"""JPEG 2000 read and written by the port (``utils/jpeg2000`` and its
modules), held to Pillow 12.1 with OpenJPEG 2.5.4.

The decoder against Pillow's ``Image.open`` on a corpus Pillow writes at
test time (L, LA, RGB, RGBA, I;16 and signed samples, 1×1 to 256², every
keyword of Pillow's writer), and on the committed fixtures of
``tools/write_jpeg2000_fixtures.py`` (what Pillow's writer cannot make:
every code-block style, SOP / EPH, POC, packed headers, an ROI, 12- and
16-bit samples, subsampled components, a palette): 0 levels for reversible
files, at most 1 level for irreversible ones (the share off by one
printed) and for sYCC (ROADMAP C), ``info`` equal.  HTJ2K, a one-sample
precinct above resolution 0, a SIZ bomb, a tile of no data and truncated
data raise; a file that declares millions of code-blocks and codes none
costs memory by its samples, not its blocks.  The
encoder: ``test_torch_jpeg2000_encode``."""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
import functools
import glob
import hashlib
import io
import os
import struct

import numpy as np
import pytest
from PIL import Image

from sdwebui_tpu_torch.utils.image_io import UnsupportedImageFormat, decode_image
from sdwebui_tpu_torch.utils.jpeg2000 import decode_jpeg2000

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "jpeg2000")
CHANNELS = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}


def _sample(h: int, w: int, c: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 5 + y * 2, y * 4 + x, 128 + 60 * np.sin(x / 4.0 + y / 7.0),
                     255 - 2 * x - y], -1)[:, :, :c]
    return np.clip(base + rng.integers(-12, 13, (h, w, c)), 0, 255).astype(np.uint8)


def _pillow(a: np.ndarray, mode: str, **kw) -> bytes:
    im = Image.fromarray(a[:, :, 0] if a.shape[2] == 1 else a, "L" if mode == "I;16" else mode)
    if mode == "I;16":
        im = Image.fromarray(a[:, :, 0].astype(np.uint16) * 40).convert("I;16")
    buf = io.BytesIO()
    im.save(buf, "JPEG2000", **kw)
    return buf.getvalue()


def _pillow_view(data: bytes):
    """Pillow's pixels as the port's decoders give them, and its info."""
    with Image.open(io.BytesIO(data)) as im:
        im.load()
        info = {k: v for k, v in im.info.items() if k in ("comment", "dpi")}
        if im.mode in CHANNELS:
            a = np.asarray(im)
        elif im.mode == "I;16":
            a = np.asarray(im.convert("L"))
        else:
            a = np.asarray(im.convert("RGB"))
    return (a[:, :, None] if a.ndim == 2 else a), info


# name → (mode, (h, w), Pillow's keywords)
_CORPUS = {
    "L_1x1": ("L", (1, 1), {}),
    "RGB_1x1": ("RGB", (1, 1), {}),
    "L_2x3": ("L", (2, 3), {}),
    "RGB_5x7": ("RGB", (5, 7), {}),
    "LA_9x4": ("LA", (9, 4), {}),
    "RGBA_17x33": ("RGBA", (17, 33), {}),
    "RGB_48x64": ("RGB", (48, 64), {}),
    "I16_21x30": ("I;16", (21, 30), {}),
    "L_signed": ("L", (20, 24), {"signed": True}),
    "RGB_256": ("RGB", (256, 256), {}),
    "RGB_irreversible": ("RGB", (40, 52), {"irreversible": True}),
    "RGB_rates_layers": ("RGB", (40, 52), {"quality_layers": [60, 20, 8],
                                            "irreversible": True}),
    "L_rates_reversible": ("L", (40, 52), {"quality_layers": [30, 10]}),
    "RGB_dB_layers": ("RGB", (40, 52), {"quality_mode": "dB", "quality_layers": [30, 40],
                                        "irreversible": True}),
    "RGB_mct": ("RGB", (30, 44), {"mct": 1}),
    "RGB_mct_irreversible": ("RGB", (30, 44), {"mct": 1, "irreversible": True}),
    "L_res1": ("L", (30, 44), {"num_resolutions": 1}),
    "L_res3": ("L", (30, 44), {"num_resolutions": 3}),
    "L_res7": ("L", (70, 80), {"num_resolutions": 7}),
    "RGB_cblk_16x8": ("RGB", (30, 44), {"codeblock_size": (16, 8)}),
    "RGB_cblk_4x64": ("RGB", (30, 44), {"codeblock_size": (4, 64)}),
    "RGB_precincts": ("RGB", (60, 70), {"precinct_size": (32, 32)}),
    "RGB_precincts_wide": ("RGB", (60, 70), {"precinct_size": (128, 64)}),
    "L_tiles": ("L", (45, 61), {"tile_size": (16, 24)}),
    "L_tile_offset": ("L", (45, 61), {"tile_size": (16, 24), "tile_offset": (3, 5),
                                      "offset": (7, 9)}),
    "RGB_offset": ("RGB", (31, 29), {"offset": (3, 1), "tile_offset": (1, 1),
                                     "tile_size": (16, 16)}),
    "RGB_LRCP": ("RGB", (40, 36), {"progression": "LRCP", "quality_layers": [20, 5]}),
    "RGB_RLCP": ("RGB", (40, 36), {"progression": "RLCP", "quality_layers": [20, 5]}),
    "RGB_RPCL": ("RGB", (40, 36), {"progression": "RPCL", "precinct_size": (64, 64)}),
    "RGB_PCRL": ("RGB", (40, 36), {"progression": "PCRL", "precinct_size": (64, 32)}),
    "RGB_CPRL": ("RGB", (40, 36), {"progression": "CPRL", "precinct_size": (32, 64)}),
    "L_plt": ("L", (30, 44), {"plt": True}),
    "L_comment": ("L", (30, 44), {"comment": "a comment"}),
    "L_comment_j2k": ("L", (30, 44), {"comment": b"bytes", "no_jp2": True}),
    "RGBA_no_jp2": ("RGBA", (23, 19), {"no_jp2": True}),
}


@functools.lru_cache(maxsize=None)
def _corpus_file(name: str) -> bytes:
    mode, (h, w), kw = _CORPUS[name]
    c = 1 if mode == "I;16" else CHANNELS[mode]
    return _pillow(_sample(h, w, c, len(name)), mode, **kw)


def _held_to_pillow(data: bytes, lossy: bool, label: str):
    got, info = decode_jpeg2000(data)
    want, ref_info = _pillow_view(data)
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    if lossy:
        print(f"{label}: {100 * np.mean(diff == 1):.3f}% of samples 1 level off")
        assert diff.max() <= 1
    else:
        assert diff.max() == 0
    assert info == ref_info


@pytest.mark.parametrize("name", sorted(_CORPUS))
def test_decoder_matches_pillow(name):
    _held_to_pillow(_corpus_file(name), _CORPUS[name][2].get("irreversible", False), name)


def _fixtures():
    return sorted(os.path.basename(p) for p in glob.glob(os.path.join(FIXTURES, "*.j*")))


@pytest.mark.parametrize("name", _fixtures())
def test_fixture_matches_pillow(name):
    """Each committed fixture decodes to the pixels Pillow gave when the
    tool wrote it (the 512² ones: their SHA-256), and to Pillow's now."""
    data = open(os.path.join(FIXTURES, name), "rb").read()
    ref = np.load(os.path.join(FIXTURES, os.path.splitext(name)[0] + ".npz"))
    got, info = decode_jpeg2000(data)
    lossy = "sycc" in name
    if "pixels" in ref:
        diff = np.abs(got.astype(int) - ref["pixels"].astype(int))
        assert diff.max() <= (1 if lossy else 0)
    else:
        assert list(got.shape) == list(ref["shape"])
        assert hashlib.sha256(got.tobytes()).digest() == ref["sha256"].tobytes()
    if os.path.getsize(os.path.join(FIXTURES, name)) < 64 << 10:
        _held_to_pillow(data, lossy, name)


# -- what raises


def _with_cap(data: bytes) -> bytes:
    """A CAP marker with Part 15 set, after SIZ."""
    o = data.index(b"\xff\x4f\xff\x51") + 2
    lsiz = struct.unpack_from(">H", data, o + 2)[0]
    cap = b"\xff\x50" + struct.pack(">HIH", 8, 1 << 17, 0)
    return data[:o + 2 + lsiz] + cap + data[o + 2 + lsiz:]


def test_htj2k_names_part_15():
    for data in (_with_cap(_corpus_file("RGB_5x7")), _with_cap(_corpus_file("RGBA_no_jp2"))):
        with pytest.raises(UnsupportedImageFormat, match="Part 15") as e:
            decode_image(data)
        assert "HTJ2K" in e.value.fmt
    data = bytearray(_corpus_file("RGBA_no_jp2"))
    cod = data.index(b"\xff\x52")
    data[cod + 12] |= 0x40                        # the HT code-block style bit
    with pytest.raises(UnsupportedImageFormat, match="Part 15"):
        decode_image(bytes(data))


def test_one_sample_precincts_name_themselves():
    """Precincts of one sample above resolution 0 (Pillow's precinct_size
    16 with six resolutions): OpenJPEG reads them through undefined shifts;
    the port refuses them by name (ROADMAP C)."""
    data = _pillow(_sample(40, 36, 3, 1), "RGB", precinct_size=(16, 16))
    with pytest.raises(UnsupportedImageFormat, match="one-sample precincts"):
        decode_image(data)


def test_siz_bomb_raises_before_allocating():
    import tracemalloc
    data = bytearray(_corpus_file("RGB_5x7"))
    o = data.index(b"\xff\x51")
    struct.pack_into(">II", data, o + 6, 60000, 60000)
    tracemalloc.start()
    try:
        with pytest.raises(ValueError, match="decompression bomb"):
            decode_image(bytes(data))
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 16 << 20


def empty_codestream(w: int, h: int, nc: int, body: bytes | None = None) -> bytes:
    """A codestream of `nc` 8-bit components over `w` × `h`, 4×4 code-blocks,
    five levels, one tile whose packets are all empty (`body` in their
    place: b"" for a tile of no data)."""
    from sdwebui_tpu_torch.utils import j2k_codestream as j2c
    expns = [8] + [8 + g for _ in range(5) for g in (1, 1, 2)]
    body = bytes(6 * nc) if body is None else body
    return (b"\xff\x4f" + j2c.siz(w, h, [(8, False, 1, 1)] * nc)
            + j2c.cod(0, 0, 1, 0, j2c.spcod(5, 2, 2, 0, True)) + j2c.qcd_none(2, expns)
            + j2c.sot(0, 14 + len(body)) + b"\xff\x93" + body + b"\xff\xd9")


#: about 150 MP, under twice MAX_IMAGE_PIXELS: 4×4 code-blocks of four
#: components, some 38 million of them
BIG_SIDE = 12288


def _traced(fn):
    """fn()'s result (or the exception it raised) and its traced peak bytes."""
    import tracemalloc
    tracemalloc.start()
    try:
        try:
            out = fn()
        except Exception as e:        # noqa: BLE001  (the caller checks it)
            out = e
        return out, tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()


def test_tile_of_no_data_raises_as_pillow():
    """A tile whose tile-parts hold no byte: OpenJPEG fails it, so Pillow
    raises; so does the port, before the tile's size is allocated."""
    with pytest.raises(OSError, match="broken data stream"):
        Image.open(io.BytesIO(empty_codestream(64, 48, 4, b""))).load()
    for side in (64, BIG_SIDE):
        err, peak = _traced(lambda side=side: decode_jpeg2000(empty_codestream(side, side, 4, b"")))
        assert isinstance(err, ValueError) and "no data" in str(err)
        assert peak < 16 << 20


def test_declared_code_blocks_cost_nothing_until_coded():
    """Code-blocks and tag trees are made for the precincts a packet
    includes: a file of 110 bytes declaring 38 million blocks and coding
    none reads its codestream and packets in a few kB, and decodes to
    Pillow's pixels, at most 16 bytes a declared sample and in seconds."""
    import time

    from sdwebui_tpu_torch.utils import j2k_codestream as j2c
    from sdwebui_tpu_torch.utils import j2k_t2

    small = empty_codestream(64, 48, 4)
    _held_to_pillow(small, False, "empty")

    def tier2(data):
        cs = j2c.read(data)
        for t in sorted(cs.tiles):
            tile, rect = cs.tiles[t], j2k_t2.tile_rect(cs, t)
            comps = j2k_t2.build_tile(cs, tile.coding, rect)
            order = j2k_t2.packet_order(cs, tile.coding, comps, rect)
            j2k_t2.decode_packets(comps, tile.coding, order, b"".join(tile.parts), None)
            assert not any(prc.built for tc in comps for res in tc.res for band in res.bands
                           for prc in band.precincts)

    t = time.perf_counter()
    err, peak = _traced(lambda: tier2(empty_codestream(BIG_SIDE, BIG_SIDE, 4)))
    assert err is None and peak < 1 << 20 and time.perf_counter() - t < 5
    side = 2048
    t = time.perf_counter()
    out, peak = _traced(lambda: decode_jpeg2000(empty_codestream(side, side, 4)))
    seconds = time.perf_counter() - t
    print(f"{side}² RGBA of empty packets: {seconds:.2f} s, traced peak "
          f"{peak / (side * side * 4):.1f} bytes a sample")
    assert out[0].shape == (side, side, 4) and (out[0] == 128).all()
    assert peak < 16 * side * side * 4 and seconds < 30


def test_truncated_data_raises():
    data = _corpus_file("RGB_48x64")
    with pytest.raises(ValueError):
        decode_jpeg2000(data[:len(data) * 2 // 3])
