"""TIFF's other compressions and colour spaces in the port's reader, held to
Pillow with libtiff on the same bytes in every pixel: JPEG (photometric 2
as Pillow writes it, 6 as cameras and scanners write it, in strips and
tiles), LZMA, Zstandard (libzstd's files and ``tests/torch_image_files``'
frames of raw and RLE blocks), CCITT Modified Huffman, Group 3 (1-D and
2-D) and Group 4 in both fill orders and both photometrics, old-style JPEG
(each strip a JPEG stream: libtiff's raw planes, chroma repeated), CMYK, YCbCr
at four chroma subsamplings, signed and float grey, 16-bit RGBA, BigTIFF; the
codecs libtiff here cannot decode name themselves.  The Zstandard decoder
also gets a property test on seeded frames of raw and RLE blocks and on
libzstd's compressed blocks (Huffman literals in one and four streams,
FSE sequences with repeat offsets), and the CCITT decoder on rows of
random runs."""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
import io
import struct

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

import torch_image_files as f
from sdwebui_tpu_torch.utils import ccitt, images as images_util, tiff, zstd
from sdwebui_tpu_torch.utils.exif import _ifd_entries
from sdwebui_tpu_torch.utils.image_io import UnsupportedImageFormat, decode_image
from sdwebui_tpu_torch.utils.jpeg import encode_jpeg


def _photo(h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    return np.clip(np.stack([x * 5, y * 6, (x + y) * 3], 2) + rng.integers(0, 20, (h, w, 3)),
                   0, 255).astype(np.uint8)


def _bits(h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    b = ((x * y) % 7 > 2) | (rng.random((h, w)) > 0.9)
    b[:, w // 2:w // 2 + 3] = True
    b[h // 3] = False
    return b.astype(np.uint8)


def _pillow(a: np.ndarray, mode: str | None = None, **kw) -> bytes:
    buf = io.BytesIO()
    im = Image.fromarray(a)
    if mode:
        im = im.convert(mode)
    im.save(buf, "TIFF", **kw)
    return buf.getvalue()


def assert_like_pillow(data: bytes) -> np.ndarray:
    got, info = decode_image(data)
    with Image.open(io.BytesIO(data)) as im:
        ref_info = dict(im.info)
        want_rgb = np.asarray(im.convert("RGB"))
        want_l = np.asarray(im.convert("L"))
    assert info["compression"] == ref_info["compression"]
    np.testing.assert_array_equal(images_util.to_rgb(got), want_rgb)
    np.testing.assert_array_equal(images_util.to_l(got), want_l)
    return got


def _jpeg_strip(sub: tuple):
    """A strip's JPEG with luma sampled `sub` (Pillow's subsampling 0, 1, 2)."""
    def encode(block: np.ndarray) -> bytes:
        buf = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(block.astype(np.uint8))).save(
            buf, "JPEG", quality=85, subsampling={(1, 1): 0, (2, 1): 1, (2, 2): 2}[sub])
        return buf.getvalue()
    return encode


def _cases() -> dict:
    rgb = _photo(37, 45, 0)
    grey = rgb[:, :, 0].copy()
    rgba = np.concatenate([rgb, _photo(37, 45, 1)[:, :, :1]], 2)
    bits = _bits(40, 70, 2)
    rng = np.random.default_rng(3)
    c = {}
    for comp in ("jpeg", "lzma", "zstd"):
        c[f"pillow_{comp}_rgb"] = lambda comp=comp: _pillow(rgb, compression=comp)
        c[f"pillow_{comp}_grey"] = lambda comp=comp: _pillow(grey, compression=comp)
        c[f"pillow_{comp}_strips"] = lambda comp=comp: _pillow(rgb, compression=comp,
                                                                tiffinfo={278: 8})
    c["pillow_jpeg_q95"] = lambda: _pillow(rgb, compression="jpeg", quality=95)
    for comp in ("lzma", "zstd"):
        c[f"pillow_{comp}_rgba"] = lambda comp=comp: _pillow(rgba, compression=comp)
        c[f"pillow_{comp}_predictor"] = lambda comp=comp: _pillow(rgb, compression=comp,
                                                                   tiffinfo={317: 2})
    for comp in ("group3", "group4", "tiff_ccitt"):
        c[f"pillow_{comp}"] = lambda comp=comp: _pillow(bits.astype(bool), compression=comp)
    c["pillow_bigtiff_rgb"] = lambda: _pillow(rgb, big_tiff=True)
    c["pillow_bigtiff_grey_big_endian"] = lambda: _pillow(grey, big_tiff=True,
                                                          tiffinfo={}, byteorder=">")
    c["pillow_cmyk"] = lambda: _pillow(rgb, "CMYK")
    c["pillow_cmyk_lzw"] = lambda: _pillow(rgb, "CMYK", compression="tiff_lzw")
    c["pillow_float"] = lambda: _pillow(rng.normal(100, 90, (21, 17)).astype(np.float32))
    c["pillow_int32"] = lambda: _pillow(rng.integers(-300, 600, (21, 17)).astype(np.int32))
    # hand-built
    for sub in ((2, 2), (2, 1), (1, 1)):
        c[f"jpeg_ycbcr_{sub[0]}{sub[1]}"] = lambda sub=sub: f.tiff_file(
            _photo(40, 48, 4), "jpeg", photometric=6, rows_per_strip=16,
            encoder=_jpeg_strip(sub), tags={530: (3, list(sub))})
    for sub, (hh, ww) in (((2, 2), (40, 48)), ((2, 2), (37, 45)), ((2, 1), (40, 48)),
                          ((1, 1), (33, 40))):
        c[f"old_jpeg_{sub[0]}{sub[1]}_{hh}x{ww}"] = lambda sub=sub, hh=hh, ww=ww: f.tiff_file(
            _photo(hh, ww, 6), "jpeg", photometric=6, encoder=_jpeg_strip(sub),
            tags={259: (3, [6]), 530: (3, list(sub))})
    c["jpeg_ycbcr_tiles_port_encoder"] = lambda: f.tiff_file(
        _photo(40, 48, 5), "jpeg", photometric=6, tile=16,
        encoder=lambda b: encode_jpeg(np.ascontiguousarray(b.astype(np.uint8)), 85),
        tags={530: (3, [2, 2])})
    for sub in ((1, 1), (2, 1), (2, 2), (4, 2)):
        c[f"ycbcr_deflate_{sub[0]}{sub[1]}"] = lambda sub=sub: f.ycbcr_tiff(rgb, sub, "deflate")
    for kind in ("ccitt", "g3", "g4"):
        for photometric in (0, 1):
            for fill in (1, 2):
                c[f"{kind}_photo{photometric}_fill{fill}"] = (
                    lambda kind=kind, p=photometric, fo=fill: f.tiff_file(
                        bits, kind, depth=1, photometric=p, fill_order=fo, rows_per_strip=16))
    c["g3_2d"] = lambda: f.tiff_file(bits, "g3", depth=1, photometric=0,
                                     tags={292: (4, [1])}, rows_per_strip=16)
    c["g3_2d_fill_bits_fill2"] = lambda: f.tiff_file(bits, "g3", depth=1, photometric=0,
                                                     tags={292: (4, [5])}, fill_order=2)
    c["zstd_frames"] = lambda: f.tiff_file(rgb, "zstd", rows_per_strip=7, seed=4)
    c["zstd_frames_tiles_predictor"] = lambda: f.tiff_file(rgb, "zstd", True, tile=16, seed=5)
    c["lzma_planar"] = lambda: f.tiff_file(rgb, "lzma", planar=True, rows_per_strip=9)
    c["lzw_fill2"] = lambda: f.tiff_file(rgb, "lzw", fill_order=2)
    c["raw_grey_fill2"] = lambda: f.tiff_file(grey, "none", fill_order=2)
    c["cmyk_extra"] = lambda: f.tiff_file(np.concatenate([rgba, rgba[:, :, :1]], 2), "deflate",
                                          photometric=5, extra=0)
    c["int16_grey"] = lambda: f.tiff_file(rng.integers(-500, 900, (21, 17)).astype(np.int16),
                                          "lzw", depth=16)
    c["rgba16"] = lambda: f.tiff_file(rng.integers(0, 65536, (21, 17, 4), dtype=np.uint16),
                                      "zstd", depth=16, extra=2)
    return c


_CASES = _cases()


@pytest.mark.parametrize("case", sorted(_CASES))
def test_tiff_codec_matches_pillow(case):
    assert_like_pillow(_CASES[case]())


@pytest.mark.parametrize("code,name", [(50001, "WebP"), (32809, "ThunderScan"),
                                       (34676, "SGILog"), (34677, "SGILog24"),
                                       (32771, "raw_16")])
def test_codecs_libtiff_cannot_decode_name_themselves(code, name):
    data = f.tiff_file(_photo(8, 8, 0), tags={259: (3, [code])})
    with pytest.raises(UnsupportedImageFormat, match=name):
        decode_image(data)


def test_jpeg_sampling_against_the_tag_refused_as_libtiff():
    """A YCbCr JPEG strip sampled 2×2 under a YCbCrSubsampling of 2×1:
    libtiff refuses it ("Improper JPEG sampling factors"), so does the port."""
    data = f.tiff_file(_photo(16, 16, 2), "jpeg", photometric=6, encoder=_jpeg_strip((2, 2)),
                       tags={530: (3, [2, 1])})
    with pytest.raises(OSError):
        Image.open(io.BytesIO(data)).load()
    with pytest.raises(ValueError, match="sampling"):
        decode_image(data)


def test_uncompressed_ycbcr_refused_as_pillow_fails():
    """Pillow unpacks an uncompressed YCbCr TIFF as RGBX and finds it
    truncated; the port raises naming it."""
    data = f.ycbcr_tiff(_photo(9, 12, 1), (2, 2), "none")
    with pytest.raises(OSError, match="truncated"):
        Image.open(io.BytesIO(data)).load()
    with pytest.raises(ValueError, match="uncompressed YCbCr"):
        decode_image(data)


# --------------------------------------------------------------------------
# Zstandard
# --------------------------------------------------------------------------

def _strips(data: bytes) -> list:
    (first,) = struct.unpack_from("<I", data, 4)
    tags = _ifd_entries(data, first, "<")
    vals = [tiff._values(tags[t], "<") for t in (273, 279)]
    return [data[o:o + n] for o, n in zip(*vals)]


@pytest.mark.parametrize("kind", ["text", "smooth", "mixed"])
@pytest.mark.parametrize("rows", [8, 512])
def test_zstd_decodes_libzstd_blocks(kind, rows):
    """libzstd's frames (through Pillow's TIFF writer): compressed blocks
    with Huffman literals (one and four streams, direct and FSE-coded
    weights, treeless repeats), FSE sequence tables of every mode and the
    three repeat offsets; each strip's content equal to the pixels."""
    rng = np.random.default_rng(9)
    y, x = np.mgrid[0:512, 0:160]
    if kind == "text":
        src = np.frombuffer((b"the quick brown fox jumps over the lazy dog " * 6000)[:512 * 480],
                            np.uint8).reshape(512, 160, 3) ^ rng.integers(0, 2, (512, 160, 3),
                                                                          dtype=np.uint8)
    elif kind == "smooth":
        src = np.stack([(x + y) % 256, (x * 2) % 256, (y * 3) % 256], 2).astype(np.uint8)
    else:
        src = np.clip(np.stack([x, y // 2, (x * y) // 64], 2)
                      + rng.integers(0, 6, (512, 160, 3)), 0, 255).astype(np.uint8)
    data = _pillow(src, compression="zstd", tiffinfo={278: rows})
    got = b"".join(zstd.decompress(s) for s in _strips(data))
    assert got == src.tobytes()


@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(data=st.binary(min_size=0, max_size=6000), runs=st.lists(
    st.tuples(st.integers(0, 255), st.integers(1, 3000)), max_size=4), seed=st.integers(0, 99))
def test_zstd_raw_and_rle_blocks_property(data, runs, seed):
    """Frames of raw and RLE blocks from the numpy writer (a skippable
    frame first, the content split over one or two frames) decode to
    their content."""
    content = data + b"".join(bytes([v]) * n for v, n in runs)
    frames = f.zstd_frames(content, seed, split=True)
    assert zstd.decompress(frames) == content
    assert zstd.decompress(f.zstd_frames(content, seed)) == content


def test_zstd_refuses_dictionaries_and_bad_magic():
    frame = struct.pack("<IB", 0xFD2FB528, 0x21) + b"\x07" + struct.pack("<I", 1) + b"\x01\0\0"
    with pytest.raises(ValueError, match="dictionary"):
        zstd.decompress(frame)
    with pytest.raises(ValueError, match="Zstandard"):
        zstd.decompress(b"not a frame")


def _zstd_blocks(blocks: list, window: int = 0x38) -> bytes:
    """A frame that is not single-segment (window descriptor `window`, 0x38
    for 128 KiB, 0 for 1 KiB) of (kind, size, payload) blocks."""
    out = struct.pack("<IBB", 0xFD2FB528, 0, window)
    for i, (kind, size, payload) in enumerate(blocks):
        out += struct.pack("<I", (i == len(blocks) - 1) | (kind << 1) | (size << 3))[:3] + payload
    return out


_BOUNDS = {
    "rle_2mib_blocks": (_zstd_blocks([(1, (1 << 21) - 1, b"\x07")] * 1000), False),
    "rle_past_128kib": (_zstd_blocks([(1, (1 << 17) + 1, b"\x07")]), False),
    "rle_past_window": (_zstd_blocks([(1, 4096, b"\x07")], 0), False),
    "raw_past_window": (_zstd_blocks([(0, 2048, b"\x07" * 2048)] * 2, 0), False),
    "rle_at_window": (_zstd_blocks([(1, 1024, b"\x07")] * 8, 0), True),
    "rle_128kib_blocks_past_the_strip": (_zstd_blocks([(1, 1 << 17, b"\x07")] * 1000), True),
}


@pytest.mark.parametrize("case", sorted(_BOUNDS))
def test_zstd_block_bounds_as_libzstd(case):
    """A block larger than its frame's window or 128 KiB raises where
    libzstd refuses it, and a frame whose content outruns its strip stops at
    the strip, as libtiff's stream does (Pillow's answer on the same TIFF);
    the port's decode never holds more than a block past the strip, however
    much the blocks' headers declare."""
    import tracemalloc

    frame, reads = _BOUNDS[case]
    data = f.tiff_file(np.full((64, 64), 7, np.uint8), "zstd", encoder=lambda _: frame)
    if reads:
        assert (assert_like_pillow(data) == 7).all()
    else:
        with pytest.raises(OSError), Image.open(io.BytesIO(data)) as im:
            im.load()
    tracemalloc.start()
    try:
        if reads:
            decode_image(data)
        else:
            with pytest.raises(ValueError, match="more than its maximum"):
                decode_image(data)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 1 << 20
    if case == "rle_128kib_blocks_past_the_strip":
        assert len(zstd.decompress(frame, limit=5000)) == 5000


def _block_kinds(frame: bytes) -> list:
    """(block type, literals type of a compressed block) of each block of a
    frame."""
    desc = frame[4]
    single = (desc >> 5) & 1
    pos = 5 + (0 if single else 1) + (1 if single else 0, 2, 4, 8)[desc >> 6]
    kinds = []
    while True:
        head = int.from_bytes(frame[pos:pos + 3], "little")
        kind, size = (head >> 1) & 3, head >> 3
        kinds.append((kind, frame[pos + 3] & 3 if kind == 2 else None))
        pos += 3 + (1 if kind == 1 else size)
        if head & 1:
            return kinds


@pytest.mark.parametrize("name", sorted(f.LIBRARY_FILES))
def test_library_files_decode_to_their_pixels(name):
    """The committed files libzstd and libtiff wrote (chip_smoke 4t (a)
    decodes them on the card's host): each decodes, in the port and in
    Pillow, to the pixels ``tools/write_libtiff_fixtures.py`` wrote it
    from; the Zstandard one holds only compressed blocks with Huffman
    literals, so its decode runs the Huffman and FSE code."""
    data, want = f.library_files()[f.LIBRARY_FILES[name][0]]
    assert_like_pillow(data)
    np.testing.assert_array_equal(decode_image(data)[0], want)
    if name.startswith("zstd"):
        kinds = [k for s in _strips(data) for k in _block_kinds(s)]
        assert len(kinds) > 1 and set(kinds) == {(2, 2)}


# --------------------------------------------------------------------------
# CCITT
# --------------------------------------------------------------------------

@settings(max_examples=25, deadline=None, derandomize=True, database=None)
@given(w=st.integers(1, 2600), h=st.integers(1, 6), seed=st.integers(0, 999),
       kind=st.sampled_from(["rle", "g3", "g4"]), two_d=st.booleans())
def test_ccitt_rows_round_trip(w, h, seed, kind, two_d):
    """Rows of random runs (long white and black runs, makeup codes past
    2560 included) decode to themselves under every coding."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((h, w), np.uint8)
    for r in rows:
        x = 0
        colour = int(rng.integers(0, 2))
        while x < w:
            n = int(rng.choice([1, 2, 5, 63, 64, 65, 300, 1800, 2600]))
            r[x:x + n] = colour
            x += n
            colour ^= 1
    t4 = 1 if two_d and kind == "g3" else 0
    data = f.ccitt_encode(rows, kind, t4)
    np.testing.assert_array_equal(ccitt.decode(data, w, h, kind, t4), rows)
