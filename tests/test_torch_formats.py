"""BMP, GIF and TIFF, and the two LZW codecs: the port's decoders against
Pillow's ``Image.open`` and the JAX package's conversions (``flatten`` as
img2img applies it, ``convert("L")``) in every pixel, with the ``info``
Pillow fills; the port's BMP and TIFF writers against the bytes JAX's
``save_image_with_geninfo`` writes; its GIF writer exact at up to 256
colours and, above, within 1.25× the mean error of Pillow's own GIF, with
JAX's comment bytes.  Variants Pillow does not write come from
``tests/torch_image_files``."""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
import io
import struct

import numpy as np
import pytest
from PIL import Image

from sdwebui_tpu.utils import images as jax_images
from sdwebui_tpu.utils.options import opts as jax_opts
from sdwebui_tpu_torch.utils import bmp, gif, images as images_util, lzw, saving, tiff
from sdwebui_tpu_torch.utils.image_io import decode_image
from sdwebui_tpu_torch.utils.options import opts
from torch_image_files import bmp_file, bmp_palette_file, lzw_tiff, tiff_file

_BG = "#ffffff"


def _photo(h: int, w: int, seed: int, noise: float = 3.0) -> np.ndarray:
    """A smooth seeded image with a little noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w] / max(h, w)
    img = np.stack([128 + 100 * np.sin(6 * x + rng.uniform(0, 6)) * np.cos(4 * y),
                    128 + 90 * np.cos(5 * x * y + rng.uniform(0, 6)), 255 * x * (1 - y)], 2)
    return np.clip(img + rng.normal(0, noise, img.shape), 0, 255).astype(np.uint8)


def assert_like_jax(data: bytes, decoder=decode_image, info_keys=None) -> np.ndarray:
    """The port's decode of `data` gives what JAX's Pillow image gives
    through flatten and convert("L"), and Pillow's info (read before the
    pixels load, as png-info reads it; `info_keys` narrows it)."""
    got, info = decoder(data)
    with Image.open(io.BytesIO(data)) as im:
        ref_info = dict(im.info)
        want_rgb = np.asarray(jax_images.flatten(im, _BG))
        want_l = np.asarray(im.convert("L"))
    if info_keys is not None:
        ref_info = {k: v for k, v in ref_info.items() if k in info_keys}
        info = {k: v for k, v in info.items() if k in info_keys}
    assert info == ref_info
    np.testing.assert_array_equal(images_util.flatten(got, _BG), want_rgb)
    np.testing.assert_array_equal(images_util.to_l(got), want_l)
    return got


def _pillow(image, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    image.save(buf, fmt, **kw)
    return buf.getvalue()


def _jax_file(tmp_path, image: np.ndarray, ext: str, geninfo=None) -> bytes:
    path = str(tmp_path / f"jax{ext}")
    jax_images.save_image_with_geninfo(Image.fromarray(image), geninfo, path)
    with open(path, "rb") as f:
        return f.read()


def _port_file(tmp_path, image: np.ndarray, ext: str, geninfo=None) -> bytes:
    path = str(tmp_path / f"port{ext}")
    saving.save_image_with_geninfo(image, geninfo, path)
    with open(path, "rb") as f:
        return f.read()


def _modes(seed: int = 0) -> dict:
    rgba = np.random.default_rng(seed).integers(0, 256, (13, 11, 4), dtype=np.uint8)
    return {m: Image.fromarray(rgba).convert(m) for m in ("1", "L", "P", "RGB", "RGBA")}


# --------------------------------------------------------------------------
# BMP
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA"])
def test_bmp_pillow_files(mode):
    assert_like_jax(_pillow(_modes()[mode], "BMP"))
    assert_like_jax(_pillow(_modes()[mode], "DIB"))


def test_bmp_32_bit_reads_as_rgb():
    """Pillow writes RGBA as 32-bit BI_RGB and reads that back as RGB, the
    fourth byte ignored; the port does the same."""
    im = _modes()["RGBA"]
    got, _ = bmp.decode_bmp(_pillow(im, "BMP"))
    assert got.shape[2] == 3
    np.testing.assert_array_equal(got, np.asarray(im)[:, :, :3])


@pytest.mark.parametrize("kind", ["rle8", "rle4", "4bit", "555", "565", "bgra", "top-down",
                                  "os2"])
def test_bmp_variants(kind):
    rng = np.random.default_rng(len(kind))
    if kind in ("rle8", "rle4", "4bit"):
        image = rng.integers(0, 256 if kind == "rle8" else 16, (13, 11), dtype=np.uint8)
        image[3:6] = 7                        # runs
    else:
        image = rng.integers(0, 256, (13, 11, 4 if kind == "bgra" else 3), dtype=np.uint8)
    assert_like_jax(bmp_file(image, kind))


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
@pytest.mark.parametrize("ext", [".bmp", ".dib"])
def test_bmp_writer_bytes_equal_jax(tmp_path, mode, ext):
    image = np.asarray(_modes(1)[mode])
    assert _port_file(tmp_path, image, ext, "x") == _jax_file(tmp_path, image, ext, "x")


def test_bmp_palette_writer_bytes_equal_pillow():
    """The helper's palette BMP is Pillow's file, byte for byte, and reads
    as JAX reads it."""
    im = _modes(2)["P"]
    pal = np.asarray(im.getpalette(), np.uint8).reshape(-1, 3)
    data = bmp_palette_file(np.asarray(im), pal)
    assert data == _pillow(im, "BMP")
    assert_like_jax(data)


def test_bmp_512(tmp_path):
    image = _photo(512, 512, 3)
    data = _port_file(tmp_path, image, ".bmp")
    assert data == _jax_file(tmp_path, image, ".bmp")
    np.testing.assert_array_equal(assert_like_jax(data), image)


# --------------------------------------------------------------------------
# GIF
# --------------------------------------------------------------------------


def _gif(frame: np.ndarray, palette: np.ndarray, screen=None, offset=(0, 0),
         interlace=False, local=False, transparency=None, comments=(), loop=None) -> bytes:
    """A one-frame GIF of (h, w) indices, written by hand."""
    h, w = frame.shape
    sw, sh = screen or (w, h)
    bits = max(1, int(np.ceil(np.log2(len(palette)))))
    table = np.zeros((1 << bits, 3), np.uint8)
    table[:len(palette)] = palette
    out = [b"GIF89a", struct.pack("<HHBBB", sw, sh, 0 if local else 0x80 | (bits - 1), 0, 0)]
    if not local:
        out.append(table.tobytes())
    if loop is not None:
        out.append(b"!\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loop) + b"\0")
    if transparency is not None:
        out.append(b"!\xf9\x04" + bytes([1]) + struct.pack("<H", 7) + bytes([transparency, 0]))
    for c in comments:
        out.append(b"!\xfe" + bytes([len(c)]) + c + b"\0")
    rows = frame
    if interlace:
        order = np.concatenate([np.arange(s, h, k) for s, k in ((0, 8), (4, 8), (2, 4), (1, 2))])
        rows = frame[order]
    flags = (0x80 | (bits - 1) if local else 0) | (0x40 if interlace else 0)
    out += [b",", struct.pack("<HHHHB", offset[0], offset[1], w, h, flags)]
    if local:
        out.append(table.tobytes())
    min_size = max(2, bits)
    coded = lzw.encode_gif(rows.astype(np.uint8).tobytes(), min_size)
    out.append(bytes([min_size]))
    out += [bytes([len(coded[i:i + 255])]) + coded[i:i + 255] for i in range(0, len(coded), 255)]
    return b"".join(out) + b"\0;"


@pytest.mark.parametrize("case", ["plain", "interlaced", "local", "transparent", "offset",
                                  "comments", "grey", "loop"])
def test_gif_variants(case):
    rng = np.random.default_rng(7)
    palette = rng.integers(0, 256, (24, 3), dtype=np.uint8)
    frame = rng.integers(0, 24, (19, 13), dtype=np.uint8)
    kw = {"interlaced": {"interlace": True}, "local": {"local": True},
          "transparent": {"transparency": 5}, "offset": {"screen": (20, 25), "offset": (3, 4),
                                                         "transparency": 2},
          "comments": {"comments": (b"first", b"second")}, "loop": {"loop": 3}}.get(case, {})
    if case == "grey":
        palette = np.repeat(np.arange(32, dtype=np.uint8)[:, None], 3, 1)
        frame = rng.integers(0, 32, (19, 13), dtype=np.uint8)
    assert_like_jax(_gif(frame, palette, **kw))


def test_gif_pillow_animation_first_frame():
    frames = [Image.fromarray(_photo(20, 24, i)).convert("P", palette=Image.Palette.ADAPTIVE)
              for i in range(3)]
    data = _pillow(frames[0], "GIF", save_all=True, append_images=frames[1:], duration=80,
                   loop=0, comment="anim")
    assert_like_jax(data)


@pytest.mark.parametrize("source", ["few", "grey", "photo", "random"])
@pytest.mark.parametrize("geninfo", [None, "Steps: 20, Sampler: Euler a", "ü" * 300])
def test_gif_writer_against_jax(tmp_path, source, geninfo):
    """Up to 256 colours the port's GIF reads back exact; above, its mean
    error is within 1.25× that of JAX's (Pillow's median cut); the comment
    is JAX's, byte for byte; both files decode in Pillow as in the port."""
    rng = np.random.default_rng(11)
    image = {"few": (rng.integers(0, 4, (30, 20, 3)) * 60).astype(np.uint8),
             "grey": rng.integers(0, 256, (30, 20), dtype=np.uint8),
             "photo": _photo(96, 96, 4), "random": rng.integers(0, 256, (64, 64, 3),
                                                                dtype=np.uint8)}[source]
    ours = _port_file(tmp_path, image, ".gif", geninfo)
    theirs = _jax_file(tmp_path, image, ".gif", geninfo)
    got = assert_like_jax(ours)
    want = assert_like_jax(theirs)
    src = images_util.to_rgb(image).astype(int)
    if source in ("few", "grey"):
        np.testing.assert_array_equal(images_util.to_rgb(got), src)
    else:
        err = np.abs(images_util.to_rgb(got).astype(int) - src).mean()
        assert err <= 1.25 * np.abs(images_util.to_rgb(want).astype(int) - src).mean()
    with Image.open(io.BytesIO(ours)) as a, Image.open(io.BytesIO(theirs)) as b:
        assert a.info.get("comment") == b.info.get("comment")
        assert a.info["version"] == b.info["version"]


def test_gif_512():
    image = _photo(512, 512, 5)
    data = gif.encode_gif(image, "x")
    got = assert_like_jax(data)
    ref = _pillow(Image.fromarray(image), "GIF")
    with Image.open(io.BytesIO(ref)) as im:
        pil_err = np.abs(np.asarray(im.convert("RGB"), int) - image).mean()
    assert np.abs(got.astype(int) - image).mean() <= 1.25 * pil_err


# --------------------------------------------------------------------------
# TIFF
# --------------------------------------------------------------------------


@pytest.mark.parametrize("compression", [None, "packbits", "tiff_lzw", "tiff_adobe_deflate"])
@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA", "LA", "I;16"])
def test_tiff_pillow_files(mode, compression):
    if mode == "I;16":
        im = Image.fromarray(np.random.default_rng(5).integers(0, 900, (13, 11), dtype=np.uint16))
    elif mode == "LA":
        im = _modes()["RGBA"].convert("LA")
    else:
        im = _modes()[mode]
    kw = {"compression": compression} if compression else {}
    assert_like_jax(_pillow(im, "TIFF", **kw))


@pytest.mark.parametrize("compression", ["none", "packbits", "lzw", "deflate", "zip"])
@pytest.mark.parametrize("predictor", [False, True])
@pytest.mark.parametrize("big_endian", [False, True])
def test_tiff_compressions(compression, predictor, big_endian):
    image = _photo(21, 17, 6)
    assert_like_jax(tiff_file(image, compression, predictor, big_endian, rows_per_strip=5))


@pytest.mark.parametrize("case", ["tiles", "planar", "extra0", "extra1", "extra2", "rgb16",
                                  "grey16", "white-is-zero", "palette4", "grey2"])
def test_tiff_layouts(case):
    rng = np.random.default_rng(8)
    rgba = rng.integers(0, 256, (21, 17, 4), dtype=np.uint8)
    rgba[..., 3] = np.maximum(rgba[..., 3], rgba[..., :3].max(2))   # premultiplied stays valid
    data = {
        "tiles": lambda: tiff_file(_photo(21, 17, 1), "lzw", True, tile=16),
        "planar": lambda: tiff_file(_photo(21, 17, 2), "deflate", planar=True, rows_per_strip=4),
        "extra0": lambda: tiff_file(rgba, "lzw", extra=0),
        "extra1": lambda: tiff_file(rgba, "lzw", extra=1),
        "extra2": lambda: tiff_file(rgba, "zip", True, extra=2),
        "rgb16": lambda: tiff_file(rng.integers(0, 65536, (21, 17, 3), dtype=np.uint16), "lzw",
                                   True, depth=16),
        "grey16": lambda: tiff_file(rng.integers(0, 700, (21, 17), dtype=np.uint16), "none",
                                    big_endian=True, depth=16),
        "white-is-zero": lambda: tiff_file(rng.integers(0, 256, (21, 17), dtype=np.uint8),
                                           "packbits", photometric=0),
        "palette4": lambda: tiff_file(rng.integers(0, 16, (21, 17), dtype=np.uint8), "lzw",
                                      depth=4, photometric=3,
                                      palette=rng.integers(0, 65536, (16, 3)).astype(np.uint16)),
        "grey2": lambda: tiff_file(rng.integers(0, 4, (21, 17), dtype=np.uint8), "none", depth=2),
    }[case]()
    assert_like_jax(data)


def test_tiff_refuses_what_it_does_not_read():
    """WebP in TIFF (compression 50001), which libtiff here cannot decode,
    raises naming itself; JPEG in TIFF is read (test_torch_tiff_codecs)."""
    data = tiff_file(_photo(16, 16, 0), tags={259: (3, [50001])})
    with pytest.raises(ValueError, match="WebP"):
        tiff.decode_tiff(data)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
@pytest.mark.parametrize("ext", [".tif", ".tiff"])
def test_tiff_writer_bytes_equal_jax(tmp_path, mode, ext):
    image = np.asarray(_modes(3)[mode])
    assert _port_file(tmp_path, image, ext, "x") == _jax_file(tmp_path, image, ext, "x")


def test_tiff_512(tmp_path):
    image = _photo(512, 512, 7)
    data = _port_file(tmp_path, image, ".tiff")
    assert data == _jax_file(tmp_path, image, ".tiff")
    np.testing.assert_array_equal(assert_like_jax(data), image)
    lzw_file = tiff_file(image, "lzw", True, rows_per_strip=64)
    np.testing.assert_array_equal(assert_like_jax(lzw_file), image)


# --------------------------------------------------------------------------
# LZW, and the formats' writers as samples_format
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 7, 5000, 70000])
@pytest.mark.parametrize("alphabet", [2, 16, 256])
def test_lzw_round_trips(n, alphabet):
    """Both codecs through table resets (70000 random symbols fill the
    4096-entry table many times over)."""
    data = bytes(np.random.default_rng(n + alphabet).integers(0, alphabet, n, dtype=np.uint8))
    assert lzw.decode_tiff(lzw_tiff(data), n) == data
    bits = max(2, int(np.log2(alphabet)))
    assert lzw.decode_gif(lzw.encode_gif(data, bits), bits, n) == data


@pytest.mark.parametrize("ext", ["gif", "bmp", "dib", "tif", "tiff", "jfif", "jpe"])
def test_save_image_in_each_format(tmp_path, ext):
    """save_image writes the format JAX's writes under the same name, and
    both decode to the same pixels."""
    image = _photo(40, 48, 9)
    sync = {"sdtpu_async_save": False}
    with opts.override(sync), jax_opts.override(sync):
        ours = saving.save_image(image, str(tmp_path / "port"), seed=1, prompt="p", info="i",
                                 extension=ext)
        theirs = jax_images.save_image(Image.fromarray(image), str(tmp_path / "jax"), seed=1,
                                       prompt="p", info="i", extension=ext)
    assert ours.replace("port", "jax") == theirs
    with open(ours, "rb") as f:
        data = f.read()
    got = assert_like_jax(data)
    with Image.open(theirs) as im:
        want = np.asarray(im.convert("RGB"))
    if ext in ("gif", "jfif", "jpe"):
        assert np.abs(got.astype(int) - want).max() <= (0 if ext != "gif" else 255)
        if ext == "gif":
            assert np.abs(got.astype(int) - image).mean() <= \
                1.25 * np.abs(want.astype(int) - image).mean()
    else:
        np.testing.assert_array_equal(got, want)
        with open(theirs, "rb") as f:
            assert data == f.read()
