"""The port's JPEG codec and EXIF block against Pillow and the JAX package.

Decoding: ``utils/jpeg.decode_jpeg`` against ``decode_base64_to_image(...)
.convert("RGB")`` of the JAX server on JPEGs that Pillow writes (quality
50/80/95/100, 4:4:4, 4:2:2, 4:2:0, progressive, restart intervals, grey,
Adobe RGB, odd sizes and a hypothesis sweep of sizes), and on 4:4:0 files
(no Pillow setting writes them: ``torch_jpeg_files`` does, Pillow decodes
them): every pixel equal.  ``img.info`` as Pillow fills it.  Encoding:
``encode_jpeg`` and the port's ``save_image_with_geninfo`` against the JAX
package's ``save_image_with_geninfo(..., ".jpg")``: equal bytes, and the
UserComment read back by JAX's ``read_user_comment``; the encoder core in
4:4:4 and 4:2:2 equal to Pillow's bytes.  EXIF: byte-equal to
``build_exif_bytes``.  What the decoder refuses raises ``ValueError``, a
frame over Pillow's pixel limit included (JAX's ``Image.open`` raises
``DecompressionBombError``).
"""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
from torch_jax_state import jax_vae_file_reset  # noqa: F401  (JAX's loaded-VAE global)
import base64
import io
import struct
import zlib

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from sdwebui_tpu.server.app import decode_base64_to_image
from sdwebui_tpu.utils import exif as jax_exif
from sdwebui_tpu.utils import images as jax_images
from sdwebui_tpu.utils.options import opts as jax_opts
from sdwebui_tpu_torch.utils import exif, jpeg, saving
from sdwebui_tpu_torch.utils.image_io import UnsupportedImageFormat, decode_image
from sdwebui_tpu_torch.utils.options import opts
from sdwebui_tpu_torch.utils.png import MAX_IMAGE_PIXELS, check_image_size, encode_png
from torch_jpeg_files import MODES, encode_sampled

INFOTEXTS = {
    "ascii": "a cat\nNegative prompt: dog\nSteps: 20, Sampler: Euler a, Seed: 9, Size: 64x48",
    "latin1": "café crème, über",
    "cjk": "猫と犬, 山の上",
    "empty": "",
    "long": "masterpiece, (best quality:1.2), " * 200,
}


def _photo(h: int, w: int, seed: int) -> np.ndarray:
    """A smooth image with noise on it: what a sample looks like to the codec."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (max(h // 8, 2), max(w // 8, 2), 3)).astype(np.uint8)
    a = np.asarray(Image.fromarray(base).resize((w, h), Image.BICUBIC)).astype(np.int16)
    return np.clip(a + rng.integers(-20, 20, (h, w, 3)), 0, 255).astype(np.uint8)


def _pillow(a: np.ndarray, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _jax_rgb(data: bytes) -> np.ndarray:
    """The JAX server's decode of a client's image, as every route converts it."""
    return np.asarray(decode_base64_to_image(base64.b64encode(data).decode()).convert("RGB"))


def _assert_decodes_like_pillow(data: bytes):
    np.testing.assert_array_equal(jpeg.decode_jpeg_rgb(data), _jax_rgb(data))


# --------------------------------------------------------------------------
# EXIF
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(INFOTEXTS))
def test_exif_bytes_equal_jax(name):
    text = INFOTEXTS[name]
    block = exif.build_exif_bytes(text)
    assert block == jax_exif.build_exif_bytes(text)
    assert exif.read_user_comment(block) == text
    raw = exif.read_exif_tags(block)[1][exif.USER_COMMENT][1]
    assert exif.decode_user_comment(raw) == jax_exif.decode_user_comment(raw) == text


def test_user_comment_of_other_writers():
    """Little-endian TIFF blocks, the UNDEFINED type and ASCII comments, as
    Pillow writes them, read back as JAX's reader does."""
    for comment in (b"UNICODE\x00" + "hé".encode("utf-16-le"), b"ASCII\x00\x00\x00hi"):
        ex = Image.Exif()
        ex.get_ifd(exif.EXIF_IFD)[exif.USER_COMMENT] = comment
        block = ex.tobytes()
        im = Image.open(io.BytesIO(_pillow(np.zeros((8, 8, 3), np.uint8), exif=block)))
        assert exif.read_user_comment(block) == jax_exif.read_user_comment(im)
    assert exif.read_user_comment(b"Exif\x00\x00garbage") is None
    assert exif.read_user_comment(None) is None


# --------------------------------------------------------------------------
# decoding
# --------------------------------------------------------------------------

DECODE_CASES = {
    "q50": dict(quality=50), "q80": dict(quality=80), "q95": dict(quality=95),
    "q100": dict(quality=100), "444": dict(quality=80, subsampling=0),
    "422": dict(quality=80, subsampling=1), "420": dict(quality=90, subsampling=2),
    "progressive": dict(quality=80, progressive=True),
    "progressive_444": dict(quality=95, subsampling=0, progressive=True),
    "progressive_422": dict(quality=70, subsampling=1, progressive=True),
    "restart_blocks": dict(quality=80, restart_marker_blocks=3),
    "restart_rows": dict(quality=80, subsampling=0, restart_marker_rows=1),
    "adobe_rgb": dict(quality=85, keep_rgb=True),
    "optimized": dict(quality=75, optimize=True),
}
SIZES = [(1, 1), (7, 9), (45, 67), (255, 513), (16, 16), (9, 2), (3, 40)]


@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_decode_equals_pillow(case, size):
    h, w = size
    _assert_decodes_like_pillow(_pillow(_photo(h, w, h * 7 + w), **DECODE_CASES[case]))


@pytest.mark.parametrize("size", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
@pytest.mark.parametrize("progressive", [False, True])
def test_decode_grey_equals_pillow(size, progressive):
    h, w = size
    a = _photo(h, w, 3)[:, :, 1]
    data = _pillow(a, quality=85, progressive=progressive)
    image, _ = jpeg.decode_jpeg(data)
    assert image.shape == (h, w, 1)
    np.testing.assert_array_equal(image[:, :, 0], np.asarray(Image.open(io.BytesIO(data))))
    _assert_decodes_like_pillow(data)


@pytest.mark.parametrize("size", [(1, 1), (7, 9), (45, 67), (32, 17)])
def test_decode_440_equals_pillow(size):
    """4:4:0 (luma sampled 1×2): the h1v2 fancy upsampling of
    libjpeg-turbo >= 2, on files the test helper writes."""
    h, w = size
    _assert_decodes_like_pillow(encode_sampled(_photo(h, w, 5), 90, "4:4:0"))


@settings(max_examples=30, deadline=None, derandomize=True, database=None)
@given(h=st.integers(1, 80), w=st.integers(1, 80), sub=st.sampled_from([0, 1, 2]),
       progressive=st.booleans(), quality=st.sampled_from([60, 90]))
def test_decode_sweep_of_sizes(h, w, sub, progressive, quality):
    _assert_decodes_like_pillow(_pillow(_photo(h, w, h * 100 + w), quality=quality,
                                        subsampling=sub, progressive=progressive))


def _info_equal(data: bytes):
    ours = jpeg.decode_jpeg(data)[1]
    theirs = dict(Image.open(io.BytesIO(data)).info)
    assert ours == theirs


@pytest.mark.parametrize("kw", [dict(), dict(exif=exif.build_exif_bytes("x")),
                                dict(dpi=(300, 300)), dict(progressive=True),
                                dict(keep_rgb=True), dict(comment=b"a comment")],
                         ids=["plain", "exif", "dpi", "progressive", "adobe", "comment"])
def test_info_equals_pillow(kw):
    _info_equal(_pillow(_photo(16, 24, 1), quality=80, **kw))


def _patched(data: bytes, marker: int, offset: int, value: int) -> bytes:
    """`data` with the byte at `offset` into the payload of its first
    `marker` segment set to `value`."""
    i = data.index(bytes([0xFF, marker])) + 4 + offset
    return data[:i] + bytes([value]) + data[i + 1:]


def _with_marker(data: bytes, old: int, new: int) -> bytes:
    i = data.index(bytes([0xFF, old]))
    return data[:i + 1] + bytes([new]) + data[i + 2:]


def _cmyk() -> bytes:
    buf = io.BytesIO()
    Image.new("CMYK", (16, 16), (10, 20, 30, 40)).save(buf, "JPEG")
    return buf.getvalue()


def _sized(data: bytes, width: int, height: int) -> bytes:
    """`data` with its frame header declaring width × height."""
    i = data.index(b"\xff\xc0") + 5
    return data[:i] + struct.pack(">HH", height, width) + data[i + 4:]


def _large_png(width: int, height: int) -> bytes:
    """A PNG whose header declares width × height, with one row of data."""
    data = encode_png(np.zeros((1, 1, 3), np.uint8))
    i = data.index(b"IHDR")
    body = struct.pack(">II", width, height) + data[i + 12:i + 17]
    ihdr = b"IHDR" + body
    return data[:i] + ihdr + struct.pack(">I", zlib.crc32(ihdr) & 0xFFFFFFFF) + data[i + 21:]


@pytest.mark.parametrize("case", ["cmyk", "12bit", "arithmetic", "lossless", "sampling3",
                                  "truncated", "truncated_progressive", "not_jpeg",
                                  "over_the_pixel_limit"])
def test_refusals_raise_value_error(case):
    rgb = _pillow(_photo(24, 24, 2), quality=80)
    data = {
        "cmyk": _cmyk,
        "12bit": lambda: _patched(rgb, 0xC0, 0, 12),
        "arithmetic": lambda: _with_marker(rgb, 0xC0, 0xC9),
        "lossless": lambda: _with_marker(rgb, 0xC0, 0xC3),
        "sampling3": lambda: _patched(rgb, 0xC0, 7, 0x31),
        "truncated": lambda: rgb[:len(rgb) // 2],
        "truncated_progressive": lambda: _pillow(_photo(24, 24, 2), progressive=True)[:300],
        "not_jpeg": lambda: b"\x89PNG....",
        "over_the_pixel_limit": lambda: _sized(rgb, 65535, 65535),
    }[case]()
    with pytest.raises(ValueError):
        jpeg.decode_jpeg(data)
    if case == "over_the_pixel_limit":
        with pytest.raises(Image.DecompressionBombError):
            decode_base64_to_image(base64.b64encode(data).decode())


@pytest.mark.parametrize("fmt,size", [("jpeg", (13380, 13377)),
                                      ("png", (65535, 65535)), ("png", (13380, 13377)),
                                      ("png", (2 * MAX_IMAGE_PIXELS + 1, 1)),
                                      ("png", (1, 2 * MAX_IMAGE_PIXELS + 1))])
def test_frames_over_the_pixel_limit_refused_as_jax(fmt, size):
    """A header over twice Pillow's MAX_IMAGE_PIXELS raises before anything
    is allocated, where JAX's Image.open raises DecompressionBombError."""
    w, h = size
    data = _large_png(w, h) if fmt == "png" else \
        _sized(_pillow(_photo(8, 8, 1), quality=80), w, h)
    with pytest.raises(ValueError, match="decompression bomb"):
        decode_image(data)
    with pytest.raises(Image.DecompressionBombError):
        decode_base64_to_image(base64.b64encode(data).decode())


@pytest.mark.parametrize("size", [(1, 1), (0, 5), (13377, 13379), (13378, 13378),
                                  (2 * MAX_IMAGE_PIXELS, 1), (2 * MAX_IMAGE_PIXELS + 1, 1),
                                  (65535, 65535)])
def test_pixel_limit_is_pillows(size):
    """check_image_size raises where Pillow's decompression-bomb check does
    (it warns, and lets through, anything up to twice the limit)."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", Image.DecompressionBombWarning)
        try:
            Image._decompression_bomb_check(size)
            theirs = None
        except Image.DecompressionBombError as e:
            theirs = str(e)
    try:
        check_image_size(*size)
        ours = None
    except ValueError as e:
        ours = str(e)
    assert ours == theirs


@pytest.mark.parametrize("band_pixels,idct_blocks", [(64, 1), (200, 3), (1000, 7)])
@pytest.mark.parametrize("mode", ["4:2:0", "4:4:4", "4:2:2", "4:4:0", "progressive", "grey"])
def test_decode_in_bands_equals_pillow(monkeypatch, mode, band_pixels, idct_blocks):
    """The IDCT over chunks of block rows and the upsampling and colour
    conversion over bands of rows (what bounds a large frame's memory),
    here with bands of a few rows: they join as the whole-image filters do."""
    monkeypatch.setattr(jpeg, "_BAND_PIXELS", band_pixels)
    monkeypatch.setattr(jpeg, "_IDCT_BLOCKS", idct_blocks)
    for h, w in ((45, 67), (37, 16), (9, 2), (64, 64)):
        a = _photo(h, w, h + w)
        if mode == "4:4:0":
            data = encode_sampled(a, 85, mode)
        elif mode == "grey":
            data = _pillow(a[:, :, 0], quality=85)
        elif mode == "progressive":
            data = _pillow(a, quality=85, progressive=True)
        else:
            data = _pillow(a, quality=85, subsampling=list(MODES).index(mode))
        _assert_decodes_like_pillow(data)


@pytest.mark.parametrize("fmt,kw", [("AVIF", {})])
def test_other_formats_name_theirs(fmt, kw):
    buf = io.BytesIO()
    Image.fromarray(_photo(8, 8, 0)).save(buf, fmt.replace(" ", ""), **kw)
    with pytest.raises(UnsupportedImageFormat, match=fmt) as e:
        decode_image(buf.getvalue())
    assert e.value.fmt == fmt


@pytest.mark.parametrize("fmt", ["PPM", "ICO", "QOI", "JPEG2000", "J2K"])
def test_other_formats_are_read(fmt):
    """PPM, ICO, QOI and JPEG 2000 (a JP2 file and a raw codestream),
    refused before the port read them: Pillow's pixels."""
    buf = io.BytesIO()
    Image.fromarray(_photo(24, 24, 0)).save(buf, "JPEG2000" if fmt == "J2K" else fmt,
                                            **({"no_jp2": True} if fmt == "J2K" else {}))
    with Image.open(io.BytesIO(buf.getvalue())) as im:
        want = np.asarray(im.convert("RGB"))
    np.testing.assert_array_equal(decode_image(buf.getvalue())[0][:, :, :3], want)


# --------------------------------------------------------------------------
# encoding
# --------------------------------------------------------------------------

ENCODE_SIZES = [(1, 1), (7, 9), (45, 67), (255, 513), (64, 64), (17, 33), (8, 72)]


@pytest.mark.parametrize("size", ENCODE_SIZES, ids=[f"{h}x{w}" for h, w in ENCODE_SIZES])
@pytest.mark.parametrize("quality", [80, 95])
def test_save_with_geninfo_bytes_equal_jax(tmp_path, quality, size):
    """The port's save_image_with_geninfo and JAX's (Pillow's encoder) write
    the same bytes at jpeg_quality; Pillow reads the infotext back."""
    h, w = size
    a = _photo(h, w, h + w)
    text = INFOTEXTS["cjk"] + INFOTEXTS["ascii"]
    with opts.override({"jpeg_quality": quality}), jax_opts.override({"jpeg_quality": quality}):
        jax_images.save_image_with_geninfo(Image.fromarray(a), text, str(tmp_path / "j.jpg"))
        saving.save_image_with_geninfo(a, text, str(tmp_path / "p.jpg"))
    ours = (tmp_path / "p.jpg").read_bytes()
    assert ours == (tmp_path / "j.jpg").read_bytes()
    with Image.open(tmp_path / "p.jpg") as im:
        assert jax_exif.read_user_comment(im) == text
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), jpeg.decode_jpeg_rgb(ours))


@pytest.mark.parametrize("quality", [1, 10, 50, 75, 100])
@pytest.mark.parametrize("subsampling", ["4:4:4", "4:2:2", "4:2:0"])
def test_encode_bytes_equal_pillow(quality, subsampling):
    """Noise (long runs of large coefficients) and a smooth image, with no
    EXIF block."""
    sub = list(MODES).index(subsampling)
    for a in (_photo(37, 51, quality), np.random.default_rng(quality).integers(
            0, 256, (24, 40, 3), dtype=np.uint8)):
        ours = jpeg.encode_jpeg(a, quality) if subsampling == "4:2:0" else \
            encode_sampled(a, quality, subsampling)
        assert ours == _pillow(a, quality=quality, subsampling=sub)


@pytest.mark.parametrize("size", [(1, 1), (13, 29), (64, 64)])
def test_encode_grey_bytes_equal_pillow(size):
    a = _photo(*size, 9)[:, :, 2]
    assert jpeg.encode_jpeg(a, 80) == _pillow(a, quality=80)
    assert jpeg.encode_jpeg(a[:, :, None], 80) == _pillow(a, quality=80)


def test_encode_refuses_what_pillow_refuses():
    with pytest.raises(ValueError, match="EXIF data is too long"):
        jpeg.encode_jpeg(np.zeros((8, 8, 3), np.uint8), exif=b"Exif\x00\x00" + bytes(70000))
    with pytest.raises(ValueError):
        jpeg.encode_jpeg(np.zeros((8, 8, 4), np.uint8))
