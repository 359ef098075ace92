"""WebP: the port's decoders (``utils/vp8``, ``utils/vp8l``, ``utils/webp``)
against Pillow's ``Image.open`` (libwebp through ``WebPAnimDecoder``) and
the JAX package's conversions in every pixel — lossy at every quality and
method, lossless, with alpha, animated, with EXIF/ICC/XMP chunks — and the
port's encoders: lossless round trips exactly, lossy decodes in Pillow as
in the port, within 1.25× the mean error of Pillow's own file at the same
quality and at most twice its size; the infotext of a saved WebP reads
back through JAX's ``read_user_comment``."""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
from torch_jax_state import jax_vae_file_reset  # noqa: F401  (JAX's loaded-VAE global)
import io
import struct

import numpy as np
import pytest
from PIL import Image

from sdwebui_tpu.utils import images as jax_images
from sdwebui_tpu.utils.exif import read_user_comment as jax_read_user_comment
from sdwebui_tpu.utils.options import opts as jax_opts
from sdwebui_tpu_torch.utils import exif, images as images_util, saving, webp, webp_encode
from sdwebui_tpu_torch.utils.options import opts
from test_torch_formats import _BG, _jax_file, _photo, _pillow, _port_file, assert_like_jax


def _rgba(h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    alpha = rng.integers(0, 256, (h, w, 1), dtype=np.uint8)
    alpha[: h // 3] = 255
    alpha[-h // 4:] = 0
    return np.concatenate([_photo(h, w, seed), alpha], 2)


_IMAGES = {"photo": lambda: _photo(64, 64, 0), "odd": lambda: _photo(37, 53, 1),
           "random": lambda: np.random.default_rng(2).integers(0, 256, (40, 48, 3),
                                                               dtype=np.uint8)}


@pytest.mark.parametrize("method", [0, 4, 6])
@pytest.mark.parametrize("quality", [10, 50, 80, 95, 100])
@pytest.mark.parametrize("name", sorted(_IMAGES))
def test_lossy_pillow_files(name, quality, method):
    assert_like_jax(_pillow(Image.fromarray(_IMAGES[name]()), "WEBP", quality=quality,
                            method=method))


@pytest.mark.parametrize("method", [0, 4, 6])
@pytest.mark.parametrize("case", ["photo", "rgba", "few", "two", "grey", "random"])
def test_lossless_pillow_files(case, method):
    rng = np.random.default_rng(3)
    image = {"photo": lambda: _photo(48, 40, 3), "rgba": lambda: _rgba(40, 40, 4),
             "few": lambda: (rng.integers(0, 3, (30, 50, 3)) * 100).astype(np.uint8),
             "two": lambda: (rng.integers(0, 2, (30, 33, 1)) * [[[10, 200, 30]]]
                             ).astype(np.uint8),
             "grey": lambda: rng.integers(0, 256, (25, 31), dtype=np.uint8),
             "random": lambda: rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)}[case]()
    assert_like_jax(_pillow(Image.fromarray(image), "WEBP", lossless=True, method=method))


@pytest.mark.parametrize("alpha_quality", [100, 60, 20])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lossy_with_alpha_pillow_files(seed, alpha_quality):
    data = _pillow(Image.fromarray(_rgba(40, 48, seed)), "WEBP", quality=80,
                   alpha_quality=alpha_quality)
    got = assert_like_jax(data)
    assert got.shape[2] == 4


@pytest.mark.parametrize("lossless", [False, True])
def test_animated_first_frame(lossless):
    frames = [Image.fromarray(_rgba(30, 36, i) if lossless else _photo(30, 36, i))
              for i in range(3)]
    data = _pillow(frames[0], "WEBP", save_all=True, append_images=frames[1:], duration=90,
                   loop=2, background=(10, 20, 30, 40), lossless=lossless, quality=80)
    assert_like_jax(data)


def test_metadata_chunks():
    data = _pillow(Image.fromarray(_photo(20, 20, 5)), "WEBP", quality=80,
                   exif=b"Exif\x00\x00MM\x00*abc", icc_profile=b"icc-bytes", xmp=b"<x/>")
    got, info = webp.decode_webp(data)
    assert (info["exif"], info["icc_profile"], info["xmp"]) == (b"MM\x00*abc", b"icc-bytes",
                                                                 b"<x/>")
    assert_like_jax(data)


def _cut_vp8(data: bytes, n: int) -> bytes:
    """A simple lossy file with its VP8 chunk cut to `n` bytes, the chunk's
    and the RIFF's sizes (and the pad byte) made to agree with the cut."""
    assert data[12:16] == b"VP8 "
    body = data[20:20 + struct.unpack_from("<I", data, 16)[0]][:n]
    chunk = b"VP8 " + struct.pack("<I", n) + body + b"\0" * (n & 1)
    return b"RIFF" + struct.pack("<I", 4 + len(chunk)) + b"WEBP" + chunk


def _same_outcome(data: bytes) -> None:
    """The port refuses `data` exactly when Pillow does, and otherwise
    decodes it to Pillow's pixels."""
    try:
        with Image.open(io.BytesIO(data)) as im:
            want = np.asarray(im.convert("RGB"))
    except OSError:
        want = None
    if want is None:
        with pytest.raises(ValueError):
            webp.decode_webp(data)
    else:
        np.testing.assert_array_equal(images_util.flatten(webp.decode_webp(data)[0], _BG),
                                      want)


@pytest.mark.parametrize("quality,method", [(80, 4), (30, 0), (95, 6)])
def test_truncated_lossy_as_pillow(quality, method):
    """Every cut of the VP8 data: libwebp's end-of-data rule (a read that
    needs a byte past a partition's end, the pad byte counted) decides
    both, so a truncated frame is refused and not decoded to an image."""
    data = _pillow(Image.fromarray(_photo(24, 32, quality)), "WEBP", quality=quality,
                   method=method)
    n = struct.unpack_from("<I", data, 16)[0]
    for cut in range(n, 9, -1):
        _same_outcome(_cut_vp8(data, cut))


@pytest.mark.parametrize("kind", ["lossy", "lossless", "exif"])
def test_truncated_file_as_pillow(kind):
    """Every prefix of a file: the demuxer's rules (the RIFF size, chunks
    that do not fit) refuse what Pillow refuses."""
    image = _photo(12, 20, 5)
    kw = {"lossy": {"quality": 80}, "lossless": {"lossless": True},
          "exif": {"quality": 80, "exif": b"Exif\x00\x00MM\x00*abc"}}[kind]
    data = _pillow(Image.fromarray(image), "WEBP", **kw)
    for cut in range(len(data), 0, -1):
        _same_outcome(data[:cut])


def test_lossy_512():
    assert_like_jax(_pillow(Image.fromarray(_photo(512, 512, 6)), "WEBP", quality=80))


# --------------------------------------------------------------------------
# the port's encoders
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(48, 40, 3), (40, 40, 4), (25, 31, 1), (1, 1, 3),
                                   (33, 17, 2)])
def test_lossless_round_trip(shape):
    rng = np.random.default_rng(sum(shape))
    image = {(48, 40, 3): lambda: _photo(48, 40, 7), (40, 40, 4): lambda: _rgba(40, 40, 7)}.get(
        shape, lambda: rng.integers(0, 256, shape, dtype=np.uint8))()
    data = webp.encode_webp(image, lossless=True)
    got = assert_like_jax(data)
    want = image if shape[2] in (3, 4) else np.repeat(image[:, :, :1], 3, 2)
    if shape[2] == 2:                     # grey + alpha goes in as RGBA
        want = np.concatenate([want, image[:, :, 1:]], 2)
    np.testing.assert_array_equal(got, want)


def test_lossless_512():
    image = _photo(512, 512, 8)
    got = assert_like_jax(webp.encode_webp(image, lossless=True))
    np.testing.assert_array_equal(got, image)


@pytest.mark.parametrize("quality", [50, 80, 95])
@pytest.mark.parametrize("name", ["smooth", "photo", "odd"])
def test_lossy_within_bound_of_pillow(name, quality):
    image = {"smooth": lambda: _photo(128, 128, 9, noise=1.0),
             "photo": lambda: _photo(96, 96, 10), "odd": lambda: _photo(45, 70, 11)}[name]()
    ours = webp.encode_webp(image, quality)
    theirs = _pillow(Image.fromarray(image), "WEBP", quality=quality)
    got = assert_like_jax(ours)
    with Image.open(io.BytesIO(theirs)) as im:
        pil_err = np.abs(np.asarray(im, int) - image).mean()
    assert np.abs(got.astype(int) - image).mean() <= 1.25 * pil_err
    assert len(ours) <= 2 * len(theirs)


def test_lossy_with_alpha_writer():
    image = _rgba(40, 48, 12)
    got = assert_like_jax(webp.encode_webp_alpha(image, 80))
    np.testing.assert_array_equal(got[:, :, 3], image[:, :, 3])


def test_lossy_512_writer():
    image = _photo(512, 512, 13)
    got = assert_like_jax(webp.encode_webp(image, 80))
    with Image.open(io.BytesIO(_pillow(Image.fromarray(image), "WEBP", quality=80))) as im:
        assert np.abs(got.astype(int) - image).mean() <= \
            1.25 * np.abs(np.asarray(im, int) - image).mean()


def test_quality_to_quantizer():
    assert [webp_encode.quality_to_q(q) for q in (0, 50, 75, 80, 95, 100)] == \
        [127, 38, 26, 19, 4, 0]


@pytest.mark.parametrize("lossless", [False, True])
@pytest.mark.parametrize("rgba", [False, True])
def test_save_with_geninfo_against_jax(tmp_path, lossless, rgba):
    """JAX's writer and the port's: each file's infotext reads back in both
    packages (JAX's read_user_comment, the port's png-info path); RGBA is
    written as RGB; lossless files equal the source."""
    image = _rgba(32, 40, 14) if rgba else _photo(32, 40, 14)
    geninfo = "a cat, Steps: 20, Sampler: Euler a, Seed: 1 ünïcode"
    with opts.override({"webp_lossless": lossless}), \
            jax_opts.override({"webp_lossless": lossless}):
        ours = _port_file(tmp_path, image, ".webp", geninfo)
        theirs = _jax_file(tmp_path, image, ".webp", geninfo)
    for data in (ours, theirs):
        got, info = webp.decode_webp(data)
        assert got.shape[2] == 3
        assert saving.read_info_from_image(info) == geninfo
        with Image.open(io.BytesIO(data)) as im:
            assert jax_read_user_comment(im) == geninfo
            assert jax_images.read_info_from_image(im) == geninfo
        assert_like_jax(data)
    if lossless:
        np.testing.assert_array_equal(webp.decode_webp(ours)[0], image[:, :, :3])
    assert exif.read_user_comment(webp.decode_webp(ours)[1]["exif"]) == geninfo


def test_oversize_webp_saves_as_png(tmp_path):
    """A side over 16383 pixels saves as PNG, in both packages (the
    4chan copy, whose resize of a one-row image fails in both, off)."""
    image = np.zeros((1, 16384, 3), np.uint8)
    settings = {"export_for_4chan": False, "sdtpu_async_save": False}
    with opts.override(settings), jax_opts.override(settings):
        ours = saving.save_image(image, str(tmp_path / "p"), seed=1, prompt="p", extension="webp")
        theirs = jax_images.save_image(Image.fromarray(image), str(tmp_path / "j"), seed=1,
                                       prompt="p", extension="webp")
    assert ours.endswith(".png") and theirs.endswith(".png")
