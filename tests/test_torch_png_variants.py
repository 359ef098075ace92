"""PNG at every bit depth and colour type, plain and Adam7-interlaced: the
port's decoder (``utils/png``) against Pillow's ``Image.open`` and the JAX
package's own conversions (``images.flatten`` as img2img applies it,
``convert("L")`` as a mask is read), in every pixel, and the ``info``
Pillow fills.  Files come from ``tests/torch_image_files.png_file`` and
from Pillow's own writer."""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
import io
import struct

import numpy as np
import pytest
from PIL import Image

from sdwebui_tpu.utils import images as jax_images
from sdwebui_tpu_torch.utils import images as images_util
from sdwebui_tpu_torch.utils.image_io import decode_image
from sdwebui_tpu_torch.utils.png import decode_png
from torch_image_files import png_file

_BG = "#ffffff"


def _assert_like_jax(data: bytes, got=None) -> None:
    """The decoded pixels give what JAX's Pillow image gives through
    flatten (RGB) and convert("L"); info is Pillow's."""
    got, info = got if got is not None else decode_png(data)
    with Image.open(io.BytesIO(data)) as im:
        assert info == im.info
        want_rgb = np.asarray(jax_images.flatten(im, _BG))
        want_l = np.asarray(im.convert("L"))
    np.testing.assert_array_equal(images_util.flatten(got, _BG), want_rgb)
    np.testing.assert_array_equal(images_util.to_l(got), want_l)


_VARIANTS = [(1, 0), (2, 0), (4, 0), (8, 0), (16, 0), (8, 2), (16, 2), (1, 3), (2, 3), (4, 3),
             (8, 3), (8, 4), (16, 4), (8, 6), (16, 6)]


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("depth,ctype", _VARIANTS)
def test_variant_matches_pillow(depth, ctype, interlace):
    rng = np.random.default_rng(depth * 10 + ctype)
    chans = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    top = (1 << depth) - 1
    samples = rng.integers(0, top + 1, (13, 11, chans)).astype(np.uint16 if depth == 16
                                                                 else np.uint8)
    palette = rng.integers(0, 256, (1 << min(depth, 8), 3), dtype=np.uint8) if ctype == 3 \
        else None
    trns = None
    if ctype == 3:
        trns = b"\xff\x00\xff"             # one transparent entry: info["transparency"] = 1
    elif ctype == 0:
        trns = struct.pack(">H", 1)
    elif ctype == 2:
        trns = struct.pack(">HHH", 1, 2, 3)
    data = png_file(samples, depth, ctype, interlace, palette, trns, seed=depth)
    _assert_like_jax(data)


def test_sixteen_bit_grey_clips_as_pillow():
    """Pillow's convert("RGB") of an "I;16" image clips at 255 (a value of
    400 becomes 255, not 400 >> 8 = 1)."""
    samples = np.array([[[0], [255], [256], [400], [65535]]], np.uint16)
    data = png_file(samples, 16, 0)
    got, _ = decode_png(data)
    assert got[0, :, 0].tolist() == [0, 255, 255, 255, 255]
    _assert_like_jax(data)


def test_sixteen_bit_grey_alpha_opens_as_rgba():
    samples = np.array([[[1000, 0], [30000, 40000], [65535, 65535]]], np.uint16)
    data = png_file(samples, 16, 4)
    got, _ = decode_png(data)
    assert got.shape == (1, 3, 4)
    _assert_like_jax(data)


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA", "LA", "I;16"])
def test_pillow_written_modes(mode):
    rng = np.random.default_rng(3)
    if mode == "I;16":
        im = Image.fromarray(rng.integers(0, 1000, (17, 9), dtype=np.uint16))
        assert im.mode == "I;16"
    else:
        im = Image.fromarray(rng.integers(0, 256, (17, 9, 4), dtype=np.uint8)).convert(mode)
    buf = io.BytesIO()
    im.save(buf, "PNG", bits=4) if mode == "P" else im.save(buf, "PNG")
    _assert_like_jax(buf.getvalue())


def test_text_and_ancillary_chunks():
    from PIL.PngImagePlugin import PngInfo

    info = PngInfo()
    info.add_text("parameters", "a cat, Steps: 20")
    info.add_text("comp", "zipped words " * 20, zip=True)
    info.add_itxt("intl", "übersicht")
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(buf, "PNG", pnginfo=info,
                                                       dpi=(300, 150))
    _assert_like_jax(buf.getvalue())


def test_interlaced_512_through_image_io():
    """One full-size case: an interlaced 16-bit RGB image at 512²."""
    rng = np.random.default_rng(9)
    y, x = np.mgrid[0:512, 0:512]
    samples = np.stack([x * 128, y * 128, (x + y) * 64], 2).astype(np.uint16)
    samples += rng.integers(0, 64, samples.shape, dtype=np.uint16)
    data = png_file(samples, 16, 2, interlace=True)
    got = decode_image(data)
    assert got[0].shape == (512, 512, 3)
    _assert_like_jax(data, got)
