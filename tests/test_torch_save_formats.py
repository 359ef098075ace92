"""The formats JAX's ``save_image_with_geninfo`` writes through Pillow's
generic branch (``image.save(filename, format, quality=jpeg_quality)``),
written by the port's ``utils/saving``: held to JAX's file under the same
options and file name.

Bytes equal for Netpbm (every extension gives P6 or P5), TGA and its other
names, QOI, SGI and its other names, PCX, DDS, IM, MPO (a plain JPEG), EPS
/ PS, and PDF with its creation and modification times masked.  Pixels
equal through Pillow for ICO, ICNS and APNG, whose PNGs are the port's
encoder's (Pillow's zlib stream and filters differ; the layout, sizes and
pixels are Pillow's).  BLP, MSP, XBM and Palm (which Pillow refuses for
the images JAX hands it) and the stub formats raise what JAX raises, and a
save on the background writer leaves what JAX's leaves.  ``check_format``
passes every extension JAX's path takes (JPEG 2000's six among them), and
names AVIF."""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
from torch_jax_state import jax_vae_file_reset  # noqa: F401  (JAX's loaded-VAE global)
import base64
import io
import os
import re

import numpy as np
import pytest
from PIL import Image

from sdwebui_tpu.utils import images as jax_images
from sdwebui_tpu_torch.server.api import Api
from sdwebui_tpu_torch.server.app import Engine
from sdwebui_tpu_torch.utils import saving
from sdwebui_tpu_torch.utils.image_io import read_image_file
from sdwebui_tpu_torch.utils.png import decode_png
from test_torch_saving import both, fixed_clock  # noqa: F401

BYTES_EQUAL = ("ppm", "pgm", "pbm", "pnm", "pfm", "tga", "icb", "vda", "vst", "qoi", "sgi",
               "rgb", "rgba", "bw", "pcx", "dds", "im", "mpo", "eps", "ps", "jp2", "j2k", "jpx",
               "jpf", "j2c", "jpc")
REFUSED = ("blp", "msp", "xbm", "palm", "h5", "hdf", "grib", "bufr", "wmf", "emf")


def _image(mode: str, h: int = 26, w: int = 33) -> np.ndarray:
    rng = np.random.default_rng(5)
    y, x = np.mgrid[0:h, 0:w]
    rgba = np.clip(np.stack([x * 7, y * 9, (x + y) * 4, 255 - x * 3], 2)
                   + rng.integers(0, 9, (h, w, 4)), 0, 255).astype(np.uint8)
    rgba[3:7, 5:20] = (10, 20, 30, 255)
    return {"RGB": rgba[:, :, :3], "L": rgba[:, :, :1], "RGBA": rgba, "LA": rgba[:, :, 1:3]}[mode]


def _pil(image: np.ndarray) -> Image.Image:
    return Image.fromarray(image[:, :, 0] if image.shape[2] == 1 else image)


def _both(tmp_path, image: np.ndarray, ext: str) -> tuple:
    """(JAX's bytes or error, the port's bytes or error) of one image saved
    as `name.ext` (the same name in two directories: SGI, IM and PDF write
    it into the file)."""
    out = []
    for which in ("jax", "port"):
        d = tmp_path / which
        d.mkdir(exist_ok=True)
        path = str(d / f"00001-77.{ext}")
        try:
            if which == "jax":
                jax_images.save_image_with_geninfo(_pil(image), "infotext", path)
            else:
                saving.save_image_with_geninfo(image, "infotext", path)
            out.append(open(path, "rb").read())
        except Exception as e:   # noqa: BLE001 - the error is what is compared
            out.append(e)
    return tuple(out)


@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA", "LA"])
@pytest.mark.parametrize("ext", BYTES_EQUAL)
def test_writer_bytes_equal_jax(tmp_path, both, ext, mode):
    """The bytes of JAX's file, or the error JAX raises for the mode."""
    both(jpeg_quality=83)
    jax_out, port_out = _both(tmp_path, _image(mode), ext)
    if isinstance(jax_out, Exception):
        assert isinstance(port_out, Exception), f"JAX raised {jax_out!r}, the port wrote"
        assert isinstance(port_out, type(jax_out)) or isinstance(jax_out, type(port_out))
        assert str(port_out) == str(jax_out)
    else:
        assert not isinstance(port_out, Exception), port_out
        assert port_out == jax_out


@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA", "LA"])
def test_pdf_bytes_equal_jax_but_the_times(tmp_path, both, mode):
    """The PDF of a grey, an RGB, an RGBA and a grey + alpha image: Pillow's
    objects, the JPEG at jpeg_quality (JPEG 2000 with SMaskInData for an
    image with alpha), the title; the creation and modification times (the
    clock at the write) are masked."""
    both(jpeg_quality=71)
    jax_out, port_out = _both(tmp_path, _image(mode), "pdf")
    mask = re.compile(rb"\(D:\d{14}Z\)")
    assert mask.sub(b"(D:)", port_out) == mask.sub(b"(D:)", jax_out)
    assert port_out.startswith(b"%PDF-1.4\n")


@pytest.mark.parametrize("ext", ["ico", "icns"])
@pytest.mark.parametrize("mode", ["RGBA", "LA"])
def test_ico_and_icns_of_alpha_say_so(tmp_path, ext, mode):
    """Pillow resizes an image with alpha premultiplied, which the port's
    resize does not restate: it says so."""
    with pytest.raises(NotImplementedError, match=ext.upper()):
        saving.save_image_with_geninfo(_image(mode), None, str(tmp_path / f"x.{ext}"))


@pytest.mark.parametrize("ext,mode", [("ico", "RGB"), ("ico", "L"), ("icns", "RGB"),
                                      ("apng", "RGB"), ("apng", "RGBA"), ("ico", "RGB512")])
def test_writer_pixels_equal_jax_through_pillow(tmp_path, ext, mode):
    """ICO (PNG entries at Pillow's sizes, LANCZOS thumbnails with the
    aspect kept), ICNS (PNGs resized BICUBIC to its six sides) and APNG (a
    PNG without text): Pillow opens the port's file as it opens JAX's, to
    the pixel, with the same sizes; the bytes differ only in the PNG
    encoder's zlib stream and filters."""
    image = _image("RGB", 512, 512) if mode == "RGB512" else _image(mode)
    jax_out, port_out = _both(tmp_path, image, ext)
    with Image.open(io.BytesIO(jax_out)) as ref, Image.open(io.BytesIO(port_out)) as got:
        assert got.format == ref.format
        assert got.info.get("sizes") == ref.info.get("sizes")
        assert "parameters" not in got.info and "parameters" not in ref.info
        assert got.size == ref.size
        np.testing.assert_array_equal(np.asarray(got.convert("RGBA")),
                                      np.asarray(ref.convert("RGBA")))
        if ext == "ico":
            for size in sorted(ref.info["sizes"]):
                ref.size = got.size = size
                np.testing.assert_array_equal(np.asarray(got.convert("RGBA")),
                                              np.asarray(ref.convert("RGBA")))
    got = read_image_file(str(tmp_path / "port" / f"00001-77.{ext}"))[0]
    with Image.open(io.BytesIO(port_out)) as im:
        want = np.asarray(im.convert({1: "L", 3: "RGB", 4: "RGBA"}[got.shape[2]]))
    np.testing.assert_array_equal(got.reshape(want.shape), want)


@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA"])
@pytest.mark.parametrize("ext", REFUSED)
def test_pillow_refusals_raise_as_jax(tmp_path, ext, mode):
    jax_out, port_out = _both(tmp_path, _image(mode), ext)
    assert isinstance(jax_out, Exception) and isinstance(port_out, type(jax_out)), \
        (jax_out, port_out)
    assert str(port_out) == str(jax_out)


@pytest.mark.parametrize("ext", ["blp", "h5", "tga"])
def test_background_save_leaves_what_jax_leaves(tmp_path, both, ext):
    """save_image on the background writer: the name reserved, then the
    write, whose error the writer logs and drops, as JAX's does; so a refused
    format leaves an empty file under the same name in both."""
    both(sdtpu_async_save=True, save_images_add_number=True)
    image = _image("RGB")
    paths = {}
    for which, save in (("jax", lambda p: jax_images.save_image(
            _pil(image), p, "", seed=5, prompt="a cat", extension=ext)),
                        ("port", lambda p: saving.save_image(image, p, "", seed=5,
                                                             prompt="a cat", extension=ext))):
        paths[which] = save(str(tmp_path / which))
    jax_images.flush_saves()
    saving.flush_saves()
    assert os.path.relpath(paths["jax"], tmp_path / "jax") == \
        os.path.relpath(paths["port"], tmp_path / "port")
    jax_bytes, port_bytes = (open(paths[w], "rb").read() for w in ("jax", "port"))
    if ext == "tga":
        assert port_bytes == jax_bytes and port_bytes
    else:
        assert port_bytes == jax_bytes == b""


@pytest.mark.parametrize("ext", saving.FORMATS + tuple(saving.PILLOW_REFUSES))
def test_check_format_takes_what_jax_writes(ext):
    saving.check_format(ext)
    saving.check_format("." + ext.upper(), "grid_format")


@pytest.mark.parametrize("ext", ["avif", "avifs"])
def test_check_format_names_jpeg_2000_and_avif(ext):
    with pytest.raises(NotImplementedError, match=ext):
        saving.check_format(ext)


@pytest.mark.parametrize("fmt", ["tga", "qoi", "ppm", "sgi", "pcx", "dds", "im"])
def test_generation_route_saves_each_format(tmp_path, both, fixed_clock, fmt):  # noqa: F811
    """txt2img with samples_format and grid_format: JAX's names, each file
    decoding to the response's pixels."""
    both(sdtpu_async_save=False)
    api = Api(Engine(device="cpu", tiny=True, seed=2, outdir=str(tmp_path / "out"),
                     hash_cache=None))
    status, res = api.handle("POST", "/sdapi/v1/txt2img", {
        "prompt": "a cat", "seed": 3, "steps": 1, "width": 64, "height": 64, "batch_size": 2,
        "save_images": True, "override_settings": {"samples_format": fmt, "grid_format": fmt}})
    assert status == 200, res
    tree = {os.path.relpath(os.path.join(r, n), tmp_path / "out"): os.path.join(r, n)
            for r, _, fs in os.walk(tmp_path / "out") for n in fs}
    assert sorted(tree) == [f"txt2img-grids/2024-05-06/grid-0000.{fmt}",
                            f"txt2img-images/2024-05-06/00000-3.{fmt}",
                            f"txt2img-images/2024-05-06/00001-4.{fmt}"]
    for i, name in enumerate(sorted(tree)):
        got = read_image_file(tree[name])[0]
        shown = decode_png(base64.b64decode(res["images"][i]))[0]
        np.testing.assert_array_equal(got, shown)
