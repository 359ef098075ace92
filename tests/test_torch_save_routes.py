"""The saving routes and JPEG on every route, the port against the JAX
package's handlers (called unbound, with stand-in engines that run JAX's
pipelines on the tiny SD1.5 pair of test_torch_img2img).

``/internal/save-images`` (files, ``log.csv`` rows, the zip),
``/internal/img2img-batch`` (2 JPEGs and 1 PNG, a mask directory,
``use_png_info``), Extras ``save_output`` (single and batch), ``png-info`` of
a JPEG, ``save_images`` on both generation routes under the Engine's
outdir, a JPEG as ``init_images``, ``mask``, a ControlNet unit's
``input_image`` and ``/controlnet/detect``'s input, a JPEG training and
preprocess directory; AVIF, PSD, QOI and PPM inputs answer 400 naming the
format, unported sample formats 422 (the other formats' routes are in
test_torch_format_routes).  Pixels within 1 level of JAX's where
a model ran, equal elsewhere; names, text and CSV rows equal.
"""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
from torch_jax_state import jax_vae_file_reset  # noqa: F401  (JAX's loaded-VAE global)
import base64
import csv
import io
import json
import os
import threading
import zipfile
from types import SimpleNamespace

import numpy as np
import pytest
from PIL import Image

from sdwebui_tpu.pipeline import img2img as jax_i2i
from sdwebui_tpu.pipeline.params import GenerationParams as JaxParams
from sdwebui_tpu.server import api as jax_api
from sdwebui_tpu.server import ui_actions as jax_ui
from sdwebui_tpu.training import preprocess as jax_pre
from sdwebui_tpu.utils import images as jax_images
from sdwebui_tpu.utils.options import opts as jax_opts
from sdwebui_tpu_torch.pipeline import img2img as port_i2i
from sdwebui_tpu_torch.pipeline.params import GenerationParams
from sdwebui_tpu_torch.server.api import Api
from sdwebui_tpu_torch.server.app import Engine
from sdwebui_tpu_torch.training import preprocess as port_pre
from sdwebui_tpu_torch.utils import exif, saving
from sdwebui_tpu_torch.utils.jpeg import decode_jpeg_rgb
from sdwebui_tpu_torch.utils.options import opts
from sdwebui_tpu_torch.utils.png import decode_png, encode_png
from test_torch_img2img import _init_image, _rect_mask, f32_policies, models  # noqa: F401
from test_torch_jpeg import _large_png, _sized
from test_torch_saving import both, fixed_clock  # noqa: F401

TEXT = "a red cat\nNegative prompt: dog\nSteps: 2, Sampler: Euler a, CFG scale: 6.5, Seed: 77"


def _smooth(seed: int, size: int = 64) -> np.ndarray:
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (size // 16, size // 16, 3)).astype(np.uint8)
    return np.asarray(Image.fromarray(base).resize((size, size), Image.BICUBIC))


def _jpeg(a: np.ndarray, quality: int = 90, text: str | None = None) -> bytes:
    buf = io.BytesIO()
    kw = {"exif": exif.build_exif_bytes(text)} if text else {}
    Image.fromarray(a).save(buf, "JPEG", quality=quality, **kw)
    return buf.getvalue()


def _png(a: np.ndarray, text: str | None = None) -> bytes:
    return encode_png(a, {"parameters": text} if text else None)


def _b64(data: bytes) -> str:
    return base64.b64encode(data).decode("ascii")


def _other_format(fmt: str) -> bytes:
    """A file in a format Pillow reads and the port does not (AVIF)."""
    buf = io.BytesIO()
    Image.fromarray(_smooth(1, 16)).save(buf, fmt.replace(" ", ""))
    return buf.getvalue()


def _flush():
    jax_images.flush_saves()
    saving.flush_saves()


def _tree(root) -> dict:
    return {os.path.relpath(os.path.join(r, f), root): os.path.join(r, f)
            for r, _, fs in os.walk(root) for f in fs}


@pytest.fixture(scope="module")
def port_api(models):  # noqa: F811
    return Api(Engine(model=models[1], device="cpu", hash_cache=None))


def _jax_self(jm):
    """What JAX's handlers read of `self`: an engine running JAX's pipeline."""
    def img2img(p, save=False):
        return jax_i2i.process_img2img(jm, p)
    return SimpleNamespace(engine=SimpleNamespace(img2img=img2img,
                                                  queue_lock=threading.Lock()))


# --------------------------------------------------------------------------
# /internal/save-images
# --------------------------------------------------------------------------

@pytest.mark.parametrize("index,zip_,fmt", [(-1, True, "png"), (1, False, "png"),
                                            (-1, False, "jpg")])
def test_save_images_route_equals_jax(port_api, tmp_path, both, fixed_clock,  # noqa: F811
                                      index, zip_, fmt):
    """A grid and two samples posted back (PNG and JPEG): the same files,
    pixels, text and log.csv rows as JAX's save_files, twice (the second
    appends a row), and the zip's names."""
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 256, (32, 48, 3), dtype=np.uint8) for _ in range(3)]
    texts = [TEXT, TEXT, TEXT.replace("Seed: 77", "Seed: 78")]
    js = {"prompt": "a red cat", "negative_prompt": "dog", "seed": 77, "all_seeds": [77, 78],
          "infotexts": texts, "index_of_first_image": 1, "width": 48, "height": 32,
          "sampler_name": "Euler a", "cfg_scale": 6.5, "steps": 2, "batch_size": 2,
          "sd_model_name": "tiny", "sd_model_hash": "0123456789"}
    posted = [_b64(_png(imgs[0])), "data:image/jpeg;base64," + _b64(_jpeg(imgs[1])),
              _b64(_png(imgs[2]))]
    body = {"info": json.dumps(js), "images": posted, "do_make_zip": zip_, "index": index}
    results = {}
    for which in ("jax", "port"):
        root = str(tmp_path / which)
        both(outdir_save=root, samples_format=fmt, grid_zip_filename_pattern="[seed]-[seed_last]")
        for _ in range(2):
            if which == "jax":
                res = jax_ui.save_files_from_json(dict(body))
            else:
                status, res = port_api.handle("POST", "/internal/save-images", dict(body))
                assert status == 200, res
            results[which] = res
    _flush()
    ours, theirs = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert sorted(ours) == sorted(theirs)
    assert len([f for f in ours if f.endswith(fmt)]) == (2 if index == 1 else 6)
    for name, path in ours.items():
        if name.endswith(".png"):
            img, text = decode_png(open(path, "rb").read())
            with Image.open(theirs[name]) as ref:
                np.testing.assert_array_equal(img, np.asarray(ref))
                assert text == {k: v for k, v in ref.info.items() if isinstance(v, str)}
        elif name.endswith(".zip"):
            with zipfile.ZipFile(path) as a, zipfile.ZipFile(theirs[name]) as b:
                assert a.namelist() == b.namelist()
        else:
            assert open(path, "rb").read() == open(theirs[name], "rb").read(), name
    with open(ours["log.csv"], newline="") as f:
        rows = list(csv.reader(f))
    assert len(rows) == 3 and rows[0][0] == "prompt"
    assert results["port"]["saved"] == results["jax"]["saved"]
    assert (results["port"]["zip"] is None) == (results["jax"]["zip"] is None) == (not zip_)


def test_log_csv_columns_padded_as_jax(port_api, tmp_path, both):
    """An old log.csv with fewer columns: both rewrite its header and pad
    its rows before appending."""
    for which in ("jax", "port"):
        root = tmp_path / which
        root.mkdir()
        (root / "log.csv").write_text("prompt,seed\nold,1\n", encoding="utf8")
        both(outdir_save=str(root))
        body = {"info": {"prompt": "p", "seed": 2}, "images": [_b64(_png(_smooth(2, 16)))]}
        if which == "jax":
            jax_ui.save_files_from_json(body)
        else:
            assert port_api.handle("POST", "/internal/save-images", body)[0] == 200
    assert (tmp_path / "port" / "log.csv").read_text() == \
        (tmp_path / "jax" / "log.csv").read_text()


# --------------------------------------------------------------------------
# /internal/img2img-batch
# --------------------------------------------------------------------------

def test_img2img_batch_equals_jax(models, f32_policies, port_api, tmp_path,  # noqa: F811
                                  both, fixed_clock):  # noqa: F811
    """Two JPEGs (one with an infotext in its EXIF) and a PNG with its
    "parameters" text, a mask for one of them, use_png_info with prompt,
    seed and steps: the same outputs, names and infotexts as JAX's."""
    both(sdtpu_vae_bf16=False, img2img_batch_show_results_limit=2)
    src, masks = tmp_path / "in", tmp_path / "masks"
    src.mkdir()
    masks.mkdir()
    (src / "a.jpg").write_bytes(_jpeg(_smooth(1), text=TEXT))
    (src / "b.png").write_bytes(_png(_smooth(2), text=TEXT.replace("Seed: 77", "Seed: 5")))
    (src / "c.jpeg").write_bytes(_jpeg(_smooth(3), quality=80))
    (src / "notes.txt").write_text("not an image")
    (masks / "c.jpeg").write_bytes(_jpeg(np.repeat(_rect_mask()[:, :, None], 3, axis=2)))
    body = {"input_dir": str(src), "inpaint_mask_dir": str(masks), "use_png_info": True,
            "png_info_props": ["Prompt", "Seed", "Steps"], "prompt": "base", "seed": 9,
            "steps": 3, "width": 64, "height": 64, "denoising_strength": 0.6, "mask_blur": 0,
            "inpainting_fill": 1, "inpaint_full_res": False}
    ref = jax_api.Api.img2img_batch(_jax_self(models[0]),
                                    dict(body, output_dir=str(tmp_path / "jax")))
    status, out = port_api.handle("POST", "/internal/img2img-batch",
                                  dict(body, output_dir=str(tmp_path / "port")))
    assert status == 200, out
    assert out["processed"] == ref["processed"] == 3 and len(out["images"]) == 2
    assert [os.path.basename(f) for f in out["outputs"]] == \
        [os.path.basename(f) for f in ref["outputs"]] == ["a.png", "b.png", "c.png"]
    for ours, theirs in zip(out["outputs"], ref["outputs"]):
        img, text = decode_png(open(ours, "rb").read())
        with Image.open(theirs) as im:
            assert np.abs(img.astype(int) - np.asarray(im, int)).max() <= 1
            assert text["parameters"] == im.info["parameters"]
    texts = [decode_png(open(f, "rb").read())[1]["parameters"] for f in out["outputs"]]
    assert texts[0].startswith("base a red cat") and "Seed: 77" in texts[0]
    assert "Seed: 5" in texts[1] and "Steps: 2" in texts[1]
    assert "Seed: 9" in texts[2] and "Steps: 3" in texts[2]


@pytest.mark.parametrize("fmt", ["BMP", "WEBP"])
def test_img2img_batch_names_an_unported_file(port_api, tmp_path, fmt):
    """The batch reads its .bmp and .webp files by what they hold: an AVIF
    under either name answers 422 naming it, before any image is made."""
    (tmp_path / "a.png").write_bytes(_png(_smooth(1)))
    (tmp_path / f"z.{fmt.lower()}").write_bytes(_other_format("AVIF"))
    status, res = port_api.handle("POST", "/internal/img2img-batch",
                                  {"input_dir": str(tmp_path), "steps": 1})
    assert status == 422 and f"z.{fmt.lower()}: a AVIF image" in res["detail"]
    assert not (tmp_path / "out").exists()


# --------------------------------------------------------------------------
# Extras save_output, png-info
# --------------------------------------------------------------------------

@pytest.mark.parametrize("suffix,original", [(False, True), (True, True), (True, False)])
def test_extras_save_output_equals_jax(port_api, tmp_path, both, suffix, original):
    both(use_upscaler_name_as_suffix=suffix, use_original_name_batch=original)
    img = _smooth(4, 32)
    single = {"image": _b64(_jpeg(img)), "upscaler_1": "Lanczos", "upscaling_resize": 2,
              "save_output": True}
    batch = {"imageList": [{"data": _b64(_png(img)), "name": "photo.one.png"},
                           {"data": _b64(_jpeg(img)), "name": "x/two.jpg"}],
             "upscaler_1": "Nearest", "upscaling_resize": 1.5, "save_output": True}
    fake = _jax_self(None)
    for which in ("jax", "port"):
        both(outdir_extras_samples=str(tmp_path / which))
        if which == "jax":
            jax_api.Api.extras_single(fake, dict(single))
            jax_api.Api.extras_batch(SimpleNamespace(extras_single=lambda b: jax_api.Api.
                                                     extras_single(fake, b)), dict(batch))
        else:
            assert port_api.handle("POST", "/sdapi/v1/extra-single-image", single)[0] == 200
            assert port_api.handle("POST", "/sdapi/v1/extra-batch-images", batch)[0] == 200
    _flush()
    ours, theirs = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert sorted(ours) == sorted(theirs) and len(ours) == 3
    for name in ours:
        img2, text = decode_png(open(ours[name], "rb").read())
        with Image.open(theirs[name]) as ref:
            np.testing.assert_array_equal(img2, np.asarray(ref))
            assert text == {"extras": ref.info["extras"]}


@pytest.mark.parametrize("kind", ["jpeg_exif", "jpeg_plain", "jpeg_progressive", "png"])
def test_png_info_equals_jax(port_api, kind):
    img = _smooth(5, 24)
    data = {"jpeg_exif": lambda: _jpeg(img, text=TEXT), "jpeg_plain": lambda: _jpeg(img),
            "jpeg_progressive": lambda: _progressive(img), "png": lambda: _png(img, TEXT)}[kind]()
    body = {"image": _b64(data)}
    ref = jax_api.Api.png_info(None, body)
    status, out = port_api.handle("POST", "/sdapi/v1/png-info", body)
    assert status == 200
    assert out["info"] == ref["info"] and out["parameters"] == ref["parameters"]
    assert json.loads(json.dumps(out["items"])) == json.loads(json.dumps(
        {k: v for k, v in ref["items"].items() if not isinstance(v, bytes)}))
    if kind == "jpeg_exif":
        assert out["info"] == TEXT and "exif" in ref["items"] and "exif" not in out["items"]


def _progressive(a):
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, "JPEG", progressive=True, quality=85)
    return buf.getvalue()


# --------------------------------------------------------------------------
# JPEG on the generation routes
# --------------------------------------------------------------------------

def test_jpeg_init_image_and_mask_match_jax(models, f32_policies, port_api, both):  # noqa: F811
    """A JPEG init image and a JPEG mask on the img2img route: JAX's
    process_img2img on Pillow's decode of the same bytes, within 1 level,
    the same infotext."""
    both(sdtpu_vae_bf16=False)
    init, mask = _jpeg(_init_image(seed=3), quality=85), _jpeg(
        np.repeat(_rect_mask()[:, :, None], 3, axis=2), quality=95)
    kw = dict(prompt="a cat", seed=12, steps=3, width=64, height=64, denoising_strength=0.7,
              mask_blur=0, inpainting_fill=1, inpaint_full_res=False)
    ref = jax_i2i.process_img2img(models[0], JaxParams(
        init_images=[Image.open(io.BytesIO(init)).convert("RGB")],
        mask=Image.open(io.BytesIO(mask)), **kw))
    status, out = port_api.handle("POST", "/sdapi/v1/img2img", dict(
        kw, init_images=["data:image/jpeg;base64," + _b64(init)], mask=_b64(mask)))
    assert status == 200, out
    img, text = decode_png(base64.b64decode(out["images"][0]))
    assert np.abs(img.astype(int) - np.asarray(ref.images[0], int)).max() <= 1
    assert text["parameters"] == ref.infotexts[0]
    # the same pixels sent as a PNG give the same answer
    png = _b64(_png(decode_jpeg_rgb(init)))
    status, again = port_api.handle("POST", "/sdapi/v1/img2img", dict(
        kw, init_images=[png], mask=_b64(mask)))
    assert again["images"] == out["images"]


def test_jpeg_controlnet_inputs_equal_their_png(port_api):
    """A JPEG ControlNet input_image and /controlnet/detect input give the
    answer of the PNG of the same decoded pixels."""
    jpg = _jpeg(_smooth(7), quality=75)
    png = _png(decode_jpeg_rgb(jpg))
    outs = []
    for data in (jpg, png):
        status, det = port_api.handle("POST", "/controlnet/detect", {
            "controlnet_module": "canny", "controlnet_input_images": [_b64(data)],
            "controlnet_processor_res": 64})
        assert status == 200, det
        unit = {"module": "canny", "model": "None", "input_image": _b64(data),
                "processor_res": 64}
        status, res = port_api.handle("POST", "/sdapi/v1/txt2img", {
            "prompt": "x", "seed": 1, "steps": 1, "width": 64, "height": 64,
            "controlnet_units": [unit]})
        outs.append((det["images"], status, res.get("images") or res.get("detail")))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("fmt", ["AVIF"])
@pytest.mark.parametrize("route,field", [("/sdapi/v1/img2img", "init_images"),
                                         ("/sdapi/v1/img2img", "mask"),
                                         ("/sdapi/v1/extra-single-image", "image"),
                                         ("/sdapi/v1/png-info", "image")])
def test_other_input_formats_answer_400(port_api, route, field, fmt):
    """AVIF, which the port does not read, answers 400 naming the format
    (PSD, QOI, PPM and JPEG 2000 are read: test_torch_formats_rare)."""
    data = _b64(_other_format(fmt))
    body = {"init_images": [_b64(_png(_smooth(1)))], "steps": 1, "width": 64, "height": 64} \
        if route.endswith("img2img") else {"upscaler_1": "Lanczos"} if "extra" in route else {}
    body[field] = [data] if field == "init_images" else data
    status, res = port_api.handle("POST", route, body)
    assert status == 400 and f"holds a {fmt} image" in res["detail"], res


@pytest.mark.parametrize("fmt", ["jpeg", "png"])
@pytest.mark.parametrize("route,field", [("/sdapi/v1/img2img", "init_images"),
                                         ("/sdapi/v1/img2img", "mask"),
                                         ("/sdapi/v1/extra-single-image", "image"),
                                         ("/sdapi/v1/png-info", "image")])
def test_decompression_bombs_answer_400(port_api, route, field, fmt):
    """A header over Pillow's pixel limit answers 400 before anything is
    allocated (JAX's Image.open raises DecompressionBombError)."""
    data = _b64(_large_png(65535, 65535) if fmt == "png" else
                _sized(_jpeg(_smooth(1)), 65535, 65535))
    with pytest.raises(Image.DecompressionBombError):
        Image.open(io.BytesIO(base64.b64decode(data)))
    body = {"init_images": [_b64(_png(_smooth(1)))], "steps": 1, "width": 64, "height": 64} \
        if route.endswith("img2img") else {"upscaler_1": "Lanczos"} if "extra" in route else {}
    body[field] = [data] if field == "init_images" else data
    status, res = port_api.handle("POST", route, body)
    assert status == 400 and "decompression bomb" in res["detail"], res


def test_save_images_on_both_routes(tmp_path, both, fixed_clock):  # noqa: F811
    """save_images writes under the Engine's outdir as JAX's Engine lays it
    out; a request without it writes nothing; avif answers 422 naming it."""
    both(sdtpu_async_save=False)
    api = Api(Engine(device="cpu", tiny=True, seed=2, outdir=str(tmp_path / "out")))
    body = {"prompt": "a cat", "seed": 3, "steps": 1, "width": 64, "height": 64,
            "batch_size": 2}
    assert api.handle("POST", "/sdapi/v1/txt2img", body)[0] == 200
    assert not (tmp_path / "out").exists()
    status, res = api.handle("POST", "/sdapi/v1/txt2img", dict(body, save_images=True))
    assert status == 200 and len(res["images"]) == 3
    png = _b64(_png(_smooth(1)))
    status, res = api.handle("POST", "/sdapi/v1/img2img", {
        "init_images": [_b64(_jpeg(_smooth(1)))], "prompt": "a cat", "seed": 3, "steps": 2,
        "width": 64, "height": 64, "save_images": True,
        "override_settings": {"samples_format": "jpg"}})
    assert status == 200
    assert sorted(_tree(tmp_path / "out")) == [
        "img2img-images/2024-05-06/00000-3.jpg", "txt2img-grids/2024-05-06/grid-0000.png",
        "txt2img-images/2024-05-06/00000-3.png", "txt2img-images/2024-05-06/00001-4.png"]
    status, res = api.handle("POST", "/sdapi/v1/img2img", {
        "init_images": [png], "steps": 1, "width": 64, "height": 64, "save_images": True,
        "override_settings": {"samples_format": "avif"}})
    assert status == 422 and "avif" in res["detail"]
    both(samples_format="avif")
    status, res = api.handle("POST", "/sdapi/v1/extra-single-image", {
        "image": png, "upscaler_1": "Lanczos", "save_output": True})
    assert status == 422 and "avif" in res["detail"]


def test_save_flags_in_override_settings(tmp_path, both, fixed_clock):  # noqa: F811
    """The arms chip_smoke's phase 4n times: save_images with samples_save
    and grid_save off answers the grid and both images and writes nothing;
    sdtpu_async_save off in override_settings writes every file before the
    response, and the option is back on after it."""
    both(sdtpu_async_save=True)
    api = Api(Engine(device="cpu", tiny=True, seed=2, outdir=str(tmp_path / "out")))
    body = {"prompt": "a cat", "seed": 3, "steps": 1, "width": 64, "height": 64,
            "batch_size": 2, "save_images": True}
    status, res = api.handle("POST", "/sdapi/v1/txt2img", dict(body, override_settings={
        "samples_save": False, "grid_save": False}))
    assert status == 200 and len(res["images"]) == 3
    saving.flush_saves()
    assert not (tmp_path / "out").exists()
    status, res = api.handle("POST", "/sdapi/v1/txt2img", dict(body, override_settings={
        "sdtpu_async_save": False}))
    assert status == 200 and len(res["images"]) == 3
    assert sorted(_tree(tmp_path / "out")) == [
        "txt2img-grids/2024-05-06/grid-0000.png", "txt2img-images/2024-05-06/00000-3.png",
        "txt2img-images/2024-05-06/00001-4.png"]
    assert opts.get("sdtpu_async_save") is True


# --------------------------------------------------------------------------
# training inputs
# --------------------------------------------------------------------------

def test_preprocess_of_jpegs_equals_jax(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    (src / "a.jpg").write_bytes(_jpeg(_smooth(8, 96), quality=80))
    grey = io.BytesIO()
    Image.fromarray(_smooth(9, 80)[:, :, 0]).save(grey, "JPEG", quality=90, progressive=True)
    (src / "b.jpeg").write_bytes(grey.getvalue())
    jax_pre.preprocess_dir(str(src), str(tmp_path / "j"), width=64, height=64, flip=True)
    port_pre.preprocess_dir(str(src), str(tmp_path / "p"), width=64, height=64, flip=True,
                            device="cpu")
    names = sorted(os.listdir(tmp_path / "p"))
    assert names == sorted(os.listdir(tmp_path / "j")) and len(names) == 4
    for name in names:
        with Image.open(tmp_path / "j" / name) as ref:
            np.testing.assert_array_equal(
                decode_png((tmp_path / "p" / name).read_bytes())[0], np.asarray(ref))


def test_init_image_saved_through_save_image(models, f32_policies, tmp_path, both):  # noqa: F811
    """save_init_img goes through save_image: its callbacks see it and
    sdtpu_png_compress_level applies."""
    from sdwebui_tpu_torch.scripts import framework

    seen = []

    def hook(params):
        seen.append(os.path.basename(params.filename))

    framework.on("before_image_saved", hook)
    try:
        both(sdtpu_vae_bf16=False, sdtpu_png_compress_level=0, save_init_img=True,
             outdir_init_images=str(tmp_path))
        res = port_i2i.process_img2img(models[1], GenerationParams(
            init_images=[_init_image()], prompt="x", seed=1, steps=2, width=64, height=64))
    finally:
        framework._callbacks["before_image_saved"].remove(hook)
    saving.flush_saves()
    (name,) = os.listdir(tmp_path)
    assert seen == [name] and f"Init image hash: {name[:-4]}" in res.infotexts[0]
    data = (tmp_path / name).read_bytes()
    np.testing.assert_array_equal(decode_png(data)[0], _init_image())
    assert len(data) > 64 * 64 * 3       # stored, not deflated


@pytest.mark.parametrize("kind", ["jpeg", "png_text"])
def test_save_init_img_keeps_the_files_info(models, f32_policies, port_api, tmp_path,  # noqa: F811
                                            both, kind):
    """save_init_img of a client's JPEG or PNG: the saved init image carries
    the decoded file's info as text, as JAX's PIL image does."""
    init = _init_image(seed=5)
    data = _jpeg(init, text=TEXT) if kind == "jpeg" else _png(init, TEXT)
    kw = dict(prompt="a cat", seed=2, steps=2, width=64, height=64, denoising_strength=0.5)
    both(sdtpu_vae_bf16=False, save_init_img=True)
    for which in ("jax", "port"):
        both(outdir_init_images=str(tmp_path / which))
        if which == "jax":
            jax_i2i.process_img2img(models[0], JaxParams(
                init_images=[Image.open(io.BytesIO(data))], **kw))
        else:
            assert port_api.handle("POST", "/sdapi/v1/img2img",
                                   dict(kw, init_images=[_b64(data)]))[0] == 200
    _flush()
    (name,) = os.listdir(tmp_path / "port")
    assert os.listdir(tmp_path / "jax") == [name]
    img, text = decode_png((tmp_path / "port" / name).read_bytes())
    with Image.open(tmp_path / "jax" / name) as ref:
        np.testing.assert_array_equal(img, np.asarray(ref))
        # Pillow hands an "exif" text chunk back as bytes
        assert text == {k: v.decode("latin-1") if isinstance(v, bytes) else v
                        for k, v in ref.info.items()}
    assert ("exif" in text) == (kind == "jpeg") and len(text) >= 1
