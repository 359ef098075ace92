"""GIF, BMP, WebP and TIFF on every route that reads or writes an image, the
port against the JAX package's handlers and pipelines (the tiny SD1.5 pair
of test_torch_img2img): image fields (init image, mask, Extras, png-info),
the img2img batch's .webp and .bmp files, ``/internal/save-images``,
``samples_format`` / ``grid_format`` on the generation routes, Extras
``save_output``, and the preprocess directory.  Pixels within 1 level of
JAX's where a model ran, equal elsewhere (lossy WebP and GIF writes within
their bounds); names, infotexts and png-info items equal."""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
from torch_jax_state import jax_vae_file_reset  # noqa: F401  (JAX's loaded-VAE global)
import base64
import io
import json
import os
import struct
import time

import numpy as np
import pytest
from PIL import Image

from sdwebui_tpu.pipeline import img2img as jax_i2i
from sdwebui_tpu.pipeline.params import GenerationParams as JaxParams
from sdwebui_tpu.server import api as jax_api
from sdwebui_tpu.server import app as jax_app
from sdwebui_tpu.server import ui_actions as jax_ui
from sdwebui_tpu.training import preprocess as jax_pre
from sdwebui_tpu.utils import images as jax_images
from sdwebui_tpu_torch.server.api import Api
from sdwebui_tpu_torch.server.app import Engine
from sdwebui_tpu_torch.training import preprocess as port_pre
from sdwebui_tpu_torch.utils import exif, images as images_util, saving
from sdwebui_tpu_torch.utils.image_io import decode_image, read_image_file
from sdwebui_tpu_torch.utils.png import decode_png, encode_png
from test_torch_img2img import _init_image, _rect_mask, f32_policies, models  # noqa: F401
from test_torch_save_routes import TEXT, _b64, _flush, _jax_self, _smooth, _tree
from test_torch_saving import both, fixed_clock  # noqa: F401

_FORMATS = ("GIF", "BMP", "WEBP", "TIFF")


def _encode(a: np.ndarray, fmt: str, text: str | None = None) -> bytes:
    """Pillow's file of `a` in `fmt` (a palette GIF of its colours, a
    lossy WebP, an LZW TIFF), with `text` where the format carries it."""
    buf = io.BytesIO()
    im = Image.fromarray(a)
    if fmt == "GIF":
        im.save(buf, "GIF", comment=text)
    elif fmt == "WEBP":
        kw = {"exif": exif.build_exif_bytes(text)} if text else {}
        im.save(buf, "WEBP", quality=90, **kw)
    elif fmt == "TIFF":
        im.save(buf, "TIFF", compression="tiff_lzw")
    else:
        im.save(buf, fmt)
    return buf.getvalue()


def _rgb(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


@pytest.fixture(scope="module")
def port_api(models):  # noqa: F811
    return Api(Engine(model=models[1], device="cpu", hash_cache=None))


# --------------------------------------------------------------------------
# image fields
# --------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", _FORMATS)
@pytest.mark.parametrize("route,field", [("/sdapi/v1/img2img", "init_images"),
                                         ("/sdapi/v1/img2img", "mask"),
                                         ("/sdapi/v1/extra-single-image", "image"),
                                         ("/sdapi/v1/png-info", "image")])
def test_input_formats_match_jax(port_api, both, route, field, fmt):
    """Each field takes the format as JAX's route does: the answer is the
    one its PNG of Pillow's decoded pixels gets, and png-info answers as
    JAX's handler."""
    both(sdtpu_vae_bf16=False)
    data = _encode(_smooth(4 + _FORMATS.index(fmt)) if field != "mask" else
                   np.repeat(_rect_mask()[:, :, None], 3, axis=2), fmt, TEXT)
    png = encode_png(_rgb(data))
    if route.endswith("png-info"):
        body = {"image": _b64(data)}
        ref = jax_api.Api.png_info(None, body)
        status, out = port_api.handle("POST", route, body)
        assert status == 200, out
        assert out["info"] == ref["info"] and out["parameters"] == ref["parameters"]
        keep = {k: v for k, v in ref["items"].items()
                if not isinstance(v, bytes) and not (isinstance(v, tuple) and
                                                     any(isinstance(x, bytes) for x in v))}
        assert json.loads(json.dumps(out["items"])) == json.loads(json.dumps(keep))
        return
    answers = []
    for payload in (data, png):
        if route.endswith("img2img"):
            body = {"init_images": [_b64(encode_png(_init_image(seed=3)))], "prompt": "a cat",
                    "seed": 12, "steps": 2, "width": 64, "height": 64, "mask_blur": 0,
                    "inpainting_fill": 1, "inpaint_full_res": False}
            body[field] = [_b64(payload)] if field == "init_images" else _b64(payload)
        else:
            body = {"image": _b64(payload), "upscaler_1": "Lanczos", "upscaling_resize": 1.5}
        status, out = port_api.handle("POST", route, body)
        assert status == 200, out
        answers.append(out.get("images") or out.get("image"))
    assert answers[0] == answers[1]


def _tiny_tiff(width: int, height: int, tags: dict) -> bytes:
    """A few hundred bytes of 8-bit grey TIFF declaring `width` × `height`,
    with `tags` ({tag: (type, values)}) laying out its strips or tiles."""
    entries = {256: (4, [width]), 257: (4, [height]), 258: (3, [8]), 259: (3, [1]),
               262: (3, [1]), **tags}
    ifd = struct.pack("<H", len(entries))
    for tag, (typ, vals) in sorted(entries.items()):
        raw = struct.pack("<" + {3: "H", 4: "I"}[typ] * len(vals), *vals)
        ifd += struct.pack("<HHI", tag, typ, len(vals)) + raw.ljust(4, b"\0")
    return b"II*\x00" + struct.pack("<I", 8) + ifd + struct.pack("<I", 0) + b"\x80" * 16


def _tiny_vp8(width: int, height: int) -> bytes:
    """A 60-byte lossy WebP declaring `width` × `height` over zero bits."""
    tag = (20 << 5) | (1 << 4)           # a shown key frame, partition 0 of 20 bytes
    frame = struct.pack("<I", tag)[:3] + b"\x9d\x01\x2a" + struct.pack("<HH", width, height) \
        + bytes(30)
    chunk = b"VP8 " + struct.pack("<I", len(frame)) + frame
    return b"RIFF" + struct.pack("<I", 4 + len(chunk)) + b"WEBP" + chunk


def _truncated_webp() -> bytes:
    """Pillow's lossy WebP with its VP8 data cut to two thirds, the sizes
    made to agree."""
    data = _encode(_smooth(13), "WEBP")
    n = struct.unpack_from("<I", data, 16)[0] * 2 // 3
    chunk = b"VP8 " + struct.pack("<I", n) + data[20:20 + n] + b"\0" * (n & 1)
    return b"RIFF" + struct.pack("<I", 4 + len(chunk)) + b"WEBP" + chunk


_MALFORMED = {
    "webp_truncated": _truncated_webp,
    "webp_13000_of_zeros": lambda: _tiny_vp8(13000, 13000),
    "tiff_1x1_tiles_13000": lambda: _tiny_tiff(13000, 13000, {
        322: (3, [1]), 323: (3, [1]), 324: (4, [0]), 325: (4, [1])}),
    "tiff_170M_one_row_strips": lambda: _tiny_tiff(1, 170_000_000, {
        273: (4, [0]), 278: (4, [1]), 279: (4, [1])}),
    "tiff_tile_width_0": lambda: _tiny_tiff(16, 16, {
        322: (3, [0]), 323: (3, [16]), 324: (4, [0]), 325: (4, [1])}),
}


@pytest.mark.parametrize("case", sorted(_MALFORMED))
def test_malformed_files_answer_400(port_api, case):
    """A truncated frame, or a few hundred bytes declaring a huge image,
    answers 400 on an image field within a second, before any buffer of
    the declared size is made; JAX's Pillow refuses the small ones too."""
    data = _MALFORMED[case]()
    t0 = time.perf_counter()
    status, out = port_api.handle("POST", "/sdapi/v1/extra-single-image", {
        "image": _b64(data), "upscaler_1": "Lanczos", "upscaling_resize": 1.5})
    assert status == 400, out
    assert time.perf_counter() - t0 < 1.0
    if case in ("webp_truncated", "tiff_tile_width_0"):
        with pytest.raises(OSError):
            jax_app.decode_base64_to_image(_b64(data)).load()


def test_webp_preview_encoded_once_beside_png(port_api, both, monkeypatch):
    """A client polling /progress (PNG) beside the UI polling
    /internal/progress in webp: each format is encoded once per preview,
    not again at every poll of the other, and a new job's first preview
    (its id restarts at 1) is encoded anew."""
    from sdwebui_tpu_torch.utils import webp

    both(live_previews_image_format="webp")
    calls = []
    real = webp.encode_webp
    monkeypatch.setattr(webp, "encode_webp", lambda *a, **k: calls.append(1) or real(*a, **k))
    state = port_api.engine.state
    for image in (_smooth(14), _smooth(15)):
        state.begin("t")
        try:
            state.set_current_image(image)
            for _ in range(3):
                status, out = port_api.handle("GET", "/sdapi/v1/progress", None)
                assert status == 200, out
                np.testing.assert_array_equal(
                    decode_png(base64.b64decode(out["current_image"]))[0], image)
                status, out = port_api.handle("POST", "/internal/progress",
                                              {"id_task": "t", "live_preview": True})
                assert status == 200 and out["live_preview"].startswith("data:image/webp"), out
        finally:
            state.end()
            state.set_current_image(None)
    assert len(calls) == 2


@pytest.mark.parametrize("fmt", ["GIF", "WEBP"])
def test_init_image_matches_jax_pipeline(models, f32_policies, port_api, both, fmt):  # noqa: F811
    """An init image as a GIF and as a lossy WebP (the two whose pixels are
    not the source's): JAX's process_img2img on Pillow's decode of the same
    bytes, within 1 level, the same infotext.  Every format's answer
    equals its PNG's (test_input_formats_match_jax)."""
    both(sdtpu_vae_bf16=False)
    data = _encode(_init_image(seed=5), fmt)
    kw = dict(prompt="a cat", seed=13, steps=2, width=64, height=64, denoising_strength=0.7)
    ref = jax_i2i.process_img2img(models[0], JaxParams(
        init_images=[Image.open(io.BytesIO(data)).convert("RGB")], **kw))
    status, out = port_api.handle("POST", "/sdapi/v1/img2img", dict(
        kw, init_images=[f"data:image/{fmt.lower()};base64," + _b64(data)]))
    assert status == 200, out
    img, text = decode_png(base64.b64decode(out["images"][0]))
    assert np.abs(img.astype(int) - np.asarray(ref.images[0], int)).max() <= 1
    assert text["parameters"] == ref.infotexts[0]


@pytest.mark.parametrize("kind", ["webp_exif", "webp_lossless_exif", "gif_comment", "bmp",
                                  "tiff", "webp_alpha", "gif_transparent"])
def test_png_info_of_each_format(port_api, kind):
    img = _smooth(6, 24)
    rgba = np.concatenate([img, np.full(img.shape[:2] + (1,), 128, np.uint8)], 2)
    buf = io.BytesIO()
    if kind.startswith("webp"):
        src = rgba if kind == "webp_alpha" else img
        kw = {} if kind == "webp_alpha" else {"exif": exif.build_exif_bytes(TEXT)}
        Image.fromarray(src).save(buf, "WEBP", lossless="lossless" in kind, **kw)
    elif kind == "gif_transparent":
        Image.fromarray(img).save(buf, "GIF", transparency=3, duration=50, loop=0)
    else:
        Image.fromarray(img).save(buf, kind.split("_")[0].upper(),
                                  **({"comment": TEXT} if "comment" in kind else {}))
    body = {"image": _b64(buf.getvalue())}
    ref = jax_api.Api.png_info(None, body)
    status, out = port_api.handle("POST", "/sdapi/v1/png-info", body)
    assert status == 200
    assert out["info"] == ref["info"] and out["parameters"] == ref["parameters"]
    keep = {k: v for k, v in ref["items"].items()
            if not isinstance(v, bytes) and not (isinstance(v, tuple) and
                                                 any(isinstance(x, bytes) for x in v))}
    assert json.loads(json.dumps(out["items"])) == json.loads(json.dumps(keep))
    if kind.endswith("exif"):
        assert out["info"] == TEXT
    if kind == "gif_comment":   # JAX does not read a GIF's comment as infotext
        assert out["info"] == "" and "comment" in ref["items"]


# --------------------------------------------------------------------------
# the img2img batch
# --------------------------------------------------------------------------


def test_img2img_batch_reads_webp_and_bmp_as_jax(models, f32_policies, port_api,  # noqa: F811
                                                 tmp_path, both, fixed_clock):  # noqa: F811
    """A lossy WebP with an EXIF infotext, a lossless WebP, a BMP and a TIFF
    under a .png name, use_png_info: the same outputs and infotexts as
    JAX's batch."""
    both(sdtpu_vae_bf16=False)
    src = tmp_path / "in"
    src.mkdir()
    (src / "a.webp").write_bytes(_encode(_smooth(1), "WEBP", TEXT))
    buf = io.BytesIO()
    Image.fromarray(_smooth(2)).save(buf, "WEBP", lossless=True)
    (src / "b.webp").write_bytes(buf.getvalue())
    (src / "c.bmp").write_bytes(_encode(_smooth(3), "BMP"))
    (src / "d.png").write_bytes(_encode(_smooth(4), "TIFF"))
    body = {"input_dir": str(src), "use_png_info": True, "png_info_props": ["Prompt", "Seed"],
            "prompt": "base", "seed": 9, "steps": 2, "width": 64, "height": 64,
            "denoising_strength": 0.6}
    ref = jax_api.Api.img2img_batch(_jax_self(models[0]),
                                    dict(body, output_dir=str(tmp_path / "jax")))
    status, out = port_api.handle("POST", "/internal/img2img-batch",
                                  dict(body, output_dir=str(tmp_path / "port")))
    assert status == 200, out
    assert out["processed"] == ref["processed"] == 4
    assert [os.path.basename(f) for f in out["outputs"]] == \
        [os.path.basename(f) for f in ref["outputs"]]
    for ours, theirs in zip(out["outputs"], ref["outputs"]):
        img, text = decode_png(open(ours, "rb").read())
        with Image.open(theirs) as im:
            assert np.abs(img.astype(int) - np.asarray(im, int)).max() <= 1
            assert text["parameters"] == im.info["parameters"]
    assert "Seed: 77" in decode_png(open(out["outputs"][0], "rb").read())[1]["parameters"]


# --------------------------------------------------------------------------
# writing in each format
# --------------------------------------------------------------------------


def _close(got: np.ndarray, want: np.ndarray, fmt: str) -> None:
    """Exact for the lossless formats; lossy WebP (at the default quality,
    80) and GIF within 1.25× the mean error of Pillow's own file of the
    same pixels."""
    if fmt in ("webp", "gif"):
        assert got.shape == want.shape
        buf = io.BytesIO()
        Image.fromarray(want).save(buf, fmt.upper(), **({"quality": 80} if fmt == "webp" else {}))
        pil_err = np.abs(_rgb(buf.getvalue()).astype(int) - want).mean()
        assert np.abs(got.astype(int) - want).mean() <= 1.25 * pil_err
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fmt", ["webp", "gif", "bmp", "tiff"])
def test_save_images_route_in_each_format(port_api, tmp_path, both, fixed_clock,  # noqa: F811
                                          fmt):
    """/internal/save-images with samples_format: JAX's file names and
    log.csv rows, each file decoding to the posted pixels (exactly for BMP
    and TIFF, as JAX's files; within the bound for lossy WebP and GIF), a
    WebP's infotext readable."""
    rng = np.random.default_rng(3)
    imgs = [_smooth(10 + i, 48) for i in range(2)] + [rng.integers(0, 256, (16, 16, 3),
                                                                     dtype=np.uint8)]
    js = {"prompt": "a red cat", "seed": 77, "all_seeds": [77, 78], "infotexts": [TEXT] * 3,
          "index_of_first_image": 0, "width": 48, "height": 48, "sampler_name": "Euler a",
          "cfg_scale": 6.5, "steps": 2, "batch_size": 3}
    body = {"info": json.dumps(js), "images": [_b64(encode_png(a)) for a in imgs[:2]],
            "do_make_zip": False, "index": -1}
    files = {}
    for which in ("jax", "port"):
        both(outdir_save=str(tmp_path / which), samples_format=fmt)
        if which == "jax":
            jax_ui.save_files_from_json(dict(body))
        else:
            status, res = port_api.handle("POST", "/internal/save-images", dict(body))
            assert status == 200, res
        _flush()
        files[which] = _tree(tmp_path / which)
    assert sorted(files["port"]) == sorted(files["jax"])
    pictures = sorted(n for n in files["port"] if not n.endswith(".csv"))
    assert len(pictures) == 2
    for name, path in files["port"].items():
        if name.endswith(".csv"):
            assert open(path).read() == open(files["jax"][name]).read()
            continue
        got = read_image_file(path)[0]
        _close(got, imgs[pictures.index(name)], fmt)
        if fmt in ("bmp", "tiff"):
            with Image.open(files["jax"][name]) as im:
                np.testing.assert_array_equal(got, np.asarray(im.convert("RGB")))
        if fmt == "webp":
            assert saving.read_info_from_image(read_image_file(path)[1]) == TEXT


@pytest.mark.parametrize("fmt", ["webp", "gif", "bmp", "tiff"])
def test_generation_routes_save_each_format(tmp_path, both, fixed_clock, fmt):  # noqa: F811
    """save_images on txt2img with samples_format and grid_format: the
    names JAX's Engine gives, each file decoding to the response's pixels
    (exact for BMP and TIFF), the WebP infotext back through png-info."""
    both(sdtpu_async_save=False)
    api = Api(Engine(device="cpu", tiny=True, seed=2, outdir=str(tmp_path / "out"),
                     hash_cache=None))
    status, res = api.handle("POST", "/sdapi/v1/txt2img", {
        "prompt": "a cat", "seed": 3, "steps": 1, "width": 64, "height": 64, "batch_size": 2,
        "save_images": True, "override_settings": {"samples_format": fmt, "grid_format": fmt}})
    assert status == 200, res
    tree = _tree(tmp_path / "out")
    assert sorted(tree) == [f"txt2img-grids/2024-05-06/grid-0000.{fmt}",
                            f"txt2img-images/2024-05-06/00000-3.{fmt}",
                            f"txt2img-images/2024-05-06/00001-4.{fmt}"]
    infos = json.loads(res["info"])["infotexts"]
    for i, name in enumerate(sorted(tree)):
        got, info = read_image_file(tree[name])
        shown = decode_png(base64.b64decode(res["images"][i]))[0]
        _close(got, shown, fmt)
        if fmt == "webp" and "grid" not in name:
            status, pi = api.handle("POST", "/sdapi/v1/png-info",
                                    {"image": _b64(open(tree[name], "rb").read())})
            assert pi["info"] == infos[i]


def test_extras_save_output_in_webp(port_api, tmp_path, both):
    both(outdir_extras_samples=str(tmp_path / "x"), samples_format="webp", webp_lossless=True)
    png = encode_png(_smooth(7))
    status, out = port_api.handle("POST", "/sdapi/v1/extra-single-image", {
        "image": _b64(png), "upscaler_1": "Lanczos", "upscaling_resize": 1, "save_output": True})
    assert status == 200, out
    _flush()
    (path,) = _tree(tmp_path / "x").values()
    assert path.endswith(".webp")
    np.testing.assert_array_equal(read_image_file(path)[0],
                                  decode_png(base64.b64decode(out["image"]))[0])


# --------------------------------------------------------------------------
# training inputs
# --------------------------------------------------------------------------


def test_preprocess_of_each_format_equals_jax(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    (src / "a.webp").write_bytes(_encode(_smooth(8, 96), "WEBP"))
    (src / "b.bmp").write_bytes(_encode(_smooth(9, 80), "BMP"))
    buf = io.BytesIO()
    Image.fromarray(_smooth(10, 72)).save(buf, "WEBP", lossless=True)
    (src / "c.webp").write_bytes(buf.getvalue())
    jax_pre.preprocess_dir(str(src), str(tmp_path / "j"), width=64, height=64, flip=True)
    port_pre.preprocess_dir(str(src), str(tmp_path / "p"), width=64, height=64, flip=True,
                            device="cpu")
    names = sorted(os.listdir(tmp_path / "p"))
    assert names == sorted(os.listdir(tmp_path / "j")) and len(names) == 6
    for name in names:
        with Image.open(tmp_path / "j" / name) as ref:
            np.testing.assert_array_equal(decode_image((tmp_path / "p" / name).read_bytes())[0],
                                          np.asarray(ref))


def test_flatten_of_each_decoded_mode_equals_jax():
    """img2img's flatten over what each decoder gives: RGBA WebP composited,
    palette transparency dropped, "I;16" clipped, as JAX's Pillow image."""
    rgba = np.concatenate([_smooth(11, 16), np.arange(256, dtype=np.uint8).reshape(16, 16, 1)],
                          2)
    cases = [_encode(rgba, "WEBP")]
    buf = io.BytesIO()
    Image.fromarray(_smooth(12, 16)).save(buf, "GIF", transparency=2)
    cases.append(buf.getvalue())
    buf = io.BytesIO()
    Image.fromarray(np.arange(0, 1024, 4, dtype=np.uint16).reshape(16, 16)).save(buf, "TIFF")
    cases.append(buf.getvalue())
    for data in cases:
        got = decode_image(data)[0]
        with Image.open(io.BytesIO(data)) as im:
            want = np.asarray(jax_images.flatten(im, "#ffffff"))
        np.testing.assert_array_equal(images_util.flatten(got, "#ffffff"), want)
