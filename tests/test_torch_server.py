"""The port's HTTP server (tiny model, CPU), its PNG codec, and its import
hygiene: the slice imports and runs — checkpoint files, the samplers, hires
fix, the upscalers, the Extras route, extra networks, ControlNet, the
merger, the UI's routes and extensions included — with the JAX package, jax, PIL, pydantic, ml_dtypes, safetensors and cv2
blocked."""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
from torch_jax_state import jax_vae_file_reset  # noqa: F401  (JAX's loaded-VAE global)
import base64
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from sdwebui_tpu_torch.utils.png import decode_png, encode_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def server_url():
    from sdwebui_tpu_torch.server.api import make_server
    from sdwebui_tpu_torch.server.app import Engine

    server = make_server(Engine(device="cpu", tiny=True, seed=1), "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)


def _call(url, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_txt2img_returns_png_with_infotext(server_url):
    status, res = _call(server_url, "/sdapi/v1/txt2img", {
        "prompt": "a cat", "seed": 42, "steps": 2, "width": 64, "height": 64,
        "batch_size": 2, "cfg_scale": 7.5, "sampler_name": "Euler a"})
    assert status == 200
    info = json.loads(res["info"])
    assert info["all_seeds"] == [42, 43] and info["index_of_first_image"] == 0
    assert len(res["images"]) == 2
    for i, b64 in enumerate(res["images"]):
        img, text = decode_png(base64.b64decode(b64))
        assert img.shape == (64, 64, 3) and img.dtype == np.uint8
        assert f"Seed: {42 + i}" in text["parameters"]
        assert "Sampler: Euler a" in text["parameters"]


@pytest.mark.parametrize("body,field", [
    ({"save_images": True, "override_settings": {"grid_format": "avif"}}, "avif"),
    ({"no_such_field": 1}, "no_such_field"),
    ({"override_settings": {"samples_log_stdout": True}}, "samples_log_stdout"),
    ({"override_settings": {"sd_model_checkpoint": "x"}}, "sd_model_checkpoint"),
    ({"enable_hr": True, "hr_scale": 1.5, "hr_prompt": "a <lora:x:1>"}, "lora"),
])
def test_out_of_slice_fields_answer_422(server_url, body, field):
    status, res = _call(server_url, "/sdapi/v1/txt2img",
                        {"steps": 1, "width": 64, "height": 64, **body})
    assert status == 422
    assert field in res["detail"]


@pytest.mark.parametrize("override,field", [
    ({"token_merging_ratio": 0.5}, "Token merging ratio: 0.5"),
    ({"token_merging_ratio_hr": 0.5, "hypertile_enable_unet": True, "upcast_attn": True,
      "sd_unet": "None"}, "Hires upscale: 1.5"),
], ids=["token_merging_ratio", "token_merging_ratio_hr"])
def test_unet_options_over_http(server_url, override, field):
    """The options the server used to refuse serve a request."""
    hr = {"enable_hr": True, "hr_scale": 1.5, "denoising_strength": 0.5} \
        if "token_merging_ratio_hr" in override else {}
    status, res = _call(server_url, "/sdapi/v1/txt2img", {
        "prompt": "a cat", "seed": 4, "steps": 2, "width": 64, "height": 64,
        "override_settings": override, **hr})
    assert status == 200, res
    assert field in json.loads(res["info"])["infotexts"][0]


def test_xla_attention_serves_on_the_plain_path(monkeypatch):
    """cross_attention_optimization "xla" (the option table's JAX name)
    set over /sdapi/v1/options serves a request on the plain path: no B2
    launch, the forced impl "plain" (JAX maps it to its einsum path)."""
    from sdwebui_tpu_torch.ops import attention, flash_attention
    from sdwebui_tpu_torch.server.api import make_server
    from sdwebui_tpu_torch.server.app import Engine
    from sdwebui_tpu_torch.utils.options import opts

    seen = []
    real = attention.plain_attention
    monkeypatch.setattr(attention, "plain_attention",
                        lambda *a, **k: seen.append(attention.get_forced_impl()) or real(*a, **k))
    server = make_server(Engine(device="cpu", tiny=True, seed=1), "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        flash_attention.reset_launch_count()
        assert _call(url, "/sdapi/v1/options", {"cross_attention_optimization": "xla"})[0] == 200
        status, res = _call(url, "/sdapi/v1/txt2img", {"prompt": "a cat", "steps": 1,
                                                      "width": 64, "height": 64})
        assert status == 200 and len(res["images"]) == 1
        assert flash_attention.launch_count("flash_attention_packed") == 0
        assert seen and set(seen) == {"plain"}
    finally:
        _call(url, "/sdapi/v1/options", {"cross_attention_optimization": "Automatic"})
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
        opts.data.pop("cross_attention_optimization", None)
        attention.set_attention_impl(None)


def test_engine_keeps_job_state():
    from sdwebui_tpu_torch.pipeline.params import GenerationParams
    from sdwebui_tpu_torch.server.app import Engine

    engine = Engine(device="cpu", tiny=True, seed=2)
    seen = []
    real = engine._step_callback

    def spy(i, n, latents):
        seen.append((engine.state.job, engine.state.job_count))
        return real(i, n, latents)

    engine._step_callback = spy
    res = engine.txt2img(GenerationParams(prompt="a cat", seed=5, steps=2,
                                          width=64, height=64))
    assert res.images[0].shape == (64, 64, 3)
    assert seen == [("txt2img", 1)] * 2
    assert (engine.state.sampling_step, engine.state.sampling_steps) == (2, 2)
    assert engine.state.job == "" and engine.state.job_count == 0


def test_bad_requests_and_listing(server_url):
    assert _call(server_url, "/sdapi/v1/txt2img", {"sampler_name": "nope"})[0] == 400
    assert _call(server_url, "/sdapi/v1/txt2img", {"steps": 0})[0] == 400
    for body in ({"steps": "20"}, {"prompt": 3}, {"override_settings": []},
                 {"seed": True}):
        status, res = _call(server_url, "/sdapi/v1/txt2img", body)
        assert status == 422 and next(iter(body)) in res["detail"]
    assert _call(server_url, "/internal/ping") == (200, {})
    status, samplers = _call(server_url, "/sdapi/v1/samplers")
    assert status == 200 and len(samplers) == 24
    assert [s["name"] for s in samplers][:2] == ["DPM++ 2M", "DPM++ SDE"]
    assert _call(server_url, "/sdapi/v1/nothing")[0] == 404


def test_png_roundtrip_and_pil_interop():
    from PIL import Image

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (13, 17, 3), dtype=np.uint8)
    data = encode_png(img, {"parameters": "Steps: 20, Sampler: Euler a — ü"})
    out, text = decode_png(data)
    np.testing.assert_array_equal(out, img)
    assert text["parameters"].endswith("— ü")
    import io

    pil = Image.open(io.BytesIO(data))
    np.testing.assert_array_equal(np.asarray(pil), img)
    assert pil.text["parameters"] == text["parameters"]
    rgba = rng.integers(0, 256, (5, 4, 4), dtype=np.uint8)
    np.testing.assert_array_equal(decode_png(encode_png(rgba))[0], rgba)
    # PIL writes filtered rows, which the reader undoes
    buf = io.BytesIO()
    smooth = np.cumsum(rng.integers(0, 3, (9, 11, 3)), axis=1).astype(np.uint8)
    Image.fromarray(smooth, "RGB").save(buf, format="PNG", optimize=True)
    np.testing.assert_array_equal(decode_png(buf.getvalue())[0], smooth)


_HYGIENE = r"""
import importlib, json, pkgutil, sys
BLOCKED = ("sdwebui_tpu", "jax", "jaxlib", "PIL", "pydantic", "ml_dtypes", "safetensors", "cv2",
           "tokenizers", "transformers", "sentencepiece", "fontTools")


class Recorder:
    # blocks like sys.modules[name] = None, and also records every attempt
    # to import a blocked package, even one that a caller catches and ignores
    attempts = []

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            self.attempts.append(name)
            raise ImportError(f"{name} is blocked")
        return None


sys.meta_path.insert(0, Recorder())
import sdwebui_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(sdwebui_tpu_torch.__path__, "sdwebui_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import base64
import numpy as np
from sdwebui_tpu_torch.pipeline.params import GenerationParams
from sdwebui_tpu_torch.pipeline.processing import process_txt2img
from sdwebui_tpu_torch.pipeline.sd_model import create_tiny_sd
from sdwebui_tpu_torch.server.api import Api
from sdwebui_tpu_torch.server.app import Engine
from sdwebui_tpu_torch.utils.png import encode_png
res = process_txt2img(create_tiny_sd(0, "cpu"), GenerationParams(
    prompt="a cat", seed=3, steps=2, width=64, height=64))
assert res.images[0].shape == (64, 64, 3)
from sdwebui_tpu_torch.parallel import collectives, mesh, sequence, sharding, spatial
from sdwebui_tpu_torch.training import train_step
rt = mesh.MeshRuntime.create(data=2, model=2, devices=["cpu"] * 4)
res = process_txt2img(create_tiny_sd(0, "cpu").replicate(rt), GenerationParams(
    prompt="a cat", seed=3, steps=1, width=64, height=64, batch_size=2))
assert len(res.images) == 3 and res.images[-1].shape == (64, 64, 3)
api = Api(Engine(device="cpu", tiny=True))
status, out = api.handle(
    "POST", "/sdapi/v1/txt2img", {"steps": 1, "width": 64, "height": 64})
assert status == 200, out
png = base64.b64encode(encode_png(np.full((64, 64, 3), 90, np.uint8))).decode()
# the rarer formats read and written with no Pillow: a TGA and a QOI
# through the open order, and the generic branch's writers
from sdwebui_tpu_torch.utils import image_io, qoi, tga, saving
a = np.random.default_rng(0).integers(0, 256, (16, 16, 3), dtype=np.uint8)
for data in (tga.encode_tga(a), qoi.encode_qoi(a)):
    assert (image_io.decode_image(data)[0] == a).all()
for ext in ("ppm", "tga", "qoi", "sgi", "pcx", "dds", "im", "pdf", "eps", "mpo", "ico"):
    assert saving._generic(a, "." + ext, "x." + ext, 80)
status, out = api.handle("POST", "/sdapi/v1/img2img", {
    "init_images": [png], "mask": png, "inpaint_full_res": False, "inpainting_fill": 1,
    "steps": 2, "width": 64, "height": 64})
assert status == 200, out
status, out = api.handle("POST", "/sdapi/v1/txt2img", {
    "steps": 1, "width": 64, "height": 64, "script_name": "X/Y/Z plot",
    "script_args": ["Seed", "1-2", "Nothing", "", "Nothing", "", False]})
assert status == 200 and len(out["images"]) == 3, out
status, out = api.handle("POST", "/sdapi/v1/txt2img", {
    "steps": 1, "width": 64, "height": 64, "script_name": "X/Y/Z plot",
    "script_args": ["Seed", "1-2", "Steps", "1", "Nothing", "", True]})
assert status == 200 and len(out["images"]) == 3, out
status, out = api.handle("POST", "/sdapi/v1/txt2img", {
    "prompt": "a cat | red", "steps": 1, "width": 64, "height": 64,
    "script_name": "Prompt matrix", "script_args": [False]})
assert status == 200 and len(out["images"]) == 3, out
from sdwebui_tpu_torch.training.textual_inversion import card_image
assert card_image("card", np.ones((1, 8), np.float32), 3)[230:240].std() > 0
from sdwebui_tpu_torch.pipeline.sd_model import create_tiny_sd3
rt = mesh.MeshRuntime.create(data=1, model=2, devices=["cpu"] * 2)
res = process_txt2img(create_tiny_sd3(0, "cpu").replicate(rt), GenerationParams(
    prompt="a cat", seed=3, steps=1, width=64, height=64, sampler_name="Euler"))
assert res.images[0].shape == (64, 64, 3)
status, out = api.handle("POST", "/sdapi/v1/txt2img", {
    "steps": 1, "width": 64, "height": 64, "postprocessing": {
        "enable": ["Upscale"], "upscaler_1": "Lanczos", "upscaling_resize": 1.5}})
assert status == 200, out
assert "Postprocessing: Upscale" in json.loads(out["info"])["infotexts"][0], out
import os, tempfile, torch
from sdwebui_tpu_torch.loader.load import ldm_state_dict
from sdwebui_tpu_torch.loader.safetensors_io import write_safetensors
from sdwebui_tpu_torch.loader.torch_ckpt import load_torch_checkpoint
with tempfile.TemporaryDirectory() as d:
    sd = ldm_state_dict(create_tiny_sd(1, "cpu"))
    write_safetensors(os.path.join(d, "a.safetensors"), sd)
    torch.save({"state_dict": sd}, os.path.join(d, "b.ckpt"))
    assert load_torch_checkpoint(os.path.join(d, "b.ckpt")).keys() == sd.keys()
    api = Api(Engine(device="cpu", ckpt=os.path.join(d, "a.safetensors"), ckpt_dirs=[d],
                     hash_cache=os.path.join(d, "cache.json")))
    for sampler in ("DPM++ SDE", "UniPC", "DPM adaptive"):
        status, out = api.handle("POST", "/sdapi/v1/txt2img", {
            "steps": 2, "width": 64, "height": 64, "sampler_name": sampler})
        assert status == 200, out
    assert api.handle("POST", "/sdapi/v1/options", {"sd_model_checkpoint": "b"}) == (200, {})
    assert len(api.handle("GET", "/sdapi/v1/sd-models", None)[1]) == 2
from sdwebui_tpu_torch.models.esrgan import SRVGGNetCompact, register_esrgan_dir
with tempfile.TemporaryDirectory() as d:
    net = SRVGGNetCompact(nf=8, num_conv=2)
    g = torch.Generator().manual_seed(0)
    write_safetensors(os.path.join(d, "realesr-t.safetensors"), {
        k: torch.randn(v.shape, generator=g) * 0.05 for k, v in net.state_dict().items()})
    assert register_esrgan_dir((d,), device="cpu") == ["realesr-t"]
    api = Api(Engine(device="cpu", tiny=True))
    for upscaler in ("Latent (bicubic)", "realesr-t"):
        status, out = api.handle("POST", "/sdapi/v1/txt2img", {
            "steps": 2, "width": 64, "height": 64, "enable_hr": True, "hr_scale": 1.5,
            "hr_upscaler": upscaler, "denoising_strength": 0.5})
        assert status == 200, out
    small = base64.b64encode(encode_png(np.full((32, 48, 3), 90, np.uint8))).decode()
    status, out = api.handle("POST", "/sdapi/v1/extra-single-image", {
        "image": small, "upscaler_1": "realesr-t", "upscaler_2": "Lanczos",
        "extras_upscaler_2_visibility": 0.5})
    assert status == 200, out
    status, out = api.handle("POST", "/sdapi/v1/img2img", {
        "init_images": [small], "resize_mode": 1, "steps": 2, "width": 64, "height": 64,
        "override_settings": {"upscaler_for_img2img": "realesr-t"}})
    assert status == 200, out
from sdwebui_tpu_torch.models.controlnet import ControlNetModel
from sdwebui_tpu_torch.models.layers import reset_random
from sdwebui_tpu_torch.networks.extra_networks import DEFAULT_LORA_DIRS, set_lora_dirs
from sdwebui_tpu_torch.pipeline import control
from sdwebui_tpu_torch.pipeline.sd_model import TINY_UNET
with tempfile.TemporaryDirectory() as d:
    g = torch.Generator().manual_seed(0)
    write_safetensors(os.path.join(d, "tiemb.safetensors"),
                      {"emb_params": torch.randn(2, 64, generator=g)})
    key = "lora_unet_input_blocks_1_1_transformer_blocks_0_attn1_to_q"
    write_safetensors(os.path.join(d, "tl.safetensors"), {
        key + ".lora_up.weight": torch.randn(32, 4, generator=g),
        key + ".lora_down.weight": torch.randn(4, 32, generator=g)})
    tower = ControlNetModel(TINY_UNET, device="cpu", dtype=torch.float32)
    reset_random(tower, g)
    write_safetensors(os.path.join(d, "cn.safetensors"),
                      {"control_model." + k: v for k, v in tower.state_dict().items()})
    set_lora_dirs([d])
    control.set_model_dirs([d])
    api = Api(Engine(device="cpu", tiny=True, embeddings_dir=d))
    grid = np.zeros((64, 64, 3), np.uint8)
    grid[::16] = 255
    hint = base64.b64encode(encode_png(grid)).decode()
    status, out = api.handle("POST", "/sdapi/v1/txt2img", {
        "prompt": "a tiemb cat <lora:tl:0.8>", "steps": 2, "width": 64, "height": 64,
        "controlnet_units": [{"model": "cn", "module": "canny", "image": hint}]})
    assert status == 200, out
    assert "TI hashes" in json.loads(out["info"])["infotexts"][0]
    status, out = api.handle("POST", "/sdapi/v1/img2img", {
        "init_images": [png], "steps": 2, "width": 64, "height": 64,
        "alwayson_scripts": {"controlnet": {"args": [{"model": "cn", "weight": 0.5}]}}})
    assert status == 200, out
    status, out = api.handle("POST", "/controlnet/detect", {
        "controlnet_module": "canny", "controlnet_input_images": [hint],
        "controlnet_processor_res": 64})
    assert status == 200 and len(out["images"]) == 1, out
    set_lora_dirs(DEFAULT_LORA_DIRS)
    control.set_model_dirs([control.DEFAULT_CONTROLNET_DIR])
from sdwebui_tpu_torch.loader.load import load_model
from sdwebui_tpu_torch.models import clip_vision
from sdwebui_tpu_torch.pipeline.sd_model import create_tiny_sd3
from sdwebui_tpu_torch.text import sentencepiece
with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, "sd3.safetensors")
    sd = ldm_state_dict(create_tiny_sd3(0, "cpu"))
    write_safetensors(path, {k: v.to(torch.float8_e4m3fn) if "clip_l" in k and v.dim() == 2
                             else v for k, v in sd.items()})
    res = process_txt2img(load_model(path, device="cpu"), GenerationParams(
        prompt="a cat", seed=3, steps=2, width=64, height=64, sampler_name="Euler"))
    assert res.images[0].shape == (64, 64, 3)
    with open(os.path.join(d, "tokenizer.json"), "w") as f:
        json.dump({"model": {"type": "Unigram", "unk_id": 0,
                             "vocab": [["<unk>", 0.0], ["\u2581cat", -1.0]]}}, f)
    assert sentencepiece.make_t5_tokenizer(os.path.join(d, "tokenizer.json"), 4)("cat") == \
        [1, 1, 0, 0]
assert clip_vision.preprocess(np.zeros((40, 30, 3), np.uint8), 32).shape == (1, 3, 32, 32)
from sdwebui_tpu_torch.models.hed import create_random_hed
from sdwebui_tpu_torch.models.midas import create_random_dpt
from sdwebui_tpu_torch.pipeline import annotators
from sdwebui_tpu_torch.pipeline.img2img import process_img2img
from sdwebui_tpu_torch.pipeline.sd_model import TINY_DPT
init = np.kron(np.arange(48, dtype=np.uint8).reshape(4, 4, 3) * 5, np.ones((16, 16, 1), np.uint8))
for channels in (9, 8, 5):
    model = create_tiny_sd(0, "cpu", in_channels=channels)
    if channels != 8:
        assert process_txt2img(model, GenerationParams(
            prompt="a cat", seed=3, steps=2, width=64, height=64)).images[0].shape == (64, 64, 3)
    res = process_img2img(model, GenerationParams(
        prompt="a cat", seed=3, steps=2, width=64, height=64, init_images=[init],
        image_cfg_scale=1.5, mask=init[:, :, 0] if channels == 9 else None,
        inpaint_full_res=False, inpainting_fill=1))
    assert res.images[0].shape == (64, 64, 3)
with tempfile.TemporaryDirectory() as d:
    write_safetensors(os.path.join(d, "ControlNetHED.safetensors"),
                      create_random_hed(0, "cpu", (8, 12, 16, 16, 16)).state_dict())
    write_safetensors(os.path.join(d, "dpt_hybrid-midas.safetensors"),
                      create_random_dpt(0, "cpu", TINY_DPT).state_dict())
    prev = list(annotators._model_dirs)
    annotators.set_annotator_dirs([d])
    api = Api(Engine(device="cpu", tiny=True))
    for module in ("depth_midas", "hed", "hed_safe", "scribble_hed", "blur_gaussian",
                   "scribble_xdog", "shuffle"):
        for res in (48, 96):
            status, out = api.handle("POST", "/controlnet/detect", {
                "controlnet_module": module, "controlnet_input_images": [png],
                "controlnet_processor_res": res})
            assert status == 200 and len(out["images"]) == 1, (module, out)
    status, out = api.handle("POST", "/sdapi/v1/img2img", {
        "init_images": [png], "steps": 2, "width": 64, "height": 64, "image_cfg_scale": 1.5})
    assert status == 200, out
    annotators.set_annotator_dirs(prev)
from sdwebui_tpu_torch.models import vae_approx
from sdwebui_tpu_torch.utils import color
from sdwebui_tpu_torch.text.styles import StyleDatabase
with tempfile.TemporaryDirectory() as d:
    os.makedirs(os.path.join(d, "VAE-taesd"))
    for which in ("encoder", "decoder"):
        write_safetensors(os.path.join(d, "VAE-taesd", f"taesd_{which}.safetensors"),
                          vae_approx.random_taesd(which, seed=1).state_dict())
    vae_approx.set_models_root(d)
    with open(os.path.join(d, "styles.csv"), "w", encoding="utf-8") as f:
        f.write("name,prompt,negative_prompt\nx,\"{prompt}, styled\",\n")
    assert StyleDatabase(os.path.join(d, "styles.csv")).apply("a", "", ["x"])[0] == "a, styled"
    api = Api(Engine(device="cpu", tiny=True, styles_path=os.path.join(d, "styles.csv")))
    mask = np.zeros((64, 64), np.uint8)
    mask[16:40, 8:30] = 255
    status, out = api.handle("POST", "/sdapi/v1/img2img", {
        "init_images": [png], "mask": base64.b64encode(encode_png(mask)).decode(),
        "steps": 2, "width": 64, "height": 64, "styles": ["x"], "tiling": True,
        "soft_inpainting": True, "override_settings": {
            "img2img_color_correction": True, "sd_vae_encode_method": "TAESD",
            "sd_vae_decode_method": "TAESD", "return_mask": True}})
    assert status == 200 and len(out["images"]) == 2, out
    assert api.handle("GET", "/sdapi/v1/prompt-styles", None)[1][0]["name"] == "x"
    vae_approx.set_models_root("models")
assert color.apply_color_correction(color.setup_color_correction(
    np.full((8, 8, 3), 90, np.uint8)), np.full((8, 8, 3), 10, np.uint8)).max() == 90
import dataclasses
from sdwebui_tpu_torch.models import dat, hat, ldsr, scunet, swin2sr, swinir
from sdwebui_tpu_torch.utils.options import opts
from sdwebui_tpu_torch.postprocessing.upscalers import register_model_dirs, unregister_upscaler
with tempfile.TemporaryDirectory() as d:
    files = {
        ("SwinIR", "s1"): swinir.create_random_swinir(0, "cpu", swinir.SwinIRConfig(
            embed_dim=12, depths=(2,), num_heads=(2,), window_size=4, num_feat=8)),
        ("SwinIR", "s2"): swin2sr.create_random_swin2sr(0, "cpu", swin2sr.Swin2SRConfig(
            embed_dim=16, depths=(2,), num_heads=(2,), num_feat=16, cpb_hidden=16, scale=2)),
        ("HAT", "h"): hat.create_random_hat(0, "cpu", hat.HATConfig(
            embed_dim=12, depths=(2,), num_heads=(2,), window_size=4, squeeze_factor=4,
            num_feat=12, scale=2)),
        ("DAT", "d"): dat.create_random_dat(0, "cpu", dat.DATConfig(
            embed_dim=32, depths=(2,), num_heads=(2,), split_size=(2, 4), scale=2)),
        ("ScuNET", "sc"): scunet.create_random_scunet(0, "cpu", scunet.SCUNetConfig(
            dim=16, config=(1,) * 7, head_dim=8, window_size=4)),
    }
    for (sub, name), net in files.items():
        os.makedirs(os.path.join(d, sub), exist_ok=True)
        write_safetensors(os.path.join(d, sub, name + ".safetensors"), net.state_dict())
    os.makedirs(os.path.join(d, "LDSR"))
    tiny_ldsr = ldsr.create_random_ldsr(0, "cpu", ldsr.LDSRConfig(
        unet=dataclasses.replace(ldsr.LDSR_UNET, model_channels=32, channel_mult=(1, 2),
                                 num_res_blocks=1, attention_resolutions=(2,),
                                 transformer_depth=(0, 1)),
        vq=dataclasses.replace(ldsr.LDSR_VQ, ch=32, num_res_blocks=1), n_embed=16))
    write_safetensors(os.path.join(d, "LDSR", "model.safetensors"),
                      ldsr.ldsr_state_dict(tiny_ldsr))
    names, _ = register_model_dirs(models_root=d, device="cpu")
    assert names == ["s1", "s2", "sc", "LDSR", "h", "d"], names
    api = Api(Engine(device="cpu", tiny=True))
    small = base64.b64encode(encode_png(np.full((20, 24, 3), 90, np.uint8))).decode()
    opts.set("ldsr_steps", 2)
    for name in names:
        status, out = api.handle("POST", "/sdapi/v1/extra-single-image", {
            "image": small, "upscaler_1": name, "upscaling_resize": 2})
        assert status == 200, (name, out)
    opts.set("ldsr_steps", 100)
    for name in names:
        unregister_upscaler(name)
assert not Recorder.attempts, Recorder.attempts
# training, preprocess and the tagger: the modules they import when they run
from sdwebui_tpu_torch.models import deepbooru
from sdwebui_tpu_torch.networks.hypernetwork import (DEFAULT_HYPERNETWORK_DIR,
                                                     set_hypernetwork_dirs)
with tempfile.TemporaryDirectory() as d:
    data = os.path.join(d, "data")
    os.makedirs(data)
    g = np.random.default_rng(0)
    for i in range(2):
        with open(os.path.join(data, f"{i}-cat.png"), "wb") as f:
            f.write(encode_png(g.integers(0, 256, (64, 160, 3), dtype=np.uint8)))
    set_hypernetwork_dirs([os.path.join(d, "hn")])
    api = Api(Engine(device="cpu", tiny=True, embeddings_dir=os.path.join(d, "emb")))
    for route, body in (
            ("preprocess", {"process_src": data, "process_dst": os.path.join(d, "pre"),
                            "process_width": 64, "process_height": 64, "process_split": True,
                            "process_flip": True, "process_focal_crop": True}),
            ("create/embedding", {"name": "e"}),
            ("train/embedding", {"embedding_name": "e", "data_root": os.path.join(d, "pre"),
                                 "steps": 1, "training_width": 64, "training_height": 64,
                                 "save_embedding_every": 1, "create_image_every": 1}),
            ("create/hypernetwork", {"name": "h", "enable_sizes": [64]}),
            ("train/hypernetwork", {"hypernetwork_name": "h", "data_root": data, "steps": 1,
                                    "training_width": 64, "training_height": 64,
                                    "create_image_every": 1})):
        status, out = api.handle("POST", "/sdapi/v1/" + route, body)
        assert status == 200, (route, out)
    set_hypernetwork_dirs([DEFAULT_HYPERNETWORK_DIR])
    assert os.path.isfile(os.path.join(d, "emb", "images", "e-1.png"))
    assert os.path.isfile(os.path.join(d, "hn", "images", "h-1.png"))
    net = deepbooru.convert_deepbooru({
        "n_Conv_0.weight": torch.ones(4, 3, 7, 7), "n_Conv_1.weight": torch.ones(8, 4, 1, 1),
        "n_Conv_2.weight": torch.ones(4, 4, 1, 1), "n_Conv_3.weight": torch.ones(4, 4, 3, 3),
        "n_Conv_4.weight": torch.ones(8, 4, 1, 1), "n_Conv_5.weight": torch.ones(2, 8, 1, 1),
        "tags": ["a_b", "c"]}, plan=(("stage", 1, 4, 8, 1),))
    assert deepbooru.tag_image(net, np.full((40, 40, 3), 9, np.uint8)) == "a b, c"
# every image format: the port's writers, then the readers behind image_io
from sdwebui_tpu_torch.utils import bmp, gif, tiff, webp
from sdwebui_tpu_torch.utils.image_io import decode_image
pic = np.random.default_rng(0).integers(0, 256, (24, 40, 3), dtype=np.uint8)
for data, exact in ((bmp.encode_bmp(pic), True), (tiff.encode_tiff(pic), True),
                    (gif.encode_gif(pic, "c"), False), (webp.encode_webp(pic, lossless=True), True),
                    (webp.encode_webp(pic, 80), False), (webp.encode_webp_alpha(
                        np.concatenate([pic, pic[:, :, :1]], 2), 80), False)):
    got = decode_image(data)[0]
    assert got.shape[:2] == (24, 40) and (not exact or (got == pic).all())
# the page, the merger, the UI's routes, extensions, config states, profiling
from sdwebui_tpu_torch import extensions
from sdwebui_tpu_torch.postprocessing.merger import merge_checkpoints
from sdwebui_tpu_torch.scripts.compat import shim_installed
from sdwebui_tpu_torch.utils import config_states, profiling, url_fetch
a, b = ldm_state_dict(create_tiny_sd(0, "cpu")), ldm_state_dict(create_tiny_sd(1, "cpu"))
merged = merge_checkpoints(a, b, None, "Weighted sum", 0.5, True, device="cpu")
assert len(merged) == len(a) and all(v.dtype != torch.float32 for v in merged.values())
here = os.getcwd()
with tempfile.TemporaryDirectory() as d:
    os.chdir(d)
    write_safetensors(os.path.join(d, "a.safetensors"), a)
    write_safetensors(os.path.join(d, "b.safetensors"), b)
    api = Api(Engine(device="cpu", ckpt_dirs=[d], hash_cache=os.path.join(d, "h.json")))
    status, out = api.handle("POST", "/sdapi/v1/modelmerger", {
        "primary_model": "a", "secondary_model": "b", "custom_name": "ab"})
    assert status == 200 and os.path.isfile(os.path.join(d, "ab.safetensors")), out
    status, page = api.handle("GET", "/", None)
    assert status == 200 and page.body.startswith(b"<!DOCTYPE html>")
    for method, route, body in (("POST", "/internal/token-count", {"text": "a BREAK b"}),
                                ("POST", "/internal/parse-infotext", {"text": "a\nSeed: 3"}),
                                ("GET", "/internal/sysinfo", None),
                                ("GET", "/internal/options-metadata", None),
                                ("GET", "/internal/profile-startup", None),
                                ("GET", "/sdapi/v1/extensions", None),
                                ("POST", "/internal/extensions/check-updates", {}),
                                ("POST", "/sdapi/v1/server-restart", {})):
        status, out = api.handle(method, route, body)
        assert status == 200, (route, out)
    assert config_states.list_config_states() == [] and extensions.list_extensions() == []
    with shim_installed(d):
        import modules.scripts
    assert "modules" not in sys.modules
    status, out = api.handle("POST", "/sdapi/v1/png-info", {"image": "http://127.0.0.1/x.png"})
    assert status == 400, out
    os.chdir(here)
print("OK", len(mods))
"""


def test_port_runs_without_jax_pil_pydantic():
    # the JAX package itself is blocked too: the port keeps its own copies
    # one torch thread: the subprocess shares the cores with the test workers
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _HYGIENE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")


def test_chip_smoke_imports_only_the_port():
    # the smoke script names torch, the stdlib and sdwebui_tpu_torch only:
    # never jax nor a module of the JAX package
    import ast

    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    third_party = roots - set(sys.stdlib_module_names) - {"__future__"}
    assert third_party == {"torch", "sdwebui_tpu_torch"}, third_party
