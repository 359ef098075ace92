"""SDXL img2img and inpainting in the port against the JAX package (CPU, f32).

On JAX's ``create_tiny_sdxl`` (perturbed, carried across by ``from_jax``):
img2img, an inpaint with the reference API's default fields
(``inpainting_fill`` 0, ``inpaint_full_res`` with padding) and an inpaint
with fill 1, each within 1 uint8 level with identical infotext; a
9-channel tiny SDXL (the SDXL inpainting layout) on inpaint, img2img and
txt2img, from ``from_jax`` and from an ldm-layout file read by both
packages' loaders; the sdxl key manifest with its first conv widened to 9
channels at full shape on ``meta``; SDXL img2img over HTTP, and a refiner
on img2img answering 422.
"""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
from torch_jax_state import jax_vae_file_reset  # noqa: F401  (JAX's loaded-VAE global)
import base64
import dataclasses
import json
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdwebui_tpu.loader import load as jax_load
from sdwebui_tpu.models import unet as jax_unet
from sdwebui_tpu.pipeline import img2img as jax_i2i
from sdwebui_tpu.pipeline import processing as jax_proc
from sdwebui_tpu.pipeline import sd_model as jax_sd
from sdwebui_tpu.pipeline.params import GenerationParams as JaxParams
from sdwebui_tpu.utils import devices as jax_devices
from sdwebui_tpu_torch.loader import load
from sdwebui_tpu_torch.loader.safetensors_io import write_safetensors
from sdwebui_tpu_torch.pipeline import img2img as port_i2i
from sdwebui_tpu_torch.pipeline import processing as port_proc
from sdwebui_tpu_torch.pipeline import sd_model as port_sd
from sdwebui_tpu_torch.pipeline.params import GenerationParams
from sdwebui_tpu_torch.utils import devices as port_devices
from sdwebui_tpu_torch.utils import masking as port_masking
from sdwebui_tpu_torch.utils.png import decode_png, encode_png
from test_torch_img2img import _init_image
from test_torch_loader import _hf_clip, _ldm, _open_clip
from test_torch_models import _perturbed


@pytest.fixture(scope="module")
def sdxl():
    rng = np.random.default_rng(71)
    jm = jax_sd.create_tiny_sdxl(6)
    jm = dataclasses.replace(jm, unet_params=_perturbed(jm.unet_params, rng),
                             vae_params=_perturbed(jm.vae_params, rng))
    for cond in (jm.conditioner, jm.conditioner2):
        cond.params = _perturbed(cond.params, rng)
    return jm, port_sd.from_jax(jm, device="cpu")


@pytest.fixture(scope="module")
def sdxl9():
    """A tiny SDXL whose UNet takes 9 channels; its VAE as JAX makes it
    (zero biases: the masked image's blank region must encode finite in
    JAX, tests/test_torch_hybrid.py)."""
    base = jax_sd.create_tiny_sdxl(12)
    cfg = dataclasses.replace(base.unet_cfg, in_channels=9)
    rng = np.random.default_rng(72)
    jm = dataclasses.replace(base, unet_cfg=cfg, unet_params=_perturbed(
        jax_unet.init_params(cfg, 13, dtype=jnp.float32), rng))
    for cond in (jm.conditioner, jm.conditioner2):
        cond.params = _perturbed(cond.params, rng)
    return jm, port_sd.from_jax(jm, device="cpu")


@pytest.fixture
def f32_policies():
    jax_prev, port_prev = jax_devices.get_policy(), port_devices.get_policy()
    jax_devices.set_policy(jax_devices.DtypePolicy(jnp.float32, jnp.float32,
                                                   jnp.float32, jnp.float32))
    port_devices.set_policy(port_devices.FP32_POLICY)
    yield
    jax_devices.set_policy(jax_prev)
    port_devices.set_policy(port_prev)


def _mask(size=64):
    m = np.zeros((size, size), np.uint8)
    m[size // 4: size * 5 // 8, size // 3: size * 3 // 4] = 255
    return m


def _pair(**kw):
    base = dict(prompt="a (red:1.1) cat, castle", negative_prompt="blurry", seed=23, steps=5,
                width=64, height=64, batch_size=1, cfg_scale=6.5, sampler_name="DPM++ 2M",
                scheduler="Karras", denoising_strength=0.75,
                override_settings={"sdtpu_vae_bf16": False})
    base.update(kw)
    return JaxParams(**base), GenerationParams(**base)


CASES = {
    "img2img": dict(init_images=[_init_image(seed=31)]),
    "img2img_euler_a_batch2": dict(init_images=[_init_image(seed=32)], batch_size=2,
                                   sampler_name="Euler a", scheduler="Automatic"),
    "inpaint_api_defaults": dict(init_images=[_init_image(seed=33, size=96)], mask=_mask(96),
                                 mask_blur=4, inpainting_fill=0, inpaint_full_res=True,
                                 inpaint_full_res_padding=16),
    "inpaint_fill1": dict(init_images=[_init_image(seed=34)], mask=_mask(), mask_blur=4,
                          inpainting_fill=1, inpaint_full_res=False),
}


def _assert_same(ref, out):
    ref_imgs = [np.asarray(im) for im in ref.images]
    assert len(out.images) == len(ref_imgs)
    for a, b in zip(out.images, ref_imgs):
        assert a.shape == b.shape and a.dtype == np.uint8
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert out.infotexts == ref.infotexts


@pytest.mark.parametrize("case", list(CASES))
def test_sdxl_img2img_matches_jax(sdxl, f32_policies, case):
    jp, pp = _pair(**CASES[case])
    ref = jax_i2i.process_img2img(sdxl[0], jp)
    out = port_i2i.process_img2img(sdxl[1], pp)
    _assert_same(ref, out)
    if pp.mask is not None:
        init = np.asarray(pp.init_images[0])
        keep = port_masking.blur_mask(pp.mask, pp.mask_blur) == 0
        final = out.images[out.index_of_first_image]
        np.testing.assert_array_equal(final[keep], init[keep])


NINE_CASES = {
    "inpaint": dict(init_images=[_init_image(seed=35)], mask=_mask(), mask_blur=4,
                    inpainting_fill=1, inpaint_full_res=False),
    "inpaint_api_defaults": dict(init_images=[_init_image(seed=36)], mask=_mask(),
                                 mask_blur=4),
    "img2img_no_mask": dict(init_images=[_init_image(seed=37)]),
}


@pytest.mark.parametrize("case", list(NINE_CASES))
def test_nine_channel_sdxl_matches_jax(sdxl9, f32_policies, case):
    jp, pp = _pair(**NINE_CASES[case])
    _assert_same(jax_i2i.process_img2img(sdxl9[0], jp),
                 port_i2i.process_img2img(sdxl9[1], pp))


def test_nine_channel_sdxl_txt2img_matches_jax(sdxl9, f32_policies):
    base = dict(prompt="a cat", seed=3, steps=3, width=64, height=64,
                override_settings={"sdtpu_vae_bf16": False})
    _assert_same(jax_proc.process_txt2img(sdxl9[0], JaxParams(**base)),
                 port_proc.process_txt2img(sdxl9[1], GenerationParams(**base)))


def test_nine_channel_sdxl_file_serves_inpaint(sdxl9, f32_policies, tmp_path):
    """An ldm-layout SDXL file with a 9-channel input_blocks.0.0: both
    packages' loaders read it, and the inpaint matches."""
    jm = sdxl9[0]
    sd = {**_ldm(jm.unet_params, "model.diffusion_model."),
          **_ldm(jm.vae_params, "first_stage_model."),
          **_hf_clip(jm.conditioner.params, "conditioner.embedders.0.transformer.text_model."),
          **_open_clip(jm.conditioner2.params, "conditioner.embedders.1.model.")}
    path = str(tmp_path / "tiny-sdxl-inpainting.safetensors")
    write_safetensors(path, sd)
    ref_model = jax_load.load_model(path, title="tiny-sdxl-inpainting")
    model = load.load_model(path, title="tiny-sdxl-inpainting", device="cpu")
    assert model.kind == "sdxl" and model.unet_cfg.in_channels == 9
    jp, pp = _pair(**NINE_CASES["inpaint"])
    _assert_same(jax_i2i.process_img2img(ref_model, jp), port_i2i.process_img2img(model, pp))


def test_sdxl_inpainting_manifest_loads_on_meta():
    """The sdxl base manifest with its first conv widened to 9 channels
    (stability's SDXL inpainting layout) loads strictly, at full shape, as
    a 9-channel SDXL base the pipelines accept."""
    from test_key_manifests import load_manifest
    from test_torch_loader import _canonical, _meta_state_dict

    sd = _meta_state_dict(load_manifest("sdxl_base"))
    sd["model.diffusion_model.input_blocks.0.0.weight"] = torch.empty(
        (320, 9, 3, 3), device="meta", dtype=torch.float16)
    model = load.model_from_state_dict(sd, device="meta")
    assert model.kind == "sdxl" and model.unet_cfg.in_channels == 9
    assert _canonical(model.unet_cfg) == _canonical(
        dataclasses.replace(port_sd.SDXL_UNET, in_channels=9))
    port_proc.check_hybrid(model)


# --------------------------------------------------------------------------
# over HTTP
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def server_url():
    from sdwebui_tpu_torch.server.api import make_server
    from sdwebui_tpu_torch.server.app import Engine

    engine = Engine(device="cpu", tiny=True, seed=4, family="sdxl")
    server = make_server(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}/sdapi/v1/img2img", engine
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_sdxl_img2img_route(server_url):
    """SDXL img2img and an inpaint with the API's defaults on the served
    base; a refiner on img2img answers 422 naming it."""
    url, engine = server_url
    init = _init_image(seed=38)
    png = base64.b64encode(encode_png(init)).decode()
    body = {"prompt": "a cat", "seed": 8, "steps": 3, "width": 64, "height": 64,
            "sampler_name": "DPM++ 2M", "scheduler": "Karras", "init_images": [png]}
    status, res = _post(url, body)
    assert status == 200, res
    img, text = decode_png(base64.b64decode(res["images"][0]))
    assert img.shape == (64, 64, 3) and "Denoising strength: 0.75" in text["parameters"]
    mask = base64.b64encode(encode_png(_mask())).decode()
    status, res = _post(url, dict(body, mask=mask))
    assert status == 200, res
    out = decode_png(base64.b64decode(res["images"][0]))[0]
    keep = port_masking.blur_mask(_mask(), 4) == 0
    np.testing.assert_array_equal(out[keep], init[keep])
    (refiner,) = engine._extra_models
    status, res = _post(url, dict(body, refiner_checkpoint=refiner, refiner_switch_at=0.8))
    assert status == 422 and "refiner_checkpoint" in res["detail"], res
