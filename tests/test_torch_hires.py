"""Hires fix in the port against the JAX package: the latent resize against
``jax.image.resize``, the hires target, the hires cond schedule, tiny SD1.5
hires ``process_txt2img`` (every latent mode, the hires sampler / scheduler
/ steps / CFG / prompts, a prompt edit across the passes, the old
width/height behaviour, extra noise, the Lanczos and ESRGAN routes), tiny
SDXL base + refiner under each ``hires_fix_refiner_pass``, and
``enable_hr`` over HTTP.  Pipelines run under the f32 policy with the bf16
VAE decode off: images within 1 uint8 level, identical infotext."""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
from torch_jax_state import jax_vae_file_reset  # noqa: F401  (JAX's loaded-VAE global)
import base64
import dataclasses
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdwebui_tpu.models import esrgan as jax_esrgan
from sdwebui_tpu.models import unet as jax_unet
from sdwebui_tpu.pipeline import processing as jax_proc
from sdwebui_tpu.pipeline import sd_model as jax_sd
from sdwebui_tpu.pipeline.params import GenerationParams as JaxParams
from sdwebui_tpu.postprocessing import upscalers as jax_upscalers
from sdwebui_tpu.text import conditioner as jax_cond
from sdwebui_tpu.utils import devices as jax_devices
from sdwebui_tpu.utils.options import opts as jax_opts
from sdwebui_tpu_torch.loader.safetensors_io import write_safetensors
from sdwebui_tpu_torch.models import esrgan as port_esrgan
from sdwebui_tpu_torch.pipeline import processing as port_proc
from sdwebui_tpu_torch.pipeline import sd_model as port_sd
from sdwebui_tpu_torch.pipeline.params import GenerationParams
from sdwebui_tpu_torch.postprocessing import upscalers as port_upscalers
from sdwebui_tpu_torch.text import conditioner as port_cond
from sdwebui_tpu_torch.utils import devices as port_devices
from sdwebui_tpu_torch.utils.options import opts as port_opts
from sdwebui_tpu_torch.utils.png import decode_png, encode_png
from test_torch_models import _perturbed

LATENT_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny models' ops are too small to split over threads; with
    several test workers on the machine's cores, extra threads only wait
    on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# the latent resize and the hires target
# --------------------------------------------------------------------------

@pytest.mark.parametrize("target", ["2x", "1.5x", "resize_xy", "shrink"])
@pytest.mark.parametrize("mode", list(port_proc.LATENT_UPSCALE_MODES))
def test_latent_resize_matches_jax_image_resize(mode, target):
    """max |Δ| <= 1e-5 against jax.image.resize as JAX's hires pass calls
    it (NHWC there, NCHW here), at integer and non-integer scales."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 12, 10)).astype(np.float32)
    th, tw = {"2x": (24, 20), "1.5x": (18, 15), "resize_xy": (23, 31), "shrink": (8, 7)}[target]
    method = jax_proc.LATENT_UPSCALE_MODES[mode]
    assert port_proc.LATENT_UPSCALE_MODES[mode] == method
    ref = np.asarray(jax.image.resize(jnp.asarray(x.transpose(0, 2, 3, 1)), (2, th, tw, 4),
                                      method=method)).transpose(0, 3, 1, 2)
    out = port_proc.resize_latents(torch.from_numpy(x), th, tw, method).numpy()
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= LATENT_TOL


@pytest.mark.parametrize("kw", [
    dict(), dict(hr_scale=1.5), dict(hr_resize_x=1000), dict(hr_resize_y=700),
    dict(hr_resize_x=1000, hr_resize_y=600), dict(width=768, height=512, hr_scale=1.75)])
@pytest.mark.parametrize("old", [False, True])
def test_hires_target_and_old_behaviour_match_jax(kw, old):
    base = {"width": 512, "height": 640, "enable_hr": True, **kw}
    jp, pp = JaxParams(**base), GenerationParams(**base)
    with jax_opts.override({"use_old_hires_fix_width_height": old}), \
            port_opts.override({"use_old_hires_fix_width_height": old}):
        jax_proc.apply_old_hires_behavior(jp)
        port_proc.apply_old_hires_behavior(pp)
    assert (pp.width, pp.height, pp.hr_resize_x, pp.hr_resize_y) == \
        (jp.width, jp.height, jp.hr_resize_x, jp.hr_resize_y)
    assert port_proc.calculate_hr_target(pp) == jax_proc.calculate_hr_target(jp)


@pytest.mark.parametrize("old", [False, True])
def test_hires_cond_schedule_tables_match_jax(old):
    """The second pass's step tables continue the first pass's prompt-edit
    schedule, unless use_old_scheduling."""
    def encode(texts):
        return np.stack([np.full((3, 2), hash(t) % 97, np.float32) for t in texts])

    prompt, negative = "[a:b:0.5] [c:d:12] AND e", "[x:y:0.7]"
    ref = jax_cond.build_cond_schedule(lambda t: jnp.asarray(encode(t)), prompt, negative, 10,
                                       hires_steps=7, use_old_scheduling=old)
    out = port_cond.build_cond_schedule(lambda t: torch.from_numpy(encode(t)), prompt,
                                        negative, 10, hires_steps=7, use_old_scheduling=old)
    np.testing.assert_array_equal(out.cond_idx, np.asarray(ref.cond_idx))
    np.testing.assert_array_equal(out.uncond_idx, np.asarray(ref.uncond_idx))
    np.testing.assert_array_equal(out.cond_bank.numpy(), np.asarray(ref.cond_bank))
    np.testing.assert_array_equal(out.uncond_bank.numpy(), np.asarray(ref.uncond_bank))


# --------------------------------------------------------------------------
# tiny SD1.5 hires txt2img
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jm = jax_sd.create_tiny_sd(5)
    rng = np.random.default_rng(51)
    jm = dataclasses.replace(jm, unet_params=_perturbed(jm.unet_params, rng),
                             vae_params=_perturbed(jm.vae_params, rng))
    jm.conditioner.params = _perturbed(jm.conditioner.params, rng)
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


def random_state_dict(net: torch.nn.Module, seed: int) -> dict:
    """Random weights for a super-resolution net in the torch layout, each
    conv scaled by 0.5 / sqrt(fan-in) and the last bias lifted by 0.5, so
    that the output is neither flat nor clipped."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in net.state_dict().items():
        scale = 0.5 / v[0].numel() ** 0.5 if v.ndim == 4 else 0.05
        sd[k] = torch.randn(v.shape, generator=g) * scale
    last = [k for k in sd if k.endswith(".bias")][-1]
    sd[last] = sd[last] + 0.5
    return sd


@pytest.fixture(scope="module")
def esrgan_file(tmp_path_factory):
    """A tiny R-ESRGAN file, registered in both packages under one name."""
    d = tmp_path_factory.mktemp("esrgan")
    net = port_esrgan.RRDBNet(nf=8, gc=4, n_blocks=1)
    write_safetensors(str(d / "R-ESRGAN tiny.safetensors"), random_state_dict(net, 3))
    names = (jax_esrgan.register_esrgan_dir(dirs=(str(d),)),
             port_esrgan.register_esrgan_dir((str(d),), device="cpu"))
    assert names == (["R-ESRGAN tiny"], ["R-ESRGAN tiny"])
    yield "R-ESRGAN tiny"
    jax_upscalers._REGISTRY.pop("R-ESRGAN tiny", None)
    port_upscalers.unregister_upscaler("R-ESRGAN tiny")


def _hr(**kw):
    base = dict(prompt="a (red:1.2) cat [in the snow:on a hill:0.5]", negative_prompt="blurry",
                seed=31, steps=4, width=64, height=64, batch_size=1, cfg_scale=7.5,
                enable_hr=True, hr_scale=1.5, hr_upscaler="Latent", denoising_strength=0.6,
                override_settings={"sdtpu_vae_bf16": False})
    base.update(kw)
    return base


def _assert_same(out, ref, n: int, size: tuple):
    ref_imgs = [np.asarray(im) for im in ref.images[ref.index_of_first_image:]]
    out_imgs = out.images[out.index_of_first_image:]
    assert len(out_imgs) == len(ref_imgs) == n
    for a, b in zip(out_imgs, ref_imgs):
        assert a.shape == b.shape == size + (3,) and a.dtype == np.uint8
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert out.infotexts[out.index_of_first_image:] == ref.infotexts[ref.index_of_first_image:]
    return out_imgs


HIRES_CASES = {
    **{f"latent_{mode}": dict(hr_upscaler=mode)
       for mode in ("Latent", "Latent (antialiased)", "Latent (bicubic)",
                    "Latent (bicubic antialiased)", "Latent (nearest)", "Latent (nearest-exact)")},
    "hr_sampler_scheduler_steps_cfg_prompts": dict(
        hr_sampler_name="DPM++ 2M", hr_scheduler="Karras", hr_second_pass_steps=5, hr_cfg=5.0,
        hr_prompt="a blue dog", hr_negative_prompt="ugly", batch_size=2, hr_scale=2.0),
    "prompt_edit_new_scheduling": dict(prompt="[a cat:a dog:0.5]"),
    "prompt_edit_old_scheduling": dict(prompt="[a cat:a dog:0.5]", override_settings={
        "sdtpu_vae_bf16": False, "use_old_scheduling": True}),
    "old_hires_width_height": dict(width=96, height=64, steps=2, override_settings={
        "sdtpu_vae_bf16": False, "use_old_hires_fix_width_height": True}),
    "hr_resize_xy_extra_noise": dict(hr_resize_x=80, hr_resize_y=0, override_settings={
        "sdtpu_vae_bf16": False, "img2img_extra_noise": 0.3}),
    "lanczos_route": dict(hr_upscaler="Lanczos", hr_scale=2.0),
    "esrgan_route": dict(hr_upscaler="ESRGAN", hr_scale=2.0),
    # the hires pass's own ToMe ratio and hypertile (processing.py:672)
    "tome_hr_hypertile": dict(hr_scale=2.0, steps=2, override_settings={
        "sdtpu_vae_bf16": False, "token_merging_ratio_hr": 0.5,
        "hypertile_enable_unet": True}),
}


@pytest.mark.parametrize("case", list(HIRES_CASES))
def test_hires_txt2img_matches_jax(models, f32_policies, esrgan_file, case):
    """Final pixels within 1 uint8 level and identical infotext strings."""
    jm, pm = models
    kw = _hr(**HIRES_CASES[case])
    if kw["hr_upscaler"] == "ESRGAN":
        kw["hr_upscaler"] = esrgan_file
    if "hr_cfg" in kw:
        kw["hr_cfg_scale"] = kw.pop("hr_cfg")
    jp, pp = JaxParams(**kw), GenerationParams(**kw)
    ref = jax_proc.process_txt2img(jm, jp)
    out = port_proc.process_txt2img(pm, pp)
    hr_w, hr_h = port_proc.calculate_hr_target(pp)
    _assert_same(out, ref, pp.batch_size, (hr_h, hr_w))
    text = out.infotexts[-1]
    assert f"Hires upscaler: {kw['hr_upscaler']}" in text
    assert ("Hires resize" if pp.hr_resize_x else "Hires upscale") in text


def test_hires_without_denoising_strength_takes_0_7(models, f32_policies):
    jm, pm = models
    kw = {k: v for k, v in _hr(steps=3).items() if k != "denoising_strength"}
    ref = jax_proc.process_txt2img(jm, JaxParams(**kw))
    out = port_proc.process_txt2img(pm, GenerationParams(**kw))
    _assert_same(out, ref, 1, (96, 96))
    assert "Denoising strength" not in out.infotexts[0]


@pytest.mark.parametrize("kw,name", [
    (dict(override_settings={"save_images_before_highres_fix": True,
                             "samples_format": "avif"}), "avif"),
    (dict(hr_upscaler="No such upscaler"), "No such upscaler"),
])
def test_unported_hires_requests_raise(models, kw, name, tmp_path):
    with pytest.raises((NotImplementedError, LookupError), match=name):
        port_proc.process_txt2img(models[1], GenerationParams(**_hr(steps=1, **kw)),
                                  outdir=str(tmp_path))


# --------------------------------------------------------------------------
# tiny SDXL base + refiner
# --------------------------------------------------------------------------

REFINER_TITLE = "tiny-sdxl-refiner-hires [0000000002]"


@pytest.fixture(scope="module")
def sdxl_models():
    """(JAX base, JAX refiner, port base, port refiner)."""
    rng = np.random.default_rng(71)
    jb = jax_sd.create_tiny_sdxl(8)
    jb = dataclasses.replace(jb, unet_params=_perturbed(jb.unet_params, rng),
                             vae_params=_perturbed(jb.vae_params, rng))
    for cond in (jb.conditioner, jb.conditioner2):
        cond.params = _perturbed(cond.params, rng)
    ref_params = jax_unet.init_params(port_sd.TINY_SDXL_REFINER_UNET, 108, dtype=jnp.float32)
    jr = dataclasses.replace(
        jb, kind="sdxl-refiner", unet_params=_perturbed(ref_params, rng),
        unet_cfg=port_sd.TINY_SDXL_REFINER_UNET, conditioner=jb.conditioner2,
        conditioner2=None, title=REFINER_TITLE)
    return jb, jr, port_sd.from_jax(jb, device="cpu"), port_sd.from_jax(jr, device="cpu")


@pytest.mark.parametrize("refiner_pass", [None, "first pass", "second pass", "both passes"])
def test_hires_sdxl_matches_jax(sdxl_models, f32_policies, refiner_pass):
    """Tiny SDXL hires (DPM++ 2M Karras) without a refiner, and with the
    refiner on each hires_fix_refiner_pass value."""
    jb, jr, pb, pr = sdxl_models
    kw = _hr(prompt="a cat [in the snow:on a hill:0.5]", sampler_name="DPM++ 2M",
             scheduler="Karras", steps=5, hr_second_pass_steps=6, denoising_strength=0.5,
             cfg_scale=7.0, override_settings={"sdtpu_vae_bf16": False})
    if refiner_pass is not None:
        kw.update(refiner_checkpoint=REFINER_TITLE, refiner_switch_at=0.6)
        kw["override_settings"]["hires_fix_refiner_pass"] = refiner_pass
    ref = jax_proc.process_txt2img(jb, JaxParams(**kw),
                                   refiner_model=jr if refiner_pass else None)
    out = port_proc.process_txt2img(pb, GenerationParams(**kw),
                                    refiner_model=pr if refiner_pass else None)
    _assert_same(out, ref, 1, (96, 96))
    assert ("Refiner: " + REFINER_TITLE in out.infotexts[0]) == (refiner_pass is not None)


def test_hires_firstpass_conds_option_matches_jax(sdxl_models, f32_policies):
    jb, _, pb, _ = sdxl_models
    kw = _hr(steps=3, override_settings={"sdtpu_vae_bf16": False,
                                         "hires_fix_use_firstpass_conds": True})
    ref = jax_proc.process_txt2img(jb, JaxParams(**kw))
    out = port_proc.process_txt2img(pb, GenerationParams(**kw))
    _assert_same(out, ref, 1, (96, 96))


# --------------------------------------------------------------------------
# enable_hr over HTTP
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def server_url():
    from sdwebui_tpu_torch.server.api import make_server
    from sdwebui_tpu_torch.server.app import Engine

    server = make_server(Engine(device="cpu", tiny=True, seed=4), "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}/sdapi/v1"
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)


def _call(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_txt2img_route_runs_hires(server_url):
    body = {"prompt": "a cat", "seed": 9, "steps": 3, "width": 64, "height": 64,
            "enable_hr": True, "hr_scale": 2, "hr_upscaler": "Latent (bicubic)",
            "denoising_strength": 0.5, "hr_second_pass_steps": 4, "hr_cfg": 5.5,
            "hr_sampler_name": "Euler", "hr_scheduler": "Karras", "hr_prompt": "a dog"}
    status, res = _call(server_url + "/txt2img", body)
    assert status == 200, res
    img, text = decode_png(base64.b64decode(res["images"][0]))
    assert img.shape == (128, 128, 3)
    for want in ("Hires upscale: 2", "Hires upscaler: Latent (bicubic)", "Hires steps: 4",
                 "Hires sampler: Euler", "Hires CFG Scale: 5.5", "Hires prompt: a dog",
                 "Denoising strength: 0.5", "Size: 64x64"):
        assert want in text["parameters"], want
    status, res = _call(server_url + "/txt2img", {**body, "hr_upscaler": "Lanczos",
                                                  "hr_scale": 1.5})
    assert status == 200, res
    assert decode_png(base64.b64decode(res["images"][0]))[0].shape == (96, 96, 3)


@pytest.mark.parametrize("body,status,word", [
    ({"hr_upscaler": "R-ESRGAN 9x"}, 422, "R-ESRGAN 9x"),
    ({"hr_sampler_name": "nope"}, 400, "Sampler not found"),
    ({"hr_scheduler": "nope"}, 400, "Scheduler not found"),
    ({"hr_scale": "2"}, 422, "hr_scale"),
    ({"hr_checkpoint_name": "x.safetensors"}, 422, "hr_checkpoint_name"),
    ({"save_images": True, "override_settings": {"save_images_before_highres_fix": True,
                                                 "samples_format": "avif"}}, 422, "avif"),
])
def test_txt2img_route_hires_errors(server_url, body, status, word):
    code, res = _call(server_url + "/txt2img", {"steps": 1, "width": 64, "height": 64,
                                                "enable_hr": True, **body})
    assert code == status and word in res["detail"], res


def test_latent_upscale_modes_route(server_url):
    status, res = _call(server_url + "/latent-upscale-modes")
    assert status == 200
    assert [m["name"] for m in res] == list(jax_proc.LATENT_UPSCALE_MODES)


def test_img2img_route_refuses_hires_fields(server_url):
    png = base64.b64encode(encode_png(np.zeros((64, 64, 3), np.uint8))).decode()
    code, res = _call(server_url + "/img2img", {"init_images": [png], "enable_hr": True})
    assert code == 422 and "enable_hr" in res["detail"], res
