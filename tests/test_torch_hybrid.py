"""The hybrid UNets in the port against the JAX package (CPU, f32): the
inpainting model (9 channels: txt2img's grey-image conditioning, inpaint
and no-mask img2img), instruct-pix2pix (8: img2img with its 3-way CFG at
several image_cfg_scale values), and SD2-depth (5: txt2img's zero depth
plane and img2img's MiDaS depth) loaded from one tiny state dict through
both packages' ``model_from_state_dict``.  Also the edit-model CFG combine
and the c_concat tiling on toy denoisers, and every request the port
still refuses.  Inputs are made with numpy from a seed; each pipeline is
held to 1 uint8 level and identical infotext."""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
from torch_jax_state import jax_vae_file_reset  # noqa: F401  (JAX's loaded-VAE global)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdwebui_tpu.loader.load import model_from_state_dict as jax_from_sd
from sdwebui_tpu.models import unet as jax_unet
from sdwebui_tpu.pipeline import img2img as jax_i2i
from sdwebui_tpu.pipeline import processing as jax_proc
from sdwebui_tpu.pipeline import sd_model as jax_sd
from sdwebui_tpu.pipeline.params import GenerationParams as JaxParams
from sdwebui_tpu.sampling.cfg import CondSchedule as JaxSched
from sdwebui_tpu.sampling.cfg import make_cfg_denoiser as jax_cfg
from sdwebui_tpu.utils import devices as jax_devices
from sdwebui_tpu_torch.loader.load import model_from_state_dict as port_from_sd
from sdwebui_tpu_torch.pipeline import img2img as port_i2i
from sdwebui_tpu_torch.pipeline import processing as port_proc
from sdwebui_tpu_torch.pipeline import sd_model as port_sd
from sdwebui_tpu_torch.pipeline.params import GenerationParams
from sdwebui_tpu_torch.sampling.cfg import CondSchedule, make_cfg_denoiser
from sdwebui_tpu_torch.utils import devices as port_devices
from test_torch_loader import _ldm, _open_clip
from test_torch_midas import random_dpt_state_dict
from test_torch_models import _assert_rel, _perturbed


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def f32_policies():
    jax_prev, port_prev = jax_devices.get_policy(), port_devices.get_policy()
    jax_devices.set_policy(jax_devices.DtypePolicy(jnp.float32, jnp.float32,
                                                   jnp.float32, jnp.float32))
    port_devices.set_policy(port_devices.FP32_POLICY)
    yield
    jax_devices.set_policy(jax_prev)
    port_devices.set_policy(port_prev)


def _hybrid(in_channels: int, seed: int, perturb_vae: bool = True):
    """A perturbed JAX tiny SD1 whose UNet takes `in_channels`, as the JAX
    package's tests build one (tests/test_img2img.py:171-180), and the
    port's model on the same tree."""
    base = jax_sd.create_tiny_sd(seed)
    cfg = dataclasses.replace(base.unet_cfg, in_channels=in_channels)
    rng = np.random.default_rng(seed + 100)
    jm = dataclasses.replace(
        base, unet_cfg=cfg,
        unet_params=_perturbed(jax_unet.init_params(cfg, seed + 7, dtype=jnp.float32), rng),
        vae_params=_perturbed(base.vae_params, rng) if perturb_vae else base.vae_params)
    jm.conditioner.params = _perturbed(jm.conditioner.params, rng)
    return jm, port_sd.from_jax(jm, device="cpu")


@pytest.fixture(scope="module")
def inpaint_models():
    """The VAE as the JAX package makes it (zero biases): with random
    biases JAX's encoder turns the flat grey image of txt2img into NaN
    (its one-pass GroupNorm variance falls below -eps in XLA's summation
    order), which test_flat_image_encodes_finite_in_the_port shows the
    port does not."""
    return _hybrid(9, 21, perturb_vae=False)


def test_flat_image_encodes_finite_in_the_port(f32_policies):
    """The grey image the inpainting model's txt2img encodes, through a
    VAE with random biases: NaN in JAX, finite in the port."""
    jm, pm = _hybrid(9, 21)
    grey = np.full((1, 64, 64, 3), 0.5, np.float32)
    assert np.isnan(np.asarray(jax_proc.encode_first_stage(jm, jnp.asarray(grey)))).any()
    with torch.inference_mode():
        assert torch.isfinite(port_proc.encode_first_stage(pm, grey)).all()


@pytest.fixture(scope="module")
def edit_models():
    return _hybrid(8, 22)


@pytest.fixture(scope="module")
def depth_models():
    """A tiny SD2-depth state dict (5-channel SD2 UNet, open_clip text
    tower, VAE, ``depth_model.model.*`` tiny DPT) loaded by both packages."""
    jm, _ = _hybrid(5, 23)
    rng = np.random.default_rng(123)
    unet = _perturbed(jax_unet.init_params(dataclasses.replace(
        jm.unet_cfg, use_linear_in_transformer=True), 24, dtype=jnp.float32), rng)
    sd = {**_ldm(unet, "model.diffusion_model."), **_ldm(jm.vae_params, "first_stage_model."),
          **_open_clip(jm.conditioner.params, "cond_stage_model.model."),
          **{"depth_model.model." + k: torch.from_numpy(v)
             for k, v in random_dpt_state_dict(port_sd.TINY_DPT, 5).items()}}
    ref = jax_from_sd({k: v.numpy() for k, v in sd.items()}, title="tiny-depth")
    out = port_from_sd(sd, title="tiny-depth", device="cpu")
    assert ref.is_depth and out.is_depth and out.unet_cfg.in_channels == 5
    return ref, out


def _init_image(seed=11, size=64):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (size // 8, size // 8, 3)).astype(np.uint8)
    return np.kron(base, np.ones((8, 8, 1), np.uint8))


def _rect_mask(size=64, lo=16, hi=48):
    m = np.zeros((size, size), np.uint8)
    m[lo:hi, lo:hi] = 255
    return m


def _pair(**kw):
    base = dict(prompt="a red cat", negative_prompt="blurry", seed=17, steps=4, width=64,
                height=64, batch_size=1, cfg_scale=7.5,
                override_settings={"sdtpu_vae_bf16": False})
    base.update(kw)
    return JaxParams(**base), GenerationParams(**base)


def _assert_same(out, ref, n):
    ref_imgs = [np.asarray(im) for im in ref.images[ref.index_of_first_image:]]
    out_imgs = out.images[out.index_of_first_image:]
    assert len(out_imgs) == len(ref_imgs) == n
    for a, b in zip(out_imgs, ref_imgs):
        assert a.shape == b.shape and a.dtype == np.uint8
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert out.infotexts[out.index_of_first_image:] == ref.infotexts[ref.index_of_first_image:]
    return out_imgs


# --------------------------------------------------------------------------
# the CFG combines on toy denoisers
# --------------------------------------------------------------------------

def _toy_scheds(k=1, image_cfg=None, seed=13):
    rng = np.random.default_rng(seed)
    b, c, h, w, s, d = 2, 4, 8, 8, 5, 6
    bank = rng.standard_normal((k, 2, s, d), dtype=np.float32)
    ubank = rng.standard_normal((2, s, d), dtype=np.float32)
    cc = rng.standard_normal((b, 3, h, w), dtype=np.float32)
    common = dict(cond_idx=np.array([[0, 1]] * k, np.int32),
                  cond_weights=np.linspace(1.0, 0.5, k).astype(np.float32),
                  uncond_idx=np.array([1, 0], np.int32), cond_scale=4.0)
    js = JaxSched(cond_bank=jnp.asarray(bank), uncond_bank=jnp.asarray(ubank),
                  c_concat=jnp.asarray(cc.transpose(0, 2, 3, 1)),
                  image_cfg_scale=None if image_cfg is None else jnp.asarray(image_cfg),
                  **{key: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                     for key, v in common.items()})
    ps = CondSchedule(cond_bank=torch.from_numpy(bank), uncond_bank=torch.from_numpy(ubank),
                      c_concat=torch.from_numpy(cc), image_cfg_scale=image_cfg, **common)
    x = rng.standard_normal((b, c, h, w), dtype=np.float32)
    init = rng.standard_normal((b, c, h, w), dtype=np.float32)
    nmask = np.around(rng.random((1, 1, h, w))).astype(np.float32)
    proj = rng.standard_normal((d + 3, c), dtype=np.float32)
    return js, ps, x, init, nmask, proj


def _jax_toy(proj):
    def denoise(x, sigma, ctx, y, c_concat):
        feat = jnp.concatenate([ctx.mean(axis=1), c_concat.mean(axis=(1, 2))], axis=-1)
        return x * 0.5 + (feat @ jnp.asarray(proj))[:, None, None, :]
    return denoise


def _port_toy(proj, seen=None):
    def denoise(x, sigma, ctx, c_concat=None):
        if seen is not None:
            seen.append(c_concat.shape[0])
        feat = torch.cat([ctx.mean(dim=1), c_concat.mean(dim=(2, 3))], dim=-1)
        return x * 0.5 + (feat @ torch.from_numpy(proj))[:, :, None, None]
    return denoise


@pytest.mark.parametrize("image_cfg,masked", [(1.5, False), (3.0, True), (None, False)])
def test_cfg_with_c_concat_matches_jax(image_cfg, masked):
    """The edit model's 3-way combine (uncond + s_txt·(cond − img) +
    s_img·(img − uncond), with the latent mask blend) and the c_concat
    tiled over K+1 rows of an AND prompt (image_cfg None), at step 1 of
    both schedules: 1e-6 of the largest magnitude."""
    k = 1 if image_cfg is not None else 2
    js, ps, x, init, nmask, proj = _toy_scheds(k=k, image_cfg=image_cfg)
    nhwc = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1))   # noqa: E731
    kw_j = kw_p = {}
    if masked:
        kw_j = dict(mask=1.0 - nhwc(nmask), nmask=nhwc(nmask), init_latent=nhwc(init))
        nm = torch.from_numpy(nmask)
        kw_p = dict(mask=1.0 - nm, nmask=nm, init_latent=torch.from_numpy(init))
    ref = jax_cfg(_jax_toy(proj), js, **kw_j)(nhwc(x), 1.0, 1)
    seen = []
    out = make_cfg_denoiser(_port_toy(proj, seen), ps, **kw_p)(torch.from_numpy(x), 1.0, 1)
    _assert_rel(out.numpy(), np.asarray(ref).transpose(0, 3, 1, 2), 1e-6)
    assert seen == [x.shape[0] * (3 if image_cfg is not None else k + 1)]


def test_edit_cfg_combine_formula():
    """The JAX package's own check (tests/test_img2img.py:202-217) on the
    port: rows cond = 2.5, image = 1.5, uncond = 1."""
    sched = CondSchedule(cond_bank=torch.full((1, 1, 7, 3), 2.0),
                         cond_idx=np.zeros((1, 1), np.int32), cond_weights=np.ones(1),
                         uncond_bank=torch.full((1, 7, 3), 1.0),
                         uncond_idx=np.zeros(1, np.int32), cond_scale=2.0,
                         c_concat=torch.full((1, 4, 4, 4), 0.5), image_cfg_scale=1.5)

    def denoise(x, sigma, ctx, c_concat=None):
        m = ctx.mean(dim=(1, 2)) + c_concat.mean(dim=(1, 2, 3))
        return torch.ones_like(x) * m[:, None, None, None]

    out = make_cfg_denoiser(denoise, sched)(torch.zeros((1, 4, 4, 4)), 1.0, 0)
    expect = 1 + 2.0 * (2.5 - 1.5) + 1.5 * (1.5 - 1)
    np.testing.assert_allclose(out.numpy(), expect, rtol=1e-6)


# --------------------------------------------------------------------------
# the pipelines
# --------------------------------------------------------------------------

def test_inpainting_model_txt2img_matches_jax(inpaint_models, f32_policies):
    jm, pm = inpaint_models
    jp, pp = _pair(batch_size=2)
    _assert_same(port_proc.process_txt2img(pm, pp), jax_proc.process_txt2img(jm, jp), 2)


@pytest.mark.parametrize("case", ["inpaint", "inpaint_fill2", "no_mask"])
def test_inpainting_model_img2img_matches_jax(inpaint_models, f32_policies, case):
    """The mask and the masked image's latent as c_concat; outside the
    blurred mask the init image comes back as it was."""
    jm, pm = inpaint_models
    kw = dict(init_images=[_init_image()], denoising_strength=0.75)
    if case != "no_mask":
        kw.update(mask=_rect_mask(), mask_blur=4, inpainting_fill=2 if case.endswith("2") else 1)
    jp, pp = _pair(**kw)
    imgs = _assert_same(port_i2i.process_img2img(pm, pp), jax_i2i.process_img2img(jm, jp), 1)
    if case != "no_mask":
        from sdwebui_tpu_torch.utils import masking
        keep = masking.blur_mask(_rect_mask(), 4) == 0
        np.testing.assert_array_equal(imgs[0][keep], _init_image()[keep])


@pytest.mark.parametrize("image_cfg", [1.5, 3.0, 1.0, None])
def test_edit_model_img2img_matches_jax(edit_models, f32_policies, image_cfg):
    """instruct-pix2pix: the 3-way CFG at 1.5 and 3.0, the plain CFG with
    the init latent as c_concat at 1.0 and None; the infotext carries no
    "Image CFG scale", as JAX's."""
    jm, pm = edit_models
    jp, pp = _pair(init_images=[_init_image(5)], denoising_strength=0.9, steps=3,
                   image_cfg_scale=image_cfg)
    out = port_i2i.process_img2img(pm, pp)
    _assert_same(out, jax_i2i.process_img2img(jm, jp), 1)
    assert "Image CFG" not in out.infotexts[0]


def test_edit_model_image_cfg_scale_changes_the_image(edit_models, f32_policies):
    _, pm = edit_models
    outs = [port_i2i.process_img2img(pm, _pair(init_images=[_init_image(5)], steps=3,
                                               denoising_strength=0.9,
                                               image_cfg_scale=s)[1]).images[0]
            for s in (1.5, 3.0)]
    assert not np.array_equal(*outs)


def test_depth_model_txt2img_matches_jax(depth_models, f32_policies):
    jm, pm = depth_models
    jp, pp = _pair(steps=3)
    _assert_same(port_proc.process_txt2img(pm, pp), jax_proc.process_txt2img(jm, jp), 1)


def test_depth_model_img2img_matches_jax(depth_models, f32_policies):
    """The init image's MiDaS depth as c_concat."""
    jm, pm = depth_models
    jp, pp = _pair(init_images=[_init_image(7)], denoising_strength=0.7, steps=4)
    _assert_same(port_i2i.process_img2img(pm, pp), jax_i2i.process_img2img(jm, jp), 1)


def test_depth_tower_loads_in_f32_and_moves(depth_models):
    _, pm = depth_models
    assert all(p.dtype == torch.float32 for p in pm.depth_model.parameters())
    assert pm.depth_model.cfg == dataclasses.replace(port_sd.TINY_DPT, vit_heads=1)


# --------------------------------------------------------------------------
# what still raises
# --------------------------------------------------------------------------

def test_unported_hybrid_requests_raise(inpaint_models, edit_models):
    _, nine = inpaint_models
    _, eight = edit_models
    init = dict(init_images=[_init_image()])
    cases = [
        (port_proc.process_txt2img, eight, {}, NotImplementedError, "8-channel"),
        (port_proc.process_txt2img, nine, dict(enable_hr=True, hr_scale=2.0,
                                                denoising_strength=0.5),
         NotImplementedError, "enable_hr with a 9-channel"),
        (port_proc.process_txt2img, nine, dict(override_settings={
            "inpainting_mask_weight": 0.5}), NotImplementedError, "inpainting_mask_weight"),
        (port_i2i.process_img2img, nine, dict(init, override_settings={
            "inpainting_mask_weight": 0.5}), NotImplementedError, "inpainting_mask_weight"),
        (port_i2i.process_img2img, eight, dict(init, controlnet_units=[
            {"model": "x", "module": "canny"}]), NotImplementedError, "controlnet_units"),
    ]
    for fn, model, kw, exc, words in cases:
        with pytest.raises(exc, match=words):
            fn(model, _pair(steps=1, **kw)[1])
    seven = dataclasses.replace(nine, unet_cfg=dataclasses.replace(nine.unet_cfg,
                                                                   in_channels=7))
    with pytest.raises(ValueError, match="7-channel"):
        port_i2i.process_img2img(seven, _pair(steps=1, **init)[1])
    five = dataclasses.replace(nine, unet_cfg=dataclasses.replace(nine.unet_cfg,
                                                                  in_channels=5))
    with pytest.raises(ValueError, match="without a depth model"):
        port_proc.process_txt2img(five, _pair(steps=1)[1])


# --------------------------------------------------------------------------
# the published layouts at full shape on meta
# --------------------------------------------------------------------------

def test_published_hybrid_layouts_load_on_meta():
    """runwayml's sd-v1-5-inpainting keys (the manifest) and an SD2-depth
    layout (the sd21 manifest with a 5-channel conv_in and a DPT-hybrid at
    the published widths under depth_model.model.) load on meta as the
    hybrids the pipelines accept."""
    from test_key_manifests import load_manifest
    from test_torch_loader import _meta_state_dict

    from sdwebui_tpu_torch.models.midas import DPTConfig, DPTDepthModel

    inpaint = port_from_sd(_meta_state_dict(load_manifest("sd15_inpaint")), device="meta")
    assert inpaint.unet_cfg.in_channels == 9 and not inpaint.is_depth
    port_proc.check_hybrid(inpaint)
    sd = _meta_state_dict(load_manifest("sd21"))
    sd["model.diffusion_model.input_blocks.0.0.weight"] = torch.empty(
        (320, 5, 3, 3), device="meta", dtype=torch.float16)
    sd.update({"depth_model.model." + k: v.to(torch.float16)
               for k, v in DPTDepthModel(DPTConfig(), device="meta").state_dict().items()})
    depth = port_from_sd(sd, device="meta")
    assert depth.kind == "sd2" and depth.unet_cfg.in_channels == 5 and depth.is_depth
    assert depth.depth_model.cfg == DPTConfig()
    assert all(p.dtype == torch.float32 for p in depth.depth_model.parameters())
    port_proc.check_hybrid(depth)


def test_ldm_state_dict_round_trips_an_sd2_depth_model():
    """The writer chip_smoke's SD2-depth file comes from: the SD2 text
    encoder in open_clip's keys (q, k, v fused back into in_proj) and the
    tower under depth_model.model.; read back, every tensor is the same
    (in the policy's dtypes; the tower's, standardised a second time,
    within 1e-5 of each weight's largest magnitude, 3.0e-6 measured)."""
    from sdwebui_tpu_torch.loader import load

    model = port_sd.create_tiny_sd(3, "cpu", in_channels=5)
    model.kind = "sd2"
    sd = load.ldm_state_dict(model)
    assert "cond_stage_model.model.transformer.resblocks.0.attn.in_proj_weight" in sd
    back = load.model_from_state_dict(sd, device="cpu")
    assert back.kind == "sd2" and back.is_depth and back.unet_cfg.in_channels == 5
    for a, b in ((model.unet, back.unet), (model.vae, back.vae),
                 (model.conditioner.model, back.conditioner.model)):
        for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            torch.testing.assert_close(x.to(y.dtype), y, rtol=0, atol=0, msg=name)
    for (name, x), y in zip(model.depth_model.state_dict().items(),
                            back.depth_model.state_dict().values()):
        _assert_rel(y.numpy(), x.numpy(), 1e-5)


def test_server_serves_hybrid_files(tmp_path, edit_models, f32_policies):
    """--ckpt / --ckpt-dir serve an instruct-pix2pix file: /sdapi/v1/img2img
    takes image_cfg_scale (the same image as process_img2img on the loaded
    model), and a tiny SD2-depth file switched to by override_settings
    answers txt2img and img2img."""
    import base64
    import json

    from sdwebui_tpu_torch.loader import load
    from sdwebui_tpu_torch.loader.safetensors_io import write_safetensors
    from sdwebui_tpu_torch.server.api import Api, _params_from_request
    from sdwebui_tpu_torch.server.app import Engine
    from sdwebui_tpu_torch.utils.png import decode_png, encode_png

    _, p2p = edit_models
    write_safetensors(str(tmp_path / "p2p.safetensors"), load.ldm_state_dict(p2p))
    depth = port_sd.create_tiny_sd(4, "cpu", in_channels=5)
    depth.kind = "sd2"
    write_safetensors(str(tmp_path / "depth.safetensors"), load.ldm_state_dict(depth))
    engine = Engine(device="cpu", ckpt=str(tmp_path / "p2p.safetensors"),
                    ckpt_dirs=[str(tmp_path)], hash_cache=str(tmp_path / "hashes.json"))
    api = Api(engine)
    png = base64.b64encode(encode_png(_init_image(5))).decode()
    body = {"init_images": [png], "prompt": "a red cat", "seed": 17, "steps": 3, "width": 64,
            "height": 64, "denoising_strength": 0.9, "image_cfg_scale": 1.5,
            "override_settings": {"sdtpu_vae_bf16": False}}
    status, out = api.handle("POST", "/sdapi/v1/img2img", body)
    assert status == 200, out
    served = decode_png(base64.b64decode(out["images"][0]))[0]
    direct = port_i2i.process_img2img(engine.sd_model,
                                      _params_from_request(body, img2img=True)).images[0]
    np.testing.assert_array_equal(served, direct)
    assert "Image CFG" not in json.loads(out["info"])["infotexts"][0]
    switch = {"override_settings": {"sd_model_checkpoint": "depth", "sdtpu_vae_bf16": False}}
    for route, extra in (("txt2img", {}), ("img2img", {"init_images": [png]})):
        status, out = api.handle("POST", f"/sdapi/v1/{route}", {
            "prompt": "a cat", "seed": 3, "steps": 2, "width": 64, "height": 64, **extra,
            **switch})
        assert status == 200, out
        assert engine.sd_model.is_depth
