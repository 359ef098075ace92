"""SD3 in the port against the JAX package (CPU, f32).

The rectified-flow tables and every sampler over them, the MMDiT (q/k norm
off and on, 77-, 154- and a ragged 100-token context), T5's buckets
(exactly) and its encoder, the converters' configs, ``encode_texts`` with
and without T5, and the tiny SD3 txt2img, img2img and hires requests, each
image within 1 uint8 level of JAX's with the same infotext.  Weights: the
JAX ``create_tiny_sd3`` (perturbed, with a tiny T5 whose width is the
MMDiT's context width) carried across with ``from_jax``.  A tiny SD3 file
with an F8_E4M3 T5 loads in both loaders to the same model.  The requests
the port refuses for SD3 answer 422 over HTTP.  Inputs come from numpy
seeds; tolerances are stated per test.
"""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
from torch_jax_state import jax_vae_file_reset  # noqa: F401  (JAX's loaded-VAE global)
import base64
import dataclasses
import json
import os
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdwebui_tpu.loader import load as jax_load
from sdwebui_tpu.loader import safetensors_io as jax_st
from sdwebui_tpu.models import mmdit as jax_mmdit
from sdwebui_tpu.models import t5 as jax_t5
from sdwebui_tpu.models import vae_approx as jax_vae_approx
from sdwebui_tpu.pipeline import img2img as jax_i2i
from sdwebui_tpu.pipeline import processing as jax_proc
from sdwebui_tpu.pipeline import sd_model as jax_sd
from sdwebui_tpu.pipeline.params import GenerationParams as JaxParams
from sdwebui_tpu.sampling import discretization as jax_disc
from sdwebui_tpu.sampling import sampler as jax_sampler
from sdwebui_tpu.sampling import solvers as jax_solvers
from sdwebui_tpu.sampling.registry import build_sigmas as jax_build_sigmas
from sdwebui_tpu.text import sentencepiece as jax_spm
from sdwebui_tpu.utils import devices as jax_devices
from sdwebui_tpu.utils.options import opts as jax_opts
from sdwebui_tpu_torch.loader import convert, load
from sdwebui_tpu_torch.loader import safetensors_io
from sdwebui_tpu_torch.models import mmdit, t5, vae_approx
from sdwebui_tpu_torch.pipeline import img2img as port_i2i
from sdwebui_tpu_torch.pipeline import processing as port_proc
from sdwebui_tpu_torch.pipeline import sd_model as port_sd
from sdwebui_tpu_torch.pipeline.params import GenerationParams
from sdwebui_tpu_torch.sampling import discretization, schedulers
from sdwebui_tpu_torch.sampling import sampler as port_sampler
from sdwebui_tpu_torch.sampling.registry import SAMPLERS, build_sigmas
from sdwebui_tpu_torch.text import sentencepiece as spm
from sdwebui_tpu_torch.utils import devices as port_devices
from sdwebui_tpu_torch.utils.options import opts
from sdwebui_tpu_torch.utils.png import encode_png
from test_sentencepiece import VOCAB, _model_proto
from test_torch_img2img import _init_image
from test_torch_loader import _hf_clip, _ldm, _open_clip
from test_torch_models import _assert_rel, _perturbed
from test_torch_solvers import SHAPE, _jax_model, _port_model

TINY_T5 = jax_t5.T5Config(vocab_size=64, d_model=96, d_kv=8, d_ff=48, num_layers=2,
                          num_heads=4)


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


@pytest.fixture(scope="module")
def t5_tokenizer(tmp_path_factory):
    path = tmp_path_factory.mktemp("t5") / "spiece.model"
    path.write_bytes(_model_proto(VOCAB))
    return str(path)


def _jax_sd3(seed=1, with_t5=False, tokenizer=None):
    rng = np.random.default_rng(seed + 30)
    jm = jax_sd.create_tiny_sd3(seed)
    jm = dataclasses.replace(jm, unet_params=_perturbed(jm.unet_params, rng),
                             vae_params=_perturbed(jm.vae_params, rng))
    for cond in (jm.conditioner, jm.conditioner2):
        cond.params = _perturbed(cond.params, rng)
    if with_t5:
        jm = dataclasses.replace(
            jm, t5_params=_perturbed(jax_t5.init_params(TINY_T5, seed + 9), rng),
            t5_cfg=TINY_T5, t5_tokenizer=tokenizer)
    return jm


@pytest.fixture(scope="module")
def models(t5_tokenizer):
    """(JAX, port) tiny SD3 without T5, and with T5 and a tokenizer."""
    jm = _jax_sd3()
    jt = _jax_sd3(2, with_t5=True, tokenizer=jax_spm.make_t5_tokenizer(t5_tokenizer))
    return jm, port_sd.from_jax(jm), jt, port_sd.from_jax(jt)


# --------------------------------------------------------------------------
# the rectified-flow schedule and the samplers over it
# --------------------------------------------------------------------------

def test_flow_discretization_tables():
    a, b = discretization.FlowDiscretization(3.0), jax_disc.FlowDiscretization(3.0)
    np.testing.assert_allclose(a.sigmas, b.sigmas, rtol=0, atol=1e-12)
    np.testing.assert_allclose(a.log_sigmas, b.log_sigmas, rtol=0, atol=1e-12)
    assert a.sigma_max == b.sigma_max == pytest.approx(1.0) and a.prediction_type == "flow"
    assert a.sigma_min == b.sigma_min and a.alphas_cumprod is None and not a.quantize
    for s in (0.003, 0.2, 0.75, 1.0):
        assert a.sigma_to_t(s) == b.sigma_to_t(s)
    np.testing.assert_allclose(a.get_sigmas(9), b.get_sigmas(9), rtol=0, atol=1e-12)
    x, n = np.linspace(-1, 1, 5), np.linspace(2, 3, 5)
    np.testing.assert_array_equal(a.noise_scaling(0.3, n, x), b.noise_scaling(0.3, n, x))


@pytest.mark.parametrize("name", sorted(schedulers.SCHEDULERS))
def test_every_scheduler_on_the_flow_table(name):
    """Each schedule the port lists builds its σ table from the flow
    discretization as JAX's does."""
    from sdwebui_tpu.sampling import schedulers as jax_sched

    a = schedulers.get_schedule(name, 10, discretization.FlowDiscretization(3.0))
    b = jax_sched.get_schedule(name, 10, jax_disc.FlowDiscretization(3.0))
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", [s.name for s in SAMPLERS])
def test_every_sampler_on_flow_sigmas(name):
    """Every sampler name over SD3's σ table (σ_max = 1) around an analytic
    denoiser: where JAX gives a number the port gives it (max|Δ| <= 1e-5 ·
    max|ref|); where JAX fails (LCM: no ᾱ table), the port's pipeline
    refuses the sampler by name."""
    from sdwebui_tpu.sampling.registry import SAMPLER_MAP as JAX_MAP

    sampler = next(s for s in SAMPLERS if s.name == name)
    scheduler = port_proc._resolve_scheduler(sampler, "Automatic")
    if sampler.solver == "lcm":
        with pytest.raises(TypeError):
            jax_build_sigmas(JAX_MAP[name], scheduler, 6, jax_disc.FlowDiscretization(3.0))
        with pytest.raises(NotImplementedError, match="LCM"):
            port_proc.check_family(port_sd.SDModel(
                unet=None, unet_cfg=None, vae=None, vae_cfg=None,
                disc=discretization.FlowDiscretization(), conditioner=None, device="cpu",
                kind="sd3"), GenerationParams(sampler_name=name))
        return
    sig = build_sigmas(sampler, scheduler, 6, discretization.FlowDiscretization(3.0))
    np.testing.assert_array_equal(
        sig, jax_build_sigmas(JAX_MAP[name], scheduler, 6, jax_disc.FlowDiscretization(3.0)))
    sig = sig.astype(np.float32)
    rng = np.random.default_rng(len(name))
    x = rng.standard_normal(SHAPE, dtype=np.float32) * sig[0]
    noise = rng.standard_normal((len(sig) - 1, 2, *SHAPE), dtype=np.float32)
    if sampler.solver == "restart":
        pairs, _ = jax_solvers.build_restart_plan(sig)
        noise = np.tile(noise, (-(-len(pairs) // len(noise)), 1, 1, 1, 1, 1))[:len(pairs)]
    cfgpp = sampler.solver == "ddim_cfgpp"
    ref = np.asarray(jax_sampler.sample(_jax_model([], cfgpp), jnp.asarray(x), sig,
                                        solver=sampler.solver, noise=jnp.asarray(noise),
                                        extra=dict(sampler.extra), mode="stepwise"))
    out = port_sampler.sample(_port_model([], cfgpp), torch.from_numpy(x), sig, sampler.solver,
                              torch.from_numpy(noise), dict(sampler.extra)).numpy()
    assert np.isfinite(ref).all() and np.isfinite(out).all()
    _assert_rel(out, ref, 1e-5)


# --------------------------------------------------------------------------
# the MMDiT and T5
# --------------------------------------------------------------------------

MMDIT_CASES = [(False, 77), (False, 154), (False, 100), (True, 77), (True, 100)]


@pytest.mark.parametrize("qk_norm,ctx_len", MMDIT_CASES)
def test_mmdit_forward_matches_jax(qk_norm, ctx_len):
    """f32, 1e-4 of the largest magnitude; the context lengths of CLIP
    alone, CLIP ⊕ T5, and a ragged one."""
    cfg = jax_mmdit.MMDiTConfig(depth=2, in_channels=16, context_dim=96, pooled_dim=80,
                                pos_embed_max_size=16, qk_norm=qk_norm)
    rng = np.random.default_rng(ctx_len + qk_norm)
    params = _perturbed(jax_mmdit.init_params(cfg, 3), rng)
    port = mmdit.mmdit_from_jax(params, cfg)
    x = rng.standard_normal((2, 6, 10, 16)).astype(np.float32)
    t = np.array([981.0, 137.5], np.float32)
    ctx = rng.standard_normal((2, ctx_len, 96)).astype(np.float32)
    y = rng.standard_normal((2, 80)).astype(np.float32)
    ref = np.asarray(jax_mmdit.apply(params, cfg, jnp.asarray(x), jnp.asarray(t),
                                     jnp.asarray(ctx), jnp.asarray(y)))
    with torch.no_grad():
        out = port(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), torch.from_numpy(t),
                   torch.from_numpy(ctx), torch.from_numpy(y)).numpy()
    _assert_rel(out.transpose(0, 2, 3, 1), ref, 1e-4)


def test_mmdit_layer_norm_plan_counts_calls(monkeypatch):
    """layer_norm_calls is what one forward calls (the launch plans of
    chip_smoke hold B5 to it)."""
    from sdwebui_tpu_torch.ops import norms

    calls = []
    real = norms.layer_norm
    monkeypatch.setattr(mmdit, "layer_norm", lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg = mmdit.MMDiTConfig(depth=3, context_dim=32, pooled_dim=16, pos_embed_max_size=8)
    m = mmdit.MMDiT(cfg, device="cpu", dtype=torch.float32)
    m.reset_random(torch.Generator().manual_seed(0))
    with torch.no_grad():
        m(torch.randn(1, 16, 8, 8), torch.tensor([500.0]), torch.randn(1, 5, 32),
          torch.randn(1, 16))
    assert len(calls) == mmdit.layer_norm_calls(cfg) == 4 * 3
    assert mmdit.self_attention_calls(cfg, 8, 5) == [(16 + 5, 3, 64)] * 3


def test_t5_buckets_exact():
    pos = np.arange(300)
    rel = pos[None, :] - pos[:, None]
    for buckets, dist in ((32, 128), (16, 64)):
        np.testing.assert_array_equal(t5.relative_position_bucket(rel, buckets, dist),
                                      jax_t5.relative_position_bucket(rel, buckets, dist))


def test_t5_encoder_matches_jax():
    rng = np.random.default_rng(5)
    params = _perturbed(jax_t5.init_params(TINY_T5, 4), rng)
    port = t5.t5_from_jax(params, TINY_T5)
    ids = rng.integers(0, TINY_T5.vocab_size, (2, 77)).astype(np.int32)
    ref = np.asarray(jax_t5.apply(params, TINY_T5, jnp.asarray(ids)))
    with torch.no_grad():
        out = port(torch.from_numpy(ids.astype(np.int64))).numpy()
    _assert_rel(out, ref, 1e-4)


def _sd3_state_dict(jm, t5_fp8=False):
    """A tiny SD3 checkpoint from a JAX model: the MMDiT, the VAE and
    CLIP-L under their checkpoint keys, bigG in open_clip's layout (what
    the JAX loader reads), T5 under text_encoders.t5xxl.transformer. (its
    matrices F8_E4M3 with t5_fp8)."""
    sd = _ldm(jm.unet_params, "model.diffusion_model.")
    sd.update(_ldm(jm.vae_params, "first_stage_model."))
    sd.update(_hf_clip(jm.conditioner.params, "text_encoders.clip_l.transformer.text_model."))
    sd.update(_open_clip(jm.conditioner2.params, "text_encoders.clip_g.model."))
    if jm.t5_params is not None:
        for k, v in t5.t5_from_jax(jm.t5_params, jm.t5_cfg).state_dict().items():
            if t5_fp8 and v.dim() == 2:
                v = v.to(torch.float8_e4m3fn)
            sd["text_encoders.t5xxl.transformer." + k] = v
        sd["text_encoders.t5xxl.transformer.encoder.embed_tokens.weight"] = \
            sd["text_encoders.t5xxl.transformer.shared.weight"]
    return sd


def test_converters_derive_jax_configs(models):
    jm, _, jt, _ = models
    sd = _sd3_state_dict(jt)
    flat, cfg = convert.convert_mmdit(sd)
    _, jcfg = jax_load.convert.convert_mmdit({k: v.numpy() for k, v in sd.items()
                                              if k.startswith("model.")})
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert convert.has_pre_only_proj(flat, cfg.depth)     # the JAX init's tree has one
    t5_sd, t5_cfg = t5.convert_t5(sd)
    _, jt5_cfg = jax_t5.convert_t5({k: v.float().numpy() for k, v in sd.items()
                                    if k.startswith("text_encoders.t5xxl.")})
    assert t5_cfg == t5.T5Config(**dataclasses.asdict(jt5_cfg)) and "shared.weight" in t5_sd
    # the published layout: no proj on the last pre-only context side
    pub = {k: v for k, v in flat.items()
           if not k.startswith(f"joint_blocks.{cfg.depth - 1}.context_block.attn.proj.")}
    pub_cfg = convert.convert_mmdit({"m." + k: v for k, v in pub.items()}, "m.")[1]
    assert pub_cfg == cfg and not convert.has_pre_only_proj(pub, cfg.depth)
    with pytest.raises(ValueError, match="missing"):
        convert.convert_mmdit({"m." + k: v for k, v in pub.items()
                               if "x_block.mlp.fc1.bias" not in k}, "m.")


@pytest.mark.parametrize("which", ["no_t5", "t5"])
def test_from_jax_consumes_every_key(models, which):
    from sdwebui_tpu.utils.pytree import flatten

    jm, pm = models[:2] if which == "no_t5" else models[2:]
    assert set(pm.unet.state_dict()) == set(flatten(jm.unet_params))
    assert pm.is_sd3 and pm.disc.prediction_type == "flow" and pm.vae_cfg.shift_factor == 0.0609
    if which == "t5":
        assert set(pm.t5.state_dict()) == set(flatten(jm.t5_params))
    else:
        assert pm.t5 is None


@pytest.mark.parametrize("which", ["no_t5", "t5"])
def test_encode_texts_matches_jax(models, which):
    """CLIP-L ⊕ bigG zero-padded to 96, T5's 77 tokens after them (154)
    with T5, pooled 32 + 64: 1e-4."""
    jm, pm = models[:2] if which == "no_t5" else models[2:]
    texts = ["a cat on the mat", "", "the (red:1.3) cat"]
    jc, jp = jm.encode_texts(texts)
    pc, pp = pm.encode_texts(texts)
    assert tuple(pc.shape) == (3, 154 if which == "t5" else 77, 96) == jc.shape
    _assert_rel(pc.numpy(), np.asarray(jc), 1e-4)
    _assert_rel(pp.numpy(), np.asarray(jp), 1e-4)


# --------------------------------------------------------------------------
# requests
# --------------------------------------------------------------------------

def _pair(**kw):
    base = dict(prompt="a (red:1.2) cat [in the snow:on a hill:0.5]", negative_prompt="blurry",
                seed=17, steps=5, width=64, height=64, batch_size=1, cfg_scale=5.0,
                sampler_name="Euler", scheduler="Automatic",
                override_settings={"sdtpu_vae_bf16": False})
    base.update(kw)
    return JaxParams(**base), GenerationParams(**base)


def _assert_same(ref, out):
    ref_imgs = [np.asarray(im) for im in ref.images]
    assert len(out.images) == len(ref_imgs) >= 1
    for a, b in zip(out.images, ref_imgs):
        assert a.shape == b.shape and a.dtype == np.uint8
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert out.infotexts == ref.infotexts


TXT2IMG_CASES = {
    "euler": dict(),
    "dpmpp_2m_karras_batch2": dict(sampler_name="DPM++ 2M", scheduler="Karras", batch_size=2),
    "hires_latent": dict(enable_hr=True, hr_scale=2, hr_upscaler="Latent",
                         denoising_strength=0.6, steps=4),
}


@pytest.mark.parametrize("case", list(TXT2IMG_CASES))
@pytest.mark.parametrize("which", ["no_t5", "t5"])
def test_sd3_txt2img_matches_jax(models, f32_policies, case, which):
    jm, pm = models[:2] if which == "no_t5" else models[2:]
    jp, pp = _pair(**TXT2IMG_CASES[case])
    _assert_same(jax_proc.process_txt2img(jm, jp), port_proc.process_txt2img(pm, pp))


@pytest.mark.parametrize("denoise", [0.75, 0.4])
def test_sd3_img2img_matches_jax(models, f32_policies, denoise):
    jm, pm = models[:2]
    jp, pp = _pair(init_images=[_init_image(seed=41)], denoising_strength=denoise)
    _assert_same(jax_i2i.process_img2img(jm, jp), port_i2i.process_img2img(pm, pp))


def test_sd3_inpaint_matches_jax(models, f32_policies):
    mask = np.zeros((64, 64), np.uint8)
    mask[16:40, 20:48] = 255
    jp, pp = _pair(init_images=[_init_image(seed=42)], mask=mask, mask_blur=4,
                   inpainting_fill=1, inpaint_full_res=False)
    _assert_same(jax_i2i.process_img2img(models[0], jp), port_i2i.process_img2img(models[1], pp))


def test_sd3_cheap_preview_matches_jax():
    rng = np.random.default_rng(8)
    lat = rng.standard_normal((1, 16, 8, 8)).astype(np.float32)
    ref = np.asarray(jax_vae_approx.cheap_approximation(jnp.asarray(lat.transpose(0, 2, 3, 1)),
                                                        "sd3"))
    out = vae_approx.cheap_approximation(torch.from_numpy(lat), "sd3")
    _assert_rel(out.permute(0, 2, 3, 1).numpy(), ref, 1e-6)
    assert vae_approx._taesd_stem("sd3") == "taesd3"


# --------------------------------------------------------------------------
# files
# --------------------------------------------------------------------------

@pytest.fixture
def t5_on():
    prev_j, prev_p = jax_opts.get("sd3_enable_t5", False), opts.get("sd3_enable_t5", False)
    jax_opts.data["sd3_enable_t5"] = opts.data["sd3_enable_t5"] = True
    yield
    jax_opts.data["sd3_enable_t5"], opts.data["sd3_enable_t5"] = prev_j, prev_p


def test_fp8_t5_file_loads_the_same_in_both(models, f32_policies, t5_on, tmp_path):
    """The tiny SD3 file with an F8_E4M3 T5, written by the port, read by
    both loaders with sd3_enable_t5 on: the same weights (the fp8 values
    cast exactly), the same model config, and the same image."""
    jt = models[2]
    path = str(tmp_path / "sd3-tiny.safetensors")
    safetensors_io.write_safetensors(path, _sd3_state_dict(jt, t5_fp8=True))
    header = json.loads(open(path, "rb").read()[8:8 + int.from_bytes(
        open(path, "rb").read(8), "little")])
    assert header["text_encoders.t5xxl.transformer.shared.weight"]["dtype"] == "F8_E4M3"
    jl = jax_load.load_model(path)
    pl = load.load_model(path, device="cpu")
    assert pl.kind == jl.kind == "sd3" and pl.t5 is not None and jl.t5_params is not None
    assert pl.t5_cfg == t5.T5Config(**dataclasses.asdict(jl.t5_cfg))
    back = t5.t5_from_jax(jl.t5_params, jl.t5_cfg).state_dict()
    for k, v in pl.t5.state_dict().items():
        torch.testing.assert_close(v, back[k], rtol=0, atol=0, msg=k)
    tok = str(tmp_path / "spiece.model")
    with open(tok, "wb") as f:
        f.write(_model_proto(VOCAB))
    jl.t5_tokenizer = jax_spm.make_t5_tokenizer(tok)
    pl.t5_tokenizer = spm.make_t5_tokenizer(tok)
    jp, pp = _pair(steps=3)
    _assert_same(jax_proc.process_txt2img(jl, jp), port_proc.process_txt2img(pl, pp))


def test_fp8_read_equals_jax(tmp_path):
    import ml_dtypes

    rng = np.random.default_rng(9)
    a = rng.standard_normal((6, 5)).astype(np.float32)
    p = str(tmp_path / "fp8.safetensors")
    jax_st.write_safetensors(p, {"e4": a.astype(ml_dtypes.float8_e4m3fn),
                                 "e5": a.astype(ml_dtypes.float8_e5m2)})
    ours, ref = safetensors_io.read_state_dict(p), jax_st.read_state_dict(p)
    assert ours["e4"].dtype == torch.float8_e4m3fn and ours["e5"].dtype == torch.float8_e5m2
    for k in ("e4", "e5"):
        np.testing.assert_array_equal(ours[k].float().numpy(), np.asarray(ref[k], np.float32))
    back = str(tmp_path / "back.safetensors")
    safetensors_io.write_safetensors(back, ours)
    assert open(back, "rb").read() == open(p, "rb").read() or \
        safetensors_io.read_state_dict(back)["e4"].view(torch.uint8).equal(
            ours["e4"].view(torch.uint8))


def test_published_layout_loads_on_meta():
    """SD3-medium at full shape on meta, with the published files' key
    layout: no proj on the last pre-only context side, no quant convs in
    the VAE, bigG under text_encoders.clip_g.transformer. in HF's layout,
    T5-XXL's 24 blocks."""
    from sdwebui_tpu_torch.models import configs
    from sdwebui_tpu_torch.models.clip import CLIPTextModel
    from sdwebui_tpu_torch.models.vae import AutoencoderKL

    sd = {}

    def put(prefix, module):
        sd.update({prefix + k: v for k, v in module.state_dict().items()})

    put("model.diffusion_model.", mmdit.MMDiT(mmdit.SD3_MEDIUM, device="meta",
                                              dtype=torch.float16))
    put("first_stage_model.", AutoencoderKL(port_sd.SD3_VAE, device="meta",
                                            dtype=torch.float16, quant_conv=False))
    put("text_encoders.clip_l.transformer.text_model.",
        CLIPTextModel(configs.CLIP_L, device="meta", dtype=torch.float16))
    g = CLIPTextModel(configs.OPEN_CLIP_BIGG, device="meta", dtype=torch.float16).state_dict()
    sd["text_encoders.clip_g.transformer.text_projection.weight"] = g.pop("text_projection.weight")
    sd.update({"text_encoders.clip_g.transformer.text_model." + k: v for k, v in g.items()})
    put("text_encoders.t5xxl.transformer.", t5.T5Encoder(t5.T5_XXL, device="meta",
                                                         dtype=torch.float8_e4m3fn))
    with opts.override({"sd3_enable_t5": True}):
        model = load.model_from_state_dict(sd, device="meta")
    assert model.unet_cfg == mmdit.SD3_MEDIUM and model.vae_cfg == port_sd.SD3_VAE
    assert model.conditioner2.cfg.projection_dim == 1280
    assert model.conditioner2.cfg.activation == "gelu" and model.t5_cfg == t5.T5_XXL
    assert isinstance(model.vae.quant_conv, torch.nn.Identity)


# --------------------------------------------------------------------------
# over HTTP
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def server_url(models):
    from sdwebui_tpu_torch.server.api import make_server
    from sdwebui_tpu_torch.server.app import Engine

    # the model is its own resident "refiner" too, so a refiner request
    # reaches the pipeline's family check
    engine = Engine(model=models[1], device="cpu", hash_cache=None,
                    extra_models={models[1].title: models[1]})
    server = make_server(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}/sdapi/v1/"
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


_BODY = {"prompt": "a cat", "steps": 2, "width": 64, "height": 64, "seed": 3,
         "sampler_name": "Euler"}
_PNG = base64.b64encode(encode_png(_init_image(seed=43))).decode()

REFUSALS = {
    "lora": ("txt2img", {"prompt": "a cat <lora:any:0.8>"}, "<lora:...>"),
    "hypernet": ("txt2img", {"prompt": "a cat <hypernet:any:1>"}, "hypernetworks"),
    "controlnet": ("txt2img", {"alwayson_scripts": {"controlnet": {"args": [
        {"enabled": True, "module": "canny", "model": "any", "image": _PNG}]}}},
        "controlnet_units"),
    "tiling": ("txt2img", {"tiling": True}, "tiling"),
    "lcm": ("txt2img", {"sampler_name": "LCM"}, "LCM"),
    "soft_inpainting": ("img2img", {"init_images": [_PNG], "mask": _PNG,
                                    "soft_inpainting": True}, "soft inpainting"),
    "refiner": ("txt2img", {"refiner_checkpoint": "tiny-sd3-test [0000000000]",
                            "refiner_switch_at": 0.8}, "refiner_checkpoint"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_answer_422(server_url, case):
    route, extra, needle = REFUSALS[case]
    status, res = _post(server_url + route, dict(_BODY, **extra))
    assert status == 422 and needle in res["detail"], res


def test_sd3_txt2img_route(server_url):
    status, res = _post(server_url + "txt2img", _BODY)
    assert status == 200, res
    assert "Model: tiny-sd3-test" in json.loads(res["info"])["infotexts"][0]
    status, res = _post(server_url + "options", {"sd3_enable_t5": True})
    assert status == 200 and opts.get("sd3_enable_t5") is True
    opts.data["sd3_enable_t5"] = False


def test_checkpoint_switch_to_and_from_sd3(tmp_path, monkeypatch):
    """An SD3 file beside an SD1 file: sd-models lists both, a switch to SD3
    and back parks the displaced model in the LRU (sd_checkpoints_limit 2)
    with no second file read, and each serves txt2img."""
    from sdwebui_tpu_torch.server.api import Api
    from sdwebui_tpu_torch.server.app import Engine

    sd1, sd3 = str(tmp_path / "tiny-sd1.safetensors"), str(tmp_path / "tiny-sd3.safetensors")
    safetensors_io.write_safetensors(sd1, load.ldm_state_dict(port_sd.create_tiny_sd(1, "cpu")))
    safetensors_io.write_safetensors(sd3, load.ldm_state_dict(port_sd.create_tiny_sd3(2, "cpu")))
    reads, real = [], load.read_checkpoint

    def counted(path, *a, **k):
        reads.append(os.path.basename(path))
        return real(path, *a, **k)

    body = {"prompt": "a cat", "steps": 2, "width": 64, "height": 64, "seed": 3,
            "sampler_name": "Euler"}
    # the switches set the process's checkpoint settings: back to the defaults after
    for key in ("sd_model_checkpoint", "sd_checkpoint_hash"):
        monkeypatch.setitem(opts.data, key, opts.data.get(key))
    with opts.override({"sd_checkpoints_limit": 2}):
        load.read_checkpoint = counted
        try:
            api = Api(Engine(device="cpu", ckpt=sd1, ckpt_dirs=[str(tmp_path)],
                             hash_cache=str(tmp_path / "cache.json")))
            listed = sorted(m["filename"] for m in api.handle("GET", "/sdapi/v1/sd-models",
                                                              None)[1])
            assert listed == sorted([sd1, sd3])
            images = []
            for name in ("tiny-sd1", "tiny-sd3", "tiny-sd1", "tiny-sd3"):
                assert api.handle("POST", "/sdapi/v1/options",
                                  {"sd_model_checkpoint": name}) == (200, {})
                status, out = api.handle("POST", "/sdapi/v1/txt2img", body)
                assert status == 200, out
                images.append(out["images"][0])
                assert api.engine.sd_model.kind == ("sd3" if name == "tiny-sd3" else "sd1")
        finally:
            load.read_checkpoint = real
    assert reads == ["tiny-sd1.safetensors", "tiny-sd3.safetensors"]
    assert images[0] == images[2] and images[1] == images[3] and images[0] != images[1]
