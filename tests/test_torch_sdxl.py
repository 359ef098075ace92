"""The SDXL base+refiner slice of the port vs the JAX package (CPU, f32).

Weights: the JAX ``create_tiny_sdxl`` model and a tiny refiner built from
the port's ``TINY_SDXL_REFINER_UNET`` config (bigG and VAE shared with the
base, as the JAX bench shares them), carried across with
``sd_model.from_jax``.  Biases and norm gains are perturbed so that
layer-normed outputs are not exactly zero-mean (see test_torch_models).
Inputs are made with numpy from a seed; layouts are NHWC on the JAX side
and NCHW in the port.  Tolerances are stated per test.
"""

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

from sdwebui_tpu.models import clip as jax_clip
from sdwebui_tpu.models import unet as jax_unet
from sdwebui_tpu.pipeline import processing as jax_proc
from sdwebui_tpu.pipeline import sd_model as jax_sd
from sdwebui_tpu.pipeline.params import GenerationParams
from sdwebui_tpu.utils import devices as jax_devices
from sdwebui_tpu_torch.pipeline import processing as port_proc
from sdwebui_tpu_torch.pipeline import sd_model as port_sd
from sdwebui_tpu_torch.utils import devices as port_devices
from test_torch_models import _assert_rel, _nchw, _nhwc, _perturbed

REFINER_TITLE = "tiny-sdxl-refiner-test [0000000001]"


@pytest.fixture(scope="module")
def models():
    """(JAX base, JAX refiner, port base, port refiner)."""
    rng = np.random.default_rng(70)
    jb = jax_sd.create_tiny_sdxl(7)
    jb = dataclasses.replace(jb, unet_params=_perturbed(jb.unet_params, rng),
                             vae_params=_perturbed(jb.vae_params, rng))
    for cond in (jb.conditioner, jb.conditioner2):
        cond.params = _perturbed(cond.params, rng)
    ref_params = jax_unet.init_params(port_sd.TINY_SDXL_REFINER_UNET, 107, dtype=jnp.float32)
    jr = dataclasses.replace(
        jb, kind="sdxl-refiner", unet_params=_perturbed(ref_params, rng),
        unet_cfg=port_sd.TINY_SDXL_REFINER_UNET, conditioner=jb.conditioner2,
        conditioner2=None, title=REFINER_TITLE)
    return jb, jr, port_sd.from_jax(jb, device="cpu"), port_sd.from_jax(jr, device="cpu")


@pytest.fixture
def f32_policies():
    jax_prev, port_prev = jax_devices.get_policy(), port_devices.get_policy()
    jax_devices.set_policy(jax_devices.DtypePolicy(jnp.float32, jnp.float32,
                                                   jnp.float32, jnp.float32))
    port_devices.set_policy(port_devices.FP32_POLICY)
    yield
    jax_devices.set_policy(jax_prev)
    port_devices.set_policy(port_prev)


def test_from_jax_consumes_every_key(models):
    from sdwebui_tpu.utils.pytree import flatten

    jb, jr, pb, pr = models
    assert (pb.kind, pr.kind) == ("sdxl", "sdxl-refiner") and pr.conditioner2 is None
    for jm, pm in ((jb, pb), (jr, pr)):
        assert set(flatten(jm.unet_params)) == set(pm.unet.state_dict())
        assert {k for k in pm.unet.state_dict() if k.startswith("label_emb.")} == {
            "label_emb.0.0.weight", "label_emb.0.0.bias",
            "label_emb.0.2.weight", "label_emb.0.2.bias"}
    g = jb.conditioner2.params
    assert set(flatten(g)) == set(pb.conditioner2.model.state_dict())
    # text_projection: (in, out) in the JAX tree, HF's (out, in) in the port
    np.testing.assert_array_equal(
        pb.conditioner2.model.text_projection.weight.numpy(),
        np.asarray(g["text_projection"]["weight"]).T)
    assert (pb.conditioner2.clip_skip, pb.conditioner2.apply_final_norm) == (2, False)
    # the linear transformer projections are linears, (out, in)
    w = np.asarray(jb.unet_params["input_blocks"]["4"]["1"]["proj_in"]["weight"])
    np.testing.assert_array_equal(pb.unet.input_blocks[4][1].proj_in.weight.numpy(), w.T)


@pytest.mark.parametrize("which", ["base", "refiner"])
def test_unet_with_y_matches_jax(models, which):
    """Linear proj_in/proj_out, label_emb on y and (refiner) an explicit
    middle depth; tolerance: 1e-4 of the output's largest magnitude (f32)."""
    jb, jr, pb, pr = models
    jm, pm = (jb, pb) if which == "base" else (jr, pr)
    cfg = jm.unet_cfg
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 16, 16, 4), dtype=np.float32)
    t = np.asarray([999.0, 321.5], np.float32)
    ctx = rng.standard_normal((2, 154, cfg.context_dim), dtype=np.float32)
    y = rng.standard_normal((2, cfg.adm_in_channels), dtype=np.float32)
    apply = jax.jit(lambda p, *a: jax_unet.apply(p, cfg, *a))
    ref = np.asarray(apply(jm.unet_params, jnp.asarray(x), jnp.asarray(t),
                           jnp.asarray(ctx), jnp.asarray(y)))
    with torch.inference_mode():
        out = pm.unet(_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx),
                      torch.from_numpy(y))
    _assert_rel(_nhwc(out), ref, 1e-4)
    with pytest.raises(ValueError, match="vector conditioning"):
        pm.unet(_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx))


@pytest.mark.parametrize("clip_skip,final_norm", [(1, True), (2, False)])
def test_bigg_matches_jax(models, clip_skip, final_norm):
    """OpenCLIP-bigG-shaped encoder with text_projection: hidden and the
    projected pooled output; tolerance 1e-4 of the largest magnitude."""
    jb, _, pb, _ = models
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, 49406, (3, 77)).astype(np.int32)
    tokens[:, 0] = 49406
    tokens[np.arange(3), [4, 30, 76]] = 49407
    hid_ref, pool_ref = jax_clip.encode(jb.conditioner2.params, jb.conditioner2.cfg,
                                        jnp.asarray(tokens), clip_skip - 1, final_norm)
    with torch.inference_mode():
        hid, pool = pb.conditioner2.model.encode(torch.from_numpy(tokens).long(),
                                                 clip_skip - 1, final_norm)
    assert pool.shape == (3, jb.conditioner2.cfg.projection_dim)
    _assert_rel(hid.numpy(), np.asarray(hid_ref), 1e-4)
    _assert_rel(pool.numpy(), np.asarray(pool_ref), 1e-4)


@pytest.mark.parametrize("which", ["base", "refiner"])
def test_sdxl_vector_maker_matches_jax(models, which):
    """[pooled | size, crop and target (or aesthetic) embeddings]; absolute
    tolerance 1e-4: cos/sin of f32 arguments up to 1024 differ by about one
    ulp (6e-5) between XLA and torch."""
    jb, jr, pb, pr = models
    jm, pm = (jb, pb) if which == "base" else (jr, pr)
    rng = np.random.default_rng(10)
    pooled = rng.standard_normal((3, 64), dtype=np.float32)
    is_uncond = np.asarray([False, False, True])
    kw = dict(width=1024, height=768, crop=(16, 8), aesthetic_score=6.5,
              negative_aesthetic_score=2.0)
    ref = np.asarray(jax_sd.sdxl_vector_maker(jm, **kw)(jnp.asarray(pooled),
                                                        jnp.asarray(is_uncond)))
    out = port_sd.sdxl_vector_maker(pm, **kw)(torch.from_numpy(pooled),
                                              torch.from_numpy(is_uncond)).numpy()
    assert out.shape == ref.shape == (3, pm.unet_cfg.adm_in_channels)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


def test_sdxl_cond_schedule_matches_jax(models):
    """Prompt editing and AND with the SDXL dual encoder: cond banks (1e-4
    of the largest magnitude), vector banks (1e-4 absolute) and index tables."""
    from sdwebui_tpu.text.conditioner import build_cond_schedule as jax_build
    from sdwebui_tpu_torch.text.conditioner import build_cond_schedule

    jb, _, pb, _ = models
    for m in (jb, pb):
        m.conditioner.clip_skip = m.conditioner2.clip_skip = 2
    prompt, negative = "a [dog:cat:0.5] on a hill AND a castle :0.6", "[bad:good:2]"
    ref = jax_build(jb.encode_texts, prompt, negative, 6, cond_scale=5.0,
                    vector_maker=jax_sd.sdxl_vector_maker(jb, 64, 64))
    out = build_cond_schedule(pb.encode_texts, prompt, negative, 6, cond_scale=5.0,
                              vector_maker=port_sd.sdxl_vector_maker(pb, 64, 64))
    assert out.cond_bank.shape == ref.cond_bank.shape and out.cond_bank.shape[-1] == 96
    np.testing.assert_array_equal(out.cond_idx, np.asarray(ref.cond_idx))
    np.testing.assert_array_equal(out.uncond_idx, np.asarray(ref.uncond_idx))
    _assert_rel(out.cond_bank.numpy(), np.asarray(ref.cond_bank), 1e-4)
    _assert_rel(out.uncond_bank.numpy(), np.asarray(ref.uncond_bank), 1e-4)
    np.testing.assert_allclose(out.vector_bank.numpy(), np.asarray(ref.vector_bank),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(out.vector_uncond_bank.numpy(),
                               np.asarray(ref.vector_uncond_bank), rtol=0, atol=1e-4)


@pytest.mark.parametrize("with_vectors", [False, True])
def test_cfg_dpmpp_2m_matches_jax(with_vectors):
    """CFG with AND weights and per-step indices around a toy denoiser that
    reads the context and (with_vectors) the y rows, six DPM++ 2M steps on
    the Karras schedule; tolerance 1e-5 of the largest magnitude."""
    from sdwebui_tpu.sampling.cfg import CondSchedule as JaxSched
    from sdwebui_tpu.sampling.cfg import make_cfg_denoiser as jax_cfg
    from sdwebui_tpu.sampling.sampler import sample as jax_sample
    from sdwebui_tpu_torch.sampling import discretization as port_disc
    from sdwebui_tpu_torch.sampling.cfg import CondSchedule, make_cfg_denoiser
    from sdwebui_tpu_torch.sampling.sampler import sample
    from sdwebui_tpu_torch.sampling.schedulers import get_schedule

    rng = np.random.default_rng(12)
    b, c, h, w, s, d, dy, steps = 2, 4, 8, 8, 5, 16, 12, 6
    x0 = rng.standard_normal((b, c, h, w), dtype=np.float32)
    cond_bank = rng.standard_normal((2, 2, s, d), dtype=np.float32)
    uncond_bank = rng.standard_normal((2, s, d), dtype=np.float32)
    vec_bank = rng.standard_normal((2, 2, dy), dtype=np.float32)
    vec_uncond = rng.standard_normal((2, dy), dtype=np.float32)
    cond_idx = np.asarray([[0, 0, 1, 1, 1, 1], [0, 1, 1, 1, 1, 1]], np.int32)
    uncond_idx = np.asarray([0, 0, 0, 1, 1, 1], np.int32)
    weights = np.asarray([1.0, 0.6], np.float32)
    disc = port_disc.Discretization(port_disc.make_alphas_cumprod())
    sigmas = np.asarray(get_schedule("Karras", steps, disc), np.float32)
    proj = rng.standard_normal((d, c), dtype=np.float32) * 0.1
    yproj = rng.standard_normal((dy, c), dtype=np.float32) * 0.1

    def jax_denoise(x, sigma, ctx, y=None, c_concat=None):   # x NHWC
        shift = jnp.einsum("nsd,dc->nc", ctx, jnp.asarray(proj))
        if y is not None:
            shift = shift + y @ jnp.asarray(yproj)
        return x / (1.0 + sigma[:, None, None, None] ** 2) + shift[:, None, None, :]

    def port_denoise(x, sigma, ctx, y=None):                  # x NCHW
        shift = torch.einsum("nsd,dc->nc", ctx, torch.from_numpy(proj))
        if y is not None:
            shift = shift + y @ torch.from_numpy(yproj)
        return x / (1.0 + sigma ** 2) + shift[:, :, None, None]

    vec = dict(vector_bank=vec_bank, vector_uncond_bank=vec_uncond) if with_vectors else {}
    js = JaxSched(cond_bank=jnp.asarray(cond_bank), cond_idx=jnp.asarray(cond_idx),
                  cond_weights=jnp.asarray(weights), uncond_bank=jnp.asarray(uncond_bank),
                  uncond_idx=jnp.asarray(uncond_idx), cond_scale=6.0,
                  **{k: jnp.asarray(v) for k, v in vec.items()})
    x_j = jnp.asarray(np.transpose(x0, (0, 2, 3, 1))) * sigmas[0]
    ref = jax_sample(jax_cfg(jax_denoise, js), x_j, sigmas, solver="dpmpp_2m", mode="scan")
    ps = CondSchedule(cond_bank=torch.from_numpy(cond_bank), cond_idx=cond_idx,
                      cond_weights=weights, uncond_bank=torch.from_numpy(uncond_bank),
                      uncond_idx=uncond_idx, cond_scale=6.0,
                      **{k: torch.from_numpy(v) for k, v in vec.items()})
    out = sample(make_cfg_denoiser(port_denoise, ps), torch.from_numpy(x0) * float(sigmas[0]),
                 sigmas, "dpmpp_2m", torch.zeros(steps, 0, b, c, h, w))
    _assert_rel(out.numpy(), np.transpose(np.asarray(ref), (0, 3, 1, 2)), 1e-5)


def test_refiner_split_idx_matches_jax(models):
    jb, _, pb, _ = models
    from sdwebui_tpu_torch.sampling.registry import build_sigmas, get_sampler

    sigmas = build_sigmas(get_sampler("DPM++ 2M"), "Karras", 20, pb.disc, is_sdxl=True)
    for switch in (0.1, 0.5, 0.8, 0.95):
        assert port_proc._refiner_split_idx(pb, sigmas, switch, 20) == \
            jax_proc._refiner_split_idx(jb, sigmas, switch, 20)


def _params(refiner: bool, **kw):
    base = dict(prompt="a (red:1.2) cat [in the snow:on a hill:0.5] AND a castle :0.7",
                negative_prompt="blurry", seed=21, steps=5, width=64, height=64,
                batch_size=2, cfg_scale=7.0, sampler_name="DPM++ 2M", scheduler="Karras",
                override_settings={"sdtpu_vae_bf16": False})
    if refiner:
        base.update(refiner_checkpoint=REFINER_TITLE, refiner_switch_at=0.8)
    base.update(kw)
    return GenerationParams(**base)


@pytest.mark.parametrize("refiner", [False, True])
def test_txt2img_sdxl_matches_jax(models, f32_policies, refiner):
    """Tiny SDXL (and base → refiner at 0.8), DPM++ 2M Karras, batch 2:
    uint8 max |Δ| <= 1 on every pixel and identical infotext strings."""
    jb, jr, pb, pr = models
    ref = jax_proc.process_txt2img(jb, _params(refiner), refiner_model=jr if refiner else None)
    out = port_proc.process_txt2img(pb, _params(refiner), refiner_model=pr if refiner else None)
    ref_imgs = [np.asarray(im) for im in ref.images[ref.index_of_first_image:]]
    out_imgs = out.images[out.index_of_first_image:]
    assert len(out_imgs) == len(ref_imgs) == 2
    for a, b in zip(out_imgs, ref_imgs):
        assert a.shape == b.shape == (64, 64, 3) and a.dtype == np.uint8
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert out.infotexts[out.index_of_first_image:] == \
        ref.infotexts[ref.index_of_first_image:]
    assert ("Refiner: " + REFINER_TITLE in out.infotexts[-1]) == refiner


def test_refiner_request_without_refiner_model_raises(models):
    with pytest.raises(ValueError, match="refiner"):
        port_proc.process_txt2img(models[2], _params(True, steps=1, batch_size=1))


@pytest.fixture(scope="module")
def sdxl_server():
    from sdwebui_tpu_torch.server.api import make_server
    from sdwebui_tpu_torch.server.app import Engine

    engine = Engine(device="cpu", tiny=True, seed=4, family="sdxl")
    server = make_server(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield engine, f"http://127.0.0.1:{server.server_address[1]}/sdapi/v1/txt2img"
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


def test_sdxl_server_serves_base_and_refiner(sdxl_server):
    """--model sdxl: the refiner is resident under its title; a request
    naming it gets a PNG whose infotext names sampler, seed and refiner."""
    from sdwebui_tpu_torch.utils.png import decode_png

    engine, url = sdxl_server
    assert engine.sd_model.kind == "sdxl"
    assert list(engine._extra_models) == [REFINER_TITLE]
    status, res = _post(url, {"prompt": "a cat", "seed": 5, "steps": 4, "width": 64,
                              "height": 64, "sampler_name": "DPM++ 2M", "scheduler": "Karras",
                              "refiner_checkpoint": REFINER_TITLE, "refiner_switch_at": 0.8})
    assert status == 200, res
    img, text = decode_png(base64.b64decode(res["images"][0]))
    assert img.shape == (64, 64, 3)
    params = text["parameters"]
    assert "Sampler: DPM++ 2M" in params and "Seed: 5" in params
    assert f"Refiner: {REFINER_TITLE}, Refiner switch at: 0.8" in params


def test_sdxl_server_unknown_refiner_answers_422(sdxl_server):
    status, res = _post(sdxl_server[1], {"steps": 1, "width": 64, "height": 64,
                                         "refiner_checkpoint": "nope", "refiner_switch_at": 0.5})
    assert status == 422 and "nope" in res["detail"]
