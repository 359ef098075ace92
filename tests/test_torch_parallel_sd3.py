"""Tensor-parallel SD3 in the port against the JAX package (CPU, f32).

JAX's ``replicate`` shards any model's ``unet_params`` over a model axis
above 1 by its rule table (``sdwebui_tpu/pipeline/sd_model.py:155``), so
GSPMD runs SD3's MMDiT with ``mlp.fc1`` split by columns, ``mlp.fc2`` by
rows and the 2×2 patch conv by output channels.  Here: the port's sharded
MMDiT against JAX's GSPMD forward at model 2 and 4 (within 1e-5 of
max|ref|), SD3 txt2img over (data, model) = (1, 2) and (2, 2) and img2img
over (1, 2) against JAX on the same mesh of its virtual CPU devices
(within 1 uint8 level, identical infotext), and the launch plan per
model shard: every shard runs every joint attention with all the heads
and every LayerNorm, and its own slice of each MLP.  Weights: JAX's
``create_tiny_sd3``, perturbed, carried across with ``from_jax``.
"""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdwebui_tpu.models import mmdit as jax_mmdit
from sdwebui_tpu.parallel import mesh as jax_mesh
from sdwebui_tpu.parallel import sharding as jax_sharding
from sdwebui_tpu.pipeline import img2img as jax_i2i
from sdwebui_tpu.pipeline import processing as jax_proc
from sdwebui_tpu.pipeline import sd_model as jax_sd
from sdwebui_tpu.pipeline.params import GenerationParams as JaxParams
from sdwebui_tpu.utils import devices as jax_devices
from sdwebui_tpu_torch.models import mmdit
from sdwebui_tpu_torch.parallel import collectives, mesh
from sdwebui_tpu_torch.parallel.sharding import TensorParallelUNet, gather_state_dict, shard_params
from sdwebui_tpu_torch.pipeline import img2img as port_i2i
from sdwebui_tpu_torch.pipeline import processing as port_proc
from sdwebui_tpu_torch.pipeline import sd_model as port_sd
from sdwebui_tpu_torch.pipeline.params import GenerationParams
from sdwebui_tpu_torch.utils import devices as port_devices
from test_torch_img2img import _init_image
from test_torch_models import _perturbed

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(71)
    jm = jax_sd.create_tiny_sd3(4)
    jm = dataclasses.replace(jm, unet_params=_perturbed(jm.unet_params, rng),
                             vae_params=_perturbed(jm.vae_params, rng))
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


@pytest.fixture(autouse=True)
def _runtimes():
    jax_old = jax_mesh.get_runtime()
    yield
    jax_mesh.set_runtime(jax_old)
    mesh.set_runtime(None)


def _inputs(cfg, seed=0, ctx_len=77):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 16, 16, 16)).astype(np.float32)
    t = np.array([981.0, 137.5], np.float32)
    ctx = rng.standard_normal((2, ctx_len, cfg.context_dim)).astype(np.float32)
    y = rng.standard_normal((2, cfg.pooled_dim)).astype(np.float32)
    return x, t, ctx, y


@pytest.mark.parametrize("m", [2, 4])
def test_tensor_parallel_mmdit_matches_jax_gspmd(models, m):
    """The model-sharded MMDiT against JAX's GSPMD forward over the same
    rule table, within 1e-5 of max|ref|, and against the port's one-device
    forward; the shards store only their slices and gather back whole."""
    jm, pm = models
    x, t, ctx, y = _inputs(jm.unet_cfg, seed=m)
    jrt = jax_mesh.MeshRuntime.create(data=1, model=m, devices=jax.devices()[:m])
    sharded = jax_sharding.shard_params(jrt, jm.unet_params)
    with jrt.mesh:
        ref = np.asarray(jax.jit(lambda p, a, b, c, d: jax_mmdit.apply(
            p, jm.unet_cfg, a, b, c, d))(sharded, jnp.asarray(x.transpose(0, 2, 3, 1)),
                                         jnp.asarray(t), jnp.asarray(ctx), jnp.asarray(y)))
    unet = pm.unet
    shards = shard_params(unet, [CPU] * m)
    hidden = unet.cfg.hidden
    assert shards[1].joint_blocks[0].x_block.mlp.fc1.weight.shape == (4 * hidden // m, hidden)
    assert shards[1].joint_blocks[0].x_block.mlp.fc2.weight.shape == (hidden, 4 * hidden // m)
    assert shards[1].x_embedder.proj.weight.shape[0] == hidden // m
    assert shards[1].joint_blocks[0].x_block.attn.qkv.weight.shape == (3 * hidden, hidden)
    tp = TensorParallelUNet(shards, [CPU] * m)
    args = [torch.from_numpy(a) for a in (x, t, ctx, y)]
    with torch.no_grad():
        got = tp(*args).numpy()
        plain = unet(*args).numpy()
    scale = np.abs(ref).max()
    assert np.abs(got.transpose(0, 2, 3, 1) - ref).max() <= 1e-5 * scale
    assert np.abs(got - plain).max() <= 1e-5 * np.abs(plain).max()
    whole = unet.state_dict()
    assert all(torch.equal(v, whole[k]) for k, v in gather_state_dict(shards).items())


def _meshes(data, model):
    n = data * model
    return (jax_mesh.MeshRuntime.create(data=data, model=model, devices=jax.devices()[:n]),
            mesh.MeshRuntime.create(data=data, model=model, devices=[CPU] * n))


def _params(cls, **kw):
    base = dict(prompt="a (red:1.2) cat", negative_prompt="blurry", seed=23, steps=3,
                width=64, height=64, batch_size=1, cfg_scale=5.0, sampler_name="Euler",
                override_settings={"sdtpu_vae_bf16": False})
    base.update(kw)
    return cls(**base)


def _samples(res):
    return [np.asarray(im) for im in res.images[res.index_of_first_image:]]


def _assert_within(out, ref, levels):
    a, b = _samples(out), _samples(ref)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.shape == y.shape and np.abs(x.astype(int) - y.astype(int)).max() <= levels
    assert out.infotexts[out.index_of_first_image:] == ref.infotexts[ref.index_of_first_image:]


def _runs(models, data, model, run):
    """run(bundle, params class) under JAX's mesh, the port's mesh and the
    port's one device."""
    jm, pm = models
    jrt, prt = _meshes(data, model)
    jax_mesh.set_runtime(jrt)
    ref = run(jm.replicate(jrt), JaxParams)
    rep = pm.replicate(prt)
    assert rep.runtime is prt
    assert all(isinstance(s.unet, TensorParallelUNet)
               for s in port_sd.shard_bundles(rep, prt, data))
    out = run(rep, GenerationParams)
    jax_mesh.set_runtime(jax_mesh.MeshRuntime.create(data=1, model=1,
                                                     devices=jax.devices()[:1]))
    mesh.set_runtime(None)
    return ref, out, run(pm, GenerationParams)


@pytest.mark.parametrize("data,model", [(1, 2), (2, 2)])
def test_sd3_txt2img_on_a_model_axis_matches_jax(models, f32_policies, data, model):
    ref, out, single = _runs(models, data, model, lambda m, cls: (
        jax_proc if cls is JaxParams else port_proc).process_txt2img(
            m, _params(cls, batch_size=data)))
    _assert_within(out, ref, 1)
    _assert_within(out, single, 1)


def test_sd3_img2img_on_a_model_axis_matches_jax(models, f32_policies):
    def run(m, cls):
        p = _params(cls, seed=31, denoising_strength=0.6, init_images=[_init_image(seed=41)])
        return (jax_i2i if cls is JaxParams else port_i2i).process_img2img(m, p)

    ref, out, single = _runs(models, 1, 2, run)
    _assert_within(out, ref, 1)
    _assert_within(out, single, 1)


@pytest.mark.parametrize("m", [2, 4])
def test_sd3_launch_plan_per_model_shard(models, monkeypatch, m):
    """One sharded MMDiT forward: each model shard runs every joint
    attention at (B, S, 24·64)'s tiny counterpart, all the heads (JAX splits
    none), ``mmdit.layer_norm_calls`` LayerNorms and each MLP at its slice
    of the hidden features; nothing runs outside a shard."""
    _, pm = models
    unet = pm.unet
    cfg = unet.cfg
    seen = {"attention": [], "layer_norm": [], "fc1": []}
    lock = threading.Lock()

    def shard():
        return collectives.axis_index("model") if "model" in collectives.axes() else None

    def spy(name, fn):
        def wrapped(x, *a, **kw):
            with lock:
                seen[name].append((shard(), tuple(x.shape), kw.get("num_heads", a[2] if
                                                                    len(a) > 2 else None)))
            return fn(x, *a, **kw)
        return wrapped

    monkeypatch.setattr(mmdit, "attention", spy("attention", mmdit.attention))
    monkeypatch.setattr(mmdit, "layer_norm", spy("layer_norm", mmdit.layer_norm))
    lin = mmdit.linear
    tp = TensorParallelUNet(shard_params(unet, [CPU] * m), [CPU] * m)
    fc1 = {id(mod.fc1.weight) for s in tp.shards for mod in s.modules()
           if isinstance(mod, mmdit.MLP)}

    def spy_linear(x, w, b=None):
        if id(w) in fc1:
            with lock:
                seen["fc1"].append((shard(), tuple(w.shape)))
        return lin(x, w, b)

    monkeypatch.setattr(mmdit, "linear", spy_linear)
    x, t, ctx, y = (torch.from_numpy(a) for a in _inputs(cfg, seed=5))
    with torch.no_grad():
        tp(x, t, ctx, y)
    tokens = (16 // cfg.patch_size) ** 2 + 77
    calls = mmdit.self_attention_calls(cfg, 16, 77)
    for r in range(m):
        att = [s for who, s, _ in seen["attention"] if who == r]
        assert len(att) == len(calls) == cfg.depth
        assert all(s == (2, tokens, cfg.hidden) for s in att)
        assert sum(who == r for who, _, _ in seen["layer_norm"]) == mmdit.layer_norm_calls(cfg)
        n_mlp = sum(not b.x_block.pre_only for b in unet.joint_blocks) \
            + sum(not b.context_block.pre_only for b in unet.joint_blocks)
        assert [s for who, s in seen["fc1"] if who == r] == [(4 * cfg.hidden // m,
                                                              cfg.hidden)] * n_mlp
    assert all(who is not None for k in seen for who, *_ in seen[k])
