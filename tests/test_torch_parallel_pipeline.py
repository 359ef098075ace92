"""Sharded generation end to end: the port's ``process_txt2img`` /
``process_img2img`` over (data, model) meshes that name the CPU n times,
each against the JAX package's run on the same mesh of its virtual CPU
devices and against the port's one-device run (tiny model, 64², 2 steps,
the pairs of ``tests/test_data_parallel.py`` and ``__graft_entry__.py``).

Bounds: the port's sharded run within 2 uint8 levels of its one-device run
at the default (bf16) policy and within 1 level under the f32 policy;
against JAX within 1 level under the f32 policy, with identical infotext.
"""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
from torch_jax_state import jax_vae_file_reset  # noqa: F401  (JAX's loaded-VAE global)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdwebui_tpu.networks import extra_networks as jax_en
from sdwebui_tpu.parallel import mesh as jax_mesh
from sdwebui_tpu.pipeline import control as jax_control
from sdwebui_tpu.pipeline import img2img as jax_i2i
from sdwebui_tpu.pipeline import processing as jax_proc
from sdwebui_tpu.pipeline import sd_model as jax_sd
from sdwebui_tpu.pipeline.params import GenerationParams as JaxParams
from sdwebui_tpu.utils import devices as jax_devices
from sdwebui_tpu_torch.loader.safetensors_io import write_safetensors
from sdwebui_tpu_torch.networks import extra_networks as port_en
from sdwebui_tpu_torch.parallel import mesh
from sdwebui_tpu_torch.pipeline import control as port_control
from sdwebui_tpu_torch.pipeline import img2img as port_i2i
from sdwebui_tpu_torch.pipeline import processing as port_proc
from sdwebui_tpu_torch.pipeline import sd_model as port_sd
from sdwebui_tpu_torch.pipeline.params import GenerationParams
from sdwebui_tpu_torch.utils import devices as port_devices
from test_torch_controlnet import TINY as CN_TINY, _tower_params
from test_torch_img2img import _init_image, _rect_mask
from test_torch_models import _perturbed
from test_torch_networks import _lora_file

CPU = torch.device("cpu")
#: the f32 comparisons decode in f32 too (no bf16 first decode)
F32 = dict(override_settings={"sdtpu_vae_bf16": False})


@pytest.fixture(scope="module")
def models():
    jm = jax_sd.create_tiny_sd(5)
    rng = np.random.default_rng(60)
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


@pytest.fixture(autouse=True)
def _runtimes():
    jax_old = jax_mesh.get_runtime()
    # JAX's cond cache keys on id(model): a replicated bundle may take the id
    # of a freed one and get back conds placed on that one's mesh
    jax_proc._COND_CACHE.clear()
    yield
    jax_mesh.set_runtime(jax_old)
    mesh.set_runtime(None)


def _meshes(data, model):
    n = data * model
    return (jax_mesh.MeshRuntime.create(data=data, model=model, devices=jax.devices()[:n]),
            mesh.MeshRuntime.create(data=data, model=model, devices=[CPU] * n))


def _one_device():
    jax_mesh.set_runtime(jax_mesh.MeshRuntime.create(data=1, model=1,
                                                     devices=jax.devices()[:1]))
    mesh.set_runtime(None)


def _samples(res):
    return [np.asarray(im) for im in res.images[res.index_of_first_image:]]


def _assert_within(out, ref, levels, infotext=True):
    a, b = _samples(out), _samples(ref)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.shape == y.shape and np.abs(x.astype(int) - y.astype(int)).max() <= levels
    if infotext:
        assert out.infotexts[out.index_of_first_image:] == \
            ref.infotexts[ref.index_of_first_image:]


def _params(cls=GenerationParams, **kw):
    base = dict(prompt="a cat", negative_prompt="blurry", seed=7, steps=2, width=64,
                height=64, batch_size=4, cfg_scale=7.5)
    base.update(kw)
    return cls(**base)


def _runs(models, data, model, run):
    """run(model bundle, params class) under the JAX mesh, the port's mesh
    and the port's one device: (jax, port mesh, port one device)."""
    jm, pm = models
    jrt, prt = _meshes(data, model)
    jax_mesh.set_runtime(jrt)
    ref = run(jm.replicate(jrt), JaxParams)
    rep = pm.replicate(prt)
    assert rep.runtime is prt
    out = run(rep, GenerationParams)
    _one_device()
    return ref, out, run(pm, GenerationParams)


def test_data_parallel_txt2img_default_policy(models, monkeypatch):
    """data=4, batch 4 (tests/test_data_parallel.py:26-42): within 2 levels of
    the one-device run, the shards' UNet calls on their own threads."""
    _, pm = models
    calls = []
    unet_call = type(pm.unet).__call__

    def spy(self, x, *a, **kw):
        calls.append(x.shape[0])
        return unet_call(self, x, *a, **kw)

    monkeypatch.setattr(type(pm.unet), "__call__", spy)
    mesh.set_runtime(mesh.MeshRuntime.create(data=4, devices=[CPU] * 4))
    out = port_proc.process_txt2img(pm, _params())
    sharded = list(calls)
    calls.clear()
    mesh.set_runtime(None)
    single = port_proc.process_txt2img(pm, _params())
    assert sharded == [2] * 8 and calls == [8] * 2       # CFG rows of one image per shard
    _assert_within(out, single, 2)


def test_data_parallel_txt2img_matches_jax(models, f32_policies):
    ref, out, single = _runs(models, 4, 1, lambda m, cls: (
        jax_proc if cls is JaxParams else port_proc).process_txt2img(m, _params(cls, **F32)))
    _assert_within(out, ref, 1)
    _assert_within(out, single, 1)


def test_data_parallel_img2img_with_mask_matches_jax(models, f32_policies):
    """data=2 inpaint: the mask, the init latent and the masked blend split
    along the batch (__graft_entry__.py:153-160)."""
    def run(m, cls):
        p = _params(cls, batch_size=2, seed=11, denoising_strength=0.7,
                    init_images=[_init_image()], mask=_rect_mask(), mask_blur=2,
                    inpainting_fill=1, **F32)
        return (jax_i2i if cls is JaxParams else port_i2i).process_img2img(m, p)

    ref, out, single = _runs(models, 2, 1, run)
    _assert_within(out, ref, 1)
    _assert_within(out, single, 1)


@pytest.fixture
def lora_and_tower(tmp_path, monkeypatch):
    """A LoRA over the UNet's attention projections and a ControlNet tower
    whose input zero-convs are zero (the injection both packages share:
    test_torch_controlnet), registered in both packages."""
    rng = np.random.default_rng(13)
    attn = {f"{b}.1.transformer_blocks.0.{a}.{p}": (c, c)
            for b, c in (("input_blocks.1", 32), ("output_blocks.1", 64))
            for a in ("attn1", "attn2") for p in ("to_q", "to_out.0")}
    _lora_file(str(tmp_path / "dry.safetensors"), attn, {}, rng)
    sd = port_sd.state_dict_from_tree(_tower_params(CN_TINY, 9, zero_input_convs=True,
                                                    out_scale=0.1))
    write_safetensors(str(tmp_path / "midonly.safetensors"),
                      {"control_model." + k: v for k, v in sd.items()})
    monkeypatch.setattr(jax_en, "_default_registry", jax_en.LoraRegistry([str(tmp_path)]))
    jax_en._merge_cache.clear()
    port_en.set_lora_dirs([str(tmp_path)])
    jax_control.set_model_dirs([str(tmp_path)])
    port_control.set_model_dirs([str(tmp_path)])
    yield
    port_en.set_lora_dirs(port_en.DEFAULT_LORA_DIRS)
    jax_control.set_model_dirs(["models/ControlNet"])
    port_control.set_model_dirs([port_control.DEFAULT_CONTROLNET_DIR])
    jax_en._merge_cache.clear()


def test_data_parallel_lora_and_controlnet_match_jax(models, f32_policies, lora_and_tower):
    """data=2 with a LoRA tag and a ControlNet unit (__graft_entry__.py:162-215):
    the merged UNet is replicated, the tower and hint reach each shard."""
    hint = np.kron(np.random.default_rng(4).integers(0, 256, (8, 8, 3)).astype(np.uint8),
                   np.ones((8, 8, 1), np.uint8))

    def run(m, cls):
        p = _params(cls, batch_size=2, seed=13, prompt="a cat <lora:dry:0.7>",
                    sampler_name="Euler", **F32,
                    controlnet_units=[{"model": "midonly", "image": hint, "module": "none",
                                       "weight": 1.5}])
        return (jax_proc if cls is JaxParams else port_proc).process_txt2img(m, p)

    ref, out, single = _runs(models, 2, 1, run)
    _assert_within(out, ref, 1)
    _assert_within(out, single, 1)
    plain = port_proc.process_txt2img(models[1], _params(batch_size=2, seed=13))
    assert not np.array_equal(_samples(out)[0], _samples(plain)[0])


@pytest.mark.parametrize("data,model", [(1, 2), (2, 2)])
def test_tensor_parallel_txt2img_matches_jax(models, f32_policies, data, model):
    """model=2 (batch 1) and data=2 × model=2 (batch 2) under the f32
    policy (test_data_parallel.py:73-166): within 1 level of JAX's run on
    the same mesh and of the port's one-device run."""
    ref, out, single = _runs(models, data, model, lambda m, cls: (
        jax_proc if cls is JaxParams else port_proc).process_txt2img(
            m, _params(cls, batch_size=data, seed=21 + data, **F32)))
    _assert_within(out, ref, 1)
    _assert_within(out, single, 1)


def test_indivisible_batch_runs_unsharded(models, monkeypatch):
    """batch 3 on data=4 (test_data_parallel.py:45-50): no shard group runs."""
    _, pm = models
    rep = pm.replicate(mesh.MeshRuntime.create(data=4, devices=[CPU] * 4))
    monkeypatch.setattr(port_proc, "data_group", lambda rt: pytest.fail("sharded"))
    res = port_proc.process_txt2img(rep, _params(batch_size=3))
    assert len(_samples(res)) == 3
    monkeypatch.undo()
    single = port_proc.process_txt2img(pm, _params(batch_size=3))
    _assert_within(res, single, 0)


def test_replicate_leaves_the_source_untouched(models):
    """test_data_parallel.py:133-144: the replica's conditioners are its
    own objects; the source's modules, devices and runtime are as they were."""
    _, pm = models
    before = (pm.conditioner, pm.conditioner.model, pm.unet, pm.vae, pm.runtime)
    weights = {k: v.clone() for k, v in pm.unet.state_dict().items()}
    rt = mesh.MeshRuntime.create(data=2, model=2, devices=[CPU] * 4)
    rep = pm.replicate(rt)
    assert (pm.conditioner, pm.conditioner.model, pm.unet, pm.vae, pm.runtime) == before
    assert rep.conditioner is not pm.conditioner and rep.runtime is rt
    assert all(torch.equal(v, weights[k]) for k, v in pm.unet.state_dict().items())
    shards = port_sd.shard_bundles(rep, rt, 2)
    assert [s.unet.group.devices for s in shards] == [(CPU, CPU)] * 2
    one = mesh.MeshRuntime.create(data=1, devices=[CPU])
    assert pm.replicate(one) is pm


def test_tensor_parallel_sd3_raises():
    """SD3 runs over a model axis > 1 as JAX's GSPMD runs it (the MMDiT's
    MLPs and patch conv split, ``tests/test_torch_parallel_sd3.py`` holds
    it to JAX): replicate gives each data shard a tensor-parallel MMDiT and
    a request runs to its images.  What raises is a module the rule table
    has no collectives for: the VAE under shard_params, NotImplementedError
    naming it (nothing falls back to one device)."""
    from sdwebui_tpu_torch.parallel.sharding import TensorParallelUNet, shard_params

    sd3 = port_sd.create_tiny_sd3(0, device="cpu")
    rt = mesh.MeshRuntime.create(data=1, model=2, devices=[CPU] * 2)
    rep = sd3.replicate(rt)
    (shard,) = port_sd.shard_bundles(rep, rt, 1)
    assert isinstance(shard.unet, TensorParallelUNet) and len(shard.unet.shards) == 2
    mesh.set_runtime(rt)
    res = port_proc.process_txt2img(sd3, _params(sampler_name="Euler", batch_size=1))
    assert len(_samples(res)) == 1 and _samples(res)[0].shape == (64, 64, 3)
    with pytest.raises(NotImplementedError, match="tensor-parallel AutoencoderKL"):
        shard_params(sd3.vae, [CPU] * 2)
