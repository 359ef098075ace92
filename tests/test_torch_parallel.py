"""The parallel runtime against the JAX package's: the mesh, the sharding
rule table (the tiny UNet and the SD1.5 / SDXL key manifests), ring
attention, the row-sharded VAE, the tensor-parallel UNet forward and the
(data, model) training step.  JAX runs on its 8 virtual CPU devices
(``tests/conftest.py``), the port on meshes that name the CPU n times."""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdwebui_tpu.models import vae as jax_vae
from sdwebui_tpu.models.configs import UNetConfig, VAEConfig
from sdwebui_tpu.parallel import mesh as jax_mesh
from sdwebui_tpu.parallel import sharding as jax_sharding
from sdwebui_tpu.parallel.sequence import ring_attention as jax_ring, seq_mesh as jax_seq_mesh
from sdwebui_tpu.parallel.spatial import decode_spatial as jax_decode_spatial
from sdwebui_tpu.parallel.spatial import encode_spatial as jax_encode_spatial
from sdwebui_tpu.pipeline import sd_model as jax_sd
from sdwebui_tpu.utils.pytree import flatten
from sdwebui_tpu_torch.models.unet import UNetModel
from sdwebui_tpu_torch.models.vae import AutoencoderKL
from sdwebui_tpu_torch.parallel import collectives
from sdwebui_tpu_torch.parallel import mesh
from sdwebui_tpu_torch.parallel.sequence import ring_attention, seq_mesh
from sdwebui_tpu_torch.parallel.sharding import (TensorParallelUNet, gather_state_dict,
                                                 param_shardings, shard_params, split_dim)
from sdwebui_tpu_torch.parallel.spatial import decode_spatial, encode_spatial
from sdwebui_tpu_torch.pipeline import sd_model as port_sd
from sdwebui_tpu_torch.training import train_step as port_train
from test_key_manifests import load_manifest
from test_torch_models import _perturbed

CPU = torch.device("cpu")


def cpus(n):
    return [CPU] * n


@pytest.fixture(autouse=True)
def _no_runtime_left():
    yield
    mesh.set_runtime(None)


# --------------------------------------------------------------------------
# the mesh
# --------------------------------------------------------------------------

def test_mesh_shapes_and_pad_batch():
    rt = mesh.MeshRuntime.create(data=4, model=2, devices=cpus(8))
    assert (rt.data_size, rt.model_size, rt.n_devices) == (4, 2, 8)
    assert rt.grid[1] == (CPU, CPU) and rt.data_devices == (CPU,) * 4
    assert [rt.pad_batch(n) for n in (1, 4, 5)] == [4, 4, 8]
    ref = jax_mesh.MeshRuntime.create(data=4, model=2, devices=jax.devices()[:8])
    assert [ref.pad_batch(n) for n in (1, 4, 5)] == [rt.pad_batch(n) for n in (1, 4, 5)]
    assert mesh.MeshRuntime.create(model=2, devices=cpus(6)).data_size == 3
    x = torch.arange(24.0).reshape(8, 3)
    parts = rt.shard_batch(x)
    assert [p.shape[0] for p in parts] == [2] * 4
    assert torch.equal(torch.cat(parts), x)
    assert all(p.data_ptr() != x.data_ptr() for p in parts)     # copies
    copies = rt.replicate(x)
    assert len(copies) == 4 and all(torch.equal(c, x) and c.data_ptr() != x.data_ptr()
                                    for c in copies)


def test_replica_cache():
    """on_device: the object itself on its own device, else one copy per
    device while the source lives; set_runtime and drop_replicas forget it."""
    import gc
    import weakref

    lin = torch.nn.Linear(3, 2)
    assert mesh.on_device(lin, CPU) is lin
    meta = mesh.on_device(lin, "meta")
    assert meta is not lin and meta.weight.is_meta and mesh.on_device(lin, "meta") is meta
    mesh.drop_replicas(lin)
    again = mesh.on_device(lin, "meta")
    assert again is not meta
    mesh.set_runtime(None)
    assert mesh.on_device(lin, "meta") is not again
    gone = weakref.ref(mesh.on_device(lin, "meta"))
    del lin, meta, again
    gc.collect()
    assert gone() is None           # the copy goes with its source
    tree = {"w": [torch.ones(2)]}
    assert mesh.on_device(tree, "meta")["w"][0].is_meta


def test_mesh_bad_model_axis():
    with pytest.raises(ValueError):
        mesh.MeshRuntime.create(model=3, devices=cpus(8))
    with pytest.raises(ValueError):
        jax_mesh.MeshRuntime.create(model=3)


@pytest.mark.skipif(torch.cuda.is_available(), reason="the default takes the visible cards")
def test_mesh_default_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA card"):
        mesh.MeshRuntime.create()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        mesh.get_runtime()
    # a CPU model runs unsharded unless a runtime was set
    assert mesh.runtime_for(CPU) is None


def test_runtime_device_type_must_match_the_model():
    mesh.set_runtime(mesh.MeshRuntime.create(data=2, devices=cpus(2)))
    with pytest.raises(ValueError, match="runtime's devices are 'cpu'"):
        mesh.runtime_for(torch.device("cuda", 0))
    cuda_rt = mesh.MeshRuntime.create(data=2, devices=["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="runtime's devices are 'cuda'"):
        mesh.runtime_for(CPU, cuda_rt)
    model = port_sd.create_tiny_sd(0, "cpu")
    with pytest.raises(ValueError, match="runtime's devices are 'cuda'"):
        model.replicate(cuda_rt)
    assert mesh.runtime_for(CPU).data_size == 2
    mesh.set_runtime(mesh.MeshRuntime.create(data=1, devices=cpus(1)))
    assert mesh.runtime_for(CPU) is None


# --------------------------------------------------------------------------
# collectives
# --------------------------------------------------------------------------

def test_collectives_values_and_no_aliasing():
    g = collectives.Group("x", cpus(4))

    def body(r):
        x = torch.full((2, 3), float(r + 1))
        s = collectives.psum(x, "x")
        a = collectives.all_gather(x, "x", dim=0)
        p = collectives.ppermute(x, "x", [(j, (j + 1) % 4) for j in range(4)])
        s.add_(100 * r)        # an in-place op on one shard's result
        a.mul_(r + 1)
        return s, a, p, collectives.axis_size("x"), collectives.axis_index("x")

    out = g.run(body)
    for r, (s, a, p, n, i) in enumerate(out):
        assert (n, i) == (4, r)
        assert torch.equal(s, torch.full((2, 3), 10.0 + 100 * r))
        assert torch.equal(a, torch.arange(1.0, 5.0).repeat_interleave(2)[:, None].expand(8, 3)
                           * (r + 1))
        assert torch.equal(p, torch.full((2, 3), float((r - 1) % 4 + 1)))


def test_shards_of_one_device_map_in_the_calling_thread():
    """Group.map: collective-free shards on one device run one after
    another on the caller's thread; Group.run gives each its own thread."""
    import threading

    g = collectives.Group("x", cpus(3))
    me = threading.get_ident()
    assert g.map(lambda r: (threading.get_ident(), collectives.axis_index("x"))) == \
        [(me, 0), (me, 1), (me, 2)]
    out = g.run(lambda r: (threading.get_ident(), collectives.psum(torch.ones(1), "x").item()))
    assert out[0][0] == me and len({i for i, _ in out}) == 3 and {v for _, v in out} == {3.0}
    with pytest.raises(ValueError, match="shard 1"):
        g.map(lambda r: (_ for _ in ()).throw(ValueError(f"shard {r}")) if r else r)
    assert g.run(lambda r: collectives.psum(torch.ones(1), "x").item()) == [3.0] * 3


def test_a_failing_shard_fails_the_run():
    g = collectives.Group("x", cpus(3))

    def body(r):
        if r == 2:
            raise ValueError("shard 2 failed")
        return collectives.psum(torch.ones(1), "x")

    with pytest.raises(ValueError, match="shard 2 failed"):
        g.run(body)
    assert [t.item() for t in g.run(lambda r: collectives.psum(torch.ones(1), "x"))] == [3.0] * 3


# --------------------------------------------------------------------------
# the rule table
# --------------------------------------------------------------------------

def _jax_dim(spec, ndim):
    """JAX's PartitionSpec of an (I, O) / HWIO weight as the split dim of
    the torch (O, I) / OIHW weight."""
    spec = tuple(spec)
    if "model" not in spec:
        return None
    d = spec.index("model")
    return {2: {1: 0, 0: 1}, 4: {3: 0}}[ndim][d]


def _jax_shape(shape):
    if len(shape) == 2:
        return (shape[1], shape[0])
    if len(shape) == 4:
        return (shape[2], shape[3], shape[1], shape[0])
    return tuple(shape)


@pytest.mark.parametrize("name", ["tiny", "sd15", "sdxl_base"])
@pytest.mark.parametrize("m", [2, 4, 8])
def test_rule_table_equals_jax(name, m):
    if name == "tiny":
        jm = jax_sd.create_tiny_sd(0)
        flat = flatten(jm.unet_params)
        port = port_sd.from_jax(jm).unet.state_dict()
        assert set(flat) == set(port)
        shapes = {k: tuple(v.shape) for k, v in port.items()}
        jax_shapes = {k: tuple(np.shape(v)) for k, v in flat.items()}
    else:
        shapes = {k: tuple(v) for k, v in load_manifest(name).items()}
        jax_shapes = {k: _jax_shape(v) for k, v in shapes.items()}
    rt = mesh.MeshRuntime.create(model=m, devices=cpus(m))
    dims = param_shardings(rt, {k: torch.empty(s, device="meta") for k, s in shapes.items()})
    n_split = 0
    for k, shape in shapes.items():
        want = _jax_dim(jax_sharding._spec_for(k, jax_shapes[k], m), len(shape))
        assert dims[k] == split_dim(k, shape, m) == want, k
        n_split += want is not None
    assert n_split > 0


# --------------------------------------------------------------------------
# ring attention
# --------------------------------------------------------------------------

def _plain_attention(q, k, v, scale):
    s = (q @ np.swapaxes(k, -1, -2)) * scale
    p = np.exp(s - s.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)) @ v


@pytest.mark.parametrize("ring", [1, 2, 4])
def test_ring_attention_matches_jax_and_plain(ring):
    rng = np.random.default_rng(ring)
    q, k, v = (rng.standard_normal((2, 3, 32, 8)).astype(np.float32) for _ in range(3))
    scale = 8 ** -0.5
    got = ring_attention(*(torch.from_numpy(t) for t in (q, k, v)), seq_mesh(ring, cpus(ring)),
                         scale).numpy()
    ref = np.asarray(jax_ring(*(jnp.asarray(t) for t in (q, k, v)), jax_seq_mesh(ring), scale))
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(got, _plain_attention(q, k, v, scale), atol=2e-5, rtol=1e-4)


def test_ring_attention_over_a_runtime_and_bf16():
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((1, 2, 16, 4)).astype(np.float32))
    rt = mesh.MeshRuntime.create(data=4, devices=cpus(4))
    np.testing.assert_allclose(ring_attention(q, q, q, rt).numpy(),
                               _plain_attention(*[q.numpy()] * 3, 0.5), atol=2e-5, rtol=1e-4)
    out = ring_attention(q.bfloat16(), q.bfloat16(), q.bfloat16(), seq_mesh(2, cpus(2)))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), _plain_attention(*[q.numpy()] * 3, 0.5),
                               atol=3e-2)


# --------------------------------------------------------------------------
# the row-sharded VAE
# --------------------------------------------------------------------------

VAE_CFG = VAEConfig(ch=32, ch_mult=(1, 2, 2, 2), num_res_blocks=1)


@pytest.fixture(scope="module")
def vaes():
    params = _perturbed(jax_vae.init_params(VAE_CFG, 0), np.random.default_rng(3))
    vae = AutoencoderKL(VAE_CFG, device="cpu", dtype=torch.float32)
    vae.load_state_dict(port_sd.state_dict_from_tree(params), strict=True)
    return params, vae


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("n", [4, 8])
def test_decode_spatial_matches_jax_and_unsharded(vaes, n):
    params, vae = vaes
    z = (np.random.RandomState(0).randn(1, 32, 24, 4) * 0.7).astype(np.float32)
    ref = np.asarray(jax_decode_spatial(params, VAE_CFG, jnp.asarray(z),
                                        jax_mesh.MeshRuntime.create(
                                            data=n, devices=jax.devices()[:n])))
    with torch.no_grad():
        got = _nhwc(decode_spatial(vae, _nchw(z), mesh.MeshRuntime.create(data=n,
                                                                          devices=cpus(n))))
        plain = _nhwc(vae.decode(_nchw(z)))
    assert got.shape == ref.shape == (1, 256, 192, 3)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, plain, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("n", [4, 8])
def test_encode_spatial_matches_jax_and_unsharded(vaes, n):
    params, vae = vaes
    x = (np.random.RandomState(1).rand(1, 128, 64, 3) * 2 - 1).astype(np.float32)
    ref = np.asarray(jax_encode_spatial(params, VAE_CFG, jnp.asarray(x),
                                        jax_mesh.MeshRuntime.create(
                                            data=n, devices=jax.devices()[:n])))
    with torch.no_grad():
        got = _nhwc(encode_spatial(vae, _nchw(x), mesh.MeshRuntime.create(data=n,
                                                                          devices=cpus(n))))
        plain = _nhwc(vae.encode_moments(_nchw(x)))
    assert got.shape == ref.shape == (1, 16, 8, 8)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, plain, rtol=2e-4, atol=2e-4)


def test_spatial_fallbacks(vaes, monkeypatch):
    _, vae = vaes
    calls = []
    monkeypatch.setattr(collectives, "halo_rows",
                        lambda *a: calls.append(1) or (_ for _ in ()).throw(AssertionError))
    z = torch.from_numpy(np.random.RandomState(0).randn(1, 4, 9, 8).astype(np.float32))
    with torch.no_grad():
        ref = vae.decode(z)
        one = mesh.MeshRuntime.create(data=1, devices=cpus(1))
        assert torch.equal(decode_spatial(vae, z, one), ref)
        four = mesh.MeshRuntime.create(data=4, devices=cpus(4))
        assert torch.equal(decode_spatial(vae, z, four), ref)            # 9 rows
        z8 = z[:, :, :8]
        assert torch.equal(decode_spatial(vae, z8, four, tiling=True),   # a wrap is global
                           vae.decode(z8, tiling=True))
        x = torch.rand(1, 3, 40, 16) * 2 - 1                             # 40 % 32
        assert torch.equal(encode_spatial(vae, x, four), vae.encode_moments(x))
    assert not calls


def test_pipeline_routes_a_large_decode_spatially(monkeypatch):
    from sdwebui_tpu_torch.pipeline import processing
    from sdwebui_tpu_torch.utils import devices as port_devices

    model = port_sd.create_tiny_sd(0, "cpu")
    mesh.set_runtime(mesh.MeshRuntime.create(data=8, devices=cpus(8)))
    calls = []
    orig = processing.decode_spatial
    monkeypatch.setattr(processing, "decode_spatial",
                        lambda *a, **kw: calls.append(a[1].shape) or orig(*a, **kw))
    z = torch.from_numpy(np.random.RandomState(0).randn(1, 4, 128, 128).astype(
        np.float32) * 0.5)
    u8 = processing.decode_first_stage_u8(model, z)
    assert u8.shape == (1, 1024, 1024, 3) and u8.dtype == np.uint8
    assert calls == [(1, 4, 128, 128)]
    mesh.set_runtime(None)
    with torch.no_grad():
        ref = processing.to_u8(torch.clamp(model.vae.decode(z) / 2 + 0.5, 0, 1))
    assert np.abs(u8.astype(int) - ref.astype(int)).max() <= 1
    # a small latent and a batch the data axis splits take the usual decode
    mesh.set_runtime(mesh.MeshRuntime.create(data=2, devices=cpus(2)))
    assert processing._spatial_decode_if_beneficial(model, z[:, :, :64, :64]) is None
    assert processing._spatial_decode_if_beneficial(model, z.repeat(2, 1, 1, 1)) is None
    assert port_devices.get_policy().vae_dtype == torch.float32


# --------------------------------------------------------------------------
# the tensor-parallel UNet
# --------------------------------------------------------------------------

def _unet_inputs(cfg, b=2, hw=8, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, cfg.in_channels, hw, hw)).astype(np.float32))
    t = torch.tensor([500.0, 20.0][:b])
    ctx = torch.from_numpy(rng.standard_normal((b, 77, cfg.context_dim)).astype(np.float32))
    return x, t, ctx


@pytest.mark.parametrize("m", [2, 4])
def test_tensor_parallel_unet_matches_jax_and_unsharded(m):
    """The model-sharded forward against JAX's GSPMD-sharded apply (the
    ``test_tensor_parallel_matches_single_device`` comparison) and the
    port's one-device forward; shards store only their slices."""
    from sdwebui_tpu.models import unet as jax_unet

    jm = jax_sd.create_tiny_sd(0)
    jm = dataclasses.replace(jm, unet_params=_perturbed(jm.unet_params, np.random.default_rng(1)))
    unet = port_sd.from_jax(jm).unet
    x, t, ctx = _unet_inputs(unet.cfg)
    jrt = jax_mesh.MeshRuntime.create(data=1, model=m, devices=jax.devices()[:m])
    sharded = jax_sharding.shard_params(jrt, jm.unet_params)
    with jrt.mesh:
        ref = np.asarray(jax.jit(lambda p, a, b, c: jax_unet.apply(p, jm.unet_cfg, a, b, c))(
            sharded, jnp.asarray(_nhwc(x)), jnp.asarray(t.numpy()), jnp.asarray(ctx.numpy())))
    shards = shard_params(unet, cpus(m))
    q = shards[1].input_blocks[1][1].transformer_blocks[0].attn1.to_q.weight
    assert q.shape[0] == unet.input_blocks[1][1].transformer_blocks[0].attn1.to_q.weight.shape[0] \
        // m
    tp = TensorParallelUNet(shards, cpus(m))
    with torch.no_grad():
        got = tp(x, t, ctx)
        plain = unet(x, t, ctx)
    np.testing.assert_allclose(_nhwc(got), ref, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-4, rtol=1e-5)
    ref_sd = unet.state_dict()
    assert all(torch.equal(v, ref_sd[k]) for k, v in gather_state_dict(shards).items())


def test_tensor_parallel_unet_heads_that_do_not_divide():
    """SDXL's 320-wide level has 5 heads: over model=2 every shard runs all
    of them after a gather (here 3 heads of 32 over 96 channels)."""
    cfg = dataclasses.replace(port_sd.TINY_UNET, model_channels=96, num_heads=-1,
                              num_head_channels=32, context_dim=64)
    unet = port_sd._random(UNetModel(cfg, device="cpu", dtype=torch.float32), 3, CPU)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in unet.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.02)
    assert cfg.heads_for(96) == 3
    x, t, ctx = _unet_inputs(cfg)
    tp = TensorParallelUNet(shard_params(unet, cpus(2)), cpus(2))
    with torch.no_grad():
        np.testing.assert_allclose(tp(x, t, ctx).numpy(), unet(x, t, ctx).numpy(),
                                   atol=1e-4, rtol=1e-5)


# --------------------------------------------------------------------------
# the training step
# --------------------------------------------------------------------------

def _train_batch(cfg, b=4, hw=8, seed=0):
    rng = np.random.default_rng(seed)
    return {"x0": rng.standard_normal((b, hw, hw, 4)).astype(np.float32),
            "noise": rng.standard_normal((b, hw, hw, 4)).astype(np.float32),
            "t": rng.integers(0, 1000, (b,)).astype(np.int32),
            "ctx": rng.standard_normal((b, 77, cfg.context_dim)).astype(np.float32)}


def _port_batch(batch):
    return {"x0": _nchw(batch["x0"]), "noise": _nchw(batch["noise"]),
            "t": torch.from_numpy(batch["t"].astype(np.int64)),
            "ctx": torch.from_numpy(batch["ctx"])}


def _port_train(unet, disc, batch, data, model, steps=2):
    """(each step's loss, the parameters after the steps, each step's
    gradients), the sharded ones gathered whole."""
    rt = mesh.MeshRuntime.create(data=data, model=model, devices=cpus(data * model))
    step, shard_batch, prepare = port_train.make_train_step(rt, unet.cfg, disc)
    shards, opts = prepare(unet)
    losses, grads = [], []
    for _ in range(steps):
        shards, opts, loss = step(shards, opts, shard_batch(_port_batch(batch)))
        losses.append(float(loss))
        named = [dict(s.named_parameters()) for s in shards[0]]
        got = [{k: p.grad.clone() for k, p in n.items()} for n in named]
        grads.append(gather_state_dict(shards[0], got) if model > 1 else got[0])
    params = gather_state_dict(shards[0]) if model > 1 else shards[0][0].state_dict()
    for row in shards[1:]:      # the data replicas agree to the bit
        other = gather_state_dict(row) if model > 1 else row[0].state_dict()
        assert all(torch.equal(other[k], params[k]) for k in params)
    return losses, params, grads


def _rel(a: dict, b: dict) -> float:
    """max |a − b| over every tensor / max |b| over every tensor."""
    num = max(float((a[k].float() - b[k].float()).abs().max()) for k in b)
    return num / max(float(b[k].float().abs().max()) for k in b)


#: a gradient element at most this share of its step's largest |g| is at
#: rounding level: the tiny UNet's time embedding and the biases before its
#: one-channel GroupNorm groups have a zero true gradient (|g| ~ 1e-8 of
#: the largest), and Adam turns their rounding into steps of up to lr
ROUNDING = 1e-6
#: max |Δp − Δp_one| / max |Δp_one| over the elements above rounding level:
#: one f32 ulp of the largest parameter (|p| ≤ 1.36) is 6e-3 of lr·2 steps,
#: a skipped or a 10%-off update reads 1 or 0.1 (measured 1.5e-3)
UPDATE_TOL = 1e-2


def _update_rel(src: dict, got: dict, one: dict, one_grads: list) -> tuple:
    """(max |Δgot − Δone| / max |Δone| over the elements whose one-device
    gradient is above rounding level at every step, the elements masked);
    Δ = the parameters after the steps − src."""
    peaks = [max(float(g.abs().max()) for g in step.values()) for step in one_grads]
    num, masked = 0.0, 0
    for k in one_grads[0]:
        mask = torch.zeros(src[k].shape, dtype=torch.bool)
        for step, peak in zip(one_grads, peaks):
            mask |= step[k].abs() <= ROUNDING * peak
        masked += int(mask.sum())
        diff = ((got[k] - src[k]) - (one[k] - src[k])).abs()[~mask]
        num = max(num, float(diff.max()) if diff.numel() else 0.0)
    return num / max(float((one[k] - src[k]).abs().max()) for k in one_grads[0]), masked


def _assert_same_update(src: dict, got: dict, one: dict, one_grads: list):
    """The sharded update equals the one-device update element for element
    (above rounding level), and moves the whole UNet as far."""
    rel, masked = _update_rel(src, got, one, one_grads)
    assert rel <= UPDATE_TOL, (rel, masked)
    moved, moved_one = _rel(got, src), _rel(one, src)
    assert moved_one > 0 and abs(moved / moved_one - 1) <= 0.05


#: a one-level UNet for the trainers: eager JAX compiles every op apart
#: (test_torch_training's TRAIN_UNET)
TRAIN_UNET = UNetConfig(model_channels=32, num_res_blocks=1, channel_mult=(1,),
                        attention_resolutions=(1,), transformer_depth=(1,), context_dim=64,
                        num_heads=4)


@pytest.fixture(scope="module")
def train_models():
    from sdwebui_tpu.models import unet as jax_unet

    jm = dataclasses.replace(jax_sd.create_tiny_sd(0), unet_cfg=TRAIN_UNET, unet_params=_perturbed(
        jax_unet.init_params(TRAIN_UNET, 3, dtype=jnp.float32), np.random.default_rng(2)))
    return jm, port_sd.from_jax(jm)


def test_train_step_data_model_matches_jax_and_one_device(train_models):
    """Two steps of make_train_step on (data=2, model=2) with a one-level
    UNet: loss and every parameter within 1e-5 relative of JAX's step on
    the same mesh (under jax.disable_jit: the jitted step strays on this
    CPU, ROADMAP "Bound, not equality") and of the port's
    one-device step; each step's gradients within 1e-5 relative of the
    one-device step's.  Relative: over the whole UNet, max |Δ| / max |ref|.
    The update itself, Δp = p after − p before, of the port's sharded step
    and of JAX's within UPDATE_TOL of the one-device update, element for
    element above rounding level (Adam moves a parameter by about lr a
    step, so a parameter bound of 1e-5 of max |p| would pass a step that
    updated nothing)."""
    from sdwebui_tpu.training import train_step as jax_train

    jm, pm = train_models
    batch = _train_batch(jm.unet_cfg)
    jrt = jax_mesh.MeshRuntime.create(data=2, model=2, devices=jax.devices()[:4])
    step, shard_batch, prepare = jax_train.make_train_step(jrt, jm.unet_cfg, jm.disc)
    with jax.disable_jit():
        params, opt_state = prepare(jm.unet_params)
        jax_losses = []
        for _ in range(2):
            params, opt_state, loss = step(params, opt_state, shard_batch(
                {k: jnp.asarray(v) for k, v in batch.items()}))
            jax_losses.append(float(loss))
    jax_params = port_sd.state_dict_from_tree(jax.device_get(params))

    src = {k: v.clone() for k, v in pm.unet.state_dict().items()}
    losses, got, grads = _port_train(pm.unet, pm.disc, batch, 2, 2)
    one_losses, one, one_grads = _port_train(pm.unet, pm.disc, batch, 1, 1)
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-5)
    np.testing.assert_allclose(losses, one_losses, rtol=1e-5)
    assert _rel(got, jax_params) <= 1e-5
    assert _rel(got, one) <= 1e-5
    assert all(_rel(g, g1) <= 1e-5 for g, g1 in zip(grads, one_grads))
    _assert_same_update(src, got, one, one_grads)
    _assert_same_update(src, jax_params, one, one_grads)


@pytest.mark.parametrize("data,model", [(2, 1), (1, 2)])
def test_train_step_one_axis_matches_one_device(train_models, data, model):
    _, pm = train_models
    batch = _train_batch(pm.unet_cfg, seed=1)
    src = {k: v.clone() for k, v in pm.unet.state_dict().items()}
    losses, got, grads = _port_train(pm.unet, pm.disc, batch, data, model)
    one_losses, one, one_grads = _port_train(pm.unet, pm.disc, batch, 1, 1)
    np.testing.assert_allclose(losses, one_losses, rtol=1e-5)
    assert _rel(got, one) <= 1e-5
    assert all(_rel(g, g1) <= 1e-5 for g, g1 in zip(grads, one_grads))
    _assert_same_update(src, got, one, one_grads)


def test_make_optimizer_is_jax_adamw():
    opt = port_train.make_optimizer()([torch.nn.Parameter(torch.zeros(1))])
    group = opt.param_groups[0]
    assert (group["lr"], group["weight_decay"], group["betas"], group["eps"]) == \
        (1e-5, 1e-2, (0.9, 0.999), 1e-8)
