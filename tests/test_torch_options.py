"""The UNet and sampling options of the port against the JAX package (CPU,
tiny sizes): hypertile's tiles, ToMe's merge, upcast_attn and fp8 storage
in the UNet; the Zero Terminal SNR and downcast ᾱ tables; old emphasis;
the device noise source's Philox; the persistent cond cache."""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdwebui_tpu.models import unet as jax_unet
from sdwebui_tpu.ops import tome as jax_tome
from sdwebui_tpu.pipeline import sd_model as jax_sd
from sdwebui_tpu.rng import philox_jax
from sdwebui_tpu.sampling import discretization as jax_disc
from sdwebui_tpu.utils.pytree import flatten
from sdwebui_tpu_torch.models import unet as port_unet
from sdwebui_tpu_torch.models.unet import AttentionOptions
from sdwebui_tpu_torch.ops import tome as port_tome
from sdwebui_tpu_torch.pipeline import sd_model as port_sd
from sdwebui_tpu_torch.rng import device_philox
from sdwebui_tpu_torch.rng import image_rng
from sdwebui_tpu_torch.sampling import discretization as port_disc
from sdwebui_tpu_torch.utils.options import opts
from test_torch_models import _assert_rel, _nchw, _nhwc, _perturbed

#: the tiny UNet at a 16² latent with an 8-token tile: hypertile splits the
#: 16² level in 2 × 2 and leaves the 8² level whole (h·w = tile², SD1.5's
#: 64² and 32² levels at 512²); ToMe merges both
LATENT = 16
TILE = 8


@pytest.fixture(scope="module")
def models():
    jm = jax_sd.create_tiny_sd(3)
    rng = np.random.default_rng(30)
    jm = dataclasses.replace(jm, unet_params=_perturbed(jm.unet_params, rng))
    return jm, port_sd.from_jax(jm, device="cpu")


def _inputs(seed=0, batch=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, LATENT, LATENT, 4)).astype(np.float32)
    ctx = rng.standard_normal((batch, 77, 64)).astype(np.float32)
    t = np.array([500.0, 20.0][:batch], np.float32)
    return x, ctx, t


def _jax_apply(*args):
    """JAX's UNet under jit: one compile costs less than the eager op-by-op
    first run."""
    import jax

    return jax.jit(jax_unet.apply, static_argnums=1)(*args)


def _forward_pair(jm, pm, opts_, dtype):
    """(port, JAX) UNet outputs (NHWC) at the options, params and
    activations in `dtype`."""
    import jax

    x, ctx, t = _inputs()
    cfg = dataclasses.replace(jm.unet_cfg, hypertile_tile=opts_.tile,
                              tome_ratio=opts_.tome_ratio, upcast_attn=opts_.upcast)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    params = jax.tree.map(lambda a: a.astype(jdt), jm.unet_params)
    ref = np.asarray(_jax_apply(params, cfg, jnp.asarray(x, jdt), jnp.asarray(t),
                                jnp.asarray(ctx, jdt)).astype(jnp.float32))
    unet = pm.unet if dtype == torch.float32 else _cast(pm.unet, dtype)
    with torch.no_grad():
        out = unet(_nchw(x).to(dtype), torch.from_numpy(t), torch.from_numpy(ctx).to(dtype),
                   attn=opts_).float()
    return _nhwc(out), ref


def _cast(unet, dtype):
    import copy

    clone = copy.deepcopy(unet)
    for p in clone.parameters():
        if p.dtype == torch.float32:
            p.data = p.data.to(dtype)
    return clone


OPTIONS = [AttentionOptions(tile=TILE), AttentionOptions(tome_ratio=0.5),
           AttentionOptions(upcast=True), AttentionOptions(tile=TILE, upcast=True),
           AttentionOptions(tome_ratio=0.3, tile=TILE)]
OPTION_IDS = ["hypertile", "tome", "upcast", "hypertile-upcast", "tome-over-hypertile"]


@pytest.mark.parametrize("opts_", OPTIONS, ids=OPTION_IDS)
def test_unet_options_match_jax(models, opts_):
    """The whole UNet in f32 within 1e-4 of the output's largest magnitude."""
    jm, pm = models
    out, ref = _forward_pair(jm, pm, opts_, torch.float32)
    _assert_rel(out, ref, 1e-4)


@pytest.mark.parametrize("opts_", OPTIONS, ids=OPTION_IDS)
def test_transformer_options_match_jax_bf16(models, opts_):
    """bf16 params and activations: the first SpatialTransformer (16²
    tokens) within 2e-2 of its output's largest magnitude.  The whole bf16
    UNet drifts 2.2e-2 from JAX's without any option (each side 1.6e-2
    from f32), so the bound is held where the options act.  ToMe at bf16
    may flip a near-tied merge: the bound is on the output, not the
    indices."""
    import jax

    jm, pm = models
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, LATENT, LATENT, 32)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 64)).astype(np.float32)
    cfg = dataclasses.replace(jm.unet_cfg, hypertile_tile=opts_.tile,
                              tome_ratio=opts_.tome_ratio, upcast_attn=opts_.upcast)
    p = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jm.unet_params["input_blocks"]["1"]["1"])
    ref = np.asarray(jax_unet._spatial_transformer(
        p, jnp.asarray(x, jnp.bfloat16), jnp.asarray(ctx, jnp.bfloat16), cfg, 1
    ).astype(jnp.float32))
    block = _cast(pm.unet.input_blocks[1][1], torch.bfloat16)
    with torch.no_grad():
        out = _nhwc(block(_nchw(x).to(torch.bfloat16), torch.from_numpy(ctx).to(torch.bfloat16),
                          None, opts_).float())
    if not opts_.tome_ratio:
        _assert_rel(out, ref, 2e-2)
        return
    # a flipped merge moves its token, its two dst tokens and the tokens
    # merged into them: at most 2% of an image's tokens outside the bound
    bad = np.abs(out - ref).max(axis=-1) > 2e-2 * np.abs(ref).max()
    assert bad.reshape(2, -1).sum(axis=1).max() <= 0.02 * LATENT * LATENT, bad.sum()


def test_unet_options_change_the_output(models):
    """Each option reaches the forward: hypertile and ToMe move it, upcast
    at bf16 too; at f32 upcast is the plain forward."""
    _, pm = models
    x, ctx, t = _inputs()

    def run(opts_, dtype=torch.float32, unet=pm.unet):
        with torch.no_grad():
            return unet(_nchw(x).to(dtype), torch.from_numpy(t),
                        torch.from_numpy(ctx).to(dtype), attn=opts_).float()

    plain = run(AttentionOptions())
    for opts_ in (AttentionOptions(tile=TILE), AttentionOptions(tome_ratio=0.5)):
        assert (run(opts_) - plain).abs().max() > 1e-3
    assert torch.equal(run(AttentionOptions(upcast=True)), plain)
    u16 = _cast(pm.unet, torch.bfloat16)
    assert not torch.equal(run(AttentionOptions(upcast=True), torch.bfloat16, u16),
                           run(AttentionOptions(), torch.bfloat16, u16))


def test_split_factor_matches_jax():
    for dim in range(1, 130):
        for tile in (1, 3, 8, 16, 32, 48, 64):
            assert port_unet.split_factor(dim, tile) == jax_unet._split_factor(dim, tile)


@pytest.mark.parametrize("hw,tile", [((32, 32), 16), ((24, 40), 16), ((16, 16), 16),
                                     ((17, 34), 16), ((96, 64), 32)])
def test_hypertile_tiles_match_jax(monkeypatch, hw, tile):
    """The tile split and its inverse, exactly: a stand-in attention that
    adds each tile's mean and its batch row's index shows every token's
    tile and order."""
    rng = np.random.default_rng(hw[0] * 100 + hw[1])
    x = rng.standard_normal((2, hw[0] * hw[1], 8)).astype(np.float32)

    def fake(t):
        rows = np.arange(t.shape[0], dtype=np.float32)[:, None, None]
        return t + t.mean(axis=1, keepdims=True) * 3 + rows

    monkeypatch.setattr(jax_unet, "_cross_attention",
                        lambda p, x, c, heads, hn=None, upcast=False: jnp.asarray(
                            fake(np.asarray(x))))

    class Fake:
        def __call__(self, t, hypernet=None, upcast=False):
            return torch.from_numpy(fake(t.numpy()))

    ref = np.asarray(jax_unet._hypertiled_self_attention(None, jnp.asarray(x), 1, hw, tile,
                                                         None))
    out = port_unet.hypertiled_self_attention(Fake(), torch.from_numpy(x), hw, tile).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("hw,ratio", [((8, 8), 0.5), ((16, 12), 0.3), ((32, 32), 0.5),
                                      ((6, 10), 0.9), ((5, 8), 0.5)])
def test_tome_merge_unmerge_match_jax(hw, ratio):
    """f32, no ties: the merged tokens and their unmerge equal JAX's."""
    rng = np.random.default_rng(int(ratio * 100) + hw[0])
    x = rng.standard_normal((2, hw[0] * hw[1], 24)).astype(np.float32)
    ref = jax_tome.build_merge(jnp.asarray(x), hw[0], hw[1], ratio)
    out = port_tome.build_merge(torch.from_numpy(x), hw[0], hw[1], ratio)
    if ref is None:
        assert out is None
        return
    assert out[2] == ref[2] == port_tome.merged_tokens(hw[0], hw[1], ratio)
    merged = out[0](torch.from_numpy(x))
    np.testing.assert_array_equal(merged.numpy(), np.asarray(ref[0](jnp.asarray(x))))
    y = rng.standard_normal(merged.shape).astype(np.float32)
    np.testing.assert_array_equal(out[1](torch.from_numpy(y)).numpy(),
                                  np.asarray(ref[1](jnp.asarray(y))))


def test_fp8_codes_match_jax(models):
    """quantize_unet_fp8: the same leaves in float8_e4m3fn, code for code;
    the forward upcasts at use; dequantize from the kept copies is exact."""
    jm, _ = models
    pm = port_sd.from_jax(jm, device="cpu")
    before = {k: v.clone() for k, v in pm.unet.state_dict().items()}
    jq = jax_sd.quantize_unet_fp8(jm)
    port_sd.quantize_unet_fp8(pm, keep_hp=True)
    ours = pm.unet.state_dict()
    n_fp8 = 0
    for key, leaf in flatten(jq.unet_params).items():
        a = np.asarray(leaf)
        t = ours[key]
        if a.dtype.name == "float8_e4m3fn":
            n_fp8 += 1
            assert t.dtype == torch.float8_e4m3fn, key
            codes = np.ascontiguousarray(a).view(np.uint8)
            if a.ndim == 4:
                codes = codes.transpose(3, 2, 0, 1)
            elif a.ndim == 2:
                codes = codes.T
            np.testing.assert_array_equal(t.view(torch.uint8).numpy(), codes, err_msg=key)
        else:
            assert t.dtype == torch.float32, key
    assert n_fp8 > 20 and port_sd.has_fp8(pm)
    # the JAX fp8 tree carried across keeps its codes
    carried = port_sd.from_jax(jq, device="cpu").unet.state_dict()
    for key, t in ours.items():
        assert carried[key].dtype == t.dtype
        assert torch.equal(carried[key].view(torch.uint8) if t.dtype == torch.float8_e4m3fn
                           else carried[key], t.view(torch.uint8)
                           if t.dtype == torch.float8_e4m3fn else t), key
    x, ctx, t = _inputs()
    ref = np.asarray(_jax_apply(jq.unet_params, jq.unet_cfg, jnp.asarray(x),
                                jnp.asarray(t), jnp.asarray(ctx)))
    with torch.no_grad():
        out = _nhwc(pm.unet(_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx)))
    _assert_rel(out, ref, 1e-4)
    port_sd.dequantize_unet_fp8(pm)
    assert not port_sd.has_fp8(pm) and pm.unet_hp is None
    for key, t in pm.unet.state_dict().items():
        assert torch.equal(t, before[key]), key


def test_fp8_without_copies_upcasts(models):
    jm, _ = models
    pm = port_sd.from_jax(jm, device="cpu")
    port_sd.quantize_unet_fp8(pm)
    codes = {k: v.clone() for k, v in pm.unet.state_dict().items()
             if v.dtype == torch.float8_e4m3fn}
    port_sd.dequantize_unet_fp8(pm, dtype=torch.float32)
    for key, c in codes.items():
        assert torch.equal(pm.unet.get_parameter(key), c.float()), key


def test_zero_terminal_snr_and_downcast_tables():
    abar = port_disc.make_alphas_cumprod()
    ours = port_disc.rescale_zero_terminal_snr_abar(abar)
    ref = jax_disc.rescale_zero_terminal_snr_abar(np.asarray(abar))
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(port_disc.Discretization(ours).sigmas,
                                  jax_disc.Discretization(ref).sigmas)
    assert np.isfinite(port_disc.Discretization(ours).sigmas).all()


# --------------------------------------------------------------------------
# the device noise source
# --------------------------------------------------------------------------

def test_device_philox_words_match_jax():
    rng = np.random.default_rng(4)
    words = [rng.integers(0, 2 ** 32, 257, dtype=np.uint64).astype(np.uint32)
             for _ in range(6)]
    ref = philox_jax.philox10_words(*[jnp.asarray(w) for w in words])
    out = device_philox.philox10_words(*[torch.from_numpy(w.astype(np.int64)) for w in words])
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(np.int64))


@pytest.mark.parametrize("kw", [dict(), dict(subseeds=[9, 10], subseed_strength=0.4),
                                dict(eta_noise_seed_delta=31337)],
                         ids=["plain", "subseed", "ensd"])
def test_device_philox_matches_jax(kw):
    """The stream JAX's DevicePhiloxRNG draws (first, next_k, next; the
    ENSD reseed; the subseed slerp) within 2e-6: JAX's float32 Box–Muller
    is up to 1.46e-6 from the exact transform (XLA's CPU sin, ~330 ulps near
    π), the port's float64 one is the host NV stream's (ROADMAP C)."""
    seeds = [3, 2 ** 33 + 5]
    a = device_philox.DevicePhiloxRNG((4, 16, 16), seeds, "cpu", **kw)
    b = philox_jax.DevicePhiloxRNG((4, 16, 16), seeds, **kw)
    for draw in (lambda r: r.first(), lambda r: r.next_k(3), lambda r: r.next(),
                 lambda r: r.next_k(2)):
        out, ref = draw(a).numpy(), np.moveaxis(np.asarray(draw(b)), -1, -3)
        assert out.shape == ref.shape
        assert np.abs(out - ref).max() <= 2e-6


@pytest.mark.parametrize("kw", [dict(), dict(eta_noise_seed_delta=7)], ids=["plain", "ensd"])
def test_device_philox_equals_the_host_nv_stream(kw):
    """Without a subseed the device source draws the host NV floats, bit
    for bit: the same words, the same float64 transform."""
    seeds = [11, 2 ** 40 + 3]
    a = device_philox.DevicePhiloxRNG((4, 24, 16), seeds, "cpu", **kw)
    b = image_rng.ImageRNG((4, 24, 16), seeds, channels_last=False, **kw)
    np.testing.assert_array_equal(a.first().numpy(), b.first())
    np.testing.assert_array_equal(a.next_k(4).numpy(), b.next_k(4))
    np.testing.assert_array_equal(a.next().numpy(), b.next())


def test_device_source_through_create_rng():
    with opts.override({"randn_source": "GPU"}):
        rng = image_rng.create_rng((4, 8, 8), [5], channels_last=False)
        assert isinstance(rng, device_philox.DevicePhiloxRNG)
        host = image_rng.ImageRNG((4, 8, 8), [5], channels_last=False)
        np.testing.assert_array_equal(rng.first().numpy(), host.first())
        # a seed resize takes the host path
        assert isinstance(image_rng.create_rng((4, 8, 8), [5], seed_resize_from_h=32,
                                               seed_resize_from_w=32, channels_last=False),
                          image_rng.ImageRNG)
