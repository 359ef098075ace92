"""Port modules vs the JAX package on identical weights (CPU; f32 unless a
test says bf16).

Weights: the JAX ``create_tiny_sd`` model, carried across with
``sd_model.from_jax``.  Inputs are made with numpy from a seed.  Layouts
are NHWC on the JAX side and NCHW in the port; tolerances are stated per
test (summation order differs between XLA and torch on the CPU).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sdwebui_tpu.models import clip as jax_clip
from sdwebui_tpu.models import unet as jax_unet
from sdwebui_tpu.models import vae as jax_vae
from sdwebui_tpu.pipeline import sd_model as jax_sd
from sdwebui_tpu_torch.models.unet import UNetModel
from sdwebui_tpu_torch.ops import norms as torch_norms
from sdwebui_tpu_torch.pipeline import sd_model as port_sd


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.numpy(), (0, 2, 3, 1))


def _assert_rel(out, ref, rel):
    """max |Δ| within `rel` of the reference's largest magnitude."""
    scale = max(float(np.abs(ref).max()), 1e-6)
    err = float(np.abs(out - ref).max())
    assert err <= rel * scale, f"max|Δ| {err:.3e} > {rel} * {scale:.3e}"


def _perturbed(tree, rng):
    """Random biases and norm gains: the init's zero biases and unit norms
    make layer-normed outputs exactly zero-mean, where emphasis divides
    rounding noise by rounding noise in either framework."""
    from sdwebui_tpu.utils.pytree import flatten, unflatten

    flat = {}
    for key, leaf in flatten(tree).items():
        a = np.asarray(leaf)
        if key.endswith(".bias"):
            a = a + rng.normal(0, 0.1, a.shape).astype(a.dtype)
        elif a.ndim == 1:
            a = a + rng.normal(0, 0.1, a.shape).astype(a.dtype)
        flat[key] = jnp.asarray(a)
    return unflatten(flat)


@pytest.fixture(scope="module")
def models():
    jm = jax_sd.create_tiny_sd(3)
    rng = np.random.default_rng(30)
    jm = dataclasses.replace(jm, unet_params=_perturbed(jm.unet_params, rng),
                             vae_params=_perturbed(jm.vae_params, rng))
    jm.conditioner.params = _perturbed(jm.conditioner.params, rng)
    return jm, port_sd.from_jax(jm, device="cpu")


def test_from_jax_consumes_every_key(models):
    jm, pm = models
    from sdwebui_tpu.utils.pytree import flatten

    assert set(flatten(jm.unet_params)) == set(pm.unet.state_dict())
    assert set(flatten(jm.vae_params)) == set(pm.vae.state_dict())
    assert set(flatten(jm.conditioner.params)) == set(pm.conditioner.model.state_dict())
    # conv HWIO → OIHW, linear (I, O) → (O, I), embeddings as they are
    w = np.asarray(jm.unet_params["input_blocks"]["0"]["0"]["weight"])
    np.testing.assert_array_equal(pm.unet.input_blocks[0][0].weight.numpy(),
                                  np.transpose(w, (3, 2, 0, 1)))
    e = np.asarray(jm.conditioner.params["embeddings"]["token_embedding"]["weight"])
    np.testing.assert_array_equal(
        pm.conditioner.model.embeddings["token_embedding"].weight.numpy(), e)


@pytest.mark.parametrize("field,value,match", [
    ("tome_ratio", 0.5, "ToMe"),
    ("hypertile_tile", 32, "hypertile"),
    ("upcast_attn", True, "upcast_attn"),
])
def test_unsupported_unet_options_raise(field, value, match):
    cfg = dataclasses.replace(port_sd.TINY_UNET, **{field: value})
    with pytest.raises(NotImplementedError, match=match):
        UNetModel(cfg, device="cpu", dtype=torch.float32)


def test_unported_unet_inputs_raise(models):
    from sdwebui_tpu_torch.models.controlnet import ControlNetModel
    from sdwebui_tpu_torch.networks.hypernetwork import Hypernetwork

    pm = models[1]
    with pytest.raises(NotImplementedError, match="ControlNet option not ported yet: tiling"):
        ControlNetModel(dataclasses.replace(port_sd.TINY_UNET, tiling=True), device="cpu",
                        dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="hypernetwork activation 'softsign'"):
        Hypernetwork({}, activation="softsign")
    sd = dict(pm.unet.state_dict())
    sd["middle_block.1.qkv.weight"] = torch.zeros(3, 3, 1)
    with pytest.raises(NotImplementedError, match="AttentionBlock"):
        pm.unet.load_state_dict(sd)


def test_modules_move_with_to(models):
    """nn.Module.to/_apply is not shadowed: every model converts as a whole."""
    import copy

    pm = models[1]
    for module in (pm.unet, pm.vae, pm.conditioner.model):
        moved = copy.deepcopy(module).to(torch.float64)
        assert {p.dtype for p in moved.parameters()} == {torch.float64}


def test_fp8_leaves_raise():
    import ml_dtypes

    tree = {"w": {"weight": np.zeros((2, 2), ml_dtypes.float8_e4m3fn)}}
    with pytest.raises(NotImplementedError, match="fp8"):
        port_sd.state_dict_from_tree(tree)


@pytest.mark.parametrize("silu", [False, True])
def test_group_norm_matches_jax(silu):
    from sdwebui_tpu.ops.norms import group_norm

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, 64), dtype=np.float32) * 3 + 1
    w = rng.standard_normal(64, dtype=np.float32)
    b = rng.standard_normal(64, dtype=np.float32)
    ref = np.asarray(group_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                num_groups=32, eps=1e-6, silu=silu))
    out = torch_norms.group_norm(_nchw(x), torch.from_numpy(w), torch.from_numpy(b),
                                 num_groups=32, eps=1e-6, silu=silu)
    np.testing.assert_allclose(_nhwc(out), ref, rtol=1e-5, atol=1e-5)


def test_layer_norm_matches_jax():
    from sdwebui_tpu.ops.norms import layer_norm

    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 77, 96), dtype=np.float32)
    w = rng.standard_normal(96, dtype=np.float32)
    b = rng.standard_normal(96, dtype=np.float32)
    ref = np.asarray(layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    out = torch_norms.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(b))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_timestep_embedding_matches_jax():
    """tolerance 1e-4 absolute: cos/sin of f32 arguments up to 999, whose
    float32 spacing is 6e-5, differ by about one ulp between XLA and torch."""
    from sdwebui_tpu.models.layers import timestep_embedding as jax_te
    from sdwebui_tpu_torch.models.layers import timestep_embedding

    t = np.asarray([0.0, 1.5, 500.25, 999.0], np.float32)
    np.testing.assert_allclose(timestep_embedding(torch.from_numpy(t), 320).numpy(),
                               np.asarray(jax_te(jnp.asarray(t), 320)),
                               rtol=0, atol=1e-4)


def test_unet_matches_jax(models):
    """tolerance: 1e-4 of the output's largest magnitude (f32)."""
    jm, pm = models
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, 16, 4), dtype=np.float32)
    t = np.asarray([999.0, 321.5], np.float32)
    ctx = rng.standard_normal((2, 154, 64), dtype=np.float32)
    apply = jax.jit(lambda p, *a: jax_unet.apply(p, jm.unet_cfg, *a))
    ref = np.asarray(apply(jm.unet_params, jnp.asarray(x), jnp.asarray(t),
                           jnp.asarray(ctx)))
    with torch.inference_mode():
        out = pm.unet(_nchw(x), torch.from_numpy(t), torch.from_numpy(ctx))
    _assert_rel(_nhwc(out), ref, 1e-4)


def test_unet_bf16_matches_jax_bf16(models):
    """bf16 params and activations on both sides.  tolerance: 5e-2 of the
    f32 output's largest magnitude.  Each side's bf16 output lies 1.6e-2 from
    the f32 one on this input, so the bound catches a wrong graph or a lost
    operand in bf16, not where each framework rounds."""
    jm, _ = models
    p16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jm.unet_params)
    pm16 = port_sd.from_jax(dataclasses.replace(jm, unet_params=p16), device="cpu")
    assert pm16.unet.input_blocks[0][0].weight.dtype == torch.bfloat16
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, 16, 4), dtype=np.float32)
    t = np.asarray([999.0, 321.5], np.float32)
    ctx = rng.standard_normal((2, 154, 64), dtype=np.float32)
    apply = jax.jit(lambda p, *a: jax_unet.apply(p, jm.unet_cfg, *a))
    ref32 = np.asarray(apply(jm.unet_params, jnp.asarray(x), jnp.asarray(t),
                             jnp.asarray(ctx)))
    ref = np.asarray(apply(p16, jnp.asarray(x, jnp.bfloat16), jnp.asarray(t),
                           jnp.asarray(ctx, jnp.bfloat16)).astype(jnp.float32))
    with torch.inference_mode():
        out = pm16.unet(_nchw(x).to(torch.bfloat16), torch.from_numpy(t),
                        torch.from_numpy(ctx).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    scale = float(np.abs(ref32).max())
    err = float(np.abs(_nhwc(out.float()) - ref).max())
    assert err <= 5e-2 * scale, f"max|Δ| {err:.3e} > 5e-2 * {scale:.3e}"


def test_vae_decode_matches_jax(models):
    """tolerance: 1e-4 of the output's largest magnitude (f32); the JAX
    side uses its fused four-phase upsample-conv, the port the plain one."""
    jm, pm = models
    rng = np.random.default_rng(5)
    z = rng.standard_normal((2, 8, 8, 4), dtype=np.float32)
    decode = jax.jit(lambda p, z: jax_vae.decode(p, jm.vae_cfg, z))
    ref = np.asarray(decode(jm.vae_params, jnp.asarray(z)))
    with torch.inference_mode():
        out = pm.vae.decode(_nchw(z))
    assert out.shape == (2, 3, 64, 64)
    _assert_rel(_nhwc(out), ref, 1e-4)


def test_vae_encode_is_not_ported(models):
    """The encode is ported (its parity with JAX is in test_torch_img2img.py):
    moments (mean, logvar) and the scaled mode at the latent grid."""
    vae = models[1].vae
    down = 2 ** (len(vae.cfg.ch_mult) - 1)
    with torch.inference_mode():
        moments = vae.encode_moments(torch.zeros(1, 3, 64, 64))
        mode = vae.encode_mode(moments)
    assert moments.shape == (1, 2 * vae.cfg.embed_dim, 64 // down, 64 // down)
    assert mode.shape == (1, vae.cfg.embed_dim, 64 // down, 64 // down)
    assert torch.isfinite(moments).all()


@pytest.mark.parametrize("clip_skip,final_norm", [(1, True), (2, True), (2, False)])
def test_clip_matches_jax(models, clip_skip, final_norm):
    """tolerance: 1e-4 of the largest magnitude, hidden and pooled."""
    jm, pm = models
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, 49406, (3, 77)).astype(np.int32)
    tokens[:, 0] = 49406
    tokens[np.arange(3), [5, 40, 76]] = 49407
    hid_ref, pool_ref = jax_clip.encode(jm.conditioner.params, jm.conditioner.cfg,
                                        jnp.asarray(tokens), clip_skip - 1, final_norm)
    with torch.inference_mode():
        hid, pool = pm.conditioner.model.encode(torch.from_numpy(tokens).long(),
                                                clip_skip - 1, final_norm)
    _assert_rel(hid.numpy(), np.asarray(hid_ref), 1e-4)
    _assert_rel(pool.numpy(), np.asarray(pool_ref), 1e-4)


LONG = ", ".join(f"word{i} (thing{i}:1.3)" for i in range(30))

PROMPTS = [
    ("a (red:1.4) cat [on a mat]", ""),
    (LONG, "blurry, lowres"),                                  # multi-chunk
    ("a photo of a cat BREAK in the snow", "ugly BREAK bad"),
    ("a [dog:cat:0.5] on a hill AND a castle :0.6", "[bad:good:2]"),
]


@pytest.mark.parametrize("prompt,negative", PROMPTS)
def test_conditioner_schedule_matches_jax(models, prompt, negative):
    """Chunking, BREAK, emphasis, prompt editing and AND: every bank and
    index table; tolerance 1e-4 of the largest magnitude on the banks."""
    from sdwebui_tpu.text.conditioner import build_cond_schedule as jax_build
    from sdwebui_tpu_torch.text.conditioner import build_cond_schedule

    jm, pm = models
    steps = 6
    ref = jax_build(jm.encode_texts, prompt, negative, steps, cond_scale=5.0)
    out = build_cond_schedule(pm.encode_texts, prompt, negative, steps, cond_scale=5.0)
    assert out.cond_bank.shape == ref.cond_bank.shape
    np.testing.assert_array_equal(out.cond_idx, np.asarray(ref.cond_idx))
    np.testing.assert_array_equal(out.uncond_idx, np.asarray(ref.uncond_idx))
    np.testing.assert_allclose(out.cond_weights, np.asarray(ref.cond_weights))
    _assert_rel(out.cond_bank.numpy(), np.asarray(ref.cond_bank), 1e-4)
    _assert_rel(out.uncond_bank.numpy(), np.asarray(ref.uncond_bank), 1e-4)


def test_tokenize_line_matches_jax(models):
    jm, pm = models
    for prompt, _ in PROMPTS:
        ref_chunks, ref_count = jm.conditioner.tokenize_line(prompt)
        chunks, count = pm.conditioner.tokenize_line(prompt)
        assert count == ref_count
        assert [c.tokens for c in chunks] == [c.tokens for c in ref_chunks]
        assert [c.multipliers for c in chunks] == [c.multipliers for c in ref_chunks]


@pytest.mark.parametrize("mode", ["Original", "No norm", "None"])
def test_apply_emphasis_matches_jax(mode):
    from sdwebui_tpu.text.conditioner import apply_emphasis as jax_emph
    from sdwebui_tpu_torch.text.conditioner import apply_emphasis

    rng = np.random.default_rng(7)
    z = rng.standard_normal((3, 77, 32), dtype=np.float32)
    z[2] -= z[2].mean()           # zero mean: the NaN guard keeps it finite
    m = rng.uniform(0.5, 1.5, (3, 77)).astype(np.float32)
    ref = np.asarray(jax_emph(jnp.asarray(z), jnp.asarray(m), mode))
    out = apply_emphasis(torch.from_numpy(z), torch.from_numpy(m), mode).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
