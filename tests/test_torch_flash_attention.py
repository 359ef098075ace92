"""Flash attention port: plain version vs the JAX kernel, and the CUDA kernel
vs the plain version on the card.

The JAX side runs the Pallas kernel in interpret mode, as tests/test_ops.py
does.  jax is imported inside the JAX-comparison tests so the CUDA cases
also collect on a machine without jax.
"""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
from torch_jax_state import jax_vae_file_reset  # noqa: F401  (JAX's loaded-VAE global)
import numpy as np
import pytest
import torch

from sdwebui_tpu_torch.ops import attention as attn_mod
from sdwebui_tpu_torch.ops.flash_attention import (flash_attention,
                                                   flash_attention_4d,
                                                   flash_attention_4d_plain,
                                                   flash_attention_packed,
                                                   flash_attention_packed_plain,
                                                   flash_attention_plain,
                                                   launch_count,
                                                   reset_launch_count)

GRID = [
    (2, 64, 64, 40),     # SD1.5 self-attn head geometry (tiny seq)
    (2, 64, 77, 40),     # cross-attn with 77-token conds (kv padding mask)
    (1, 128, 128, 512),  # VAE mid-block single head
    (3, 100, 33, 64),    # ragged: q pad + kv pad
]


def _qkv(seed, bh, sq, skv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((bh, sq, d), dtype=np.float32),
            rng.standard_normal((bh, skv, d), dtype=np.float32),
            rng.standard_normal((bh, skv, d), dtype=np.float32))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("bh,sq,skv,d", GRID)
def test_plain_matches_jax_flash_f32(bh, sq, skv, d):
    import jax.numpy as jnp

    from sdwebui_tpu.ops.flash_attention import flash_attention as jax_flash

    q, k, v = _qkv(0, bh, sq, skv, d)
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               block_q=64, block_kv=64, interpret=True))
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v))
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("bh,sq,skv,d", [(2, 64, 64, 80), (1, 64, 96, 160)])
def test_plain_matches_jax_flash_wider_heads(bh, sq, skv, d, dtype, tol):
    """B1's plain version at the SD1.5 32² head dim (80) and at 160 (past the
    tensor-core kernel's 128, on the split-d kernel's side) against the JAX
    kernel in interpret mode; absolute 1e-5 in f32, 2e-2 in bf16."""
    from sdwebui_tpu.ops.flash_attention import flash_attention as jax_flash

    q, k, v = _qkv(6, bh, sq, skv, d)
    ref = jax_flash(*(jnp_dtype(a, dtype) for a in (q, k, v)), block_q=64, block_kv=64,
                    interpret=True)
    out = flash_attention(*(torch_dtype(a, dtype) for a in (q, k, v)))
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=0, atol=tol)


def test_plain_matches_jax_flash_bf16():
    import jax.numpy as jnp

    from sdwebui_tpu.ops.flash_attention import flash_attention as jax_flash

    q, k, v = _qkv(1, 2, 64, 77, 40)
    ref = jax_flash(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
                    jnp.asarray(v, jnp.bfloat16), block_q=64, block_kv=64,
                    interpret=True)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out = flash_attention(tq, tk, tv)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, dtype=np.float32),
                               rtol=0.1, atol=0.1)


@pytest.mark.parametrize("num_heads", [None, 4])
def test_attention_dispatch_matches_jax(num_heads):
    import jax.numpy as jnp

    from sdwebui_tpu.ops.attention import attention as jax_attention

    if num_heads is None:
        q, k, v = _qkv(2, 3, 50, 30, 32)
    else:
        q, k, v = _qkv(3, 2, 40, 77, 64)
    ref = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), num_heads=num_heads))
    out = attn_mod.attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), num_heads=num_heads)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [40, 80])
def test_attention_dispatch_sd15_heads_matches_jax(d):
    """ops.attention with the SD1.5 head geometry (8 heads of 40 or 80) on
    fused-qkv chunk views against the JAX dispatch (f32, 1e-5)."""
    import jax.numpy as jnp

    from sdwebui_tpu.ops.attention import attention as jax_attention

    rng = np.random.default_rng(7 + d)
    qkv = rng.standard_normal((2, 96, 3 * 8 * d), dtype=np.float32)
    ctx = rng.standard_normal((2, 77, 2 * 8 * d), dtype=np.float32)
    for q, k, v in (np.split(qkv, 3, axis=-1),                       # self-attention
                    (qkv[..., :8 * d], *np.split(ctx, 2, axis=-1))):   # cross, Skv 77
        ref = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       num_heads=8))
        tq, tk, tv = (torch.from_numpy(np.ascontiguousarray(a)) for a in (q, k, v))
        out = attn_mod.attention(tq, tk, tv, num_heads=8)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_cpu_wrapper_uses_plain_and_counts_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 2, 33, 1100, 16))
    reset_launch_count()
    out = attn_mod.attention(q, k, v)   # Skv >= 1024, but on the CPU
    assert launch_count() == 0
    torch.testing.assert_close(out, flash_attention_plain(q, k, v),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shapes,dtype,error", [
    (((2, 8, 16), (2, 8, 16), (2, 8, 16)), torch.float16, TypeError),
    (((2, 8, 12), (2, 8, 12), (2, 8, 12)), torch.float32, ValueError),   # d % 8
    (((2, 8, 520), (2, 8, 520), (2, 8, 520)), torch.float32, ValueError),  # d > 512
    (((2, 8, 16), (3, 8, 16), (3, 8, 16)), torch.float32, ValueError),   # BH
    (((2, 8, 16), (2, 8, 16), (2, 9, 16)), torch.float32, ValueError),   # Skv
    (((8, 16), (8, 16), (8, 16)), torch.float32, ValueError),            # rank
])
def test_kernel_argument_checks(shapes, dtype, error):
    """What the wrapper refuses before a launch (the checks run on any
    device; only a CUDA tensor goes on to the kernel)."""
    from sdwebui_tpu_torch.ops.flash_attention import _check

    q, k, v = (torch.zeros(s, dtype=dtype) for s in shapes)
    with pytest.raises(error):
        _check(q, k, v)


def test_kernel_argument_checks_strides():
    from sdwebui_tpu_torch.ops.flash_attention import _check

    q = torch.zeros(2, 16, 8).transpose(1, 2)      # last dim strided
    k = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError, match="contiguous"):
        _check(q, k, k)
    _check(k[:, :, :8], k[:, :, 8:], k[:, :, 8:])   # row-strided views pass


def test_operands_copy_only_what_tma_cannot_take():
    """The 16-byte rule of the kernels' loads, decided on the host: aligned
    views (fused-qkv chunks, B1's (BH, S, D)) pass as they are; a 2-byte
    offset or a row stride of H·D + 4 bf16 elements is copied."""
    from sdwebui_tpu_torch.ops.flash_attention import _aligned16, _operands

    qkv = torch.zeros((2, 64, 3 * 8 * 40), dtype=torch.bfloat16)
    chunks = qkv.chunk(3, dim=-1)
    assert all(_aligned16(t) for t in chunks)
    assert all(a is b for a, b in zip(_operands(*chunks), chunks))
    assert _aligned16(torch.zeros((16, 4096, 40), dtype=torch.bfloat16)[:, :1000])
    odd = torch.zeros((3, 200, 56), dtype=torch.bfloat16)[..., 1:41]
    wide = torch.zeros((2, 33, 4 * 64 + 4), dtype=torch.bfloat16)[..., :256]
    for t in (odd, wide):
        assert not _aligned16(t)
        (c, _, _) = _operands(t, t, t)
        assert c.is_contiguous() and _aligned16(c) and torch.equal(c, t)
    assert _aligned16(torch.zeros((2, 33, 4 * 64 + 4))[..., :256])   # f32: 1040 B rows


def test_forced_flash_on_cpu_raises():
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, 1, 8, 8, 8))
    with attn_mod.forced_impl("flash"):
        with pytest.raises(ValueError, match="CUDA"):
            attn_mod.attention(q, k, v)
    assert attn_mod.get_forced_impl() is None
    with pytest.raises(ValueError):
        attn_mod.set_attention_impl("xla")


# ---- B2 (packed) and B3 (4-D) --------------------------------------------

# tests/test_ops.py:160,190 shapes at the SDXL head dim (b, sq, skv, h, d)
GRID_HEADS = [
    (2, 64, 64, 4, 64),     # multi-kv-block grid on the TPU side
    (2, 64, 77, 4, 64),     # cross-attention, kv padding mask
    (1, 100, 100, 2, 64),   # ragged rows
    (1, 64, 64, 2, 128),    # one head per 128 lanes
]


def _heads_qkv(seed, b, sq, skv, h, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d), dtype=np.float32),
            rng.standard_normal((b, skv, h, d), dtype=np.float32),
            rng.standard_normal((b, skv, h, d), dtype=np.float32))


def jnp_dtype(a, dtype):
    import jax.numpy as jnp

    return jnp.asarray(a, getattr(jnp, dtype))


def torch_dtype(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("b,sq,skv,h,d", GRID_HEADS)
def test_packed_matches_jax_flash_packed(b, sq, skv, h, d, dtype, tol):
    """The port's (B, S, H·D) entry on the CPU (its plain version) against
    the JAX packed kernel in interpret mode; absolute tolerance 1e-5 in f32,
    2e-2 in bf16 (outputs are bf16-rounded averages of N(0,1) values)."""
    from sdwebui_tpu.ops.flash_attention import flash_attention_packed as jax_packed

    q, k, v = (a.reshape(a.shape[0], a.shape[1], h * d) for a in _heads_qkv(3, b, sq, skv, h, d))
    ref = jax_packed(*(jnp_dtype(a, dtype) for a in (q, k, v)), num_heads=h,
                     block_q=64, block_kv=64, interpret=True)
    out = flash_attention_packed(*(torch_dtype(a, dtype) for a in (q, k, v)), num_heads=h)
    assert out.shape == (b, sq, h * d) and out.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=0, atol=tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("b,sq,skv,h,d", GRID_HEADS)
def test_4d_matches_jax_flash_4d(b, sq, skv, h, d, dtype, tol):
    """The port's (B, S, H, D) entry on the CPU against the JAX 4-D kernel
    in interpret mode; tolerances as for the packed entry."""
    from sdwebui_tpu.ops.flash_attention import flash_attention_4d as jax_4d

    q, k, v = _heads_qkv(4, b, sq, skv, h, d)
    ref = jax_4d(*(jnp_dtype(a, dtype) for a in (q, k, v)), block_q=64, block_kv=64,
                 interpret=True)
    out = flash_attention_4d(*(torch_dtype(a, dtype) for a in (q, k, v)))
    assert out.shape == (b, sq, h, d) and out.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=0, atol=tol)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("d", [40, 80])
def test_packed_sd15_heads_on_fused_qkv_matches_jax(d, dtype, tol):
    """The (B, S, H·D) entry at SD1.5's 8 heads of 40 and 80, on the three
    chunk views of a fused qkv projection (row stride 3·H·D, as the UNet
    calls it), against the JAX kernels in interpret mode: the packed kernel
    at d = 80 (8 heads fill 5 × 128 lanes) and, at d = 40, the 4-D kernel
    (JAX packs no 40-wide heads: 8 × 40 is not a multiple of 128)."""
    from sdwebui_tpu.ops.flash_attention import flash_attention_4d as jax_4d
    from sdwebui_tpu.ops.flash_attention import flash_attention_packed as jax_packed

    b, s, h = 2, 80, 8
    qkv = np.random.default_rng(8).standard_normal((b, s, 3 * h * d), dtype=np.float32)
    parts = [np.ascontiguousarray(a) for a in np.split(qkv, 3, axis=-1)]
    if d == 80:
        ref = jax_packed(*(jnp_dtype(a, dtype) for a in parts), num_heads=h, block_q=64,
                         block_kv=64, interpret=True)
    else:
        ref = jax_4d(*(jnp_dtype(a.reshape(b, s, h, d), dtype) for a in parts), block_q=64,
                     block_kv=64, interpret=True).reshape(b, s, h * d)
    q, k, v = torch_dtype(qkv, dtype).chunk(3, dim=-1)
    assert q.stride(1) == 3 * h * d
    out = flash_attention_packed(q, k, v, num_heads=h)
    assert out.shape == (b, s, h * d) and out.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=0, atol=tol)


def test_packed_and_4d_plain_equal_per_head_plain():
    """Both layouts compute B1's math per head: the same numbers as the
    (B·H, S, D) plain version on the split heads, on chunk views too."""
    q, k, v = (torch.from_numpy(a) for a in _heads_qkv(5, 2, 40, 50, 3, 16))
    b, h, d = 2, 3, 16

    def split(t):
        return t.transpose(1, 2).reshape(b * h, t.shape[1], d)

    ref = flash_attention_plain(split(q), split(k), split(v), scale=0.3)
    out4 = flash_attention_4d_plain(q, k, v, scale=0.3)
    torch.testing.assert_close(split(out4), ref, rtol=0, atol=1e-6)
    fused = torch.cat([t.flatten(2)[:, :40] for t in (q, k, v)], dim=-1)   # (B, S, 3·H·D)
    qc, kc, vc = fused.chunk(3, dim=-1)
    outp = flash_attention_packed_plain(qc, kc, vc, num_heads=h, scale=0.3)
    ref = flash_attention_plain(split(q), split(k[:, :40]), split(v[:, :40]), scale=0.3)
    torch.testing.assert_close(split(outp.unflatten(-1, (h, d))), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("d,h", [(64, 10), (64, 20), (64, 12), (64, 24), (128, 3),
                                 (64, 5), (40, 8), (80, 8), (160, 8), (32, 4)])
def test_dispatch_packs_only_where_jax_would(d, h, monkeypatch):
    """The automatic choice on a CUDA tensor (only the device type is read):
    every (B, S, H·D) call with Skv >= 1024 takes the strided kernel B2,
    whatever the head geometry, with the q/k/v views handed over as they
    are (no head split or merge copy); short KV and the CPU never do;
    "plain" forces the plain path, "flash" and "flash-packed" the kernel."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert attn_mod._use_flash(4096, cuda)
    assert not attn_mod._use_flash(77, cuda)
    assert not attn_mod._use_flash(4096, cpu)
    with attn_mod.forced_impl("plain"):
        assert not attn_mod._use_flash(4096, cuda)
    for forced in ("flash", "flash-packed"):
        with attn_mod.forced_impl(forced):
            assert attn_mod._use_flash(77, cuda)
            with pytest.raises(ValueError, match="CUDA"):
                attn_mod._use_flash(4096, cpu)

    seen = []

    def packed(q, k, v, *, num_heads, scale=None):
        seen.append((q, k, v, num_heads))
        return flash_attention_packed_plain(q, k, v, num_heads=num_heads, scale=scale)

    monkeypatch.setattr(attn_mod, "flash_attention_packed", packed)
    monkeypatch.setattr(attn_mod, "_use_flash", lambda skv, device: skv >= 1024)
    q, k, v = torch.zeros((1, 1024, 3 * h * d)).chunk(3, dim=-1)
    attn_mod.attention(q, k, v, num_heads=h)
    assert len(seen) == 1 and seen[0][3] == h
    assert all(a is b for a, b in zip(seen[0][:3], (q, k, v)))


def test_sdxl_unet_attention_calls_follow_the_plan():
    """Which entry each self-attention takes on the card, from the configs
    alone: every one with Skv >= 1024 takes B2 (the base's 10 at 64² and 60
    at 32², the refiner's 40, SD1.5's 10 at 64² and 32²); the refiner's 16²
    middle block and SD1.5's 16² level (Skv 256) take the plain path, and
    no UNet call reaches the per-head B1 entry."""
    from sdwebui_tpu.models.configs import SD15_UNET, SDXL_REFINER_UNET, SDXL_UNET
    from sdwebui_tpu_torch.models.unet import self_attention_calls

    cuda = torch.device("cuda")

    def plan(cfg, latent):
        calls = self_attention_calls(cfg, latent)
        packed = sum(attn_mod._use_flash(s, cuda) for s, h, d in calls)
        per_head = sum(s >= attn_mod.FLASH_MIN_KV and not attn_mod._use_flash(s, cuda)
                       for s, h, d in calls)
        return len(calls), packed, per_head

    assert plan(SDXL_UNET, 128) == (70, 70, 0)
    assert plan(SDXL_REFINER_UNET, 128) == (44, 40, 0)
    assert plan(SD15_UNET, 64) == (16, 10, 0)
    assert {(s, h, d) for s, h, d in self_attention_calls(SDXL_UNET, 128)} == {
        (4096, 10, 64), (1024, 20, 64)}
    assert {(s, h, d) for s, h, d in self_attention_calls(SD15_UNET, 64)
            if s >= attn_mod.FLASH_MIN_KV} == {(4096, 8, 40), (1024, 8, 80)}


# ---- on the card ---------------------------------------------------------

#: the kernels against their plain versions, as chip_smoke.py phase 1 holds
#: them: bf16 by max|Δ| / max|ref| (outputs of N(0, 1) inputs shrink as
#: sqrt(e / Skv), so an absolute bound would pass a dropped kv tile), f32
#: by max|Δ| with TF32 off
ATTN_REL_TOL = 2e-2
F32_TOL = 1e-4


def assert_matches_plain(out, ref):
    err = (out.float() - ref.float()).abs().max().item()
    if out.dtype == torch.bfloat16:
        ref_max = ref.float().abs().max().item()
        assert err <= ATTN_REL_TOL * ref_max, f"max|Δ| {err} / max|ref| {ref_max}"
    else:
        assert err <= F32_TOL, f"max|Δ| {err}"


CUDA_CASES = [
    ((16, 4096, 4096, 40), torch.bfloat16),
    ((16, 1024, 1024, 80), torch.bfloat16),
    ((1, 4096, 4096, 512), torch.bfloat16),
    ((1, 4096, 4096, 512), torch.float32),
    ((3, 1000, 1100, 64), torch.bfloat16),
    ((3, 1000, 1100, 64), torch.float32),
    ((2, 77, 300, 160), torch.bfloat16),
    ((5, 33, 7, 8), torch.float32),
    ((5, 33, 7, 8), torch.bfloat16),
    ((4, 130, 200, 24), torch.bfloat16),     # d padded to 32 by TMA's zero fill
    ((2, 100, 300, 256), torch.bfloat16),    # split-d kernel, 128 columns per group
    ((2, 70, 130, 400), torch.bfloat16),     # split-d kernel, padded to 512
    ((2, 50, 90, 200), torch.float32),
]

#: every head-dim class of the three kernels, in both dtypes
HEAD_DIMS = [8, 40, 64, 80, 128, 136, 160, 512]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", CUDA_CASES)
def test_cuda_kernel_matches_plain(cuda_device, shape, dtype):
    bh, sq, skv, d = shape
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn((bh, sq, d), generator=g, device=cuda_device).to(dtype)
    k = torch.randn((bh, skv, d), generator=g, device=cuda_device).to(dtype)
    v = torch.randn((bh, skv, d), generator=g, device=cuda_device).to(dtype)
    reset_launch_count()
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert launch_count() == 1
    assert_matches_plain(out, flash_attention_plain(q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_cuda_head_dims_ragged(cuda_device, d, dtype):
    """Each head dim the kernels split on (wgmma k-steps of 16, swizzles of
    32/64/128 bytes, the split-d kernel's two column counts, the f32 micro-
    tiles) at ragged Sq/Skv (1000/1100: partial q and kv tiles)."""
    g = torch.Generator(device=cuda_device).manual_seed(d)
    q = torch.randn((2, 1000, d), generator=g, device=cuda_device).to(dtype)
    k = torch.randn((2, 1100, d), generator=g, device=cuda_device).to(dtype)
    v = torch.randn((2, 1100, d), generator=g, device=cuda_device).to(dtype)
    out = flash_attention(q, k, v)
    assert_matches_plain(out, flash_attention_plain(q, k, v))


@pytest.mark.cuda
def test_cuda_tma_fill_stays_inside_the_head(cuda_device):
    """At d = 40 the kernel reads 48 columns per head (the wgmma k-step is
    16); TMA must zero-fill columns 40-47 and never read the next head's or
    the row's padding.  Here the row carries 8 columns of 1e4 after the
    last head: a leak would swamp the scores."""
    b, s, h, d = 2, 1024, 8, 40
    g = torch.Generator(device=cuda_device).manual_seed(6)
    big = torch.randn((b, s, 3, h * d + 8), generator=g, device=cuda_device)
    big[..., h * d:] = 1e4
    big = big.to(torch.bfloat16)
    q, k, v = (big[:, :, i, :h * d] for i in range(3))
    out = flash_attention_packed(q, k, v, num_heads=h)
    assert_matches_plain(out, flash_attention_packed_plain(q, k, v, num_heads=h))


@pytest.mark.cuda
def test_cuda_tiny_txt2img_through_kernel(cuda_device):
    """The slice on the card with the kernel forced at every UNet and VAE
    attention (tiny model, f32 policy: the f32 kernel at d = 8, 16, 64 and
    Skv = 64 or 77) gives the CPU port's images within 1 uint8 level."""
    import copy
    import dataclasses

    from sdwebui_tpu.pipeline.params import GenerationParams
    from sdwebui_tpu_torch.pipeline.processing import process_txt2img
    from sdwebui_tpu_torch.pipeline.sd_model import create_tiny_sd
    from sdwebui_tpu_torch.utils import devices

    cpu = create_tiny_sd(0, "cpu")
    with torch.no_grad():
        # zero-mean CLIP output (zero biases) would make emphasis divide
        # rounding noise by rounding noise on either device
        cpu.conditioner.model.final_layer_norm.bias.normal_(
            0.0, 0.1, generator=torch.Generator().manual_seed(0))
    cond = copy.deepcopy(cpu.conditioner)
    cond.model.to(cuda_device)
    gpu = dataclasses.replace(cpu, unet=copy.deepcopy(cpu.unet).to(cuda_device),
                              vae=copy.deepcopy(cpu.vae).to(cuda_device),
                              conditioner=cond, device=cuda_device)

    def params():
        return GenerationParams(prompt="a (red:1.2) cat AND a dog :0.5", seed=11,
                                steps=3, width=64, height=64, batch_size=2,
                                override_settings={"sdtpu_vae_bf16": False})

    prev = devices.get_policy()
    devices.set_policy(devices.FP32_POLICY)
    try:
        ref = process_txt2img(cpu, params())
        reset_launch_count()
        with attn_mod.forced_impl("flash"):
            out = process_txt2img(gpu, params())
    finally:
        devices.set_policy(prev)
    assert launch_count() > 0
    for a, b in zip(out.images, ref.images):
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert out.infotexts == ref.infotexts


@pytest.mark.cuda
def test_cuda_kernel_strided_heads(cuda_device):
    """The kernel reads q/k/v through strides: a (B, S, H, D) view that was
    never made contiguous per head gives the same result."""
    b, s, h, d = 2, 300, 3, 40
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn((b, s, h, d), generator=g, device=cuda_device).to(torch.bfloat16)
    q = x.permute(0, 2, 1, 3).reshape(b * h, s, d)        # contiguous copy
    view = x.permute(0, 2, 1, 3)[0]                        # (H, S, D), strided
    out = flash_attention(view, view, view)
    assert_matches_plain(out, flash_attention_plain(q[:h], q[:h], q[:h]))


@pytest.mark.cuda
def test_cuda_kernel_unaligned_rows(cuda_device):
    """An operand that is not 16-byte aligned (TMA's rule) is copied with
    .contiguous() before the launch: the same result."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    big = torch.randn((3, 200, 56), generator=g, device=cuda_device).to(torch.bfloat16)
    q = big[..., 1:41]                        # 2-byte offset: no 16-byte loads
    out = flash_attention(q, q, q)
    assert_matches_plain(out, flash_attention_plain(q, q, q))


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d", [(2, 4096, 10, 64), (2, 1024, 20, 64),
                                     (2, 4096, 12, 64), (2, 1024, 24, 64),
                                     (2, 300, 3, 40)])
def test_cuda_packed_on_fused_qkv_chunks(cuda_device, b, s, h, d):
    """B2 on the three chunk views of a fused (B, S, 3·H·D) projection (row
    stride 3·H·D, no copy), and B3 on (B, S, H, D) views of the same data,
    against their plain versions."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    qkv = torch.randn((b, s, 3 * h * d), generator=g, device=cuda_device).to(torch.bfloat16)
    q, k, v = qkv.chunk(3, dim=-1)
    assert q.stride(1) == 3 * h * d and not q.is_contiguous()
    reset_launch_count()
    out = flash_attention_packed(q, k, v, num_heads=h)
    out4 = flash_attention_4d(*(t.unflatten(-1, (h, d)) for t in (q, k, v)))
    torch.cuda.synchronize()
    assert (launch_count("flash_attention_packed"), launch_count("flash_attention_4d"),
            launch_count()) == (1, 1, 0)
    ref = flash_attention_packed_plain(q, k, v, num_heads=h)
    assert_matches_plain(out, ref)
    assert_matches_plain(out4.flatten(2), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_packed_and_4d_unaligned_row_stride(cuda_device, dtype):
    """Row strides that are not a multiple of 16 bytes (H·D + 4 elements)
    are copied with .contiguous() before the launch; Sq != Skv and ragged
    lengths."""
    b, sq, skv, h, d = 2, 333, 1100, 4, 64
    g = torch.Generator(device=cuda_device).manual_seed(4)

    def padded(s):
        return torch.randn((b, s, h * d + 4), generator=g, device=cuda_device).to(dtype)[
            ..., :h * d]

    q, k, v = padded(sq), padded(skv), padded(skv)
    assert q.stride(1) % 8 != 0
    out = flash_attention_packed(q, k, v, num_heads=h)
    out4 = flash_attention_4d(*(t.unflatten(-1, (h, d)) for t in (q, k, v)))
    ref = flash_attention_packed_plain(q, k, v, num_heads=h)
    assert_matches_plain(out, ref)
    assert_matches_plain(out4.flatten(2), ref)


@pytest.mark.cuda
def test_cuda_sdxl_dispatch_launches_packed(cuda_device):
    """A (B, S, H·D) call with Skv >= 1024 goes to B2 at d = 64 and at
    d = 40 alike; B1 is never reached."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn((2, 1024, 3 * 640), generator=g, device=cuda_device).to(torch.bfloat16)
    reset_launch_count()
    attn_mod.attention(*x.chunk(3, dim=-1), num_heads=10)     # d = 64
    attn_mod.attention(*x.chunk(3, dim=-1), num_heads=16)     # d = 40
    torch.cuda.synchronize()
    assert (launch_count("flash_attention_packed"), launch_count()) == (2, 0)
