"""Flash attention port: plain version vs the JAX kernel, and the CUDA kernel
vs the plain version on the card.

The JAX side runs the Pallas kernel in interpret mode, as tests/test_ops.py
does.  jax is imported inside the JAX-comparison tests so the CUDA cases
also collect on a machine without jax.
"""

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


def _jax_packs(d, h):
    from sdwebui_tpu.ops.flash_attention import packed_heads_per_block

    hp = packed_heads_per_block(d, h)
    return hp is not None and hp <= 2


def test_packs_heads_is_the_jax_auto_rule():
    """packed_heads_per_block(d, H) <= 2, for every head dim the kernel
    takes and 1 to 24 heads."""
    for d in range(8, 513, 8):
        for h in range(1, 25):
            assert attn_mod.packs_heads(d, h) == _jax_packs(d, h), (d, h)


@pytest.mark.parametrize("d,h", [(64, 10), (64, 20), (64, 12), (64, 24), (128, 3),
                                 (64, 5), (40, 8), (80, 8), (160, 8), (32, 4)])
def test_dispatch_packs_only_where_jax_would(d, h):
    """The automatic choice on a CUDA tensor (only the device type is read):
    packed for Skv >= 1024 where JAX packs, never for short KV, never on the
    CPU, and never when another implementation is forced."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert attn_mod._use_packed(d, h, 4096, cuda) == _jax_packs(d, h)
    assert not attn_mod._use_packed(d, h, 77, cuda)
    assert not attn_mod._use_packed(d, h, 4096, cpu)
    for forced in ("plain", "flash"):
        with attn_mod.forced_impl(forced):
            assert not attn_mod._use_packed(d, h, 4096, cuda)
    with attn_mod.forced_impl("flash-packed"):
        assert attn_mod._use_packed(d, h, 77, cuda)
        with pytest.raises(ValueError, match="CUDA"):
            attn_mod._use_packed(d, h, 4096, cpu)


def test_sdxl_unet_attention_calls_follow_the_plan():
    """Which entry each SDXL self-attention takes on the card, from the
    configs alone: every base self-attention (10 at 64², 60 at 32²) and the
    refiner's 40 at 64² and 32² are packed; the refiner's 16² middle block
    (Skv 256) is not.  SD1.5 keeps its 10 per-head B1 calls."""
    from sdwebui_tpu.models.configs import SD15_UNET, SDXL_REFINER_UNET, SDXL_UNET
    from sdwebui_tpu_torch.models.unet import self_attention_calls

    cuda = torch.device("cuda")

    def plan(cfg, latent):
        calls = self_attention_calls(cfg, latent)
        packed = sum(attn_mod._use_packed(d, h, s, cuda) for s, h, d in calls)
        per_head = sum(s >= attn_mod.FLASH_MIN_KV and not attn_mod.packs_heads(d, h)
                       for s, h, d in calls)
        return len(calls), packed, per_head

    assert plan(SDXL_UNET, 128) == (70, 70, 0)
    assert plan(SDXL_REFINER_UNET, 128) == (44, 40, 0)
    assert plan(SD15_UNET, 64) == (16, 0, 10)
    assert {(s, h, d) for s, h, d in self_attention_calls(SDXL_UNET, 128)} == {
        (4096, 10, 64), (1024, 20, 64)}


# ---- on the card ---------------------------------------------------------

CUDA_CASES = [
    ((16, 4096, 4096, 40), torch.bfloat16, 2e-2),
    ((16, 1024, 1024, 80), torch.bfloat16, 2e-2),
    ((1, 4096, 4096, 512), torch.bfloat16, 2e-2),
    ((1, 4096, 4096, 512), torch.float32, 1e-4),
    ((3, 1000, 1100, 64), torch.bfloat16, 2e-2),
    ((3, 1000, 1100, 64), torch.float32, 1e-4),
    ((2, 77, 300, 160), torch.bfloat16, 2e-2),
    ((5, 33, 7, 8), torch.float32, 1e-4),
    ((5, 33, 7, 8), torch.bfloat16, 2e-2),
    ((4, 130, 200, 24), torch.bfloat16, 2e-2),     # D padded to 32 in shared memory
    ((2, 100, 300, 256), torch.bfloat16, 2e-2),    # D split over 2 warps
    ((2, 70, 130, 400), torch.bfloat16, 2e-2),     # D split over 4 warps, padded
    ((2, 50, 90, 200), torch.float32, 1e-4),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,tol", CUDA_CASES)
def test_cuda_kernel_matches_plain(cuda_device, shape, dtype, tol):
    bh, sq, skv, d = shape
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn((bh, sq, d), generator=g, device=cuda_device).to(dtype)
    k = torch.randn((bh, skv, d), generator=g, device=cuda_device).to(dtype)
    v = torch.randn((bh, skv, d), generator=g, device=cuda_device).to(dtype)
    reset_launch_count()
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert launch_count() == 1
    ref = flash_attention_plain(q, k, v)
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol, f"max |Δ| {err} > {tol}"


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
    ref = flash_attention_plain(q[:h], q[:h], q[:h])
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.cuda
def test_cuda_kernel_unaligned_rows(cuda_device):
    """Rows that are not 16-byte aligned take the kernel's scalar loads."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    big = torch.randn((3, 200, 56), generator=g, device=cuda_device).to(torch.bfloat16)
    q = big[..., 1:41]                        # 2-byte offset: no 16-byte loads
    out = flash_attention(q, q, q)
    ref = flash_attention_plain(q, q, q)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d", [(2, 4096, 10, 64), (2, 1024, 20, 64),
                                     (2, 4096, 12, 64), (2, 1024, 24, 64),
                                     (2, 300, 3, 40)])
def test_cuda_packed_on_fused_qkv_chunks(cuda_device, b, s, h, d):
    """B2 on the three chunk views of a fused (B, S, 3·H·D) projection (row
    stride 3·H·D, no copy), and B3 on (B, S, H, D) views of the same data,
    against their plain versions (bf16, 2e-2)."""
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
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert (out4.flatten(2).float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
def test_cuda_packed_and_4d_unaligned_row_stride(cuda_device, dtype, tol):
    """Row strides that are not a multiple of 8 elements (H·D + 4) take the
    kernel's scalar loads; Sq != Skv and ragged lengths."""
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
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert (out4.flatten(2).float() - ref.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_cuda_sdxl_dispatch_launches_packed(cuda_device):
    """A (B, S, H·D) call at d = 64 and Skv >= 1024 goes to B2, not B1; at
    d = 40 it stays on the split → B1 path."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn((2, 1024, 3 * 640), generator=g, device=cuda_device).to(torch.bfloat16)
    reset_launch_count()
    attn_mod.attention(*x.chunk(3, dim=-1), num_heads=10)     # d = 64
    attn_mod.attention(*x.chunk(3, dim=-1), num_heads=16)     # d = 40
    torch.cuda.synchronize()
    assert (launch_count("flash_attention_packed"), launch_count()) == (1, 1)
