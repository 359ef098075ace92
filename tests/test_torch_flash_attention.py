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
