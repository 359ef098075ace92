"""B5 (LayerNorm) and B4 (3×3 conv) of the port: plain versions vs the JAX
kernels on the CPU, and the CUDA kernels vs the plain versions on the card.

The JAX side runs the Pallas kernels in interpret mode, as tests/test_ops.py
and tests/test_conv.py do; jax is imported inside those tests so that the
CUDA cases also collect on a machine without jax.  Layouts: the JAX conv is
NHWC/HWIO, the port's NCHW/OIHW.
"""

import numpy as np
import pytest
import torch

from sdwebui_tpu_torch.ops import conv as conv_mod
from sdwebui_tpu_torch.ops import layer_norm as ln_mod
from sdwebui_tpu_torch.ops import norms

LN_SHAPES = [(2, 64, 1280), (2, 33, 320), (3, 77, 768), (2, 5, 640), (2, 4096, 320)]
CONV_SHAPES = [   # (B, H, W, Cin, Cout), tests/test_conv.py:18-22
    (2, 8, 8, 16, 24),
    (1, 16, 8, 8, 8),
    (1, 8, 16, 24, 16),
]


def _ln_inputs(shape, seed=4):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    b = rng.standard_normal(shape[-1]).astype(np.float32)
    return x, w, b


def _bf16_ulp(v):
    """One bf16 unit in the last place at |v| (8 significant bits)."""
    a = np.maximum(np.abs(v), np.float32(1e-30))
    return np.exp2(np.floor(np.log2(a)) - 7)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# --------------------------------------------------------------------------
# B5: LayerNorm
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", LN_SHAPES)
def test_layer_norm_plain_matches_jax_pallas(shape):
    """f32 within 2e-5 abs/rel; bf16 within one bf16 ulp (both round the
    fp32 result once), plus the f32 bound's 2e-5 for outputs near zero,
    where x − mean differs with the fp32 summation order."""
    import jax.numpy as jnp

    from sdwebui_tpu.ops.pallas_norms import layer_norm_pallas

    x, w, b = _ln_inputs(shape)
    ref = np.asarray(layer_norm_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                       interpret=True))
    out = ln_mod.layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)

    xb = jnp.asarray(x, jnp.bfloat16)
    ref_b = np.asarray(layer_norm_pallas(xb, None, None, interpret=True), np.float32)
    out_b = ln_mod.layer_norm(torch.from_numpy(x).to(torch.bfloat16))
    assert out_b.dtype == torch.bfloat16
    out_b = out_b.float().numpy()
    diff = np.abs(out_b - ref_b)
    assert (diff <= _bf16_ulp(np.maximum(np.abs(out_b), np.abs(ref_b))) + 2e-5).all()


@pytest.mark.parametrize("shape", LN_SHAPES[:4])
def test_layer_norm_plain_matches_jax_main_path(shape):
    """vs ``sdwebui_tpu.ops.norms.layer_norm`` (the folded form): f32 within
    2e-5; bf16 within 5e-2, the bound tests/test_ops.py:246-249 uses (the
    folded form rounds scale, shift and the product in bf16)."""
    import jax.numpy as jnp

    from sdwebui_tpu.ops.norms import layer_norm as jax_ln

    x, w, b = _ln_inputs(shape, seed=5)
    ref = np.asarray(jax_ln(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    out = norms.layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)
    ref_b = np.asarray(jax_ln(jnp.asarray(x, jnp.bfloat16)), np.float32)
    out_b = norms.layer_norm(torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_allclose(out_b.float().numpy(), ref_b, rtol=5e-2, atol=5e-2)


def test_layer_norm_dispatch_on_cpu_uses_plain_and_counts_no_launch():
    x, w, b = _ln_inputs((2, 7, 96))
    xt, wt, bt = (torch.from_numpy(a) for a in (x, w, b))
    ln_mod.reset_launch_count()
    want = ln_mod.layer_norm_plain(xt, wt, bt)
    torch.testing.assert_close(norms.layer_norm(xt, wt, bt), want, rtol=0, atol=0)
    with norms.forced_plain():
        torch.testing.assert_close(norms.layer_norm(xt, wt, bt), want, rtol=0, atol=0)
    assert not norms._PLAIN
    assert ln_mod.launch_count() == 0
    # only the weight, only the bias
    np.testing.assert_allclose(ln_mod.layer_norm(xt, wt).numpy(),
                               ln_mod.layer_norm(xt).numpy() * w, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ln_mod.layer_norm(xt, None, bt).numpy(),
                               ln_mod.layer_norm(xt).numpy() + b, rtol=1e-6, atol=1e-6)


def test_layer_norm_other_devices_raise():
    with pytest.raises(ValueError, match="no kernel"):
        ln_mod.layer_norm(torch.zeros(2, 8, device="meta"))


# --------------------------------------------------------------------------
# B4: 3×3 conv
# --------------------------------------------------------------------------

def _conv_inputs(shape, seed, dtype=np.float32):
    bsz, h, w, ci, co = shape
    rng = np.random.RandomState(seed)
    x = rng.randn(bsz, h, w, ci).astype(dtype)
    wt = (rng.randn(3, 3, ci, co) * 0.1).astype(dtype)
    b = rng.randn(co).astype(dtype)
    return x, wt, b


def _to_port(x, wt, b=None):
    """NHWC / HWIO numpy → NCHW / OIHW torch."""
    out = (torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))),
           torch.from_numpy(np.ascontiguousarray(wt.transpose(3, 2, 0, 1))))
    return out + ((torch.from_numpy(b),) if b is not None else (None,))


@pytest.mark.parametrize("shape", CONV_SHAPES)
@pytest.mark.parametrize("with_bias", [True, False])
def test_conv3x3_plain_matches_jax_kernel(shape, with_bias):
    """f32 within 1e-4 abs/rel, the bound of tests/test_conv.py:31."""
    import jax.numpy as jnp

    from sdwebui_tpu.ops.conv import conv3x3 as jax_conv

    x, wt, b = _conv_inputs(shape, 0)
    b = b if with_bias else None
    ref = np.asarray(jax_conv(jnp.asarray(x), jnp.asarray(wt),
                              None if b is None else jnp.asarray(b), interpret=True))
    out = conv_mod.conv3x3(*_to_port(x, wt, b))
    assert out.shape == (shape[0], shape[4], shape[1], shape[2])
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, rtol=1e-4, atol=1e-4)


def test_conv3x3_plain_matches_jax_kernel_bf16():
    """bf16 at the bound of tests/test_conv.py:46 (atol 0.15, rtol 0.1)."""
    import jax.numpy as jnp

    from sdwebui_tpu.ops.conv import conv3x3 as jax_conv

    x, wt, _ = _conv_inputs((1, 8, 8, 16, 16), 2)
    ref = jax_conv(jnp.asarray(x, jnp.bfloat16), jnp.asarray(wt, jnp.bfloat16), None,
                   interpret=True)
    xt, wtt, _ = _to_port(x, wt)
    out = conv_mod.conv3x3(xt.to(torch.bfloat16), wtt.to(torch.bfloat16))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref, np.float32), atol=0.15, rtol=0.1)


def test_conv3x3_cpu_counts_no_launch_and_checks_devices():
    conv_mod.reset_launch_count()
    x, wt, b = _to_port(*_conv_inputs((1, 4, 4, 3, 5), 3))
    conv_mod.conv3x3(x, wt, b)
    assert conv_mod.launch_count() == 0
    with pytest.raises(ValueError, match="no kernel"):
        conv_mod.conv3x3(x.to("meta"), wt.to("meta"))


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

def _rel(out, ref):
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", ["aligned", "ragged_c", "row_stride", "no_affine",
                                  "one_row", "f32_weight"])
def test_cuda_layer_norm_matches_plain(cuda_device, dtype, case):
    """f32 within 1e-4; bf16 within one bf16 ulp (+2e-5 near zero): both
    round the fp32 result once, and their fp32 sums may differ in the last
    bit."""
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def randn(*shape, dt=dtype):
        return (torch.randn(shape, generator=g, device=cuda_device) * 2 + 0.5).to(dt)

    c = {"ragged_c": 333, "one_row": 1280}.get(case, 320)
    x = randn(2, 77, c)
    if case == "row_stride":            # a column slice: row stride 400, not 320
        x = randn(2, 77, 400)[..., :c]
    if case == "one_row":
        x = randn(1, c)
    wdt = torch.float32 if case == "f32_weight" else dtype
    w = None if case == "no_affine" else randn(c, dt=wdt)
    b = None if case == "no_affine" else randn(c, dt=wdt)
    ln_mod.reset_launch_count()
    out = ln_mod.layer_norm(x, w, b)
    ref = ln_mod.layer_norm_plain(x, w, b)
    torch.cuda.synchronize()
    assert ln_mod.launch_count() == 1
    assert out.shape == x.shape and out.dtype == dtype and out.is_contiguous()
    diff = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert diff.max().item() <= 1e-4
    else:
        mag = torch.maximum(out.float().abs(), ref.float().abs()).cpu().numpy()
        assert (diff.cpu().numpy() <= _bf16_ulp(mag) + 2e-5).all(), diff.max().item()


@pytest.mark.cuda
def test_cuda_unet_runs_its_layer_norms_through_the_kernel(cuda_device):
    """Every LayerNorm of the tiny UNet and CLIP launches B5 on CUDA."""
    from sdwebui_tpu_torch.pipeline.sd_model import create_tiny_sd

    m = create_tiny_sd(0, cuda_device)
    x = torch.randn(2, 4, 8, 8, device=cuda_device)
    t = torch.tensor([10.0, 500.0], device=cuda_device)
    ctx = torch.randn(2, 77, m.unet_cfg.context_dim, device=cuda_device)
    ln_mod.reset_launch_count()
    with torch.inference_mode():
        out = m.unet(x, t, ctx)
        with norms.forced_plain():
            ref = m.unet(x, t, ctx)
    torch.cuda.synchronize()
    blocks = sum(1 for mod in m.unet.modules() if type(mod).__name__ == "BasicTransformerBlock")
    assert ln_mod.launch_count() == 3 * blocks > 0
    assert _rel(out, ref) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1e-2), (torch.float32, 1e-5)])
@pytest.mark.parametrize("shape,with_bias", [
    ((2, 320, 16, 16, 320), True),     # a UNet width at a small size
    ((2, 5, 9, 7, 7), True),           # Cin, Cout not multiples of 8
    ((2, 5, 9, 7, 7), False),
    ((3, 24, 1, 1, 40), True),         # H = W = 1: every tap but the centre is padding
    ((1, 64, 33, 17, 130), False),     # ragged pixel and channel tiles
])
def test_cuda_conv3x3_matches_conv2d(cuda_device, dtype, tol, shape, with_bias):
    bsz, cin, h, w, cout = shape
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn((bsz, cin, h, w), generator=g, device=cuda_device).to(dtype)
    wt = (torch.randn((cout, cin, 3, 3), generator=g, device=cuda_device) * 0.1).to(dtype)
    b = torch.randn((cout,), generator=g, device=cuda_device).to(dtype) if with_bias else None
    conv_mod.reset_launch_count()
    out = conv_mod.conv3x3(x, wt, b)
    ref = conv_mod.conv3x3_plain(x, wt, b)
    torch.cuda.synchronize()
    assert conv_mod.launch_count() == 1
    assert out.shape == ref.shape and out.dtype == dtype
    assert _rel(out, ref) <= tol
