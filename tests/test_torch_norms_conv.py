"""B5 (LayerNorm) and B4 (3×3 conv) of the port: plain versions vs the JAX
kernels on the CPU, and the CUDA kernels vs the plain versions on the card.

The JAX side runs the Pallas kernels in interpret mode, as tests/test_ops.py
and tests/test_conv.py do; jax is imported inside those tests so that the
CUDA cases also collect on a machine without jax.  Layouts: the JAX conv is
NHWC/HWIO, the port's NCHW/OIHW.
"""

import torch_threads  # noqa: F401  (one thread share per xdist worker)
import math

import numpy as np
import pytest
import torch

import chip_smoke
from sdwebui_tpu_torch.ops import conv as conv_mod
from sdwebui_tpu_torch.ops import layer_norm as ln_mod
from sdwebui_tpu_torch.ops import norms

LN_SHAPES = [(2, 64, 1280), (2, 33, 320), (3, 77, 768), (2, 5, 640), (2, 4096, 320)]
CONV_SHAPES = [   # (B, H, W, Cin, Cout), tests/test_conv.py:18-22
    (2, 8, 8, 16, 24),
    (1, 16, 8, 8, 8),
    (1, 8, 16, 24, 16),
]
#: (B, Cin, H, W, Cout) of the CUDA conv cases: each tile rectangle, widths
#: that are not powers of two, the split-K path, Cin % 64 != 0, Cin % 8 != 0
CUDA_CONV_SHAPES = [
    (2, 320, 16, 16, 320),     # a UNet width at a small size
    (2, 5, 9, 7, 7),           # Cin, Cout not multiples of 8 (the padded copy)
    (3, 24, 1, 1, 40),         # H = W = 1: every tap but the centre is padding
    (1, 64, 33, 17, 130),      # ragged pixel and channel tiles
    (1, 128, 4, 64, 160),      # the 64x2 rectangle
    (1, 128, 8, 32, 160),      # the 32x4 rectangle
    (1, 128, 16, 16, 160),     # the 16x8 rectangle
    (2, 64, 9, 17, 96),        # W = 17: pixels past the image masked
    (1, 64, 33, 33, 64),       # W = 33
    (2, 1280, 16, 16, 1280),   # SD1.5's 16² level at B = 2: split K over a cluster
    (2, 24, 16, 16, 64),       # Cin % 64 != 0: zeros past Cin from the weight map
    (2, 40, 16, 16, 64),
    (1, 64, 8, 16, 192),       # N tiles of 192 and of 256
    (1, 64, 8, 16, 512),
]
#: clusters of 1..8 blocks of the bf16 conv kernel (BN = 160) that one NVIDIA
#: H100 80GB HBM3 holds at once (tools/norms_conv_probe_cuda.py splits,
#: cudaOccupancyMaxActiveClusters): a cluster's blocks share one GPC
H100_CAPACITY = (132, 66, 39, 30, 22, 17, 15, 15)
#: a card of 132 SMs on which any SMs could form a cluster
IDEAL_CAPACITY = tuple(132 // s for s in range(1, 9))
#: the register kernel's widths on the paths (ops/layer_norm.ln_plan's table)
LN_WIDTHS = {320: (8, 5), 640: (16, 5), 768: (16, 6), 1280: (32, 5), 1536: (32, 6)}


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
# launch plans (the choices that decide each launch), at every phase-1 shape
# --------------------------------------------------------------------------

def _phase1_conv_shapes():
    """(B, H, W, Cin, Cout) of chip_smoke phase 1 and of the CUDA cases."""
    return ([s[1:] for s in chip_smoke.CONV_SHAPES]
            + [(b, h, w, ci, co) for b, ci, h, w, co in CUDA_CONV_SHAPES])


@pytest.mark.parametrize("shape", _phase1_conv_shapes())
def test_conv_plan_covers_every_output_once(shape):
    bsz, h, w, cin, cout = shape
    plan = conv_mod.conv_plan(bsz, h, w, cin, cout, H100_CAPACITY)
    assert (plan.tw, plan.th) in conv_mod.RECTS and plan.tw * plan.th == 128
    assert plan.bn in conv_mod.BN_CHOICES
    # Cin padded to a multiple of 8 (TMA's 16-byte rows), and no further
    assert plan.cin % 8 == 0 and cin <= plan.cin < cin + 8
    assert (plan.cin == cin) == (cin % 8 == 0)
    assert plan.ksteps == 9 * math.ceil(plan.cin / 64)
    splits, n_tiles, m_tiles = plan.grid
    assert splits == plan.splits == plan.cluster and 1 <= plan.cluster <= 8
    # every output pixel in exactly one rectangle of one M tile
    tiles_w, tiles_h = math.ceil(w / plan.tw), math.ceil(h / plan.th)
    assert m_tiles == bsz * tiles_w * tiles_h
    cover = np.zeros((bsz, tiles_h * plan.th, tiles_w * plan.tw), np.int32)
    for mt in range(m_tiles):
        b, rect = divmod(mt, tiles_w * tiles_h)
        h0, w0 = (rect // tiles_w) * plan.th, (rect % tiles_w) * plan.tw
        cover[b, h0:h0 + plan.th, w0:w0 + plan.tw] += 1
    assert (cover == 1).all()     # past the image: masked at the store
    # every output channel in exactly one N tile
    channels = np.zeros(n_tiles * plan.bn, np.int32)
    for nt in range(n_tiles):
        channels[nt * plan.bn:(nt + 1) * plan.bn] += 1
    assert (channels == 1).all() and n_tiles * plan.bn >= cout > (n_tiles - 1) * plan.bn
    # the splits partition the k-steps (9 taps x ceil(Cin / 64) chunks), each non-empty,
    # as the kernel cuts them: [r K / S, (r + 1) K / S)
    ranges = [(r * plan.ksteps // splits, (r + 1) * plan.ksteps // splits)
              for r in range(splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.ksteps
    assert all(a < b for a, b in ranges)
    assert all(ranges[r][1] == ranges[r + 1][0] for r in range(splits - 1))


def test_conv_plan_picks_the_documented_tiles():
    # the rectangle from W, BN = 160 at SD's widths
    for w, rect in ((64, (64, 2)), (32, (32, 4)), (16, (16, 8))):
        assert conv_mod.conv_rect(w, w) == rect
    for cout in (320, 640, 1280):
        assert conv_mod.conv_bn(cout) == 160
    assert conv_mod.conv_bn(64) == 64 and conv_mod.conv_bn(256) == 256
    # no split where the tiles fill the card, e.g. 8x64²x320 (512 blocks)
    assert conv_mod.conv_plan(8, 64, 64, 320, 320, H100_CAPACITY).splits == 1


@pytest.mark.parametrize("capacity", [H100_CAPACITY, IDEAL_CAPACITY])
def test_conv_plan_splits_k_at_the_small_levels(capacity):
    """SD1.5's 32² and 16² levels at B = 2 (64 and 32 output tiles) split K
    over a cluster, at the split the model rates fastest; the levels whose
    tiles fill the card do not split."""
    for shape, tiles in (((2, 32, 32, 640, 640), 64), ((2, 16, 16, 1280, 1280), 32)):
        plan = conv_mod.conv_plan(*shape, capacity)
        assert plan.grid[1] * plan.grid[2] == tiles and plan.splits > 1
        assert plan.splits == conv_mod.conv_splits(tiles, plan.ksteps, capacity)
    # on the H100 the 16² level takes 3 splits (96 blocks): the clusters of 4-8
    # that would give all 132 SMs a block do not fit on the card at once
    assert conv_mod.conv_plan(2, 16, 16, 1280, 1280, H100_CAPACITY).splits == 3
    assert conv_mod.conv_plan(2, 64, 64, 320, 320, capacity).splits == 1
    assert conv_mod.conv_plan(8, 16, 16, 1280, 1280, capacity).splits == 1


def _layer_norm_widths():
    return sorted({c for _, _, c in chip_smoke.layer_norm_shapes()} | set(LN_WIDTHS))


@pytest.mark.parametrize("c", _layer_norm_widths())
def test_layer_norm_plan_at_every_path_width(c):
    lanes, chunks = ln_mod.ln_plan(c, 2)
    assert lanes in (8, 16, 32) and 1 <= chunks <= 8
    assert lanes * chunks * 8 >= c
    if c in LN_WIDTHS:
        assert (lanes, chunks) == LN_WIDTHS[c]


@pytest.mark.parametrize("itemsize", [2, 4])
def test_layer_norm_plan_rule(itemsize):
    per = 16 // itemsize
    for c in range(per, 4096 + per, per):
        lanes, chunks = ln_mod.ln_plan(c, itemsize)
        if c > 2048:                              # wider than 32 lanes x 64 values
            assert (lanes, chunks) == (0, 0)
            continue
        assert lanes * chunks * per >= c and chunks * per <= 64
        assert chunks <= 8 or (itemsize == 4 and lanes == 32
                               and chunks in ln_mod.F32_WIDE_CHUNKS)
        if lanes > 8:                            # the fewest lanes that hold the row
            assert -(-c // (per * lanes // 2)) > 8
    # rows that do not split into 16-byte chunks take the loop kernel
    assert ln_mod.ln_plan(333, itemsize) == (0, 0)
    assert ln_mod.ln_plan(320, itemsize, aligned=False) == (0, 0)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

def _rel(out, ref):
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", ["aligned", "ragged_c", "row_stride", "no_affine",
                                  "one_row", "f32_weight", "bf16_weight"])
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
    wdt = {"f32_weight": torch.float32, "bf16_weight": torch.bfloat16}.get(case, dtype)
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
@pytest.mark.parametrize("shape,with_bias", [(s, True) for s in CUDA_CONV_SHAPES] + [
    ((2, 5, 9, 7, 7), False),
    ((1, 64, 33, 17, 130), False),
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 1e-2), (torch.float32, 1e-5)])
def test_cuda_conv3x3_unaligned_base(cuda_device, dtype, tol):
    """x and the weight start 2 (bf16) or 4 (f32) bytes past a 16-byte
    boundary: the wrapper copies them for the kernels' 16-byte loads."""
    bsz, cin, h, w, cout = 2, 64, 16, 16, 64
    g = torch.Generator(device=cuda_device).manual_seed(2)

    def shifted(n, c, hh, ww, scale=1.0):   # channels-last (N, C, H, W), one element in
        flat = torch.randn(n * c * hh * ww + 1, generator=g, device=cuda_device) * scale
        return flat.to(dtype)[1:].view(n, hh, ww, c).permute(0, 3, 1, 2)

    x, wt = shifted(bsz, cin, h, w), shifted(cout, cin, 3, 3, scale=0.1)
    assert x.data_ptr() % 16 != 0 and wt.data_ptr() % 16 != 0
    out = conv_mod.conv3x3(x, wt)
    assert _rel(out, conv_mod.conv3x3_plain(x, wt)) <= tol


@pytest.mark.cuda
def test_cuda_conv3x3_split_k_is_deterministic(cuda_device):
    """The split-K path (a cluster at 2x16²x1280) reduces in a fixed order:
    two runs give the same bits."""
    plan = conv_mod.conv_plan(2, 16, 16, 1280, 1280, conv_mod.card_capacity(cuda_device, 160))
    assert plan.splits > 1
    g = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn((2, 1280, 16, 16), generator=g, device=cuda_device).to(torch.bfloat16)
    wt = (torch.randn((1280, 1280, 3, 3), generator=g, device=cuda_device) * 0.05).to(
        torch.bfloat16)
    first = conv_mod.conv3x3(x, wt)
    second = conv_mod.conv3x3(x, wt)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c", sorted(LN_WIDTHS))
@pytest.mark.parametrize("rows", [1, 3, 1000])
def test_cuda_layer_norm_register_kernel(cuda_device, dtype, c, rows):
    """Every width of the register kernel's table, at 1 and 3 rows (sub-warps
    with no row) and at 1000 rows (not a multiple of the rows per block)."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    x = (torch.randn((rows, c), generator=g, device=cuda_device) * 2 + 0.5).to(dtype)
    w = torch.randn((c,), generator=g, device=cuda_device).to(dtype)
    b = torch.randn((c,), generator=g, device=cuda_device).to(dtype)
    ln_mod.reset_launch_count()
    out = ln_mod.layer_norm(x, w, b)
    ref = ln_mod.layer_norm_plain(x, w, b)
    torch.cuda.synchronize()
    assert ln_mod.launch_count() == 1
    diff = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert diff.max().item() <= 1e-4
    else:
        mag = torch.maximum(out.float().abs(), ref.float().abs()).cpu().numpy()
        assert (diff.cpu().numpy() <= _bf16_ulp(mag) + 2e-5).all(), diff.max().item()
