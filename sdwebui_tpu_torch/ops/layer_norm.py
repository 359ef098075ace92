"""LayerNorm over the last dim: the hand-written Hopper kernel and its
plain version.

Port of B5, ``layer_norm_pallas`` (``sdwebui_tpu/ops/pallas_norms.py:65``,
kernel body ``:27-35``): mean = Σx/C and var = Σx²/C − mean² in fp32 (one
pass, not Welford), rstd = rsqrt(var + eps), out = (x − mean)·rstd·w + b in
fp32, cast once to x's dtype; ``weight`` and ``bias`` are optional (1 and
0).  On a CUDA tensor :func:`layer_norm` launches a kernel of
``csrc/layer_norm.cu`` (built with nvcc at first use, see ``ops/_build.py``)
or raises: the register kernel at the lanes and chunks :func:`ln_plan`
picks from C, or the loop kernel for rows it does not cover.  The wrapper
is kept thin, since every transformer block calls it three times: the C
function is looked up once, the device guard is skipped when x lies on the
current device, and the stream is read raw.  On a CPU tensor it computes
:func:`layer_norm_plain`, which is also what tests and ``chip_smoke.py``
hold the kernels against.  The TPU arguments ``block_rows`` and
``interpret`` have no counterpart.

Numerics against the JAX main path: ``sdwebui_tpu/ops/norms.layer_norm``
(:79-93) folds the affine into ``x * scale + shift`` with scale and shift
rounded to x's dtype, so in bf16 it rounds three times where this rounds
once; in f32 the two agree to ~1e-6.
"""

from __future__ import annotations

import ctypes

import torch

from sdwebui_tpu_torch.ops import _build, refuse_autograd

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_launches = 0


def launch_count() -> int:
    """Kernel launches since the last reset."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def layer_norm_plain(x, weight=None, bias=None, eps: float = 1e-5):
    """The kernel's math in torch ops: fp32 one-pass statistics and affine,
    one cast to x's dtype."""
    c = x.shape[-1]
    xf = x.float()
    mean = xf.sum(-1, keepdim=True) / c
    var = (xf * xf).sum(-1, keepdim=True) / c - mean * mean
    out = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


#: the most 16-byte chunks a lane of the register kernel holds, and the
#: longer rows of f32 (64 values a lane, as 8 chunks of bf16) at 32 lanes
MAX_CHUNKS = 8
F32_WIDE_CHUNKS = (10, 12, 16)


def ln_plan(c: int, itemsize: int, aligned: bool = True) -> tuple:
    """(lanes, chunks) of the register kernel for rows of `c` elements of
    `itemsize` bytes: the fewest lanes per row (8, 16, 32) whose lanes hold
    the row in at most MAX_CHUNKS 16-byte chunks each (C = 320 bf16: 8 × 5,
    640: 16 × 5, 768: 16 × 6, 1280: 32 × 5, 1536: 32 × 6); f32 rows of
    1025-2048 take 32 lanes of 10, 12 or 16 chunks.  (0, 0), the loop
    kernel, where the row does not split into 16-byte chunks (C or the row
    stride, or a base, not 16-byte aligned: ``aligned`` False) or is wider
    than 2048."""
    per = 16 // itemsize
    if not aligned or c % per:
        return 0, 0
    n = c // per
    for lanes in (8, 16, 32):
        if n <= lanes * MAX_CHUNKS:
            return lanes, -(-n // lanes)
    if itemsize == 4:
        wide = [k for k in F32_WIDE_CHUNKS if n <= 32 * k]
        if wide:
            return 32, wide[0]
    return 0, 0


_fn = None
_raw_stream = None
_plans: dict = {}   # (C, dtype) -> ln_plan for aligned rows


def _bind():
    """Look the C function up once (the build runs at the first call)."""
    global _fn, _raw_stream
    fn = _build.load_library("layer_norm").sdtpu_layer_norm
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                   + [ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                      ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _raw_stream = torch._C._cuda_getCurrentRawStream
    _fn = fn
    return fn


def _check(x, weight, bias) -> int:
    """Raise on what the kernel does not take; returns the code of the
    weight and bias dtype (f32 when both are absent)."""
    if weight is None and bias is None:
        return 1
    if weight is not None and bias is not None and weight.dtype != bias.dtype:
        raise TypeError("weight and bias must share one dtype, bf16 or f32")
    w_dtype = _DTYPES.get((weight if weight is not None else bias).dtype)
    if w_dtype is None:
        raise TypeError("weight and bias must share one dtype, bf16 or f32")
    c = x.shape[-1]
    dev = x.get_device()
    for name, t in (("weight", weight), ("bias", bias)):
        if t is None:
            continue
        if t.get_device() != dev:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dim() != 1 or t.shape[0] != c or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({c},) vector")
    return w_dtype


def layer_norm(x, weight=None, bias=None, eps: float = 1e-5):
    """LayerNorm over the last dim of any (…, C) tensor; returns a
    contiguous tensor of x's shape and dtype."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return layer_norm_plain(x, weight, bias, eps)
        raise ValueError(f"layer_norm has no kernel for {x.device}")
    refuse_autograd("layer_norm", x, weight, bias)
    dtype = _DTYPES.get(x.dtype)
    if dtype is None:
        raise TypeError(f"layer_norm takes bf16 or f32, got {x.dtype}")
    w_dtype = _check(x, weight, bias)
    c = x.shape[-1]
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    rows = out.numel() // c if c else 0
    if rows == 0:
        return out
    if x.is_contiguous():
        x2, stride = x, c
    else:
        x2 = x.reshape(rows, c)          # a view whenever the rows share one stride
        if x2.stride(1) != 1:
            x2 = x2.contiguous()
        stride = x2.stride(0)
    xp = x2.data_ptr()
    wp = 0 if weight is None else weight.data_ptr()
    bp = 0 if bias is None else bias.data_ptr()
    plan = _plans.get((c, dtype))
    if plan is None:
        plan = _plans[(c, dtype)] = ln_plan(c, x.element_size())
    if (xp | wp | bp | stride * x.element_size()) % 16:
        plan = (0, 0)
    fn = _fn or _bind()
    dev = x.get_device()
    if dev == torch._C._cuda_getDevice():
        err = fn(xp, wp, bp, out.data_ptr(), dtype, w_dtype, rows, c, stride, c, eps, *plan,
                 _raw_stream(dev))
    else:
        with torch.cuda.device(dev):
            err = fn(xp, wp, bp, out.data_ptr(), dtype, w_dtype, rows, c, stride, c, eps, *plan,
                     _raw_stream(dev))
    if err != 0:
        raise RuntimeError(f"layer_norm kernel launch failed: CUDA error {err}")
    global _launches
    _launches += 1
    return out
