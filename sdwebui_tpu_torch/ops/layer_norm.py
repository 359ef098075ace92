"""LayerNorm over the last dim: the hand-written Hopper kernel and its
plain version.

Port of B5, ``layer_norm_pallas`` (``sdwebui_tpu/ops/pallas_norms.py:65``,
kernel body ``:27-35``): mean = Σx/C and var = Σx²/C − mean² in fp32 (one
pass, not Welford), rstd = rsqrt(var + eps), out = (x − mean)·rstd·w + b in
fp32, cast once to x's dtype; ``weight`` and ``bias`` are optional (1 and
0).  On a CUDA tensor :func:`layer_norm` launches the kernel of
``csrc/layer_norm.cu`` (built with nvcc at first use, see ``ops/_build.py``)
or raises; on a CPU tensor it computes :func:`layer_norm_plain`, which is
also what tests and ``chip_smoke.py`` hold the kernel against.  The TPU
arguments ``block_rows`` and ``interpret`` have no counterpart.

Numerics against the JAX main path: ``sdwebui_tpu/ops/norms.layer_norm``
(:79-93) folds the affine into ``x * scale + shift`` with scale and shift
rounded to x's dtype, so in bf16 it rounds three times where this rounds
once; in f32 the two agree to ~1e-6.
"""

from __future__ import annotations

import ctypes

import torch

from sdwebui_tpu_torch.ops import _build

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


def _lib():
    fn = _build.load_library("layer_norm").sdtpu_layer_norm
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                       + [ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                          ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(x, weight, bias):
    if x.dtype not in _DTYPES:
        raise TypeError(f"layer_norm takes bf16 or f32, got {x.dtype}")
    params = [t for t in (weight, bias) if t is not None]
    if len({t.dtype for t in params}) > 1 or any(t.dtype not in _DTYPES for t in params):
        raise TypeError("weight and bias must share one dtype, bf16 or f32")
    for name, t in (("weight", weight), ("bias", bias)):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.shape != (x.shape[-1],) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({x.shape[-1]},) vector")


def layer_norm(x, weight=None, bias=None, eps: float = 1e-5):
    """LayerNorm over the last dim of any (…, C) tensor; returns a
    contiguous tensor of x's shape and dtype."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, weight, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"layer_norm has no kernel for {x.device}")
    _check(x, weight, bias)
    c = x.shape[-1]
    rows = x.numel() // c if c else 0
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if rows == 0:
        return out
    x2 = x.reshape(rows, c)          # a view whenever the rows share one stride
    if x2.stride(1) != 1:
        x2 = x2.contiguous()
    params = [t for t in (weight, bias) if t is not None]
    w_dtype = _DTYPES[params[0].dtype] if params else 1
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x2.data_ptr(), 0 if weight is None else weight.data_ptr(),
                 0 if bias is None else bias.data_ptr(), out.data_ptr(),
                 _DTYPES[x.dtype], w_dtype, rows, c, x2.stride(0), c, float(eps), stream)
    if err != 0:
        raise RuntimeError(f"layer_norm kernel launch failed: CUDA error {err}")
    global _launches
    _launches += 1
    return out
