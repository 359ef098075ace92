"""3×3 stride-1 pad-1 convolution: the hand-written Hopper kernel and its
plain version.

Port of B4, ``conv3x3`` (``sdwebui_tpu/ops/conv.py:75-121``, kernel body
``:43-56``): nine shifted (pixels, Cin) @ (Cin, Cout) products accumulated
in fp32, plus the optional bias, cast once to x's dtype.  As in the JAX
package it is a standalone op, slower than the library convolution and
wired into no model: ``models/layers.conv2d`` stays ``F.conv2d``.

The entry point takes the port's idiom, NCHW tensors and OIHW weights; the
kernel of ``csrc/conv3x3.cu`` reads both channels-last, so an activation
that already lives channels-last (as the port's do) and a channels-last
weight (as ``models/layers`` stores them) are read in place.  On a CUDA
tensor :func:`conv3x3` launches the kernel or raises; on a CPU tensor it
computes :func:`conv3x3_plain` (``F.conv2d``).  The TPU arguments
``block_rows`` and ``interpret`` have no counterpart.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from sdwebui_tpu_torch.ops import _build

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_launches = 0


def launch_count() -> int:
    """Kernel launches since the last reset."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def conv3x3_plain(x, weight, bias=None):
    """x (B, Cin, H, W), weight (Cout, Cin, 3, 3) → (B, Cout, H, W)."""
    b = bias.to(x.dtype) if bias is not None else None
    return F.conv2d(x, weight.to(x.dtype), b, 1, 1)


def _lib():
    fn = _build.load_library("conv3x3").sdtpu_conv3x3
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(x, weight, bias):
    if x.dim() != 4 or weight.dim() != 4 or tuple(weight.shape[2:]) != (3, 3):
        raise ValueError(f"conv3x3 takes x (B, Cin, H, W) and weight (Cout, Cin, 3, 3), "
                         f"got {tuple(x.shape)} and {tuple(weight.shape)}")
    if weight.shape[1] != x.shape[1]:
        raise ValueError(f"weight takes {weight.shape[1]} input channels, x has {x.shape[1]}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"conv3x3 takes bf16 or f32, got {x.dtype}")
    if bias is not None and bias.shape != (weight.shape[0],):
        raise ValueError(f"bias must be ({weight.shape[0]},), got {tuple(bias.shape)}")
    for name, t in (("weight", weight), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def conv3x3(x, weight, bias=None):
    """x (B, Cin, H, W), weight (Cout, Cin, 3, 3), bias (Cout,) or None →
    (B, Cout, H, W) in x's dtype, channels-last in memory."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, weight, bias)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3 has no kernel for {x.device}")
    _check(x, weight, bias)
    bsz, cin, h, w = x.shape
    cout = weight.shape[0]
    cl = torch.channels_last
    x_cl = x.contiguous(memory_format=cl)                   # (B, H, W, Cin) in memory
    w_cl = weight.to(x.dtype).contiguous(memory_format=cl)  # (Cout, 3, 3, Cin) in memory
    b = bias.to(x.dtype).contiguous() if bias is not None else None
    out = torch.empty((bsz, cout, h, w), dtype=x.dtype, device=x.device, memory_format=cl)
    if out.numel() == 0:
        return out
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x_cl.data_ptr(), w_cl.data_ptr(), 0 if b is None else b.data_ptr(),
                 out.data_ptr(), _DTYPES[x.dtype], bsz, h, w, cin, cout, stream)
    if err != 0:
        raise RuntimeError(f"conv3x3 kernel launch failed: CUDA error {err}")
    global _launches
    _launches += 1
    return out
