"""Flash attention: the hand-written Hopper kernel and its plain version.

Port of the TPU kernel ``sdwebui_tpu/ops/flash_attention.py:111``
(``flash_attention``) with the same public signature over ``(BH, S, D)``
tensors.  On a CUDA tensor the wrapper launches the CUDA kernel in
``csrc/flash_attention.cu`` (built with nvcc at first use, see
``ops/_build.py``) or raises; on a CPU tensor it computes the plain
version below, which is also what tests and ``chip_smoke.py`` hold the
kernel against.
"""

from __future__ import annotations

import ctypes
import math

import torch

from sdwebui_tpu_torch.ops import _build

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_launches = 0


def launch_count() -> int:
    """Kernel launches made by :func:`flash_attention` since the last reset."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def flash_attention_plain(q, k, v, scale=None):
    """softmax(q kᵀ · scale) v with explicit matmuls: fp32 scores and
    softmax, p cast to v's dtype, p·v accumulated in fp32, out in q's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def _lib():
    lib = _build.load_library("flash_attention")
    fn = lib.sdtpu_flash_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_int64] * 12 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(q, k, v):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash_attention takes (BH, S, D) tensors")
    bh, _, d = q.shape
    if k.shape[0] != bh or v.shape[0] != bh or k.shape[2] != d \
            or v.shape[2] != d or k.shape[1] != v.shape[1]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention takes bf16 or f32, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if d > 512 or d % 8 != 0:
        raise ValueError(f"head dim {d} unsupported (multiple of 8, <= 512)")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")


def flash_attention(q, k, v, scale=None):
    """Softmax(q kᵀ · scale) v over (BH, S, D) tensors.

    q: (BH, Sq, D); k, v: (BH, Skv, D).  Returns (BH, Sq, D) in q's dtype.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention has no kernel for {q.device}")
    _check(q, k, v)
    global _launches
    bh, sq, d = q.shape
    skv = k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    out = torch.empty((bh, sq, d), dtype=q.dtype, device=q.device)
    fn = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _DTYPES[q.dtype], bh, 1, sq, skv, d,
                 q.stride(0), 0, q.stride(1),
                 k.stride(0), 0, k.stride(1),
                 v.stride(0), 0, v.stride(1),
                 out.stride(0), 0, out.stride(1),
                 float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    _launches += 1
    return out
