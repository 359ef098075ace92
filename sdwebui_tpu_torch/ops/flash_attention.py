"""Flash attention: the hand-written Hopper kernel and its plain versions.

Ports of the three TPU kernels of ``sdwebui_tpu/ops/flash_attention.py``,
each with the same math and one entry point per layout:

    flash_attention         (BH, S, D)       B1, ``flash_attention.py:111``
    flash_attention_packed  (B, S, H·D)      B2, ``flash_attention.py:308``
    flash_attention_4d      (B, S, H, D)     B3, ``flash_attention.py:429``

On a CUDA tensor each wrapper launches a kernel of
``csrc/flash_attention.cu`` (built with nvcc at first use, see
``ops/_build.py``) or raises: bf16 with d <= 128 takes the wgmma + TMA
kernel, bf16 with larger d (the VAE's 512-wide head) the split-d wgmma
kernel, f32 the exact-FMA kernel.  The kernels read q, k and v through
batch, head and sequence strides, so B2 and B3 are launches with
``heads = H`` and no head split or merge copy: q, k and v may be the
``chunk`` views of a fused qkv projection as they are.  TMA (bf16) and the
16-byte loads (f32) need a 16-byte aligned base and strides that are
multiples of 16 bytes; an operand that breaks this is first copied with
``.contiguous()`` (no path tensor does).  On a CPU tensor each wrapper
computes its plain version below, which is also what tests and
``chip_smoke.py`` hold the kernels against.  The TPU tiling arguments
(``block_q``, ``block_kv``, ``interpret``) and the 128-lane head-packing
rule have no counterpart here.
"""

from __future__ import annotations

import ctypes
import math

import torch

from sdwebui_tpu_torch.ops import _build, refuse_autograd

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
ENTRY_POINTS = ("flash_attention", "flash_attention_packed", "flash_attention_4d")
_launches = dict.fromkeys(ENTRY_POINTS, 0)


def launch_count(name: str = "flash_attention") -> int:
    """Kernel launches made by the entry point `name` since the last reset."""
    return _launches[name]


def reset_launch_count() -> None:
    """Set every entry point's launch count to 0."""
    for name in _launches:
        _launches[name] = 0


def flash_attention_plain(q, k, v, scale=None):
    """softmax(q kᵀ · scale) v with explicit matmuls over the last two dims:
    fp32 scores and softmax, p cast to v's dtype, p·v accumulated in fp32,
    out in q's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def flash_attention_packed_plain(q, k, v, *, num_heads: int, scale=None):
    """The plain version of :func:`flash_attention_packed`: per-head views
    of the (B, S, H·D) tensors through :func:`flash_attention_plain`."""
    b, sq, hd = q.shape
    d = hd // num_heads

    def heads(t):   # (B, S, H·D) → (B, H, S, D) view
        return t.unflatten(-1, (num_heads, d)).transpose(1, 2)

    out = flash_attention_plain(heads(q), heads(k), heads(v), scale)
    return out.transpose(1, 2).reshape(b, sq, hd)


def flash_attention_4d_plain(q, k, v, *, scale=None):
    """The plain version of :func:`flash_attention_4d` over (B, S, H, D)."""
    out = flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), scale)
    return out.transpose(1, 2).contiguous()


def _lib():
    lib = _build.load_library("flash_attention")
    fn = lib.sdtpu_flash_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_int64] * 12 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_args(q, k, v, d: int):
    """What every layout shares: dtype, device, head dim, contiguous last dim."""
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"flash attention takes bf16 or f32, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if d > 512 or d % 8 != 0:
        raise ValueError(f"head dim {d} unsupported (multiple of 8, <= 512)")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")


def _check_shapes(q, k, v, rank: int, layout: str):
    if q.dim() != rank or k.dim() != rank or v.dim() != rank:
        raise ValueError(f"this entry point takes {layout} tensors")
    # q and k/v share every dim but the sequence (dim 1); k and v match
    if (k.shape != v.shape or q.shape[0] != k.shape[0]
            or q.shape[2:] != k.shape[2:]):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")


def _check(q, k, v):
    """B1's checks over (BH, S, D)."""
    _check_shapes(q, k, v, 3, "(BH, S, D)")
    _check_args(q, k, v, q.shape[2])


def _check_packed(q, k, v, num_heads: int):
    _check_shapes(q, k, v, 3, "(B, S, H·D)")
    if num_heads < 1 or q.shape[2] % num_heads != 0:
        raise ValueError(f"width {q.shape[2]} is not a multiple of {num_heads} heads")
    _check_args(q, k, v, q.shape[2] // num_heads)


def _check_4d(q, k, v):
    _check_shapes(q, k, v, 4, "(B, S, H, D)")
    _check_args(q, k, v, q.shape[3])


def _on_cuda(q, name: str) -> bool:
    """False for a CPU tensor (the plain version runs); True for CUDA."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{name} has no kernel for {q.device}")
    return True


def _on_cuda_no_grad(name: str, q, k, v) -> bool:
    """_on_cuda, and on CUDA no operand that requires grad."""
    if not _on_cuda(q, name):
        return False
    refuse_autograd(name, q, k, v)
    return True


def _aligned16(t) -> bool:
    """TMA's (and the 16-byte loads') rule: a 16-byte aligned base and every
    stride of a dim longer than 1 a positive multiple of 16 bytes."""
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        n == 1 or (st > 0 and st * size % 16 == 0)
        for n, st in zip(t.shape[:-1], t.stride()[:-1]))


def _operands(q, k, v):
    """q, k, v as the kernel takes them: each that breaks the 16-byte rule
    is copied with ``.contiguous()``."""
    return tuple(t if _aligned16(t) else t.contiguous() for t in (q, k, v))


def _launch(name, q, k, v, out, batch, heads, head_dim, strides_of, scale):
    """One launch of the CUDA kernel; strides_of(t) gives the (batch, head,
    sequence) element strides of q, k, v and out."""
    if scale is None:
        scale = 1.0 / math.sqrt(head_dim)
    q, k, v = _operands(q, k, v)
    strides = [strides_of(t) for t in (q, k, v, out)]
    fn = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 _DTYPES[q.dtype], batch, heads, q.shape[1], k.shape[1], head_dim,
                 *(s for t in strides for s in t), float(scale), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    _launches[name] += 1
    return out


def flash_attention(q, k, v, scale=None):
    """Softmax(q kᵀ · scale) v over (BH, S, D) tensors.

    q: (BH, Sq, D); k, v: (BH, Skv, D).  Returns (BH, Sq, D) in q's dtype.
    """
    if not _on_cuda_no_grad("flash_attention", q, k, v):
        return flash_attention_plain(q, k, v, scale)
    _check(q, k, v)
    bh, sq, d = q.shape
    out = torch.empty((bh, sq, d), dtype=q.dtype, device=q.device)
    return _launch("flash_attention", q, k, v, out, bh, 1, d,
                   lambda t: (t.stride(0), 0, t.stride(1)), scale)


def flash_attention_packed(q, k, v, *, num_heads: int, scale=None):
    """Softmax(q kᵀ · scale) v per head over head-packed (B, S, H·D) tensors,
    as the qkv projections produce them.

    q: (B, Sq, H·D); k, v: (B, Skv, H·D), each with any row stride (the
    chunks of a fused (B, S, 3·H·D) projection included).  Head h is the
    column slice [h·D, (h+1)·D).  Returns a contiguous (B, Sq, H·D).
    """
    if not _on_cuda_no_grad("flash_attention_packed", q, k, v):
        return flash_attention_packed_plain(q, k, v, num_heads=num_heads, scale=scale)
    _check_packed(q, k, v, num_heads)
    b, sq, hd = q.shape
    d = hd // num_heads
    out = torch.empty((b, sq, hd), dtype=q.dtype, device=q.device)
    return _launch("flash_attention_packed", q, k, v, out, b, num_heads, d,
                   lambda t: (t.stride(0), d, t.stride(1)), scale)


def flash_attention_4d(q, k, v, *, scale=None):
    """Softmax(q kᵀ · scale) v per head over head-interleaved (B, S, H, D)
    tensors, read through their strides.  Returns a contiguous (B, Sq, H, D).
    """
    if not _on_cuda_no_grad("flash_attention_4d", q, k, v):
        return flash_attention_4d_plain(q, k, v, scale=scale)
    _check_4d(q, k, v)
    b, sq, h, d = q.shape
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    return _launch("flash_attention_4d", q, k, v, out, b, h, d,
                   lambda t: (t.stride(0), t.stride(2), t.stride(1)), scale)
