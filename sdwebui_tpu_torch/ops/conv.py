"""3×3 stride-1 pad-1 convolution: the hand-written Hopper kernel and its
plain version.

Port of B4, ``conv3x3`` (``sdwebui_tpu/ops/conv.py:75-121``, kernel body
``:43-56``): nine shifted (pixels, Cin) @ (Cin, Cout) products accumulated
in fp32, plus the optional bias, cast once to x's dtype.  As in the JAX
package it is a standalone op wired into no model: ``models/layers.conv2d``
stays ``F.conv2d``.  How it compares with the library convolution at the
UNet's shapes is in ``PERF.md`` §6.

The entry point takes the port's idiom, NCHW tensors and OIHW weights; the
kernels of ``csrc/conv3x3.cu`` read both channels-last, so an activation
that already lives channels-last (as the port's do) and a channels-last
weight (as ``models/layers`` stores them) are read in place.  bf16 takes the
wgmma + TMA kernel under the launch plan of :func:`conv_plan`, f32 the
exact-FMA kernel.  Both load 16-byte rows: where Cin is not a multiple of 8
(bf16) or 4 (f32) the channels of x and the weight are zero-padded with one
copy each, and an x or weight whose base is not 16-byte aligned is copied.  On a CUDA tensor :func:`conv3x3` launches a kernel or
raises; on a CPU tensor it computes :func:`conv3x3_plain` (``F.conv2d``).
The TPU arguments ``block_rows`` and ``interpret`` have no counterpart.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from sdwebui_tpu_torch.ops import _build, refuse_autograd

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_launches = 0

#: the output rectangles (TW, TH) of the bf16 kernel: 128 pixels of one image
RECTS = ((64, 2), (32, 4), (16, 8))
#: output channels per block (wgmma's N) the kernel is built for
BN_CHOICES = (32, 64, 96, 128, 160, 192, 256)
#: the most k-step splits: one cluster of blocks, at most 8 (portable size)
MAX_SPLITS = 8
CHUNK = 64   # input channels per k-step (one 128-byte TMA box row)


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


# ---- the bf16 kernel's launch plan -----------------------------------------

class ConvPlan(NamedTuple):
    tw: int          # output rectangle: tw x th pixels of one image
    th: int
    bn: int          # output channels per block
    splits: int      # k-step ranges, one block each, in one cluster
    cin: int         # input channels as the kernel reads them (padded to 8)
    ksteps: int      # 9 taps x ceil(cin / 64) channel chunks
    grid: tuple      # (splits, N tiles, M tiles)
    cluster: int     # blocks per cluster (1: none)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def conv_rect(h: int, w: int) -> tuple:
    """The rectangle with the fewest tiles over an h × w image, the wider on
    a tie: W = 64 → 64×2, 32 → 32×4, 16 → 16×8; other widths pad the
    fewest pixels (those past the image are masked at the store)."""
    return min(RECTS, key=lambda r: _cdiv(w, r[0]) * _cdiv(h, r[1]))


def conv_bn(cout: int) -> int:
    """160 where it divides Cout (SD's 320, 640, 1280: no channel wasted),
    else the choice that wastes the fewest channels, the wider on a tie."""
    if cout % 160 == 0:
        return 160
    return min(BN_CHOICES, key=lambda bn: (_cdiv(cout, bn) * bn - cout, -bn))


#: a block's fixed cost beyond its k-steps, in k-steps' time: the epilogue,
#: and the reduction of a split (its dump, two cluster barriers and the
#: remote reads; from the split sweep of tools/norms_conv_probe_cuda.py)
EPILOGUE_STEPS = 2
REDUCE_STEPS = 20


def conv_splits(tiles: int, ksteps: int, capacity) -> int:
    """k-step splits for `tiles` output tiles, where capacity[s - 1] clusters
    of s blocks fit on the card at once (the card's own count: a cluster's
    blocks share one GPC, so wide clusters fit fewer times than SMs / s).
    The split with the least modelled time: waves of clusters × (k-steps a
    block + its fixed cost), the fewer splits on a tie."""
    def cost(s):
        fixed = EPILOGUE_STEPS + (REDUCE_STEPS if s > 1 else 0)
        return _cdiv(tiles, capacity[s - 1]) * (_cdiv(ksteps, s) + fixed)

    return min(range(1, min(MAX_SPLITS, ksteps) + 1), key=lambda s: (cost(s), s))


def conv_plan(batch: int, h: int, w: int, cin: int, cout: int, capacity) -> ConvPlan:
    """The bf16 kernel's launch at these shapes on a card holding
    capacity[s - 1] clusters of s blocks at once (:func:`card_capacity`)."""
    tw, th = conv_rect(h, w)
    bn = conv_bn(cout)
    cin_k = _cdiv(cin, 8) * 8
    ksteps = 9 * _cdiv(cin_k, CHUNK)
    m_tiles = batch * _cdiv(h, th) * _cdiv(w, tw)
    n_tiles = _cdiv(cout, bn)
    splits = conv_splits(m_tiles * n_tiles, ksteps, capacity)
    return ConvPlan(tw, th, bn, splits, cin_k, ksteps, (splits, n_tiles, m_tiles), splits)


# ---- the CUDA call ----------------------------------------------------------

_fn = None
_clusters = None
_capacity: dict = {}   # (device index, bn) -> capacity tuple


def _bind():
    global _fn, _clusters
    lib = _build.load_library("conv3x3")
    fn = lib.sdtpu_conv3x3
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _clusters = lib.sdtpu_conv3x3_clusters
    _clusters.argtypes = [ctypes.c_int, ctypes.c_int]
    _clusters.restype = ctypes.c_int
    _fn = fn
    return fn


def card_capacity(device, bn: int) -> tuple:
    """capacity[s - 1]: clusters of s blocks of the bf16 kernel at N tile
    `bn` that `device` holds at once (cudaOccupancyMaxActiveClusters)."""
    key = (device.index, bn)
    cap = _capacity.get(key)
    if cap is None:
        _fn or _bind()
        with torch.cuda.device(device):
            cap = tuple(_clusters(bn, s) for s in range(1, MAX_SPLITS + 1))
        if min(cap) < 1:
            raise RuntimeError(f"conv3x3 occupancy query failed: {cap}")
        _capacity[key] = cap
    return cap


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


def _channels_last(t, cin_k: int):
    """t (N, C, H, W) as the contiguous (N, H, W, cin_k) the kernels read:
    a view where t lives channels-last with a 16-byte aligned base, else one
    copy (zero-padding C to cin_k where it falls short)."""
    v = t.permute(0, 2, 3, 1)
    if cin_k != t.shape[1]:
        return F.pad(v, (0, cin_k - t.shape[1])).contiguous()
    v = v.contiguous()
    return v if v.data_ptr() % 16 == 0 else v.clone()


def conv3x3(x, weight, bias=None):
    """x (B, Cin, H, W), weight (Cout, Cin, 3, 3), bias (Cout,) or None →
    (B, Cout, H, W) in x's dtype, channels-last in memory."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, weight, bias)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3 has no kernel for {x.device}")
    refuse_autograd("conv3x3", x, weight, bias)
    _check(x, weight, bias)
    bsz, cin, h, w = x.shape
    cout = weight.shape[0]
    out = torch.empty((bsz, cout, h, w), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    weight = weight.to(x.dtype)
    b = bias.to(x.dtype).contiguous() if bias is not None else None
    if x.dtype == torch.bfloat16:
        plan = conv_plan(bsz, h, w, cin, cout, card_capacity(x.device, conv_bn(cout)))
        cin_k, geometry = plan.cin, (plan.tw, plan.th, plan.bn, plan.splits)
    else:
        cin_k, geometry = _cdiv(cin, 4) * 4, (0, 0, 0, 1)   # 16-byte rows of 4 channels
    xk, wk = _channels_last(x, cin_k), _channels_last(weight, cin_k)
    fn = _fn or _bind()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(xk.data_ptr(), wk.data_ptr(), 0 if b is None else b.data_ptr(),
                 out.data_ptr(), _DTYPES[x.dtype], bsz, h, w, cin_k, cout, *geometry, stream)
    if err != 0:
        raise RuntimeError(f"conv3x3 kernel launch failed: CUDA error {err}")
    global _launches
    _launches += 1
    return out
