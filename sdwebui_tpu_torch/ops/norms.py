"""GroupNorm(+SiLU) and LayerNorm with one-pass fp32 statistics (NCHW).

Port of ``sdwebui_tpu/ops/norms.py:22-108``.  GroupNorm: (Σx, Σx²) in fp32
in one pass, then the per-channel affine folded to ``x * scale + shift``
with scale and shift cast to the input dtype, so bf16 rounds where the JAX
code rounds.  LayerNorm dispatches to B5 (``ops/layer_norm.py``): the
kernel for CUDA tensors, its plain version on the CPU, or the plain version
everywhere inside :func:`forced_plain` (the yardstick arm of a comparison).
Under ``parallel.collectives.spatial_sharding`` GroupNorm's (Σx, Σx²) and
its count sum over the row shards (``norms.py:30-58``).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from sdwebui_tpu_torch.ops import layer_norm as _ln
from sdwebui_tpu_torch.parallel import collectives

_PLAIN = False


def group_norm(x, weight, bias, num_groups: int = 32, eps: float = 1e-5,
               silu: bool = False):
    """x: (B, C, ...) channels-first; weight/bias: (C,).  Stats in fp32 over
    all but the batch dim, per channel group."""
    b, c = x.shape[:2]
    g = num_groups
    xf = x.float()
    red = tuple(range(2, x.dim()))
    s1 = xf.sum(dim=red)                     # (B, C)
    s2 = (xf * xf).sum(dim=red)
    n_spatial = 1
    for a in red:
        n_spatial *= x.shape[a]
    axis = collectives.spatial_axis()
    if axis is not None:
        s1, s2 = collectives.psum(torch.stack([s1, s2]), axis).unbind(0)
        n_spatial *= collectives.axis_size(axis)
    cnt = n_spatial * (c // g)
    mean_g = s1.reshape(b, g, c // g).sum(-1) / cnt
    var_g = s2.reshape(b, g, c // g).sum(-1) / cnt - mean_g * mean_g
    rstd_g = torch.rsqrt(var_g + eps)
    mean_c = mean_g.repeat_interleave(c // g, dim=-1)
    rstd_c = rstd_g.repeat_interleave(c // g, dim=-1)
    wf = weight.float()
    shape = (b, c) + (1,) * (x.dim() - 2)
    scale = (rstd_c * wf).to(x.dtype).reshape(shape)
    shift = (bias.float() - mean_c * rstd_c * wf).to(x.dtype).reshape(shape)
    out = x * scale + shift
    return F.silu(out) if silu else out


@contextlib.contextmanager
def forced_plain():
    """Run every LayerNorm inside the block through the plain version."""
    global _PLAIN
    prev = _PLAIN
    _PLAIN = True
    try:
        yield
    finally:
        _PLAIN = prev


def layer_norm(x, weight=None, bias=None, eps: float = 1e-5):
    """LayerNorm over the last dim with one-pass fp32 stats (B5)."""
    if _PLAIN:
        return _ln.layer_norm_plain(x, weight, bias, eps)
    return _ln.layer_norm(x, weight, bias, eps)
