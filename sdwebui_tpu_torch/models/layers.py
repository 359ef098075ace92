"""Primitive layers: plain functions on NCHW tensors and the parameter
holders the models are built from.

Port of ``sdwebui_tpu/models/layers.py``.  Parameters keep the torch
checkpoint layout (conv OIHW, linear (out, in)), so ldm state dicts load
with ``load_state_dict`` and no transposes.  Weights are cast to the
activation dtype at use, as the JAX code does; random init draws from an
explicit ``torch.Generator`` with the distributions of
``sdwebui_tpu/models/init_utils.HostInit``.

Two mesh hooks (``sdwebui_tpu/models/layers.py:25-72``): inside
``parallel.collectives.spatial_sharding`` a tensor holds a row slice of
the image, and a stride-1 padded conv first takes the row above and the
row below from its neighbours (zeros at the image border, as the zero
padding); a ``Conv2d`` that ``parallel/sharding`` split over ``model``
computes its slice of the output channels and all-gathers it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from sdwebui_tpu_torch.ops.norms import group_norm, layer_norm
from sdwebui_tpu_torch.parallel import collectives


def conv2d(x, weight, bias=None, stride: int = 1, padding: int = 1,
           circular: bool = False):
    """circular=True wraps the padding (seamless tiling) — an argument here,
    not a patched module (reference modules/sd_hijack.py:311).  Under
    spatial sharding a stride-1 padded conv exchanges its halo rows."""
    if circular and padding > 0:
        x = F.pad(x, (padding,) * 4, mode="circular")
        padding = 0
    elif padding > 0 and stride == 1 and collectives.spatial_axis() is not None:
        above, below = collectives.halo_rows(x, collectives.spatial_axis(), padding)
        x = torch.cat([above, x, below], dim=2)
        padding = (0, padding)
    b = bias.to(x.dtype) if bias is not None else None
    return F.conv2d(x, weight.to(x.dtype), b, stride, padding)


def linear(x, weight, bias=None):
    b = bias.to(x.dtype) if bias is not None else None
    return F.linear(x, weight.to(x.dtype), b)


def timestep_embedding(timesteps, dim: int, max_period: int = 10000):
    """ldm sinusoidal embedding, cat([cos, sin]) over log-spaced freqs; fp32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def upsample_nearest_2x(x):
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


def _param(shape, device, dtype):
    # 4-D (conv) weights live channels-last: cuDNN's NHWC kernels then need
    # no layout conversion around each convolution
    fmt = torch.channels_last if len(shape) == 4 else torch.contiguous_format
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype, memory_format=fmt),
                        requires_grad=False)


def _normal_(p, std: float, gen: torch.Generator):
    p.copy_(torch.randn(p.shape, generator=gen, device=p.device,
                        dtype=torch.float32) * std)


class Conv2d(nn.Module):
    #: (rank, size) when this module holds model shard `rank`'s slice of
    #: the output channels (``parallel/sharding.shard_params``)
    model_shard = None

    def __init__(self, cin, cout, kernel: int, stride: int = 1,
                 padding: int | None = None, bias: bool = True, *, device, dtype):
        super().__init__()
        self.weight = _param((cout, cin, kernel, kernel), device, dtype)
        self.bias = _param((cout,), device, dtype) if bias else None
        self.stride = stride
        self.padding = kernel // 2 if padding is None else padding

    def forward(self, x, circular: bool = False):
        if self.model_shard is None:
            return conv2d(x, self.weight, self.bias, self.stride, self.padding, circular)
        rank, size = self.model_shard
        bias = None if self.bias is None else self.bias.chunk(size)[rank]
        out = conv2d(collectives.copy_to_model(x), self.weight, bias, self.stride,
                     self.padding, circular)
        return collectives.gather_from_model(out, dim=1)

    @torch.no_grad()
    def reset_random(self, gen):
        cout, cin, kh, kw = self.weight.shape
        _normal_(self.weight, 1.0 / math.sqrt(kh * kw * cin), gen)
        if self.bias is not None:
            self.bias.zero_()


class Linear(nn.Module):
    #: (rank, size) when split over ``model``; the module that holds it
    #: (an attention, a feed-forward) runs the collectives
    model_shard = None

    def __init__(self, cin, cout, bias: bool = True, *, device, dtype):
        super().__init__()
        self.weight = _param((cout, cin), device, dtype)
        self.bias = _param((cout,), device, dtype) if bias else None

    def forward(self, x):
        return linear(x, self.weight, self.bias)

    @torch.no_grad()
    def reset_random(self, gen):
        _normal_(self.weight, 1.0 / math.sqrt(self.weight.shape[1]), gen)
        if self.bias is not None:
            self.bias.zero_()


class GroupNorm(nn.Module):
    def __init__(self, c, num_groups: int = 32, eps: float = 1e-5, *,
                 device, dtype):
        super().__init__()
        self.weight = _param((c,), device, dtype)
        self.bias = _param((c,), device, dtype)
        self.num_groups = num_groups
        self.eps = eps

    def forward(self, x, silu: bool = False):
        return group_norm(x, self.weight, self.bias, self.num_groups,
                          self.eps, silu)

    @torch.no_grad()
    def reset_random(self, gen):
        self.weight.fill_(1.0)
        self.bias.zero_()


class LayerNorm(nn.Module):
    def __init__(self, c, eps: float = 1e-5, *, device, dtype):
        super().__init__()
        self.weight = _param((c,), device, dtype)
        self.bias = _param((c,), device, dtype)
        self.eps = eps

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)

    reset_random = GroupNorm.reset_random


class Embedding(nn.Module):
    def __init__(self, n, d, init_scale: float = 0.02, *, device, dtype):
        super().__init__()
        self.weight = _param((n, d), device, dtype)
        self.init_scale = init_scale

    def forward(self, ids):
        return self.weight[ids]

    @torch.no_grad()
    def reset_random(self, gen):
        _normal_(self.weight, self.init_scale, gen)


def reset_random(module: nn.Module, gen: torch.Generator) -> None:
    """Random weights for every layer of `module`, in registration order."""
    for m in module.modules():
        if isinstance(m, (Conv2d, Linear, GroupNorm, LayerNorm, Embedding)):
            m.reset_random(gen)


def assign_f32(module: nn.Module, sd: dict, device) -> nn.Module:
    """`module` with every parameter and buffer taken from `sd`, in float32
    on `device`: the keys must be the module's own, and each tensor is
    reshaped to its slot when only unit dims differ (a checkpoint's
    (1, C, 1, 1) bias in a (C,) slot, say).  The face nets load this way."""
    own = module.state_dict()
    if set(sd) != set(own):
        missing, extra = sorted(set(own) - set(sd)), sorted(set(sd) - set(own))
        raise ValueError(f"state dict does not fit {type(module).__name__}: "
                         f"missing {missing[:5]}, unexpected {extra[:5]}")
    out = {}
    for k, v in sd.items():
        v = torch.as_tensor(v)
        if v.numel() != own[k].numel():
            raise ValueError(f"{k}: shape {tuple(v.shape)}, expected {tuple(own[k].shape)}")
        out[k] = v.reshape(own[k].shape).to(device=device, dtype=torch.float32, copy=True)
    module.load_state_dict(out, assign=True)
    return module.eval()
