"""Primitive layers: plain functions on NCHW tensors and the parameter
holders the models are built from.

Port of ``sdwebui_tpu/models/layers.py``.  Parameters keep the torch
checkpoint layout (conv OIHW, linear (out, in)), so ldm state dicts load
with ``load_state_dict`` and no transposes.  Weights are cast to the
activation dtype at use, as the JAX code does; random init draws from an
explicit ``torch.Generator`` with the distributions of
``sdwebui_tpu/models/init_utils.HostInit``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from sdwebui_tpu_torch.ops.norms import group_norm, layer_norm


def conv2d(x, weight, bias=None, stride: int = 1, padding: int = 1,
           circular: bool = False):
    """circular=True wraps the padding (seamless tiling) — an argument here,
    not a patched module (reference modules/sd_hijack.py:311)."""
    if circular and padding > 0:
        x = F.pad(x, (padding,) * 4, mode="circular")
        padding = 0
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
    def __init__(self, cin, cout, kernel: int, stride: int = 1,
                 padding: int | None = None, bias: bool = True, *, device, dtype):
        super().__init__()
        self.weight = _param((cout, cin, kernel, kernel), device, dtype)
        self.bias = _param((cout,), device, dtype) if bias else None
        self.stride = stride
        self.padding = kernel // 2 if padding is None else padding

    def forward(self, x, circular: bool = False):
        return conv2d(x, self.weight, self.bias, self.stride, self.padding,
                      circular)

    @torch.no_grad()
    def reset_random(self, gen):
        cout, cin, kh, kw = self.weight.shape
        _normal_(self.weight, 1.0 / math.sqrt(kh * kw * cin), gen)
        if self.bias is not None:
            self.bias.zero_()


class Linear(nn.Module):
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
