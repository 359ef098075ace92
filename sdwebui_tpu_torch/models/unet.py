"""Config-driven SD UNet (SD1.x, SDXL base and refiner) as an ``nn.Module``, NCHW.

Port of ``sdwebui_tpu/models/unet.py``.  Parameter names equal the
``model.diffusion_model.*`` state-dict keys with the prefix stripped:

    input_blocks.0.0          conv_in
    input_blocks.i.{0,1}      ResBlock [, SpatialTransformer] | Downsample
    middle_block.{0,1,2}      ResBlock, SpatialTransformer, ResBlock
    output_blocks.i.{0,1,2}   ResBlock [, SpatialTransformer] [, Upsample]
    out.{0,2}                 GroupNorm+SiLU, conv
    label_emb.0.{0,2}         SDXL: linear, SiLU, linear on the adm vector y

Self-attention runs through ``ops.attention`` (on CUDA the flash kernel
for the 4096- and 1024-token levels: per head for SD1.5's d = 40 and 80,
head-packed for SDXL's d = 64).

``forward(control=)`` adds ControlNet residuals as lllyasviel's cldm
``ControlledUnetModel`` does: the encoder runs without them, the middle
residual is added after the middle block, and each input residual joins
its skip at the decoder's concatenation (``hs.pop() + control.pop()``).
JAX's ``unet.apply`` adds each input residual to the encoder's running
state instead (``sdwebui_tpu/models/unet.py:318-323``), which only agrees
for the middle residual; that form is not carried over.
``forward(hypernet=)`` passes every attention's k/v context through a
hypernetwork's MLPs for its width (``networks/hypernetwork``);
``forward(tiling=True)`` wraps the padding of every 3×3 conv, the stride-2
downsample's too (seamless textures, ``unet.py:260-345``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sdwebui_tpu_torch.models.configs import UNetConfig
from sdwebui_tpu_torch.models.layers import (Conv2d, GroupNorm, LayerNorm,
                                             Linear, linear,
                                             timestep_embedding,
                                             upsample_nearest_2x)
from sdwebui_tpu_torch.ops.attention import attention


def build_plan(cfg: UNetConfig):
    """Returns (input_plan, middle_depth, output_plan, input_chs); a copy of
    the JAX package's ``build_plan`` (unet.py:39-86)."""
    depth = list(cfg.transformer_depth)
    while len(depth) < len(cfg.channel_mult):
        depth.append(depth[-1])

    input_plan = [[("conv_in", cfg.in_channels, cfg.model_channels)]]
    ch = cfg.model_channels
    input_chs = [ch]
    ds = 1
    for level, mult in enumerate(cfg.channel_mult):
        out_ch = cfg.model_channels * mult
        for _ in range(cfg.num_res_blocks):
            layers = [("res", ch, out_ch)]
            ch = out_ch
            if ds in cfg.attention_resolutions and depth[level] > 0:
                layers.append(("attn", ch, depth[level]))
            input_plan.append(layers)
            input_chs.append(ch)
        if level != len(cfg.channel_mult) - 1:
            input_plan.append([("down", ch)])
            input_chs.append(ch)
            ds *= 2

    if cfg.transformer_depth_middle >= 0:
        middle_depth = cfg.transformer_depth_middle
    else:
        middle_depth = depth[-1] if depth[-1] > 0 else 1

    output_plan = []
    chs = list(input_chs)
    for level in reversed(range(len(cfg.channel_mult))):
        out_ch = cfg.model_channels * cfg.channel_mult[level]
        for i in range(cfg.num_res_blocks + 1):
            skip = chs.pop()
            layers = [("res", ch + skip, out_ch)]
            ch = out_ch
            if ds in cfg.attention_resolutions and depth[level] > 0:
                layers.append(("attn", ch, depth[level]))
            if level > 0 and i == cfg.num_res_blocks:
                layers.append(("up", ch))
                ds //= 2
            output_plan.append(layers)
    return input_plan, middle_depth, output_plan, input_chs


def self_attention_calls(cfg: UNetConfig, latent: int, decoder: bool = True):
    """(tokens, heads, head_dim) of every self-attention one forward makes
    at a latent×latent input, in call order: the launch plan of the
    attention kernels.  decoder=False: the encoder and middle block only
    (a ControlNet tower's)."""
    input_plan, middle_depth, output_plan, _ = build_plan(cfg)
    middle = [("attn", cfg.model_channels * cfg.channel_mult[-1], middle_depth)]
    calls, res = [], latent
    for layer in [layer for plan in input_plan for layer in plan] + middle + \
            [layer for plan in (output_plan if decoder else []) for layer in plan]:
        if layer[0] == "down":
            res //= 2
        elif layer[0] == "up":
            res *= 2
        elif layer[0] == "attn":
            heads = cfg.heads_for(layer[1])
            calls += [(res * res, heads, layer[1] // heads)] * layer[2]
    return calls


class ResBlock(nn.Module):
    def __init__(self, cin, cout, emb_dim, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.in_layers = nn.Sequential(GroupNorm(cin, **kw), nn.SiLU(),
                                       Conv2d(cin, cout, 3, **kw))
        self.emb_layers = nn.Sequential(nn.SiLU(), Linear(emb_dim, cout, **kw))
        self.out_layers = nn.Sequential(GroupNorm(cout, **kw), nn.SiLU(),
                                        nn.Dropout(0.0), Conv2d(cout, cout, 3, **kw))
        self.skip_connection = Conv2d(cin, cout, 1, **kw) if cin != cout else None

    def forward(self, x, emb, circular: bool = False):
        h = self.in_layers[0](x, silu=True)
        h = self.in_layers[2](h, circular)
        e = self.emb_layers[1](F.silu(emb)).to(h.dtype)
        h = h + e[:, :, None, None]
        h = self.out_layers[0](h, silu=True)
        h = self.out_layers[3](h, circular)
        if self.skip_connection is not None:
            x = self.skip_connection(x)
        return x + h


class CrossAttention(nn.Module):
    def __init__(self, c, context_dim, heads, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.heads = heads
        self.to_q = Linear(c, c, bias=False, **kw)
        self.to_k = Linear(context_dim, c, bias=False, **kw)
        self.to_v = Linear(context_dim, c, bias=False, **kw)
        self.to_out = nn.Sequential(Linear(c, c, **kw), nn.Dropout(0.0))

    def forward(self, x, context=None, hypernet=None):
        if context is None and hypernet is None:
            # self-attention: one fused qkv matmul (unet.py:112-121)
            w = torch.cat([self.to_q.weight, self.to_k.weight,
                           self.to_v.weight], dim=0)
            q, k, v = linear(x, w).chunk(3, dim=-1)
        else:
            ctx_k = ctx_v = x if context is None else context
            pair = hypernet.context_pair(ctx_k) if hypernet is not None else None
            if pair is not None:        # unet.py:125-145
                ctx_k, ctx_v = pair
            q, k, v = self.to_q(x), self.to_k(ctx_k), self.to_v(ctx_v)
        return self.to_out[0](attention(q, k, v, num_heads=self.heads))


class GEGLU(nn.Module):
    def __init__(self, cin, cout, *, device, dtype):
        super().__init__()
        self.proj = Linear(cin, cout * 2, device=device, dtype=dtype)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, c, *, device, dtype):
        super().__init__()
        self.net = nn.Sequential(GEGLU(c, c * 4, device=device, dtype=dtype),
                                 nn.Dropout(0.0),
                                 Linear(c * 4, c, device=device, dtype=dtype))

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, c, context_dim, heads, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.attn1 = CrossAttention(c, c, heads, **kw)
        self.ff = FeedForward(c, **kw)
        self.attn2 = CrossAttention(c, context_dim, heads, **kw)
        self.norm1 = LayerNorm(c, **kw)
        self.norm2 = LayerNorm(c, **kw)
        self.norm3 = LayerNorm(c, **kw)

    def forward(self, x, context, hypernet=None):
        x = x + self.attn1(self.norm1(x), hypernet=hypernet)
        x = x + self.attn2(self.norm2(x), context, hypernet)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """proj_in / proj_out are 1×1 convs (SD1.x) or, with
    ``use_linear_in_transformer`` (SD2, SDXL), linears over (B, HW, C)
    (unet.py:214-236)."""

    def __init__(self, c, depth, cfg: UNetConfig, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        heads = cfg.heads_for(c)
        self.use_linear = cfg.use_linear_in_transformer
        self.norm = GroupNorm(c, eps=1e-6, **kw)
        self.proj_in = Linear(c, c, **kw) if self.use_linear else Conv2d(c, c, 1, **kw)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(c, cfg.context_dim, heads, **kw)
            for _ in range(depth))
        self.proj_out = Linear(c, c, **kw) if self.use_linear else Conv2d(c, c, 1, **kw)

    def forward(self, x, context, hypernet=None):
        b, c, h, w = x.shape
        residual = x
        x = self.norm(x)
        if self.use_linear:
            x = self.proj_in(x.permute(0, 2, 3, 1).reshape(b, h * w, c))
        else:
            x = self.proj_in(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        for block in self.transformer_blocks:
            x = block(x, context, hypernet)
        if self.use_linear:
            return self.proj_out(x).reshape(b, h, w, c).permute(0, 3, 1, 2) + residual
        return self.proj_out(x.reshape(b, h, w, c).permute(0, 3, 1, 2)) + residual


class Downsample(nn.Module):
    def __init__(self, c, *, device, dtype):
        super().__init__()
        self.op = Conv2d(c, c, 3, stride=2, device=device, dtype=dtype)

    def forward(self, x, circular: bool = False):
        return self.op(x, circular)


class Upsample(nn.Module):
    def __init__(self, c, *, device, dtype):
        super().__init__()
        self.conv = Conv2d(c, c, 3, device=device, dtype=dtype)

    def forward(self, x, circular: bool = False):
        return self.conv(upsample_nearest_2x(x), circular)


def _unsupported(cfg: UNetConfig) -> str | None:
    if cfg.hypertile_tile:
        return "hypertile"
    if cfg.tome_ratio:
        return "token merging (ToMe)"
    if cfg.upcast_attn:
        return "upcast_attn"
    return None


def make_layer(layer, cfg: UNetConfig, **kw) -> nn.Module:
    """The module of one `build_plan` layer descriptor."""
    kind = layer[0]
    if kind == "conv_in":
        return Conv2d(layer[1], layer[2], 3, **kw)
    if kind == "res":
        return ResBlock(layer[1], layer[2], cfg.time_embed_dim, **kw)
    if kind == "attn":
        return SpatialTransformer(layer[1], layer[2], cfg, **kw)
    if kind == "down":
        return Downsample(layer[1], **kw)
    return Upsample(layer[1], **kw)


def run_layers(layers, h, emb, context, hypernet=None, circular: bool = False):
    """circular: every 3×3 conv wraps its padding (seamless tiling,
    unet.py:260-276)."""
    for layer in layers:
        if isinstance(layer, ResBlock):
            h = layer(h, emb, circular)
        elif isinstance(layer, SpatialTransformer):
            h = layer(h, context, hypernet)
        else:
            h = layer(h, circular)
    return h


class UNetEncoder(nn.Module):
    """time_embed, label_emb (SDXL), the input blocks and the middle block:
    what the UNet and the ControlNet tower share."""

    kind = "UNet"

    def __init__(self, cfg: UNetConfig, *, device, dtype):
        super().__init__()
        missing = _unsupported(cfg)
        if missing:
            raise NotImplementedError(f"{self.kind} option not ported yet: {missing}")
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        input_plan, middle_depth, _, _ = build_plan(cfg)
        ted = cfg.time_embed_dim
        mc = cfg.model_channels
        self.time_embed = nn.Sequential(Linear(mc, ted, **kw), nn.SiLU(),
                                        Linear(ted, ted, **kw))
        if cfg.adm_in_channels:
            self.label_emb = nn.Sequential(nn.Sequential(
                Linear(cfg.adm_in_channels, ted, **kw), nn.SiLU(), Linear(ted, ted, **kw)))
        self.input_blocks = nn.ModuleList(
            nn.ModuleList(make_layer(layer, cfg, **kw) for layer in plan) for plan in input_plan)
        mid = mc * cfg.channel_mult[-1]
        self.middle_block = nn.ModuleList([
            ResBlock(mid, mid, ted, **kw),
            SpatialTransformer(mid, middle_depth, cfg, **kw),
            ResBlock(mid, mid, ted, **kw)])

    def embed(self, timesteps, y, dtype):
        """The timestep (+ SDXL vector) embedding in `dtype`."""
        t_emb = timestep_embedding(timesteps, self.cfg.model_channels)
        emb = self.time_embed[2](F.silu(self.time_embed[0](t_emb)))
        if self.cfg.adm_in_channels:
            if y is None:
                raise ValueError("this model requires vector conditioning y")
            le = self.label_emb[0]
            emb = emb + le[2](F.silu(le[0](y.to(emb.dtype))))
        return emb.to(dtype)


class UNetModel(UNetEncoder):
    def __init__(self, cfg: UNetConfig, *, device, dtype):
        super().__init__(cfg, device=device, dtype=dtype)
        kw = dict(device=device, dtype=dtype)
        _, _, output_plan, _ = build_plan(cfg)
        mc = cfg.model_channels
        self.output_blocks = nn.ModuleList(
            nn.ModuleList(make_layer(layer, cfg, **kw) for layer in plan) for plan in output_plan)
        self.out = nn.Sequential(GroupNorm(mc, **kw), nn.SiLU(),
                                 Conv2d(mc, cfg.out_channels, 3, **kw))

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        if any(k.endswith(".qkv.weight") for k in state_dict):
            raise NotImplementedError("the legacy AttentionBlock (fused qkv, "
                                      "context-free UNets) is not ported yet")
        return super().load_state_dict(state_dict, strict, assign)

    def forward(self, x, timesteps, context, y=None, control=None, hypernet=None,
                tiling: bool = False):
        """x: (B, C_in, H, W) latent; timesteps: (B,); context: (B, S, D);
        y: (B, adm_in_channels) SDXL vector conds; control: a ControlNet's
        {"input": per-input-block residuals, "middle": residual}, added the
        cldm way (module docstring); hypernet: a
        ``networks.hypernetwork.Hypernetwork``; tiling: circular padding on
        every 3×3 conv (unet.py:260-345).  Activations run channels-last in
        memory (NCHW indexing)."""
        emb = self.embed(timesteps, y, x.dtype)
        context = context.to(x.dtype)
        hs = []
        h = x.contiguous(memory_format=torch.channels_last)
        for block in self.input_blocks:
            h = run_layers(block, h, emb, context, hypernet, tiling)
            hs.append(h)
        h = run_layers(self.middle_block, h, emb, context, hypernet, tiling)
        if control is not None:
            h = h + control["middle"]
        for block in self.output_blocks:
            skip = hs.pop()
            if control is not None:
                skip = skip + control["input"][len(hs)]
            h = run_layers(block, torch.cat([h, skip], dim=1), emb, context, hypernet, tiling)
        return self.out[2](self.out[0](h, silu=True), tiling)
