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

``forward(attn=AttentionOptions(...))`` carries a request's self-attention
options (``unet.py:106-113,160-229``): hypertile runs each self-attention
over spatial tiles of at most tile×tile tokens where the map is larger
than one tile, ToMe (``ops/tome``) merges tokens around it, and
``upcast`` runs every attention, its projections included, in fp32.  The
ControlNet tower runs without them, as JAX's tower does.  Weights stored
as ``torch.float8_e4m3fn`` (fp8 storage) are upcast at use by
``layers.linear`` / ``layers.conv2d``.  ``UNetModel(cfg, depths=...)``
builds each transformer stack at a checkpoint's own depth and drops a
pruned middle block (SSD-1B, ``unet.py:264-271,327-335``;
:func:`state_dict_depths`).

``UNetModel(cfg, legacy_attention=True)`` is the context-free LDM UNet of
LDSR: each attention layer is the legacy ``AttentionBlock`` (GroupNorm,
a fused-qkv 1×1 conv, multi-head self-attention through ``ops.attention``,
proj_out; ``unet.py:239-253``) and ``forward`` takes ``context=None``.
The fused qkv splits into [q | k | v] over all heads, as JAX splits it;
ldm's ``QKVAttentionLegacy`` reads it per head ([q k v] of head 0, then
head 1, ...), so the two agree only for one head.

Split over a mesh's ``model`` axis by ``parallel/sharding.shard_params``,
``CrossAttention``, ``GEGLU`` and ``FeedForward`` run Megatron's tensor
parallelism (``sdwebui_tpu/parallel/sharding.py``, which GSPMD runs from
the layout alone): each model shard runs its H/model heads through the
same ``attention`` dispatch, so the kernel launches per shard at
(B, S, (H/model)·D); ``to_out.0``'s and ``ff.net.2``'s partial products
are summed over ``model`` and their bias is added once, after the sum.
"""

from __future__ import annotations

import dataclasses
import math
import re

import torch
import torch.nn.functional as F
from torch import nn

from sdwebui_tpu_torch.models.configs import UNetConfig
from sdwebui_tpu_torch.models.layers import (Conv2d, GroupNorm, LayerNorm,
                                             Linear, linear,
                                             timestep_embedding,
                                             upsample_nearest_2x)
from sdwebui_tpu_torch.ops.attention import attention
from sdwebui_tpu_torch.ops.tome import build_merge, merged_tokens
from sdwebui_tpu_torch.parallel import collectives


@dataclasses.dataclass(frozen=True)
class AttentionOptions:
    """A request's self-attention options: hypertile's latent tile (0: off),
    ToMe's ratio (0: off) and upcast_attn."""

    tile: int = 0
    tome_ratio: float = 0.0
    upcast: bool = False

    @classmethod
    def of(cls, cfg: UNetConfig) -> "AttentionOptions":
        return cls(cfg.hypertile_tile, cfg.tome_ratio, cfg.upcast_attn)


NO_OPTIONS = AttentionOptions()


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


def self_attention_calls(cfg: UNetConfig, latent: int, decoder: bool = True,
                         depths: dict | None = None):
    """(tokens, heads, head_dim) of every self-attention one forward makes
    at a latent×latent input, in call order: the launch plan of the
    attention kernels.  decoder=False: the encoder and middle block only
    (a ControlNet tower's); depths: a pruned module's
    (:func:`state_dict_depths`)."""
    depths = depths or {}
    input_plan, middle_depth, output_plan, _ = build_plan(cfg)
    middle = [("attn", cfg.model_channels * cfg.channel_mult[-1], middle_depth)] \
        if depths.get("middle_block", 3) == 3 else []
    named = [(f"input_blocks.{i}.{j}", layer) for i, plan in enumerate(input_plan)
             for j, layer in enumerate(plan)] + [("middle_block.1", layer) for layer in middle]
    if decoder:
        named += [(f"output_blocks.{i}.{j}", layer) for i, plan in enumerate(output_plan)
                  for j, layer in enumerate(plan)]
    calls, res = [], latent
    for path, layer in named:
        if layer[0] == "down":
            res //= 2
        elif layer[0] == "up":
            res *= 2
        elif layer[0] == "attn":
            heads = cfg.heads_for(layer[1])
            calls += [(res * res, heads, layer[1] // heads)] * depths.get(path, layer[2])
    return calls


def self_attention_shapes(cfg: UNetConfig, latent: int, batch: int,
                          attn: "AttentionOptions | None" = None, depths: dict | None = None):
    """(B, S, heads, head_dim) of every self-attention one forward at a
    latent×latent input of `batch` rows hands the attention, with a
    request's ToMe (merged tokens) and hypertile (B·tiles rows of a tile's
    tokens) as ``BasicTransformerBlock`` applies them."""
    attn = attn or NO_OPTIONS
    out = []
    for s, heads, d in self_attention_calls(cfg, latent, depths=depths):
        side = math.isqrt(s)
        if attn.tome_ratio > 0 and merged_tokens(side, side, attn.tome_ratio) != s:
            out.append((batch, merged_tokens(side, side, attn.tome_ratio), heads, d))
        elif attn.tile > 0 and s > attn.tile * attn.tile:
            n = split_factor(side, attn.tile)
            out.append((batch * n * n, (side // n) ** 2, heads, d))
        else:
            out.append((batch, s, heads, d))
    return out


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

    def forward(self, x, context=None, hypernet=None, upcast: bool = False):
        """context None: self-attention.  upcast: the whole attention in
        fp32, a self-attention still fused (unet.py:106-113)."""
        if upcast and x.dtype != torch.float32:
            ctx = None if context is None else context.float()
            return self.forward(x.float(), ctx, hypernet).to(x.dtype)
        shard = self.to_out[0].model_shard
        if shard is not None:
            x = collectives.copy_to_model(x)
            context = collectives.copy_to_model(context)
        if context is None and hypernet is None:
            # self-attention: one fused qkv matmul (unet.py:112-121)
            w = torch.cat([self.to_q.weight.to(x.dtype), self.to_k.weight.to(x.dtype),
                           self.to_v.weight.to(x.dtype)], dim=0)
            q, k, v = linear(x, w).chunk(3, dim=-1)
        else:
            ctx_k = ctx_v = x if context is None else context
            pair = hypernet.context_pair(ctx_k) if hypernet is not None else None
            if pair is not None:        # unet.py:125-145
                ctx_k, ctx_v = pair
            q, k, v = self.to_q(x), self.to_k(ctx_k), self.to_v(ctx_v)
        if shard is None:
            return self.to_out[0](attention(q, k, v, num_heads=self.heads))
        rank, size = shard
        if self.heads % size == 0:
            out = attention(q, k, v, num_heads=self.heads // size)
        else:   # heads that do not divide: every shard runs all of them
            q, k, v = (collectives.gather_from_model(t, dim=-1) for t in (q, k, v))
            out = collectives.scatter_to_model(attention(q, k, v, num_heads=self.heads), dim=-1)
        proj = self.to_out[0]
        out = collectives.reduce_from_model(linear(out, proj.weight))
        return out + proj.bias.to(out.dtype)


def split_factor(dim: int, tile: int) -> int:
    """Smallest divisor of `dim` whose quotient is ≤ tile (unet.py:160-168)."""
    for f in range(math.ceil(dim / tile), dim + 1):
        if dim % f == 0:
            return f
    return dim


def hypertiled_self_attention(attn: CrossAttention, x, hw, tile: int, hypernet=None,
                              upcast: bool = False):
    """Self-attention over spatial tiles (unet.py:170-186): (B, h·w, C) →
    (B·nh·nw, th·tw, C) around the attention."""
    h, w = hw
    b, s, c = x.shape
    nh, nw = split_factor(h, tile), split_factor(w, tile)
    if s != h * w or (nh == 1 and nw == 1):
        return attn(x, hypernet=hypernet, upcast=upcast)
    th, tw = h // nh, w // nw
    xt = x.reshape(b, nh, th, nw, tw, c).permute(0, 1, 3, 2, 4, 5).reshape(
        b * nh * nw, th * tw, c)
    out = attn(xt, hypernet=hypernet, upcast=upcast)
    return out.reshape(b, nh, nw, th, tw, c).permute(0, 1, 3, 2, 4, 5).reshape(b, s, c)


class GEGLU(nn.Module):
    def __init__(self, cin, cout, *, device, dtype):
        super().__init__()
        self.proj = Linear(cin, cout * 2, device=device, dtype=dtype)

    def forward(self, x):
        """Split over ``model``, the projection holds the shard's slice of
        both halves and its bias is sliced to match."""
        shard = self.proj.model_shard
        bias = self.proj.bias
        if shard is not None and bias is not None:
            rank, size = shard
            h_b, g_b = bias.chunk(2)
            bias = torch.cat([h_b.chunk(size)[rank], g_b.chunk(size)[rank]])
        h, gate = linear(x, self.proj.weight, bias).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, c, *, device, dtype):
        super().__init__()
        self.net = nn.Sequential(GEGLU(c, c * 4, device=device, dtype=dtype),
                                 nn.Dropout(0.0),
                                 Linear(c * 4, c, device=device, dtype=dtype))

    def forward(self, x):
        out_proj = self.net[2]
        if out_proj.model_shard is None:
            return out_proj(self.net[0](x))
        h = self.net[0](collectives.copy_to_model(x))
        out = collectives.reduce_from_model(linear(h, out_proj.weight))
        return out + out_proj.bias.to(out.dtype)


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

    def forward(self, x, context, hypernet=None, hw=None, opts: AttentionOptions = NO_OPTIONS):
        """hw: the (h, w) of x's token grid; opts: the self-attention's
        ToMe, hypertile and upcast (unet.py:188-208)."""
        h = self.norm1(x)
        merged = None
        if opts.tome_ratio > 0 and hw is not None:
            merged = build_merge(h, hw[0], hw[1], opts.tome_ratio)
        if merged is not None:
            merge, unmerge, _ = merged
            x = x + unmerge(self.attn1(merge(h), hypernet=hypernet, upcast=opts.upcast))
        elif opts.tile > 0 and hw is not None and hw[0] * hw[1] > opts.tile * opts.tile:
            x = x + hypertiled_self_attention(self.attn1, h, hw, opts.tile, hypernet,
                                              opts.upcast)
        else:
            x = x + self.attn1(h, hypernet=hypernet, upcast=opts.upcast)
        x = x + self.attn2(self.norm2(x), context, hypernet, upcast=opts.upcast)
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

    def forward(self, x, context, hypernet=None, opts: AttentionOptions = NO_OPTIONS):
        b, c, h, w = x.shape
        residual = x
        x = self.norm(x)
        if self.use_linear:
            x = self.proj_in(x.permute(0, 2, 3, 1).reshape(b, h * w, c))
        else:
            x = self.proj_in(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        for block in self.transformer_blocks:
            x = block(x, context, hypernet, (h, w), opts)
        if self.use_linear:
            return self.proj_out(x).reshape(b, h, w, c).permute(0, 3, 1, 2) + residual
        return self.proj_out(x.reshape(b, h, w, c).permute(0, 3, 1, 2)) + residual


class AttentionBlock(nn.Module):
    """The legacy LDM AttentionBlock (context-free UNets: LDSR's bsr model):
    GroupNorm → fused-qkv 1×1 conv (weights (3C, C, 1)) → self-attention
    over H·W tokens → proj_out (unet.py:239-253)."""

    def __init__(self, c, heads, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.heads = heads
        self.norm = GroupNorm(c, **kw)
        self.qkv = nn.Module()
        self.qkv.weight = nn.Parameter(torch.empty((3 * c, c, 1), **kw), requires_grad=False)
        self.qkv.bias = nn.Parameter(torch.empty((3 * c,), **kw), requires_grad=False)
        self.proj_out = nn.Module()
        self.proj_out.weight = nn.Parameter(torch.empty((c, c, 1), **kw), requires_grad=False)
        self.proj_out.bias = nn.Parameter(torch.empty((c,), **kw), requires_grad=False)

    def forward(self, x):
        b, c, h, w = x.shape
        t = self.norm(x).permute(0, 2, 3, 1).reshape(b, h * w, c)
        q, k, v = linear(t, self.qkv.weight[:, :, 0], self.qkv.bias).chunk(3, dim=-1)
        out = linear(attention(q, k, v, num_heads=self.heads), self.proj_out.weight[:, :, 0],
                     self.proj_out.bias)
        return x + out.reshape(b, h, w, c).permute(0, 3, 1, 2)

    @torch.no_grad()
    def reset_random(self, gen):
        for p in (self.qkv.weight, self.proj_out.weight):
            p.copy_(torch.randn(p.shape, generator=gen, device=p.device) / p.shape[1] ** 0.5)
        self.qkv.bias.zero_()
        self.proj_out.bias.zero_()


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


_TRANSFORMER_BLOCK = re.compile(r"^(.*)\.transformer_blocks\.(\d+)\.")
_MIDDLE = re.compile(r"^middle_block\.(\d+)\.")


def state_dict_depths(names) -> dict:
    """The per-block depths of a UNet state dict's names: {"input_blocks.i.1"
    | "middle_block.1" | "output_blocks.i.1": transformer blocks present}
    and {"middle_block": modules present}.  SSD-1B-style pruning
    (convert_sdxl_to_ssd) shortens stacks and drops middle_block.1 and .2
    (JAX reads the same from its params: unet.py:264-271,327-335)."""
    depths: dict = {}
    for name in names:
        m = _TRANSFORMER_BLOCK.match(name)
        if m:
            depths[m.group(1)] = max(depths.get(m.group(1), 0), int(m.group(2)) + 1)
        m = _MIDDLE.match(name)
        if m:
            depths["middle_block"] = max(depths.get("middle_block", 0), int(m.group(1)) + 1)
    return depths


def make_layer(layer, cfg: UNetConfig, legacy_attention: bool = False, depth: int | None = None,
               **kw) -> nn.Module:
    """The module of one `build_plan` layer descriptor (attention layers:
    the legacy AttentionBlock with `legacy_attention`; a SpatialTransformer
    of `depth` blocks where given)."""
    kind = layer[0]
    if kind == "attn" and legacy_attention:
        return AttentionBlock(layer[1], cfg.heads_for(layer[1]), **kw)
    if kind == "conv_in":
        return Conv2d(layer[1], layer[2], 3, **kw)
    if kind == "res":
        return ResBlock(layer[1], layer[2], cfg.time_embed_dim, **kw)
    if kind == "attn":
        return SpatialTransformer(layer[1], layer[2] if depth is None else depth, cfg, **kw)
    if kind == "down":
        return Downsample(layer[1], **kw)
    return Upsample(layer[1], **kw)


def run_layers(layers, h, emb, context, hypernet=None, circular: bool = False,
               attn: AttentionOptions = NO_OPTIONS):
    """circular: every 3×3 conv wraps its padding (seamless tiling,
    unet.py:260-276); attn: the transformers' self-attention options."""
    for layer in layers:
        if isinstance(layer, ResBlock):
            h = layer(h, emb, circular)
        elif isinstance(layer, SpatialTransformer):
            h = layer(h, context, hypernet, attn)
        elif isinstance(layer, AttentionBlock):
            h = layer(h)
        else:
            h = layer(h, circular)
    return h


class UNetEncoder(nn.Module):
    """time_embed, label_emb (SDXL), the input blocks and the middle block:
    what the UNet and the ControlNet tower share."""

    kind = "UNet"

    def __init__(self, cfg: UNetConfig, *, device, dtype, legacy_attention: bool = False,
                 depths: dict | None = None):
        """depths: :func:`state_dict_depths` of a checkpoint whose blocks
        may be pruned (None: the config's depths)."""
        super().__init__()
        self.cfg = cfg
        depths = depths or {}
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
            nn.ModuleList(make_layer(layer, cfg, legacy_attention,
                                     depths.get(f"input_blocks.{i}.{j}"), **kw)
                          for j, layer in enumerate(plan))
            for i, plan in enumerate(input_plan))
        mid = mc * cfg.channel_mult[-1]
        n_middle = depths.get("middle_block", 3)
        if n_middle not in (1, 3):
            raise ValueError(f"a middle block of {n_middle} modules: only SSD-1B's pruning "
                             "(middle_block.1 and .2 both gone) is known")
        self.middle_block = nn.ModuleList([ResBlock(mid, mid, ted, **kw)])
        if n_middle == 3:
            self.middle_block.extend([
                make_layer(("attn", mid, middle_depth), cfg, legacy_attention,
                           depths.get("middle_block.1"), **kw),
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
    def __init__(self, cfg: UNetConfig, *, device, dtype, legacy_attention: bool = False,
                 depths: dict | None = None):
        super().__init__(cfg, device=device, dtype=dtype, legacy_attention=legacy_attention,
                         depths=depths)
        kw = dict(device=device, dtype=dtype)
        _, _, output_plan, _ = build_plan(cfg)
        mc = cfg.model_channels
        depths = depths or {}
        self.output_blocks = nn.ModuleList(
            nn.ModuleList(make_layer(layer, cfg, legacy_attention,
                                     depths.get(f"output_blocks.{i}.{j}"), **kw)
                          for j, layer in enumerate(plan))
            for i, plan in enumerate(output_plan))
        self.out = nn.Sequential(GroupNorm(mc, **kw), nn.SiLU(),
                                 Conv2d(mc, cfg.out_channels, 3, **kw))

    def forward(self, x, timesteps, context, y=None, control=None, hypernet=None,
                tiling: bool = False, attn: AttentionOptions = NO_OPTIONS):
        """x: (B, C_in, H, W) latent; timesteps: (B,); context: (B, S, D);
        None for a legacy-attention UNet;
        y: (B, adm_in_channels) SDXL vector conds; control: a ControlNet's
        {"input": per-input-block residuals, "middle": residual}, added the
        cldm way (module docstring); hypernet: a
        ``networks.hypernetwork.Hypernetwork``; tiling: circular padding on
        every 3×3 conv (unet.py:260-345); attn: the request's
        self-attention options.  Activations run channels-last in memory
        (NCHW indexing)."""
        emb = self.embed(timesteps, y, x.dtype)
        context = context.to(x.dtype) if context is not None else None
        hs = []
        h = x.contiguous(memory_format=torch.channels_last)
        for block in self.input_blocks:
            h = run_layers(block, h, emb, context, hypernet, tiling, attn)
            hs.append(h)
        h = run_layers(self.middle_block, h, emb, context, hypernet, tiling, attn)
        if control is not None:
            h = h + control["middle"]
        for block in self.output_blocks:
            skip = hs.pop()
            if control is not None:
                skip = skip + control["input"][len(hs)]
            h = run_layers(block, torch.cat([h, skip], dim=1), emb, context, hypernet, tiling,
                           attn)
        return self.out[2](self.out[0](h, silu=True), tiling)
