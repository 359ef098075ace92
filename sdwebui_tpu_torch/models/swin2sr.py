"""Swin2SR super-resolution (SwinV2 attention) — port of
``sdwebui_tpu/models/swin2sr.py``.

SwinV2 blocks: post-norm residuals, cosine attention with a learned logit
scale clamped at log 100, and a continuous relative-position bias from a
two-layer MLP over log-spaced offsets, 16·sigmoid (``swin2sr.py:61-115``).
The windowing, the upsamplers and the tiled inference are SwinIR's
(``models/swinir``); every LayerNorm goes through B5.

Two key layouts load: the original repository's (``conv_first``,
``layers.{i}.residual_group.blocks.{j}.attn.{qkv,q_bias,v_bias,
logit_scale,cpb_mlp,proj}``) and Hugging Face's (``swin2sr.*``, split
q/k/v), which ``hf_to_original`` re-keys (``swin2sr.py:203-245``); the 1x1
patch projections Hugging Face inserts are applied where present.  The
window size is not in the weights: 8, as the JAX package fixes it.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sdwebui_tpu_torch.models.layers import Conv2d, LayerNorm, Linear, assign_f32
from sdwebui_tpu_torch.models.swinir import (RGB_MEAN, BlockGroup, Mlp, conv_nhwc,
                                             device_const, n_indexed, nest_sequential,
                                             nhwc_runner, randomize, relative_position_index,
                                             shift_attn_mask, state_dict_from_jax,
                                             strip_wrappers, upsample_convs, upsample_tail,
                                             window_partition, window_reverse,
                                             windowed_softmax_av)
from sdwebui_tpu_torch.postprocessing.upscalers import tiled_sr_upscale
from sdwebui_tpu_torch.utils.devices import get_device


@dataclasses.dataclass(frozen=True)
class Swin2SRConfig:
    embed_dim: int = 180
    depths: tuple = (6, 6, 6, 6, 6, 6)
    num_heads: tuple = (6, 6, 6, 6, 6, 6)
    window_size: int = 8
    mlp_ratio: float = 2.0
    upsampler: str = "pixelshuffle"   # | pixelshuffledirect | nearest+conv | none
    scale: int = 4
    in_chans: int = 3
    img_range: float = 1.0
    # read from the weights (the JAX package reads them from its tree)
    num_feat: int = 64
    patch_norm: bool = True
    patch_projection: bool = False    # Hugging Face's 1x1 convs: after conv_first
    stage_projection: bool = False    # and after each stage's conv
    cpb_hidden: int = 512
    qkv_bias: bool = True


def cpb_coords_table(w: int) -> np.ndarray:
    """SwinV2 log-spaced continuous-position-bias inputs: ((2w-1)², 2); a
    copy of swin2sr.py:51-58."""
    r = np.arange(-(w - 1), w, dtype=np.float32)
    table = np.stack(np.meshgrid(r, r, indexing="ij"), axis=-1)  # (2w-1,2w-1,2)
    table = table / max(w - 1, 1)
    table = table * 8.0
    table = np.sign(table) * np.log2(np.abs(table) + 1.0) / np.log2(8.0)
    return table.reshape(-1, 2)


class V2Attention(nn.Module):
    def __init__(self, c: int, heads: int, cpb_hidden: int, qkv_bias: bool, kw: dict):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(c, 3 * c, bias=False, **kw)
        if qkv_bias:
            self.q_bias = nn.Parameter(torch.empty((c,), **kw), requires_grad=False)
            self.v_bias = nn.Parameter(torch.empty((c,), **kw), requires_grad=False)
        self.logit_scale = nn.Parameter(torch.empty((heads, 1, 1), **kw), requires_grad=False)
        self.cpb_mlp = nn.ModuleDict({"0": Linear(2, cpb_hidden, **kw),
                                      "2": Linear(cpb_hidden, heads, bias=False, **kw)})
        self.proj = Linear(c, c, **kw)

    def forward(self, x, rpi, cpb_in, mask=None):
        """Cosine attention + CPB-MLP bias; x: (B_, N, C)."""
        b_, n, c = x.shape
        h, d = self.heads, c // self.heads
        qkv = self.qkv(x)
        if hasattr(self, "q_bias"):
            qkv = qkv + torch.cat([self.q_bias, torch.zeros_like(self.q_bias), self.v_bias])
        qkv = qkv.reshape(b_, n, 3, h, d).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        qn = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-12)
        kn = k / (torch.linalg.vector_norm(k, dim=-1, keepdim=True) + 1e-12)
        attn = torch.matmul(qn, kn.transpose(-1, -2))
        scale = torch.exp(torch.clamp(self.logit_scale, max=float(np.log(100.0))))
        attn = attn * scale.reshape(1, h, 1, 1)
        table = self.cpb_mlp["2"](F.relu(self.cpb_mlp["0"](cpb_in)))    # ((2w-1)², h)
        bias = table[rpi.reshape(-1)].reshape(n, n, h).permute(2, 0, 1)
        attn = attn + 16.0 * torch.sigmoid(bias)[None]
        return self.proj(windowed_softmax_av(attn, v, mask))


class V2Block(nn.Module):
    """SwinV2 post-norm residual block."""

    def __init__(self, cfg: Swin2SRConfig, heads: int, kw: dict):
        super().__init__()
        e = cfg.embed_dim
        self.attn = V2Attention(e, heads, cfg.cpb_hidden, cfg.qkv_bias, kw)
        self.norm1 = LayerNorm(e, **kw)
        self.mlp = Mlp(e, int(e * cfg.mlp_ratio), kw)
        self.norm2 = LayerNorm(e, **kw)

    def forward(self, t, hh, ww, window, shift, rpi, cpb_in, mask):
        b, _, c = t.shape
        x = t.reshape(b, hh, ww, c)
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        wins = self.attn(window_partition(x, window), rpi, cpb_in, mask if shift > 0 else None)
        x = window_reverse(wins, window, b, hh, ww)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        t = t + self.norm1(x.reshape(b, hh * ww, c))
        return t + self.norm2(self.mlp(t))


class Stage(nn.Module):
    def __init__(self, cfg: Swin2SRConfig, depth: int, heads: int, kw: dict):
        super().__init__()
        e = cfg.embed_dim
        self.residual_group = BlockGroup(V2Block(cfg, heads, kw) for _ in range(depth))
        self.conv = Conv2d(e, e, 3, **kw)
        if cfg.stage_projection:      # Hugging Face's learnable 1x1 after the conv
            self.patch_embed = nn.Module()
            self.patch_embed.projection = Conv2d(e, e, 1, **kw)

    def forward(self, t, hh, ww, window, rpi, cpb_in, mask):
        b, _, c = t.shape
        tin = t
        for j, blk in enumerate(self.residual_group.blocks):
            t = blk(t, hh, ww, window, 0 if j % 2 == 0 else window // 2, rpi, cpb_in, mask)
        x = conv_nhwc(self.conv, t.reshape(b, hh, ww, c))
        if hasattr(self, "patch_embed"):
            x = conv_nhwc(self.patch_embed.projection, x)
        return x.reshape(b, hh * ww, c) + tin


class Swin2SR(nn.Module):
    """forward: (B, H, W, in_chans) in [0, 1], H and W multiples of the
    window → (B, scale·H, scale·W, in_chans) clipped to [0, 1]."""

    def __init__(self, cfg: Swin2SRConfig, device="cpu", dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        e, nf, cin = cfg.embed_dim, cfg.num_feat, cfg.in_chans
        self.conv_first = Conv2d(cin, e, 3, **kw)
        if cfg.patch_norm or cfg.patch_projection:
            self.patch_embed = nn.Module()
            if cfg.patch_projection:
                self.patch_embed.projection = Conv2d(e, e, 1, **kw)
            if cfg.patch_norm:
                self.patch_embed.norm = LayerNorm(e, **kw)
        self.layers = nn.ModuleList(Stage(cfg, d, h, kw)
                                    for d, h in zip(cfg.depths, cfg.num_heads))
        self.norm = LayerNorm(e, **kw)
        self.conv_after_body = Conv2d(e, e, 3, **kw)
        if cfg.upsampler in ("nearest+conv", "pixelshuffle"):
            self.conv_before_upsample = nn.ModuleDict({"0": Conv2d(e, nf, 3, **kw)})
        if cfg.upsampler == "nearest+conv":
            self.conv_up1 = Conv2d(nf, nf, 3, **kw)
            if cfg.scale == 4:
                self.conv_up2 = Conv2d(nf, nf, 3, **kw)
            self.conv_hr = Conv2d(nf, nf, 3, **kw)
            self.conv_last = Conv2d(nf, cin, 3, **kw)
        elif cfg.upsampler == "pixelshuffle":
            self.upsample = upsample_convs(nf, cfg.scale, kw)
            self.conv_last = Conv2d(nf, cin, 3, **kw)
        elif cfg.upsampler == "pixelshuffledirect":
            self.upsample = nn.ModuleDict({"0": Conv2d(e, cin * cfg.scale ** 2, 3, **kw)})
        else:
            self.conv_last = Conv2d(e, cin, 3, **kw)

    @property
    def scale(self) -> int:
        return self.cfg.scale

    @property
    def pad_multiple(self) -> int:
        return self.cfg.window_size

    def forward(self, x):
        cfg = self.cfg
        b, h, w, _ = x.shape
        win = cfg.window_size
        if h % win or w % win:
            raise ValueError(f"input {h}x{w} is not a multiple of the window {win}")
        rpi = device_const(relative_position_index, win, device=x.device)
        cpb_in = device_const(cpb_coords_table, win, device=x.device)
        mask = device_const(shift_attn_mask, h, w, win, win // 2, device=x.device)
        mean = torch.tensor(RGB_MEAN if cfg.in_chans == 3 else (0.5,), device=x.device)
        feat = conv_nhwc(self.conv_first, (x - mean) * cfg.img_range).contiguous()
        body = feat
        if cfg.patch_projection:
            body = conv_nhwc(self.patch_embed.projection, body)
        t = body.reshape(b, h * w, cfg.embed_dim)
        if cfg.patch_norm:
            t = self.patch_embed.norm(t)
        for layer in self.layers:
            t = layer(t, h, w, win, rpi, cpb_in, mask)
        t = self.norm(t)
        feat = conv_nhwc(self.conv_after_body, t.reshape(b, h, w, cfg.embed_dim)) + feat
        return upsample_tail(self, feat, cfg.upsampler, cfg.scale, mean, cfg.img_range)


# --------------------------------------------------------------------------
# loading
# --------------------------------------------------------------------------

_HF_RENAMES = [
    ("swin2sr.first_convolution.", "conv_first."),
    ("swin2sr.embeddings.patch_embeddings.projection.", "patch_embed.projection."),
    ("swin2sr.embeddings.patch_embeddings.layernorm.", "patch_embed.norm."),
    ("swin2sr.layernorm.", "norm."),
    ("swin2sr.conv_after_body.", "conv_after_body."),
    ("upsample.conv_before_upsample.", "conv_before_upsample."),
    ("upsample.final_convolution.", "conv_last."),
    ("swin2sr.final_convolution.", "conv_last."),
]


def hf_to_original(sd: dict) -> dict:
    """Hugging Face's Swin2SR keys → the original repository's (q, k, v
    fused along dim 0); swin2sr.py:203-245."""
    out, qkv = {}, {}
    for k, v in sd.items():
        for a, b in _HF_RENAMES:
            if k.startswith(a):
                k = b + k[len(a):]
                break
        m = re.match(r"upsample\.upsample\.convolution_(\d+)\.(.+)", k)
        if m:
            k = f"upsample.{2 * int(m.group(1))}.{m.group(2)}"
        k = re.sub(r"swin2sr\.encoder\.stages\.(\d+)\.layers\.(\d+)\.",
                   r"layers.\1.residual_group.blocks.\2.", k)
        k = re.sub(r"swin2sr\.encoder\.stages\.(\d+)\.", r"layers.\1.", k)
        k = (k.replace(".attention.self.continuous_position_bias_mlp.", ".attn.cpb_mlp.")
             .replace(".attention.self.logit_scale", ".attn.logit_scale")
             .replace(".attention.output.dense.", ".attn.proj.")
             .replace(".layernorm_before.", ".norm1.")
             .replace(".layernorm_after.", ".norm2.")
             .replace(".intermediate.dense.", ".mlp.fc1.")
             .replace(".output.dense.", ".mlp.fc2."))
        m = re.match(r"(.*)\.attention\.self\.(query|key|value)\.(weight|bias)", k)
        if m:
            base = m.group(1) if m.group(1).endswith(".attn") else m.group(1) + ".attn"
            qkv.setdefault(base, {})[(m.group(2), m.group(3))] = v
            continue
        out[k] = v
    for base, parts in qkv.items():
        out[base + ".qkv.weight"] = torch.cat([torch.as_tensor(parts[(n, "weight")])
                                               for n in ("query", "key", "value")], 0)
        if ("query", "bias") in parts:
            out[base + ".q_bias"] = parts[("query", "bias")]
            out[base + ".v_bias"] = parts[("value", "bias")]
    return out


def derive_swin2sr_config(sd: dict) -> Swin2SRConfig:
    """The architecture from weight shapes (swin2sr.py:247-286); the window
    is 8, which the weights do not record."""
    embed, in_chans = sd["conv_first.weight"].shape[:2]
    depths, heads = [], []
    for i in range(n_indexed(sd, "layers.")):
        pre = f"layers.{i}.residual_group.blocks."
        depths.append(n_indexed(sd, pre))
        heads.append(int(sd[f"{pre}0.attn.logit_scale"].shape[0]))
    mlp_ratio = sd["layers.0.residual_group.blocks.0.mlp.fc1.weight"].shape[0] / embed
    num_feat = int(sd["conv_before_upsample.0.weight"].shape[0]) \
        if "conv_before_upsample.0.weight" in sd else 64
    if "upsample.0.weight" in sd:
        if "conv_before_upsample.0.weight" in sd:
            upsampler, scale, k = "pixelshuffle", 1, 0
            while f"upsample.{k}.weight" in sd:
                w = sd[f"upsample.{k}.weight"]
                scale *= {4: 2, 9: 3}.get(int(w.shape[0]) // int(w.shape[1]), 2)
                k += 2
        else:
            upsampler = "pixelshuffledirect"
            scale = int(np.sqrt(int(sd["upsample.0.weight"].shape[0]) // in_chans))
    elif "conv_up1.weight" in sd:
        upsampler, scale = "nearest+conv", 4 if "conv_up2.weight" in sd else 2
    else:
        upsampler, scale = "none", 1
    return Swin2SRConfig(
        embed_dim=int(embed), depths=tuple(depths), num_heads=tuple(heads), window_size=8,
        mlp_ratio=float(mlp_ratio), upsampler=upsampler, scale=scale, in_chans=int(in_chans),
        num_feat=num_feat, patch_norm="patch_embed.norm.weight" in sd,
        patch_projection="patch_embed.projection.weight" in sd,
        stage_projection="layers.0.patch_embed.projection.weight" in sd,
        cpb_hidden=int(sd["layers.0.residual_group.blocks.0.attn.cpb_mlp.0.weight"].shape[0]),
        qkv_bias="layers.0.residual_group.blocks.0.attn.q_bias" in sd)


_DROP_SUFFIXES = ("relative_coords_table", "relative_position_index", "attn_mask")


def swin2sr_from_state_dict(sd: dict, device="cuda", window_size: int = 8) -> Swin2SR:
    """A Swin2SR file's state dict (either layout) → the net in f32 on
    `device`."""
    sd = strip_wrappers(sd)
    if any(k.startswith("swin2sr.") for k in sd):
        sd = hf_to_original(sd)
    sd = nest_sequential(sd, "conv_before_upsample")
    sd = {k: v for k, v in sd.items() if not k.endswith(_DROP_SUFFIXES)}
    cfg = dataclasses.replace(derive_swin2sr_config(sd), window_size=window_size)
    return assign_f32(Swin2SR(cfg, device="meta"), sd, get_device(device))


def swin2sr_from_jax(tree: dict, device="cpu", window_size: int = 8) -> Swin2SR:
    """The JAX package's Swin2SR tree (``convert_swin2sr`` / ``init_params``)
    → the net (the window is not in a tree either)."""
    return swin2sr_from_state_dict(state_dict_from_jax(tree), device, window_size)


#: the JAX package's defaults (the classical-SR x4 release's widths):
#: embed 180, 6 stages of 6 blocks, 6 heads, window 8, pixelshuffle, 64 features
SWIN2SR_X4 = Swin2SRConfig()


def create_random_swin2sr(seed: int = 0, device="cuda",
                          cfg: Swin2SRConfig = SWIN2SR_X4) -> Swin2SR:
    """A seeded random Swin2SR at `cfg`, f32; logit scales at log 10, the
    last conv's weights × 0.2 (the output then stays mostly inside [0, 1])."""
    net = randomize(Swin2SR(cfg, device=get_device(device)), seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, V2Attention):
                m.logit_scale.fill_(float(np.log(10.0)))
        if hasattr(net, "conv_last"):
            net.conv_last.weight.mul_(0.2)
    return net


def upscale_image(net: Swin2SR, image: np.ndarray, tile: int | None = None,
                  overlap: int | None = None) -> np.ndarray:
    """RGB uint8 (H, W, 3) → (scale·H, scale·W, 3) through
    ``tiled_sr_upscale`` (opts.ESRGAN_tile / ESRGAN_tile_overlap)."""
    return tiled_sr_upscale(nhwc_runner(net), net.scale, net.pad_multiple, image,
                            tile=tile, overlap=overlap)
