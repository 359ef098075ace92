"""SwinIR super-resolution — port of ``sdwebui_tpu/models/swinir.py``.

Liang et al. 2021, "SwinIR: Image Restoration Using Swin Transformer", as
the JAX package runs it: activations NHWC (B, H, W, C), tokens (B, H·W, C);
window attention is one batched ``torch.matmul`` over every window of every
tile with fp32 scores, the relative-position bias gathered from its table
and the −100 shift mask added (``swinir.py:107-124``); it never reaches
``ops/attention``.  Every LayerNorm goes through ``ops.norms.layer_norm``
(B5 on CUDA tensors).  Convolutions are ``F.conv2d`` on NCHW views of the
NHWC maps (XLA convs in JAX).  f32 throughout, TF32 off
(``utils/devices``).

Parameter names are the published checkpoint keys (``conv_first``,
``patch_embed.norm``, ``layers.{i}.residual_group.blocks.{j}.…``,
``layers.{i}.conv`` or its 3conv ``.0/.2/.4``, ``norm``,
``conv_after_body``, ``conv_before_upsample.0``, ``conv_up1/2``,
``conv_hr``, ``conv_last``, ``upsample.{k}``), so a file's state dict loads
as it is; the config comes from its shapes (``derive_swinir_config``).
Upsamplers: nearest+conv, pixelshuffle, pixelshuffledirect and none.

This module also holds the window helpers and host constants that
``swin2sr``, ``hat`` and ``scunet`` share, as the JAX modules share
``swinir``'s.  ``relative_position_index`` and ``shift_attn_mask`` are
copies of ``sdwebui_tpu/models/swinir.py:56-80`` (held equal in
``tests/test_torch_copies.py``).

Departures of the JAX package that the port keeps: the output is
``conv_last(feat) / img_range + mean`` for the "none" upsampler too (the
reference's denoising SwinIR adds its input back); a file with an absolute
position embedding (``ape``) raises here, where JAX ignores the embedding.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sdwebui_tpu_torch.models.layers import (Conv2d, LayerNorm, Linear, assign_f32,
                                             reset_random)
from sdwebui_tpu_torch.postprocessing.upscalers import register_upscaler, tiled_sr_upscale
from sdwebui_tpu_torch.utils.devices import get_device   # importing devices turns TF32 off

RGB_MEAN = (0.4488, 0.4371, 0.4040)


@dataclasses.dataclass(frozen=True)
class SwinIRConfig:
    embed_dim: int = 180
    depths: tuple = (6, 6, 6, 6, 6, 6)
    num_heads: tuple = (6, 6, 6, 6, 6, 6)
    window_size: int = 8
    mlp_ratio: float = 2.0
    upsampler: str = "nearest+conv"   # | pixelshuffle | pixelshuffledirect | none
    scale: int = 4
    in_chans: int = 3
    patch_norm: bool = True
    ape: bool = False
    img_range: float = 1.0
    # read from the weights (the JAX config reads them from its tree)
    resi_connection: str = "1conv"     # | 3conv (SwinIR-L)
    num_feat: int = 64


# --------------------------------------------------------------------------
# host constants (copies of swinir.py:56-80) and the window helpers
# --------------------------------------------------------------------------

def relative_position_index(w: int) -> np.ndarray:
    """(w², w²) lookup into the (2w-1)² relative-position bias table."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w), indexing="ij"))
    flat = coords.reshape(2, -1)                          # (2, w²)
    rel = flat[:, :, None] - flat[:, None, :]             # (2, w², w²)
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[..., 0] += w - 1
    rel[..., 1] += w - 1
    rel[..., 0] *= 2 * w - 1
    return rel.sum(-1)


def shift_attn_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """(nW, w², w²) additive mask (-100 across region boundaries) for
    shifted-window attention."""
    img = np.zeros((h, w), np.float32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    mw = img.reshape(h // window, window, w // window, window) \
            .transpose(0, 2, 1, 3).reshape(-1, window * window)
    mask = mw[:, None, :] - mw[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


_CONSTS: dict = {}


def device_const(fn, *args, device) -> torch.Tensor:
    """fn(*args), a host numpy constant, as a tensor on `device` (kept for
    the next call with the same arguments); float64 arrives as float32,
    as ``jnp.asarray`` makes it."""
    key = (fn.__module__, fn.__qualname__, args, str(device))
    t = _CONSTS.get(key)
    if t is None:
        if len(_CONSTS) > 256:
            _CONSTS.clear()
        a = np.asarray(fn(*args))
        a = a.astype(np.float32) if a.dtype == np.float64 else a
        t = _CONSTS[key] = torch.as_tensor(a, device=device)
    return t


def window_partition(x, w: int):
    """(B, H, W, C) → (B·nW, w², C)"""
    b, hh, ww, c = x.shape
    x = x.reshape(b, hh // w, w, ww // w, w, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, c)


def window_reverse(win, w: int, b: int, hh: int, ww: int):
    c = win.shape[-1]
    x = win.reshape(b, hh // w, ww // w, w, w, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, hh, ww, c)


def heads_of(t, heads: int):
    """(B_, N, h·d) → (B_, h, N, d)"""
    b_, n, c = t.shape
    return t.reshape(b_, n, heads, c // heads).transpose(1, 2)


def windowed_softmax_av(attn, v, mask=None):
    """softmax(attn [+ mask per window]) · v: attn (B_, h, N, M) fp32 scores
    with their bias, mask (nW, N, M) or None, v (B_, h, M, d) → (B_, N, h·d)."""
    b_, h, n, m = attn.shape
    if mask is not None:
        nw = mask.shape[0]
        attn = (attn.view(b_ // nw, nw, h, n, m) + mask[None, :, None]).view(b_, h, n, m)
    attn = torch.softmax(attn, dim=-1)
    return torch.matmul(attn, v).transpose(1, 2).reshape(b_, n, -1)


#: input width from which a 3x3 conv on a CUDA tensor runs as GEMMs
GEMM_CONV_MIN_CIN = 48


def conv_nhwc(conv: nn.Module, x):
    """A conv module on an NHWC map: NCHW views in and out (no copies
    when x is contiguous NHWC, which is channels-last NCHW).  On CUDA a 3x3
    stride-1 conv at least GEMM_CONV_MIN_CIN wide runs as conv3x3_gemm."""
    if x.is_cuda and isinstance(conv, Conv2d) and conv.weight.shape[1] >= GEMM_CONV_MIN_CIN \
            and conv.weight.shape[-1] == 3 and conv.stride == 1 and conv.padding == 1:
        return conv3x3_gemm(conv, x)
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def conv3x3_gemm(conv: Conv2d, x):
    """A 3x3 stride-1 pad-1 conv of an NHWC map as nine GEMMs, one a tap,
    accumulated in place (addmm); NHWC out.  cuDNN's f32 heuristic (TF32
    off) runs the 180-wide 3x3 convs of Swin2SR, HAT and DAT as FFT
    convolutions, ~336 ms each on the 9 tiles of a 512² image where the
    GEMMs need a few ms, and HAT's 60 → 180 conv as a small-tile implicit
    GEMM of 91 ms (tools/zoo_probe_cuda.py on an H100)."""
    b, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    weight = conv.weight.to(x.dtype)
    if conv.bias is not None:
        out = conv.bias.to(x.dtype).expand(b * h * w, -1).contiguous()
    else:
        out = x.new_zeros((b * h * w, weight.shape[0]))
    for dy in range(3):
        for dx in range(3):
            out.addmm_(xp[:, dy:dy + h, dx:dx + w].reshape(-1, c), weight[:, :, dy, dx].t())
    return out.reshape(b, h, w, -1)


class Mlp(nn.Module):
    def __init__(self, c: int, hidden: int, kw: dict):
        super().__init__()
        self.fc1 = Linear(c, hidden, **kw)
        self.fc2 = Linear(hidden, c, **kw)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


def make_resi_conv(c: int, kind: str, kw: dict) -> nn.Module:
    """The residual connection's conv: '1conv' (one 3x3, keys ``conv.*``)
    or '3conv' (3x3 → lrelu → 1x1 → lrelu → 3x3 bottleneck, SwinIR-L; keys
    ``conv.{0,2,4}.*``)."""
    if kind == "1conv":
        return Conv2d(c, c, 3, **kw)
    return nn.ModuleDict({"0": Conv2d(c, c // 4, 3, **kw),
                          "2": Conv2d(c // 4, c // 4, 1, **kw),
                          "4": Conv2d(c // 4, c, 3, **kw)})


def resi_conv(m: nn.Module, x):
    """make_resi_conv's module on an NHWC map."""
    if isinstance(m, Conv2d):
        return conv_nhwc(m, x)
    x = F.leaky_relu(conv_nhwc(m["0"], x), 0.2)
    x = F.leaky_relu(conv_nhwc(m["2"], x), 0.2)
    return conv_nhwc(m["4"], x)


# --------------------------------------------------------------------------
# the net
# --------------------------------------------------------------------------

class WindowAttention(nn.Module):
    def __init__(self, c: int, heads: int, window: int, kw: dict):
        super().__init__()
        self.heads = heads
        self.qkv = Linear(c, 3 * c, **kw)
        self.proj = Linear(c, c, **kw)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty(((2 * window - 1) ** 2, heads), **kw), requires_grad=False)

    def forward(self, x, rpi, mask=None):
        """x: (B_, N, C), one fused qkv matmul (swinir.py:107-124)."""
        b_, n, c = x.shape
        h, d = self.heads, c // self.heads
        qkv = self.qkv(x).reshape(b_, n, 3, h, d).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]                   # (B_, h, N, d)
        attn = torch.matmul(q * (d ** -0.5), k.transpose(-1, -2))
        bias = self.relative_position_bias_table[rpi.reshape(-1)]
        attn = attn + bias.reshape(n, n, h).permute(2, 0, 1)[None]
        return self.proj(windowed_softmax_av(attn, v, mask))


class SwinBlock(nn.Module):
    def __init__(self, c: int, heads: int, window: int, hidden: int, kw: dict):
        super().__init__()
        self.norm1 = LayerNorm(c, **kw)
        self.attn = WindowAttention(c, heads, window, kw)
        self.norm2 = LayerNorm(c, **kw)
        self.mlp = Mlp(c, hidden, kw)

    def forward(self, t, hh: int, ww: int, window: int, shift: int, rpi, mask):
        b, _, c = t.shape
        x = self.norm1(t).reshape(b, hh, ww, c)
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        wins = self.attn(window_partition(x, window), rpi, mask if shift > 0 else None)
        x = window_reverse(wins, window, b, hh, ww)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        t = t + x.reshape(b, hh * ww, c)
        return t + self.mlp(self.norm2(t))


class BlockGroup(nn.Module):
    """A group's blocks under the checkpoint's ``residual_group.blocks``."""

    def __init__(self, blocks):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


class RSTB(nn.Module):
    """Residual Swin Transformer Block: blocks → conv → +residual."""

    def __init__(self, cfg: SwinIRConfig, depth: int, heads: int, kw: dict):
        super().__init__()
        e = cfg.embed_dim
        self.residual_group = BlockGroup(
            SwinBlock(e, heads, cfg.window_size, int(e * cfg.mlp_ratio), kw)
            for _ in range(depth))
        self.conv = make_resi_conv(e, cfg.resi_connection, kw)

    def forward(self, t, hh, ww, window, rpi, mask):
        b, _, c = t.shape
        tin = t
        for j, blk in enumerate(self.residual_group.blocks):
            t = blk(t, hh, ww, window, 0 if j % 2 == 0 else window // 2, rpi, mask)
        return resi_conv(self.conv, t.reshape(b, hh, ww, c)).reshape(b, hh * ww, c) + tin


def upsample_convs(cin: int, scale: int, kw: dict) -> nn.ModuleDict:
    """The pixelshuffle ladder: upsample.{0,2,...} (torch's Sequential
    interleaves the PixelShuffle modules)."""
    convs, s, k = {}, scale, 0
    while s > 1:
        r = 3 if s % 3 == 0 else 2
        convs[str(k)] = Conv2d(cin, cin * r * r, 3, **kw)
        s //= r
        k += 2
    return nn.ModuleDict(convs)


def run_upsample_ladder(convs: nn.ModuleDict, feat, scale: int):
    """NCHW feat through the pixelshuffle ladder."""
    s, k = scale, 0
    while s > 1:
        r = 3 if s % 3 == 0 else 2
        feat = F.pixel_shuffle(convs[str(k)](feat), r)
        s //= r
        k += 2
    return feat


class SwinIR(nn.Module):
    """forward: (B, H, W, in_chans) in [0, 1], H and W multiples of the
    window → (B, scale·H, scale·W, in_chans) clipped to [0, 1]."""

    def __init__(self, cfg: SwinIRConfig, device="cpu", dtype=torch.float32):
        super().__init__()
        if cfg.ape:
            raise NotImplementedError("SwinIR with an absolute position embedding (ape)")
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        e, nf, cin = cfg.embed_dim, cfg.num_feat, cfg.in_chans
        self.conv_first = Conv2d(cin, e, 3, **kw)
        if cfg.patch_norm:
            self.patch_embed = nn.Module()
            self.patch_embed.norm = LayerNorm(e, **kw)
        self.layers = nn.ModuleList(RSTB(cfg, d, h, kw)
                                    for d, h in zip(cfg.depths, cfg.num_heads))
        self.norm = LayerNorm(e, **kw)
        self.conv_after_body = make_resi_conv(e, cfg.resi_connection, kw)
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
        mask = device_const(shift_attn_mask, h, w, win, win // 2, device=x.device)
        mean = torch.tensor(RGB_MEAN if cfg.in_chans == 3 else (0.5,), device=x.device)
        feat = conv_nhwc(self.conv_first, (x - mean) * cfg.img_range).contiguous()
        t = feat.reshape(b, h * w, cfg.embed_dim)
        if cfg.patch_norm:
            t = self.patch_embed.norm(t)
        for layer in self.layers:
            t = layer(t, h, w, win, rpi, mask)
        t = self.norm(t)
        feat = resi_conv(self.conv_after_body, t.reshape(b, h, w, cfg.embed_dim)) + feat
        return upsample_tail(self, feat, cfg.upsampler, cfg.scale, mean, cfg.img_range)


def upsample_tail(net: nn.Module, feat, upsampler: str, scale: int, mean, img_range: float):
    """The upsampler of SwinIR, Swin2SR and HAT on the NHWC body features →
    the NHWC image, clipped to [0, 1] (swinir.py:198-222)."""
    lrelu = lambda t: F.leaky_relu(t, 0.01)   # noqa: E731
    f = feat.permute(0, 3, 1, 2)
    if upsampler == "nearest+conv":
        f = lrelu(net.conv_before_upsample["0"](f))
        f = lrelu(net.conv_up1(F.interpolate(f, scale_factor=2.0, mode="nearest")))
        if scale == 4:
            f = lrelu(net.conv_up2(F.interpolate(f, scale_factor=2.0, mode="nearest")))
        out = net.conv_last(lrelu(net.conv_hr(f)))
    elif upsampler == "pixelshuffle":
        f = lrelu(net.conv_before_upsample["0"](f))
        out = net.conv_last(run_upsample_ladder(net.upsample, f, scale))
    elif upsampler == "pixelshuffledirect":
        out = F.pixel_shuffle(net.upsample["0"](f), scale)
    else:
        out = net.conv_last(f)
    out = out.permute(0, 2, 3, 1) / img_range + mean
    return torch.clamp(out, 0.0, 1.0)


# --------------------------------------------------------------------------
# loading
# --------------------------------------------------------------------------

def strip_wrappers(sd: dict) -> dict:
    """The ``params_ema.`` / ``params.`` wrapper of BasicSR files off (the
    EMA weights when both are there)."""
    for prefix in ("params_ema.", "params."):
        if any(k.startswith(prefix) for k in sd):
            return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    return sd


def read_state_dict(path: str) -> dict:
    """A .safetensors, .pth, .pt or .ckpt file → {key: tensor}, its
    BasicSR wrapper off."""
    from sdwebui_tpu_torch.loader.load import read_checkpoint

    return strip_wrappers(read_checkpoint(path))


def n_indexed(sd: dict, prefix: str) -> int:
    """1 + the largest N of the keys `prefix`N.…"""
    return 1 + max(int(k[len(prefix):].split(".")[0]) for k in sd if k.startswith(prefix))


def derive_swinir_config(sd: dict) -> SwinIRConfig:
    """The architecture from weight shapes (swinir.py:239-281)."""
    shape = lambda k: tuple(sd[k].shape)   # noqa: E731
    embed, in_chans = shape("conv_first.weight")[:2]
    depths, heads = [], []
    table_rows = None
    for i in range(n_indexed(sd, "layers.")):
        pre = f"layers.{i}.residual_group.blocks."
        depths.append(n_indexed(sd, pre))
        table_rows, h = shape(f"{pre}0.attn.relative_position_bias_table")
        heads.append(h)
    window = (int(round(table_rows ** 0.5)) + 1) // 2
    mlp_ratio = shape("layers.0.residual_group.blocks.0.mlp.fc1.weight")[0] / embed
    num_feat = shape("conv_before_upsample.0.weight")[0] \
        if "conv_before_upsample.0.weight" in sd else 64
    if "conv_up1.weight" in sd:
        upsampler, scale = "nearest+conv", 4 if "conv_up2.weight" in sd else 2
    elif "conv_before_upsample.0.weight" in sd:
        upsampler, scale, k = "pixelshuffle", 1, 0
        while f"upsample.{k}.weight" in sd:
            scale *= int(round((shape(f"upsample.{k}.weight")[0] // num_feat) ** 0.5))
            k += 2
    elif "upsample.0.weight" in sd:
        upsampler = "pixelshuffledirect"
        scale = int(round((shape("upsample.0.weight")[0] // in_chans) ** 0.5))
    else:
        upsampler, scale = "none", 1
    return SwinIRConfig(
        embed_dim=embed, depths=tuple(depths), num_heads=tuple(heads), window_size=window,
        mlp_ratio=float(mlp_ratio), upsampler=upsampler, scale=scale, in_chans=in_chans,
        patch_norm="patch_embed.norm.weight" in sd, ape="absolute_pos_embed" in sd,
        resi_connection="1conv" if "conv_after_body.weight" in sd else "3conv",
        num_feat=num_feat)


_DROP_SUFFIXES = ("relative_position_index", "attn_mask", "attns.", "table_index")


def nest_sequential(sd: dict, *names: str) -> dict:
    """`name.weight` → `name.0.weight` for convs a published file keeps in
    an nn.Sequential (conv_before_upsample) and a JAX tree flattens."""
    out = {}
    for k, v in sd.items():
        for name in names:
            if k.startswith(name + ".") and not k.startswith(name + ".0."):
                k = name + ".0." + k[len(name) + 1:]
        out[k] = v
    return out


def swinir_from_state_dict(sd: dict, device="cuda") -> SwinIR:
    """A SwinIR file's state dict (BasicSR keys; wrappers stripped, the
    recomputed buffers dropped) → the net in f32 on `device`."""
    sd = nest_sequential(strip_wrappers(sd), "conv_before_upsample")
    sd = {k: v for k, v in sd.items() if not any(k.endswith(s) or s in k
                                                 for s in _DROP_SUFFIXES)}
    cfg = derive_swinir_config(sd)
    device = get_device(device)
    return assign_f32(SwinIR(cfg, device="meta"), sd, device)


def state_dict_from_jax(tree: dict, keep=()) -> dict:
    """A JAX tree (``convert_leaf``'s layouts: conv HWIO, linear (in, out))
    → torch layouts (conv OIHW, linear (out, in)) as f32 tensors; keys
    ending in one of `keep` stay as they are."""
    from sdwebui_tpu_torch.utils.pytree import flatten

    sd = {}
    for k, v in flatten(tree).items():
        t = torch.from_numpy(np.array(v, np.float32))
        if k.endswith(".weight") and not k.endswith(tuple(keep)):
            if t.dim() == 4:
                t = t.permute(3, 2, 0, 1)
            elif t.dim() == 2:
                t = t.t()
        sd[k] = t.contiguous()
    return sd


def swinir_from_jax(tree: dict, device="cpu") -> SwinIR:
    """The JAX package's SwinIR tree (``convert_swinir`` / ``init_params``)
    → the net."""
    return swinir_from_state_dict(state_dict_from_jax(tree), device)


def randomize(net: nn.Module, seed: int, table_std: float = 0.02) -> nn.Module:
    """Seeded random weights for `net` in place: the layers' own init
    (``layers.reset_random``), then every parameter that none of them
    holds (bias tables, scales) N(0, table_std²)."""
    gen = torch.Generator(device=next(net.parameters()).device).manual_seed(seed)
    reset_random(net, gen)
    held = {id(p) for m in net.modules()
            if isinstance(m, (Conv2d, Linear, LayerNorm)) for p in m.parameters()}
    with torch.no_grad():
        for p in net.parameters():
            if id(p) not in held:
                p.copy_(torch.randn(p.shape, generator=gen, device=p.device) * table_std)
    return net.eval()


#: SwinIR-L, the real-SR x4 release (003_realSR_BSRGAN_DFOWMFC_s64w8_SwinIR-L_x4_GAN):
#: embed 240, 9 RSTBs of 6 blocks, 8 heads, window 8, nearest+conv, 3conv
SWINIR_L = SwinIRConfig(embed_dim=240, depths=(6,) * 9, num_heads=(8,) * 9, window_size=8,
                        mlp_ratio=2.0, upsampler="nearest+conv", scale=4,
                        resi_connection="3conv", num_feat=64)


def create_random_swinir(seed: int = 0, device="cuda", cfg: SwinIRConfig = SWINIR_L) -> SwinIR:
    """A seeded random SwinIR at `cfg` (default SwinIR-L's published widths), f32."""
    return randomize(SwinIR(cfg, device=get_device(device)), seed)


# --------------------------------------------------------------------------
# tiled inference and the registry
# --------------------------------------------------------------------------

def nhwc_runner(net: nn.Module):
    """(N, H, W, 3) float32 numpy → the net's NHWC output as numpy, on the
    net's device in one call."""
    device = next(net.parameters()).device

    @torch.inference_mode()
    def run_batch(arr: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(device)
        return net(x).cpu().numpy()
    return run_batch


def upscale_image(net: nn.Module, image: np.ndarray, tile: int | None = None,
                  overlap: int | None = None) -> np.ndarray:
    """RGB uint8 (H, W, 3) → (scale·H, scale·W, 3), every tile in one
    batched call (tile / overlap: opts.ESRGAN_tile / ESRGAN_tile_overlap,
    as swinir.py:388-391 reads them; the single-tile path clips as the
    tiled one does)."""
    return tiled_sr_upscale(nhwc_runner(net), net.scale, net.pad_multiple, image,
                            tile=tile, overlap=overlap)


def is_swin2sr(sd: dict) -> bool:
    """A SwinV2 (Swin2SR) file: the sniff of swinir.py:455-461."""
    return any("logit_scale" in k or k.startswith("swin2sr.") for k in sd)


def load_swinir_dir_net(path: str, device):
    """A file of the SwinIR directory → (net, upscale function): Swin2SR
    files go to ``models/swin2sr``."""
    sd = read_state_dict(path)
    if is_swin2sr(sd):
        from sdwebui_tpu_torch.models import swin2sr

        return swin2sr.swin2sr_from_state_dict(sd, device), swin2sr.upscale_image
    return swinir_from_state_dict(sd, device), upscale_image


def model_files(dirs, exts=(".pth", ".pt", ".safetensors")):
    """(name, path) of each file of `dirs` with one of `exts`, sorted by
    name within each directory; a missing directory is skipped."""
    for d in dirs:
        if not d or not os.path.isdir(d):
            continue
        for fn in sorted(os.listdir(d)):
            if fn.lower().endswith(exts):
                yield os.path.splitext(fn)[0], os.path.join(d, fn)


def register_lazy(name: str, path: str, load, run, default_scale: int = 4):
    """Register `name`: the file is read (load(path) → state) at the
    first use, then run(state, image, scale) serves each call."""
    cache = {}

    def scale_fn(image, scale):
        if "state" not in cache:
            cache["state"] = load(path)
        return run(cache["state"], image, scale)
    register_upscaler(name, scale_fn, default_scale=default_scale, path=path)


def register_swinir_dir(dirs=(os.path.join("models", "SwinIR"),), device="cuda") -> list:
    """Register every .pth / .pt / .safetensors file of `dirs` as an
    upscaler named by its file, run on `device` (swinir.py:430); a SwinV2
    file is served by Swin2SR."""
    device = get_device(device)
    found = []
    for name, path in model_files(dirs):
        register_lazy(name, path, lambda p: load_swinir_dir_net(p, device),
                      lambda state, image, scale: state[1](state[0], image))
        found.append(name)
    return found
