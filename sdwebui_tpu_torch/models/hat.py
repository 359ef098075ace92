"""HAT super-resolution (Hybrid Attention Transformer, Chen et al. 2023) —
port of ``sdwebui_tpu/models/hat.py``.

Each residual group (RHAG) runs hybrid attention blocks (HAB: window
attention at window 16, plus a conv branch with channel attention scaled
by ``conv_scale``) and one overlapping cross-attention block (OCAB: the
queries' windows against overlapping owin×owin key/value patches,
``hat.py:81-183``), then a conv and the group's residual.  The windows ride
one batched ``torch.matmul`` with fp32 scores, as in ``models/swinir``;
every LayerNorm goes through B5.

Parameter names are the release's keys.  As the JAX package does, the port
leaves the release's ``patch_embed.norm`` unused (the reference's HAT
normalises the patch embedding), and reads ``conv_before_upsample`` both
as the release's nn.Sequential (``conv_before_upsample.0``) and flat.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sdwebui_tpu_torch.models.layers import Conv2d, LayerNorm, Linear, assign_f32
from sdwebui_tpu_torch.models.swinir import (RGB_MEAN, BlockGroup, Mlp, WindowAttention,
                                             conv_nhwc, device_const, heads_of, n_indexed,
                                             nest_sequential, nhwc_runner, randomize,
                                             relative_position_index, shift_attn_mask,
                                             state_dict_from_jax, strip_wrappers,
                                             upsample_convs, upsample_tail, window_partition,
                                             window_reverse, windowed_softmax_av)
from sdwebui_tpu_torch.postprocessing.upscalers import tiled_sr_upscale
from sdwebui_tpu_torch.utils.devices import get_device


@dataclasses.dataclass(frozen=True)
class HATConfig:
    embed_dim: int = 180
    depths: tuple = (6, 6, 6, 6, 6, 6)
    num_heads: tuple = (6, 6, 6, 6, 6, 6)
    window_size: int = 16
    overlap_ratio: float = 0.5
    compress_ratio: int = 3
    squeeze_factor: int = 16
    conv_scale: float = 0.01
    mlp_ratio: float = 2.0
    scale: int = 4
    in_chans: int = 3
    img_range: float = 1.0
    # read from the weights
    num_feat: int = 64
    patch_norm: bool = False      # carried, unused (hat.py:198-236)

    @property
    def overlap_win(self) -> int:
        return self.window_size + int(self.overlap_ratio * self.window_size)


def rpi_oca(ws: int, owin: int) -> np.ndarray:
    """(ws², owin²) lookup into the ((ws+owin-1)², heads) OCA bias table;
    a copy of hat.py:63-74."""
    co = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    co = co.reshape(2, -1)                                   # (2, ws²)
    ce = np.stack(np.meshgrid(np.arange(owin), np.arange(owin), indexing="ij"))
    ce = ce.reshape(2, -1)                                   # (2, owin²)
    rel = ce[:, None, :] - co[:, :, None]                    # (2, ws², owin²)
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[..., 0] += ws - 1
    rel[..., 1] += ws - 1
    rel[..., 0] *= ws + owin - 1
    return rel.sum(-1)


class CAB(nn.Module):
    """conv → GELU → conv → channel attention (squeeze: the global mean,
    1x1 convs, a sigmoid gate); keys ``cab.{0,2,3.attention.{1,3}}``."""

    def __init__(self, c: int, compress: int, squeeze: int, kw: dict):
        super().__init__()
        att = nn.Module()
        att.attention = nn.ModuleDict({"1": Conv2d(c, c // squeeze, 1, **kw),
                                       "3": Conv2d(c // squeeze, c, 1, **kw)})
        self.cab = nn.ModuleDict({"0": Conv2d(c, c // compress, 3, **kw),
                                  "2": Conv2d(c // compress, c, 3, **kw), "3": att})

    def forward(self, x):               # NHWC
        h = conv_nhwc(self.cab["2"], F.gelu(conv_nhwc(self.cab["0"], x)))
        a = self.cab["3"].attention
        pooled = h.mean(dim=(1, 2), keepdim=True)
        return h * torch.sigmoid(conv_nhwc(a["3"], F.relu(conv_nhwc(a["1"], pooled))))


class HAB(nn.Module):
    def __init__(self, cfg: HATConfig, heads: int, kw: dict):
        super().__init__()
        e = cfg.embed_dim
        self.norm1 = LayerNorm(e, **kw)
        self.attn = WindowAttention(e, heads, cfg.window_size, kw)
        self.conv_block = CAB(e, cfg.compress_ratio, cfg.squeeze_factor, kw)
        self.norm2 = LayerNorm(e, **kw)
        self.mlp = Mlp(e, int(e * cfg.mlp_ratio), kw)

    def forward(self, t, hh, ww, cfg: HATConfig, shift, rpi, mask):
        b, _, c = t.shape
        win = cfg.window_size
        img = self.norm1(t).reshape(b, hh, ww, c)
        conv_x = self.conv_block(img)
        if shift > 0:
            img = torch.roll(img, (-shift, -shift), dims=(1, 2))
        wins = self.attn(window_partition(img, win), rpi, mask if shift > 0 else None)
        img = window_reverse(wins, win, b, hh, ww)
        if shift > 0:
            img = torch.roll(img, (shift, shift), dims=(1, 2))
        t = t + img.reshape(b, hh * ww, c) + conv_x.reshape(b, hh * ww, c) * cfg.conv_scale
        return t + self.mlp(self.norm2(t))


def unfold_overlap(img, win: int, owin: int):
    """(B, H, W, C) → (B·nW, owin², C): overlapping owin×owin patches at
    stride win, zero-padded by (owin − win)/2 (torch's F.unfold, as
    hat.py:138-152 gathers them)."""
    b, hh, ww, c = img.shape
    pad = (owin - win) // 2
    xp = F.pad(img, (0, 0, pad, pad, pad, pad))
    t = xp.unfold(1, owin, win).unfold(2, owin, win)       # (B, nh, nw, C, owin, owin)
    return t.permute(0, 1, 2, 4, 5, 3).reshape(-1, owin * owin, c)


class OCAB(nn.Module):
    def __init__(self, cfg: HATConfig, heads: int, kw: dict):
        super().__init__()
        e = cfg.embed_dim
        self.heads = heads
        self.norm1 = LayerNorm(e, **kw)
        self.qkv = Linear(e, 3 * e, **kw)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty(((cfg.window_size + cfg.overlap_win - 1) ** 2, heads), **kw),
            requires_grad=False)
        self.proj = Linear(e, e, **kw)
        self.norm2 = LayerNorm(e, **kw)
        self.mlp = Mlp(e, int(e * cfg.mlp_ratio), kw)

    def forward(self, t, hh, ww, cfg: HATConfig, rpi):
        b, _, c = t.shape
        win, owin, h = cfg.window_size, cfg.overlap_win, self.heads
        d = c // h
        qkv = self.qkv(self.norm1(t)).reshape(b, hh, ww, 3, c)
        qw = window_partition(qkv[..., 0, :], win)                       # (B·nW, win², C)
        kvw = unfold_overlap(qkv[..., 1:, :].reshape(b, hh, ww, 2 * c), win, owin)
        nq, nk = win * win, owin * owin
        q, k, v = heads_of(qw, h), heads_of(kvw[..., :c], h), heads_of(kvw[..., c:], h)
        attn = torch.matmul(q * (d ** -0.5), k.transpose(-1, -2))
        bias = self.relative_position_bias_table[rpi.reshape(-1)]
        attn = attn + bias.reshape(nq, nk, h).permute(2, 0, 1)[None]
        out = window_reverse(windowed_softmax_av(attn, v), win, b, hh, ww)
        t = t + self.proj(out.reshape(b, hh * ww, c))
        return t + self.mlp(self.norm2(t))


class RHAG(nn.Module):
    def __init__(self, cfg: HATConfig, depth: int, heads: int, kw: dict):
        super().__init__()
        e = cfg.embed_dim
        self.residual_group = BlockGroup(HAB(cfg, heads, kw) for _ in range(depth))
        self.residual_group.overlap_attn = OCAB(cfg, heads, kw)
        self.conv = Conv2d(e, e, 3, **kw)

    def forward(self, t, hh, ww, cfg: HATConfig, rpi_sa, rpi_o, mask):
        b, _, c = t.shape
        tin = t
        for j, blk in enumerate(self.residual_group.blocks):
            t = blk(t, hh, ww, cfg, 0 if j % 2 == 0 else cfg.window_size // 2, rpi_sa, mask)
        t = self.residual_group.overlap_attn(t, hh, ww, cfg, rpi_o)
        return conv_nhwc(self.conv, t.reshape(b, hh, ww, c)).reshape(b, hh * ww, c) + tin


class HAT(nn.Module):
    """forward: (B, H, W, in_chans) in [0, 1], H and W multiples of the
    window → (B, scale·H, scale·W, in_chans) clipped to [0, 1]."""

    def __init__(self, cfg: HATConfig, device="cpu", dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        e, nf, cin = cfg.embed_dim, cfg.num_feat, cfg.in_chans
        self.conv_first = Conv2d(cin, e, 3, **kw)
        if cfg.patch_norm:
            self.patch_embed = nn.Module()
            self.patch_embed.norm = LayerNorm(e, **kw)
        self.layers = nn.ModuleList(RHAG(cfg, d, h, kw)
                                    for d, h in zip(cfg.depths, cfg.num_heads))
        self.norm = LayerNorm(e, **kw)
        self.conv_after_body = Conv2d(e, e, 3, **kw)
        self.conv_before_upsample = nn.ModuleDict({"0": Conv2d(e, nf, 3, **kw)})
        self.upsample = upsample_convs(nf, cfg.scale, kw)
        self.conv_last = Conv2d(nf, cin, 3, **kw)

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
        rpi_sa = device_const(relative_position_index, win, device=x.device)
        rpi_o = device_const(rpi_oca, win, cfg.overlap_win, device=x.device)
        mask = device_const(shift_attn_mask, h, w, win, win // 2, device=x.device)
        mean = torch.tensor(RGB_MEAN if cfg.in_chans == 3 else (0.5,), device=x.device)
        feat = conv_nhwc(self.conv_first, (x - mean) * cfg.img_range).contiguous()
        t = feat.reshape(b, h * w, cfg.embed_dim)
        for layer in self.layers:
            t = layer(t, h, w, cfg, rpi_sa, rpi_o, mask)
        t = self.norm(t)
        feat = conv_nhwc(self.conv_after_body, t.reshape(b, h, w, cfg.embed_dim)) + feat
        return upsample_tail(self, feat, "pixelshuffle", cfg.scale, mean, cfg.img_range)


# --------------------------------------------------------------------------
# loading
# --------------------------------------------------------------------------

def derive_hat_config(sd: dict) -> HATConfig:
    """The architecture from weight shapes (hat.py:238-276)."""
    embed, in_chans = (int(n) for n in sd["conv_first.weight"].shape[:2])
    depths, heads = [], []
    for i in range(n_indexed(sd, "layers.")):
        pre = f"layers.{i}.residual_group.blocks."
        depths.append(n_indexed(sd, pre))
        heads.append(int(sd[f"{pre}0.attn.relative_position_bias_table"].shape[1]))
    tbl = sd["layers.0.residual_group.blocks.0.attn.relative_position_bias_table"]
    win = (int(np.sqrt(tbl.shape[0])) + 1) // 2
    otbl = sd["layers.0.residual_group.overlap_attn.relative_position_bias_table"]
    owin = int(np.sqrt(otbl.shape[0])) + 1 - win
    blk = "layers.0.residual_group.blocks.0."
    compress = embed // int(sd[blk + "conv_block.cab.0.weight"].shape[0])
    squeeze = embed // int(sd[blk + "conv_block.cab.3.attention.1.weight"].shape[0])
    mlp_ratio = sd[blk + "mlp.fc1.weight"].shape[0] / embed
    num_feat = int(sd["conv_before_upsample.0.weight"].shape[0])
    scale, k = 1, 0
    while f"upsample.{k}.weight" in sd:
        scale *= {4: 2, 9: 3}.get(int(sd[f"upsample.{k}.weight"].shape[0]) // num_feat, 2)
        k += 2
    return HATConfig(embed_dim=embed, depths=tuple(depths), num_heads=tuple(heads),
                     window_size=win, overlap_ratio=(owin - win) / win,
                     compress_ratio=compress, squeeze_factor=squeeze,
                     mlp_ratio=float(mlp_ratio), scale=scale, in_chans=in_chans,
                     num_feat=num_feat, patch_norm="patch_embed.norm.weight" in sd)


_DROP = ("attn_mask", "relative_position_index", "relative_position_index_SA",
         "relative_position_index_OCA", "rpi_sa", "rpi_oca")


def hat_from_state_dict(sd: dict, device="cuda") -> HAT:
    """A HAT file's state dict (the release's keys; wrappers stripped, the
    recomputed buffers dropped) → the net in f32 on `device`."""
    sd = nest_sequential(strip_wrappers(sd), "conv_before_upsample")
    sd = {k: v for k, v in sd.items() if k.split(".")[-1] not in _DROP}
    return assign_f32(HAT(derive_hat_config(sd), device="meta"), sd, get_device(device))


def hat_from_jax(tree: dict, device="cpu") -> HAT:
    """The JAX package's HAT tree (``convert_hat`` / ``init_params``) → the net."""
    return hat_from_state_dict(state_dict_from_jax(tree), device)


#: Real_HAT_GAN_SRx4: embed 180, 6 groups of 6 HABs, 6 heads, window 16,
#: overlap 0.5, compress 3, squeeze 30, 64 features, x4 pixelshuffle
REAL_HAT_GAN_X4 = HATConfig(squeeze_factor=30, patch_norm=True)


def create_random_hat(seed: int = 0, device="cuda", cfg: HATConfig = REAL_HAT_GAN_X4) -> HAT:
    """A seeded random HAT at `cfg`, f32, the last conv's weights × 0.2
    (the output then stays mostly inside [0, 1])."""
    net = randomize(HAT(cfg, device=get_device(device)), seed)
    with torch.no_grad():
        net.conv_last.weight.mul_(0.2)
    return net


def upscale_image(net: HAT, image: np.ndarray, tile: int | None = None,
                  overlap: int | None = None) -> np.ndarray:
    """RGB uint8 (H, W, 3) → (scale·H, scale·W, 3) through
    ``tiled_sr_upscale`` (opts.ESRGAN_tile / ESRGAN_tile_overlap)."""
    return tiled_sr_upscale(nhwc_runner(net), net.scale, net.pad_multiple, image,
                            tile=tile, overlap=overlap)


def register_hat_dir(dirs=("models/HAT",), device="cuda") -> list:
    """Register every .pth / .pt / .safetensors file of `dirs` as an
    upscaler named by its file, run on `device` (hat.py:394)."""
    from sdwebui_tpu_torch.models.swinir import model_files, read_state_dict, register_lazy

    device = get_device(device)
    found = []
    for name, path in model_files(dirs, exts=(".pth", ".pt", ".safetensors")):
        register_lazy(name, path, lambda p: hat_from_state_dict(read_state_dict(p), device),
                      lambda net, image, scale: upscale_image(net, image))
        found.append(name)
    return found
