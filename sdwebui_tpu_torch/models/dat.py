"""DAT super-resolution (Dual Aggregation Transformer, Chen et al. ICCV
2023) — port of ``sdwebui_tpu/models/dat.py``.

Each residual group alternates two block types (``dat.py:287-330``):

* even blocks: adaptive spatial attention — two rectangle-window branches
  (windows (s0, s1) and (s1, s0), each on half the channels with half the
  heads, a dynamic position-bias MLP, shifted on the blocks
  ``_is_shifted`` picks) beside a depthwise-conv branch, coupled by the
  adaptive interaction module (``dat.py:180-250``);
* odd blocks: adaptive channel attention — Restormer's transposed
  attention (L2-normalised q and k over the tokens, a learned per-head
  temperature) with the same conv branch, the interaction maps swapped
  (``dat.py:251-274``).

The FFN is the spatial-gate FFN: fc1 → GELU → split, one half gated by a
depthwise conv of the LayerNormed other half → fc2 (``dat.py:276-284``).
BatchNorms run in eval form from their running statistics.  The windows
ride one batched ``torch.matmul`` with fp32 scores; every LayerNorm goes
through B5: the blocks' (C = 180), the gate's (C = 360 at expansion 4) and
the position-bias MLPs' (C = 5 at embed 180).

Parameter names are the release's keys; the split size is read from the
position-bias buffers (``_split_from_buffers``, ``dat.py:364-385``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sdwebui_tpu_torch.models.layers import Conv2d, LayerNorm, Linear, assign_f32
from sdwebui_tpu_torch.models.swinir import (RGB_MEAN, upsample_convs, conv_nhwc,
                                             device_const, heads_of, make_resi_conv,
                                             n_indexed, nhwc_runner, randomize, resi_conv,
                                             run_upsample_ladder, state_dict_from_jax,
                                             strip_wrappers, windowed_softmax_av)
from sdwebui_tpu_torch.postprocessing.upscalers import tiled_sr_upscale
from sdwebui_tpu_torch.utils.devices import get_device
from sdwebui_tpu_torch.utils.options import opts


@dataclasses.dataclass(frozen=True)
class DATConfig:
    embed_dim: int = 180
    depths: tuple = (6, 6, 6, 6, 6, 6)
    num_heads: tuple = (6, 6, 6, 6, 6, 6)
    split_size: tuple = (8, 32)
    expansion_factor: float = 4.0
    scale: int = 4
    in_chans: int = 3
    img_range: float = 1.0
    resi_connection: str = "1conv"       # or "3conv"
    upsampler: str = "pixelshuffle"      # or "pixelshuffledirect"
    num_feat: int = 64

    @property
    def shift_size(self) -> tuple:
        return (self.split_size[0] // 2, self.split_size[1] // 2)


# --------------------------------------------------------------------------
# host constants: copies of dat.py:89-128
# --------------------------------------------------------------------------

def rect_rpi(wh: int, ww: int) -> np.ndarray:
    """(N, N) lookup into the ((2wh-1)·(2ww-1), heads) dynamic bias table."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[..., 0] += wh - 1
    rel[..., 1] += ww - 1
    rel[..., 0] *= 2 * ww - 1
    return rel.sum(-1)


def rect_rpe_biases(wh: int, ww: int) -> np.ndarray:
    """((2wh-1)·(2ww-1), 2) relative-offset inputs to the pos-bias MLP."""
    bh = np.arange(1 - wh, wh)
    bw = np.arange(1 - ww, ww)
    return np.stack(np.meshgrid(bh, bw, indexing="ij")) \
        .reshape(2, -1).T.astype(np.float32)


def rect_shift_mask(hh: int, ww_img: int, wh: int, ww: int,
                    sh: int, sw: int) -> np.ndarray:
    """Swin-style attention mask for rect windows (wh, ww) rolled by
    (sh, sw): (nW, N, N) with -100 across region boundaries."""
    img = np.zeros((hh, ww_img))
    cnt = 0
    for hs in (slice(0, -wh), slice(-wh, -sh), slice(-sh, None)):
        for ws in (slice(0, -ww), slice(-ww, -sw), slice(-sw, None)):
            img[hs, ws] = cnt
            cnt += 1
    wins = img.reshape(hh // wh, wh, ww_img // ww, ww) \
        .transpose(0, 2, 1, 3).reshape(-1, wh * ww)
    diff = wins[:, None, :] - wins[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def rect_partition(img, wh: int, ww: int):
    """(B, H, W, C) → (B·nW, wh·ww, C)"""
    b, hh, www, c = img.shape
    x = img.reshape(b, hh // wh, wh, www // ww, ww, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, wh * ww, c)


def rect_reverse(wins, wh: int, ww: int, b: int, hh: int, www: int):
    c = wins.shape[-1]
    x = wins.reshape(b, hh // wh, www // ww, wh, ww, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, hh, www, c)


def is_shifted(rg_idx: int, b_idx: int) -> bool:
    """Which spatial blocks use the shifted windows (dat.py:287-290)."""
    return (rg_idx % 2 == 0 and b_idx > 0 and (b_idx - 2) % 4 == 0) or \
        (rg_idx % 2 != 0 and b_idx % 4 == 0)


# --------------------------------------------------------------------------
# primitive blocks
# --------------------------------------------------------------------------

class BatchNorm(nn.Module):
    """Eval-mode BatchNorm2d from running stats, on (…, C) channel-last."""

    def __init__(self, c: int, kw: dict):
        super().__init__()
        for name in ("weight", "bias", "running_mean", "running_var"):
            setattr(self, name, nn.Parameter(torch.empty((c,), **kw), requires_grad=False))

    def forward(self, x, eps: float = 1e-5):
        scale = self.weight / torch.sqrt(self.running_var + eps)
        return (x - self.running_mean) * scale + self.bias


class DWConv(nn.Module):
    """Depthwise 3×3 conv with bias, on NHWC maps."""

    def __init__(self, c: int, kw: dict):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((c, 1, 3, 3), **kw), requires_grad=False)
        self.bias = nn.Parameter(torch.empty((c,), **kw), requires_grad=False)

    def forward(self, x):
        out = F.conv2d(x.permute(0, 3, 1, 2), self.weight, self.bias, 1, 1, 1, x.shape[-1])
        return out.permute(0, 2, 3, 1)


class Interactions(nn.Module):
    """The conv branch and the adaptive interaction module's two maps:
    dwconv.{0,1}, channel_interaction.{1,2,4}, spatial_interaction.{0,1,3}."""

    def __init__(self, c: int, kw: dict):
        super().__init__()
        self.dwconv = nn.ModuleDict({"0": DWConv(c, kw), "1": BatchNorm(c, kw)})
        self.channel_interaction = nn.ModuleDict({
            "1": Conv2d(c, c // 8, 1, **kw), "2": BatchNorm(c // 8, kw),
            "4": Conv2d(c // 8, c, 1, **kw)})
        self.spatial_interaction = nn.ModuleDict({
            "0": Conv2d(c, c // 16, 1, **kw), "1": BatchNorm(c // 16, kw),
            "3": Conv2d(c // 16, 1, 1, **kw)})

    def conv_branch(self, x):                   # NHWC → NHWC
        return F.gelu(self.dwconv["1"](self.dwconv["0"](x)))

    def channel_map(self, x):                   # NHWC → (B, 1, 1, C)
        m = self.channel_interaction
        h = conv_nhwc(m["1"], x.mean(dim=(1, 2), keepdim=True))
        return conv_nhwc(m["4"], F.gelu(m["2"](h)))

    def spatial_map(self, x):                   # NHWC → (B, H, W, 1)
        m = self.spatial_interaction
        return conv_nhwc(m["3"], F.gelu(m["1"](conv_nhwc(m["0"], x))))


class DynamicPosBias(nn.Module):
    """Linear(2 → pd), then 3 × (LN → ReLU → Linear); keys pos_proj,
    pos{1,2,3}.{0,2}."""

    def __init__(self, pd: int, heads: int, kw: dict):
        super().__init__()
        self.pos_proj = Linear(2, pd, **kw)
        for i, out in ((1, pd), (2, pd), (3, heads)):
            setattr(self, f"pos{i}", nn.ModuleDict({"0": LayerNorm(pd, **kw),
                                                    "2": Linear(pd, out, **kw)}))

    def forward(self, biases):
        h = self.pos_proj(biases)
        for m in (self.pos1, self.pos2, self.pos3):
            h = m["2"](F.relu(m["0"](h)))
        return h                                   # (n_offsets, heads)


class SpatialBranch(nn.Module):
    def __init__(self, pd: int, heads: int, kw: dict):
        super().__init__()
        self.pos = DynamicPosBias(pd, heads, kw)

    def forward(self, q, k, v, hh, ww_img, wh, ww, heads, mask):
        """One rect-window branch on (B, H, W, Cb) q/k/v (dat.py:157-177)."""
        b, cb = q.shape[0], q.shape[-1]
        d, n = cb // heads, wh * ww
        qw, kw_, vw = (heads_of(rect_partition(t, wh, ww), heads) for t in (q, k, v))
        attn = torch.matmul(qw * (d ** -0.5), kw_.transpose(-1, -2))
        bias = self.pos(device_const(rect_rpe_biases, wh, ww, device=q.device))
        rpi = device_const(rect_rpi, wh, ww, device=q.device)
        attn = attn + bias[rpi.reshape(-1)].reshape(n, n, heads).permute(2, 0, 1)[None]
        return rect_reverse(windowed_softmax_av(attn, vw, mask), wh, ww, b, hh, ww_img)


class SpatialAttention(Interactions):
    """Adaptive spatial attention (dat.py:180-248)."""

    def __init__(self, c: int, heads: int, kw: dict):
        super().__init__(c, kw)
        self.qkv = Linear(c, 3 * c, **kw)
        self.proj = Linear(c, c, **kw)
        pd = ((c // 2) // 4) // 4
        self.attns = nn.ModuleList(SpatialBranch(pd, heads // 2, kw) for _ in range(2))

    def forward(self, x, hh, ww_img, cfg: DATConfig, heads: int, shifted: bool):
        b, n, c = x.shape
        s0, s1 = cfg.split_size
        sh0, sh1 = cfg.shift_size
        qkv = self.qkv(x).reshape(b, hh, ww_img, 3, c)
        q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
        halves = []
        for idx in range(2):
            sl = slice(0, c // 2) if idx == 0 else slice(c // 2, None)
            wh, ww = (s0, s1) if idx == 0 else (s1, s0)
            rh, rw = (sh0, sh1) if idx == 0 else (sh1, sh0)
            qi, ki, vi = q[..., sl], k[..., sl], v[..., sl]
            mask = None
            if shifted:
                qi, ki, vi = (torch.roll(t, (-rh, -rw), dims=(1, 2)) for t in (qi, ki, vi))
                mask = device_const(rect_shift_mask, hh, ww_img, wh, ww, rh, rw,
                                    device=x.device)
            hx = self.attns[idx](qi, ki, vi, hh, ww_img, wh, ww, heads // 2, mask)
            if shifted:
                hx = torch.roll(hx, (rh, rw), dims=(1, 2))
            halves.append(hx)
        attened = torch.cat(halves, dim=-1).reshape(b, n, c)
        conv_x = self.conv_branch(v)                                    # (B, H, W, C)
        channel_map = self.channel_map(conv_x).reshape(b, 1, c)
        spatial_map = self.spatial_map(attened.reshape(b, hh, ww_img, c))
        attened = attened * torch.sigmoid(channel_map)
        conv_x = conv_x * torch.sigmoid(spatial_map)
        return self.proj(attened + conv_x.reshape(b, n, c))


class ChannelAttention(Interactions):
    """Adaptive channel attention (dat.py:251-274)."""

    def __init__(self, c: int, heads: int, kw: dict):
        super().__init__(c, kw)
        self.qkv = Linear(c, 3 * c, **kw)
        self.proj = Linear(c, c, **kw)
        self.temperature = nn.Parameter(torch.empty((heads, 1, 1), **kw), requires_grad=False)

    def forward(self, x, hh, ww_img, heads: int):
        b, n, c = x.shape
        d = c // heads
        qkv = self.qkv(x).reshape(b, n, 3, heads, d).permute(2, 0, 3, 4, 1)
        q, k, v = qkv[0], qkv[1], qkv[2]                       # (B, h, d, N)
        q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-12)
        k = k / torch.clamp(torch.linalg.vector_norm(k, dim=-1, keepdim=True), min=1e-12)
        attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * self.temperature[None],
                             dim=-1)
        out = torch.matmul(attn, v).permute(0, 3, 1, 2).reshape(b, n, c)
        v_img = v.permute(0, 3, 1, 2).reshape(b, hh, ww_img, c)
        conv_x = self.conv_branch(v_img)
        channel_map = self.channel_map(out.reshape(b, hh, ww_img, c))
        spatial_map = self.spatial_map(conv_x).reshape(b, n, 1)
        out = out * torch.sigmoid(spatial_map)
        conv_x = conv_x * torch.sigmoid(channel_map)
        return self.proj(out + conv_x.reshape(b, n, c))


class SGFN(nn.Module):
    """fc1 → GELU → spatial gate (LN + dwconv on one half) → fc2."""

    def __init__(self, c: int, hidden: int, kw: dict):
        super().__init__()
        self.fc1 = Linear(c, hidden, **kw)
        self.sg = nn.Module()
        self.sg.norm = LayerNorm(hidden // 2, **kw)
        self.sg.conv = DWConv(hidden // 2, kw)
        self.fc2 = Linear(hidden // 2, c, **kw)

    def forward(self, x, hh, ww_img):
        b, n, _ = x.shape
        h = F.gelu(self.fc1(x))
        half = h.shape[-1] // 2
        x1, x2 = h[..., :half], h[..., half:]
        x2 = self.sg.conv(self.sg.norm(x2).reshape(b, hh, ww_img, half))
        return self.fc2(x1 * x2.reshape(b, n, half))


class DATB(nn.Module):
    def __init__(self, cfg: DATConfig, heads: int, spatial: bool, kw: dict):
        super().__init__()
        e = cfg.embed_dim
        self.norm1 = LayerNorm(e, **kw)
        self.attn = SpatialAttention(e, heads, kw) if spatial else ChannelAttention(e, heads, kw)
        self.norm2 = LayerNorm(e, **kw)
        self.ffn = SGFN(e, int(e * cfg.expansion_factor), kw)

    def forward(self, x, hh, ww_img, cfg: DATConfig, heads, rg_idx, b_idx):
        h = self.norm1(x)
        if isinstance(self.attn, SpatialAttention):
            h = self.attn(h, hh, ww_img, cfg, heads, is_shifted(rg_idx, b_idx))
        else:
            h = self.attn(h, hh, ww_img, heads)
        x = x + h
        return x + self.ffn(self.norm2(x), hh, ww_img)


class ResidualGroup(nn.Module):
    def __init__(self, cfg: DATConfig, depth: int, heads: int, kw: dict):
        super().__init__()
        self.blocks = nn.ModuleList(DATB(cfg, heads, j % 2 == 0, kw) for j in range(depth))
        self.conv = make_resi_conv(cfg.embed_dim, cfg.resi_connection, kw)

    def forward(self, x, hh, ww_img, cfg, heads, rg_idx):
        b, n, c = x.shape
        res = x
        for j, blk in enumerate(self.blocks):
            x = blk(x, hh, ww_img, cfg, heads, rg_idx, j)
        return resi_conv(self.conv, x.reshape(b, hh, ww_img, c)).reshape(b, n, c) + res


class DAT(nn.Module):
    """forward: (B, H, W, in_chans) in [0, 1], H and W multiples of
    max(split_size) → (B, scale·H, scale·W, in_chans) clipped to [0, 1]."""

    def __init__(self, cfg: DATConfig, device="cpu", dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        e, nf, cin = cfg.embed_dim, cfg.num_feat, cfg.in_chans
        self.conv_first = Conv2d(cin, e, 3, **kw)
        self.before_RG = nn.ModuleDict({"1": LayerNorm(e, **kw)})
        self.layers = nn.ModuleList(ResidualGroup(cfg, d, h, kw)
                                    for d, h in zip(cfg.depths, cfg.num_heads))
        self.norm = LayerNorm(e, **kw)
        self.conv_after_body = make_resi_conv(e, cfg.resi_connection, kw)
        if cfg.upsampler == "pixelshuffle":
            self.conv_before_upsample = nn.ModuleDict({"0": Conv2d(e, nf, 3, **kw)})
            self.upsample = upsample_convs(nf, cfg.scale, kw)
            self.conv_last = Conv2d(nf, cin, 3, **kw)
        else:
            self.upsample = nn.ModuleDict({"0": Conv2d(e, cin * cfg.scale ** 2, 3, **kw)})

    @property
    def scale(self) -> int:
        return self.cfg.scale

    @property
    def pad_multiple(self) -> int:
        return max(self.cfg.split_size)

    def forward(self, x):
        cfg = self.cfg
        b, h, w, _ = x.shape
        if h % self.pad_multiple or w % self.pad_multiple:
            raise ValueError(f"input {h}x{w} is not a multiple of {self.pad_multiple}")
        mean = torch.tensor(RGB_MEAN if cfg.in_chans == 3 else (0.5,), device=x.device)
        feat = conv_nhwc(self.conv_first, (x - mean) * cfg.img_range).contiguous()
        t = self.before_RG["1"](feat.reshape(b, h * w, cfg.embed_dim))
        for i, layer in enumerate(self.layers):
            t = layer(t, h, w, cfg, cfg.num_heads[i], i)
        t = self.norm(t)
        feat = resi_conv(self.conv_after_body, t.reshape(b, h, w, cfg.embed_dim)) + feat
        f = feat.permute(0, 3, 1, 2)
        if cfg.upsampler == "pixelshuffle":
            f = F.leaky_relu(self.conv_before_upsample["0"](f), 0.01)
            out = self.conv_last(run_upsample_ladder(self.upsample, f, cfg.scale))
        else:
            out = F.pixel_shuffle(self.upsample["0"](f), cfg.scale)
        return torch.clamp(out.permute(0, 2, 3, 1) / cfg.img_range + mean, 0.0, 1.0)


# --------------------------------------------------------------------------
# loading
# --------------------------------------------------------------------------

def split_from_buffers(sd: dict) -> tuple:
    """(s0, s1) from the branch-0 position-bias buffers (dat.py:364-385):
    rpe_biases has (2s0-1)(2s1-1) rows, relative_position_index is
    (s0·s1)², and its contents tell (s0, s1) from (s1, s0); (8, 32) when
    the file holds neither."""
    key = next((k for k in sd if k.endswith("attn.attns.0.rpe_biases")), None)
    idx_key = next((k for k in sd if k.endswith("attn.attns.0.relative_position_index")), None)
    if key is None or idx_key is None:
        return (8, 32)
    m = int(sd[key].shape[0])
    idx = np.asarray(sd[idx_key])
    n = int(round(np.sqrt(idx.size)))
    for s0 in range(1, n + 1):
        if n % s0:
            continue
        s1 = n // s0
        if (2 * s0 - 1) * (2 * s1 - 1) == m and np.array_equal(rect_rpi(s0, s1),
                                                                  idx.reshape(n, n)):
            return (s0, s1)
    return (8, 32)


def derive_dat_config(sd: dict, split_size=None) -> DATConfig:
    """The architecture from weight shapes (dat.py:388-436)."""
    embed, in_chans = (int(n) for n in sd["conv_first.weight"].shape[:2])
    depths, heads = [], []
    for i in range(n_indexed(sd, "layers.")):
        depths.append(n_indexed(sd, f"layers.{i}.blocks."))
        tkey = f"layers.{i}.blocks.1.attn.temperature"
        heads.append(int(sd[tkey].shape[0]) if tkey in sd else 2 * int(
            sd[f"layers.{i}.blocks.0.attn.attns.0.pos.pos3.2.weight"].shape[0]))
    expansion = sd["layers.0.blocks.0.ffn.fc1.weight"].shape[0] / embed
    if "conv_before_upsample.0.weight" in sd:
        upsampler = "pixelshuffle"
        num_feat = int(sd["conv_before_upsample.0.weight"].shape[0])
        scale, k = 1, 0
        while f"upsample.{k}.weight" in sd:
            scale *= {4: 2, 9: 3}.get(int(sd[f"upsample.{k}.weight"].shape[0]) // num_feat, 2)
            k += 2
    else:
        upsampler, num_feat = "pixelshuffledirect", 64
        scale = int(round(np.sqrt(int(sd["upsample.0.weight"].shape[0]) // in_chans)))
    return DATConfig(embed_dim=embed, depths=tuple(depths), num_heads=tuple(heads),
                     split_size=tuple(split_size or split_from_buffers(sd)),
                     expansion_factor=float(expansion), scale=scale, in_chans=in_chans,
                     resi_connection="1conv" if "layers.0.conv.weight" in sd else "3conv",
                     upsampler=upsampler, num_feat=num_feat)


_SKIP = ("rpe_biases", "relative_position_index", "attn_mask_0", "attn_mask_1",
         "num_batches_tracked", "mean")


def dat_from_state_dict(sd: dict, device="cuda", split_size=None) -> DAT:
    """A DAT file's state dict (the release's keys; wrappers stripped, the
    recomputed buffers dropped) → the net in f32 on `device`."""
    sd = strip_wrappers(sd)
    cfg = derive_dat_config(sd, split_size)
    sd = {k: v for k, v in sd.items() if k.split(".")[-1] not in _SKIP}
    return assign_f32(DAT(cfg, device="meta"), sd, get_device(device))


def dat_from_jax(tree: dict, split_size: tuple, device="cpu") -> DAT:
    """The JAX package's DAT tree (``convert_dat`` / ``init_params``) → the
    net; a tree keeps no buffers, so the split size is given."""
    return dat_from_state_dict(state_dict_from_jax(tree), device, split_size)


#: DAT x4, the release's widths: embed 180, 6 groups of 6 blocks, 6 heads,
#: split (8, 32), expansion 4, 1conv, pixelshuffle with 64 features
DAT_X4 = DATConfig()


def create_random_dat(seed: int = 0, device="cuda", cfg: DATConfig = DAT_X4) -> DAT:
    """A seeded random DAT at `cfg`, f32: BatchNorms at unit variance and
    zero mean, temperatures 1, the last conv's weights × 0.2 (the output
    then stays mostly inside [0, 1])."""
    net = randomize(DAT(cfg, device=get_device(device)), seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
            elif isinstance(m, ChannelAttention):
                m.temperature.fill_(1.0)
        if hasattr(net, "conv_last"):
            net.conv_last.weight.mul_(0.2)
    return net


def state_dict_with_buffers(net: DAT) -> dict:
    """The net's state dict plus the release's branch-0 position-bias
    buffers, from which a loader reads the split size back."""
    sd = dict(net.state_dict())
    s0, s1 = net.cfg.split_size
    for i, layer in enumerate(net.layers):
        pre = f"layers.{i}.blocks.0.attn.attns.0."
        sd[pre + "rpe_biases"] = torch.from_numpy(rect_rpe_biases(s0, s1))
        sd[pre + "relative_position_index"] = torch.from_numpy(rect_rpi(s0, s1))
    return sd


def upscale_image(net: DAT, image: np.ndarray, tile: int | None = None,
                  overlap: int | None = None) -> np.ndarray:
    """RGB uint8 (H, W, 3) → (scale·H, scale·W, 3): DAT's own tile options
    (opts.DAT_tile / DAT_tile_overlap, dat.py:572), max(split_size) pad."""
    if tile is None:
        tile = int(opts.get("DAT_tile", 192) or 0)
    if overlap is None:
        overlap = int(opts.get("DAT_tile_overlap", 8))
    return tiled_sr_upscale(nhwc_runner(net), net.scale, net.pad_multiple, image,
                            tile=tile, overlap=overlap)


def register_dat_dir(dirs=("models/DAT",), device="cuda") -> list:
    """Register every .pth / .pt / .safetensors file of `dirs` as an
    upscaler named by its file, run on `device` (dat.py:584)."""
    from sdwebui_tpu_torch.models.swinir import model_files, read_state_dict, register_lazy

    device = get_device(device)
    found = []
    for name, path in model_files(dirs):
        register_lazy(name, path, lambda p: dat_from_state_dict(read_state_dict(p), device),
                      lambda net, image, scale: upscale_image(net, image))
        found.append(name)
    return found
