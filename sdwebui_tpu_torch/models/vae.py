"""AutoencoderKL (the ``first_stage_model``) — encode and decode, NCHW.

Port of ``sdwebui_tpu/models/vae.py:29-139``.  Parameter names are the
``first_stage_model.*`` keys with the prefix stripped.  The ldm encoder
pads each downsample asymmetrically (0, 1, 0, 1) before a stride-2 VALID
conv; the decoder runs ``up`` in reverse (``up.3`` first, at the lowest
resolution); all norms are GroupNorm(32, eps=1e-6); the mid-block
attention is single-head over H·W tokens and goes through
``ops.attention`` (the flash kernel B1 at 512² encode and decode sizes).
A ``tiling`` decode wraps the padding of the decoder's 3×3 convs
(``vae.py:117-139``); the encoder never does, as in JAX.

Row-sharded (``parallel/spatial``, inside
``collectives.spatial_sharding``): the 3×3 convs exchange halo rows and
GroupNorm sums its statistics over the shards (``models/layers``,
``ops/norms``); the mid-block attention keeps q local and all-gathers k
and v, so B1 runs at Sq = S/n, Skv = S (``vae.py:39-53``); the encoder's
stride-2 downsample takes its one extra row from the shard below, zeros
at the bottom (``vae.py:73-92``); the decoder's upsample already runs as
upsample-then-conv, the form JAX keeps for sharded rows (``vae.py:127-135``).

``VQModel`` is LDSR's first stage, a VQGAN with ``double_z: false`` (the
encoder's conv_out and quant_conv z-wide, a codebook under
``quantize.embedding``): ``vq_quantize`` picks each latent's nearest
codebook row by ‖h‖² − 2h·cb + ‖cb‖² in fp32 (``ldsr.py:52-60``) and
``vq_decode`` decodes the quantized latent through the same decoder.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sdwebui_tpu_torch.models.configs import VAEConfig
from sdwebui_tpu_torch.models.layers import (Conv2d, Embedding, GroupNorm, conv2d,
                                             upsample_nearest_2x)
from sdwebui_tpu_torch.ops.attention import attention
from sdwebui_tpu_torch.parallel import collectives


class ResnetBlock(nn.Module):
    def __init__(self, cin, cout, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = GroupNorm(cin, eps=1e-6, **kw)
        self.conv1 = Conv2d(cin, cout, 3, **kw)
        self.norm2 = GroupNorm(cout, eps=1e-6, **kw)
        self.conv2 = Conv2d(cout, cout, 3, **kw)
        self.nin_shortcut = Conv2d(cin, cout, 1, **kw) if cin != cout else None

    def forward(self, x, circular: bool = False):
        h = self.conv1(self.norm1(x, silu=True), circular)
        h = self.conv2(self.norm2(h, silu=True), circular)
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    def __init__(self, c, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm = GroupNorm(c, eps=1e-6, **kw)
        self.q = Conv2d(c, c, 1, **kw)
        self.k = Conv2d(c, c, 1, **kw)
        self.v = Conv2d(c, c, 1, **kw)
        self.proj_out = Conv2d(c, c, 1, **kw)

    def forward(self, x):
        b, c, h, w = x.shape
        hn = self.norm(x)

        def tokens(conv):   # (B, C, H, W) → (B, H·W, C), one head of width C
            return conv(hn).permute(0, 2, 3, 1).reshape(b, h * w, c)

        q, k, v = tokens(self.q), tokens(self.k), tokens(self.v)
        axis = collectives.spatial_axis()
        if axis is not None:     # q's rows are this shard's; k and v are every row
            k, v = collectives.all_gather(torch.stack([k, v]), axis, dim=2).unbind(0)
        out = attention(q, k, v)
        return x + self.proj_out(out.reshape(b, h, w, c).permute(0, 3, 1, 2))


def _mid(c, kw):
    return nn.ModuleDict({"block_1": ResnetBlock(c, c, **kw),
                          "attn_1": AttnBlock(c, **kw),
                          "block_2": ResnetBlock(c, c, **kw)})


class _Level(nn.Module):
    def __init__(self, blocks, resample_name=None, resample=None):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        if resample_name is not None:
            self.add_module(resample_name, resample)


class _Resample(nn.Module):
    def __init__(self, c, *, device, dtype):
        super().__init__()
        self.conv = Conv2d(c, c, 3, device=device, dtype=dtype)


def _pad_bottom_right(h):
    """ldm's (0, 1, 0, 1) pad before the stride-2 downsample; row-sharded,
    the bottom row is the first row of the shard below (zeros for the
    last shard)."""
    axis = collectives.spatial_axis()
    if axis is None:
        return F.pad(h, (0, 1, 0, 1))
    n = collectives.axis_size(axis)
    below = collectives.ppermute(h[:, :, :1], axis, [(i + 1, i) for i in range(n - 1)])
    return F.pad(torch.cat([h, below], dim=2), (0, 1, 0, 0))


class Encoder(nn.Module):

    def __init__(self, cfg: VAEConfig, *, device, dtype, double_z: bool = True):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        chs = [cfg.ch * m for m in cfg.ch_mult]
        self.conv_in = Conv2d(cfg.in_channels, cfg.ch, 3, **kw)
        levels = []
        ch = cfg.ch
        for level, out_ch in enumerate(chs):
            blocks = []
            for _ in range(cfg.num_res_blocks):
                blocks.append(ResnetBlock(ch, out_ch, **kw))
                ch = out_ch
            if level != len(chs) - 1:
                levels.append(_Level(blocks, "downsample", _Resample(ch, **kw)))
            else:
                levels.append(_Level(blocks))
        self.down = nn.ModuleList(levels)
        self.mid = _mid(chs[-1], kw)
        self.norm_out = GroupNorm(chs[-1], eps=1e-6, **kw)
        self.conv_out = Conv2d(chs[-1], (2 if double_z else 1) * cfg.z_channels, 3, **kw)

    def forward(self, x):
        h = self.conv_in(x)
        for lp in self.down:
            for block in lp.block:
                h = block(h)
            if hasattr(lp, "downsample"):
                conv = lp.downsample.conv
                h = conv2d(_pad_bottom_right(h), conv.weight, conv.bias, stride=2, padding=0)
        h = self.mid["block_1"](h)
        h = self.mid["attn_1"](h)
        h = self.mid["block_2"](h)
        return self.conv_out(self.norm_out(h, silu=True))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        chs = [cfg.ch * m for m in cfg.ch_mult]
        ch = chs[-1]
        self.conv_in = Conv2d(cfg.z_channels, ch, 3, **kw)
        self.mid = _mid(ch, kw)
        up = [None] * len(chs)
        for level in reversed(range(len(chs))):
            blocks = []
            for _ in range(cfg.num_res_blocks + 1):
                blocks.append(ResnetBlock(ch, chs[level], **kw))
                ch = chs[level]
            if level != 0:
                up[level] = _Level(blocks, "upsample", _Resample(ch, **kw))
            else:
                up[level] = _Level(blocks)
        self.up = nn.ModuleList(up)
        self.norm_out = GroupNorm(cfg.ch, eps=1e-6, **kw)
        self.conv_out = Conv2d(cfg.ch, cfg.out_ch, 3, **kw)

    def forward(self, z, circular: bool = False):
        """circular: every 3×3 conv wraps its padding (vae.py:117-139)."""
        h = self.conv_in(z, circular)
        h = self.mid["block_1"](h, circular)
        h = self.mid["attn_1"](h)
        h = self.mid["block_2"](h, circular)
        for level in reversed(range(len(self.up))):
            lp = self.up[level]
            for block in lp.block:
                h = block(h, circular)
            if hasattr(lp, "upsample"):
                h = lp.upsample.conv(upsample_nearest_2x(h), circular)
        return self.conv_out(self.norm_out(h, silu=True), circular)


class AutoencoderKL(nn.Module):
    """quant_conv False: SD3's VAE, whose published files hold no 1×1
    quant convs (the latent is the encoder's mean itself)."""

    def __init__(self, cfg: VAEConfig, *, device, dtype, double_z: bool = True,
                 quant_conv: bool = True):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.encoder = Encoder(cfg, double_z=double_z, **kw)
        self.decoder = Decoder(cfg, **kw)
        z = 2 if double_z else 1
        if quant_conv:
            self.quant_conv = Conv2d(z * cfg.z_channels, z * cfg.embed_dim, 1, **kw)
            self.post_quant_conv = Conv2d(cfg.embed_dim, cfg.z_channels, 1, **kw)
        else:
            self.quant_conv = self.post_quant_conv = nn.Identity()

    def decode(self, z, tiling: bool = False):
        """scaled latent (B, z, h, w) → image (B, 3, 8h, 8w) in [-1, 1];
        tiling: the decoder's 3×3 convs wrap their padding (the encoder's
        never do, as in JAX).  Activations run channels-last in memory."""
        z = z.contiguous(memory_format=torch.channels_last)
        z = z / self.cfg.scale_factor + self.cfg.shift_factor
        return self.decoder(self.post_quant_conv(z), tiling)

    def encode_moments(self, x):
        """image (B, 3, H, W) in [-1, 1] → moments (B, 2·z, H/8, W/8)
        (mean, logvar); activations run channels-last in memory."""
        x = x.contiguous(memory_format=torch.channels_last)
        return self.quant_conv(self.encoder(x))

    def encode_mode(self, moments):
        """The deterministic encode the img2img path uses: the scaled mean."""
        mean = moments.chunk(2, dim=1)[0]
        return (mean - self.cfg.shift_factor) * self.cfg.scale_factor

    def sample_latent(self, moments, noise):
        """moments + N(0, 1) noise → a scaled latent sample."""
        mean, logvar = moments.chunk(2, dim=1)
        z = mean + torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0)) * noise
        return (z - self.cfg.shift_factor) * self.cfg.scale_factor


class VQModel(AutoencoderKL):
    """LDSR's f4 VQGAN: the ldm encoder and decoder with z-wide quant
    convs and an (n_embed, embed_dim) codebook; scale 1, shift 0."""

    def __init__(self, cfg: VAEConfig, n_embed: int, *, device, dtype):
        super().__init__(cfg, device=device, dtype=dtype, double_z=False)
        self.quantize = nn.Module()
        self.quantize.embedding = Embedding(n_embed, cfg.embed_dim, device=device, dtype=dtype)

    def vq_decode(self, h, quantize: bool = True):
        """pre-quant latent (B, e, h, w) → image (B, 3, 4h, 4w) in [-1, 1]."""
        if quantize:
            h = vq_quantize(h, self.quantize.embedding.weight)
        return self.decode(h)


def vq_distances(h, codebook):
    """(B·H·W, n_embed) squared distances of each latent of NCHW `h` to
    each codebook row, fp32: ‖h‖² − 2h·cb + ‖cb‖² (ldsr.py:55-57)."""
    flat = h.permute(0, 2, 3, 1).reshape(-1, h.shape[1]).float()
    cb = codebook.float()
    return (flat ** 2).sum(-1, keepdim=True) - 2.0 * flat @ cb.t() + (cb ** 2).sum(-1)[None]


def vq_quantize(h, codebook, return_indices: bool = False):
    """Each latent of NCHW `h` replaced by its nearest codebook row (argmin
    of vq_distances), in h's dtype (reference VectorQuantizer2)."""
    b, c, hh, ww = h.shape
    idx = torch.argmin(vq_distances(h, codebook), dim=-1)
    q = codebook.float()[idx].reshape(b, hh, ww, c).permute(0, 3, 1, 2).to(h.dtype)
    return (q, idx) if return_indices else q
