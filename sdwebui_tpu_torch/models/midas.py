"""MiDaS DPT-hybrid depth estimator, NCHW: SD2-depth's conditioner and the
``depth_midas`` annotator.

Port of ``sdwebui_tpu/models/midas.py`` (the DPT paper's hybrid, Ranftl et
al., ICCV 2021).  Parameter names are the torch ``DPTDepthModel`` state
dict's (``pretrained.model.*``, ``pretrained.act_postprocess{3,4}.*``,
``scratch.*``), so a checkpoint loads by its keys:

  backbone  ResNetV2 stem (StdConv 7x7/2, GroupNorm(32) + ReLU, max pool
            3/2) and three stages of pre-activation bottlenecks; the
            stage outputs 0 and 1 are the /4 and /8 hooks
  ViT       1x1 patch projection of the /16 map, a cls token, 12 blocks
            (LayerNorm eps 1e-6 through B5, attention through
            ``ops.attention``: at 577 tokens the plain path, as JAX's
            Skv >= 1024 rule has it); blocks 8 and 11 are read out
            (cls concatenated onto every token, Linear + GELU) and
            reassembled to /16 and /32 maps
  scratch   3x3 convs of the four hooks to `features`, four RefineNet
            fusion blocks (residual conv units, 2x align-corners bilinear
            upsampling), the head (conv, 2x upsampling, conv + ReLU,
            1x1 conv + ReLU) → non-negative inverse depth at the input size

StdConv2d's weight standardisation runs once, in fp32, when the tower is
built (:meth:`DPTDepthModel.standardize_`), not on every call.  The tower
runs in fp32 whatever the policy's dtype, as JAX casts it
(``sdwebui_tpu/loader/load.py:266-271``); TF32 stays off
(``utils/devices``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from sdwebui_tpu_torch.models.layers import Conv2d, GroupNorm, LayerNorm, Linear, reset_random
from sdwebui_tpu_torch.ops.attention import attention


@dataclasses.dataclass(frozen=True)
class DPTConfig:
    """The published dpt_hybrid widths.  Beyond JAX's config: the stage
    widths, the head's middle width and whether the stem and the backbone
    end carry a norm, which JAX reads off its tree."""
    image_size: int = 384
    stem_width: int = 64
    stage_blocks: tuple = (3, 4, 9)
    stage_widths: tuple = (256, 512, 1024)
    vit_width: int = 768
    vit_layers: int = 12
    vit_heads: int = 12
    hooks: tuple = (8, 11)          # transformer blocks feeding layers 3/4
    features: int = 256
    head_width: int = 32
    stem_norm: bool = True
    backbone_norm: bool = True


def _gn(c: int, **kw) -> GroupNorm:
    return GroupNorm(c, num_groups=min(32, c), eps=1e-5, **kw)


def _gn_relu(norm: GroupNorm, x):
    return F.relu(norm(x))


class StdConv2d(Conv2d):
    """A bias-free conv whose weight is standardised per output channel
    (BiT's StdConv2d, eps 1e-8) once by :meth:`standardize_`."""

    def __init__(self, cin, cout, kernel: int, stride: int = 1, **kw):
        super().__init__(cin, cout, kernel, stride, bias=False, **kw)

    @torch.no_grad()
    def standardize_(self):
        """New storage for the standardised weight: a loaded weight may
        share its storage with the caller's state dict."""
        w = self.weight.float()
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        var = w.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
        std = ((w - mean) / torch.sqrt(var + 1e-8)).to(self.weight.dtype)
        self.weight.data = std.contiguous(memory_format=torch.channels_last)


class _Module(nn.Module):
    """A named holder of submodules (the state dict's path segments)."""

    def __init__(self, **children):
        super().__init__()
        for name, child in children.items():
            setattr(self, name, child)


class Bottleneck(nn.Module):
    """timm's pre-activation bottleneck: GN-ReLU before each StdConv 1/3/1
    (the stride on the 3x3), the shortcut fed by the first GN-ReLU."""

    def __init__(self, cin: int, cout: int, stride: int, downsample: bool, **kw):
        super().__init__()
        mid = cout // 4
        self.norm1 = _gn(cin, **kw)
        self.conv1 = StdConv2d(cin, mid, 1, **kw)
        self.norm2 = _gn(mid, **kw)
        self.conv2 = StdConv2d(mid, mid, 3, stride, **kw)
        self.norm3 = _gn(mid, **kw)
        self.conv3 = StdConv2d(mid, cout, 1, **kw)
        self.downsample = _Module(conv=StdConv2d(cin, cout, 1, stride, **kw)) \
            if downsample else None

    def forward(self, x):
        pre = _gn_relu(self.norm1, x)
        shortcut = self.downsample.conv(pre) if self.downsample is not None else x
        out = self.conv1(pre)
        out = self.conv2(_gn_relu(self.norm2, out))
        out = self.conv3(_gn_relu(self.norm3, out))
        return out + shortcut


class VitBlock(nn.Module):
    def __init__(self, width: int, heads: int, **kw):
        super().__init__()
        self.heads = heads
        self.norm1 = LayerNorm(width, eps=1e-6, **kw)
        self.attn = _Module(qkv=Linear(width, 3 * width, **kw), proj=Linear(width, width, **kw))
        self.norm2 = LayerNorm(width, eps=1e-6, **kw)
        self.mlp = _Module(fc1=Linear(width, 4 * width, **kw), fc2=Linear(4 * width, width, **kw))

    def forward(self, x):
        q, k, v = self.attn.qkv(self.norm1(x)).chunk(3, dim=-1)
        x = x + self.attn.proj(attention(q, k, v, num_heads=self.heads))
        return x + self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm2(x))))


class ResidualConvUnit(nn.Module):
    def __init__(self, f: int, **kw):
        super().__init__()
        self.conv1 = Conv2d(f, f, 3, **kw)
        self.conv2 = Conv2d(f, f, 3, **kw)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


def upsample2x_ac(x):
    """2x bilinear with align_corners=True (the DPT fusion blocks')."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


class FusionBlock(nn.Module):
    def __init__(self, f: int, **kw):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(f, **kw)
        self.resConfUnit2 = ResidualConvUnit(f, **kw)
        self.out_conv = Conv2d(f, f, 1, **kw)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        return self.out_conv(upsample2x_ac(self.resConfUnit2(x)))


def conv_im2col(conv: Conv2d, x):
    """A stride-1 conv as im2col + one GEMM (the route PyTorch itself takes
    without cuDNN).  The head's 3x3 256 → 128 conv at 192² takes this
    route: cuDNN's f32 path (TF32 off) runs it as 33024 gemv launches,
    ~180 ms whatever the layout or cudnn.benchmark, against 0.83 ms here
    (tools/midas_probe_cuda.py on an H100)."""
    b, _, h, w = x.shape
    cols = F.unfold(x, conv.weight.shape[-1], padding=conv.padding)
    out = conv.weight.reshape(conv.weight.shape[0], -1).to(x.dtype) @ cols
    return (out + conv.bias.to(x.dtype)[:, None]).reshape(b, -1, h, w)


def _readout(cfg: DPTConfig, stride2: bool, **kw) -> nn.ModuleDict:
    """act_postprocessN: [0] ProjectReadout's Linear (+ GELU), [3] a 1x1
    conv, and for the /32 map [4] a 3x3 stride-2 conv."""
    w = cfg.vit_width
    mods = {"0": _Module(project=nn.ModuleDict({"0": Linear(2 * w, w, **kw)})),
            "3": Conv2d(w, w, 1, **kw)}
    if stride2:
        mods["4"] = Conv2d(w, w, 3, 2, **kw)
    return nn.ModuleDict(mods)


class DPTDepthModel(nn.Module):
    def __init__(self, cfg: DPTConfig = DPTConfig(), *, device="cpu", dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        grid = cfg.image_size // 16
        stem = _Module(conv=StdConv2d(3, cfg.stem_width, 7, 2, **kw))
        if cfg.stem_norm:
            stem.norm = _gn(cfg.stem_width, **kw)
        stages, cin = nn.ModuleList(), cfg.stem_width
        for si, (n, cout) in enumerate(zip(cfg.stage_blocks, cfg.stage_widths)):
            # each stage's first block downsamples (stage 0 keeps /4) and
            # carries the projection shortcut
            blocks = nn.ModuleList(
                Bottleneck(cin if bi == 0 else cout, cout, 2 if si > 0 and bi == 0 else 1,
                           bi == 0, **kw) for bi in range(n))
            stages.append(_Module(blocks=blocks))
            cin = cout
        backbone = _Module(stem=stem, stages=stages)
        if cfg.backbone_norm:
            backbone.norm = _gn(cin, **kw)
        model = _Module(
            patch_embed=_Module(backbone=backbone, proj=Conv2d(cin, cfg.vit_width, 1, **kw)),
            blocks=nn.ModuleList(VitBlock(cfg.vit_width, cfg.vit_heads, **kw)
                                 for _ in range(cfg.vit_layers)))
        model.cls_token = nn.Parameter(torch.empty((1, 1, cfg.vit_width), **kw),
                                       requires_grad=False)
        model.pos_embed = nn.Parameter(torch.empty((1, grid * grid + 1, cfg.vit_width), **kw),
                                       requires_grad=False)
        self.pretrained = _Module(model=model, act_postprocess3=_readout(cfg, False, **kw),
                                  act_postprocess4=_readout(cfg, True, **kw))
        f = cfg.features
        w1, w2 = cfg.stage_widths[0], cfg.stage_widths[1]
        self.scratch = _Module(
            layer1_rn=Conv2d(w1, f, 3, bias=False, **kw),
            layer2_rn=Conv2d(w2, f, 3, bias=False, **kw),
            layer3_rn=Conv2d(cfg.vit_width, f, 3, bias=False, **kw),
            layer4_rn=Conv2d(cfg.vit_width, f, 3, bias=False, **kw),
            **{f"refinenet{i}": FusionBlock(f, **kw) for i in range(1, 5)},
            output_conv=nn.ModuleDict({"0": Conv2d(f, f // 2, 3, **kw),
                                       "2": Conv2d(f // 2, cfg.head_width, 3, **kw),
                                       "4": Conv2d(cfg.head_width, 1, 1, **kw)}))

    @torch.no_grad()
    def standardize_(self) -> "DPTDepthModel":
        """Standardise every StdConv2d weight in place (once, after the
        weights are loaded)."""
        for m in self.modules():
            if isinstance(m, StdConv2d):
                m.standardize_()
        return self

    @torch.no_grad()
    def reset_random(self, gen: torch.Generator) -> "DPTDepthModel":
        """Random weights (the layers' HostInit distributions; cls token
        and position embedding N(0, 0.02²)), standardised."""
        reset_random(self, gen)
        pm = self.pretrained.model
        for p in (pm.cls_token, pm.pos_embed):
            p.copy_(torch.randn(p.shape, generator=gen, device=p.device) * 0.02)
        return self.standardize_()

    def _pos_embed(self, gh: int, gw: int):
        pos = self.pretrained.model.pos_embed
        side = int(round((pos.shape[1] - 1) ** 0.5))
        if (gh, gw) == (side, side):
            return pos
        # DPT _resize_pos_embed: bilinear over the grid part, antialiased
        # when it shrinks, as jax.image.resize computes it
        grid = pos[:, 1:].reshape(1, side, side, -1).permute(0, 3, 1, 2)
        grid = F.interpolate(grid, size=(gh, gw), mode="bilinear", align_corners=False,
                             antialias=True)
        return torch.cat([pos[:, :1], grid.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)], dim=1)

    def _reassemble(self, pp: nn.ModuleDict, tokens, gh: int, gw: int):
        patches = tokens[:, 1:]
        cat = torch.cat([patches, tokens[:, :1].expand_as(patches)], dim=-1)
        h = F.gelu(pp["0"].project["0"](cat))
        h = h.transpose(1, 2).reshape(h.shape[0], -1, gh, gw)
        h = pp["3"](h)
        return pp["4"](h) if "4" in pp else h

    def forward(self, images):
        """images (B, 3, H, W) in [-1, 1] → inverse depth (B, 1, H, W),
        non-negative, unnormalised."""
        cfg = self.cfg
        pm = self.pretrained.model
        backbone = pm.patch_embed.backbone
        x = images.to(pm.cls_token.dtype)
        x = backbone.stem.conv(x)
        if cfg.stem_norm:
            x = _gn_relu(backbone.stem.norm, x)
        x = F.max_pool2d(x, 3, 2, 1)
        feats = []
        for stage in backbone.stages:
            for block in stage.blocks:
                x = block(x)
            feats.append(x)
        layer1, layer2, deep = feats[0], feats[1], feats[-1]
        if cfg.backbone_norm:
            deep = _gn_relu(backbone.norm, deep)

        b, _, gh, gw = deep.shape
        tok = pm.patch_embed.proj(deep).flatten(2).transpose(1, 2)
        tok = torch.cat([pm.cls_token.expand(b, -1, -1), tok], dim=1) + self._pos_embed(gh, gw)
        hooks = {}
        for i, block in enumerate(pm.blocks):
            tok = block(tok)
            if i in cfg.hooks:
                hooks[i] = tok
        layer3 = self._reassemble(self.pretrained.act_postprocess3, hooks[cfg.hooks[0]], gh, gw)
        layer4 = self._reassemble(self.pretrained.act_postprocess4, hooks[cfg.hooks[1]], gh, gw)

        sc = self.scratch
        path = sc.refinenet4(sc.layer4_rn(layer4))
        path = sc.refinenet3(path, sc.layer3_rn(layer3))
        path = sc.refinenet2(path, sc.layer2_rn(layer2))
        path = sc.refinenet1(path, sc.layer1_rn(layer1))
        out = upsample2x_ac(conv_im2col(sc.output_conv["0"], path))
        out = F.relu(sc.output_conv["2"](out))
        return F.relu(sc.output_conv["4"](out))


def _resize_bicubic(x, h: int, w: int):
    """``jax.image.resize(..., "bicubic")``: Keys' cubic (a = -0.5),
    antialiased when shrinking: torch's antialiased bicubic."""
    return F.interpolate(x, size=(h, w), mode="bicubic", align_corners=False, antialias=True)


def depth_conditioning(tower: DPTDepthModel, images_01, latent_h: int, latent_w: int):
    """images (B, 3, H, W) in [0, 1] → (B, 1, latent_h, latent_w) in [-1, 1]
    (midas.py:265-278): bicubic to the tower's input size, the tower,
    bicubic to the latent grid, min-max normalised per image."""
    s = tower.cfg.image_size
    x = _resize_bicubic(images_01.float(), s, s)
    depth = _resize_bicubic(tower(x * 2.0 - 1.0), latent_h, latent_w)
    dmin = depth.amin(dim=(1, 2, 3), keepdim=True)
    dmax = depth.amax(dim=(1, 2, 3), keepdim=True)
    return 2.0 * (depth - dmin) / torch.clamp(dmax - dmin, min=1e-8) - 1.0


def create_random_dpt(seed: int = 0, device="cuda", cfg: DPTConfig = DPTConfig()):
    """A random-weight tower at `cfg` (default: the published widths), fp32."""
    from sdwebui_tpu_torch.utils.devices import get_device

    device = get_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return DPTDepthModel(cfg, device=device).reset_random(gen)
