"""GFPGAN v1 "clean" face restorer, NCHW.

Port of ``sdwebui_tpu/models/gfpgan.py`` (GFPGANv1Clean, as the reference
runs GFPGANv1.3 / v1.4): a U-Net that removes degradation — a 1x1 conv,
ResBlocks down to 4x4 (bilinear 0.5x, a 1x1 skip, /√2), ``final_conv``,
and ResUpBlocks back up, each level's feature giving an SFT scale and
shift — whose 4x4 feature, through ``final_linear``, is the latent code of
a StyleGAN2-clean decoder: modulated convs with bilinear 2x upsampling,
the SFT conditions applied to half the channels after each level's
upsampling conv, and RGB skips summed up the levels.  Parameter names are
the checkpoint's ``params_ema`` keys (the ``params_ema.`` prefix and the
unused ``style_mlp`` dropped); ``toRGB`` is loaded and never run, as in JAX.

``ModulatedConv`` (``gfpgan.py:104-137``) makes per-sample kernels and runs
the batch as one grouped conv (``F.conv2d(groups=B)``).  The bilinear
resampling is ``F.interpolate(align_corners=False)`` with no antialias,
JAX's ``jax.image.resize(linear, antialias=False)`` at a factor of 2.  The
noise is the checkpoint's registered buffers (deterministic).  f32
throughout; TF32 stays off (``utils/devices``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sdwebui_tpu_torch.models.layers import Conv2d, Linear, assign_f32, reset_random
from sdwebui_tpu_torch.utils.devices import get_device


@dataclasses.dataclass(frozen=True)
class GFPGANConfig:
    out_size: int = 512
    num_style_feat: int = 512
    channel_multiplier: int = 2
    narrow: float = 1.0
    sft_half: bool = True
    different_w: bool = True

    @property
    def log_size(self) -> int:
        return int(math.log2(self.out_size))

    @property
    def num_latent(self) -> int:
        return self.log_size * 2 - 2

    def channels(self, unet: bool = False) -> dict:
        base = {4: 512, 8: 512, 16: 512, 32: 512,
                64: 256 * self.channel_multiplier,
                128: 128 * self.channel_multiplier,
                256: 64 * self.channel_multiplier,
                512: 32 * self.channel_multiplier,
                1024: 16 * self.channel_multiplier}
        mult = self.narrow * (0.5 if unet else 1.0)
        return {k: int(v * mult) for k, v in base.items()}


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


def _interp2x(x, up: bool = True):
    """2x or 0.5x bilinear, align_corners False, no antialias."""
    h, w = x.shape[2:]
    size = (h * 2, w * 2) if up else (h // 2, w // 2)
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False)


class ResBlock(nn.Module):
    """basicsr's GFPGAN ResBlock: lrelu convs with the resampling between
    them, a bias-free 1x1 skip of the resampled input, the sum over √2."""

    def __init__(self, cin: int, cout: int, up: bool, **kw):
        super().__init__()
        self.conv1 = Conv2d(cin, cin, 3, **kw)
        self.conv2 = Conv2d(cin, cout, 3, **kw)
        self.skip = Conv2d(cin, cout, 1, bias=False, **kw)
        self.up = up

    def forward(self, x):
        out = _lrelu(self.conv2(_interp2x(_lrelu(self.conv1(x)), self.up)))
        return (out + self.skip(_interp2x(x, self.up))) / math.sqrt(2)


class ModulatedConv(nn.Module):
    """StyleGAN2 ModulatedConv2d: weight (1, Cout, Cin, k, k), the style
    through ``modulation`` to a per-input-channel scale, 1/√(Cin·k²), and
    demodulation; the batch's kernels in one grouped conv."""

    def __init__(self, cin: int, cout: int, k: int, style: int, demodulate: bool = True,
                 upsample: bool = False, *, device, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((1, cout, cin, k, k), device=device,
                                               dtype=dtype), requires_grad=False)
        self.modulation = Linear(style, cin, device=device, dtype=dtype)
        self.demodulate, self.upsample = demodulate, upsample

    def forward(self, x, style, eps: float = 1e-8):
        _, cout, cin, k, _ = self.weight.shape
        b = x.shape[0]
        s = self.modulation(style.float())                              # (B, Cin)
        wk = (1.0 / math.sqrt(cin * k * k)) * self.weight * s[:, None, :, None, None]
        if self.demodulate:
            wk = wk * torch.rsqrt((wk * wk).sum(dim=(2, 3, 4)) + eps)[:, :, None, None, None]
        if self.upsample:
            x = _interp2x(x, True)
        h, w = x.shape[2:]
        out = F.conv2d(x.reshape(1, b * cin, h, w), wk.reshape(b * cout, cin, k, k),
                       padding=k // 2, groups=b)
        return out.reshape(b, cout, h, w)


class StyleConv(nn.Module):
    def __init__(self, cin: int, cout: int, style: int, upsample: bool = False, **kw):
        super().__init__()
        self.modulated_conv = ModulatedConv(cin, cout, 3, style, upsample=upsample, **kw)
        self.weight = nn.Parameter(torch.empty((1,), **kw), requires_grad=False)   # noise
        self.bias = nn.Parameter(torch.empty((1, cout, 1, 1), **kw), requires_grad=False)

    def forward(self, x, style, noise=None):
        out = self.modulated_conv(x, style) * (2 ** 0.5)
        if noise is not None:
            out = out + self.weight * noise
        return _lrelu(out + self.bias)


class ToRGB(nn.Module):
    def __init__(self, cin: int, style: int, **kw):
        super().__init__()
        self.modulated_conv = ModulatedConv(cin, 3, 1, style, demodulate=False, **kw)
        self.bias = nn.Parameter(torch.empty((1, 3, 1, 1), **kw), requires_grad=False)

    def forward(self, x, style, skip=None):
        out = self.modulated_conv(x, style) + self.bias
        return out if skip is None else out + _interp2x(skip, True)


class _Holder(nn.Module):
    """A named module holding one tensor (``constant_input.weight``)."""

    def __init__(self, shape, **kw):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(shape, **kw), requires_grad=False)


class StyleGANDecoder(nn.Module):
    """StyleGAN2GeneratorCSFT without its style MLP (the latent is given)."""

    def __init__(self, cfg: GFPGANConfig, **kw):
        super().__init__()
        gch = cfg.channels(unet=False)
        s = cfg.num_style_feat
        self.constant_input = _Holder((1, gch[4], 4, 4), **kw)
        self.style_conv1 = StyleConv(gch[4], gch[4], s, **kw)
        self.to_rgb1 = ToRGB(gch[4], s, **kw)
        self.style_convs, self.to_rgbs = nn.ModuleList(), nn.ModuleList()
        self.noises = nn.Module()
        self.noises.register_buffer("noise0", torch.empty((1, 1, 4, 4), **kw))
        cin = gch[4]
        for li, res in enumerate(range(3, cfg.log_size + 1)):
            cout = gch[2 ** res]
            self.style_convs.append(StyleConv(cin, cout, s, upsample=True, **kw))
            self.style_convs.append(StyleConv(cout, cout, s, **kw))
            self.to_rgbs.append(ToRGB(cout, s, **kw))
            for n in (2 * li + 1, 2 * li + 2):
                self.noises.register_buffer(f"noise{n}", torch.empty((1, 1, 2 ** res, 2 ** res),
                                                                    **kw))
            cin = cout
        self.sft_half = cfg.sft_half

    def forward(self, latent, conditions):
        b = latent.shape[0]
        noise = [getattr(self.noises, f"noise{i}") for i in range(len(self.style_convs) + 1)]
        out = self.constant_input.weight.expand(b, -1, -1, -1)
        out = self.style_conv1(out, latent[:, 0], noise[0])
        skip = self.to_rgb1(out, latent[:, 1])
        i = 1
        for li, to_rgb in enumerate(self.to_rgbs):
            out = self.style_convs[2 * li](out, latent[:, i], noise[2 * li + 1])
            if i < len(conditions):       # CSFT after the upsampling conv
                scale, shift = conditions[i - 1], conditions[i]
                if self.sft_half:
                    same, sft = out.split(out.shape[1] // 2, dim=1)
                    out = torch.cat([same, sft * scale + shift], dim=1)
                else:
                    out = out * scale + shift
            out = self.style_convs[2 * li + 1](out, latent[:, i + 1], noise[2 * li + 2])
            skip = to_rgb(out, latent[:, i + 2], skip)
            i += 2
        return skip


class GFPGAN(nn.Module):
    def __init__(self, cfg: GFPGANConfig = GFPGANConfig(), *, device="cpu",
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        uch = cfg.channels(unet=True)
        gch = cfg.channels(unet=False)
        self.conv_body_first = Conv2d(3, uch[cfg.out_size], 1, **kw)
        cin = uch[cfg.out_size]
        self.conv_body_down = nn.ModuleList()
        for res in range(cfg.log_size, 2, -1):
            self.conv_body_down.append(ResBlock(cin, uch[2 ** (res - 1)], False, **kw))
            cin = uch[2 ** (res - 1)]
        self.final_conv = Conv2d(cin, uch[4], 3, **kw)
        n_lat = cfg.num_latent if cfg.different_w else 1
        self.final_linear = Linear(uch[4] * 16, n_lat * cfg.num_style_feat, **kw)
        self.conv_body_up = nn.ModuleList()
        self.condition_scale, self.condition_shift = nn.ModuleList(), nn.ModuleList()
        self.toRGB = nn.ModuleList()
        cin = uch[4]
        for res in range(3, cfg.log_size + 1):
            cout = uch[2 ** res]
            self.conv_body_up.append(ResBlock(cin, cout, True, **kw))
            sft = gch[2 ** res] // 2 if cfg.sft_half else gch[2 ** res]
            for stack in (self.condition_scale, self.condition_shift):
                stack.append(nn.ModuleDict({"0": Conv2d(cout, cout, 3, **kw),
                                            "2": Conv2d(cout, sft, 3, **kw)}))
            self.toRGB.append(Conv2d(cout, 3, 1, **kw))
            cin = cout
        self.stylegan_decoder = StyleGANDecoder(cfg, **kw)

    def forward(self, x):
        """x (B, 3, S, S) in [-1, 1] → restored (B, 3, S, S), about [-1, 1]."""
        cfg = self.cfg
        feat = _lrelu(self.conv_body_first(x.float()))
        skips = []
        for block in self.conv_body_down:
            feat = block(feat)
            skips.insert(0, feat)
        feat = _lrelu(self.final_conv(feat))
        b = feat.shape[0]
        style = self.final_linear(feat.reshape(b, -1))
        if cfg.different_w:
            latent = style.reshape(b, cfg.num_latent, cfg.num_style_feat)
        else:
            latent = style[:, None].expand(b, cfg.num_latent, cfg.num_style_feat)
        conditions = []
        for i, block in enumerate(self.conv_body_up):
            feat = block(feat + skips[i])
            for stack in (self.condition_scale, self.condition_shift):
                conditions.append(stack[i]["2"](_lrelu(stack[i]["0"](feat))))
        return self.stylegan_decoder(latent, conditions)

    @torch.no_grad()
    def reset_random(self, gen: torch.Generator) -> "GFPGAN":
        """Seeded weights at the layers' distributions; modulated weights
        N(0, 1), modulation biases 1 (StyleGAN2's init), noise strengths
        0.1, noise buffers N(0, 1), biases 0."""
        reset_random(self, gen)
        for m in self.modules():
            if isinstance(m, ModulatedConv):
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen, device=gen.device))
                m.modulation.bias.fill_(1.0)
            elif isinstance(m, StyleConv):
                m.weight.fill_(0.1)
                m.bias.zero_()
            elif isinstance(m, ToRGB):
                m.bias.zero_()
        dec = self.stylegan_decoder
        dec.constant_input.weight.copy_(torch.randn(dec.constant_input.weight.shape,
                                                    generator=gen, device=gen.device))
        for _, buf in dec.noises.named_buffers():
            buf.copy_(torch.randn(buf.shape, generator=gen, device=gen.device))
        return self


# --------------------------------------------------------------------------
# loading
# --------------------------------------------------------------------------

def config_from_state_dict(sd: dict) -> GFPGANConfig:
    """``convert_gfpgan``'s reading (gfpgan.py:241-275): the output size from
    the up-block count, the channel multiplier from conv_body_first, the
    style width from the modulation."""
    n_up = len({k.split(".")[1] for k in sd if k.startswith("conv_body_up.")})
    first_ch = sd["conv_body_first.weight"].shape[0]
    style = sd["stylegan_decoder.style_conv1.modulated_conv.modulation.weight"].shape[1]
    return GFPGANConfig(out_size=4 * 2 ** n_up, num_style_feat=int(style),
                        channel_multiplier=2 if first_ch >= 32 else 1)


def gfpgan_from_state_dict(sd: dict, device="cuda") -> GFPGAN:
    """A GFPGANv1Clean state dict (``params_ema`` prefixed or not) → the net
    on `device`, in f32."""
    if any(k.startswith("params_ema.") for k in sd):
        sd = {k[len("params_ema."):]: v for k, v in sd.items() if k.startswith("params_ema.")}
    sd = {k: v for k, v in sd.items() if ".style_mlp." not in k}
    net = GFPGAN(config_from_state_dict(sd), device="meta")
    return assign_f32(net, sd, get_device(device))


def gfpgan_from_jax(tree: dict, device="cpu") -> GFPGAN:
    """The JAX package's tree (``convert_gfpgan``'s layout: plain convs HWIO,
    final_linear and modulation (in, out)) → the net."""
    from sdwebui_tpu_torch.utils.pytree import flatten

    sd = {}
    for k, v in flatten(tree).items():
        t = torch.from_numpy(np.array(v, np.float32))
        if k.endswith(".weight") and t.dim() == 4 and "constant_input" not in k:
            t = t.permute(3, 2, 0, 1)
        elif k.endswith(("final_linear.weight", "modulation.weight")):
            t = t.t()
        sd[k] = t
    return gfpgan_from_state_dict(sd, device)


def create_random_gfpgan(seed: int = 0, device="cuda",
                         cfg: GFPGANConfig = GFPGANConfig()) -> GFPGAN:
    """A seeded random GFPGANv1-clean at `cfg` (default: v1.4's published
    widths, 512, channel multiplier 2), f32."""
    device = get_device(device)
    net = GFPGAN(cfg, device=device)
    return net.reset_random(torch.Generator(device=device).manual_seed(seed)).eval()
