"""ESRGAN / Real-ESRGAN super-resolution nets — port of ``sdwebui_tpu/models/esrgan.py``.

Two architectures, told apart by their state dict:

* RRDBNet (ESRGAN, R-ESRGAN 4x+): conv_first, residual-in-residual dense
  blocks (three dense blocks of five convs each, residual scale 0.2),
  conv_body, nearest 2x upsamples each followed by conv_up1 / conv_up2,
  conv_hr, conv_last.  Real-ESRGAN's x2 and x1 variants feed the body
  pixel-unshuffled input (12 or 48 channels).  The old ``model.N`` key
  layout and the ``model.model.`` / ``params.`` prefixes are translated.
* SRVGGNetCompact (realesr-general-x4v3): a stack of convs each followed by
  a per-channel PReLU, a pixel shuffle, and the nearest-upsampled input
  added back.

Images are NCHW float in [0, 1]; outputs are clipped to [0, 1].  Weights
stay in the file's dtype and are cast to the input's at use, as JAX's
``layers.conv2d`` casts them; the 3x3 convs are ``F.conv2d`` (JAX runs them
as ``lax.conv``, outside any Pallas kernel).  ``upscale_image`` runs every
tile of an image in one batched call on the net's device
(``esrgan.py:185-222``).  TF32 stays off (``utils/devices``).
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sdwebui_tpu_torch.loader.safetensors_io import read_state_dict as read_safetensors
from sdwebui_tpu_torch.loader.torch_ckpt import load_torch_checkpoint
from sdwebui_tpu_torch.postprocessing.upscalers import register_upscaler, tiled_sr_upscale
from sdwebui_tpu_torch.utils.devices import get_device   # importing devices turns TF32 off


class Conv3x3(nn.Module):
    """A 3x3 stride-1 pad-1 conv holding OIHW weights in their own dtype."""

    def __init__(self, cin: int, cout: int, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((cout, cin, 3, 3), dtype=dtype),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.empty((cout,), dtype=dtype), requires_grad=False)

    def forward(self, x):
        return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype), 1, 1)


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


class ResidualDenseBlock(nn.Module):
    """Five convs over the running concat, residual scale 0.2."""

    def __init__(self, nf: int, gc: int, dtype):
        super().__init__()
        for i in range(5):
            setattr(self, f"conv{i + 1}", Conv3x3(nf + i * gc, gc if i < 4 else nf, dtype))

    def forward(self, x):
        x1 = _lrelu(self.conv1(x))
        x2 = _lrelu(self.conv2(torch.cat([x, x1], 1)))
        x3 = _lrelu(self.conv3(torch.cat([x, x1, x2], 1)))
        x4 = _lrelu(self.conv4(torch.cat([x, x1, x2, x3], 1)))
        x5 = self.conv5(torch.cat([x, x1, x2, x3, x4], 1))
        return x + 0.2 * x5


class RRDB(nn.Module):
    def __init__(self, nf: int, gc: int, dtype):
        super().__init__()
        self.rdb1 = ResidualDenseBlock(nf, gc, dtype)
        self.rdb2 = ResidualDenseBlock(nf, gc, dtype)
        self.rdb3 = ResidualDenseBlock(nf, gc, dtype)

    def forward(self, x):
        return x + 0.2 * self.rdb3(self.rdb2(self.rdb1(x)))


class RRDBNet(nn.Module):
    """in_ch 3 (x4 with both upsamples), 12 (x2) or 48 (x1)."""

    def __init__(self, in_ch: int = 3, nf: int = 64, gc: int = 32, n_blocks: int = 23,
                 n_up: int = 2, dtype=torch.float32):
        super().__init__()
        self.conv_first = Conv3x3(in_ch, nf, dtype)
        self.body = nn.ModuleList(RRDB(nf, gc, dtype) for _ in range(n_blocks))
        self.conv_body = Conv3x3(nf, nf, dtype)
        self.n_up = n_up
        if n_up >= 1:
            self.conv_up1 = Conv3x3(nf, nf, dtype)
        if n_up >= 2:
            self.conv_up2 = Conv3x3(nf, nf, dtype)
        self.conv_hr = Conv3x3(nf, nf, dtype)
        self.conv_last = Conv3x3(nf, 3, dtype)
        self.unshuffle = {12: 2, 48: 4}.get(in_ch, 1)
        self.scale = max((2 ** n_up) // self.unshuffle, 1)

    def forward(self, x):
        h0, w0 = x.shape[2:]
        r = self.unshuffle
        if r > 1:
            ph, pw = (-h0) % r, (-w0) % r
            if ph or pw:
                x = F.pad(x, (0, pw, 0, ph), mode="reflect")
            x = F.pixel_unshuffle(x, r)
        fea = self.conv_first(x)
        body = fea
        for block in self.body:
            body = block(body)
        fea = fea + self.conv_body(body)
        for i in range(1, self.n_up + 1):
            up = getattr(self, f"conv_up{i}")
            fea = _lrelu(up(F.interpolate(fea, scale_factor=2.0, mode="nearest")))
        out = self.conv_last(_lrelu(self.conv_hr(fea)))
        if r > 1:       # the reflect pad off again, at the net's output scale
            out = out[:, :, : h0 * self.scale, : w0 * self.scale]
        return torch.clamp(out, 0.0, 1.0)


class PReLU(nn.Module):
    def __init__(self, channels: int, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((channels,), dtype=dtype), requires_grad=False)

    def forward(self, x):
        return torch.where(x > 0, x, x * self.weight.to(x.dtype).view(1, -1, 1, 1))


class SRVGGNetCompact(nn.Module):
    """body: conv(3, nf), PReLU, num_conv x (conv(nf, nf), PReLU),
    conv(nf, 3·scale²), then a pixel shuffle plus the input upsampled."""

    def __init__(self, nf: int = 64, num_conv: int = 32, scale: int = 4, dtype=torch.float32):
        super().__init__()
        layers = [Conv3x3(3, nf, dtype), PReLU(nf, dtype)]
        for _ in range(num_conv):
            layers += [Conv3x3(nf, nf, dtype), PReLU(nf, dtype)]
        layers.append(Conv3x3(nf, 3 * scale * scale, dtype))
        self.body = nn.ModuleList(layers)
        self.scale = scale

    def forward(self, x):
        h = x
        for layer in self.body:
            h = layer(h)
        out = F.pixel_shuffle(h, self.scale)
        base = F.interpolate(x, scale_factor=float(self.scale), mode="nearest")
        return torch.clamp(out + base, 0.0, 1.0)


# --------------------------------------------------------------------------
# loading
# --------------------------------------------------------------------------

_OLD_KEY_RE = re.compile(r"^model\.1\.sub\.(\d+)\.RDB(\d)\.conv(\d)\.0\.(weight|bias)$")

_OLD_FIXED = {
    "model.0": "conv_first",
    "model.1.sub.23": "conv_body",
    "model.3": "conv_up1",
    "model.6": "conv_up2",
    "model.8": "conv_hr",
    "model.10": "conv_last",
}


def normalize_keys(sd: dict) -> dict:
    """Old ESRGAN serialization (model.0, model.1.sub.N.RDBk.convj.0, ...)
    → modern RRDBNet names (esrgan.py:102)."""
    if not any(k.startswith("model.") for k in sd):
        return sd
    out = {}
    for k, v in sd.items():
        m = _OLD_KEY_RE.match(k)
        if m:
            out[f"body.{m.group(1)}.rdb{m.group(2)}.conv{m.group(3)}.{m.group(4)}"] = v
            continue
        for old, new in _OLD_FIXED.items():
            if k.startswith(old + "."):
                out[new + k[len(old):]] = v
                break
    return out


def read_state_dict(path: str) -> dict:
    """A .safetensors, .pth or .pt file → {key: tensor}, without the
    ``params.`` wrapper of Real-ESRGAN's files."""
    read = read_safetensors if path.endswith(".safetensors") else load_torch_checkpoint
    return {k[len("params."):] if k.startswith("params.") else k: v
            for k, v in read(path).items()}


def is_srvgg(keys) -> bool:
    keys = set(keys)
    return any(k.startswith("body.") for k in keys) and \
        not any(".rdb" in k or ".RDB" in k for k in keys) and \
        "conv_first.weight" not in keys and "model.0.weight" not in keys


def _assign(module: nn.Module, sd: dict, device) -> nn.Module:
    """The state dict's tensors, in their own dtypes, copied to `device`
    (never a view into a file's map; "cuda" without a card raises)."""
    device = get_device(device)
    own = module.state_dict()
    if set(sd) != set(own):
        missing, extra = sorted(set(own) - set(sd)), sorted(set(sd) - set(own))
        raise ValueError(f"state dict does not fit {type(module).__name__}: "
                         f"missing {missing[:5]}, unexpected {extra[:5]}")
    for k, v in sd.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{k}: shape {tuple(v.shape)}, expected {tuple(own[k].shape)}")
    module.load_state_dict({k: v.to(device, copy=True) for k, v in sd.items()}, assign=True)
    return module.eval()


def rrdbnet_from_state_dict(sd: dict, device="cuda") -> RRDBNet:
    sd = {k.replace("model.", "", 1) if k.startswith("model.model.") else k: v
          for k, v in sd.items()}
    sd = normalize_keys(sd)
    w = sd["conv_first.weight"]
    n_blocks = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("body."))
    net = RRDBNet(in_ch=w.shape[1], nf=w.shape[0], gc=sd["body.0.rdb1.conv1.weight"].shape[0],
                  n_blocks=n_blocks, n_up=int("conv_up1.weight" in sd) + int(
                      "conv_up2.weight" in sd), dtype=w.dtype)
    return _assign(net, sd, device)


def srvgg_from_state_dict(sd: dict, device="cuda") -> SRVGGNetCompact:
    n = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("body."))
    first, last = sd["body.0.weight"], sd[f"body.{n - 1}.weight"]
    scale = max(int(round((last.shape[0] / 3) ** 0.5)), 1)
    net = SRVGGNetCompact(nf=first.shape[0], num_conv=(n - 3) // 2, scale=scale,
                          dtype=first.dtype)
    return _assign(net, sd, device)


def load_upscaler_net(path: str, device="cuda") -> nn.Module:
    """A file → its net on `device`, the architecture sniffed from its keys."""
    sd = read_state_dict(path)
    if is_srvgg(sd):
        return srvgg_from_state_dict(sd, device)
    return rrdbnet_from_state_dict(sd, device)


# --------------------------------------------------------------------------
# tiled inference and the registry
# --------------------------------------------------------------------------

def upscale_image(net: nn.Module, image: np.ndarray, tile: int | None = None,
                  overlap: int | None = None) -> np.ndarray:
    """RGB uint8 (H, W, 3) → (scale·H, scale·W, 3): every tile in one
    batched f32 call on the net's device, feathered re-assembly."""
    device = next(net.parameters()).device

    @torch.inference_mode()
    def run_batch(arr: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.ascontiguousarray(arr)).to(device).permute(0, 3, 1, 2)
        return net(x.float()).permute(0, 2, 3, 1).cpu().numpy()

    return tiled_sr_upscale(run_batch, net.scale, 1, image, tile=tile, overlap=overlap)


def register_esrgan_dir(dirs, device="cuda") -> list:
    """Register every .pth / .pt / .safetensors file of `dirs` as an
    upscaler named by its file name, run on `device`; the file is read, and
    its architecture sniffed, at its first use (esrgan.py:225).  The
    registry is the process's: the server registers its directories once
    at start (``server/__main__``)."""
    device = get_device(device)
    found = []
    for d in dirs:
        if not d or not os.path.isdir(d):
            continue
        for fn in sorted(os.listdir(d)):
            if not fn.lower().endswith((".pth", ".pt", ".safetensors")):
                continue
            path = os.path.join(d, fn)

            def make_fn(p=path):
                cache = {}

                def scale_fn(image, scale):
                    if "net" not in cache:
                        cache["net"] = load_upscaler_net(p, device)
                    return upscale_image(cache["net"], image)
                return scale_fn

            name = os.path.splitext(fn)[0]
            register_upscaler(name, make_fn(), default_scale=4)
            found.append(name)
    return found
