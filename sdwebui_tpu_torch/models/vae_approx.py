"""Fast latent → RGB approximations and TAESD, NCHW.

Port of ``sdwebui_tpu/models/vae_approx.py``.  Three tiers (the
reference's ``sd_vae_approx.py`` and ``sd_vae_taesd.py``):

  1. ``cheap_approximation``: a fixed 4×3 (SDXL: its own 4×3, SD3 16×3)
     matrix on the latent, no weights;
  2. ``VAEApprox`` ("Approx NN"): nearest 2× upsample, an 11-pixel zero
     pad, then eight unpadded convs (7, 5, 3, … 3; 4→8→16→32→64→32→16→8→3),
     each followed by leaky_relu(0.1), mapped to [0, 1] by x/2 + 0.5;
  3. TAESD (madebyollin's tiny autoencoder): a decoder of 64-wide residual
     conv blocks with three nearest 2× upsamples, latent clamped by
     tanh(x/3)·3, output clipped to [0, 1]; and an encoder of the same
     blocks with three stride-2 convs, from an image in [0, 1] straight to
     the sampler-space (scaled) latent.

Parameter names are the published files' sequential indices (``1.weight``,
``3.conv.0.weight``, ``7.weight`` …; ``conv1`` … ``conv8`` for VAEApprox),
so those files load with ``load_state_dict``; re-exports whose keys carry
``decoder.`` / ``encoder.`` are accepted too.  Files are found as the JAX
package finds them: ``<root>/VAE-taesd/{taesd,taesdxl,taesd3}_{encoder,
decoder}.{safetensors,pth}`` and ``<root>/VAE-approx/{model,vaeapprox-sdxl,
vaeapprox-sd3}.pt``, with the root ``models`` unless ``set_models_root``
says otherwise.  A file that is absent or does not load gives None, and
the caller runs the full VAE (or the cheap matrix for a preview), as in
JAX; the port logs each such fallback once.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sdwebui_tpu_torch.models.layers import Conv2d, reset_random

log = logging.getLogger(__name__)

# https://discuss.huggingface.co/t/decoding-latents-to-rgb-without-upscaling/23204/2
_CHEAP_SD = [[0.298, 0.207, 0.208], [0.187, 0.286, 0.173],
             [-0.158, 0.189, 0.264], [-0.184, -0.271, -0.473]]
_CHEAP_SDXL = [[0.3448, 0.4168, 0.4395], [-0.1953, -0.0290, 0.0250],
               [0.1074, 0.0886, -0.0163], [-0.3730, -0.2499, -0.2088]]
_CHEAP_SD3 = [
    [-0.0645, 0.0177, 0.1052], [0.0028, 0.0312, 0.0650],
    [0.1848, 0.0762, 0.0360], [0.0944, 0.0360, 0.0889],
    [0.0897, 0.0506, -0.0364], [-0.0020, 0.1203, 0.0284],
    [0.0855, 0.0118, 0.0283], [-0.0539, 0.0658, 0.1047],
    [-0.0057, 0.0116, 0.0700], [-0.0412, 0.0281, -0.0039],
    [0.1106, 0.1171, 0.1220], [-0.0248, 0.0682, -0.0481],
    [0.0815, 0.0846, 0.1207], [-0.0120, -0.0055, -0.0867],
    [-0.0749, -0.0634, -0.0456], [-0.1418, -0.1457, -0.1259],
]


def cheap_approximation(latent, kind: str = "sd1"):
    """Sampler-space latent (B, C, h, w) → RGB (B, 3, h, w) in [0, 1]; the
    coefficients apply to the scaled latent as the sampler holds it."""
    table = {"sd1": _CHEAP_SD, "sd2": _CHEAP_SD, "sdxl": _CHEAP_SDXL,
             "sd3": _CHEAP_SD3}.get(kind, _CHEAP_SD)
    coefs = torch.tensor(table, dtype=torch.float32, device=latent.device)
    rgb = torch.einsum("blhw,lr->brhw", latent.float(), coefs)
    return torch.clamp(rgb / 2.0 + 0.5, 0.0, 1.0)


# --------------------------------------------------------------------------
# VAEApprox ("Approx NN")
# --------------------------------------------------------------------------

#: the published net's (in, out, kernel) per conv
VAE_APPROX_LAYERS = ((4, 8, 7), (8, 16, 5), (16, 32, 3), (32, 64, 3), (64, 32, 3),
                     (32, 16, 3), (16, 8, 3), (8, 3, 3))


class VAEApprox(nn.Module):
    def __init__(self, layers=VAE_APPROX_LAYERS, *, device, dtype=torch.float32):
        super().__init__()
        for i, (cin, cout, k) in enumerate(layers, start=1):
            self.add_module(f"conv{i}", Conv2d(cin, cout, k, padding=0, device=device,
                                               dtype=dtype))

    def forward(self, latent):
        """Sampler-space latent (B, C, h, w) → RGB (B, 3, 2h, 2w) in [0, 1]."""
        x = F.interpolate(latent.float(), scale_factor=2.0, mode="nearest")
        x = F.pad(x, (11, 11, 11, 11))
        for i in range(1, 9):
            x = F.leaky_relu(getattr(self, f"conv{i}")(x), 0.1)
        return torch.clamp(x / 2.0 + 0.5, 0.0, 1.0)


def vae_approx_from_state_dict(sd: dict, device="cpu") -> VAEApprox:
    """The net of a ``conv1`` … ``conv8`` state dict, its widths and kernels
    read from the weights (the SDXL and SD3 files differ in their first)."""
    layers = tuple((sd[f"conv{i}.weight"].shape[1], sd[f"conv{i}.weight"].shape[0],
                    sd[f"conv{i}.weight"].shape[2]) for i in range(1, 9))
    net = VAEApprox(layers, device=device)
    net.load_state_dict({k: v.float() for k, v in sd.items()}, strict=True)
    return net


# --------------------------------------------------------------------------
# TAESD
# --------------------------------------------------------------------------

class _Clamp(nn.Module):
    def forward(self, x):
        return torch.tanh(x / 3.0) * 3.0


class TAESDBlock(nn.Module):
    """conv-ReLU-conv-ReLU-conv plus the input (a bias-free 1×1 conv when
    the widths differ), then ReLU."""

    def __init__(self, cin, cout, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.conv = nn.Sequential(Conv2d(cin, cout, 3, **kw), nn.ReLU(),
                                  Conv2d(cout, cout, 3, **kw), nn.ReLU(),
                                  Conv2d(cout, cout, 3, **kw))
        self.skip = Conv2d(cin, cout, 1, bias=False, **kw) if cin != cout else None

    def forward(self, x):
        skip = x if self.skip is None else self.skip(x)
        return F.relu(self.conv(x) + skip)


def taesd_decoder(latent_channels: int = 4, *, device, dtype=torch.float32) -> nn.Sequential:
    """The published decoder: Clamp, conv, ReLU, 3 blocks, then three times
    (upsample, bias-free conv, blocks), a block and conv(64 → 3) (indices
    0 … 19)."""
    kw = dict(device=device, dtype=dtype)

    def blocks(n):
        return [TAESDBlock(64, 64, **kw) for _ in range(n)]

    layers = [_Clamp(), Conv2d(latent_channels, 64, 3, **kw), nn.ReLU(), *blocks(3)]
    for n in (3, 3, 1):
        layers += [nn.Upsample(scale_factor=2), Conv2d(64, 64, 3, bias=False, **kw), *blocks(n)]
    return nn.Sequential(*layers, Conv2d(64, 3, 3, **kw))


def taesd_encoder(latent_channels: int = 4, *, device, dtype=torch.float32) -> nn.Sequential:
    """The published encoder: conv(3 → 64), a block, then three times (a
    bias-free stride-2 conv, 3 blocks), conv(64 → latent) (indices 0 … 14)."""
    kw = dict(device=device, dtype=dtype)
    layers = [Conv2d(3, 64, 3, **kw), TAESDBlock(64, 64, **kw)]
    for _ in range(3):
        layers += [Conv2d(64, 64, 3, stride=2, bias=False, **kw),
                   *(TAESDBlock(64, 64, **kw) for _ in range(3))]
    return nn.Sequential(*layers, Conv2d(64, latent_channels, 3, **kw))


def taesd_decode(decoder: nn.Module, latent):
    """TAESD decode: sampler-space latent (B, C, h, w) → RGB (B, 3, 8h, 8w)
    in [0, 1], fp32."""
    return torch.clamp(decoder(latent.float().contiguous(memory_format=torch.channels_last)),
                       0.0, 1.0)


def taesd_encode(encoder: nn.Module, images):
    """TAESD encode: RGB (B, 3, H, W) in [0, 1] → sampler-space latent
    (B, C, H/8, W/8), fp32."""
    return encoder(images.float().contiguous(memory_format=torch.channels_last))


def taesd_from_state_dict(sd: dict, device="cpu") -> nn.Sequential:
    """A TAESD encoder or decoder from its state dict (bare indices, or
    keys carrying ``decoder.`` / ``encoder.``): an encoder has a
    ``0.weight`` of 3 input channels, a decoder its first conv at 1."""
    sd = {k.replace("decoder.", "").replace("encoder.", ""): v.float() for k, v in sd.items()}
    if "0.weight" in sd:
        net = taesd_encoder(sd["14.weight"].shape[0], device=device)
    else:
        net = taesd_decoder(sd["1.weight"].shape[1], device=device)
    net.load_state_dict(sd, strict=True)
    return net


def _read(path: str) -> dict:
    if path.endswith(".safetensors"):
        from sdwebui_tpu_torch.loader.safetensors_io import read_state_dict

        return read_state_dict(path)
    from sdwebui_tpu_torch.loader.torch_ckpt import load_torch_checkpoint

    return load_torch_checkpoint(path)


def load_taesd(path: str, device="cpu") -> nn.Sequential:
    """A published TAESD ``.safetensors`` / ``.pth`` encoder or decoder."""
    return taesd_from_state_dict(_read(path), device)


def load_vae_approx(path: str, device="cpu") -> VAEApprox:
    """A ``model.pt`` / ``vaeapprox-sdxl.pt`` / ``vaeapprox-sd3.pt`` file."""
    return vae_approx_from_state_dict(_read(path), device)


def _tree_state_dict(tree: dict) -> dict:
    """A JAX tree of these nets (conv HWIO) → a torch state dict (OIHW)."""
    from sdwebui_tpu_torch.utils.pytree import flatten

    sd = {}
    for key, leaf in flatten(tree).items():
        t = torch.from_numpy(np.array(leaf, np.float32))
        sd[key] = t.permute(3, 2, 0, 1).contiguous() if t.dim() == 4 else t
    return sd


def taesd_from_jax(tree: dict, device="cpu") -> nn.Sequential:
    """The JAX package's TAESD tree (``load_taesd``'s layout)."""
    return taesd_from_state_dict(_tree_state_dict(tree), device)


def vae_approx_from_jax(tree: dict, device="cpu") -> VAEApprox:
    """The JAX package's VAEApprox tree (``load_vae_approx``'s layout)."""
    return vae_approx_from_state_dict(_tree_state_dict(tree), device)


def random_taesd(which: str, latent_channels: int = 4, seed: int = 0, device="cpu"):
    """A TAESD encoder or decoder at the published widths with seeded
    random weights (conv weights N(0, 1/fan_in), zero biases)."""
    make = taesd_encoder if which == "encoder" else taesd_decoder
    net = make(latent_channels, device=device)
    reset_random(net, torch.Generator(device=device).manual_seed(seed))
    return net


# --------------------------------------------------------------------------
# discovery
# --------------------------------------------------------------------------

_root = "models"
_CACHE: dict = {}
_LOGGED: set = set()


def set_models_root(root: str) -> None:
    """The directory whose VAE-taesd / VAE-approx folders are searched
    (default ``models``, relative to the working directory)."""
    global _root
    _root = root
    _CACHE.clear()


def models_root() -> str:
    return _root


def _taesd_stem(kind: str) -> str:
    return {"sdxl": "taesdxl", "sdxl-refiner": "taesdxl", "sd3": "taesd3"}.get(kind, "taesd")


def _load_cached(key, paths, loader, device):
    if key in _CACHE:
        return _CACHE[key]
    net, why = None, f"none of {paths} exists"
    for path in paths:
        if os.path.exists(path):
            try:
                net = loader(path, device).eval()
                break
            except Exception as e:      # a file that does not load, as JAX: None
                why = f"{path} did not load: {type(e).__name__}: {e}"
    if net is None and key not in _LOGGED:
        _LOGGED.add(key)
        log.warning("%s: %s", key[0], why)
    _CACHE[key] = net
    return net


def get_taesd(kind: str, which: str = "decoder", device="cpu", root: str | None = None):
    """The TAESD encoder or decoder of a model family on `device`, or None
    when no file of it loads (``get_taesd``, vae_approx.py:173)."""
    base = os.path.join(root or _root, "VAE-taesd", f"{_taesd_stem(kind)}_{which}")
    key = (f"TAESD {which}", base, str(torch.device(device)))
    return _load_cached(key, [base + ".safetensors", base + ".pth"], load_taesd, device)


def get_vae_approx(kind: str, device="cpu", root: str | None = None):
    """The VAEApprox net of a model family on `device`, or None
    (``get_vae_approx``, vae_approx.py:191)."""
    name = {"sdxl": "vaeapprox-sdxl.pt", "sdxl-refiner": "vaeapprox-sdxl.pt",
            "sd3": "vaeapprox-sd3.pt"}.get(kind, "model.pt")
    path = os.path.join(root or _root, "VAE-approx", name)
    key = ("VAE-approx", path, str(torch.device(device)))
    return _load_cached(key, [path], load_vae_approx, device)


def approx_decode(kind: str, method: str, latent):
    """Latent → RGB (B, 3, H, W) in [0, 1] by preview method name ("TAESD",
    "Approx NN", else the cheap matrix), the cheap matrix when the chosen
    net has no file (vae_approx.py:206)."""
    net = None
    if method == "TAESD":
        net = get_taesd(kind, "decoder", latent.device)
        if net is not None:
            return taesd_decode(net, latent)
    elif method == "Approx NN":
        net = get_vae_approx(kind, latent.device)
        if net is not None:
            return net(latent)
    return cheap_approximation(latent, kind)
