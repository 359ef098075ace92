"""Checkpoint merger (reference run_modelmerger, modules/extras.py:88).

Port of ``sdwebui_tpu/postprocessing/merger.py:29-105``: "Weighted sum",
"Add difference" and "No interpolation" over raw state dicts, ``model_ema.``
keys kept from the primary, the 9-channel against 4-channel ``conv_in``
blend over the shared channels, a baked VAE under ``first_stage_model.``,
the ``discard_weights`` regex and ``save_as_half``.

The arithmetic is JAX's, in float32 on `device`, one tensor at a time:
each input tensor goes to the device, is merged there and comes back to
the host, so no step holds more than one key's three operands on the card.
``a * (1 - m) + b * m`` and ``a + (b - c) * m`` are each a chain of
separate elementwise ops whose scalars are first rounded to float32, as
numpy rounds a Python float against a float32 array, so the merged
tensors are bit-equal to JAX's numpy merge on the CPU and on the card.
``save_as_half`` casts float16, float32 and float64 tensors only (numpy's
``floating``): bfloat16 and fp8 tensors keep their dtype, as in JAX.

Unlike JAX (``merger.py:99``), the output name must be one path component:
a name holding ``/``, ``\\``, a NUL or ``..`` is refused (``ValueError``),
as the extension installer refuses such directory names.
"""

from __future__ import annotations

import os
import re

import torch

from sdwebui_tpu_torch.utils.devices import get_device

INTERP_METHODS = ("Weighted sum", "Add difference", "No interpolation")

_SKIP_VAE_PREFIX = "first_stage_model."

#: numpy's ``floating``: the dtypes save_as_half casts
_HALF_CAST = (torch.float16, torch.float32, torch.float64)


def _f32(x: float) -> float:
    """A Python float rounded to float32, as numpy casts a scalar against a
    float32 array."""
    return float(torch.tensor(x, dtype=torch.float32))


def _interp(method: str, a, b, c, alpha: float):
    """JAX's _interp_weighted_sum / _interp_add_difference: one op at a
    time, in float32."""
    if method == "Weighted sum":
        return a * _f32(1.0 - alpha) + b * _f32(alpha)
    return a + (b - c) * _f32(alpha)


def _merge_key(method, a, b, c, multiplier, device):
    """One key's merged tensor (on the host), or None where JAX keeps the
    primary's tensor as it is (shapes that neither match nor are a
    conv_in of other channel counts)."""
    af = a.to(device).to(torch.float32)
    bf = b.to(device).to(torch.float32)
    cf = c.to(device).to(torch.float32) if c is not None else torch.zeros((), device=device)
    if tuple(a.shape) == tuple(b.shape):
        return _interp(method, af, bf, cf, multiplier).cpu()
    if a.dim() == 4 and b.dim() == 4 and a.shape[1] != b.shape[1]:
        # inpaint (9-channel) + normal (4-channel) conv_in: blend the shared channels
        n = min(a.shape[1], b.shape[1])
        cn = cf[:, :n] if cf.dim() == 4 else torch.zeros((), device=device)
        af = af.clone()                     # never the primary's own tensor
        af[:, :n] = _interp(method, af[:, :n], bf[:, :n], cn, multiplier)
        return af.cpu()
    return None


def merge_checkpoints(primary: dict, secondary: dict | None = None,
                      tertiary: dict | None = None, method: str = "Weighted sum",
                      multiplier: float = 0.5, save_as_half: bool = False,
                      vae: dict | None = None, discard_weights: str = "",
                      device=None) -> dict:
    """State dicts of tensors → the merged state dict, its tensors on the
    host; the merge itself runs on `device` (default the card), one key at a
    time."""
    if method not in INTERP_METHODS:
        raise NotImplementedError(f"interp_method {method!r} is not one of {INTERP_METHODS}")
    if method == "Add difference" and tertiary is None:
        raise ValueError("Add difference requires a tertiary model")
    device = get_device(device or "cuda")
    interpolate = method != "No interpolation" and secondary is not None
    out = {}
    for key, a in primary.items():
        merged = None
        if interpolate and key in secondary and not key.startswith("model_ema."):
            c = tertiary.get(key) if tertiary is not None else None
            merged = _merge_key(method, a, secondary[key], c, multiplier, device)
        out[key] = a if merged is None else merged
    if vae is not None:                     # bake an external VAE
        for k, v in vae.items():
            out[_SKIP_VAE_PREFIX + k] = v
    if discard_weights:
        pattern = re.compile(discard_weights)
        out = {k: v for k, v in out.items() if not pattern.search(k)}
    if save_as_half:
        out = {k: v.half() if v.dtype in _HALF_CAST else v for k, v in out.items()}
    return out


def check_output_name(name: str) -> str:
    """The merged file's name: one path component, or ValueError."""
    if name in (".", "..") or ".." in name or any(ch in name for ch in ("/", "\\", "\0")):
        raise ValueError(f"invalid merged checkpoint name {name!r}: it must be a file name "
                         "without path separators or '..'")
    return name


def run_modelmerger(primary_path: str, secondary_path: str | None,
                    tertiary_path: str | None, method: str, multiplier: float,
                    save_as_half: bool, output_name: str,
                    output_dir: str = os.path.join("models", "Stable-diffusion"),
                    bake_in_vae_path: str | None = None, discard_weights: str = "",
                    device=None) -> str:
    """Read the files, merge them on `device` (default the card) and write
    ``<output_dir>/<output_name>.safetensors`` with JAX's ``sd_merge_recipe``
    and ``format`` metadata; the path written."""
    from sdwebui_tpu_torch.loader.load import read_checkpoint
    from sdwebui_tpu_torch.loader.safetensors_io import write_safetensors

    check_output_name(output_name)
    primary = read_checkpoint(primary_path)
    secondary = read_checkpoint(secondary_path) if secondary_path else None
    tertiary = read_checkpoint(tertiary_path) if tertiary_path else None
    vae = read_checkpoint(bake_in_vae_path) if bake_in_vae_path else None

    merged = merge_checkpoints(primary, secondary, tertiary, method, multiplier,
                               save_as_half, vae, discard_weights, device=device)
    os.makedirs(output_dir, exist_ok=True)
    out_path = os.path.join(output_dir, f"{output_name}.safetensors")
    write_safetensors(out_path, merged, metadata={
        "sd_merge_recipe": f"{method} {multiplier} "
                           f"{os.path.basename(primary_path)} + "
                           f"{os.path.basename(secondary_path or '')}",
        "format": "pt"})
    return out_path
