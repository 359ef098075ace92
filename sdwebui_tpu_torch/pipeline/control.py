"""ControlNet units: a request's units → towers, hints and per-step scales,
and the residuals they add to each UNet call.

Port of ``sdwebui_tpu/pipeline/control.py`` and of the step-gated
injection of ``sdwebui_tpu/pipeline/processing.py:48-102``.  A unit names a
tower file (the process's registry over ``models/ControlNet``,
``set_model_dirs``), an image (or img2img's init image), an annotator
``module``, a weight, a guidance range and a control mode.  The tower runs
only at the steps whose scale is non-zero: JAX's ``lax.cond`` is a Python
``if`` on the host-side scale table here, so a gated step costs no device
work at all.  Control modes (the sd-webui-controlnet extension's):

  0 Balanced: the residuals on every row of the CFG batch;
  1 "My prompt is more important": residual i of n scaled by 0.825^(n-1-i);
  2 "ControlNet is more important": the residuals on the cond rows only
    (the CFG batch's first rows, AND prompts included), so the CFG combine
    amplifies them by the cond scale.

Several units add up.  At most one tower stays resident.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from sdwebui_tpu_torch.loader import convert, load
from sdwebui_tpu_torch.networks import NetworkNotFound
from sdwebui_tpu_torch.pipeline.annotators import run_annotator
from sdwebui_tpu_torch.utils import images as images_util

_MODEL_EXTS = (".safetensors", ".pt", ".ckpt", ".pth", ".bin")

#: where ControlNet files live unless the caller says otherwise
DEFAULT_CONTROLNET_DIR = os.path.join("models", "ControlNet")

CONTROL_MODES = {
    "balanced": 0,
    "my prompt is more important": 1,
    "controlnet is more important": 2,
}

#: mode 1's per-residual decay (the extension's soft injection)
SOFT_DECAY = 0.825


@dataclasses.dataclass
class ControlNetUnit:
    """One tower application (a unit of the extension's API)."""

    model: str = ""                 # a file name in the registry, or a path
    image: Any = None               # uint8 (H, W[, C]) image, or float (H, W[, C]) in [0, 1]
    weight: float = 1.0
    guidance_start: float = 0.0     # fraction of the steps
    guidance_end: float = 1.0
    enabled: bool = True
    control_mode: Any = 0           # 0 / 1 / 2 or the extension's names
    module: str = "none"            # annotator (pipeline/annotators.py)
    processor_res: int = 512
    threshold_a: Any = None         # per-module meaning (canny low, ...)
    threshold_b: Any = None

    @classmethod
    def from_dict(cls, d: dict) -> "ControlNetUnit":
        known = {f.name for f in dataclasses.fields(cls)}
        args = {k: v for k, v in d.items() if k in known}
        if "input_image" in d and args.get("image") is None:
            args["image"] = d["input_image"]      # the extension's name
        return cls(**args)

    @property
    def mode_int(self) -> int:
        m = self.control_mode
        if isinstance(m, str):
            if m.strip().lower() not in CONTROL_MODES:
                raise ValueError(f"unknown control_mode {m!r} (one of {list(CONTROL_MODES)})")
            return CONTROL_MODES[m.strip().lower()]
        if int(m) not in (0, 1, 2):
            raise ValueError(f"unknown control_mode {m!r} (0, 1 or 2)")
        return int(m)


# --------------------------------------------------------------------------
# the tower registry (control.py:70-117)
# --------------------------------------------------------------------------

_dirs = [DEFAULT_CONTROLNET_DIR]
_resident: dict = {}


def set_model_dirs(dirs):
    """Point the process's ControlNet registry at `dirs`; drops the
    resident tower."""
    _dirs[:] = list(dirs)
    _resident.clear()


def list_models() -> list[str]:
    return [os.path.splitext(fn)[0] for d in _dirs if os.path.isdir(d)
            for fn in sorted(os.listdir(d)) if fn.endswith(_MODEL_EXTS)]


def resolve_path(name: str) -> str:
    if os.path.isfile(name):
        return name
    for d in _dirs:
        for ext in _MODEL_EXTS:
            cand = os.path.join(d, name if name.endswith(ext) else name + ext)
            if os.path.isfile(cand):
                return cand
    raise NetworkNotFound(f"ControlNet model {name!r} not found in {_dirs}")


def load_controlnet(name_or_path: str, device, dtype):
    """→ (ControlNetModel, its UNetConfig), loaded once; a tower of another
    name, device or dtype replaces it."""
    path = resolve_path(name_or_path)
    key = (path, os.path.getmtime(path), str(device), dtype)
    if key not in _resident:
        _resident.clear()
        sd, cfg, hint_ch = convert.convert_controlnet(load.read_checkpoint(path))
        tower = load.build("controlnet", cfg, sd, device, dtype, hint_channels=hint_ch)
        _resident[key] = (tower, cfg)
    return _resident[key]


# --------------------------------------------------------------------------
# hints (control.py:120-156)
# --------------------------------------------------------------------------

def to_hint_array(image, width: int, height: int, channels: int) -> np.ndarray:
    """→ (height, width, channels) float32 in [0, 1].  A uint8 image is
    converted like Pillow's ``convert`` ("RGB", or "L" below 3 channels)
    and resized with the Lanczos restatement (JAX's PIL branch); a float
    array is resized with antialiased bilinear (JAX's ``jax.image.resize``
    branch)."""
    arr = np.asarray(image)
    if arr.dtype == np.uint8:
        arr = images_util.to_rgb(arr) if channels >= 3 else images_util.to_l(arr)
        if arr.shape[:2] != (height, width):
            arr = images_util.resize(arr, (width, height), "lanczos")
        arr = arr.astype(np.float32) / 255.0
    else:
        arr = arr.astype(np.float32)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.shape[:2] != (height, width):
        t = torch.from_numpy(np.ascontiguousarray(arr.transpose(2, 0, 1)))[None]
        t = F.interpolate(t, size=(height, width), mode="bilinear", align_corners=False,
                          antialias=True)
        arr = t[0].permute(1, 2, 0).numpy()
    if arr.shape[-1] < channels:          # grey hint into RGB slots
        arr = np.repeat(arr, channels, axis=-1)[..., :channels]
    return np.ascontiguousarray(arr[..., :channels], np.float32)


def step_scales(unit: ControlNetUnit, n_steps: int) -> np.ndarray:
    """The unit's weight at the steps inside its guidance range, else 0."""
    frac = np.arange(n_steps, dtype=np.float32) / max(n_steps - 1, 1)
    active = (frac >= unit.guidance_start - 1e-6) & (frac <= unit.guidance_end + 1e-6)
    return np.where(active, np.float32(unit.weight), np.float32(0.0))


@dataclasses.dataclass
class PreparedControl:
    tower: torch.nn.Module
    cfg: Any                        # the tower's UNetConfig
    hint: torch.Tensor              # (1, hint_channels, H, W) on the device
    scales: np.ndarray              # (n_steps,) host floats
    mode: int


def prepare_controls(units, width: int, height: int, n_steps: int, latent_channels: int,
                     device, dtype, default_image=None) -> list:
    """A request's units (ControlNetUnit or dicts) → [PreparedControl];
    disabled units and units without a model or image drop out.
    default_image fills a unit without an image of its own (img2img's init
    image, as the extension does)."""
    out = []
    for u in units or []:
        u = ControlNetUnit.from_dict(u) if isinstance(u, dict) else u
        if u.image is None and default_image is not None:
            u = dataclasses.replace(u, image=default_image)
        if not u.enabled or u.image is None or not u.model:
            continue
        image = u.image
        if u.module and u.module != "none":
            image = run_annotator(u.module, to_hint_array(image, width, height, 3), res=0,
                                  threshold_a=u.threshold_a, threshold_b=u.threshold_b,
                                  device=device)
        tower, cfg = load_controlnet(u.model, device, dtype)
        if cfg.in_channels != latent_channels:
            raise ValueError(f"ControlNet {u.model!r} expects {cfg.in_channels} latent "
                             f"channels; the model makes {latent_channels}")
        hint = to_hint_array(image, width, height, tower.hint_channels)
        out.append(PreparedControl(
            tower, cfg, torch.from_numpy(hint.transpose(2, 0, 1)[None].copy()).to(device),
            step_scales(u, n_steps), u.mode_int))
    return out


def control_residuals(controls: list, x_in, timesteps, context, y, step: int,
                      n_cond_rows: int):
    """The summed residuals of every unit active at `step` for one UNet call
    on x_in (the CFG batch, cond rows first), or None when none is."""
    b = x_in.shape[0]
    total = None
    for c in controls:
        scale = float(c.scales[min(max(step, 0), len(c.scales) - 1)])
        if scale == 0.0:
            continue
        hint = c.hint.to(x_in.dtype).expand(b, -1, -1, -1)
        res = c.tower(x_in[:, :c.cfg.in_channels], timesteps, context, hint,
                      y if c.cfg.adm_in_channels else None)
        n = len(res["input"]) + 1
        soft = [SOFT_DECAY ** (n - 1 - i) if c.mode == 1 else 1.0 for i in range(n)]
        gate = 1.0
        if c.mode == 2:
            gate = (torch.arange(b, device=x_in.device) < n_cond_rows).to(x_in.dtype)
            gate = gate[:, None, None, None]
        res = {"input": tuple(r * (w * gate) * scale for r, w in zip(res["input"], soft)),
               "middle": res["middle"] * (soft[-1] * gate) * scale}
        total = res if total is None else {
            "input": tuple(a + r for a, r in zip(total["input"], res["input"])),
            "middle": total["middle"] + res["middle"]}
    return total
