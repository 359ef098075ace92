"""The extras stage chain — port of the Upscale stage of
``sdwebui_tpu/postprocessing/stages.py``.

``run_stages`` runs the stages over one RGB uint8 image in the order of
opts.postprocessing_operation_order, then the default order, leaving out
opts.postprocessing_disable_in_extras (the Extras routes) or running just
the named ones.  Upscale: scale-by (``upscaling_resize``, capped by
``max_side_length``) or scale-to (``upscaling_resize_w/h``, optionally
cropped to it), with ``upscaler_2`` blended over ``upscaler_1`` by
``extras_upscaler_2_visibility``.  The face-restoration stages (GFPGAN,
CodeFormer) are not ported: a visibility above 0 raises naming them.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from sdwebui_tpu_torch.postprocessing.upscalers import upscale
from sdwebui_tpu_torch.utils import images as images_util
from sdwebui_tpu_torch.utils.options import opts


@dataclasses.dataclass
class StageArgs:
    """The Extras request's stage fields and defaults."""

    resize_mode: int = 0          # 0 = scale by, 1 = scale to
    gfpgan_visibility: float = 0.0
    codeformer_visibility: float = 0.0
    codeformer_weight: float = 0.0
    upscaling_resize: float = 2.0
    upscaling_resize_w: int = 512
    upscaling_resize_h: int = 512
    upscaling_crop: bool = True
    upscaler_1: str = "None"
    upscaler_2: str = "None"
    extras_upscaler_2_visibility: float = 0.0
    max_side_length: int = 0
    upscale_first: bool = False

    @classmethod
    def from_obj(cls, obj: dict) -> "StageArgs":
        """From a request dict holding a subset of the fields, each coerced
        to its default's type."""
        kw = {}
        for f in dataclasses.fields(cls):
            v = obj.get(f.name)
            if v is not None:
                want = type(f.default)
                kw[f.name] = v if isinstance(v, want) else want(v)
        return cls(**kw)


def _run_upscaler(args: StageArgs, name: str, im: np.ndarray, sc: float) -> np.ndarray:
    """Scale-by mode honours max_side_length: when a side would pass it,
    the larger side becomes the limit (stages.py:57)."""
    h0, w0 = im.shape[:2]
    if args.resize_mode != 1 and args.max_side_length and max(w0, h0) * sc > args.max_side_length:
        w, h = w0 * sc, h0 * sc
        lim = args.max_side_length
        if h > w and h > lim:
            w, h = lim * w // h, lim
        elif w > lim:
            w, h = lim, lim * h // w
        out = upscale(name, im, max(w / w0, h / h0))
        return images_util.resize(out, (int(w), int(h)))
    return upscale(name, im, sc)


def _stage_upscale(args: StageArgs, im: np.ndarray) -> np.ndarray:
    h, w = im.shape[:2]
    if args.resize_mode == 1:
        scale = max(args.upscaling_resize_w / w, args.upscaling_resize_h / h)
    else:
        scale = args.upscaling_resize
    out = _run_upscaler(args, args.upscaler_1, im, scale)
    if args.upscaler_2 not in (None, "", "None") and args.extras_upscaler_2_visibility > 0:
        second = _run_upscaler(args, args.upscaler_2, im, scale)
        if second.shape != out.shape:
            second = images_util.resize(second, (out.shape[1], out.shape[0]))
        out = images_util.blend(out, second, args.extras_upscaler_2_visibility)
    if args.resize_mode == 1 and args.upscaling_crop:
        left = (out.shape[1] - args.upscaling_resize_w) // 2
        top = (out.shape[0] - args.upscaling_resize_h) // 2
        out = images_util.crop(out, (left, top, left + args.upscaling_resize_w,
                                     top + args.upscaling_resize_h))
    return out


def _face_stage(name: str, field: str):
    def stage(args: StageArgs, im: np.ndarray) -> np.ndarray:
        if getattr(args, field) > 0:
            raise NotImplementedError(f"{name} face restoration ({field!r}) is not ported yet")
        return im
    return stage


STAGES = {"Upscale": _stage_upscale,
          "GFPGAN": _face_stage("GFPGAN", "gfpgan_visibility"),
          "CodeFormer": _face_stage("CodeFormer", "codeformer_visibility")}


def run_stages(img, args: StageArgs, enabled: set | None = None) -> np.ndarray:
    """The stage chain over one image: enabled None → every stage less
    opts.postprocessing_disable_in_extras; a set → just those."""
    preferred = list(opts.get("postprocessing_operation_order", []) or [])
    order = [n for n in preferred if n in STAGES] + [n for n in STAGES if n not in preferred]
    if enabled is None:
        disabled = set(opts.get("postprocessing_disable_in_extras", []) or [])
        active = [n for n in order if n not in disabled]
    else:
        active = [n for n in order if n in enabled]
    out = images_util.to_rgb(img)
    for name in active:
        out = STAGES[name](args, out)
    return out
