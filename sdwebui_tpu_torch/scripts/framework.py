"""Scripts and callbacks — port of ``sdwebui_tpu/scripts/framework.py``
(the reference's modules/scripts.py:52-348 and modules/script_callbacks.py).

A :class:`Script` is either selectable (``script_name``: its ``run``
replaces the whole generation) or always-on: it joins the process-wide
:class:`ScriptRunner` when its class is registered, and the pipelines fire
its lifecycle hooks in the reference's order (setup → before_process →
after_extra_networks_activate → process → before_process_batch →
process_batch → process_before_every_sampling → post_sample →
postprocess_batch → postprocess_batch_list → postprocess_image →
postprocess_maskoverlay → postprocess_image_after_composite →
postprocess).  ``on_mask_blend`` fires once before sampling with the blend
inputs, as in JAX (the blend itself runs in ``sampling/cfg.py``).  A hook
that raises is logged with its traceback and the job carries on, as the
reference's runner prints it and carries on.  The callback registry holds
the 21 named channels extensions attach to (``on`` / ``invoke``).

Images in the hook arguments are uint8 (H, W, 3) numpy arrays and latents
are (B, C, h, w) tensors on the model's device.
"""

from __future__ import annotations

import dataclasses
import logging
from collections import defaultdict
from typing import Any, Callable

log = logging.getLogger(__name__)


# ---- hook argument bundles (framework.py:25-66) ---------------------------

@dataclasses.dataclass
class ImageSaveParams:
    """Before and after an image is saved: hooks may swap the image, rename
    the file or edit the PNG text."""
    image: object
    p: object
    filename: str
    pnginfo: dict


@dataclasses.dataclass
class PostSampleArgs:
    samples: Any                      # latents, before the VAE decode


@dataclasses.dataclass
class PostprocessImageArgs:
    image: Any                        # uint8 (H, W, 3)
    index: int = 0


@dataclasses.dataclass
class PostprocessBatchListArgs:
    images: list


@dataclasses.dataclass
class MaskBlendArgs:
    current_latent: Any
    nmask: Any
    init_latent: Any
    mask: Any
    blended_latent: Any = None
    denoiser: Any = None
    sigma: Any = None


@dataclasses.dataclass
class PostProcessMaskOverlayArgs:
    index: int
    mask_for_overlay: Any
    overlay_image: Any


class Script:
    name = "base"
    section = None
    alwayson = False
    # the UI argument spec, in run(*args) order: dicts with name, label,
    # type ("text" | "number" | "checkbox" | "select" | "textarea"),
    # default, and optional choices (a list, or a registry key the UI
    # resolves: "samplers" | "upscalers" | "checkpoints"); served by
    # /sdapi/v1/script-info
    ui_params: list = []

    def title(self) -> str:
        return self.name

    # selectable scripts take over the generation
    def run(self, engine, p, *args):
        raise NotImplementedError

    # ---- always-on lifecycle hooks (the reference's order and names) ----
    def setup(self, p, *args):
        pass

    def before_process(self, p, *args):
        pass

    def process(self, p, *args):
        pass

    def before_process_batch(self, p, *args, **kwargs):
        pass

    def after_extra_networks_activate(self, p, *args, **kwargs):
        pass

    def process_before_every_sampling(self, p, *args, **kwargs):
        pass

    def process_batch(self, p, *args, batch_number=0, seeds=None, **kwargs):
        pass

    def on_mask_blend(self, p, mba: MaskBlendArgs, *args):
        pass

    def post_sample(self, p, ps: PostSampleArgs, *args):
        pass

    def postprocess_batch(self, p, *args, images=None, batch_number=0):
        pass

    def postprocess_batch_list(self, p, pp: PostprocessBatchListArgs, *args, **kwargs):
        pass

    def postprocess_image(self, p, image, *args):
        return image

    def postprocess_maskoverlay(self, p, ppmo: PostProcessMaskOverlayArgs, *args):
        pass

    def postprocess_image_after_composite(self, p, pp: PostprocessImageArgs, *args):
        pass

    def postprocess(self, p, processed, *args):
        pass


_SCRIPT_REGISTRY: dict[str, type] = {}


class ScriptArgError(ValueError):
    """A script_args value the script cannot take: names the failing
    argument, so the API answers 400 with the control's label."""

    def __init__(self, script_name: str, index: int, label: str, message: str):
        self.script_name = script_name
        self.index = index
        self.label = label
        super().__init__(f"script {script_name!r} argument {index} ({label}): {message}")


def validate_script_args(script: Script, args) -> None:
    """Check script_args' count and each control's type against the
    script's ui_params before it runs (framework.py:140-205).  A select
    takes a choice or its index; a registry key's choices are the
    script's to resolve.  A script with another argument layout (XYZ's
    index convention) checks it in its own ``validate_args``."""
    custom = getattr(script, "validate_args", None)
    if custom is not None and custom(args):
        return
    spec = script.ui_params
    if len(args) > len(spec):
        raise ScriptArgError(script.name, len(spec), "<extra>",
                             f"takes at most {len(spec)} script_args, got {len(args)}")
    for i, (param, val) in enumerate(zip(spec, args)):
        kind = param.get("type", "text")
        label = param.get("label", param.get("name", f"arg{i}"))

        def fail(message):
            raise ScriptArgError(script.name, i, label, message)

        if val is None:
            continue    # every script reads None as its default
        if kind == "number":
            if isinstance(val, bool):
                fail("expected a number, got a boolean")
            try:
                float(val)
            except (TypeError, ValueError):
                fail(f"expected a number, got {val!r}")
        elif kind == "checkbox":
            if not isinstance(val, (bool, int)):
                fail(f"expected true/false, got {val!r}")
        elif kind == "select":
            choices = param.get("choices")
            if isinstance(val, bool) or not isinstance(val, (str, int)):
                fail(f"expected a choice name or index, got {val!r}")
            if isinstance(choices, (list, tuple)) and choices:
                if isinstance(val, int):
                    if not 0 <= val < len(choices):
                        fail(f"choice index {val} out of range (0..{len(choices) - 1})")
                elif val not in choices:
                    preview = ", ".join(map(repr, list(choices)[:4]))
                    fail(f"{val!r} is not one of the {len(choices)} choices ({preview}, ...)")
        elif kind in ("text", "textarea"):
            if not isinstance(val, (str, int, float)):
                fail(f"expected text, got {type(val).__name__}")


def register_script(cls):
    """Register a Script class; an always-on one joins the process-wide
    runner once (the reference's ScriptRunner.initialize_scripts)."""
    _SCRIPT_REGISTRY[cls.name.lower()] = cls
    if cls.alwayson and not any(type(s) is cls for s in _default_runner.alwayson_scripts):
        _default_runner.add(cls())
    return cls


def list_selectable_scripts():
    return sorted(n for n, c in _SCRIPT_REGISTRY.items() if not c.alwayson)


def list_alwayson_scripts():
    return sorted(n for n, c in _SCRIPT_REGISTRY.items() if c.alwayson)


def get_script(name: str) -> Script | None:
    cls = _SCRIPT_REGISTRY.get((name or "").lower())
    return cls() if cls else None


class ScriptRunner:
    """Fires each hook on every always-on script in registration order
    (the reference's ScriptRunner, modules/scripts.py:542)."""

    def __init__(self):
        self.alwayson_scripts: list[Script] = []

    def add(self, script: Script):
        self.alwayson_scripts.append(script)

    def _each(self, hook: str, *args, **kwargs):
        for s in self.alwayson_scripts:
            try:
                getattr(s, hook)(*args, **kwargs)
            except Exception:
                log.exception("script %r: hook %s failed", s.name, hook)

    def setup_scripts(self, p):
        self._each("setup", p)

    def before_process(self, p):
        self._each("before_process", p)

    def process(self, p):
        self._each("process", p)

    def before_process_batch(self, p, **kwargs):
        self._each("before_process_batch", p, **kwargs)

    def after_extra_networks_activate(self, p, **kwargs):
        self._each("after_extra_networks_activate", p, **kwargs)

    def process_before_every_sampling(self, p, **kwargs):
        self._each("process_before_every_sampling", p, **kwargs)

    def process_batch(self, p, batch_number=0, seeds=None, **kwargs):
        self._each("process_batch", p, batch_number=batch_number, seeds=seeds, **kwargs)

    def on_mask_blend(self, p, mba: MaskBlendArgs):
        self._each("on_mask_blend", p, mba)

    def post_sample(self, p, ps: PostSampleArgs):
        self._each("post_sample", p, ps)

    def postprocess_batch(self, p, images=None, batch_number=0):
        self._each("postprocess_batch", p, images=images, batch_number=batch_number)

    def postprocess_batch_list(self, p, pp: PostprocessBatchListArgs):
        self._each("postprocess_batch_list", p, pp)

    def postprocess_image(self, p, image):
        """Each script's image replaces the one before (a None keeps it)."""
        for s in self.alwayson_scripts:
            try:
                out = s.postprocess_image(p, image)
                if out is not None:
                    image = out
            except Exception:
                log.exception("script %r: hook postprocess_image failed", s.name)
        return image

    def postprocess_maskoverlay(self, p, ppmo: PostProcessMaskOverlayArgs):
        self._each("postprocess_maskoverlay", p, ppmo)

    def postprocess_image_after_composite(self, p, pp: PostprocessImageArgs):
        self._each("postprocess_image_after_composite", p, pp)

    def postprocess(self, p, processed):
        self._each("postprocess", p, processed)


_default_runner = ScriptRunner()


def get_runner() -> ScriptRunner:
    """The process-wide always-on runner the pipelines fire."""
    return _default_runner


# ---- callback registry (framework.py:318-349) -----------------------------

CALLBACK_CHANNELS = [
    "app_started", "model_loaded", "ui_tabs", "ui_settings", "before_ui",
    "image_saved", "before_image_saved", "cfg_denoiser", "cfg_denoised",
    "cfg_after_cfg", "extra_noise", "infotext_pasted", "script_unloaded",
    "list_optimizers", "list_unets", "before_token_counter",
    "on_reload", "image_grid", "mask_blend", "before_process",
    "after_extra_networks_activate",
]

_callbacks: dict[str, list] = defaultdict(list)


def on(channel: str, fn: Callable):
    if channel not in CALLBACK_CHANNELS:
        raise ValueError(f"unknown callback channel {channel!r}")
    _callbacks[channel].append(fn)


def remove_current_script_callbacks():
    _callbacks.clear()


def invoke(channel: str, *args, **kwargs) -> list:
    """Call every callback of `channel`; the results of those that did not
    raise (one that raises is logged with its traceback)."""
    results = []
    for fn in _callbacks[channel]:
        try:
            results.append(fn(*args, **kwargs))
        except Exception:
            log.exception("callback %r on channel %r failed", fn, channel)
    return results
