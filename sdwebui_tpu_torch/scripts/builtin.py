"""The built-in scripts — port of ``sdwebui_tpu/scripts/builtin.py`` (the
reference's scripts/ directory): X/Y/Z plot, prompt matrix, prompts from
file, loopback, SD upscale, the two outpaintings, img2img alternative,
custom code and the main UI's postprocessing.

Images are uint8 (H, W, 3) numpy arrays; the Pillow operations are
``utils/images`` and ``utils/masking`` restatements.  Each cell runs
through the Engine's ``txt2img_inner`` / ``img2img_inner`` on a shallow
copy of the request, as JAX's ``_clone`` makes it (builtin.py:19-23): the
cells share the request's ``override_settings`` and
``extra_generation_params`` dicts, so an options axis writes into the
request's dict and an infotext key one cell adds stays for the next.

The X/Y/Z legend and the prompt matrix's legend are drawn by
``utils/grid_annotations`` as JAX's Pillow draws them.  Every value the
JAX package's script path ignores (an options axis whose cell JAX leaves
unchanged, the Styles axis, "Use same random seed for all lines") raises
``NotImplementedError`` naming it: the port never drops one silently.
"""

from __future__ import annotations

import copy
import re
from types import ModuleType

import numpy as np
import torch

from sdwebui_tpu_torch.pipeline.img2img import _prepare_images_and_mask
from sdwebui_tpu_torch.pipeline.params import GenerationParams, Processed
from sdwebui_tpu_torch.pipeline.processing import (_build_conds, encode_first_stage,
                                                   image_grid, invert_noise)
from sdwebui_tpu_torch.postprocessing.noise_match import matched_noise
from sdwebui_tpu_torch.postprocessing.stages import StageArgs, run_stages
from sdwebui_tpu_torch.postprocessing.upscalers import upscale
from sdwebui_tpu_torch.sampling.schedulers import get_schedule
from sdwebui_tpu_torch.scripts.framework import Script, ScriptArgError, register_script
from sdwebui_tpu_torch.utils import images as images_util
from sdwebui_tpu_torch.utils import masking
from sdwebui_tpu_torch.utils.grid_annotations import (GridAnnotation, draw_grid_annotations,
                                                      draw_prompt_matrix)
from sdwebui_tpu_torch.utils.options import opts

def _clone(p: GenerationParams) -> GenerationParams:
    q = copy.copy(p)
    q.all_prompts, q.all_negative_prompts = [], []
    q.all_seeds, q.all_subseeds = [], []
    return q


# ==========================================================================
# X/Y/Z plot (builtin.py:27-435)
# ==========================================================================

def _run_cell(engine, q: GenerationParams) -> Processed:
    """One cell: img2img when the request has init images, else txt2img
    (the reference's scripts call process_images, which dispatches on the
    tab)."""
    if getattr(q, "init_images", None):
        return engine.img2img_inner(q)
    return engine.txt2img_inner(q)


def _apply_field(field):
    def fn(p, v):
        setattr(p, field, type(getattr(p, field, v))(v)
                if getattr(p, field, None) is not None else v)
    fn._field = field       # validation reads the target field's type
    return fn


AXIS_OPTIONS = {
    "Nothing": None,
    "Seed": _apply_field("seed"),
    "Var. seed": _apply_field("subseed"),
    "Var. strength": _apply_field("subseed_strength"),
    "Steps": _apply_field("steps"),
    "CFG Scale": _apply_field("cfg_scale"),
    "Image CFG Scale": _apply_field("image_cfg_scale"),
    "Sampler": _apply_field("sampler_name"),
    "Schedule type": _apply_field("scheduler"),
    "Denoising": _apply_field("denoising_strength"),
    "Clip skip": _apply_field("clip_skip"),
    "Width": _apply_field("width"),
    "Height": _apply_field("height"),
    "Eta": _apply_field("eta"),
    "Sigma Churn": _apply_field("s_churn"),
    "Sigma min": _apply_field("s_tmin"),
    "Sigma max": _apply_field("s_tmax"),
    "Sigma noise": _apply_field("s_noise"),
    "Initial noise multiplier": _apply_field("initial_noise_multiplier"),
    "Negative Guidance minimum sigma": _apply_field("s_min_uncond"),
    "Hires steps": _apply_field("hr_second_pass_steps"),
    "Hires upscaler": _apply_field("hr_upscaler"),
    "Hires sampler": _apply_field("hr_sampler_name"),
    "Hires CFG Scale": _apply_field("hr_cfg_scale"),
    "Hires scale": _apply_field("hr_scale"),
    "Refiner checkpoint": _apply_field("refiner_checkpoint"),
    "Refiner switch at": _apply_field("refiner_switch_at"),
    "Face restore": _apply_field("restore_faces"),
    "Styles": "styles",
    "Prompt S/R": "prompt_sr",     # search and replace: the first value is the token
    "Prompt order": "prompt_order",
    "Size": "size",                # "WxH": width and height of the cell
}

#: axes that sweep an option, written into the cell's override_settings
OPTS_AXES = {
    "Checkpoint name": "sd_model_checkpoint",
    "VAE": "sd_vae",
    "Token merging ratio": "token_merging_ratio",
    "Token merging ratio high-res": "token_merging_ratio_hr",
    "RNG source": "randn_source",
    "Beta schedule alpha": "beta_dist_alpha",
    "Beta schedule beta": "beta_dist_beta",
    "Emphasis": "emphasis",
    "Eta noise seed delta": "eta_noise_seed_delta",
    "Schedule min sigma": "sigma_min",
    "Schedule max sigma": "sigma_max",
    "Schedule rho": "rho",
    "UniPC Order": "uni_pc_order",
    "UniPC Variant": "uni_pc_variant",
    "Face restore model": "face_restoration_model",
    "Extra noise": "img2img_extra_noise",
    "Always discard next-to-last sigma": "always_discard_next_to_last_sigma",
    "SGM noise multiplier": "sgm_noise_multiplier",
    "Cond. Image Mask Weight": "inpainting_mask_weight",
    "FP8 mode": "fp8_storage",
}

#: axes whose value the JAX package's cells leave unread: each raises
#: naming itself (ROADMAP C)
UNPORTED_AXES = {
    "VAE": "the JAX package's script cells never switch the VAE (app.py:384-393 skips "
           "_maybe_switch_vae)",
    "Emphasis": "the JAX package pushes emphasis into the conditioners outside the "
                "script path only (app.py:73-94), so its cells keep the request's",
    "FP8 mode": "the JAX package applies fp8_storage outside the script path only "
                "(app.py:94-125)",
    "Beta schedule alpha": "the JAX package never reads beta_dist_alpha",
    "Beta schedule beta": "the JAX package never reads beta_dist_beta",
    "Cond. Image Mask Weight": "the JAX package never reads inpainting_mask_weight",
    "Styles": "the JAX package's script cells apply no styles (app.py:384-393 skips "
              "apply_styles)",
}

# The reference API passes axes as indices into the tab's filtered axis
# list (scripts/xyz_grid.py:239-283, filtered at :420), with a
# values_dropdown list after each values string; these orders reproduce
# that filtering (builtin.py:106-130).
_REF_AXES_COMMON_HEAD = ["Nothing", "Seed", "Var. seed", "Var. strength", "Steps"]
_REF_AXES_TAIL = [
    "Checkpoint name", "Negative Guidance minimum sigma", "Sigma Churn",
    "Sigma min", "Sigma max", "Sigma noise", "Schedule type",
    "Schedule min sigma", "Schedule max sigma", "Schedule rho",
    "Beta schedule alpha", "Beta schedule beta", "Eta", "Clip skip",
    "Denoising", "Initial noise multiplier", "Extra noise"]
_REF_AXES_TAIL2 = [
    "VAE", "Styles", "UniPC Order", "Face restore", "Token merging ratio",
    "Token merging ratio high-res", "Always discard next-to-last sigma",
    "SGM noise multiplier", "Refiner checkpoint", "Refiner switch at",
    "RNG source", "FP8 mode", "Size"]
REF_AXES_TXT2IMG = (_REF_AXES_COMMON_HEAD + ["Hires steps", "CFG Scale", "Prompt S/R",
                                             "Prompt order", "Sampler", "Hires sampler"]
                    + _REF_AXES_TAIL + ["Hires upscaler"] + _REF_AXES_TAIL2)
REF_AXES_IMG2IMG = (_REF_AXES_COMMON_HEAD + ["CFG Scale", "Image CFG Scale", "Prompt S/R",
                                             "Prompt order", "Sampler"]
                    + _REF_AXES_TAIL + ["Cond. Image Mask Weight"] + _REF_AXES_TAIL2)


def _axis_field_type(axis: str):
    """The Python type of the GenerationParams field an axis sweeps (None
    for Nothing, the option axes and the compound ones): it drives range
    expansion and validation."""
    field = getattr(AXIS_OPTIONS.get(axis), "_field", None)
    if field is None:
        return None
    cur = getattr(GenerationParams(prompt=""), field, None)
    if cur is not None:
        return type(cur)
    # fields whose default is None (denoising_strength, eta, ...): the annotation
    f = GenerationParams.__dataclass_fields__.get(field)
    ann = str(f.type) if f else ""
    return float if "float" in ann else int if "int" in ann else None


_NUM = r"[+-]?\d+(?:\.\d*)?"
# the range grammar of numeric axes (the reference's xyz_grid process_axis):
#   "A-B" inclusive, step 1; "A-B (+S)" step S; "A-B [N]" N evenly spaced values
_RANGE_RE = re.compile(rf"({_NUM})\s*-\s*({_NUM})"
                       rf"(?:\s*(?:\(\s*({_NUM})\s*\)|\[\s*(\d+)\s*\]))?$")


def _expand_range(v: str, ftype):
    m = _RANGE_RE.fullmatch(v.strip())
    if not m:
        return None
    a, b, step, count = m.groups()
    a, b = float(a), float(b)
    if count is not None:
        pts = np.linspace(a, b, max(int(count), 1))
    else:
        s = float(step) if step is not None else 1.0
        if s == 0:
            return None
        pts = np.arange(a, b + s / 2, s)
    return [int(round(p)) for p in pts] if ftype is int else [float(p) for p in pts]


def parse_axis_values(axis: str, values) -> list:
    if axis == "Nothing" or not values:
        return [None]
    if isinstance(values, (list, tuple)):
        return list(values)
    vals = [v.strip() for v in str(values).split(",") if v.strip() != ""]
    ftype = _axis_field_type(axis)
    out = []
    for v in vals:
        rng = _expand_range(v, ftype) if ftype in (int, float) else None
        if rng is not None:
            out.extend(rng)
        else:
            out.append(v)
    return out


def _ui(name, label, type="text", default="", choices=None):
    d = {"name": name, "label": label, "type": type, "default": default}
    if choices is not None:
        d["choices"] = choices
    return d


_ALL_AXES = list(AXIS_OPTIONS) + list(OPTS_AXES)


def _coerce(v):
    if isinstance(v, str):
        low = v.strip().lower()
        if low in ("true", "false"):
            return low == "true"
        try:
            return int(v)
        except ValueError:
            try:
                return float(v)
            except ValueError:
                return v
    return v


@register_script
class XYZPlot(Script):
    name = "X/Y/Z plot"
    ui_params = [
        _ui("x_axis", "X type", "select", "Nothing", _ALL_AXES),
        _ui("x_values", "X values"),
        _ui("y_axis", "Y type", "select", "Nothing", _ALL_AXES),
        _ui("y_values", "Y values"),
        _ui("z_axis", "Z type", "select", "Nothing", _ALL_AXES),
        _ui("z_values", "Z values"),
        _ui("draw_legend", "Draw legend", "checkbox", True),
        _ui("include_sub_grids", "Include Sub Grids", "checkbox", False),
    ]

    def validate_args(self, args):
        """The reference's index convention (13 args: three (type index,
        values, values dropdown) triples and four flags) as another layout:
        True when it applies (the 8-control check is then skipped)."""
        if not args:
            return False
        by_index = isinstance(args[0], (int, float)) and not isinstance(args[0], bool)
        has_dropdown = any(isinstance(v, (list, tuple)) for v in list(args)[2:9:3])
        if not (by_index or has_dropdown):
            return False
        if len(args) > 13:
            raise ScriptArgError(self.name, 13, "<extra>",
                                 f"reference-convention XYZ takes at most 13 script_args, "
                                 f"got {len(args)}")
        n_axes = max(len(REF_AXES_TXT2IMG), len(REF_AXES_IMG2IMG))
        labels = ("X", "Y", "Z")
        for a in range(3):
            base = 3 * a
            if base >= len(args):
                break
            t = args[base]
            if not isinstance(t, (bool, int, float, str, type(None))):
                raise ScriptArgError(self.name, base, f"{labels[a]} type",
                                     f"expected an axis index or name, got {t!r}")
            if isinstance(t, (int, float)) and not isinstance(t, bool) \
                    and not 0 <= int(t) < n_axes:
                raise ScriptArgError(self.name, base, f"{labels[a]} type",
                                     f"axis index {t} out of range (0..{n_axes - 1})")
            if base + 2 < len(args):
                d = args[base + 2]
                if d and not isinstance(d, (list, tuple)):
                    raise ScriptArgError(self.name, base + 2, f"{labels[a]} values dropdown",
                                         f"expected a list of choices, got {d!r}")
        return True

    def _check_axis_values(self, axis, parsed, slot, label):
        """A value a numeric axis cannot take answers 400 naming the axis."""
        if _axis_field_type(axis) not in (int, float):
            return
        for v in parsed:
            if not isinstance(v, str) or v.strip().lower() in ("true", "false"):
                continue
            try:
                float(v)
            except ValueError:
                raise ScriptArgError(self.name, slot, label,
                                     f"axis {axis!r} expects numbers, got {v!r}") from None

    def run(self, engine, p: GenerationParams,
            x_axis="Nothing", x_values="", y_axis="Nothing", y_values="",
            z_axis="Nothing", z_values="", draw_legend=True, include_sub_grids=False, *rest):
        if isinstance(x_axis, (int, float)) and not isinstance(x_axis, bool) \
                or isinstance(y_axis, (list, tuple)):
            # the reference's convention (scripts/xyz_grid.py run): a
            # (type index, values, values dropdown) triple per axis, then
            # draw_legend, include_lone_images, include_sub_grids, ...; the
            # indices are the tab's
            args = [x_axis, x_values, y_axis, y_values, z_axis, z_values,
                    draw_legend, include_sub_grids, *rest]
            args += [None] * (12 - len(args))
            order = REF_AXES_IMG2IMG if getattr(p, "init_images", None) else REF_AXES_TXT2IMG

            def axis_name(i):
                i = int(i or 0)
                return order[i] if 0 <= i < len(order) else "Nothing"

            def vals(text, dropdown, slot):
                if not dropdown:         # None, "", [], 0 or False: no dropdown
                    return text
                if not isinstance(dropdown, (list, tuple)):
                    raise ScriptArgError(self.name, slot, "values dropdown",
                                         f"expected a list of choices, got {dropdown!r}")
                return list(dropdown)

            x_axis, x_values = axis_name(args[0]), vals(args[1], args[2], 2)
            y_axis, y_values = axis_name(args[3]), vals(args[4], args[5], 5)
            z_axis, z_values = axis_name(args[6]), vals(args[7], args[8], 8)
            draw_legend = bool(args[9]) if args[9] is not None else True
            include_sub_grids = bool(args[11])
        xs = parse_axis_values(x_axis, x_values)
        ys = parse_axis_values(y_axis, y_values)
        zs = parse_axis_values(z_axis, z_values)
        for axis, parsed, slot, label in ((x_axis, xs, 1, "X values"), (y_axis, ys, 3, "Y values"),
                                          (z_axis, zs, 5, "Z values")):
            self._check_axis_values(axis, parsed, slot, label)
            if axis in UNPORTED_AXES:
                raise NotImplementedError(f"X/Y/Z axis {axis!r} is not ported: "
                                          f"{UNPORTED_AXES[axis]}")
        first_values = {x_axis: xs, y_axis: ys, z_axis: zs}

        def apply(q, axis, val):
            if val is None:
                return
            if axis in OPTS_AXES:
                # an option, read by the cell through its override_settings
                q.override_settings[OPTS_AXES[axis]] = _coerce(val)
                return
            fn = AXIS_OPTIONS.get(axis)
            if fn is None:
                return
            if fn == "prompt_sr":
                token = str(first_values[axis][0])
                q.prompt = q.prompt.replace(token, str(val))
                q.negative_prompt = q.negative_prompt.replace(token, str(val))
            elif fn == "prompt_order":
                # the prompt's comma-separated parts, `val`'s first
                parts = [s.strip() for s in str(val).split(";")]
                rest_parts = [s.strip() for s in q.prompt.split(",") if s.strip() not in parts]
                q.prompt = ", ".join(parts + rest_parts)
            elif fn == "size":
                # the reference's apply_size (scripts/xyz_grid.py:283): "WxH"
                w, _, h = str(val).lower().partition("x")
                q.width, q.height = int(w), int(h)
            else:
                fn(q, _coerce(val))

        # the reference's grid size guard (xyz_grid.py:635)
        grid_mp = round(len(xs) * len(ys) * len(zs) * p.width * p.height / 1_000_000)
        max_mp = float(opts.get("img_max_size_mp", 200) or 200)
        if grid_mp >= max_mp:
            raise ValueError(f"Error: Resulting grid would be too large ({grid_mp} MPixels) "
                             f"(max configured size is {int(max_mp)} MPixels)")

        all_images, infotexts, cell_rows = [], [], []
        first = None
        for zv in zs:
            rows = []
            for yv in ys:
                row_imgs = []
                for xv in xs:
                    q = _clone(p)
                    for axis, val in ((x_axis, xv), (y_axis, yv), (z_axis, zv)):
                        apply(q, axis, val)
                    res = _run_cell(engine, q)
                    if first is None:
                        first = res
                    row_imgs.extend(res.images)
                    all_images.extend(res.images)
                    infotexts.extend(res.infotexts)
                rows.append(row_imgs)
            cell_rows.append(rows)

        # one grid a z value, x labels above and y labels left, then the z
        # grids side by side under their titles (xyz_grid.py:287-395)
        def label(axis, val):
            return "" if axis == "Nothing" else f"{axis}: {val}"

        grids = []
        for rows in cell_rows:
            flat = [im for row in rows for im in row]
            if not flat:
                continue
            grid = image_grid(flat, rows=len(rows))
            if draw_legend:
                w = max(im.shape[1] for im in flat)
                h = max(im.shape[0] for im in flat)
                hor = [[GridAnnotation(label(x_axis, v))] for v in xs]
                ver = [[GridAnnotation(label(y_axis, v))] for v in ys]
                grid = draw_grid_annotations(grid, w, h, hor, ver)
            grids.append(grid)
        if len(grids) > 1:
            z_grid = image_grid(grids, rows=1)
            if draw_legend:
                w = max(g.shape[1] for g in grids)
                h = max(g.shape[0] for g in grids)
                titles = [[GridAnnotation(label(z_axis, v))] for v in zs]
                z_grid = draw_grid_annotations(z_grid, w, h, titles, [[GridAnnotation()]])
            grids = [z_grid] + (grids if include_sub_grids else [])
        return Processed(
            images=grids + all_images, params=p,
            seed=first.seed if first else p.seed,
            subseed=first.subseed if first else p.subseed,
            infotexts=([infotexts[0]] * len(grids) + infotexts) if infotexts else [],
            all_seeds=first.all_seeds if first else [],
            all_subseeds=first.all_subseeds if first else [],
            all_prompts=first.all_prompts if first else [],
            width=p.width, height=p.height)


# ==========================================================================
# Prompt matrix (builtin.py:443-480)
# ==========================================================================

@register_script
class PromptMatrix(Script):
    """Every subset of the prompt's "|"-separated parts, one cell each,
    and the grid under its legend: active parts plain, inactive ones
    struck through (builtin.py:443-480)."""

    name = "Prompt matrix"
    ui_params = [
        _ui("put_at_start", "Put variable parts at start of prompt", "checkbox", False),
    ]

    def run(self, engine, p: GenerationParams, put_at_start=False, *rest):
        parts = [s.strip() for s in p.prompt.split("|")]
        base, variable = parts[0], parts[1:]
        combos = []
        for n in range(2 ** len(variable)):
            selected = [variable[i] for i in range(len(variable)) if n & (1 << i)]
            combos.append(", ".join([*selected, base] if put_at_start else [base, *selected]))
        all_images, infotexts = [], []
        first = None
        for prompt in combos:
            q = _clone(p)
            q.prompt = prompt
            q.do_not_save_grid = True       # the reference's prompt_matrix.py:87
            res = _run_cell(engine, q)
            if first is None:
                first = res
            all_images.extend(res.images)
            infotexts.extend(res.infotexts)
        grid = image_grid(all_images, rows=1 << (len(variable) // 2))
        grid = draw_prompt_matrix(grid, all_images[0].shape[1], all_images[0].shape[0], parts)
        return Processed(images=[grid] + all_images, params=p,
                         seed=first.seed, subseed=first.subseed,
                         infotexts=infotexts[:1] + infotexts,
                         all_seeds=first.all_seeds, all_subseeds=first.all_subseeds,
                         all_prompts=combos, width=p.width, height=p.height)


# ==========================================================================
# Prompts from file (builtin.py:488-519)
# ==========================================================================

@register_script
class PromptsFromFile(Script):
    """Each non-empty line is a bare prompt, as in JAX (the reference also
    parses ``--prompt ... --steps ...`` lines; ROADMAP C)."""

    name = "Prompts from file or textbox"
    ui_params = [
        _ui("checkbox_iterate", "Iterate seed every line", "checkbox", False),
        _ui("checkbox_iterate_batch", "Use same random seed for all lines", "checkbox", False),
        _ui("prompt_txt", "List of prompt inputs", "textarea", ""),
    ]

    def run(self, engine, p: GenerationParams, checkbox_iterate=False,
            checkbox_iterate_batch=False, prompt_txt="", *rest):
        if checkbox_iterate_batch:
            raise NotImplementedError(
                "'Use same random seed for all lines' is not ported (the JAX package never "
                "reads it)")
        lines = [line.strip() for line in str(prompt_txt).splitlines() if line.strip()]
        all_images, infotexts = [], []
        first = None
        for line in lines:
            q = _clone(p)
            q.prompt = line
            q.do_not_save_grid = True       # the reference's prompts_from_file.py:133
            res = _run_cell(engine, q)
            if first is None:
                first = res
            if checkbox_iterate:
                p.seed = res.all_seeds[-1] + 1 if res.all_seeds else p.seed
            all_images.extend(res.images)
            infotexts.extend(res.infotexts)
        return Processed(images=all_images, params=p,
                         seed=first.seed if first else p.seed,
                         subseed=first.subseed if first else p.subseed,
                         infotexts=infotexts,
                         all_seeds=first.all_seeds if first else [],
                         all_subseeds=first.all_subseeds if first else [],
                         all_prompts=lines, width=p.width, height=p.height)


# ==========================================================================
# Loopback (builtin.py:527-566)
# ==========================================================================

@register_script
class Loopback(Script):
    name = "Loopback"
    ui_params = [
        _ui("loops", "Loops", "number", 4),
        _ui("final_denoising_strength", "Final denoising strength", "number", 0.5),
        _ui("denoising_curve", "Denoising strength curve", "select", "Linear",
            ["Aggressive", "Linear", "Lazy"]),
    ]

    def run(self, engine, p: GenerationParams, loops=4, final_denoising_strength=0.5,
            denoising_curve="Linear", *rest):
        loops = int(loops)
        strength = p.denoising_strength or 0.75
        final = float(final_denoising_strength)
        images, infotexts = [], []
        first = None
        current = p.init_images
        for i in range(loops):
            q = _clone(p)
            q.init_images = current
            ratio = (i + 1) / loops if loops > 1 else 1.0
            if denoising_curve == "Aggressive":
                ratio = np.sin(ratio * np.pi / 2)
            elif denoising_curve == "Lazy":
                ratio = 1 - np.cos(ratio * np.pi / 2)
            q.denoising_strength = strength + (final - strength) * ratio
            q.do_not_save_grid = True       # the reference's loopback.py:81
            res = engine.img2img_inner(q)
            if first is None:
                first = res
            current = [res.images[0]]
            images.append(res.images[0])
            infotexts.extend(res.infotexts)
        return Processed(images=images, params=p, seed=first.seed, subseed=first.subseed,
                         infotexts=infotexts, all_seeds=first.all_seeds,
                         all_subseeds=first.all_subseeds, all_prompts=first.all_prompts,
                         width=p.width, height=p.height)


# ==========================================================================
# SD upscale (builtin.py:575-627): img2img over the tiles of an upscale
# ==========================================================================

@register_script
class SDUpscale(Script):
    name = "SD upscale"
    ui_params = [
        _ui("tile_overlap", "Tile overlap", "number", 64),
        _ui("upscaler_name", "Upscaler", "select", "Lanczos", "upscalers"),
        _ui("scale_factor", "Scale factor", "number", 2.0),
    ]

    def run(self, engine, p: GenerationParams, tile_overlap=64, upscaler_name="Lanczos",
            scale_factor=2.0, *rest):
        if not p.init_images:
            raise ValueError("SD upscale needs an init image")
        upscaled = upscale(upscaler_name, images_util.to_rgb(p.init_images[0]),
                           float(scale_factor))
        grid = images_util.split_grid(upscaled, p.width, p.height, int(tile_overlap))
        # the tiles run in batches of p.batch_size (the reference's
        # sd_upscale.py:60-84): edge tiles overlap, so every tile is
        # p.width x p.height and a batch is one UNet call a step
        slots = [(y_i, idx) for y_i, (_, _, row) in enumerate(grid.tiles)
                 for idx in range(len(row))]
        tiles = [grid.tiles[y_i][2][idx][2] for y_i, idx in slots]
        first = None
        infotexts, outs = [], []
        bs = max(int(p.batch_size or 1), 1)
        for lo in range(0, len(tiles), bs):
            chunk = tiles[lo: lo + bs]
            q = _clone(p)
            q.init_images = list(chunk)
            q.batch_size = len(chunk)
            q.n_iter = 1
            q.width, q.height = chunk[0].shape[1], chunk[0].shape[0]
            q.do_not_save_grid = True       # the reference's sd_upscale.py:54
            res = engine.img2img_inner(q)
            if first is None:
                first = res
            outs.extend(res.images[res.index_of_first_image:]
                        if res.index_of_first_image else res.images)
            infotexts.extend(res.infotexts)
        for (y_i, idx), img in zip(slots, outs):
            x, w, _ = grid.tiles[y_i][2][idx]
            grid.tiles[y_i][2][idx] = [x, w, img]
        combined = images_util.combine_grid(grid)
        return Processed(images=[combined], params=p, seed=first.seed, subseed=first.subseed,
                         infotexts=infotexts[:1], all_seeds=first.all_seeds,
                         all_subseeds=first.all_subseeds, all_prompts=first.all_prompts,
                         width=combined.shape[1], height=combined.shape[0])


# ==========================================================================
# Outpainting (builtin.py:634-728)
# ==========================================================================

def _expand_canvas(image, pixels, directions, device):
    """(canvas, mask, (left, up)): the image on a larger canvas whose new
    border (mask 255) holds the colours around it (``masking.fill`` on
    `device`)."""
    left = pixels if "left" in directions else 0
    right = pixels if "right" in directions else 0
    up = pixels if "up" in directions else 0
    down = pixels if "down" in directions else 0
    h, w = image.shape[0] + up + down, image.shape[1] + left + right
    canvas = images_util.paste(np.zeros((h, w, 3), np.uint8), image, (left, up))
    mask = images_util.paste(np.full((h, w), 255, np.uint8),
                             np.zeros(image.shape[:2], np.uint8), (left, up))
    filled = masking.fill(canvas, mask, device)
    return images_util.composite(filled, canvas, mask), mask, (left, up)


@register_script
class PoorMansOutpainting(Script):
    name = "Poor man's outpainting"
    ui_params = [
        _ui("pixels", "Pixels to expand", "number", 64),
        _ui("mask_blur", "Mask blur", "number", 4),
        _ui("inpainting_fill", "Masked content (0 fill/1 original/2 noise/3 nothing)",
            "number", 1),
        _ui("direction", "Outpainting direction (comma separated)", "text",
            "left, right, up, down"),
    ]

    def run(self, engine, p: GenerationParams, pixels=64, mask_blur=4, inpainting_fill=1,
            direction=("left", "right", "up", "down"), *rest):
        if not p.init_images:
            raise ValueError("outpainting needs an init image")
        canvas, mask, _ = _expand_canvas(images_util.to_rgb(p.init_images[0]), int(pixels),
                                         direction, engine.sd_model.device)
        q = _clone(p)
        q.init_images = [canvas]
        q.mask = mask
        q.mask_blur = int(mask_blur)
        q.inpainting_fill = int(inpainting_fill)
        q.inpaint_full_res = False
        q.width, q.height = canvas.shape[1], canvas.shape[0]
        q.denoising_strength = p.denoising_strength or 0.8
        return engine.img2img_inner(q)


@register_script
class OutpaintingMk2(Script):
    name = "Outpainting mk2"
    ui_params = [
        _ui("pixels", "Pixels to expand", "number", 128),
        _ui("mask_blur", "Mask blur", "number", 8),
        _ui("direction", "Outpainting direction (comma separated)", "text",
            "left, right, up, down"),
        _ui("noise_q", "Fall-off exponent (lower=higher detail)", "number", 1.0),
        _ui("color_variation", "Color variation", "number", 0.05),
    ]

    def run(self, engine, p: GenerationParams, pixels=128, mask_blur=8,
            direction=("left", "right", "up", "down"), noise_q=1.0, color_variation=0.05,
            *rest):
        """The new border is filled with noise shaped by the source's
        spectrum and matched to its histogram before the inpainting pass
        (``postprocessing/noise_match``)."""
        if not p.init_images:
            raise ValueError("outpainting needs an init image")
        canvas, mask, _ = _expand_canvas(images_util.to_rgb(p.init_images[0]), int(pixels),
                                         direction, engine.sd_model.device)
        arr = canvas.astype(np.float32) / 255.0
        m3 = np.repeat(mask.astype(np.float32)[..., None] / 255.0, 3, axis=-1)
        blended = matched_noise(arr, m3, noise_q=float(noise_q),
                                color_variation=float(color_variation))
        canvas = np.clip(blended * 255.0, 0, 255).astype(np.uint8)
        q = _clone(p)
        q.init_images = [canvas]
        q.mask = mask
        q.mask_blur = int(mask_blur)
        q.inpainting_fill = 1
        q.inpaint_full_res = False
        q.width, q.height = canvas.shape[1], canvas.shape[0]
        q.denoising_strength = p.denoising_strength or 0.8
        return engine.img2img_inner(q)


# ==========================================================================
# img2img alternative (builtin.py:732-782)
# ==========================================================================

@register_script
class Img2ImgAlternative(Script):
    """Reverse-Euler reconstruction img2img (the reference's
    scripts/img2imgalt.py): the noise that gives the init image under the
    original prompt (``processing.invert_noise``), denoised with the new
    prompt.  Like JAX's, it sets the request's steps, CFG scale, sampler
    (Euler) and denoising strength (1.0) in place."""

    name = "img2img alternative test"
    ui_params = [
        _ui("original_prompt", "Original prompt"),
        _ui("original_negative_prompt", "Original negative prompt"),
        _ui("override_steps", "Override `Sampling Steps` to the same value as `Decode steps`",
            "checkbox", True),
        _ui("st", "Decode steps", "number", 50),
        _ui("cfg", "Decode CFG scale", "number", 2.0),
    ]

    def run(self, engine, p, original_prompt="", original_negative_prompt="",
            override_steps=True, st=50, cfg=2.0, *rest):
        model = engine.sd_model
        if override_steps:
            p.steps = int(st)
            p.cfg_scale = float(cfg)
        p.sampler_name = "Euler"     # the inversion is Euler's
        with torch.inference_mode():
            image_arr, _ = _prepare_images_and_mask(p, model.device)
            init_latent = encode_first_stage(model, image_arr)
            orig = _clone(p)
            orig.prompt = original_prompt or p.prompt
            orig.negative_prompt = original_negative_prompt or p.negative_prompt
            orig.batch_size = init_latent.shape[0]
            orig.all_prompts = [orig.prompt] * orig.batch_size
            orig.all_negative_prompts = [orig.negative_prompt] * orig.batch_size
            sched = _build_conds(model, orig, p.steps + 1, prompt=orig.prompt)
        sigmas = get_schedule("Automatic", p.steps, model.disc, is_sdxl=model.is_sdxl)
        p.init_noise_override = invert_noise(model, sched, init_latent, sigmas[::-1].copy())
        p.denoising_strength = 1.0
        return engine.img2img_inner(p)


# ==========================================================================
# Custom code (builtin.py:791-839), behind --allow-code
# ==========================================================================

@register_script
class CustomCode(Script):
    name = "Custom code"
    ui_params = [
        _ui("code", "Python code", "textarea", ""),
        _ui("indent_level", "Shift+Enter indent level", "number", 0),
    ]

    def run(self, engine, p: GenerationParams, code="", indent_level=0, *rest):
        if not getattr(engine, "allow_code", False):
            raise PermissionError("Custom code requires the server to run with --allow-code "
                                  "(the reference's scripts/custom_code.py gate)")
        display_data = {"images": None, "seed": None, "info": None}

        def display(imgs, s=None, i=None):
            display_data.update(images=list(imgs), seed=s, info=i)

        module = ModuleType("customcode")
        module.p = p
        module.engine = engine
        module.display = display
        module.GenerationParams = GenerationParams
        module.Processed = Processed
        indent = " " * int(indent_level or 0)
        lines = [indent + line for line in str(code).splitlines()]
        body = "def __webuitemp__():\n" + "\n".join("    " + line for line in lines) \
            + "\n__webuitemp__result__ = __webuitemp__()"
        exec(compile(body, "<custom code>", "exec"), module.__dict__)
        result = module.__dict__.get("__webuitemp__result__")
        if isinstance(result, Processed):
            return result
        if display_data["images"] is None:
            return _run_cell(engine, p)
        imgs = display_data["images"]
        return Processed(images=imgs, params=p,
                         seed=display_data["seed"] if display_data["seed"] is not None
                         else p.seed,
                         subseed=p.subseed, infotexts=[display_data["info"] or ""] * len(imgs),
                         all_seeds=[p.seed], all_subseeds=[p.subseed], all_prompts=[p.prompt],
                         width=p.width, height=p.height)


# ==========================================================================
# The main UI's postprocessing (builtin.py:842-869), always on
# ==========================================================================

@register_script
class MainUIPostprocessing(Script):
    """A request's ``postprocessing`` dict (the Extras stage fields and an
    "enable" list of stages, else opts.postprocessing_enable_in_main_ui)
    runs the named stages over each generated image in the
    postprocess_image hook, after face restoration and before the grid,
    on the device the batch's latents are on."""

    name = "postprocessing (main UI)"
    alwayson = True

    def __init__(self):
        self._device = None

    def post_sample(self, p, ps, *args):
        self._device = ps.samples.device

    def postprocess_image(self, p, image, *args):
        pp = dict(getattr(p, "postprocessing", None) or {})
        if not pp:
            return image
        enabled = set(pp.pop("enable", None)
                      or opts.get("postprocessing_enable_in_main_ui", []) or [])
        if not enabled:
            return image
        out = run_stages(image, StageArgs.from_obj(pp), enabled=enabled, device=self._device)
        p.extra_generation_params.setdefault("Postprocessing", ", ".join(sorted(enabled)))
        return out
