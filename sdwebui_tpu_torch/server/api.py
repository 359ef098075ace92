"""HTTP API: ``/sdapi/v1/txt2img`` (with hires fix), ``/sdapi/v1/img2img``,
the Extras upscale routes, the checkpoint routes and friends on a stdlib
server.

Port of the generation, extras, option and checkpoint routes of
``sdwebui_tpu/server/api.py:133-163,252-347,511-600,895-914``: options
(a ``sd_model_checkpoint`` in a POST reloads), samplers, schedulers,
upscalers, latent upscale modes, sd-models, sd-vae, and refresh / reload /
unload of checkpoints.  ``extra-single-image`` and ``extra-batch-images``
run the stage chain (``postprocessing/stages``: Upscale, GFPGAN,
CodeFormer) and answer one PNG per image, saved under
``outdir_extras_samples`` with ``save_output``; extras resize modes other
than 0 and 1 answer 422, and so does a face restorer without weights.
Job control: ``progress``, ``interrupt``, ``skip`` and
``/internal/{interrupt,progress}`` read and set the Engine's job state
without its queue lock, the live preview as a PNG (or a JPEG or WebP,
with ``live_previews_image_format``).  Saving (``utils/saving``): both
generation routes write their images and grid with ``save_images``;
``/internal/save-images`` writes the posted images with a ``log.csv`` row
and a zip (``server/ui_actions``); ``/internal/img2img-batch`` runs img2img
over a directory of images (api.py:645-745).  Every image field reads
what JAX's Pillow reads but AVIF (``utils/image_io``).  Training and
interrogation (``api.py:349-415,1206-1365``): ``interrogate``
(DeepDanbooru, or the CLIP interrogator with BLIP's caption when BLIP is
there; 501 naming what is absent), ``preprocess``, ``create/embedding``,
``create/hypernetwork``, ``train/embedding`` and ``train/hypernetwork``;
a training run is a job (``progress`` reports its steps, ``interrupt``
stops it after the step in flight).  ``png-info``,
``memory``, ``cmd-flags``, ``refresh-vae``, ``realesrgan-models`` and
``face-restorers`` answer as JAX's (``api.py:437-539,587-592,899,916``).
Requests are plain JSON mapped
onto ``GenerationParams`` (no pydantic); responses have the reference's
shape, ``{"images": [b64 png], "parameters": {...}, "info": "<json>"}``.
Every image a client sends (img2img's ``init_images`` and ``mask``, Extras,
ControlNet, interrogate, png-info) is a base64 image in any format
``utils/image_io`` reads (a ``data:`` URL prefix is accepted), or an
http(s) URL: fetched with opts.api_enable_requests and opts.api_useragent,
and only from a host whose every address is global (``utils/url_fetch``;
JAX fetches any URL); ``parameters`` leaves them out unless
``include_init_images`` is set, as the reference does.  ControlNet units
come as ``controlnet_units`` or as the sd-webui-controlnet extension's
``alwayson_scripts.controlnet.args`` (``api.py:112-119``), their images
encoded as the other image fields.  The extra-network routes
(loras, embeddings, hypernetworks and their refreshes), the prompt-style
routes (GET, POST and DELETE ``/sdapi/v1/prompt-styles``) and the
extension's ``/controlnet/*`` routes are served too.  A request's
``styles`` are applied to its prompts before either route runs.  Both
generation routes run a selectable script (``script_name`` and
``script_args``, ``scripts/builtin``) through ``Engine.run_script``, and
the main UI's ``postprocessing`` stages; ``/sdapi/v1/scripts`` and
``/sdapi/v1/script-info`` list the scripts (api.py:972-999), and a
script_args value a script cannot take answers 400 naming its control.
``GET /`` serves the single-page UI (``server/webui.html``), and the rest
of JAX's route table with it (api.py:293-299,420-435,600-643,813-887,
1000-1201,1387-1397): ``modelmerger`` (``postprocessing/merger``; a
``custom_name`` that is not one path component answers 400),
``/internal/{last-result,options-metadata,ui-config,localization,
save-style,delete-style,token-count,parse-infotext,sysinfo,
sysinfo-download,profile-startup}``, the extra-network cards' previews and
user metadata, the extensions (``extensions.py``) and the server commands
``server-{kill,restart,stop}``, which ``server/__main__`` acts on.
A request field, override or
option the port does not run answers 422 naming it — it is never silently
ignored — and so does a checkpoint name the server does not hold; a LoRA,
hypernetwork, ControlNet model or annotator it does not hold answers 404
naming it.
"""

from __future__ import annotations

import base64
import binascii
import dataclasses
import glob
import json
import os
import platform
import resource
import sys
import threading
import time
import traceback
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from sdwebui_tpu_torch import __version__
from sdwebui_tpu_torch import extensions as ext_mod
from sdwebui_tpu_torch.loader.safetensors_io import read_metadata
from sdwebui_tpu_torch.networks import NetworkNotFound
from sdwebui_tpu_torch.networks.extra_networks import lora_registry
from sdwebui_tpu_torch.networks.hypernetwork import hypernet_registry
from sdwebui_tpu_torch.pipeline import annotators, control
from sdwebui_tpu_torch.pipeline.params import GenerationParams
from sdwebui_tpu_torch.pipeline.processing import LATENT_UPSCALE_MODES
from sdwebui_tpu_torch.postprocessing import faces, upscalers
from sdwebui_tpu_torch.postprocessing.merger import check_output_name, run_modelmerger
from sdwebui_tpu_torch.postprocessing.stages import STAGES, StageArgs
from sdwebui_tpu_torch.sampling.registry import SAMPLER_MAP, SAMPLERS
from sdwebui_tpu_torch.sampling.schedulers import ALIASES, SCHEDULERS
from sdwebui_tpu_torch.scripts.framework import (ScriptArgError, get_script,
                                                 list_alwayson_scripts,
                                                 list_selectable_scripts)
from sdwebui_tpu_torch.server.app import CheckpointNotFound, Engine
from sdwebui_tpu_torch.text.prompt_parser import parse_prompt_attention
from sdwebui_tpu_torch.text.styles import PromptStyle
from sdwebui_tpu_torch.utils import images as images_util
from sdwebui_tpu_torch.utils import infotext, saving, timer, url_fetch, webp
from sdwebui_tpu_torch.utils.image_io import (UnsupportedImageFormat, decode_image,
                                              read_image_file)
from sdwebui_tpu_torch.utils.jpeg import encode_jpeg
from sdwebui_tpu_torch.utils.options import opts
from sdwebui_tpu_torch.utils.png import encode_png

_NUM = (int, float)

#: request fields the slice runs: the reference schema's default and type
FIELDS = {
    "prompt": ("", str), "negative_prompt": ("", str), "seed": (-1, int),
    "subseed": (-1, int), "subseed_strength": (0.0, _NUM),
    "seed_resize_from_h": (-1, int), "seed_resize_from_w": (-1, int),
    "sampler_name": (None, str), "sampler_index": (None, str), "scheduler": (None, str),
    "batch_size": (1, int), "n_iter": (1, int), "steps": (50, int), "cfg_scale": (7.0, _NUM),
    "width": (512, int), "height": (512, int), "eta": (None, _NUM),
    "s_min_uncond": (None, _NUM), "s_churn": (None, _NUM), "s_tmax": (None, _NUM),
    "s_tmin": (None, _NUM), "s_noise": (None, _NUM), "override_settings": ({}, dict),
    "do_not_save_samples": (False, bool), "do_not_save_grid": (False, bool),
    "send_images": (True, bool), "refiner_checkpoint": (None, str),
    "refiner_switch_at": (None, _NUM), "controlnet_units": (None, list),
    "alwayson_scripts": ({}, dict), "styles": ([], list), "tiling": (None, bool),
    "restore_faces": (None, bool),
    # a selectable script and its arguments (scripts/builtin), and the main
    # UI's postprocessing stages (the always-on MainUIPostprocessing)
    "script_name": (None, str), "script_args": ([], list), "postprocessing": ({}, dict),
    # write the images and the grid under the Engine's outdir
    "save_images": (False, bool),
}

#: fields of the reference schema outside the slice: accepted only at
#: these values (their defaults)
NEUTRAL = {
    "disable_extra_networks": (False,), "comments": ({},),
    "firstphase_width": (0,), "firstphase_height": (0,), "hr_checkpoint_name": (None,),
    "infotext": (None,),
    "override_settings_restore_afterwards": (True,),
}

#: txt2img's hires-fix fields (``hr_cfg`` is GenerationParams.hr_cfg_scale)
HIRES_FIELDS = {
    "enable_hr": (False, bool), "denoising_strength": (None, _NUM), "hr_scale": (2.0, _NUM),
    "hr_upscaler": (None, str), "hr_second_pass_steps": (0, int), "hr_resize_x": (0, int),
    "hr_resize_y": (0, int), "hr_sampler_name": (None, str), "hr_scheduler": (None, str),
    "hr_prompt": ("", str), "hr_negative_prompt": ("", str), "hr_cfg": (0.0, _NUM),
}

#: the hires fields img2img accepts, at their defaults only
HIRES_NEUTRAL = {k: (default,) for k, (default, _) in HIRES_FIELDS.items()
                 if k != "denoising_strength"}

#: the saving options (utils/saving, the pipelines' save stages)
SAVING_OPTIONS = {
    "samples_save", "samples_format", "grid_save", "grid_format", "grid_extended_filename",
    "enable_pnginfo", "outdir_samples", "outdir_grids", "outdir_txt2img_samples",
    "outdir_img2img_samples", "outdir_txt2img_grids", "outdir_img2img_grids",
    "save_incomplete_images", "samples_filename_pattern", "save_images_add_number",
    "save_images_replace_action", "save_to_dirs", "grid_save_to_dirs",
    "directories_filename_pattern", "directories_max_prompt_words", "jpeg_quality",
    "webp_lossless", "export_for_4chan", "img_downscale_threshold", "target_side_length", "save_txt",
    "save_images_before_face_restoration", "save_images_before_highres_fix",
    "sdtpu_async_save", "sdtpu_png_compress_level",
}

#: override_settings keys the slice reads
OVERRIDES = SAVING_OPTIONS | {
    "CLIP_stop_at_last_layers", "eta_noise_seed_delta", "randn_source",
    "enable_quantization", "emphasis", "enable_emphasis", "comma_padding_backtrack",
    "sdtpu_vae_bf16", "auto_vae_precision", "eta_ancestral", "s_min_uncond",
    "s_min_uncond_all", "skip_early_cond", "use_old_scheduling",
    "enable_prompt_comments", "return_grid", "n_rows", "grid_background_color",
    # the grid legends' font and colours (utils/grid_annotations)
    "font", "grid_text_active_color", "grid_text_inactive_color",
    "grid_only_if_multiple", "grid_prevent_empty_spots", "add_model_hash_to_info",
    "add_model_name_to_info", "add_version_to_infotext", "add_user_name_to_info",
    "cross_attention_optimization", "sdxl_clip_l_skip", "sdxl_crop_top",
    "sdxl_crop_left", "sdxl_refiner_high_aesthetic_score",
    "sdxl_refiner_low_aesthetic_score", "refiner_switch_by_sample_steps",
    # the samplers' settings (processing._solver_extra, registry.build_sigmas)
    "eta_ddim", "s_churn", "s_tmin", "s_tmax", "sigma_min", "sigma_max", "rho",
    "always_discard_next_to_last_sigma", "use_old_karras_scheduler_sigmas",
    "ddim_discretize", "uni_pc_order", "uni_pc_variant", "uni_pc_skip_type",
    "uni_pc_lower_order_final",
    # per-request checkpoint and VAE (Engine._maybe_switch)
    "sd_model_checkpoint", "sd_vae",
    # hires fix and the upscalers it runs
    "hires_fix_use_firstpass_conds", "hires_fix_refiner_pass",
    "use_old_hires_fix_width_height", "img2img_extra_noise", "ESRGAN_tile",
    "ESRGAN_tile_overlap", "upscaling_max_images_in_cache",
    # the zoo's own: DAT's tiles and LDSR's steps (SwinIR, Swin2SR and HAT
    # read ESRGAN_tile, SCUNet fixes 256 / 8, as the JAX package does)
    "DAT_tile", "DAT_tile_overlap", "ldsr_steps",
    # extra networks
    "sd_hypernetwork", "extra_networks_default_multiplier",
    "textual_inversion_add_hashes_to_infotext",
    # TAESD for the VAE's encode and decode, the preview decode of an
    # interrupted job (processing._taesd_for, _fast_interrupt_method)
    "sd_vae_encode_method", "sd_vae_decode_method", "live_preview_fast_interrupt",
    "show_progress_type",
    # live previews (Engine._step_callback) and face restoration
    "live_previews_enable", "show_progress_every_n_steps", "show_progress_grid",
    "face_restoration_model", "code_former_weight",
    # the UNet's attention options, fp8 storage, the schedule overrides,
    # old emphasis and the cond cache (processing.apply_attention_options,
    # apply_schedule_overrides, Engine._apply_fp8_storage, _build_conds);
    # sd_unet names a provider of the list_unets channel (pipeline/sd_unet)
    "hypertile_enable_unet", "hypertile_max_tile_unet", "token_merging_ratio",
    "token_merging_ratio_hr", "token_merging_ratio_img2img", "upcast_attn", "fp8_storage",
    "cache_fp16_weight", "sgm_noise_multiplier", "sd_noise_schedule",
    "use_downcasted_alpha_bar", "use_old_emphasis_implementation", "persistent_cond_cache",
    "sd_unet",
    # the scripts: X/Y/Z's grid size guard, the main UI's postprocessing stages
    "img_max_size_mp", "postprocessing_enable_in_main_ui",
    # a generation under torch.profiler (utils/profiling)
    "profiling_enable", "profiling_activities", "profiling_record_shapes",
    "profiling_profile_memory", "profiling_with_stack", "profiling_filename",
}


#: img2img request fields beyond txt2img's: the reference schema's default
#: and type (Img2ImgRequest: the mask applies inpaint_full_res and
#: inpainting_fill only when a mask is given)
IMG2IMG_FIELDS = {
    "init_images": (None, list), "mask": (None, str), "mask_blur": (None, int),
    "denoising_strength": (0.75, _NUM), "inpainting_fill": (0, int),
    "inpaint_full_res": (True, bool), "inpaint_full_res_padding": (0, int),
    "inpainting_mask_invert": (0, int), "resize_mode": (0, int),
    "initial_noise_multiplier": (None, _NUM), "include_init_images": (False, bool),
    "image_cfg_scale": (None, _NUM),
    # soft inpainting: GenerationParams fields that JAX's request model
    # passes through (extra="allow")
    "soft_inpainting": (False, bool), "mask_blend_power": (1.0, _NUM),
    "mask_blend_scale": (0.5, _NUM), "inpaint_detail_preservation": (4.0, _NUM),
}

#: img2img fields of the reference schema accepted only at these values
IMG2IMG_NEUTRAL = {
    "mask_blur_x": (4,), "mask_blur_y": (4,),
    "mask_round": (True,), "latent_mask": (None,),
}

IMG2IMG_OVERRIDES = {"img2img_extra_noise", "img2img_background_color", "overlay_inpaint",
                     "upscaler_for_img2img", "img2img_color_correction", "save_init_img",
                     "outdir_init_images", "return_mask", "return_mask_composite",
                     "save_images_before_color_correction", "save_mask", "save_mask_composite"}

#: options POST /sdapi/v1/options sets: the overrides, how checkpoints are
#: kept and read, and the Extras stage order
OPTIONS = OVERRIDES | IMG2IMG_OVERRIDES | {
    "sd_checkpoints_limit", "sd_checkpoints_keep_in_cpu", "sd_checkpoint_cache",
    "sd_vae_checkpoint_cache", "sd_vae_overrides_per_model_preferences",
    "list_hidden_files", "disable_mmap_load_safetensors", "postprocessing_operation_order",
    "postprocessing_disable_in_extras", "realesrgan_enabled_models", "dat_enabled_models",
    "live_previews_image_format", "interrupt_after_current",
    # Extras' save_output, the Save button, the img2img batch
    "outdir_extras_samples", "use_original_name_batch", "use_upscaler_name_as_suffix",
    "outdir_save", "save_selected_only", "save_write_log_csv", "use_save_to_dirs_for_ui",
    "grid_zip_filename_pattern", "img2img_batch_show_results_limit",
    # read by the loader at the next checkpoint load: SD3's bundled T5-XXL
    "sd3_enable_t5",
    # training and interrogation (training/*, postprocessing/interrogate,
    # models/deepbooru)
    "training_xattention_optimizations", "unload_models_when_training",
    "save_optimizer_state", "save_training_settings_to_txt", "training_write_csv_every",
    "training_image_repeats_per_epoch", "dataset_filename_word_regex",
    "dataset_filename_join_string", "interrogate_keep_models_in_memory",
    "interrogate_deepbooru_score_threshold", "deepbooru_sort_alpha", "deepbooru_use_spaces",
    "deepbooru_escape", "deepbooru_filter_tags", "interrogate_return_ranks",
    "interrogate_clip_num_beams", "interrogate_clip_min_length", "interrogate_clip_max_length",
    "interrogate_clip_dict_limit", "interrogate_clip_skip_categories",
    # image URLs in request fields, the UI's token counter, infotext paste
    # and localization, extensions
    "api_enable_requests", "api_useragent", "include_styles_into_token_counters",
    "infotext_styles", "infotext_skip_pasting", "disable_weights_auto_swap", "localization",
    "disabled_extensions", "disable_all_extensions", "enable_extension_scripts",
    "restore_config_state_file", "multiple_tqdm", "extra_networks_hidden_models"}

#: the training routes' request fields: the ones JAX's handlers read
#: (api.py:1206-1365); another field answers 422
PREPROCESS_FIELDS = {"process_src", "input_dir", "process_dst", "output_dir", "process_width",
                     "process_height", "process_split", "process_split_threshold",
                     "process_overlap_ratio", "process_flip", "process_focal_crop",
                     "process_multicrop", "process_caption_deepbooru",
                     "existing_caption_action"}
CREATE_EMBEDDING_FIELDS = {"name", "num_vectors_per_token"}
CREATE_HYPERNETWORK_FIELDS = {"name", "enable_sizes", "layer_structure", "weight_init",
                              "add_layer_norm", "activation_func"}
_DATASET_FIELDS = {"data_root", "steps", "learn_rate", "batch_size", "template_filename",
                   "template", "training_width", "training_height", "varsize", "use_weight",
                   "shuffle_tags", "tag_drop_out", "latent_sampling_method",
                   "create_image_every", "preview_prompt"}
TRAIN_EMBEDDING_FIELDS = _DATASET_FIELDS | {"embedding_name", "placeholder",
                                            "num_vectors_per_token", "save_embedding_every"}
TRAIN_HYPERNETWORK_FIELDS = _DATASET_FIELDS | {
    "hypernetwork_name", "layer_structure", "activation_func", "weight_init", "add_layer_norm",
    "use_dropout", "last_layer_dropout", "dropout_structure", "save_hypernetwork_every"}

#: where interrogate and preprocess find their files unless the caller
#: says otherwise (the reference's layout, relative to the working directory)
INTERROGATE_DIRS = {"deepbooru": os.path.join("models", "torch_deepdanbooru"),
                    "clip": os.path.join("models", "clip_vision"),
                    "categories": "interrogate", "blip": os.path.join("models", "BLIP")}

#: the Extras request's fields (ExtrasSingleImageRequest; ``name`` is a
#: batch item's file name)
EXTRAS_FIELDS = {
    **{f.name: (f.default, bool if isinstance(f.default, bool) else
                _NUM if isinstance(f.default, float) else type(f.default))
       for f in StageArgs.__dataclass_fields__.values()},
    "show_extras_results": (True, bool), "save_output": (False, bool), "image": ("", str),
    "name": (None, str),
}

#: a ControlNet unit's fields (ControlNetUnit, and the extension's
#: ``input_image``), and the extension's fields accepted at these values
UNIT_FIELDS = {f.name for f in dataclasses.fields(control.ControlNetUnit)} | {"input_image"}
UNIT_NEUTRAL = {"lowvram": (False,), "pixel_perfect": (False,), "guessmode": (False,),
                "mask": (None,), "resize_mode": (0, "Just Resize")}

class ApiError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


class RawResponse:
    """A handler's answer that is not JSON: the page, an image, a download."""

    def __init__(self, body, content_type: str, headers: dict | None = None):
        self.body = body.encode("utf-8") if isinstance(body, str) else body
        self.content_type = content_type
        self.headers = headers or {}


def _check_fields(body: dict, fields: dict, neutral: dict) -> dict:
    """The request with every field of `fields` (its default when absent),
    each of its type; a field outside both answers 422."""
    for key, value in body.items():
        if key in fields:
            continue
        if key in neutral:
            if value not in neutral[key]:
                raise ApiError(422, f"field {key!r} is not supported by this server yet")
            continue
        raise ApiError(422, f"unknown or unsupported field {key!r}")
    req = {key: default for key, (default, _) in fields.items()}
    req.update(body)
    for key, (_, typ) in fields.items():
        value = req[key]
        if value is not None and (not isinstance(value, typ)
                                  or isinstance(value, bool) and typ is not bool):
            raise ApiError(422, f"field {key!r} has the wrong type")
    return req


def _check_upscaler(name, field: str, latent: bool = False):
    """An upscaler the registry holds (or, with latent, a latent upscale
    mode); another name answers 422 naming it."""
    if latent and name in LATENT_UPSCALE_MODES:
        return
    try:
        upscalers.get_upscaler(name)
    except upscalers.UpscalerNotFound as e:
        raise ApiError(422, f"{field}: {e}") from e


def _units_from_request(req: dict) -> list:
    """The request's ControlNet units (``controlnet_units`` and the
    extension's ``alwayson_scripts``), checked, their images decoded."""
    units = list(req.get("controlnet_units") or [])
    for name, script in (req.get("alwayson_scripts") or {}).items():
        if name not in ("controlnet", "ControlNet"):
            raise ApiError(422, f"alwayson_scripts {name!r} is not supported by this server yet")
        if not isinstance(script, dict) or not isinstance(script.get("args", []), list):
            raise ApiError(422, "alwayson_scripts.controlnet must be {\"args\": [units]}")
        units += script.get("args") or []
    out = []
    for i, unit in enumerate(units):
        if not isinstance(unit, dict):
            raise ApiError(422, f"ControlNet unit {i} must be an object")
        for key, value in unit.items():
            if key not in UNIT_FIELDS and value not in UNIT_NEUTRAL.get(key, ()):
                raise ApiError(422, f"ControlNet unit field {key!r}={value!r} is not supported "
                                    "by this server yet")
        unit = {k: v for k, v in unit.items() if k in UNIT_FIELDS}
        for key in ("image", "input_image"):
            if unit.get(key) is not None:
                unit[key] = _decode_image(unit[key], f"ControlNet unit {i} {key}")
        out.append(unit)
    return out


def _params_from_request(body: dict, img2img: bool = False,
                         init_images: list | None = None) -> GenerationParams:
    """The request's GenerationParams; init_images: img2img's (pixels, info)
    already decoded (the batch route's files), else ``init_images`` is read
    from the body.  The init images' decoded info goes to
    p.init_images_info (save_init_img writes it, as JAX's PIL images carry
    theirs)."""
    fields, neutral, overrides = {**FIELDS, **HIRES_FIELDS}, NEUTRAL, OVERRIDES
    if img2img:
        fields = {**FIELDS, **IMG2IMG_FIELDS}
        neutral = {**{k: v for k, v in NEUTRAL.items() if k not in fields}, **HIRES_NEUTRAL,
                   **IMG2IMG_NEUTRAL}
        overrides = OVERRIDES | IMG2IMG_OVERRIDES
    req = _check_fields(body, fields, neutral)
    req["override_settings"] = dict(req["override_settings"] or {})
    for key in req["override_settings"]:
        if key not in overrides:
            raise ApiError(422, f"override_settings key {key!r} is not supported yet")
    sampler = req["sampler_name"] or req["sampler_index"] or "Euler a"
    if sampler != "Automatic" and sampler not in SAMPLER_MAP:
        raise ApiError(400, "Sampler not found")
    scheduler = req["scheduler"] or "Automatic"
    if ALIASES.get(scheduler, scheduler.lower()) not in SCHEDULERS:
        raise ApiError(422, f"scheduler {scheduler!r} is unknown or not ported yet")
    if req["steps"] < 1:
        raise ApiError(400, f"steps must be >= 1, got {req['steps']}")
    if req["width"] < 8 or req["height"] < 8:
        raise ApiError(400, f"invalid image size {req['width']}x{req['height']}")
    if req["batch_size"] < 1 or req["n_iter"] < 1:
        raise ApiError(400, "batch_size and n_iter must be >= 1")
    if not img2img:     # the hires pass's sampler, scheduler and upscaler (api.py:227-231)
        if req["hr_sampler_name"] and req["hr_sampler_name"] != "Automatic" \
                and req["hr_sampler_name"] not in SAMPLER_MAP:
            raise ApiError(400, "Sampler not found")
        hr_scheduler = req["hr_scheduler"]
        if hr_scheduler and ALIASES.get(hr_scheduler, hr_scheduler.lower()) not in SCHEDULERS:
            raise ApiError(400, f"Scheduler not found: {hr_scheduler!r}")
        if req["enable_hr"] and req["hr_upscaler"]:
            _check_upscaler(req["hr_upscaler"], "hr_upscaler", latent=True)
    gp_fields = set(GenerationParams.__dataclass_fields__)
    kw = {k: v for k, v in req.items() if k in gp_fields and v is not None}
    kw["sampler_name"] = sampler
    kw["scheduler"] = scheduler
    if req.get("hr_cfg"):
        kw["hr_cfg_scale"] = req["hr_cfg"]
    if "CLIP_stop_at_last_layers" in req["override_settings"]:
        kw["clip_skip"] = int(req["override_settings"]["CLIP_stop_at_last_layers"])
    kw["controlnet_units"] = _units_from_request(req)
    kw["postprocessing"] = _check_postprocessing(req["postprocessing"] or {})
    if not req["script_name"] and not req["save_images"]:
        # nothing is written, so no grid is assembled (JAX's
        # _apply_save_flags).  JAX's run_script leaves do_not_save_grid as
        # the request has it, so a script's cells of several images get
        # their grid (app.py:395-409)
        kw["do_not_save_grid"] = True
    decoded = []
    if img2img:
        if init_images is None and not req["init_images"]:
            raise ApiError(404, "Init image not found")
        decoded = init_images if init_images is not None else \
            [_decode_with_info(x, "init_images") for x in req["init_images"]]
        kw["init_images"] = [pixels for pixels, _ in decoded]
        if req["mask"]:
            kw["mask"] = _decode_image(req["mask"], "mask")
        else:
            kw.pop("mask", None)
    p = GenerationParams(**kw)
    p.init_images_info = [info for _, info in decoded]
    return p


def _check_postprocessing(pp: dict) -> dict:
    """The main UI's ``postprocessing`` field: the Extras stage fields and
    an "enable" list of stage names; another key, stage or upscaler
    answers 422 naming it."""
    unknown = sorted(set(pp) - set(StageArgs.__dataclass_fields__) - {"enable"})
    if unknown:
        raise ApiError(422, f"postprocessing fields {unknown} are not supported")
    enable = pp.get("enable") or []
    if not isinstance(enable, list) or not set(enable) <= set(STAGES):
        raise ApiError(422, f"postprocessing 'enable' must list stages of {sorted(STAGES)}, "
                            f"got {enable!r}")
    for field in ("upscaler_1", "upscaler_2"):
        if pp.get(field) not in (None, "", "None"):
            _check_upscaler(pp[field], f"postprocessing {field}")
    return dict(pp)


def _decode_image(encoding, field: str):
    """A base64 image (optionally a data: URL) → uint8 (H, W, C)."""
    return _decode_with_info(encoding, field)[0]


def _decode_with_info(encoding, field: str):
    """A base64 image (optionally a data: URL) in any format the port reads
    (``utils/image_io``) → (uint8 (H, W, C), its Pillow ``img.info``)."""
    if not isinstance(encoding, str):
        raise ApiError(422, f"field {field!r} must hold base64 strings")
    if encoding.startswith(("http://", "https://")):
        data = _fetch_image(encoding, field)
    else:
        if encoding.startswith("data:"):
            encoding = encoding.split(",", 1)[-1]
        try:
            data = base64.b64decode(encoding, validate=True)
        except (binascii.Error, ValueError) as e:
            raise ApiError(400, f"field {field!r} is not valid base64: {e}") from e
    try:
        return decode_image(data)
    except UnsupportedImageFormat as e:
        raise ApiError(400, f"field {field!r} holds a {e.fmt} image, which this server does "
                            "not read") from e
    except ValueError as e:
        raise ApiError(400, f"field {field!r}: {e}") from e


def _fetch_image(url: str, field: str) -> bytes:
    """An image URL's bytes (app.py:478-492): only with
    opts.api_enable_requests, with opts.api_useragent, and only from a host
    whose every address is global (``utils/url_fetch``; JAX fetches any)."""
    if not opts.get("api_enable_requests", True):
        raise ApiError(400, f"field {field!r}: requests not allowed (api_enable_requests is off)")
    try:
        return url_fetch.fetch(url, useragent=str(opts.get("api_useragent", "") or ""))
    except url_fetch.URLRefused as e:
        raise ApiError(400, f"field {field!r}: {e}") from e


class Api:
    """The routes over one Engine.  flags: the server's command-line flags
    (``/cmd-flags``); realesrgan: the upscaler names registered from the
    Real-ESRGAN directory (``/realesrgan-models``)."""

    def __init__(self, engine: Engine, flags: dict | None = None, realesrgan=(),
                 interrogate_dirs: dict | None = None):
        self.engine = engine
        self.flags = dict(flags or {})
        #: deepbooru, clip, categories and blip directories (INTERROGATE_DIRS)
        self.interrogate_dirs = {**INTERROGATE_DIRS, **(interrogate_dirs or {})}
        self._interrogators: dict = {}
        self.realesrgan = tuple(realesrgan)
        self._preview_lock = threading.Lock()
        self._previews = {}                # format → (the preview image, its base64 file)
        self.routes = {
            ("POST", "/sdapi/v1/txt2img"): self.txt2img,
            ("POST", "/sdapi/v1/img2img"): self.img2img,
            ("GET", "/sdapi/v1/options"): self.get_options,
            ("POST", "/sdapi/v1/options"): self.set_options,
            ("GET", "/sdapi/v1/samplers"): self.samplers,
            ("GET", "/sdapi/v1/schedulers"): self.schedulers,
            ("GET", "/sdapi/v1/upscalers"): self.upscalers,
            ("GET", "/sdapi/v1/latent-upscale-modes"): self.latent_upscale_modes,
            ("POST", "/sdapi/v1/extra-single-image"): self.extras_single,
            ("POST", "/sdapi/v1/extra-batch-images"): self.extras_batch,
            ("GET", "/sdapi/v1/sd-models"): self.sd_models,
            ("GET", "/sdapi/v1/sd-vae"): self.sd_vaes,
            ("POST", "/sdapi/v1/refresh-checkpoints"): self.refresh_checkpoints,
            ("POST", "/sdapi/v1/reload-checkpoint"): self.reload_checkpoint,
            ("POST", "/sdapi/v1/unload-checkpoint"): self.unload_checkpoint,
            ("GET", "/sdapi/v1/loras"): self.loras,
            ("POST", "/sdapi/v1/refresh-loras"): self.refresh_loras,
            ("GET", "/sdapi/v1/embeddings"): self.embeddings,
            ("POST", "/sdapi/v1/refresh-embeddings"): self.refresh_embeddings,
            ("GET", "/sdapi/v1/hypernetworks"): self.hypernetworks,
            ("GET", "/sdapi/v1/prompt-styles"): self.prompt_styles,
            ("POST", "/sdapi/v1/prompt-styles"): self.save_style,
            ("DELETE", "/sdapi/v1/prompt-styles"): self.delete_style,
            ("GET", "/controlnet/model_list"): self.controlnet_models,
            ("GET", "/controlnet/module_list"): self.controlnet_modules,
            ("POST", "/controlnet/detect"): self.controlnet_detect,
            ("GET", "/controlnet/version"): lambda body: {"version": 2},
            ("GET", "/internal/ping"): lambda body: {},
            # job control (api.py:437-539)
            ("GET", "/sdapi/v1/progress"): self.progress,
            ("POST", "/sdapi/v1/interrupt"): self.interrupt,
            ("POST", "/sdapi/v1/skip"): self.skip,
            ("POST", "/internal/interrupt"): self.interrupt_ui,
            ("GET", "/internal/progress"): self.internal_progress,
            ("POST", "/internal/progress"): self.internal_progress,
            ("POST", "/sdapi/v1/png-info"): self.png_info,
            ("GET", "/sdapi/v1/scripts"): self.scripts,
            ("GET", "/sdapi/v1/script-info"): self.script_info,
            ("GET", "/sdapi/v1/memory"): self.memory,
            ("GET", "/sdapi/v1/cmd-flags"): self.cmd_flags,
            ("POST", "/sdapi/v1/refresh-vae"): lambda body: {},
            ("GET", "/sdapi/v1/realesrgan-models"): self.realesrgan_models,
            ("GET", "/sdapi/v1/face-restorers"): self.face_restorers,
            # training and interrogation (api.py:349-415,1206-1365)
            ("POST", "/sdapi/v1/interrogate"): self.interrogate,
            ("POST", "/sdapi/v1/preprocess"): self.preprocess,
            ("POST", "/sdapi/v1/create/embedding"): self.create_embedding,
            ("POST", "/sdapi/v1/create/hypernetwork"): self.create_hypernetwork,
            ("POST", "/sdapi/v1/train/embedding"): self.train_embedding,
            ("POST", "/sdapi/v1/train/hypernetwork"): self.train_hypernetwork,
            # saving (api.py:645-745)
            ("POST", "/internal/save-images"): self.save_images_action,
            ("POST", "/internal/img2img-batch"): self.img2img_batch,
            # the page and its routes (api.py:293-299,420-435,600-643,813-887,
            # 1000-1201,1376-1397)
            ("GET", "/"): self.index_html,
            ("POST", "/sdapi/v1/modelmerger"): self.modelmerger,
            ("GET", "/internal/last-result"): self.last_result,
            ("GET", "/internal/options-metadata"): self.options_metadata,
            ("GET", "/internal/ui-config"): self.ui_config_get,
            ("POST", "/internal/ui-config"): self.ui_config_set,
            ("GET", "/internal/localization"): self.localization,
            ("POST", "/internal/save-style"): self.save_style,
            ("POST", "/internal/delete-style"): self.delete_style,
            ("POST", "/internal/token-count"): self.token_count,
            ("POST", "/internal/parse-infotext"): self.parse_infotext,
            ("GET", "/internal/sysinfo"): self.sysinfo,
            ("GET", "/internal/sysinfo-download"): self.sysinfo_download,
            ("GET", "/internal/profile-startup"): self.profile_startup,
            ("POST", "/internal/extra-networks/user-metadata"): self.extra_network_user_metadata,
            ("GET", "/internal/extra-networks/preview"): self.extra_network_preview,
            ("POST", "/internal/extra-networks/preview"): self.extra_network_set_preview,
            ("GET", "/sdapi/v1/extensions"): self.extensions,
            ("POST", "/internal/extensions/install"): self.extensions_install,
            ("POST", "/internal/extensions/available"): self.extensions_available,
            ("POST", "/internal/extensions/check-updates"): self.extensions_check_updates,
            ("POST", "/sdapi/v1/server-kill"): self.server_kill,
            ("POST", "/sdapi/v1/server-restart"): self.server_restart,
            ("POST", "/sdapi/v1/server-stop"): self.server_stop,
        }
        #: the last finished generation's images and info, for a reloaded
        #: page's gallery (api.py:264,288)
        self._last_result: dict | None = None

    def _generate(self, body, img2img: bool):
        if not isinstance(body, dict):
            raise ApiError(422, "request body must be a JSON object")
        p = _params_from_request(body, img2img)
        name = body.get("script_name")
        if name:
            self._check_script(name)
            res = self.engine.run_script(name, p, body.get("script_args") or [])
        else:
            res = (self.engine.img2img if img2img else self.engine.txt2img)(
                p, save=bool(body.get("save_images", False)))
        images = None
        if body.get("send_images", True):
            images = [base64.b64encode(encode_png(
                img, {"parameters": res.infotexts[i]} if i < len(res.infotexts) else None)
            ).decode("ascii") for i, img in enumerate(res.images)]
        if images:
            self._last_result = {"images": images, "info": json.dumps(res.js())}
        if img2img and not body.get("include_init_images", False):
            body = {k: v for k, v in body.items() if k not in ("init_images", "mask")}
        return {"images": images, "parameters": body, "info": json.dumps(res.js())}

    def txt2img(self, body: dict):
        return self._generate(body, img2img=False)

    def _check_script(self, name: str):
        """A script_name JAX's API runs (api.py:240-250): a selectable
        script; "Custom code" only with --allow-code, as the reference
        hides it without (its show() is cmd_opts.allow_code)."""
        script = get_script(name)
        if script is None or (script.name == "Custom code" and not self.engine.allow_code):
            hint = " (the server runs without --allow-code)" if script is not None else ""
            raise ApiError(400, f"Script not found: {name!r}{hint}")
        if script.alwayson:
            raise ApiError(400, f"Script {name!r} is always-on and cannot be selected as "
                                "script_name")

    def scripts(self, body=None):
        """The selectable scripts of both tabs (api.py:972-981)."""
        names = [n for n in list_selectable_scripts()
                 if n != "custom code" or self.engine.allow_code]
        return {"txt2img": names, "img2img": names}

    def script_info(self, body=None):
        """Every script's argument spec (api.py:983-999)."""
        return [{"name": n, "is_alwayson": alwayson, "is_img2img": True,
                 "args": list(get_script(n).ui_params)}
                for alwayson, names in ((False, list_selectable_scripts()),
                                        (True, list_alwayson_scripts()))
                for n in names]

    def img2img(self, body: dict):
        return self._generate(body, img2img=True)

    def _extras_args(self, body) -> StageArgs:
        """The Upscale stage's arguments of an Extras request, checked."""
        if not isinstance(body, dict):
            raise ApiError(422, "request body must be a JSON object")
        req = _check_fields(body, EXTRAS_FIELDS, {})
        if req["save_output"]:
            saving.check_format(opts.get("samples_format", "png") or "png")
        if req["resize_mode"] not in (0, 1):
            raise ApiError(422, f"extras resize_mode {req['resize_mode']} is not supported "
                                "(0 scale by, 1 scale to)")
        _check_upscaler(req["upscaler_1"], "upscaler_1")
        if req["upscaler_2"] not in (None, "", "None"):
            _check_upscaler(req["upscaler_2"], "upscaler_2")
        return StageArgs.from_obj(req)

    @staticmethod
    def _save_extras(image, args: StageArgs, name: str | None) -> str:
        """save_output (api.py:310-333): under opts.outdir_extras_samples in
        opts.samples_format, the "extras" text naming the upscale; the
        original name kept with use_original_name_batch, the upscaler's
        name as a suffix with use_upscaler_name_as_suffix."""
        suffix = f"-{args.upscaler_1}" if opts.get("use_upscaler_name_as_suffix", False) else ""
        forced = None
        if opts.get("use_original_name_batch", True) and name:
            forced = os.path.splitext(os.path.basename(name))[0] + suffix
        return saving.save_image(
            image, path=opts.get("outdir_extras_samples", "outputs/extras-images"),
            info=f"Postprocess upscale by: {float(args.upscaling_resize)}, "
                 f"Postprocess upscaler: {args.upscaler_1}",
            extension=opts.get("samples_format", "png"), short_filename=True, no_prompt=True,
            pnginfo_section_name="extras", forced_filename=forced, suffix=suffix)

    def extras_single(self, body: dict):
        """api.py:301: the Upscale stage over one base64 image."""
        args = self._extras_args(body)
        if not body.get("image"):
            raise ApiError(404, "Image not found")
        (out,) = self.engine.extras([_decode_image(body["image"], "image")], args)
        if body.get("save_output", False):
            self._save_extras(out, args, body.get("name"))
        return {"html_info": f"<p>Upscaled with {args.upscaler_1}</p>",
                "image": base64.b64encode(encode_png(out)).decode("ascii")}

    def extras_batch(self, body: dict):
        """api.py:337: the Upscale stage over every image of imageList."""
        if not isinstance(body, dict):
            raise ApiError(422, "request body must be a JSON object")
        body = dict(body)
        items = body.pop("imageList", []) or []
        if not isinstance(items, list) or not all(isinstance(i, dict) for i in items):
            raise ApiError(422, "field 'imageList' must hold {data, name} objects")
        args = self._extras_args(body)
        images = [_decode_image(item.get("data", ""), "imageList") for item in items]
        outs = self.engine.extras(images, args)
        if body.get("save_output", False):
            for item, out in zip(items, outs):
                self._save_extras(out, args, item.get("name"))
        return {"html_info": f"<p>{len(outs)} images upscaled</p>",
                "images": [base64.b64encode(encode_png(o)).decode("ascii") for o in outs]}

    def upscalers(self, body=None):
        return [{"name": n, "model_name": None, "model_path": None, "model_url": None,
                 "scale": 4} for n in upscalers.upscaler_names()]

    def latent_upscale_modes(self, body=None):
        return [{"name": n} for n in LATENT_UPSCALE_MODES]

    def get_options(self, body=None):
        d = opts.dumpjson()
        model = self.engine._model
        d["sd_model_checkpoint"] = model.title if model else d.get("sd_model_checkpoint")
        return d

    def set_options(self, body: dict):
        """Set the options; a sd_model_checkpoint in the body loads it."""
        if not isinstance(body, dict):
            raise ApiError(422, "request body must be a JSON object")
        unknown = sorted(set(body) - OPTIONS)
        if unknown:
            raise ApiError(422, f"options {unknown} are not supported by this server yet")
        body = dict(body)
        checkpoint = body.pop("sd_model_checkpoint", None)
        for key, value in body.items():
            try:
                opts.set(key, value, is_api=True)
            except (TypeError, PermissionError) as e:
                raise ApiError(422, f"option {key!r}: {e}") from e
        if checkpoint is not None:     # the setting follows a load that succeeded
            self.engine.reload_checkpoint(checkpoint)
            opts.data["sd_model_checkpoint"] = checkpoint
        return {}

    def samplers(self, body=None):
        return [{"name": s.name, "aliases": list(s.aliases), "options": dict(s.extra)}
                for s in SAMPLERS]

    def schedulers(self, body=None):
        seen = {}
        for label, key in ALIASES.items():
            seen.setdefault(key, label)
        return [{"name": k, "label": lbl, "aliases": [lbl], "default_rho": -1,
                 "need_inner_model": k in ("uniform", "sgm_uniform", "simple",
                                           "normal", "ddim", "beta")}
                for k, lbl in seen.items()]

    def sd_models(self, body=None):
        registry = self.engine.registry
        return [{"title": c.title, "model_name": c.model_name, "filename": c.filename,
                 "hash": (c.sha256 or "")[:10] or None, "sha256": c.sha256, "config": None}
                for c in (registry.list() if registry is not None else [])]

    def sd_vaes(self, body=None):
        return [{"model_name": os.path.splitext(os.path.basename(p))[0], "filename": p}
                for d in self.engine.vae_dirs for p in sorted(glob.glob(os.path.join(d, "*")))
                if p.lower().endswith((".pt", ".ckpt", ".safetensors"))]

    def refresh_checkpoints(self, body=None):
        if self.engine.registry is not None:
            self.engine.registry.refresh()
        return {}

    def reload_checkpoint(self, body=None):
        self.engine.reload_checkpoint()
        return {}

    def unload_checkpoint(self, body=None):
        self.engine.unload_checkpoint()
        return {}

    # ---- extra networks (api.py:747-790,889-910) -------------------------

    def loras(self, body=None):
        """name, alias (kohya's ss_output_name), path and the safetensors
        metadata of each LoRA file, with its mtime, whether a dot-directory
        hides it (extra_networks_hidden_models "Never" leaves it out), its
        preview's URL and its <file>.json user metadata (api.py:759-811)."""
        hidden_mode = opts.get("extra_networks_hidden_models", "When searched")
        out = []
        for name, path in lora_registry().files.items():
            hidden = any(part.startswith(".")
                         for part in os.path.normpath(path).split(os.sep)[:-1])
            if hidden and hidden_mode == "Never":
                continue
            meta = read_metadata(path) if path.endswith(".safetensors") else {}
            entry = {"name": name, "alias": meta.get("ss_output_name") or name,
                     "path": path, "metadata": meta, "mtime": os.path.getmtime(path),
                     "hidden": hidden}
            if self._find_network_preview(path):
                entry["preview"] = ("/internal/extra-networks/preview?name="
                                    + urllib.parse.quote(name))
            side = os.path.splitext(path)[0] + ".json"
            if os.path.isfile(side):
                try:
                    with open(side, encoding="utf-8") as f:
                        entry["user_metadata"] = json.load(f)
                except (OSError, ValueError):
                    pass
            out.append(entry)
        return out

    def refresh_loras(self, body=None):
        lora_registry().refresh()
        return {}

    def embeddings(self, body=None):
        db = self.engine.sd_model.conditioner.embedding_db
        if db is None:
            return {"loaded": {}, "skipped": {}}
        return {"loaded": {name: {"step": e.step, "sd_checkpoint": None,
                                  "sd_checkpoint_name": None, "shape": int(e.vec.shape[-1]),
                                  "vectors": e.vectors} for name, e in db.embeddings.items()},
                "skipped": {s.split(" ")[0]: {} for s in db.skipped}}

    def refresh_embeddings(self, body=None):
        self.engine.refresh_embeddings()
        return {}

    def hypernetworks(self, body=None):
        return [{"name": name, "path": path} for name, path in hypernet_registry().files.items()]

    # ---- prompt styles (api.py:595-645) -----------------------------------

    def prompt_styles(self, body=None):
        return [{"name": s.name, "prompt": s.prompt, "negative_prompt": s.negative_prompt}
                for s in self.engine.styles.styles.values()]

    def _style_name(self, body) -> str:
        if not isinstance(body, dict) or not isinstance(body.get("name", ""), str):
            raise ApiError(422, "request body must be a JSON object with a string 'name'")
        name = body.get("name", "").strip()
        if not name:
            raise ApiError(400, "style name required")
        return name

    def save_style(self, body: dict):
        """Create or replace a style and write the CSV (JAX's save_style)."""
        name = self._style_name(body)
        with self.engine.queue_lock:
            self.engine.styles.styles[name] = PromptStyle(
                name, str(body.get("prompt", "")), str(body.get("negative_prompt", "")))
            self.engine.styles.save()
            return {"name": name, "count": len(self.engine.styles.styles)}

    def delete_style(self, body: dict):
        """Remove a style and write the CSV (JAX's delete_style)."""
        name = self._style_name(body)
        with self.engine.queue_lock:
            if name not in self.engine.styles.styles:
                raise ApiError(404, f"style {name!r} not found")
            del self.engine.styles.styles[name]
            self.engine.styles.save()
            return {"name": name, "count": len(self.engine.styles.styles)}

    # ---- the sd-webui-controlnet extension's routes (api.py:937-969) --------

    def controlnet_models(self, body=None):
        return {"model_list": control.list_models()}

    def controlnet_modules(self, body=None):
        return {"module_list": annotators.list_modules()}

    def controlnet_detect(self, body):
        """An annotator over base64 PNGs → base64 PNG hints."""
        if not isinstance(body, dict):
            raise ApiError(422, "request body must be a JSON object")
        module = body.get("controlnet_module", "none")
        res = body.get("controlnet_processor_res", 512)
        if not isinstance(res, int) or isinstance(res, bool):
            raise ApiError(422, "field 'controlnet_processor_res' must be an integer")
        out = []
        for enc in body.get("controlnet_input_images") or []:
            img = _decode_image(enc, "controlnet_input_images")
            hint = annotators.run_annotator(module, img[:, :, :3] if img.shape[2] >= 3
                                            else img[:, :, 0], res=res,
                                            threshold_a=body.get("controlnet_threshold_a"),
                                            threshold_b=body.get("controlnet_threshold_b"),
                                            device=self.engine.device)
            out.append(base64.b64encode(encode_png(hint)).decode("ascii"))
        return {"images": out, "info": f"module={module}"}

    # ---- job control (api.py:437-539,587-592,899,916) ---------------------

    def _preview_b64(self, snap: dict, fmt: str = "png") -> str | None:
        """The live preview as a base64 PNG, encoded once per preview image
        and format (/progress and /internal/progress each keep theirs; the
        image itself is the key, since id_live_preview restarts with each
        job) and
        stored uncompressed (deflate level 0): compressing a noisy 1024²
        grid costs many times what the rest of a poll does; or as a JPEG at
        Pillow's default quality, 75, or a lossy WebP at Pillow's default,
        80 (an RGBA preview with its alpha in an ALPH chunk)."""
        if snap["current_image"] is None:
            return None
        with self._preview_lock:
            img = snap["current_image"]
            if self._previews.get(fmt, (None,))[0] is not img:
                if fmt == "png":
                    data = encode_png(img, level=0)
                elif fmt == "webp":
                    data = webp.encode_webp_alpha(img, 80) if img.ndim == 3 and \
                        img.shape[2] == 4 else webp.encode_webp(img, 80)
                else:
                    data = encode_jpeg(img, 75)
                self._previews[fmt] = (img, base64.b64encode(data).decode("ascii"))
            return self._previews[fmt][1]

    def progress(self, body=None):
        """The job's progress and live preview, read from one snapshot of the
        state without the queue lock."""
        snap = self.engine.state.snapshot()
        elapsed = time.time() - snap["time_start"] if snap["time_start"] else 0
        progress = snap["progress"]
        return {
            "progress": progress if snap["job"] else 0.0,
            "eta_relative": elapsed / progress - elapsed if progress > 0 else 0,
            "state": {k: snap[k] for k in (
                "skipped", "interrupted", "stopping_generation", "job", "job_count",
                "job_timestamp", "job_no", "sampling_step", "sampling_steps")},
            "current_image": self._preview_b64(snap),
            "textinfo": snap["textinfo"]}

    def internal_progress(self, body=None):
        """The UI's progress poll (api.py:470-490): the preview as a data URL
        in opts.live_previews_image_format, png, jpeg (an RGBA preview stays
        PNG, as in JAX) or webp; another format raises naming it."""
        body = body if isinstance(body, dict) else {}
        snap = self.engine.state.snapshot()
        live = None
        if snap["current_image"] is not None and body.get("live_preview", True):
            fmt = str(opts.get("live_previews_image_format", "png")).lower()
            img = snap["current_image"]
            if fmt == "jpeg" and img.ndim == 3 and img.shape[2] == 4:
                fmt = "png"
            if fmt not in ("png", "jpeg", "webp"):
                raise NotImplementedError(f"live_previews_image_format {fmt!r} is not ported "
                                          "yet (png, jpeg and webp)")
            live = f"data:image/{fmt};base64," + self._preview_b64(snap, fmt)
        return {"active": bool(snap["job"]), "queued": False, "completed": not snap["job"],
                "progress": snap["progress"], "eta": None, "live_preview": live,
                "id_live_preview": snap["id_live_preview"], "textinfo": snap["textinfo"]}

    def interrupt(self, body=None):
        self.engine.state.interrupt()
        return {}

    def skip(self, body=None):
        self.engine.state.skip()
        return {}

    def interrupt_ui(self, body=None):
        """The UI button: with opts.interrupt_after_current a multi-image job
        finishes the image in flight first (State.interrupt_ui)."""
        self.engine.state.interrupt_ui()
        return {}

    def png_info(self, body):
        """The generation parameters of a base64 image (api.py:437-447): its
        "parameters" text or EXIF UserComment, the image's Pillow ``img.info``
        less its bytes values (a JPEG's or WebP's raw EXIF, a GIF's version
        and comment), which JSON cannot carry, and the parsed infotext."""
        if not isinstance(body, dict):
            raise ApiError(422, "request body must be a JSON object")
        if not body.get("image"):
            raise ApiError(404, "Image not found")
        _, items = _decode_with_info(body["image"], "image")
        info = saving.read_info_from_image(items) or ""
        items = {k: v for k, v in items.items() if not isinstance(v, bytes) and not (
            isinstance(v, tuple) and any(isinstance(x, bytes) for x in v))}
        return {"info": info, "items": items, "parameters": infotext.parse(info)}

    # ---- saving (api.py:645-745) --------------------------------------------

    def save_images_action(self, body):
        """The gallery's Save / Save-as-zip button (``server/ui_actions``): the
        posted images under opts.outdir_save, a log.csv row, a zip."""
        from sdwebui_tpu_torch.server.ui_actions import save_files_from_json

        if body is not None and not isinstance(body, dict):
            raise ApiError(422, "request body must be a JSON object")
        try:
            return save_files_from_json(body or {})
        except (binascii.Error, ValueError) as e:
            raise ApiError(400, f"images: {e}") from e

    def img2img_batch(self, body):
        """img2img over the .png, .jpg, .jpeg, .webp and .bmp files of
        input_dir (api.py:653-745), read whatever their format: each file an
        init image, its mask the same-named file of inpaint_mask_dir,
        with use_png_info its infotext's png_info_props (read from the file or
        the same-named one in png_info_dir) merged into the request; the
        outputs saved as PNG under output_dir (default <input_dir>/out) by the
        file's name, the first opts.img2img_batch_show_results_limit of them
        answered.  Each file is decoded once, all before the first
        generation (held as RGB until its turn), so a file in a format the
        port does not read (AVIF, ...) answers 422 naming it before anything
        runs; a file that is not an image raises when its turn comes, as in
        JAX."""
        import glob

        if not isinstance(body, dict):
            raise ApiError(422, "request body must be a JSON object")
        body = dict(body)
        input_dir = body.pop("input_dir", "")
        output_dir = body.pop("output_dir", "")
        mask_dir = body.pop("inpaint_mask_dir", "")
        use_png_info = bool(body.pop("use_png_info", False))
        png_info_props = set(body.pop("png_info_props", None) or [])
        png_info_dir = body.pop("png_info_dir", "")
        if not input_dir or not os.path.isdir(input_dir):
            raise ApiError(404, f"input directory not found: {input_dir!r}")
        files = sorted(f for f in glob.glob(os.path.join(input_dir, "*"))
                       if f.lower().endswith((".png", ".jpg", ".jpeg", ".webp", ".bmp")))
        if not files:
            raise ApiError(404, "no images in input directory")
        decoded = []
        for path in files:
            try:
                pixels, info = read_image_file(path)
            except UnsupportedImageFormat as e:
                raise NotImplementedError(f"{os.path.basename(path)}: a {e.fmt} image, which "
                                          "the img2img batch does not read") from e
            except ValueError as e:
                decoded.append(e)
                continue
            # JAX converts each file to RGB first, which keeps its info
            decoded.append((images_util.to_rgb(pixels), info))
        limit = int(opts.get("img2img_batch_show_results_limit", 32))
        outd = output_dir or os.path.join(input_dir, "out")
        shown, done = [], []
        for path, read in zip(files, decoded):
            if isinstance(read, ValueError):
                raise read
            rgb, info = read
            sub = dict(body)
            if use_png_info:
                try:
                    source = read_image_file(os.path.join(
                        png_info_dir, os.path.basename(path)))[1] if png_info_dir else info
                    parsed = infotext.parse(saving.read_info_from_image(source) or "")
                    parsed = {k: v for k, v in parsed.items() if k in png_info_props}
                except (OSError, ValueError):
                    parsed = {}
                if "Prompt" in parsed:
                    sub["prompt"] = (sub.get("prompt", "") + " " + parsed["Prompt"]).strip()
                if "Negative prompt" in parsed:
                    sub["negative_prompt"] = (sub.get("negative_prompt", "") + " "
                                              + parsed["Negative prompt"]).strip()
                if "Seed" in parsed:
                    sub["seed"] = int(parsed["Seed"])
                if "CFG scale" in parsed:
                    sub["cfg_scale"] = float(parsed["CFG scale"])
                if "Sampler" in parsed:
                    sub["sampler_name"] = parsed["Sampler"]
                if "Steps" in parsed:
                    sub["steps"] = int(parsed["Steps"])
            p = _params_from_request(sub, img2img=True, init_images=[(rgb, info)])
            mask_path = os.path.join(mask_dir, os.path.basename(path)) if mask_dir else ""
            if mask_path and os.path.isfile(mask_path):
                p.mask = images_util.to_l(read_image_file(mask_path)[0])
            res = self.engine.img2img(p, save=False)
            base = os.path.splitext(os.path.basename(path))[0]
            for i, im in enumerate(res.images):
                done.append(saving.save_image(
                    im, outd, seed=p.all_seeds[i] if i < len(p.all_seeds) else p.seed,
                    prompt=p.prompt, info=res.infotexts[i] if i < len(res.infotexts) else None,
                    forced_filename=f"{base}-{i}" if len(res.images) > 1 else base, p=p,
                    save_to_dirs=False))
                if limit != 0 and (limit < 0 or len(shown) < limit):
                    shown.append(base64.b64encode(encode_png(im)).decode("ascii"))
        saving.flush_saves()
        return {"processed": len(files), "outputs": done, "images": shown}

    def memory(self, body=None):
        """Host RAM (this process's peak RSS) and the card's memory, with the
        last job's peak allocation (utils/memmon)."""
        ram = {"free": -1, "used": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
               "total": -1}
        device = self.engine.device
        if device.type == "cuda":
            free, total = torch.cuda.mem_get_info(device)
            system = {"free": free, "used": total - free, "total": total}
        else:
            system = {"error": "unavailable"}
        mon = self.engine.state.memmon
        return {"ram": ram, "cuda": {"system": system, "events": {
            "peak_used": mon.peak_used, "polls": mon.polls}}}

    def cmd_flags(self, body=None):
        return {**self.flags, "api": True, "ckpt": self.engine._requested_ckpt}

    def realesrgan_models(self, body=None):
        """The Real-ESRGAN files the server registered (JAX answers [])."""
        return [{"name": e.name, "path": e.path, "scale": e.default_scale}
                for e in map(upscalers.get_upscaler, self.realesrgan)]

    def face_restorers(self, body=None):
        return [{"name": n, "cmd_dir": None} for n in faces.available_restorers()]

    # ---- interrogation (api.py:349-415) ----------------------------------

    def interrogate(self, body):
        """The image's caption by DeepDanbooru, or by the CLIP interrogator
        (with BLIP's caption first when BLIP's files are there); 501 naming
        what is absent.  The nets stay loaded with
        opts.interrogate_keep_models_in_memory, else go after the request."""
        if not isinstance(body, dict):
            raise ApiError(422, "request body must be a JSON object")
        req = _check_fields(body, {"image": ("", str), "model": ("clip", str)}, {})
        try:
            return self._interrogate(req)
        finally:
            if not opts.get("interrogate_keep_models_in_memory", False):
                self._interrogators.clear()

    def _interrogator(self, key: str, make):
        if key not in self._interrogators:
            self._interrogators[key] = make()
        return self._interrogators[key]

    def _interrogate(self, req: dict):
        from sdwebui_tpu_torch.models import deepbooru
        from sdwebui_tpu_torch.postprocessing import interrogate as interrogators
        from sdwebui_tpu_torch.training.preprocess import find_deepbooru

        if not req["image"]:
            raise ApiError(404, "Image not found")
        dirs, device = self.interrogate_dirs, self.engine.device
        with self.engine.queue_lock:
            if req["model"] == "deepdanbooru":
                path = find_deepbooru(dirs["deepbooru"])
                if path:
                    net = self._interrogator(
                        "deepbooru", lambda: deepbooru.load_deepbooru(path, device))
                    return {"caption": deepbooru.tag_image(
                        net, _decode_image(req["image"], "image"),
                        threshold=float(opts.get("interrogate_deepbooru_score_threshold", 0.5)),
                        alpha_sort=bool(opts.get("deepbooru_sort_alpha", True)),
                        use_spaces=bool(opts.get("deepbooru_use_spaces", True)),
                        use_escape=bool(opts.get("deepbooru_escape", True)),
                        filter_tags=str(opts.get("deepbooru_filter_tags", "")),
                        include_ranks=bool(opts.get("interrogate_return_ranks", False)))}
            if req["model"] == "clip":
                captioner = None
                found = interrogators.find_blip_model(dirs["blip"])
                if found:
                    captioner = self._interrogator(
                        "blip", lambda: interrogators.BlipCaptioner(*found, device=device))
                path = interrogators.find_clip_model(dirs["clip"])
                if path and os.path.isdir(dirs["categories"]):
                    clip = self._interrogator("clip", lambda: interrogators.ClipInterrogator(
                        path, dirs["categories"], device=device))
                    return {"caption": clip.interrogate(_decode_image(req["image"], "image"),
                                                        captioner=captioner)}
                if captioner is not None:
                    return {"caption": captioner.caption(_decode_image(req["image"], "image"))}
        raise ApiError(
            501, f"interrogate model {req['model']!r} weights are not present "
                 f"(no network access in this deployment); place "
                 f"TorchDeepDanbooru weights under models/torch_deepdanbooru/, "
                 f"a CLIP model under models/clip_vision/ plus "
                 f"interrogate/<category>.txt files, and/or BLIP weights + "
                 f"vocab.txt under models/BLIP/, to enable")

    # ---- training (api.py:1206-1365) ---------------------------------------

    @staticmethod
    def _training_body(body, fields: set) -> dict:
        if not isinstance(body, dict):
            raise ApiError(422, "request body must be a JSON object")
        unknown = sorted(set(body) - fields)
        if unknown:
            raise ApiError(422, f"fields {unknown} are not supported by this server yet")
        return body

    def preprocess(self, body):
        """The dataset preprocessing pass over process_src into process_dst."""
        from sdwebui_tpu_torch.training.preprocess import preprocess_dir

        body = self._training_body(body, PREPROCESS_FIELDS)
        src = body.get("process_src", body.get("input_dir", ""))
        dst = body.get("process_dst", body.get("output_dir", ""))
        if not src or not os.path.isdir(src):
            raise ApiError(404, f"source directory not found: {src!r}")
        if not dst:
            raise ApiError(400, "process_dst is required")
        with self.engine.queue_lock:
            written = preprocess_dir(
                src, dst, width=int(body.get("process_width", 512)),
                height=int(body.get("process_height", 512)),
                split=bool(body.get("process_split", False)),
                split_threshold=float(body.get("process_split_threshold", 2.0)),
                overlap_ratio=float(body.get("process_overlap_ratio", 0.2)),
                flip=bool(body.get("process_flip", False)),
                focal_crop=bool(body.get("process_focal_crop", False)),
                auto_size_crop=bool(body.get("process_multicrop", False)),
                caption_deepbooru=bool(body.get("process_caption_deepbooru", False)),
                existing_caption_action=str(body.get(
                    "existing_caption_action",
                    opts.get("postprocessing_existing_caption_action", "ignore"))).lower(),
                device=self.engine.device, deepbooru_dir=self.interrogate_dirs["deepbooru"])
        return {"info": f"preprocess complete: {len(written)} images", "outputs": written}

    def create_embedding(self, body):
        """A new embedding of num_vectors_per_token rows of the live model's
        CLIP width, N(0, 0.01²) from seed 0, in the embeddings directory."""
        import numpy as np

        from sdwebui_tpu_torch.loader.safetensors_io import write_safetensors

        body = self._training_body(body, CREATE_EMBEDDING_FIELDS)
        name = body.get("name", "embedding")
        n_vectors = int(body.get("num_vectors_per_token", 1))
        width = self.engine.sd_model.conditioner.cfg.width
        os.makedirs(self.engine.embeddings_dir, exist_ok=True)
        path = os.path.join(self.engine.embeddings_dir, f"{name}.safetensors")
        vec = np.random.default_rng(0).standard_normal((n_vectors, width)).astype(
            np.float32) * 0.01
        write_safetensors(path, {"emb_params": torch.from_numpy(vec)}, metadata={"name": name})
        return {"info": f"create embedding filename: {path}"}

    def create_hypernetwork(self, body):
        """A new hypernetwork (create_hypernetwork at seed 0) in the first
        hypernetwork directory."""
        from sdwebui_tpu_torch.networks.hypernetwork import (create_hypernetwork,
                                                             save_hypernetwork)

        body = self._training_body(body, CREATE_HYPERNETWORK_FIELDS)
        name = body.get("name", "hypernetwork")
        layer_structure = tuple(float(x) for x in body.get("layer_structure", (1, 2, 1)))
        directory = hypernet_registry().dirs[0]
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"{name}.safetensors")
        hn = create_hypernetwork(
            dims=tuple(int(x) for x in body.get("enable_sizes", [768, 320, 640, 1280])),
            layer_structure=layer_structure, weight_init=body.get("weight_init", "Normal"),
            add_layer_norm=bool(body.get("add_layer_norm", False)),
            activation=body.get("activation_func", "linear"))
        save_hypernetwork(hn, path, name=name, layer_structure=layer_structure)
        hypernet_registry().refresh()
        return {"info": f"create hypernetwork filename: {path}"}

    def _train(self, job: str, steps: int, run):
        """run(callback) as a job under the queue lock: each step sets the
        progress, an interrupt stops the run after the step in flight."""
        def callback(i, loss):
            self.engine.state.set_sampling_step(i + 1, steps)
            return not self.engine.state.interrupted

        with self.engine.queue_lock:
            self.engine.state.begin(job, 1, self.engine.device)
            try:
                return run(callback)
            except (ValueError, AssertionError) as e:
                raise ApiError(400, str(e)) from e
            finally:
                self.engine.state.end()

    def train_embedding(self, body):
        """Textual-inversion training from a directory of images into the
        embeddings directory; the live model's database is rescanned."""
        from sdwebui_tpu_torch.training.textual_inversion import train_embedding_from_dir

        body = self._training_body(body, TRAIN_EMBEDDING_FIELDS)
        name = body.get("embedding_name", "embedding")
        data_dir = body.get("data_root", "")
        if not os.path.isdir(data_dir):
            raise ApiError(404, f"data_root not found: {data_dir}")
        steps = int(body.get("steps", 100))
        os.makedirs(self.engine.embeddings_dir, exist_ok=True)
        _, losses = self._train("train-embedding", steps, lambda callback: train_embedding_from_dir(
            self.engine.sd_model, name, data_dir, placeholder=body.get("placeholder") or name,
            n_vectors=int(body.get("num_vectors_per_token", 1)), steps=steps,
            learn_rate=body.get("learn_rate", "0.005"),
            batch_size=int(body.get("batch_size", 1)),
            template=body.get("template_filename", body.get("template", "subject")),
            width=int(body.get("training_width", 512)),
            height=int(body.get("training_height", 512)),
            varsize=bool(body.get("varsize", False)),
            use_weight=bool(body.get("use_weight", False)),
            shuffle_tags=bool(body.get("shuffle_tags", False)),
            tag_drop_out=float(body.get("tag_drop_out", 0.0)),
            latent_sampling_method=body.get("latent_sampling_method", "once"),
            save_every=int(body.get("save_embedding_every", 0)),
            preview_every=int(body.get("create_image_every", 0)),
            preview_prompt=body.get("preview_prompt") or None,
            save_path=os.path.join(self.engine.embeddings_dir, f"{name}.safetensors"),
            callback=callback))
        self.engine.refresh_embeddings()
        return {"info": f"train embedding complete: {len(losses)} steps, "
                        f"final loss {losses[-1]:.4f}"}

    def train_hypernetwork(self, body):
        """Hypernetwork training from a directory of images into the first
        hypernetwork directory; the registry is rescanned."""
        from sdwebui_tpu_torch.training.hypernetwork import train_hypernetwork_from_dir

        body = self._training_body(body, TRAIN_HYPERNETWORK_FIELDS)
        name = body.get("hypernetwork_name", "hypernetwork")
        data_dir = body.get("data_root", "")
        if not os.path.isdir(data_dir):
            raise ApiError(404, f"data_root not found: {data_dir}")
        steps = int(body.get("steps", 100))
        directory = hypernet_registry().dirs[0]
        os.makedirs(directory, exist_ok=True)
        _, losses = self._train("train-hypernetwork", steps,
                                lambda callback: train_hypernetwork_from_dir(
            self.engine.sd_model, name, data_dir, steps=steps,
            learn_rate=body.get("learn_rate", "0.00001"),
            batch_size=int(body.get("batch_size", 1)),
            template=body.get("template_filename", body.get("template", "hypernetwork")),
            width=int(body.get("training_width", 512)),
            height=int(body.get("training_height", 512)),
            varsize=bool(body.get("varsize", False)),
            use_weight=bool(body.get("use_weight", False)),
            shuffle_tags=bool(body.get("shuffle_tags", False)),
            tag_drop_out=float(body.get("tag_drop_out", 0.0)),
            latent_sampling_method=body.get("latent_sampling_method", "once"),
            layer_structure=tuple(float(x) for x in body.get("layer_structure", (1, 2, 1))),
            activation=body.get("activation_func", "linear"),
            weight_init=body.get("weight_init", "Normal"),
            add_layer_norm=bool(body.get("add_layer_norm", False)),
            use_dropout=bool(body.get("use_dropout", False)),
            last_layer_dropout=bool(body.get("last_layer_dropout", True)),
            dropout_structure=body.get("dropout_structure"),
            save_every=int(body.get("save_hypernetwork_every", 0)),
            preview_every=int(body.get("create_image_every", 0)),
            preview_prompt=body.get("preview_prompt") or None,
            save_path=os.path.join(directory, f"{name}.safetensors"), callback=callback))
        hypernet_registry().refresh()
        return {"info": f"train hypernetwork complete: {len(losses)} steps, "
                        f"final loss {losses[-1]:.4f}"}

    # ---- the page (api.py:1376-1383) ----------------------------------------

    def index_html(self, body=None):
        """The single-page UI, ``server/webui.html`` (a copy of JAX's page)."""
        with open(os.path.join(os.path.dirname(__file__), "webui.html"), encoding="utf-8") as f:
            return RawResponse(f.read(), "text/html; charset=utf-8")

    def last_result(self, body=None):
        """The last finished generation's images and info (api.py:293-299)."""
        if not self._last_result:
            raise ApiError(404, "No generation has completed yet")
        return self._last_result

    # ---- the checkpoint merger (api.py:420-435) -----------------------------

    def _merge_input(self, name) -> str | None:
        """A merge input: a file path, else a checkpoint the registry holds
        by name or title (the page sends titles)."""
        if name in (None, "", "None"):
            return None
        if not isinstance(name, str):
            raise ApiError(422, f"checkpoint names must be strings, got {name!r}")
        return name if os.path.isfile(name) else self.engine._find(name).filename

    @staticmethod
    def _vae_file(path) -> str | None:
        if path in (None, "", "None"):
            return None
        if not isinstance(path, str) or not os.path.isfile(path):
            raise ApiError(404, f"bake_in_vae {path!r} is not a file")
        return path

    def modelmerger(self, body):
        """Merge checkpoints under the queue lock into the first checkpoint
        directory (``postprocessing/merger``), then rescan the registry.
        custom_name must be one path component (400 otherwise)."""
        from sdwebui_tpu_torch.server.app import DEFAULT_CKPT_DIR

        if not isinstance(body, dict) or not body.get("primary_model"):
            raise ApiError(422, "request body must be a JSON object naming 'primary_model'")
        name = body.get("custom_name") or "merged"
        try:
            check_output_name(str(name))
        except ValueError as e:
            raise ApiError(400, str(e)) from e
        registry = self.engine.registry
        try:
            with self.engine.queue_lock:
                path = run_modelmerger(
                    primary_path=self._merge_input(body["primary_model"]),
                    secondary_path=self._merge_input(body.get("secondary_model")),
                    tertiary_path=self._merge_input(body.get("tertiary_model")),
                    method=body.get("interp_method", "Weighted sum"),
                    multiplier=float(body.get("multiplier", 0.5)),
                    save_as_half=bool(body.get("save_as_half", False)), output_name=str(name),
                    output_dir=registry.model_dirs[0] if registry is not None
                    else DEFAULT_CKPT_DIR,
                    bake_in_vae_path=self._vae_file(body.get("bake_in_vae")),
                    discard_weights=body.get("discard_weights", "") or "",
                    device=self.engine.device)
        except ValueError as e:
            raise ApiError(400, str(e)) from e
        if registry is not None:
            registry.refresh()
        return {"info": f"merged checkpoint saved to {path}"}

    # ---- the UI's settings, styles and prompt tools (api.py:600-643,1056-1144)

    def options_metadata(self, body=None):
        """Each option's label, section, type and choices, for the settings
        page (api.py:600-618)."""
        out = {}
        for key, info in opts.data_labels.items():
            sec = info.section or (None, None)
            row = {"label": info.label, "section": sec[0] or "other",
                   "section_title": sec[1] or "Other"}
            choices = (info.component_args or {}).get("choices")
            if choices:
                row["choices"] = list(choices)
            row["type"] = type(info.default).__name__
            out[key] = row
        return out

    def ui_config_get(self, body=None):
        """The widget defaults of ``ui-config.json`` in the working
        directory, as JAX keeps them (api.py:1109-1117)."""
        try:
            with open("ui-config.json", encoding="utf-8") as f:
                return json.load(f)
        except (FileNotFoundError, ValueError):
            return {}

    def ui_config_set(self, body):
        with open("ui-config.json", "w", encoding="utf-8") as f:
            json.dump(body or {}, f, indent=2)
        return {"saved": True}

    def localization(self, body=None):
        """The dictionary named by opts.localization: a JSON file of
        ``localizations/`` or of an enabled extension's (api.py:1126-1144)."""
        selected = opts.get("localization", "None")
        if selected in (None, "None"):
            return {}
        dirs = ["localizations"] + [os.path.join(e.path, "localizations")
                                    for e in ext_mod.active_extensions()]
        for d in dirs:
            for path in glob.glob(os.path.join(d, "*.json")):
                if os.path.splitext(os.path.basename(path))[0] == selected:
                    with open(path, encoding="utf-8") as f:
                        return json.load(f)
        return {}

    def token_count(self, body):
        """The prompt's tokens after the attention syntax is stripped (BREAK
        pads to the next 75), with its styles applied under
        include_styles_into_token_counters, and the 75-token chunks' length
        (api.py:1085-1107)."""
        if not isinstance(body, dict):
            raise ApiError(422, "request body must be a JSON object")
        text = str(body.get("text", ""))
        styles = body.get("styles") or []
        negative = bool(body.get("negative"))
        if styles and opts.get("include_styles_into_token_counters", True):
            pos, neg = self.engine.styles.apply(text if not negative else "",
                                                text if negative else "", styles)
            text = neg if negative else pos
        tok = (self.engine._model or self.engine.sd_model).conditioner.tokenizer
        n = 0
        for part, _w in parse_prompt_attention(text):
            if part == "BREAK":
                n += 75 - (n % 75 or 75)
                continue
            n += len(tok.encode(part))
        return {"token_count": n, "max_length": max((n + 74) // 75, 1) * 75}

    def parse_infotext(self, body):
        """A pasted infotext as fields (api.py:1056-1083): the known styles
        taken out of its prompts under opts.infotext_styles, the fields of
        opts.infotext_skip_pasting dropped, and Model / Model hash dropped
        with opts.disable_weights_auto_swap."""
        if not isinstance(body, dict):
            raise ApiError(422, "request body must be a JSON object")
        parsed = infotext.backcompat(infotext.parse(str(body.get("text", ""))))
        styles_mode = str(opts.get("infotext_styles", "Apply if any"))
        if styles_mode != "Ignore" and "Prompt" in parsed:
            found, prompt, negative = self.engine.styles.extract_styles_from_prompt(
                str(parsed.get("Prompt", "")), str(parsed.get("Negative prompt", "")))
            parsed["Prompt"], parsed["Negative prompt"] = prompt, negative
            if found and styles_mode in ("Apply", "Apply if any"):
                parsed["Styles array"] = found
        for k in opts.get("infotext_skip_pasting", []) or []:
            parsed.pop(k, None)
        if opts.get("disable_weights_auto_swap", False):
            parsed.pop("Model", None)
            parsed.pop("Model hash", None)
        return {"parsed": {str(k): v for k, v in parsed.items()}}

    # ---- the system report and the startup profile (api.py:1146-1201) ------

    def sysinfo(self, body=None):
        """JAX's report (api.py:1155-1190) with torch's version, the device
        type and the card count and name in place of jax, backend and
        device_count."""
        device = self.engine.device
        model = self.engine._model
        cuda = device.type == "cuda"
        return {
            "version": f"sdwebui-tpu-{__version__}",
            "python": sys.version.split()[0],
            "platform": platform.platform(),
            "torch": torch.__version__,
            "backend": device.type,
            "device_count": torch.cuda.device_count() if cuda else 1,
            "device_name": torch.cuda.get_device_name(device) if cuda else None,
            "ram_peak_mb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024,
            "checkpoint": getattr(model, "title", None),
            "checkpoint_hash": (model.sha256[:10] if getattr(model, "sha256", "") else None),
            "model_kind": getattr(model, "kind", None),
            "cmd_flags": {k: v for k, v in self.flags.items() if v not in (None, False, "")},
            "config": dict(opts.data),
            "extensions": [{"name": e.name, "enabled": e.enabled}
                           for e in ext_mod.list_extensions()],
        }

    def sysinfo_download(self, body=None):
        name = f"sysinfo-{time.strftime('%Y-%m-%d-%H-%M')}.json"
        return RawResponse(json.dumps(self.sysinfo(), indent=2), "application/json",
                           {"Content-Disposition": f'attachment; filename="{name}"'})

    def profile_startup(self, body=None):
        """The server's start-up stages, in seconds (``utils/timer``)."""
        return timer.startup_record or timer.startup_timer.dump()

    # ---- extra-network cards (api.py:813-887) ------------------------------

    _PREVIEW_EXTS = ("png", "jpg", "jpeg", "webp", "gif")
    _PREVIEW_TYPES = {"png": "image/png", "jpg": "image/jpeg", "jpeg": "image/jpeg",
                      "webp": "image/webp", "gif": "image/gif"}

    @classmethod
    def _find_network_preview(cls, path: str):
        """<base>.<ext>, then <base>.preview.<ext>, for each preview
        extension (reference ui_extra_networks.py:647 find_preview)."""
        base = os.path.splitext(path)[0]
        for ext in cls._PREVIEW_EXTS:
            for cand in (f"{base}.{ext}", f"{base}.preview.{ext}"):
                if os.path.isfile(cand):
                    return cand
        return None

    @staticmethod
    def _network_path(body) -> str:
        if not isinstance(body, dict):
            raise ApiError(422, "request body must be a JSON object")
        name = body.get("name", "")
        path = lora_registry().files.get(name)
        if path is None:
            raise ApiError(404, f"network {name!r} not found")
        return path

    def extra_network_preview(self, body):
        """A card's preview image, as its file's bytes."""
        path = self._network_path(body)
        found = self._find_network_preview(path)
        if found is None:
            raise ApiError(404, f"no preview image for {body.get('name')!r}")
        with open(found, "rb") as f:
            return RawResponse(f.read(), self._PREVIEW_TYPES[found.rsplit(".", 1)[-1].lower()])

    def extra_network_set_preview(self, body):
        """The posted image written as <base>.preview.png with its geninfo
        (the request's, else the image's own "parameters")."""
        path = self._network_path(body)
        if not body.get("image"):
            raise ApiError(400, "image required")
        pixels, info = _decode_with_info(body["image"], "image")
        target = os.path.splitext(path)[0] + ".preview.png"
        saving.save_image_with_geninfo(pixels, body.get("geninfo") or info.get("parameters"),
                                       target)
        return {"path": target}

    def extra_network_user_metadata(self, body):
        """The <file>.json user-metadata sidecar: the body less its name."""
        path = self._network_path(body)
        side = os.path.splitext(path)[0] + ".json"
        with open(side, "w", encoding="utf-8") as f:
            json.dump({k: v for k, v in body.items() if k != "name"}, f, indent=2)
        return {"path": side}

    # ---- extensions (api.py:1000-1054) ---------------------------------------

    def extensions(self, body=None):
        out = []
        for ext in ext_mod.list_extensions():
            ext.read_info_from_repo()
            out.append({"name": ext.name, "remote": ext.remote, "branch": ext.branch,
                        "commit_hash": ext.commit_hash, "commit_date": ext.commit_date,
                        "version": ext.version, "enabled": ext.enabled})
        return out

    def extensions_install(self, body):
        """git clone into extensions/ (a local path or a file:// remote needs
        no network); its install.py runs only with --allow-code."""
        if not isinstance(body, dict):
            raise ApiError(422, "request body must be a JSON object")
        try:
            ext = ext_mod.install_from_url(body.get("url", ""),
                                              dirname=body.get("dirname") or None,
                                              branch=body.get("branch") or None,
                                              allow_code=self.engine.allow_code)
        except (ValueError, FileExistsError, RuntimeError) as e:
            raise ApiError(400, str(e)) from e
        return {"name": ext.name, "path": ext.path, "commit_hash": ext.commit_hash,
                "branch": ext.branch}

    def extensions_available(self, body):
        """The extensions index, filtered and sorted: {url?, refresh?, tags?,
        search?, sort?, hide_installed?}; url a local index file or an
        http(s) URL."""
        body = body if isinstance(body, dict) else {}
        if body.get("refresh") or ext_mod._available_index is None:
            try:
                ext_mod.load_available_index(body.get("url") or None)
            except Exception as e:
                raise ApiError(400, f"could not load extensions index: {e}") from e
        try:
            return ext_mod.browse_available(
                selected_tags=body.get("tags") or (), filter_text=body.get("search") or "",
                sort_column=int(body.get("sort") or 0),
                hide_installed=bool(body.get("hide_installed", True)))
        except ValueError as e:
            raise ApiError(400, str(e)) from e

    def extensions_check_updates(self, body=None):
        return ext_mod.check_updates()

    # ---- server commands (api.py:1387-1397; server/__main__ acts on them) --

    def server_kill(self, body=None):
        self.engine.state.server_command = "kill"
        return {}

    def server_restart(self, body=None):
        self.engine.state.server_command = "restart"
        return {}

    def server_stop(self, body=None):
        self.engine.state.server_command = "stop"
        return {}

    def handle(self, method: str, path: str, body):
        """→ (status, JSON-able payload or RawResponse); a query string is
        the body of a request that has none (api.py:1441-1454)."""
        route, _, query = path.partition("?")
        handler = self.routes.get((method, route))
        if handler is None:
            return 404, {"detail": "Not Found"}
        if query and not body:
            body = {k: v[0] if len(v) == 1 else v
                    for k, v in urllib.parse.parse_qs(query).items()}
        try:
            return 200, handler(body)
        except ApiError as e:
            return e.status, {"detail": e.message}
        except ScriptArgError as e:     # a caller's script_args: 400 naming the control
            return 400, {"detail": str(e)}
        except NetworkNotFound as e:
            return 404, {"detail": str(e)}
        except (NotImplementedError, CheckpointNotFound, upscalers.UpscalerNotFound,
                faces.FaceRestorerNotFound) as e:
            return 422, {"detail": str(e)}
        except Exception as e:   # surfaced as a 500 with its message
            traceback.print_exc()
            return 500, {"detail": f"{type(e).__name__}: {e}"}


def make_handler(api: Api):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _respond(self, status: int, payload):
            raw = isinstance(payload, RawResponse)
            data = payload.body if raw else json.dumps(payload).encode("utf-8")
            self.send_response(status)
            self.send_header("Content-Type", payload.content_type if raw else "application/json")
            self.send_header("Content-Length", str(len(data)))
            for key, value in (payload.headers.items() if raw else ()):
                self.send_header(key, value)
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            self._respond(*api.handle("GET", self.path, None))

        def _with_body(self, method: str):
            length = int(self.headers.get("Content-Length") or 0)
            raw = self.rfile.read(length) if length else b"{}"
            try:
                body = json.loads(raw or b"{}")
            except json.JSONDecodeError as e:
                self._respond(400, {"detail": f"invalid JSON: {e}"})
                return
            self._respond(*api.handle(method, self.path, body))

        def do_POST(self):
            self._with_body("POST")

        def do_DELETE(self):
            self._with_body("DELETE")

        def log_message(self, fmt, *args):   # quiet by default
            pass

    return Handler


def make_server(engine: Engine, host: str = "127.0.0.1", port: int = 7860,
                flags: dict | None = None, realesrgan=(),
                interrogate_dirs: dict | None = None) -> ThreadingHTTPServer:
    """The bound server (port 0 picks a free one); run ``serve_forever()``.
    flags, realesrgan and interrogate_dirs: the Api's."""
    server = ThreadingHTTPServer((host, port), make_handler(
        Api(engine, flags, realesrgan, interrogate_dirs)))
    server.daemon_threads = True
    return server
