"""Typed runtime settings registry (reference modules/options.py +
modules/shared_options.py): `OptionInfo` entries grouped in sections, type
enforcement on assignment, onchange hooks, restriction flags, JSON
persistence, and the `/sdapi/v1/options` API surface.

Copy of ``sdwebui_tpu/utils/options.py``: the port's own ``opts``, with the
same keys and defaults, shared with no other package."""

from __future__ import annotations

import json
import os
from typing import Any, Callable


class OptionInfo:
    def __init__(self, default: Any, label: str, component: str | None = None,
                 component_args: dict | None = None,
                 onchange: Callable | None = None, section: tuple = (None, None),
                 restrict_api: bool = False, do_not_save: bool = False):
        self.default = default
        self.label = label
        self.component = component
        self.component_args = component_args or {}
        self.onchange = onchange
        self.section = section
        self.restrict_api = restrict_api
        self.do_not_save = do_not_save

    def info(self, text):  # fluent doc helper, parity with reference
        self.label += f" ({text})"
        return self


def options_section(section, entries: dict) -> dict:
    for v in entries.values():
        v.section = section
    return entries


class Options:
    def __init__(self, templates: dict[str, OptionInfo]):
        self.data_labels = templates
        self.data = {k: v.default for k, v in templates.items()}
        self.restricted_opts = {k for k, v in templates.items() if v.restrict_api}

    # attribute access ---------------------------------------------------

    def __getattr__(self, item):
        data = self.__dict__.get("data", {})
        if item in data:
            return data[item]
        raise AttributeError(item)

    def __setattr__(self, key, value):
        if key in ("data_labels", "data", "restricted_opts"):
            super().__setattr__(key, value)
            return
        if key in self.data:
            self.set(key, value)
            return
        super().__setattr__(key, value)

    # legacy/internal spellings → canonical reference option names
    ALIASES = {"emphasis_mode": "emphasis"}

    def get(self, key, default=None):
        return self.data.get(self.ALIASES.get(key, key), default)

    def override(self, settings: dict, restore: bool = True):
        """Context manager: apply per-request override_settings and restore
        afterwards (reference modules/processing.py:823-858 semantics)."""
        import contextlib

        @contextlib.contextmanager
        def _cm():
            saved = {}
            for k, v in (settings or {}).items():
                k = self.ALIASES.get(k, k)
                if k not in self.data:
                    continue
                saved[k] = self.data[k]
                try:
                    self.set(k, v)
                except Exception:
                    saved.pop(k, None)
            try:
                yield self
            finally:
                if restore:
                    for k, v in saved.items():
                        self.set(k, v)

        return _cm()

    def set(self, key, value, run_callbacks=True, is_api=False):
        key = self.ALIASES.get(key, key)
        if key not in self.data_labels:
            raise KeyError(f"unknown option {key}")
        info = self.data_labels[key]
        if is_api and info.restrict_api:
            raise PermissionError(f"option {key} cannot be set via API")
        default = info.default
        if default is not None and value is not None and \
                not isinstance(value, type(default)):
            # bool/int/float coercion with type enforcement
            if isinstance(default, bool):
                value = bool(value)
            elif isinstance(default, int) and isinstance(value, (int, float)):
                value = int(value)
            elif isinstance(default, float) and isinstance(value, (int, float)):
                value = float(value)
            elif isinstance(default, str):
                value = str(value)
            else:
                raise TypeError(f"bad type for option {key}: {type(value)}")
        changed = self.data.get(key) != value
        self.data[key] = value
        if changed and run_callbacks and info.onchange is not None:
            info.onchange()
        return changed

    # persistence --------------------------------------------------------

    def save(self, path: str):
        out = {k: v for k, v in self.data.items()
               if not self.data_labels[k].do_not_save}
        with open(path, "w", encoding="utf-8") as f:
            json.dump(out, f, indent=4)

    def load(self, path: str):
        if not os.path.exists(path):
            return
        with open(path, encoding="utf-8") as f:
            saved = json.load(f)
        for k, v in saved.items():
            if k in self.data_labels:
                self.data[k] = v

    def dumpjson(self) -> dict:
        return dict(self.data)


# ==========================================================================
# default option templates (representative subset of the reference's 282;
# grouped by the same section keys so /sdapi/v1/options is familiar)
# ==========================================================================

def make_default_templates() -> dict:
    t: dict[str, OptionInfo] = {}
    t.update(options_section(("saving-images", "Saving images/grids"), {
        "samples_save": OptionInfo(True, "Always save all generated images"),
        "samples_format": OptionInfo("png", "File format for images"),
        "grid_save": OptionInfo(True, "Always save all generated image grids"),
        "grid_format": OptionInfo("png", "File format for grids"),
        "grid_extended_filename": OptionInfo(False, "Add extended info (seed, prompt) to filename when saving grid"),
        "grid_only_if_multiple": OptionInfo(True, "Do not save grids consisting of one picture"),
        "grid_prevent_empty_spots": OptionInfo(False, "Prevent empty spots in grid (when set to autodetect)"),
        "n_rows": OptionInfo(-1, "Grid row count; use -1 for autodetect and 0 for it to be same as batch size"),
        "return_grid": OptionInfo(True, "Show grid in gallery"),
        "enable_pnginfo": OptionInfo(True, "Save infotext to metadata"),
        "outdir_samples": OptionInfo("", "Output directory for images; if empty, defaults to the per-kind directories below"),
        "outdir_grids": OptionInfo("", "Output directory for grids; if empty, defaults to the per-kind directories below"),
        "outdir_txt2img_samples": OptionInfo("outputs/txt2img-images", "txt2img output dir"),
        "outdir_img2img_samples": OptionInfo("outputs/img2img-images", "img2img output dir"),
        "outdir_extras_samples": OptionInfo("outputs/extras-images", "extras output dir"),
        "outdir_txt2img_grids": OptionInfo("outputs/txt2img-grids", "txt2img grids output dir"),
        "outdir_img2img_grids": OptionInfo("outputs/img2img-grids", "img2img grids output dir"),
        "outdir_save": OptionInfo("log/images", "Directory for saving images using the Save button"),
        "outdir_init_images": OptionInfo("outputs/init-images", "Directory for saving init images when using img2img"),
        "save_selected_only": OptionInfo(True, "When using 'Save' button, only save a single selected image"),
        "use_original_name_batch": OptionInfo(True, "Use original name for output filename during batch process in extras tab"),
        "save_incomplete_images": OptionInfo(False, "Save incomplete images (from interrupted/skipped jobs)"),
        "use_upscaler_name_as_suffix": OptionInfo(False, "Use upscaler name as filename suffix in the extras tab"),
        "save_write_log_csv": OptionInfo(True, "Write log.csv when saving images using 'Save' button"),
        "use_save_to_dirs_for_ui": OptionInfo(False, "When using 'Save' button, save images to a subdirectory"),
        "grid_zip_filename_pattern": OptionInfo("", "Archive filename pattern"),
        "save_init_img": OptionInfo(False, "Save init images when using img2img"),
        "img_max_size_mp": OptionInfo(200, "Maximum image size (in megapixels)"),
        "font": OptionInfo("", "Font for image grids that have text"),
        "grid_text_active_color": OptionInfo("#000000", "Text color for image grids"),
        "grid_text_inactive_color": OptionInfo("#999999", "Inactive text color for image grids"),
        "grid_background_color": OptionInfo("#ffffff", "Background color for image grids"),
        "samples_filename_pattern": OptionInfo("", "Images filename pattern"),
        "save_images_add_number": OptionInfo(True, "Add number to filename when saving"),
        "save_images_replace_action": OptionInfo("Replace", "Saving the image to an existing file"),
        "save_to_dirs": OptionInfo(True, "Save images to a subdirectory"),
        "grid_save_to_dirs": OptionInfo(True, "Save grids to a subdirectory"),
        "directories_filename_pattern": OptionInfo("[date]", "Directory name pattern"),
        "directories_max_prompt_words": OptionInfo(8, "Max prompt words for [prompt_words] pattern"),
        "jpeg_quality": OptionInfo(80, "Quality for saved jpeg and avif images"),
        "webp_lossless": OptionInfo(False, "Use lossless compression for webp images"),
        "export_for_4chan": OptionInfo(True, "Save copy of large images as JPG"),
        "img_downscale_threshold": OptionInfo(4.0, "File size limit for the above option, MB"),
        "target_side_length": OptionInfo(4000, "Width/height limit for the above option, in pixels"),
        "save_txt": OptionInfo(False, "Create a text file with infotext next to every generated image"),
        "save_images_before_face_restoration": OptionInfo(False, "Save a copy of image before doing face restoration."),
        "save_images_before_highres_fix": OptionInfo(False, "Save a copy of image before applying highres fix."),
        "save_images_before_color_correction": OptionInfo(False, "Save a copy of image before applying color correction to img2img results"),
        "save_mask": OptionInfo(False, "For inpainting, save a copy of the greyscale mask"),
        "save_mask_composite": OptionInfo(False, "For inpainting, save a masked composite"),
    }))
    t.update(options_section(("sd", "Stable Diffusion"), {
        "sd_model_checkpoint": OptionInfo(None, "Stable Diffusion checkpoint", "dropdown"),
        "sd_checkpoints_limit": OptionInfo(1, "Maximum number of loaded checkpoints"),
        "list_hidden_files": OptionInfo(True, "Load models/files in hidden directories"),
        "sd_checkpoint_cache": OptionInfo(0, "Checkpoints to cache in RAM (state dicts; skips file re-read on switch)"),
        "sd_vae_checkpoint_cache": OptionInfo(0, "VAE Checkpoints to cache in RAM"),
        "disable_mmap_load_safetensors": OptionInfo(False, "Disable memmapping for loading .safetensors files (read eagerly; helps on network filesystems)"),
        "restore_config_state_file": OptionInfo("", "Config state file to restore from (applied once at next server start)"),
        "sd_vae": OptionInfo("Automatic", "SD VAE"),
        "sd_vae_overrides_per_model_preferences": OptionInfo(True, "Selected VAE overrides per-model preferences (off: a .vae file beside the checkpoint wins)"),
        "sd_vae_encode_method": OptionInfo(
            "Full", "VAE type for encode",
            component_args={"choices": ["Full", "TAESD"]}),
        "sd_vae_decode_method": OptionInfo(
            "Full", "VAE type for decode",
            component_args={"choices": ["Full", "TAESD"]}),
        "sd3_enable_t5": OptionInfo(False, "Enable T5 text encoder for SD3"),
        "interrogate_keep_models_in_memory": OptionInfo(False, "Keep interrogation models in memory"),
        "interrogate_deepbooru_score_threshold": OptionInfo(0.5, "deepbooru: score threshold"),
        "deepbooru_sort_alpha": OptionInfo(True, "deepbooru: sort tags alphabetically"),
        "deepbooru_use_spaces": OptionInfo(True, "deepbooru: use spaces in tags"),
        "deepbooru_escape": OptionInfo(True, "deepbooru: escape (\\) brackets"),
        "deepbooru_filter_tags": OptionInfo("", "deepbooru: filter out those tags"),
        "interrogate_return_ranks": OptionInfo(False, "Include ranks of model tags matches in results"),
        "interrogate_clip_num_beams": OptionInfo(1, "BLIP: num_beams"),
        "interrogate_clip_min_length": OptionInfo(24, "BLIP: minimum description length"),
        "interrogate_clip_max_length": OptionInfo(48, "BLIP: maximum description length"),
        "interrogate_clip_dict_limit": OptionInfo(1500, "CLIP: maximum number of lines in text file"),
        "interrogate_clip_skip_categories": OptionInfo([], "CLIP: skip inquire categories"),
        "auto_backcompat": OptionInfo(True, "Automatic backward compatibility for old infotexts"),
        "sdtpu_vae_bf16": OptionInfo(True, "Decode VAE in bfloat16 (fp32 retry on NaN, like the reference's fp16 VAE + no-half-vae fallback)"),
        "sdtpu_overlap_decode_fetch": OptionInfo(True, "Overlap per-image VAE decode with host image fetch (multi-image batches; hides most of the transfer time)"),
        "persistent_cond_cache": OptionInfo(True, "Persistent cond cache (re-encoding identical prompts across jobs is skipped)"),
        "auto_vae_precision": OptionInfo(True, "Automatically revert VAE to 32-bit floats (retry bf16-NaN decodes in fp32)"),
        "upcast_attn": OptionInfo(False, "Upcast cross attention layer to float32 (scores/softmax are always fp32 on TPU; this additionally upcasts QKV/PV)"),
        "sd_hypernetwork": OptionInfo("None", "Add hypernetwork to prompt"),
        "enable_console_prompts": OptionInfo(False, "Print prompts to console when generating with txt2img and img2img"),
        "samples_log_stdout": OptionInfo(False, "Always print all generation info to standard output"),
        "textual_inversion_print_at_load": OptionInfo(False, "Print a list of Textual Inversion embeddings when loading"),
        "print_hypernet_extra": OptionInfo(False, "Print extra hypernetwork information to console"),
        "dump_stacks_on_signal": OptionInfo(False, "Print stack traces before exiting the program with ctrl+c"),
        "profiling_enable": OptionInfo(False, "Enable profiling (jax profiler trace per generation; view in Perfetto)"),
        "profiling_filename": OptionInfo("profile-traces/trace", "Profile output location"),
        "ddim_discretize": OptionInfo(
            "uniform", "img2img DDIM discretize",
            component_args={"choices": ["uniform", "quad"]}),
        "interrupt_after_current": OptionInfo(True, "Don't Interrupt in the middle (stop after the current image)"),
        "extra_networks_default_multiplier": OptionInfo(1.0, "Default multiplier for extra networks"),
        "extra_networks_card_width": OptionInfo(0, "Card width for Extra Networks (px, 0 = auto)"),
        "extra_networks_card_height": OptionInfo(0, "Card height for Extra Networks (px, 0 = auto)"),
        "extra_networks_card_text_scale": OptionInfo(1.0, "Card text scale"),
        "extra_networks_card_show_desc": OptionInfo(True, "Show description on card"),
        "extra_networks_add_text_separator": OptionInfo(" ", "Extra networks separator (added between the prompt and the inserted tag)"),
        "sdtpu_async_save": OptionInfo(True, "Write images to disk on a background thread (responses carry in-memory images; flush on shutdown)"),
        "sdtpu_png_compress_level": OptionInfo(1, "PNG compression level 0-9 (1 halves encode time vs PIL's default 6 at ~equal size)"),
        "sd_checkpoints_limit": OptionInfo(1, "Maximum number of checkpoints loaded at the same time"),
        "CLIP_stop_at_last_layers": OptionInfo(1, "Clip skip"),
        "enable_emphasis": OptionInfo(True, "Enable emphasis"),
        "enable_prompt_comments": OptionInfo(True, "Enable comments (# lines stripped from prompts)"),
        "emphasis": OptionInfo(
            "Original", "Emphasis mode",
            component_args={"choices": ["None", "Ignore", "Original", "No norm"]}),
        "comma_padding_backtrack": OptionInfo(20, "Prompt word wrap length limit"),
        # NV reproduces NVIDIA-GPU reference images; CPU reproduces
        # reference CPU images (torch stream); TPU generates the Philox
        # stream on device — no host transfer, the analog of the
        # reference's default GPU source ("GPU" aliases it)
        "randn_source": OptionInfo(
            "NV", "Random number generator source",
            component_args={"choices": ["NV", "CPU", "TPU", "GPU"]}),
        "tiling": OptionInfo(False, "Tiling"),
    }))
    t.update(options_section(("sampler-params", "Sampler parameters"), {
        "hide_samplers": OptionInfo([], "Hide samplers in user interface"),
        "eta_ancestral": OptionInfo(1.0, "Eta for k-diffusion samplers"),
        "enable_quantization": OptionInfo(False, "Enable quantization in K samplers for sharper and cleaner results. This may change existing seeds"),
        "eta_ddim": OptionInfo(0.0, "Eta for DDIM"),
        "eta_noise_seed_delta": OptionInfo(0, "Eta noise seed delta (ENSD)"),
        "s_churn": OptionInfo(0.0, "sigma churn"),
        "s_tmin": OptionInfo(0.0, "sigma tmin"),
        "s_tmax": OptionInfo(0.0, "sigma tmax"),
        "s_noise": OptionInfo(1.0, "sigma noise"),
        "sigma_min": OptionInfo(0.0, "sigma min"),
        "sigma_max": OptionInfo(0.0, "sigma max"),
        "rho": OptionInfo(0.0, "rho"),
        "always_discard_next_to_last_sigma": OptionInfo(
            False, "Always discard next-to-last sigma"),
        "sgm_noise_multiplier": OptionInfo(False, "SGM noise multiplier"),
        "sd_noise_schedule": OptionInfo(
            "Default", "Noise schedule for sampling",
            component_args={"choices": ["Default", "Zero Terminal SNR"]}),
        "skip_early_cond": OptionInfo(
            0.0, "Ignore negative prompt during early sampling"),
        "uni_pc_variant": OptionInfo(
            "bh1", "UniPC variant", component_args={"choices": ["bh1", "bh2"]}),
        "uni_pc_skip_type": OptionInfo(
            "time_uniform", "UniPC skip type",
            component_args={"choices": ["time_uniform", "time_quadratic",
                                        "logSNR"]}),
        "uni_pc_order": OptionInfo(3, "UniPC order"),
        "uni_pc_lower_order_final": OptionInfo(True, "UniPC lower order final"),
        "beta_dist_alpha": OptionInfo(0.6, "Beta scheduler alpha"),
        "beta_dist_beta": OptionInfo(0.6, "Beta scheduler beta"),
    }))
    t.update(options_section(("compatibility", "Compatibility"), {
        "use_old_scheduling": OptionInfo(False, "Use old prompt editing timelines (hires schedule numbers do not continue past the first pass)"),
        "use_old_hires_fix_width_height": OptionInfo(False, "For hires fix, use width/height sliders to set final resolution rather than first pass"),
        "hires_fix_use_firstpass_conds": OptionInfo(False, "For hires fix, calculate conds of second pass using extra networks of first pass"),
        "hires_fix_show_sampler": OptionInfo(False, "Hires fix: show hires checkpoint and sampler selection"),
        "hires_fix_show_prompts": OptionInfo(False, "Hires fix: show hires prompt and negative prompt"),
        "refiner_switch_by_sample_steps": OptionInfo(False, "Switch to refiner by sampling steps instead of model timesteps (old behavior)"),
        "use_old_karras_scheduler_sigmas": OptionInfo(
            False, "Use old karras scheduler sigmas (0.1 to 10)."),
        "use_downcasted_alpha_bar": OptionInfo(
            False, "Downcast model alphas_cumprod to fp16 before sampling. "
                   "For reproducing old seeds."),
    }))
    t.update(options_section(("sdxl", "Stable Diffusion XL"), {
        "sdxl_clip_l_skip": OptionInfo(False, "Clip skip SDXL (apply Clip skip to the CLIP-L encoder too)"),
        "hires_fix_refiner_pass": OptionInfo(
            "second pass", "Hires fix: which pass to enable refiner for",
            component_args={"choices": ["first pass", "second pass", "both passes"]}),
        "sdxl_crop_top": OptionInfo(0, "crop top coordinate"),
        "sdxl_crop_left": OptionInfo(0, "crop left coordinate"),
        "sdxl_refiner_low_aesthetic_score": OptionInfo(
            2.5, "SDXL low aesthetic score"),
        "sdxl_refiner_high_aesthetic_score": OptionInfo(
            6.0, "SDXL high aesthetic score"),
    }))
    t.update(options_section(("infotext", "Infotext"), {
        "add_model_name_to_info": OptionInfo(True, "Add model name to infotext"),
        "add_model_hash_to_info": OptionInfo(True, "Add model hash to infotext"),
        "add_vae_name_to_info": OptionInfo(True, "Add VAE name to infotext"),
        "add_vae_hash_to_info": OptionInfo(True, "Add VAE hash to infotext"),
        "add_version_to_infotext": OptionInfo(True, "Add program version to infotext"),
        "infotext_styles": OptionInfo(
            "Apply if any", "Infer styles from prompts of pasted infotext",
            component_args={"choices": ["Ignore", "Apply", "Discard", "Apply if any"]}),
        "infotext_skip_pasting": OptionInfo([], "Disregard fields from pasted infotext"),
        "disable_weights_auto_swap": OptionInfo(True, "Disregard checkpoint information from pasted infotext"),
        "add_user_name_to_info": OptionInfo(False, "Add user name to infotext when authenticated"),
        "textual_inversion_add_hashes_to_infotext": OptionInfo(True, "Add textual inversion hashes to infotext"),
    }))
    t.update(options_section(("img2img", "img2img"), {
        "inpainting_mask_weight": OptionInfo(1.0, "Inpainting conditioning mask strength"),
        "initial_noise_multiplier": OptionInfo(1.0, "Noise multiplier for img2img"),
        "img2img_extra_noise": OptionInfo(
            0.0, "Extra noise multiplier for img2img and hires fix"),
        "img2img_fix_steps": OptionInfo(False, "With img2img, do exactly the amount of steps specified"),
        "img2img_color_correction": OptionInfo(False, "Apply color correction"),
        "img2img_background_color": OptionInfo(
            "#ffffff", "With img2img, fill transparent parts of the input image with this color."),
        "return_mask": OptionInfo(
            False, "For inpainting, include the greyscale mask in results for web"),
        "return_mask_composite": OptionInfo(
            False, "For inpainting, include masked composite in results for web"),
        "overlay_inpaint": OptionInfo(True, "Overlay original for inpaint"),
        "img2img_editor_height": OptionInfo(720, "Height of the image editor"),
        "img2img_sketch_default_brush_color": OptionInfo("#ffffff", "Sketch initial brush color"),
        "img2img_inpaint_mask_brush_color": OptionInfo("#ffffff", "Inpaint mask brush color"),
        "img2img_inpaint_sketch_default_brush_color": OptionInfo("#ffffff", "Inpaint sketch initial brush color"),
        "img2img_batch_show_results_limit": OptionInfo(32, "Show the first N batch img2img results in UI (0: disable, -1: show all)"),
    }))
    t.update(options_section(("extensions", "Extensions"), {
        "disabled_extensions": OptionInfo([], "Disable these extensions"),
        "disable_all_extensions": OptionInfo("none", "Disable all extensions (preserves the list of disabled extensions)"),
        "enable_extension_scripts": OptionInfo(False, "Execute python scripts shipped by extensions"),
    }))
    t.update(options_section(("optimizations", "Optimizations"), {
        "cross_attention_optimization": OptionInfo("Automatic", "Cross attention optimization",
                                                   component_args={"choices": ["Automatic", "flash", "xla"]}),
        "s_min_uncond": OptionInfo(0.0, "Negative Guidance minimum sigma"),
        "s_min_uncond_all": OptionInfo(
            False, "Negative Guidance minimum sigma all steps"),
        "batch_cond_uncond": OptionInfo(True, "Batch cond/uncond"),
    }))
    t.update(options_section(("upscaling", "Upscaling"), {
        "upscaler_for_img2img": OptionInfo("None", "Upscaler for img2img"),
        "ESRGAN_tile": OptionInfo(192, "Tile size for ESRGAN upscalers (0 = no tiling)"),
        "ESRGAN_tile_overlap": OptionInfo(8, "Tile overlap for ESRGAN upscalers"),
        "DAT_tile": OptionInfo(192, "Tile size for DAT upscalers (0 = no tiling)"),
        "DAT_tile_overlap": OptionInfo(8, "Tile overlap for DAT upscalers"),
        "postprocessing_operation_order": OptionInfo([], "Postprocessing operation order (names run first, in this order)"),
        "postprocessing_disable_in_extras": OptionInfo([], "Disable these postprocessing operations in the extras tab"),
        "upscaling_max_images_in_cache": OptionInfo(5, "Maximum number of images in upscaling cache"),
        "SCUNET_tile": OptionInfo(256, "Tile size for SCUNET upscalers"),
        "SCUNET_tile_overlap": OptionInfo(8, "Tile overlap for SCUNET upscalers"),
        "ldsr_steps": OptionInfo(100, "LDSR processing steps"),
        "SWIN_tile": OptionInfo(192, "Tile size for all SwinIR"),
        "SWIN_tile_overlap": OptionInfo(8, "Tile overlap for SwinIR"),
    }))
    t.update(options_section(("hypertile", "Hypertile"), {
        "hypertile_enable_unet": OptionInfo(False, "Enable Hypertile U-Net"),
        "hypertile_max_tile_unet": OptionInfo(256, "Hypertile U-Net max tile size"),
    }))
    t.update(options_section(("optimizations", "Optimizations"), {
        "token_merging_ratio": OptionInfo(0.0, "Token merging ratio"),
        "token_merging_ratio_img2img": OptionInfo(0.0, "Token merging ratio for img2img"),
        "token_merging_ratio_hr": OptionInfo(0.0, "Token merging ratio for high-res pass"),
        # fp8 weight residency (reference shared_options fp8_storage /
        # cache_fp16_weight): UNet conv/linear weights stored float8_e4m3fn
        # in HBM, upcast to bf16 inside jit (server/app.py
        # _apply_fp8_storage, pipeline/sd_model.py quantize_unet_fp8)
        "fp8_storage": OptionInfo(
            "Disable", "FP8 weight",
            component_args={"choices": ["Disable", "Enable for SDXL",
                                        "Enable"]}),
        "cache_fp16_weight": OptionInfo(
            False, "Cache FP16 weight for LoRA (keep high-precision host "
                   "copies of fp8-quantized weights as the merge base)"),
    }))
    t.update(options_section(("face-restoration", "Face restoration"), {
        "face_restoration": OptionInfo(False, "Restore faces"),
        "face_restoration_model": OptionInfo("CodeFormer", "Face restoration model",
                                             component_args={"choices": ["CodeFormer", "GFPGAN"]}),
        "code_former_weight": OptionInfo(0.5, "CodeFormer weight (0 = max effect, 1 = max fidelity)"),
        "face_restoration_unload": OptionInfo(False, "Move face restoration model from VRAM into RAM after processing"),
    }))
    t.update(options_section(("live-previews", "Live previews"), {
        "show_progress_every_n_steps": OptionInfo(10, "Live preview display period"),
        "live_previews_enable": OptionInfo(True, "Show live previews"),
        "live_preview_content": OptionInfo("Prompt", "Live preview subject"),
        "show_progress_grid": OptionInfo(
            True, "Show previews of all images generated in a batch as a grid"),
        "show_progress_type": OptionInfo(
            "Approx NN", "Live preview method",
            component_args={"choices": ["Full", "Approx NN", "Approx cheap", "TAESD"]}),
        "live_preview_fast_interrupt": OptionInfo(
            False, "Return image with chosen live preview method on interrupt"),
        "live_previews_image_format": OptionInfo(
            "png", "Live preview file format",
            component_args={"choices": ["png", "jpeg", "webp"]}),
        "live_preview_refresh_period": OptionInfo(1000, "Progressbar and preview update period (ms)"),
    }))
    t.update(options_section(("ui", "User interface"), {
        "localization": OptionInfo("None", "Localization"),
        "quicksettings_list": OptionInfo(["sd_model_checkpoint"], "Quicksettings list (setting entries that appear at the top of page)"),
        "hidden_tabs": OptionInfo([], "Hidden UI tabs"),
        "ui_tab_order": OptionInfo([], "UI tab order"),
        "gallery_height": OptionInfo("", "Gallery height (e.g. 800px)"),
        "disable_token_counters": OptionInfo(False, "Disable prompt token counters"),
        "show_progress_in_title": OptionInfo(True, "Show generation progress in window title"),
        "show_progressbar": OptionInfo(True, "Show progressbar"),
        "keyedit_precision_attention": OptionInfo(0.1, "Precision for (attention:1.1) when editing the prompt with Ctrl+up/down"),
        "do_not_show_images": OptionInfo(False, "Do not show any images in gallery results"),
        "keyedit_delimiters": OptionInfo(".,\\/!?%^*;:{}=`~()", "Word delimiters when editing the prompt with Ctrl+up/down"),
        "keyedit_move": OptionInfo(True, "Alt+left/right moves prompt elements"),
        "notification_audio": OptionInfo(True, "Play notification sound after image generation"),
        "notification_volume": OptionInfo(100, "Notification sound volume"),
        "send_size": OptionInfo(True, "Send size when sending prompt or image to another interface"),
        "include_styles_into_token_counters": OptionInfo(True, "Count tokens of enabled styles"),
        "prevent_screen_sleep_during_generation": OptionInfo(True, "Prevent screen sleep during generation"),
        "extra_networks_card_order_field": OptionInfo(
            "Name", "Default order field for Extra Networks cards",
            component_args={"choices": ["Name", "Date Created"]}),
        "extra_networks_card_order": OptionInfo(
            "Ascending", "Default order for Extra Networks cards",
            component_args={"choices": ["Ascending", "Descending"]}),
        "send_seed": OptionInfo(True, "Send seed when sending prompt or image to other interface"),
    }))
    t.update(options_section(("training", "Training"), {
        "dataset_filename_word_regex": OptionInfo("", "Filename word regex"),
        "dataset_filename_join_string": OptionInfo(" ", "Filename join string"),
        "save_optimizer_state": OptionInfo(False, "Saves Optimizer state as separate *.optim file, so training can resume with Adam moments intact"),
        "save_training_settings_to_txt": OptionInfo(True, "Save textual inversion and hypernet settings to a text file whenever training starts"),
        "training_write_csv_every": OptionInfo(500, "Save an csv containing the loss to log directory every N steps, 0 to disable"),
        "postprocessing_existing_caption_action": OptionInfo(
            "ignore", "Action for existing captions during preprocessing",
            component_args={"choices": ["ignore", "copy", "prepend", "append"]}),
    }))
    t.update(options_section(("api", "API"), {
        "api_enable_requests": OptionInfo(True, "Allow http:// and https:// URLs for input images", restrict_api=True),
        "api_forbid_local_requests": OptionInfo(True, "Forbid URLs to local resources", restrict_api=True),
    }))
    # settings-in-UI (reference extensions-builtin/extra-options-section):
    # the chosen option names render as inline generation-page controls whose
    # values ride each request as override_settings (webui.html
    # renderExtraOptions / extraOptionOverrides)
    t.update(options_section(("settings_in_ui", "Settings in UI"), {
        "extra_options_txt2img": OptionInfo(
            [], "Settings for txt2img: options appearing in the txt2img "
                "interface"),
        "extra_options_img2img": OptionInfo(
            [], "Settings for img2img: options appearing in the img2img "
                "interface"),
        "extra_options_cols": OptionInfo(
            0, "Number of columns for added settings"),
        "extra_options_accordion": OptionInfo(
            False, "Place added settings into an accordion"),
    }))

    # the rest of the reference's 282-option surface (names/defaults/labels
    # mirror modules/shared_options.py; see utils/options_reference.py)
    from sdwebui_tpu_torch.utils.options_reference import REFERENCE_OPTIONS

    for section, entries in REFERENCE_OPTIONS:
        extra = {name: OptionInfo(default, label)
                 for name, default, label, _why in entries if name not in t}
        t.update(options_section(section, extra))
    return t


opts = Options(make_default_templates())
