"""Generation parameters — the explicit pytree replacing the reference's
`StableDiffusionProcessing` grab-bag (modules/processing.py:136; design
stance SURVEY.md §7).  Field names mirror the reference's API schema so the
`/sdapi/v1` layer maps requests 1:1.

Copy of ``sdwebui_tpu/pipeline/params.py``."""

from __future__ import annotations

import dataclasses
from typing import Any, List


@dataclasses.dataclass
class GenerationParams:
    prompt: str = ""
    negative_prompt: str = ""
    styles: List[str] = dataclasses.field(default_factory=list)
    seed: int = -1
    subseed: int = -1
    subseed_strength: float = 0.0
    seed_resize_from_h: int = -1
    seed_resize_from_w: int = -1
    sampler_name: str = "Euler a"
    scheduler: str = "Automatic"
    batch_size: int = 1
    n_iter: int = 1
    steps: int = 20
    cfg_scale: float = 7.0
    width: int = 512
    height: int = 512
    restore_faces: bool = False
    tiling: bool = False
    eta: float | None = None
    s_min_uncond: float = 0.0
    s_churn: float = 0.0
    s_tmin: float = 0.0
    s_tmax: float = 0.0
    s_noise: float = 1.0
    clip_skip: int = 1
    do_not_save_samples: bool = False
    do_not_save_grid: bool = False
    outpath_grids: str | None = None  # reference processing.py:140
    override_settings: dict = dataclasses.field(default_factory=dict)
    # internal: pre-resolved hypernetwork (tree, meta) bypassing the
    # <hypernet:...> registry — used by training previews on the live net
    hypernet_override: Any = None

    # refiner (reference processing_scripts/refiner.py + apply_refiner)
    refiner_checkpoint: str = ""
    refiner_switch_at: float = 0.0

    # hires fix (txt2img)
    enable_hr: bool = False
    denoising_strength: float | None = None
    hr_scale: float = 2.0
    hr_upscaler: str = "Latent"
    hr_second_pass_steps: int = 0
    hr_resize_x: int = 0
    hr_resize_y: int = 0
    hr_sampler_name: str = ""
    hr_scheduler: str = ""
    hr_prompt: str = ""
    hr_negative_prompt: str = ""
    hr_cfg_scale: float = 0.0

    # img2img
    init_images: Any = None
    resize_mode: int = 0
    image_cfg_scale: float | None = None
    mask: Any = None
    mask_blur: int = 4
    inpainting_fill: int = 1
    inpaint_full_res: bool = False
    inpaint_full_res_padding: int = 0
    inpainting_mask_invert: int = 0
    initial_noise_multiplier: float = 1.0
    include_init_images: bool = False
    # soft inpainting (builtin extension parity)
    soft_inpainting: bool = False
    # scripts may inject a custom initial noise tensor (NHWC), e.g.
    # img2img-alternative's reverse-Euler reconstruction
    init_noise_override: object = None
    mask_blend_power: float = 1.0
    mask_blend_scale: float = 0.5
    inpaint_detail_preservation: float = 4.0

    # ControlNet units (pipeline/control.ControlNetUnit or dicts; mirrors the
    # sd-webui-controlnet extension's alwayson_scripts args)
    controlnet_units: List[Any] = dataclasses.field(default_factory=list)

    # main-UI postprocessing accordion (opts.postprocessing_enable_in_main_ui,
    # reference shared_options.py:413): Extras-style stage args + an
    # "enable" op list, applied per image by scripts/builtin.py's
    # always-on MainUIPostprocessing hook
    postprocessing: dict = dataclasses.field(default_factory=dict)

    # populated during processing
    all_prompts: List[str] = dataclasses.field(default_factory=list)
    all_negative_prompts: List[str] = dataclasses.field(default_factory=list)
    all_seeds: List[int] = dataclasses.field(default_factory=list)
    all_subseeds: List[int] = dataclasses.field(default_factory=list)
    batch_index: int = 0              # index within the current batch
    iteration: int = 0                # current n_iter loop index
    extra_generation_params: dict = dataclasses.field(default_factory=dict)
    # ^ script/extension infotext contributions (reference processing.py)
    job_timestamp: str = ""           # set at job start (filename patterns)
    user: str = ""                    # API auth user, if any
    sd_model_name: str = ""           # loaded checkpoint title
    sd_model_hash: str = ""           # loaded checkpoint short hash

    def latent_size(self):
        return self.height // 8, self.width // 8


@dataclasses.dataclass
class Processed:
    """Result bundle (reference modules/processing.py:516)."""

    images: list                      # PIL images
    params: GenerationParams
    seed: int
    subseed: int
    infotexts: List[str]
    all_seeds: List[int]
    all_subseeds: List[int]
    all_prompts: List[str]
    width: int = 0
    height: int = 0
    comments: str = ""
    # 1 when a grid image was prepended via opts.return_grid
    # (reference processing.py:1127)
    index_of_first_image: int = 0
    sd_model_name: str = ""
    sd_model_hash: str = ""

    @property
    def infotext(self) -> str:
        return self.infotexts[0] if self.infotexts else ""

    def js(self) -> dict:
        return {
            "prompt": self.params.prompt,
            "all_prompts": self.all_prompts,
            "negative_prompt": self.params.negative_prompt,
            "seed": self.seed,
            "all_seeds": self.all_seeds,
            "subseed": self.subseed,
            "all_subseeds": self.all_subseeds,
            "width": self.width,
            "height": self.height,
            "sampler_name": self.params.sampler_name,
            "cfg_scale": self.params.cfg_scale,
            "steps": self.params.steps,
            "batch_size": self.params.batch_size,
            "infotexts": self.infotexts,
            "index_of_first_image": self.index_of_first_image,
            "sd_model_name": self.sd_model_name,
            "sd_model_hash": self.sd_model_hash,
        }
