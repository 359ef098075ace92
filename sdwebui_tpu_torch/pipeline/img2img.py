"""img2img and inpainting (SD1.x) — port of ``sdwebui_tpu/pipeline/img2img.py``.

Pipeline (``img2img.py:32-116,132-445``): init images flattened onto
``img2img_background_color`` → mask binarized (and inverted), blurred →
latent mask by a bicubic resize to the latent grid, rounded; init images
of another size than the request through ``resize_image`` (resize modes
0-2, ``upscaler_for_img2img`` for a leg that upscales), masks through
Pillow's default (bicubic) resize → VAE encode
(the mean, at the policy's ``vae_dtype``) → fill 2 (latent noise) or 3
(latent nothing) in the repaint region → noise to σ₀ of the t_enc slice of
the schedule (plus ``img2img_extra_noise``) → sampling with the latent mask
blend after every denoise → the final blend → decode → the original pasted
back outside the blurred mask.  Images are uint8 numpy arrays throughout
(``utils/images`` restates the Pillow operations).

Each request field or option outside this slice raises
``NotImplementedError`` naming it: resize mode 3, ``inpainting_fill`` 0,
``inpaint_full_res``, soft inpainting, UNets of other than 4 input
channels, colour correction, ControlNet and SDXL img2img.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from sdwebui_tpu_torch.pipeline.params import GenerationParams, Processed
from sdwebui_tpu_torch.pipeline.processing import (_apply_grid, _build_conds,
                                                   _check_slice, _resolve_seeds,
                                                   _skip_uncond_mask,
                                                   _strip_prompt_comments,
                                                   create_infotext, create_rng,
                                                   decode_first_stage_u8,
                                                   encode_first_stage,
                                                   prepare_sampler, sample_latents,
                                                   setup_img2img_steps)
from sdwebui_tpu_torch.pipeline.sd_model import SDModel
from sdwebui_tpu_torch.rng.philox import PhiloxGenerator
from sdwebui_tpu_torch.sampling.sampler import prepare_noise
from sdwebui_tpu_torch.utils import images as images_util
from sdwebui_tpu_torch.utils import masking
from sdwebui_tpu_torch.utils.options import opts

#: img2img options whose other values are not ported yet, with the value
#: the slice runs
UNPORTED_IMG2IMG_OPTIONS = {
    "img2img_color_correction": False,
    "save_init_img": False,
    "sd_vae_encode_method": "Full",
    "return_mask": False,
    "return_mask_composite": False,
}


def _check_img2img(model: SDModel, p: GenerationParams) -> None:
    """Raise for the img2img fields, options and models the slice does not run."""
    _check_slice(p)
    if model.is_sdxl:
        raise NotImplementedError("SDXL img2img is not ported yet")
    if model.unet_cfg.in_channels != 4:
        raise NotImplementedError(
            f"{model.unet_cfg.in_channels}-channel UNets (instruct-pix2pix, inpainting, "
            "depth) are not ported yet")
    if p.resize_mode not in (0, 1, 2):
        raise NotImplementedError(
            f"resize_mode {p.resize_mode} (just resize, latent upscale) of init images and "
            "masks is not ported yet (modes 0-2 resize with LANCZOS or upscaler_for_img2img)")
    fields = {
        "soft_inpainting": p.soft_inpainting,
        "init_noise_override": p.init_noise_override is not None,
        "inpaint_full_res": p.mask is not None and p.inpaint_full_res,
        "inpainting_fill 0 (fill with the surrounding colours)":
            p.mask is not None and p.inpainting_fill == 0,
    }
    for name, used in fields.items():
        if used:
            raise NotImplementedError(f"{name!r} is not ported yet")
    for name, value in UNPORTED_IMG2IMG_OPTIONS.items():
        if opts.get(name, value) != value:
            raise NotImplementedError(f"option {name!r} is not ported yet")


def _prepare_images_and_mask(p: GenerationParams):
    """Returns (images (N, H, W, 3) float32 in [0, 1], mask info dict):
    ``img2img.py:45-116`` without the inpaint-full-res crop.  The blurred
    mask keeps its own size for the overlay and is resized (bicubic) to the
    request's for the latent mask."""
    init_images = p.init_images if isinstance(p.init_images, list) else [p.init_images]
    overlay_mask = mask = None
    if p.mask is not None:
        overlay_mask = masking.binarize_mask(p.mask, invert=bool(p.inpainting_mask_invert))
        overlay_mask = masking.blur_mask(overlay_mask, p.mask_blur)
        mask = images_util.resize(overlay_mask, (p.width, p.height))
    bg = opts.get("img2img_background_color", "#ffffff") or "#ffffff"
    upscaler = opts.get("upscaler_for_img2img", "None")
    imgs, originals = [], []
    for im in init_images:
        a = images_util.as_hwc(im)
        rgb = images_util.resize_image(p.resize_mode, images_util.flatten(a, bg), p.width,
                                       p.height, upscaler_name=upscaler)
        imgs.append(rgb.astype(np.float32) / 255.0)
        originals.append(images_util.to_rgb(a))
    info = {"mask": mask, "overlay_mask": overlay_mask, "originals": originals}
    return np.stack(imgs), info


def apply_overlay(img: np.ndarray, mask_info: dict, index: int) -> np.ndarray:
    """The original outside the blurred mask, the generated image inside it,
    the original and the mask resized (bicubic) to the image's size
    (``img2img.py:446-465`` without the inpaint-full-res crop)."""
    if mask_info.get("mask") is None:
        return img
    size = (img.shape[1], img.shape[0])
    original = mask_info["originals"][min(index, len(mask_info["originals"]) - 1)]
    return images_util.composite(img, images_util.resize(original, size),
                                 images_util.resize(mask_info["overlay_mask"], size))


def process_img2img(model: SDModel, p: GenerationParams,
                    step_callback: Callable | None = None) -> Processed:
    """img2img with per-request override_settings applied and restored.
    ``step_callback(i, n, latents)`` returning False stops sampling."""
    with opts.override(p.override_settings):
        return _process_img2img(model, p, step_callback)


@torch.inference_mode()
def _process_img2img(model: SDModel, p: GenerationParams,
                     step_callback: Callable | None) -> Processed:
    if not p.init_images:
        raise ValueError("img2img requires init_images")
    _check_img2img(model, p)
    if p.denoising_strength is None:
        p.denoising_strength = 0.75
    _resolve_seeds(p)
    _strip_prompt_comments(p)
    h, w = p.latent_size()
    c = model.latent_channels

    image_arr, mask_info = _prepare_images_and_mask(p)
    if image_arr.shape[0] > p.batch_size:
        # multiple init images (API batch): the batch matches the image count
        p.batch_size = image_arr.shape[0]
        _resolve_seeds(p)
    b = p.batch_size
    if image_arr.shape[0] == 1 and b > 1:
        image_arr = np.repeat(image_arr, b, axis=0)
    if image_arr.shape[0] != b:
        raise ValueError(f"{image_arr.shape[0]} init images for batch_size {b}")

    init_latent = encode_first_stage(model, image_arr)

    # latent mask: mask = keep weight, nmask = repaint weight
    mask = nmask = None
    if mask_info["mask"] is not None:
        latmask = images_util.resize(mask_info["mask"], (w, h))
        latmask = np.around(latmask.astype(np.float32) / 255.0)
        nmask = torch.from_numpy(latmask).to(model.device)[None, None]
        mask = 1.0 - nmask
        if p.inpainting_fill == 2:     # latent noise in the repaint region
            fill_noise = np.stack([PhiloxGenerator(s).randn((c, h, w))
                                   for s in p.all_seeds[:init_latent.shape[0]]])
            init_latent = init_latent * mask + torch.from_numpy(fill_noise).to(
                model.device) * nmask
        elif p.inpainting_fill == 3:   # latent nothing
            init_latent = init_latent * mask

    # schedule: the last t_enc + 1 sigmas
    steps, t_enc = setup_img2img_steps(p.steps, p.denoising_strength)
    sampler, spec, sigmas_full, solver_extra = prepare_sampler(model, p, steps)
    sigma_sched = sigmas_full[steps - t_enc - 1:]
    extra_noise = float(opts.get("img2img_extra_noise", 0.0) or 0.0)

    all_images, infotexts = [], []
    for n in range(p.n_iter):
        lo = n * b
        seeds = p.all_seeds[lo: lo + b]
        subseeds = p.all_subseeds[lo: lo + b]
        sched = _build_conds(model, p, t_enc + 1)
        rng = create_rng((c, h, w), seeds, subseeds=subseeds,
                         subseed_strength=p.subseed_strength)
        x = torch.from_numpy(rng.first()).to(model.device)
        if p.initial_noise_multiplier != 1.0:
            x = x * p.initial_noise_multiplier
        xi = init_latent + x * float(np.float32(sigma_sched[0]))
        if extra_noise > 0:
            # un-scheduled extra noise on top of the σ₀ injection (reference
            # sd_samplers_kdiffusion.py:145-150)
            p.extra_generation_params["Extra noise"] = extra_noise
            xi = xi + x * extra_noise
        sched.skip_uncond = _skip_uncond_mask(sigma_sched, p)
        noise = prepare_noise(spec, len(sigma_sched) - 1, rng, model.device)
        latents = sample_latents(model, sched, xi, sigma_sched, noise, sampler.solver,
                                 solver_extra, step_callback=step_callback,
                                 mask=mask, nmask=nmask, init_latent=init_latent)
        if mask is not None:
            latents = latents * nmask + init_latent * mask
        images = list(decode_first_stage_u8(model, latents))
        if opts.get("overlay_inpaint", True):
            images = [apply_overlay(img, mask_info, i) for i, img in enumerate(images)]
        infotexts.extend(create_infotext(p, model, lo + i) for i in range(len(images)))
        all_images.extend(images)

    first_idx = _apply_grid(all_images, infotexts, p, model)
    return Processed(
        images=all_images, params=p, seed=p.all_seeds[0], subseed=p.all_subseeds[0],
        infotexts=infotexts, all_seeds=p.all_seeds, all_subseeds=p.all_subseeds,
        all_prompts=p.all_prompts, width=p.width, height=p.height,
        index_of_first_image=first_idx,
        sd_model_name=(model.title or "").split(" [")[0],
        sd_model_hash=model.sha256[:10] if model.sha256 else "")
