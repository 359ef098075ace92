"""img2img and inpainting — port of ``sdwebui_tpu/pipeline/img2img.py``.

Pipeline (``img2img.py:32-116,132-445``): init images flattened onto
``img2img_background_color`` (and saved under ``outdir_init_images`` with
``save_init_img``) → mask binarized (and inverted), blurred → with
``inpaint_full_res`` the image and mask cropped to the mask's box plus
``inpaint_full_res_padding``, widened to the request's aspect → init
images through ``resize_image`` (resize modes 0-3, ``upscaler_for_img2img``
for a leg that upscales; mode 3 resizes as mode 0, as JAX does), masks
through Pillow's default (bicubic) resize → ``inpainting_fill`` 0 fills the
repaint region with the surrounding colours (``masking.fill``) → VAE or
TAESD encode → fill 2 (latent noise) or 3 (latent nothing) → noise to σ₀
of the t_enc slice of the schedule (or ``init_noise_override``, plus
``img2img_extra_noise``) → sampling with the latent mask blend after every
denoise, or soft inpainting's σ-scheduled blend before it → the final
blend (not with soft inpainting) → decode → ``restore_faces`` → colour
correction against the init images → the original pasted back outside the blurred mask (into the
crop region with ``inpaint_full_res``) → the mask and the mask composite
when ``return_mask`` / ``return_mask_composite`` ask for them.  Extra
networks apply as in txt2img, and a ControlNet unit without an image of
its own takes the first init image (``img2img.py:317-323``).  Images are
uint8 numpy arrays throughout (``utils/images`` and ``utils/masking``
restate the Pillow operations).

Hybrid UNets get their image conditioning (``c_concat``,
``img2img.py:224-252``): instruct-pix2pix's init latent with its 3-way
CFG at ``image_cfg_scale``, the inpainting model's mask and masked-image
latent (SD1 and SDXL), SD2-depth's MiDaS depth.  SDXL runs as txt2img
does, its vector conds at the request's size; SD3 noises the init latent
by the flow's LERP, σ·noise + (1−σ)·x0; an unclip model's adm vector is
the first init image's noised ViT embedding.  What JAX's img2img does
not run raises ``NotImplementedError`` naming it: ``refiner_checkpoint``,
``inpainting_mask_weight`` other than 1.0, ControlNet units and soft
inpainting with instruct-pix2pix.  The always-on scripts' hooks fire as in
txt2img, with ``on_mask_blend`` once before sampling, and
``postprocess_maskoverlay`` and ``postprocess_image_after_composite`` around
the overlay (img2img.py:141-445).
"""

from __future__ import annotations

import hashlib
import os
from typing import Callable

import numpy as np
import torch

from sdwebui_tpu_torch.pipeline.params import GenerationParams, Processed
from sdwebui_tpu_torch.networks import extra_networks
from sdwebui_tpu_torch.models.midas import depth_conditioning
from sdwebui_tpu_torch.pipeline import sd_unet
from sdwebui_tpu_torch.pipeline.processing import (_apply_grid, _build_conds,
                                                   _check_slice, _prepare_units,
                                                   _reset_ti_usage, _resolve_seeds,
                                                   _skip_uncond_mask,
                                                   _strip_prompt_comments,
                                                   create_infotext, create_rng,
                                                   decode_first_stage_u8,
                                                   encode_first_stage,
                                                   check_family, check_hybrid,
                                                   apply_attention_options,
                                                   apply_schedule_overrides,
                                                   maybe_restore_faces,
                                                   postprocess_batch, prepare_sampler,
                                                   sample_latents, setup_img2img_steps,
                                                   uses_refiner, with_tiling)
from sdwebui_tpu_torch.pipeline.sd_model import SDModel, unclip_adm
from sdwebui_tpu_torch.rng.philox import PhiloxGenerator
from sdwebui_tpu_torch.sampling.sampler import prepare_noise
from sdwebui_tpu_torch.scripts.framework import (MaskBlendArgs, PostprocessImageArgs,
                                                 PostProcessMaskOverlayArgs, PostSampleArgs,
                                                 get_runner)
from sdwebui_tpu_torch.utils import color
from sdwebui_tpu_torch.utils import images as images_util
from sdwebui_tpu_torch.utils import masking
from sdwebui_tpu_torch.utils.options import opts
from sdwebui_tpu_torch.utils.png import encode_png


def _check_img2img(model: SDModel, p: GenerationParams) -> None:
    """Raise for the img2img fields and models the port does not run."""
    _check_slice(p)
    check_hybrid(model)
    check_family(model, p)
    if uses_refiner(p):
        raise NotImplementedError(
            f"refiner_checkpoint {p.refiner_checkpoint!r} on img2img is not ported (the JAX "
            "package's img2img reads no refiner)")
    if model.unet_cfg.in_channels == 8 and p.controlnet_units:
        raise NotImplementedError(
            "controlnet_units with an 8-channel (instruct-pix2pix) UNet are not ported (the "
            "JAX package's edit-model CFG passes no step to the units)")


def _save_init_image(p: GenerationParams, image: np.ndarray) -> None:
    """save_init_img (img2img.py:70-80): the flattened init image as
    ``<outdir_init_images>/<md5 of its RGB bytes>.png``; the hash goes to
    the infotext as "Init image hash"."""
    p.init_img_hash = hashlib.md5(image.tobytes()).hexdigest()
    outdir = opts.get("outdir_init_images", "outputs/init-images") or "outputs/init-images"
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, f"{p.init_img_hash}.png"), "wb") as f:
        f.write(encode_png(image))


def _prepare_images_and_mask(p: GenerationParams, device="cpu"):
    """Returns (images (N, H, W, 3) float32 in [0, 1], mask info dict)
    (``img2img.py:45-116``): "mask" the last image's mask at the request's
    size (None without a mask), "overlay_mask" the blurred mask at the
    init image's size, "crop_region" the inpaint-full-res box or None,
    "originals" the init images as RGB.  inpainting_fill 0's colour fill
    runs on `device`."""
    init_images = p.init_images if isinstance(p.init_images, list) else [p.init_images]
    mask_img = overlay_mask = crop_region = final_mask = None
    if p.mask is not None:
        mask_img = masking.binarize_mask(p.mask, invert=bool(p.inpainting_mask_invert))
        mask_img = masking.blur_mask(mask_img, p.mask_blur)
    bg = opts.get("img2img_background_color", "#ffffff") or "#ffffff"
    upscaler = opts.get("upscaler_for_img2img", "None")
    imgs, originals = [], []
    for im in init_images:
        a = images_util.as_hwc(im)
        flat = images_util.flatten(a, bg)
        if opts.get("save_init_img", False):
            _save_init_image(p, flat)
        if mask_img is not None and p.inpaint_full_res:
            ih, iw = flat.shape[:2]
            overlay_mask = images_util.resize(mask_img, (iw, ih))
            crop_region = masking.get_crop_region_v2(overlay_mask > 127,
                                                     p.inpaint_full_res_padding)
            crop_region = masking.expand_crop_region(crop_region, p.width, p.height, iw, ih)
            flat = images_util.crop(flat, crop_region)
            mask_use = images_util.crop(overlay_mask, crop_region)
        else:
            mask_use = overlay_mask = mask_img
        rgb = images_util.resize_image(p.resize_mode, flat, p.width, p.height,
                                       upscaler_name=upscaler)
        if mask_use is not None:
            mask_use = images_util.resize(mask_use, (p.width, p.height))
            if p.inpainting_fill == 0:     # fill with the surrounding colours
                rgb = images_util.composite(masking.fill(rgb, mask_use, device), rgb,
                                            masking.binarize_mask(mask_use))
        imgs.append(rgb.astype(np.float32) / 255.0)
        originals.append(images_util.to_rgb(a))
        final_mask = mask_use
    info = {"mask": final_mask, "overlay_mask": overlay_mask, "crop_region": crop_region,
            "originals": originals}
    return np.stack(imgs), info


def apply_overlay(img: np.ndarray, mask_info: dict, index: int) -> np.ndarray:
    """The original outside the blurred mask, the generated image inside it
    (``img2img.py:446-465``): with a crop region the image is resized to the
    region, composited under the region's overlay mask and pasted back into
    the original; else the original and the mask are resized (bicubic) to
    the image's size."""
    if mask_info.get("mask") is None:
        return img
    original = mask_info["originals"][min(index, len(mask_info["originals"]) - 1)]
    overlay_mask = mask_info["overlay_mask"]
    box = mask_info["crop_region"]
    if box is not None:
        x1, y1, x2, y2 = box
        img = images_util.resize(img, (x2 - x1, y2 - y1))
        region_mask = images_util.resize(images_util.crop(overlay_mask, box), (x2 - x1, y2 - y1))
        out = original.copy()
        return images_util.paste(out, images_util.composite(
            img, images_util.crop(original, box), region_mask), (x1, y1))
    size = (img.shape[1], img.shape[0])
    return images_util.composite(img, images_util.resize(original, size),
                                 images_util.resize(overlay_mask, size))


def image_conditioning(model: SDModel, p: GenerationParams, image_arr: np.ndarray,
                       init_latent, mask, nmask):
    """A hybrid UNet's c_concat for img2img (img2img.py:224-252), or None:
    instruct-pix2pix (8) the init latent unscaled; the inpainting model
    (9) [the latent mask, the latent of the image with its repaint region
    blanked] (zeros and the init latent without a mask); SD2-depth (5) the
    MiDaS depth of the init images on the latent grid."""
    n = model.unet_cfg.in_channels
    b, h, w = init_latent.shape[0], init_latent.shape[2], init_latent.shape[3]
    if n == 8:
        return init_latent / model.vae_cfg.scale_factor
    if n == 9:
        if nmask is None:
            return torch.cat([torch.zeros((b, 1, h, w), device=model.device), init_latent],
                             dim=1)
        full = images_util.resize(mask, (p.width, p.height))
        full = np.around(full.astype(np.float32) / 255.0)[None, :, :, None]
        masked = encode_first_stage(model, image_arr * (1.0 - full))
        return torch.cat([nmask.expand(b, 1, h, w), masked], dim=1)
    if n == 5:
        images = torch.from_numpy(np.ascontiguousarray(image_arr.transpose(0, 3, 1, 2)))
        return depth_conditioning(model.depth_model, images.to(model.device), h, w)
    return None


def _mask_outputs(mask_info: dict, pre_overlay: list) -> list:
    """return_mask / return_mask_composite (img2img.py:410-428): per image,
    the mask as RGB and the pre-overlay image's RGBa composite under it."""
    mask_l = mask_info["mask"]
    out = []
    for img in pre_overlay:
        if opts.get("return_mask", False):
            out.append(images_util.to_rgb(mask_l))
        if opts.get("return_mask_composite", False):
            size = (img.shape[1], img.shape[0])
            out.append(images_util.mask_composite(img, images_util.resize(mask_l, size)))
    return out


def process_img2img(model: SDModel, p: GenerationParams,
                    step_callback: Callable | None = None,
                    interrupted: Callable | None = None,
                    callback: Callable | None = None) -> Processed:
    """img2img with per-request override_settings applied and restored.
    ``step_callback(i, n, latents)`` returning False stops sampling;
    ``interrupted()`` true at the decode lets live_preview_fast_interrupt
    decode with the preview method; ``callback`` is txt2img's batch
    callback (img2img.py:257,430)."""
    with opts.override(p.override_settings):
        return _process_img2img(sd_unet.resolve(model), p, step_callback, interrupted,
                                callback)


@torch.inference_mode()
def _process_img2img(model: SDModel, p: GenerationParams,
                     step_callback: Callable | None,
                     interrupted: Callable | None,
                     callback: Callable | None = None) -> Processed:
    if not p.init_images:
        raise ValueError("img2img requires init_images")
    _check_img2img(model, p)
    # the always-on scripts' hooks fire where JAX fires them (img2img.py:141-445)
    runner = get_runner()
    runner.setup_scripts(p)
    runner.before_process(p)
    _reset_ti_usage(model)
    if p.denoising_strength is None:
        p.denoising_strength = 0.75
    _resolve_seeds(p)
    _strip_prompt_comments(p)
    clean_prompt, model, hypernet = extra_networks.activate(model, p.prompt)
    runner.after_extra_networks_activate(p)
    runner.process(p)
    model = with_tiling(model, p)
    model = apply_attention_options(model, "img2img")
    model = apply_schedule_overrides(model, p)
    h, w = p.latent_size()
    c = model.latent_channels

    image_arr, mask_info = _prepare_images_and_mask(p, model.device)
    corrections = None
    if opts.get("img2img_color_correction", False):
        corrections = [color.setup_color_correction(im) for im in mask_info["originals"]]
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

    # latent mask: mask = keep weight, nmask = repaint weight; soft
    # inpainting keeps the blurred mask's levels
    mask = nmask = None
    if mask_info["mask"] is not None:
        latmask = images_util.resize(mask_info["mask"], (w, h)).astype(np.float32) / 255.0
        if not p.soft_inpainting:
            latmask = np.around(latmask)
        nmask = torch.from_numpy(latmask).to(model.device)[None, None]
        mask = 1.0 - nmask
        if p.inpainting_fill == 2:     # latent noise in the repaint region
            fill_noise = np.stack([PhiloxGenerator(s).randn((c, h, w))
                                   for s in p.all_seeds[:init_latent.shape[0]]])
            init_latent = init_latent * mask + torch.from_numpy(fill_noise).to(
                model.device) * nmask
        elif p.inpainting_fill == 3:   # latent nothing
            init_latent = init_latent * mask
    soft = None
    if p.soft_inpainting and nmask is not None:
        soft = (float(p.mask_blend_power), float(p.mask_blend_scale),
                float(p.inpaint_detail_preservation))

    c_concat = image_conditioning(model, p, image_arr, init_latent, mask_info["mask"], nmask)

    # schedule: the last t_enc + 1 sigmas
    steps, t_enc = setup_img2img_steps(p.steps, p.denoising_strength)
    sampler, spec, sigmas_full, solver_extra = prepare_sampler(model, p, steps)
    sigma_sched = sigmas_full[steps - t_enc - 1:]
    extra_noise = float(opts.get("img2img_extra_noise", 0.0) or 0.0)
    init_images = p.init_images if isinstance(p.init_images, list) else [p.init_images]
    controls = _prepare_units(model, p, w * 8, h * 8, t_enc + 1, default_image=init_images[0])

    all_images, infotexts = [], []
    for n in range(p.n_iter):
        if callback is not None and callback("batch", n, None) is False:
            break
        lo = n * b
        seeds = p.all_seeds[lo: lo + b]
        subseeds = p.all_subseeds[lo: lo + b]
        runner.before_process_batch(p, batch_number=n, seeds=seeds)
        adm = None
        if model.is_unclip:    # the first init image's noised ViT embedding (img2img.py:265-270)
            adm = unclip_adm(model, images=mask_info["originals"], seed=p.all_seeds[0])
        sched = _build_conds(model, p, t_enc + 1, prompt=clean_prompt, adm_vector=adm)
        runner.process_batch(p, batch_number=n, seeds=seeds)
        runner.process_before_every_sampling(p, batch_number=n)
        sched.c_concat = c_concat
        if model.unet_cfg.in_channels == 8 and p.image_cfg_scale not in (None, 1.0):
            sched.image_cfg_scale = float(p.image_cfg_scale)
        rng = create_rng((c, h, w), seeds, model.device, subseeds=subseeds,
                         subseed_strength=p.subseed_strength)
        if p.init_noise_override is not None:
            x = torch.as_tensor(p.init_noise_override, dtype=torch.float32,
                                device=model.device)
        else:
            x = torch.as_tensor(rng.first(), device=model.device)
        if p.initial_noise_multiplier != 1.0:
            x = x * p.initial_noise_multiplier
        if model.disc.prediction_type == "flow":
            # rectified flow: x_t = σ·noise + (1−σ)·x0 (img2img.py:287-290)
            s0 = float(sigma_sched[0])
            xi = s0 * x + (1.0 - s0) * init_latent
        else:
            xi = init_latent + x * float(np.float32(sigma_sched[0]))
        if extra_noise > 0:
            # un-scheduled extra noise on top of the σ₀ injection (reference
            # sd_samplers_kdiffusion.py:145-150)
            p.extra_generation_params["Extra noise"] = extra_noise
            xi = xi + x * extra_noise
        sched.skip_uncond = _skip_uncond_mask(sigma_sched, p)
        noise = prepare_noise(spec, len(sigma_sched) - 1, rng, model.device)
        if nmask is not None:
            # the blend runs inside the CFG denoiser; the hook sees its
            # inputs once, as in JAX (img2img.py:333-337)
            runner.on_mask_blend(p, MaskBlendArgs(xi, nmask, init_latent, mask))
        latents = sample_latents(model, sched, xi, sigma_sched, noise, sampler.solver,
                                 solver_extra, step_callback=step_callback,
                                 mask=mask, nmask=nmask, init_latent=init_latent,
                                 hypernet=hypernet, controls=controls, soft_inpainting=soft)
        if mask is not None and soft is None:
            latents = latents * nmask + init_latent * mask
        runner.post_sample(p, PostSampleArgs(latents))
        images = list(decode_first_stage_u8(model, latents,
                                            bool(interrupted and interrupted())))
        images = postprocess_batch(runner, p, images, n)
        images = maybe_restore_faces(p, images, model.device)
        if corrections is not None:
            images = [color.apply_color_correction(corrections[min(i, len(corrections) - 1)],
                                                   img) for i, img in enumerate(images)]
        images = [runner.postprocess_image(p, img) for img in images]
        if mask_info["mask"] is not None:
            for i in range(len(images)):
                runner.postprocess_maskoverlay(p, PostProcessMaskOverlayArgs(
                    i, mask_info["overlay_mask"], mask_info["originals"]))
        pre_overlay = list(images)
        if opts.get("overlay_inpaint", True):
            images = [apply_overlay(img, mask_info, i) for i, img in enumerate(images)]
        for i in range(len(images)):
            after = PostprocessImageArgs(images[i], i)
            runner.postprocess_image_after_composite(p, after)
            images[i] = after.image
        infotexts.extend(create_infotext(p, model, lo + i) for i in range(len(images)))
        all_images.extend(images)
        if mask_info["mask"] is not None:
            extra = _mask_outputs(mask_info, pre_overlay)
            all_images.extend(extra)
            infotexts.extend([infotexts[-1]] * len(extra))
        if callback is not None:
            callback("batch_done", n, images)

    first_idx = _apply_grid(all_images, infotexts, p, model)
    res = Processed(
        images=all_images, params=p, seed=p.all_seeds[0], subseed=p.all_subseeds[0],
        infotexts=infotexts, all_seeds=p.all_seeds, all_subseeds=p.all_subseeds,
        all_prompts=p.all_prompts, width=p.width, height=p.height,
        index_of_first_image=first_idx,
        sd_model_name=(model.title or "").split(" [")[0],
        sd_model_hash=model.sha256[:10] if model.sha256 else "")
    runner.postprocess(p, res)
    return res
