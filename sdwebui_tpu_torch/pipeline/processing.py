"""txt2img orchestration — the txt2img half of ``sdwebui_tpu/pipeline/processing.py``,
with hires fix, plus the VAE encode that img2img (``pipeline/img2img.py``)
builds on.

Host side: seeds, prompt schedules, infotext.  Device side: a Python step
loop of batched CFG UNet calls (cond + uncond in one call), for SDXL
handed from the base to the refiner at the switch-point sigma, and a VAE
decode to uint8 with an fp32 retry on NaN.  Hires fix (``enable_hr``,
processing.py:601-777) upscales the first pass's latents — in latent space
(``LATENT_UPSCALE_MODES``), or decoded, through an upscaler of
``postprocessing/upscalers`` and encoded again — and samples the last
t_enc + 1 steps of a second schedule at the target size.  Extra networks
(``<lora:...>``, ``<hypernet:...>``, textual-inversion triggers) and
ControlNet units (``pipeline/control.py``) apply to every pass of the base
model.  A hybrid UNet (the inpainting models' 9 channels, SD2-depth's 5)
gets its fixed image conditioning (``c_concat``, processing.py:1386-1399),
an unclip model its zero adm vector.  SD3's rectified flow runs the MMDiT
on the raw latent at t = σ·1000 and noises by the LERP σ·noise + (1−σ)·x
(processing.py:153-159,733-735).
``restore_faces`` runs the face restorer (``postprocessing/faces``) on each
decoded image.  Images leave as uint8 HWC numpy arrays.  Given an
``outdir``, the samples are saved there (``utils/saving.save_image``,
processing.py:829-891,1482-1520), with the ``-before-highres-fix`` and
``-before-face-restoration`` copies their options ask for, and the grid
under ``p.outpath_grids``.  Options and request
fields outside the slice raise ``NotImplementedError`` naming them;
nothing falls back to a different computation.

The always-on scripts' hooks (``scripts/framework``) fire where JAX fires
them, ``postprocess_image`` after face restoration and before the
infotext and the grid; ``opts.sd_unet`` picks the model bundle of a
registered UNet provider (``pipeline/sd_unet``) before the job starts.
``invert_noise`` is img2img alternative's reverse-Euler inversion
(processing.py:1150-1195).

On a mesh (``parallel/mesh``: the bundle's own runtime from
``SDModel.replicate``, else the process's) :func:`sample_latents` runs
the CFG denoiser per data shard when the batch divides the data axis
(processing.py:407-415): x, the image conds, the masks and the init
latent split along the batch, and each shard's UNet (tensor-parallel over
its model group when the model axis is > 1) runs on its replica, one
shard after another (``collectives.Group.map``).  The solver's
arithmetic stays on the whole batch on the bundle's device, so the step
callback, /progress, interrupt and skip see each step once with every
image, and a solver whose step reads the whole batch (DPM adaptive's
error norm) keeps its one-device result; JAX partitions that arithmetic as well, to the same
values.  The decode splits the batch the same way; a big single image
that the batch cannot split decodes row-sharded
(:func:`_spatial_decode_if_beneficial`, processing.py:499-513).
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import math
import os
import random
import weakref
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from sdwebui_tpu_torch import __version__
from sdwebui_tpu_torch.models import vae_approx
from sdwebui_tpu_torch.models.unet import AttentionOptions
from sdwebui_tpu_torch.networks import extra_networks
from sdwebui_tpu_torch.parallel.mesh import data_group, on_device, runtime_for
from sdwebui_tpu_torch.parallel.spatial import decode_spatial
from sdwebui_tpu_torch.pipeline import sd_unet
from sdwebui_tpu_torch.pipeline.control import control_residuals, prepare_controls
from sdwebui_tpu_torch.pipeline.params import GenerationParams, Processed
from sdwebui_tpu_torch.postprocessing import faces, upscalers
from sdwebui_tpu_torch.pipeline.sd_model import (SDModel, sdxl_vector_maker, shard_bundles,
                                                 unclip_adm)
from sdwebui_tpu_torch.rng import image_rng
from sdwebui_tpu_torch.sampling.cfg import CondSchedule, make_cfg_denoiser
from sdwebui_tpu_torch.sampling.discretization import (Discretization,
                                                       rescale_zero_terminal_snr_abar)
from sdwebui_tpu_torch.sampling.registry import SamplerData, build_sigmas, get_sampler
from sdwebui_tpu_torch.sampling.sampler import prepare_noise, sample
from sdwebui_tpu_torch.sampling.solvers import get_solver
from sdwebui_tpu_torch.scripts import framework
from sdwebui_tpu_torch.scripts.framework import (PostprocessBatchListArgs, PostSampleArgs,
                                                 get_runner)
from sdwebui_tpu_torch.text.conditioner import build_cond_schedule
from sdwebui_tpu_torch.text.prompt_parser import strip_comments
from sdwebui_tpu_torch.utils import devices
from sdwebui_tpu_torch.utils import infotext as infotext_util
from sdwebui_tpu_torch.utils import saving
from sdwebui_tpu_torch.utils.options import opts

log = logging.getLogger(__name__)

MAX_SEED = 2 ** 32 - 1

def check_family(model: SDModel, p: GenerationParams,
                 refiner_model: SDModel | None = None) -> None:
    """Raise for the requests the JAX package has no correct form of with
    the SD3 and unclip models (ROADMAP queue C): with SD3 a LoRA (merged
    into UNet keys only), a hypernetwork or ControlNet units (its flow
    denoiser, processing.py:153-159, drops both), tiling (no field of the
    MMDiT's config) and LCM (no ᾱ table to distil); soft inpainting with
    rectified flow (its blend assumes x = x0 + σ·noise); hires fix with an
    unclip model (its hires pass builds no adm vector); and a refiner
    unless base and refiner are SDXL."""
    if model.is_sd3:
        kinds = {n.kind for n in extra_networks.parse_prompt(p.prompt)[1]}
        if p.hr_prompt:
            kinds |= {n.kind for n in extra_networks.parse_prompt(p.hr_prompt)[1]}
        if kinds & {"lora", "lyco"}:
            raise NotImplementedError("<lora:...> tags with an SD3 model are not ported (the "
                                      "JAX package merges LoRAs into UNet keys only)")
        if "hypernet" in kinds or opts.get("sd_hypernetwork", "None") not in ("None", "", None):
            raise NotImplementedError("hypernetworks with an SD3 model are not ported (the JAX "
                                      "package's flow denoiser drops them)")
        if p.controlnet_units:
            raise NotImplementedError("controlnet_units with an SD3 model are not ported (the "
                                      "JAX package's flow denoiser drops them)")
        if p.tiling:
            raise NotImplementedError("tiling with an SD3 model is not ported (the MMDiT has "
                                      "no circular padding in the JAX package)")
        if get_sampler(p.sampler_name).solver == "lcm" or (
                p.enable_hr and p.hr_sampler_name
                and get_sampler(p.hr_sampler_name).solver == "lcm"):
            raise NotImplementedError("the LCM sampler with an SD3 model is not ported (the "
                                      "flow schedule has no alphas_cumprod to distil)")
    if p.soft_inpainting and model.disc.prediction_type == "flow":
        raise NotImplementedError("soft inpainting with a rectified-flow (SD3) model is not "
                                  "ported (its blend assumes x = x0 + sigma * noise)")
    if model.is_unclip and p.enable_hr:
        raise NotImplementedError("enable_hr with an unclip model is not ported (the JAX "
                                  "package's hires pass builds no adm vector)")
    if uses_refiner(p) and (not model.is_sdxl
                            or (refiner_model is not None and not refiner_model.is_sdxl)):
        raise NotImplementedError(
            f"refiner_checkpoint with a {model.kind!r} model"
            + (f" and a {refiner_model.kind!r} refiner" if refiner_model is not None else "")
            + " is not ported: the refiner handoff is SDXL's only")


def _check_slice(p: GenerationParams, txt2img: bool = False) -> None:
    """Raise for every request field and option the slice does not run
    (hypernet_override, the training preview's live network, runs in
    txt2img only, as in JAX)."""
    if p.hypernet_override is not None and not txt2img:
        raise NotImplementedError("'hypernet_override' is not ported yet")


# --------------------------------------------------------------------------
# denoising
# --------------------------------------------------------------------------

def sigma_to_t(sigma: float, log_sigmas: np.ndarray, quantize: bool) -> float:
    """σ → model timestep in float32 (processing.py:105-123): nearest table
    entry when quantized, else interpolated in log σ."""
    log_sigma = np.log(np.maximum(np.float32(sigma), np.float32(1e-12)))
    dists = log_sigma - log_sigmas
    if quantize:
        return float(np.argmin(np.abs(dists)))
    low_idx = int(np.clip(np.argmax(np.cumsum(dists >= 0)), 0, len(log_sigmas) - 2))
    low, high = log_sigmas[low_idx], log_sigmas[low_idx + 1]
    w = np.clip((low - log_sigma) / (low - high), np.float32(0), np.float32(1))
    return float((1 - w) * np.float32(low_idx) + w * np.float32(low_idx + 1))


#: LCM's distillation steps: its timesteps are every (T / 50)-th table entry
LCM_ORIGINAL_STEPS = 50


def make_denoise_fn(model: SDModel, quantize_t: bool, compute_dtype, solver: str = "",
                    hypernet=None, controls=(), conds_per_image: int = 1):
    """denoise(x, sigma, ctx, y=None, step=0, c_concat=None) → denoised:
    k-diffusion CompVis(V)Denoiser scalings around the UNet
    (processing.py:150-202), or for SD3's rectified flow the MMDiT's
    velocity at t = σ·1000; y is the SDXL / SD3 / unclip vector cond; c_concat, a hybrid
    UNet's image conditioning, joins the scaled latent on the channel axis
    after the ControlNet towers have read its 4 channels
    (processing.py:187-188).  For LCM, σ snaps to the distillation
    subtable and an eps model's output passes through the consistency
    model's boundary scalings (sigma_data 0.5 over t·10).  hypernet and
    controls (``pipeline/control.PreparedControl``) go into every UNet
    call, the controls gated by `step`; the CFG batch holds
    conds_per_image cond rows per image before the uncond rows."""
    log_sigmas = np.asarray(model.disc.log_sigmas, np.float32)
    prediction_type = model.disc.prediction_type
    lcm = solver == "lcm"
    skip = len(log_sigmas) // LCM_ORIGINAL_STEPS
    sub = log_sigmas[skip - 1::skip]
    attn_opts = None if prediction_type == "flow" else AttentionOptions.of(model.unet_cfg)

    def denoise(x, sigma: float, ctx, y=None, step: int = 0, c_concat=None):
        s = np.float32(sigma)
        if prediction_type == "flow":
            # rectified flow (SD3, processing.py:153-159): the raw latent,
            # timestep σ·1000, a velocity out, x0 = x − v·σ
            timesteps = torch.full((x.shape[0],), float(s * np.float32(1000.0)),
                                   dtype=torch.float32, device=x.device)
            out = model.unet(x.to(compute_dtype), timesteps, ctx, y).float()
            return x - out * float(s)
        if lcm:
            j = int(np.argmin(np.abs(np.log(np.maximum(s, np.float32(1e-12))) - sub)))
            t = np.float32(j * skip + (skip - 1))
        else:
            t = sigma_to_t(s, log_sigmas, quantize_t)
        c_in = float(np.float32(1.0) / np.sqrt(s * s + np.float32(1.0)))
        x_in = (x * c_in).to(compute_dtype)
        timesteps = torch.full((x.shape[0],), float(t), dtype=torch.float32, device=x.device)
        control = None
        if controls:
            n_cond = x.shape[0] - x.shape[0] // (conds_per_image + 1)
            control = control_residuals(controls, x_in, timesteps, ctx, y, step, n_cond)
        if c_concat is not None:
            x_in = torch.cat([x_in, c_concat.to(x_in.dtype)], dim=1)
        out = model.unet(x_in, timesteps, ctx, y, control=control, hypernet=hypernet,
                         tiling=model.unet_cfg.tiling, attn=attn_opts).float()
        if prediction_type == "v":
            return x / float(s * s + 1) - out * float(s / np.sqrt(s * s + 1))
        if lcm:
            st = t * np.float32(10.0)
            c_skip = np.float32(0.25) / (st ** 2 + np.float32(0.25))
            c_out = st / np.sqrt(st ** 2 + np.float32(0.25))
            return (x - out * float(s)) * float(c_out) + x * float(c_skip)
        return x - out * float(s)

    return denoise


def sample_latents(model: SDModel, sched: CondSchedule, x, sigmas, noise,
                   solver: str, extra: dict | None = None,
                   step_callback: Callable | None = None, first_step: int = 0,
                   total_steps: int | None = None, mask=None, nmask=None,
                   init_latent=None, hypernet=None, controls=(), soft_inpainting=None):
    """Sample from sigmas[0] to sigmas[-1].  step_callback(i, n, x) sees
    step first_step + i of total_steps (a refiner run continues the base's
    count).  mask / nmask / init_latent: the img2img latent blend, or with
    soft_inpainting (power, scale, detail) the σ-scheduled soft blend;
    hypernet / controls: make_denoise_fn's."""
    quantize = bool(opts.get("enable_quantization", False))
    mesh = _mesh_for(model, x.shape[0])
    if mesh is not None:
        model_fn = _mesh_denoiser(model, *mesh, sched, x.shape[0], quantize, solver,
                                  hypernet=hypernet, controls=controls, mask=mask, nmask=nmask,
                                  init_latent=init_latent, soft_inpainting=soft_inpainting)
    else:
        denoise = make_denoise_fn(model, quantize, devices.get_policy().compute_dtype, solver,
                                  hypernet=hypernet, controls=controls,
                                  conds_per_image=sched.cond_bank.shape[0])
        model_fn = make_cfg_denoiser(denoise, sched, mask=mask, nmask=nmask,
                                     init_latent=init_latent, soft_inpainting=soft_inpainting,
                                     return_uncond=solver == "ddim_cfgpp")
    sig = np.asarray(sigmas, np.float32)
    n = total_steps or len(sig) - 1
    callback = None
    if step_callback is not None:
        callback = lambda i, xc: step_callback(first_step + i, n, xc)  # noqa: E731
    extra = dict(extra or {})
    if solver == "unipc":     # processing.py:382-392
        for key, default in (("uni_pc_order", 3), ("uni_pc_variant", "bh1"),
                             ("uni_pc_lower_order_final", True)):
            extra[key] = opts.get(key, default)
    return sample(model_fn, x, sig, solver, noise, extra, callback=callback)


def _mesh_for(model: SDModel, batch: int):
    """(runtime, data shards) when `model` runs sharded for a batch of
    `batch`, else None: the batch splits over the data axis when it
    divides it (an indivisible batch runs on data shard 0's model group:
    unsharded when the model axis is 1, as JAX's processing.py:407-415)."""
    rt = runtime_for(model.device, model.runtime)
    if rt is None:
        return None
    n_data = rt.data_size if batch % rt.data_size == 0 else 1
    if n_data == 1 and rt.model_size == 1:
        return None
    return rt, n_data


def _mesh_denoiser(model: SDModel, rt, n_data: int, sched: CondSchedule, batch: int,
                   quantize: bool, solver: str, hypernet=None, controls=(), mask=None,
                   nmask=None, init_latent=None, soft_inpainting=None):
    """The CFG denoiser of :func:`sample_latents` over the mesh: one per
    data shard on its bundle (``sd_model.shard_bundles``) with its rows of
    everything batch-shaped, run over the data group (``Group.map``); the
    output joins on x's device."""
    b = batch // n_data
    uncond_out = solver == "ddim_cfgpp"
    fns = []
    for d, shard in enumerate(shard_bundles(model, rt, n_data)):
        dev = shard.device

        def rows(t, d=d, dev=dev):
            if t is None:
                return None
            return (t[d * b:(d + 1) * b] if t.shape[0] == batch else t).to(dev, copy=True)

        def to(t, dev=dev):
            return None if t is None else t.to(dev)

        s_d = dataclasses.replace(sched, cond_bank=to(sched.cond_bank),
                                  uncond_bank=to(sched.uncond_bank),
                                  vector_bank=to(sched.vector_bank),
                                  vector_uncond_bank=to(sched.vector_uncond_bank),
                                  c_concat=rows(sched.c_concat))
        ctrls = [dataclasses.replace(c, tower=on_device(c.tower, dev), hint=c.hint.to(dev))
                 for c in controls]
        denoise = make_denoise_fn(shard, quantize, devices.get_policy().compute_dtype, solver,
                                  hypernet=on_device(hypernet, dev), controls=ctrls,
                                  conds_per_image=sched.cond_bank.shape[0])
        fns.append(make_cfg_denoiser(denoise, s_d, mask=rows(mask), nmask=rows(nmask),
                                     init_latent=rows(init_latent),
                                     soft_inpainting=soft_inpainting,
                                     return_uncond=uncond_out))
    if n_data == 1:
        dev = rt.grid[0][0]
        return lambda x, sigma, i: fns[0](x.to(dev), sigma, i).to(x.device)
    group = data_group(rt)

    def model_fn(x, sigma: float, i: int):
        parts = rt.shard_batch(x)
        outs = group.map(lambda d: fns[d](parts[d], sigma, i))
        return torch.cat([o.to(x.device) for o in outs], dim=1 if uncond_out else 0)

    return model_fn


@torch.inference_mode()
def invert_noise(model: SDModel, sched: CondSchedule, init_latent, sigmas):
    """Reverse-Euler noise reconstruction (processing.py:1150-1195, the
    reference's scripts/img2imgalt.py find_noise_for_image): from the init
    latent at sigmas[0] (= 0) up the ascending `sigmas`, each step taken
    with the CFG denoiser's estimate at the step's target σ; t is the
    nearest entry of the model's log-σ table, ε and v prediction alike.
    Returns x at the last σ over its standard deviation, (B, C, h, w) fp32
    on the model's device; the UNet runs in the policy's compute dtype."""
    denoise = make_denoise_fn(model, True, devices.get_policy().compute_dtype)
    model_fn = make_cfg_denoiser(denoise, sched)
    sig = np.asarray(sigmas, np.float32)
    x = init_latent.float()
    for i in range(1, len(sig)):
        s = float(max(sig[i], np.float32(1e-5)))
        denoised = model_fn(x, s, i - 1)
        x = x + (x - denoised) / s * float(sig[i] - sig[i - 1])
    return x / x.std(unbiased=False)


def setup_img2img_steps(steps: int, denoising_strength: float,
                        fix_steps: bool = False):
    """(steps_to_schedule, t_enc) — reference sd_samplers_common.py:22."""
    if fix_steps:
        requested = steps
        steps = int(requested / min(denoising_strength, 0.999)) \
            if denoising_strength > 0 else 0
        t_enc = requested - 1
    else:
        t_enc = int(min(denoising_strength, 0.999) * steps)
    return steps, t_enc


def _taesd_for(model: SDModel, which: str):
    """The TAESD encoder or decoder when opts.sd_vae_{encode,decode}_method
    is "TAESD" and its file loads (processing.py:458-470), else None: the
    full VAE runs, as in JAX (``models/vae_approx`` logs the fallback)."""
    opt = "sd_vae_decode_method" if which == "decoder" else "sd_vae_encode_method"
    if opts.get(opt, "Full") != "TAESD":
        return None
    return vae_approx.get_taesd(model.kind, which, model.device)


def _fast_interrupt_method(interrupted: bool):
    """The live-preview method an interrupted job decodes its finals with
    under opts.live_preview_fast_interrupt (processing.py:473-483), or None."""
    if interrupted and opts.get("live_preview_fast_interrupt", False):
        method = opts.get("show_progress_type", "Approx NN")
        return None if method == "Full" else method
    return None


def encode_first_stage(model: SDModel, images: np.ndarray):
    """images (B, H, W, 3) float in [0, 1] → scaled latents (B, z, H/8, W/8)
    in fp32: the encoder's mean at the policy's vae_dtype, or TAESD's
    encoder (processing.py:348-351,586-593)."""
    x = torch.from_numpy(np.ascontiguousarray(images.transpose(0, 3, 1, 2))).to(model.device)
    taesd = _taesd_for(model, "encoder")
    if taesd is not None:
        return vae_approx.taesd_encode(taesd, x)
    x = x.to(devices.get_policy().vae_dtype) * 2.0 - 1.0
    vae = model.vae
    return vae.encode_mode(vae.encode_moments(x)).float()


def to_u8(img) -> np.ndarray:
    """(B, 3, H, W) in [0, 1] → uint8 (B, H, W, 3), rounded half up."""
    return (img * 255.0 + 0.5).to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy()


def _vae_decode(model: SDModel, z):
    """The VAE decode of `z`, split over the data axis when the batch
    divides it (each shard on its replica, the images joined on z's
    device)."""
    mesh = _mesh_for(model, z.shape[0])
    tiling = model.vae_cfg.tiling
    if mesh is None or mesh[1] == 1:
        return model.vae.decode(z, tiling=tiling)
    rt = mesh[0]
    parts = rt.shard_batch(z)
    outs = data_group(rt).map(lambda d: on_device(model.vae, rt.data_devices[d]).decode(
        parts[d], tiling=tiling))
    return torch.cat([o.to(z.device) for o in outs])


def _decode_u8(model: SDModel, latents, dtype):
    """(uint8 (B, H, W, 3), whether the decode gave NaN or inf); NaN reads
    as 0, as JAX's ``tensor_to_pil`` reads it."""
    img = _vae_decode(model, latents.to(dtype))
    bad = not devices.all_finite(img)
    return to_u8(torch.nan_to_num(torch.clamp(img.float() / 2.0 + 0.5, 0.0, 1.0))), bad


def _approx_u8(model: SDModel, latents, interrupted: bool):
    """The finals of an interrupted job under live_preview_fast_interrupt,
    or TAESD's decode, as uint8; None for the full VAE."""
    fast = _fast_interrupt_method(interrupted)
    if fast is not None:
        return to_u8(vae_approx.approx_decode(model.kind, fast, latents))
    taesd = _taesd_for(model, "decoder")
    if taesd is not None:
        return to_u8(vae_approx.taesd_decode(taesd, latents))
    return None


def decode_first_stage(model: SDModel, latents) -> np.ndarray:
    """latents → uint8 (B, H, W, 3) as JAX's ``decode_first_stage`` and
    ``tensor_to_pil`` make the hires pass's image: TAESD, or one decode at
    the policy's vae_dtype, no bf16 first (processing.py:320,485)."""
    u8 = _approx_u8(model, latents, False)
    if u8 is not None:
        return u8
    return _decode_u8(model, latents, devices.get_policy().vae_dtype)[0]


def _spatial_decode_if_beneficial(model: SDModel, latents):
    """The row-sharded f32 decode of a big image the batch cannot split
    (batch % data ≠ 0, rows % data = 0, rows ≥ 128: processing.py:499-513)
    as [0, 1] images, or None."""
    rt = runtime_for(model.device, model.runtime)
    if rt is None:
        return None
    n, rows = rt.data_size, latents.shape[2]
    if n > 1 and latents.shape[0] % n and rows % n == 0 and rows >= 128:
        img = decode_spatial(model.vae, latents.float(), rt, tiling=model.vae_cfg.tiling)
        return torch.clamp(img.float() / 2.0 + 0.5, 0.0, 1.0)
    return None


def decode_first_stage_u8(model: SDModel, latents, interrupted: bool = False) -> np.ndarray:
    """latents (B, C, h, w) → uint8 (B, H, W, 3).  An interrupted job's
    preview decode or TAESD when the options ask for them; else a bf16
    decode first when opts.sdtpu_vae_bf16, retried in fp32 on NaN/inf
    unless opts.auto_vae_precision is off (processing.py:523-546)."""
    u8 = _approx_u8(model, latents, interrupted)
    if u8 is not None:
        return u8
    spatial = _spatial_decode_if_beneficial(model, latents)
    if spatial is not None:
        return to_u8(torch.nan_to_num(spatial))
    if opts.get("sdtpu_vae_bf16", True):
        u8, bad = _decode_u8(model, latents, torch.bfloat16)
        if not bad or not opts.get("auto_vae_precision", True):
            return u8
    return _decode_u8(model, latents, devices.get_policy().vae_dtype)[0]


# --------------------------------------------------------------------------
# orchestration
# --------------------------------------------------------------------------

def _resolve_seeds(p: GenerationParams):
    if p.seed in (-1, None):
        p.seed = random.randrange(MAX_SEED)
    if p.subseed in (-1, None):
        p.subseed = random.randrange(MAX_SEED)
    n = p.batch_size * p.n_iter
    p.all_seeds = [int(p.seed) + (i if p.subseed_strength == 0 else 0) for i in range(n)]
    p.all_subseeds = [int(p.subseed) + i for i in range(n)]
    p.all_prompts = [p.prompt] * n
    p.all_negative_prompts = [p.negative_prompt] * n


def _strip_prompt_comments(p: GenerationParams):
    if not opts.get("enable_prompt_comments", True):
        return
    if "#" not in p.prompt and "#" not in p.negative_prompt:
        return
    p.prompt = strip_comments(p.prompt)
    p.negative_prompt = strip_comments(p.negative_prompt)
    p.all_prompts = [strip_comments(x) for x in p.all_prompts]
    p.all_negative_prompts = [strip_comments(x) for x in p.all_negative_prompts]


def create_rng(shape, seeds, device, subseeds=None, subseed_strength=0.0,
               seed_resize_from_h=0, seed_resize_from_w=0, eta_noise_seed_delta=0):
    """The noise streams of opts.randn_source in NCHW (image_rng.py:181-209):
    "NV" (host Philox, the reference's NVIDIA bits), "CPU" (the torch CPU
    generator), or "TPU" / "GPU" / "JAX" (the same Philox counters on
    `device`, ``rng/device_philox``; a seed resize takes the host path)."""
    return image_rng.create_rng(shape, seeds, subseeds=subseeds,
                                subseed_strength=subseed_strength,
                                seed_resize_from_h=seed_resize_from_h,
                                seed_resize_from_w=seed_resize_from_w,
                                eta_noise_seed_delta=eta_noise_seed_delta,
                                channels_last=False, device=device)


def apply_attention_options(model: SDModel, kind: str = "txt2img") -> SDModel:
    """The UNet's attention options of this request (processing.py:1115-1147):
    hypertile (the latent tile is hypertile_max_tile_unet // 8, at least
    16), token merging (img2img and the hires pass fall back to the base
    ratio when their own option is 0) and upcast_attn; a copy of the
    bundle, the same modules.  SD3's MMDiT takes none of them."""
    cfg = model.unet_cfg
    if not hasattr(cfg, "tome_ratio"):
        return model
    tile = 0
    if opts.get("hypertile_enable_unet", False):
        tile = max(int(opts.get("hypertile_max_tile_unet", 256)) // 8, 16)
    base = float(opts.get("token_merging_ratio", 0.0))
    own = {"img2img": "token_merging_ratio_img2img", "hr": "token_merging_ratio_hr"}.get(kind)
    ratio = (float(opts.get(own, 0.0)) if own else 0.0) or base
    new = dataclasses.replace(cfg, hypertile_tile=tile or cfg.hypertile_tile,
                              tome_ratio=ratio if ratio > 0 else 0.0,
                              upcast_attn=bool(opts.get("upcast_attn", False)))
    return model if new == cfg else dataclasses.replace(model, unet_cfg=new)


def apply_schedule_overrides(model: SDModel, p: GenerationParams) -> SDModel:
    """sd_noise_schedule "Zero Terminal SNR" and use_downcasted_alpha_bar
    (an fp16 round trip of ᾱ) rebuild the sigma table for this run, with
    their infotext fields (processing.py:1260-1284); a flow model has no ᾱ
    table and is left as it is."""
    disc = model.disc
    if getattr(disc, "alphas_cumprod", None) is None:
        return model
    abar, changed = disc.alphas_cumprod, False
    if opts.get("use_downcasted_alpha_bar", False):
        abar = np.asarray(abar).astype(np.float16).astype(np.float64)
        p.extra_generation_params["Downcast alphas_cumprod"] = "True"
        changed = True
    if opts.get("sd_noise_schedule", "Default") == "Zero Terminal SNR":
        abar = rescale_zero_terminal_snr_abar(abar)
        p.extra_generation_params["Noise Schedule"] = "Zero Terminal SNR"
        changed = True
    if not changed:
        return model
    return dataclasses.replace(model, disc=Discretization(
        abar, prediction_type=disc.prediction_type, quantize=disc.quantize))


def initial_noise_scale(p: GenerationParams, sigma0: float) -> float:
    """txt2img's first-noise scale: σ₀, or √(1+σ₀²) with
    opts.sgm_noise_multiplier (processing.py:1436-1442), recorded in the
    infotext."""
    if opts.get("sgm_noise_multiplier", False):
        p.extra_generation_params["SGM noise multiplier"] = "True"
        return float(np.sqrt(1.0 + float(sigma0) ** 2))
    return float(sigma0)


_TIMESTEP_SOLVERS = ("ddim", "ddim_cfgpp", "plms", "unipc")
_CHURN_SOLVERS = ("euler", "heun", "dpm_2")


def _solver_extra(p: GenerationParams, sampler: SamplerData) -> dict:
    """Per-run solver knobs (processing.py:1202-1229): the sampler's own
    options, eta (request > eta_ddim / eta_ancestral options), s_noise,
    and Karras churn for the samplers the reference forwards it to."""
    extra = dict(sampler.extra)
    if p.eta is not None and p.eta > 0:
        extra["eta"] = float(p.eta)
    elif sampler.solver in _TIMESTEP_SOLVERS:
        v = float(opts.get("eta_ddim", 0.0) or 0.0)
        if v > 0:
            extra["eta"] = v
    else:
        v = float(opts.get("eta_ancestral", 1.0))
        if v != 1.0:
            extra["eta"] = v
    if p.s_noise not in (None, 1.0):
        extra["s_noise"] = float(p.s_noise)
    if sampler.solver in _CHURN_SOLVERS:
        churn = float(p.s_churn or opts.get("s_churn", 0.0) or 0.0)
        if churn > 0:
            extra["s_churn"] = churn
            extra["s_tmin"] = float(p.s_tmin or opts.get("s_tmin", 0.0) or 0.0)
            extra["s_tmax"] = float(p.s_tmax or opts.get("s_tmax", 0.0) or 0.0)
            p.extra_generation_params["Sigma churn"] = churn
    return extra


def _resolve_scheduler(sampler: SamplerData, requested: str) -> str:
    """The sampler's forced scheduler, with UniPC's skip type mapped onto
    its schedule (processing.py:1289-1301)."""
    scheduler = sampler.scheduler_override or requested
    if sampler.solver == "unipc":
        skip = opts.get("uni_pc_skip_type", "time_uniform")
        scheduler = {"logSNR": "exponential",
                     "time_quadratic": "unipc_quadratic"}.get(skip, scheduler)
    return scheduler


def prepare_sampler(model: SDModel, p: GenerationParams, steps: int,
                    sampler_name: str | None = None, scheduler: str | None = None):
    """(sampler, solver spec, sigmas, solver extra) of a request (or of the
    named sampler and scheduler): the resolved scheduler's schedule with
    build_sigmas' post-passes (their infotext pairs go to
    p.extra_generation_params), and one noise a step for a churn run."""
    sampler = get_sampler(sampler_name or p.sampler_name)
    spec = get_solver(sampler.solver)
    sigmas = build_sigmas(sampler, _resolve_scheduler(sampler, scheduler or p.scheduler), steps,
                          model.disc, extra_params_out=p.extra_generation_params,
                          is_sdxl=model.is_sdxl)
    extra = _solver_extra(p, sampler)
    if extra.get("s_churn"):
        spec = dataclasses.replace(spec, noises_per_step=max(spec.noises_per_step, 1))
    return sampler, spec, sigmas, extra


def _skip_uncond_mask(sigmas, p: GenerationParams):
    """NGMS (s_min_uncond) and skip_early_cond per step (processing.py:1232)."""
    smu = float(p.s_min_uncond or opts.get("s_min_uncond", 0.0) or 0.0)
    early = float(opts.get("skip_early_cond", 0.0) or 0.0)
    if smu <= 0 and early <= 0:
        return None
    all_steps = bool(opts.get("s_min_uncond_all", False))
    n = len(sigmas) - 1
    mask = np.zeros((n,), bool)
    for i in range(n):
        if early > 0 and i / n <= early:
            mask[i] = True
            p.extra_generation_params["Skip Early CFG"] = early
        elif smu > 0 and (i % 2 or all_steps) and float(sigmas[i]) < smu:
            mask[i] = True
            p.extra_generation_params["NGMS"] = smu
            if all_steps:
                p.extra_generation_params["NGMS all steps"] = "True"
    return mask if mask.any() else None


#: opts.persistent_cond_cache (processing.py:1015-1056): schedules of
#: prompts seen before, by everything that shapes their banks; at most
#: COND_CACHE_SIZE, the least recently used leaving first
_COND_CACHE: dict = {}
COND_CACHE_SIZE = 16


def _cond_cache_key(model: SDModel, p: GenerationParams, steps, cfg_scale, prompt, negative,
                    width, height, hires_steps) -> tuple:
    """The JAX package's key (processing.py:1030-1043), with the options
    that change the tokens and weights it leaves out (use_old_emphasis_
    implementation, enable_emphasis, comma_padding_backtrack: ROADMAP C)."""
    return (id(model), model.kind, id(model.conditioner.embedding_db),
            prompt if prompt is not None else p.prompt,
            negative if negative is not None else p.negative_prompt,
            steps, hires_steps, cfg_scale if cfg_scale is not None else p.cfg_scale,
            p.clip_skip, width or p.width, height or p.height,
            bool(opts.get("use_old_scheduling", False)),
            bool(opts.get("sdxl_clip_l_skip", False)),
            int(opts.get("sdxl_crop_top", 0)), int(opts.get("sdxl_crop_left", 0)),
            str(opts.get("emphasis", "Original")),
            bool(opts.get("use_old_emphasis_implementation", False)),
            bool(opts.get("enable_emphasis", True)),
            int(opts.get("comma_padding_backtrack", 20)))


def _build_conds(model: SDModel, p: GenerationParams, steps: int,
                 cfg_scale: float | None = None, prompt: str | None = None,
                 negative: str | None = None, width: int | None = None,
                 height: int | None = None, hires_steps: int | None = None,
                 adm_vector=None) -> CondSchedule:
    """`_encode_conds` through the persistent cond cache: off with an adm
    vector; a hit is a shallow copy (callers set ``skip_uncond`` and
    ``c_concat`` per run) and marks the textual-inversion embeddings it
    used, so the infotext's TI hashes stay.  An entry holds its model
    weakly: a model built at a freed model's address misses."""
    if not opts.get("persistent_cond_cache", True) or adm_vector is not None:
        return _encode_conds(model, p, steps, cfg_scale, prompt, negative, width, height,
                             hires_steps, adm_vector)
    key = _cond_cache_key(model, p, steps, cfg_scale, prompt, negative, width, height,
                          hires_steps)
    db = model.conditioner.embedding_db
    hit = _COND_CACHE.pop(key, None)
    if hit is not None and hit[0]() is model:
        _COND_CACHE[key] = hit                  # most recently used
        if db is not None:
            db.used_names.update(hit[2])
        return copy.copy(hit[1])
    before = set(db.used_names) if db is not None else set()
    if db is not None:
        db.used_names.clear()
    sched = _encode_conds(model, p, steps, cfg_scale, prompt, negative, width, height,
                          hires_steps, adm_vector)
    used = frozenset(db.used_names) if db is not None else frozenset()
    if db is not None:
        db.used_names.update(before)
    _COND_CACHE[key] = (weakref.ref(model), copy.copy(sched), used)
    while len(_COND_CACHE) > COND_CACHE_SIZE:
        _COND_CACHE.pop(next(iter(_COND_CACHE)))
    return sched


def _encode_conds(model: SDModel, p: GenerationParams, steps: int,
                  cfg_scale: float | None = None, prompt: str | None = None,
                  negative: str | None = None, width: int | None = None,
                  height: int | None = None, hires_steps: int | None = None,
                  adm_vector=None) -> CondSchedule:
    """The CFG schedule (processing.py:1061-1113) of the request's prompts,
    or of the given ones (the hires pass).  SDXL keeps CLIP-L at the
    penultimate layer unless opts.sdxl_clip_l_skip, and adds the y vectors
    (sizes, crop, and for the refiner the aesthetic scores); SD3's y is the
    pooled CLIP-L ⊕ bigG; adm_vector (unclip's) is one vector for every
    schedule entry and both CFG branches.  hires_steps: the second pass's
    steps, which the prompt-edit schedule continues into unless
    opts.use_old_scheduling."""
    if model.is_sdxl and not opts.get("sdxl_clip_l_skip", False):
        model.conditioner.clip_skip = 2
    else:
        model.conditioner.clip_skip = max(p.clip_skip, 1 if model.kind == "sd1" else 2)
    if model.conditioner2 is not None:
        model.conditioner2.clip_skip = max(p.clip_skip, 2)
    vector_maker = None
    if model.is_sdxl:
        vector_maker = sdxl_vector_maker(
            model, width or p.width, height or p.height,
            crop=(int(opts.get("sdxl_crop_top", 0)), int(opts.get("sdxl_crop_left", 0))),
            aesthetic_score=float(opts.get("sdxl_refiner_high_aesthetic_score", 6.0)),
            negative_aesthetic_score=float(opts.get("sdxl_refiner_low_aesthetic_score", 2.5)))
    elif model.is_sd3:
        vector_maker = lambda pooled, is_uncond: pooled.float()   # noqa: E731
    sched = build_cond_schedule(
        model.encode_texts, p.prompt if prompt is None else prompt,
        p.negative_prompt if negative is None else negative, steps,
        cond_scale=p.cfg_scale if cfg_scale is None else cfg_scale,
        vector_maker=vector_maker, hires_steps=hires_steps,
        use_old_scheduling=bool(opts.get("use_old_scheduling", False)))
    if adm_vector is not None:
        k, max_sched = sched.cond_bank.shape[:2]
        v = adm_vector.float()
        sched.vector_bank = v.expand((k, max_sched) + v.shape)
        sched.vector_uncond_bank = v.expand((sched.uncond_bank.shape[0],) + v.shape)
    return sched


def _refiner_split_idx(model: SDModel, sigmas, switch_at: float, max_steps: int) -> int:
    """Step index of the base → refiner handoff (processing.py:640-661): the
    first step whose timestep has completed `switch_at` of the schedule,
    (999 - t(σ)) / 1000 >= switch_at, or int(steps · switch_at) with
    opts.refiner_switch_by_sample_steps; kept within [1, max_steps - 1]."""
    if opts.get("refiner_switch_by_sample_steps", False):
        n = len(sigmas) - 1
        return min(max(int(n * switch_at), 1), max_steps - 1)
    log_s = np.log(np.maximum(np.asarray(sigmas[:-1]), 1e-12))
    tsteps = np.argmin(np.abs(log_s[:, None]
                              - np.asarray(model.disc.log_sigmas)[None, :]), axis=1)
    hit = np.nonzero((999.0 - tsteps) / 1000.0 >= switch_at)[0]
    s_idx = int(hit[0]) if hit.size else len(log_s) - 1
    return min(max(s_idx, 1), max_steps - 1)


def uses_refiner(p: GenerationParams) -> bool:
    return bool(p.refiner_checkpoint) and 0 < (p.refiner_switch_at or 0) < 1


# --------------------------------------------------------------------------
# hires fix (processing.py:601-777)
# --------------------------------------------------------------------------

#: hires_upscaler names that resize the latents, and how (processing.py:601)
LATENT_UPSCALE_MODES = {
    "Latent": "bilinear",
    "Latent (antialiased)": "bilinear",
    "Latent (bicubic)": "bicubic",
    "Latent (bicubic antialiased)": "bicubic",
    "Latent (nearest)": "nearest",
    "Latent (nearest-exact)": "nearest",
}


def resize_latents(latents, height: int, width: int, method: str):
    """NCHW latents to height x width as ``jax.image.resize`` computes them
    (processing.py:687): it antialiases when shrinking and uses Keys' cubic
    (a = -0.5), which is torch's antialiased bilinear / bicubic with
    half-pixel centres; its "nearest" is torch's "nearest-exact"."""
    if method == "nearest":
        return F.interpolate(latents, size=(height, width), mode="nearest-exact")
    return F.interpolate(latents, size=(height, width), mode=method, align_corners=False,
                         antialias=True)


def apply_old_hires_behavior(p: GenerationParams) -> None:
    """opts.use_old_hires_fix_width_height (processing.py:611): width and
    height become the hires target, and the first pass runs near 512²."""
    if not (p.enable_hr and opts.get("use_old_hires_fix_width_height", False)):
        return
    p.hr_resize_x, p.hr_resize_y = p.width, p.height
    scale = math.sqrt(512 * 512 / (p.width * p.height))
    p.width = math.ceil(scale * p.width / 64) * 64
    p.height = math.ceil(scale * p.height / 64) * 64


def calculate_hr_target(p: GenerationParams) -> tuple:
    """(hr_width, hr_height) (processing.py:628): hr_scale times the size,
    or hr_resize_x / hr_resize_y, a zero one following the aspect."""
    if p.hr_resize_x == 0 and p.hr_resize_y == 0:
        return int(p.width * p.hr_scale), int(p.height * p.hr_scale)
    if p.hr_resize_y == 0:
        return p.hr_resize_x, p.hr_resize_x * p.height // p.width
    if p.hr_resize_x == 0:
        return p.hr_resize_y * p.width // p.height, p.hr_resize_y
    return p.hr_resize_x, p.hr_resize_y


def upscale_first_pass(model: SDModel, p: GenerationParams, latents, hr_w: int, hr_h: int):
    """First-pass latents → latents at hr_w x hr_h: a latent resize, or the
    image-space route (decode, the hr_upscaler to exactly the target,
    encode at the policy's vae_dtype)."""
    if p.hr_upscaler in LATENT_UPSCALE_MODES or not p.hr_upscaler:
        return resize_latents(latents, hr_h // 8, hr_w // 8,
                              LATENT_UPSCALE_MODES.get(p.hr_upscaler, "bilinear"))
    ups = [upscalers.upscale_by_name(p.hr_upscaler, im, hr_w, hr_h)
           for im in decode_first_stage(model, latents)]
    return encode_first_stage(model, np.stack(ups).astype(np.float32) / 255.0)


def _hires_pass(model: SDModel, p: GenerationParams, latents, seeds, subseeds,
                refiner_model: SDModel | None = None,
                step_callback: Callable | None = None, hypernet=None):
    """First-pass latents → hires latents: the upscale, then t_enc + 1 steps
    of a schedule of hr_second_pass_steps (or steps) from the noise level
    of denoising_strength, with the hires sampler, scheduler, CFG and
    prompts (their extra-network tags stripped: the first pass's networks
    stay active) and the ControlNet units re-prepared at the target size
    (processing.py:745-777); for SDXL handed to `refiner_model` inside it.
    Its noise takes no seed resize and no ENSD (processing.py:730)."""
    model = apply_attention_options(model, "hr")
    hr_w, hr_h = calculate_hr_target(p)
    th, tw = hr_h // 8, hr_w // 8
    c = model.latent_channels
    denoising = p.denoising_strength if p.denoising_strength is not None else 0.7
    steps, t_enc = setup_img2img_steps(p.hr_second_pass_steps or p.steps, denoising)
    up = upscale_first_pass(model, p, latents, hr_w, hr_h)
    sampler, spec, sigmas_full, extra = prepare_sampler(model, p, steps, p.hr_sampler_name,
                                                        p.hr_scheduler)
    sigma_sched = sigmas_full[steps - t_enc - 1:]
    cfg = p.hr_cfg_scale or p.cfg_scale
    prompt = _hires_prompt(p)
    negative = p.hr_negative_prompt or p.negative_prompt
    if opts.get("hires_fix_use_firstpass_conds", False):
        cond_w, cond_h = p.width, p.height
    else:
        cond_w, cond_h = hr_w, hr_h
    sched = _build_conds(model, p, p.steps, cfg_scale=cfg, prompt=prompt, negative=negative,
                         width=cond_w, height=cond_h, hires_steps=t_enc + 1)
    rng = create_rng((c, th, tw), seeds, model.device, subseeds=subseeds,
                     subseed_strength=p.subseed_strength)
    noise0 = torch.as_tensor(rng.first(), device=model.device)
    if model.disc.prediction_type == "flow":   # the LERP (processing.py:733-735)
        s0 = float(sigma_sched[0])
        x = s0 * noise0 + (1.0 - s0) * up
    else:
        x = up + noise0 * float(np.float32(sigma_sched[0]))
    extra_noise = float(opts.get("img2img_extra_noise", 0.0) or 0.0)
    if extra_noise > 0:
        # the un-scheduled extra noise img2img adds, shared by the hires
        # pass (reference sd_samplers_kdiffusion.py:145-150)
        p.extra_generation_params["Extra noise"] = extra_noise
        x = x + noise0 * extra_noise
    noise = prepare_noise(spec, len(sigma_sched) - 1, rng, model.device)
    sched.skip_uncond = _skip_uncond_mask(sigma_sched, p)
    n = len(sigma_sched) - 1
    controls = _prepare_units(model, p, hr_w, hr_h, t_enc + 1)
    if refiner_model is None or not uses_refiner(p):
        return sample_latents(model, sched, x, sigma_sched, noise, sampler.solver, extra,
                              step_callback=step_callback, hypernet=hypernet,
                              controls=controls)
    s_idx = _refiner_split_idx(model, sigma_sched, p.refiner_switch_at, t_enc + 1)
    x = sample_latents(model, sched, x, sigma_sched[: s_idx + 1], noise[:s_idx],
                       sampler.solver, extra, step_callback=step_callback, total_steps=n,
                       hypernet=hypernet, controls=controls)
    r_sched = _build_conds(refiner_model, p, t_enc + 1 - s_idx, cfg_scale=cfg, prompt=prompt,
                           negative=negative, width=hr_w, height=hr_h)
    if sched.skip_uncond is not None:
        r_sched.skip_uncond = sched.skip_uncond[s_idx:]
    return sample_latents(refiner_model, r_sched, x, sigma_sched[s_idx:], noise[s_idx:],
                          sampler.solver, extra, step_callback=step_callback,
                          first_step=s_idx, total_steps=n)


def _hires_prompt(p: GenerationParams) -> str:
    """The hires pass's prompt without its extra-network tags; networks of
    its own (other than the first pass's) are not ported."""
    text, nets = extra_networks.parse_prompt(p.hr_prompt or p.prompt)
    if nets != extra_networks.parse_prompt(p.prompt)[1]:
        tags = " ".join(f"<{n.kind}:{':'.join(n.items)}>" for n in nets)
        raise NotImplementedError(f"extra networks of hr_prompt other than the prompt's "
                                  f"({tags or 'none'}) are not ported yet")
    return text


def _prepare_units(model: SDModel, p: GenerationParams, width: int, height: int,
                   n_steps: int, default_image=None) -> list:
    """The request's ControlNet units for a pass at width x height with
    n_steps sampler steps (processing.py:1377-1383, img2img.py:317-323)."""
    if not p.controlnet_units:
        return []
    return prepare_controls(p.controlnet_units, width, height, n_steps,
                            model.latent_channels, model.device,
                            devices.get_policy().param_dtype, default_image=default_image)


def _reset_ti_usage(model: SDModel):
    """Each job logs its own textual-inversion triggers (processing.py:812)."""
    for cond in (model.conditioner, model.conditioner2):
        if cond is not None and cond.embedding_db is not None:
            cond.embedding_db.used_names = set()


def create_infotext(p: GenerationParams, model: SDModel, index: int = 0) -> str:
    """The generation-parameters text (processing.py:914), restricted to the
    fields the slice can produce."""
    pairs = {
        "Steps": p.steps,
        "Sampler": p.sampler_name,
        "Schedule type": p.scheduler if p.scheduler != "Automatic" else None,
        "CFG scale": p.cfg_scale,
        "Seed": p.all_seeds[index] if p.all_seeds else p.seed,
        "Size": f"{p.width}x{p.height}",
        "Model hash": (model.sha256[:10] if model.sha256
                       and opts.get("add_model_hash_to_info", True) else None),
        "Model": (model.title.split(" [")[0] if model.title
                  and opts.get("add_model_name_to_info", True) else None),
        "Denoising strength": p.denoising_strength,
        "Init image hash": getattr(p, "init_img_hash", None),
        "Face restoration": (opts.get("face_restoration_model", "CodeFormer")
                             if p.restore_faces else None),
        "Clip skip": p.clip_skip if p.clip_skip > 1 else None,
        "Version": (f"sdwebui-tpu-{__version__}"
                    if opts.get("add_version_to_infotext", True) else None),
    }
    if p.subseed_strength > 0:
        pairs["Variation seed"] = p.all_subseeds[index] if p.all_subseeds else p.subseed
        pairs["Variation seed strength"] = p.subseed_strength
    if p.enable_hr:       # processing.py:940-960
        if p.hr_resize_x or p.hr_resize_y:
            pairs["Hires resize"] = f"{p.hr_resize_x}x{p.hr_resize_y}"
        else:
            pairs["Hires upscale"] = p.hr_scale
        if p.hr_second_pass_steps:
            pairs["Hires steps"] = p.hr_second_pass_steps
        if p.hr_upscaler:
            pairs["Hires upscaler"] = p.hr_upscaler
        if p.hr_sampler_name:
            pairs["Hires sampler"] = p.hr_sampler_name
        if p.hr_cfg_scale and p.hr_cfg_scale != p.cfg_scale:
            pairs["Hires CFG Scale"] = p.hr_cfg_scale
        if p.hr_prompt and p.hr_prompt != p.prompt:
            pairs["Hires prompt"] = p.hr_prompt
        if p.hr_negative_prompt and p.hr_negative_prompt != p.negative_prompt:
            pairs["Hires negative prompt"] = p.hr_negative_prompt
    if uses_refiner(p):
        pairs["Refiner"] = p.refiner_checkpoint
        pairs["Refiner switch at"] = p.refiner_switch_at
    if model.vae_file:
        if opts.get("add_vae_hash_to_info", True) and model.vae_sha256:
            pairs["VAE hash"] = model.vae_sha256[:10]
        if opts.get("add_vae_name_to_info", True):
            pairs["VAE"] = os.path.splitext(os.path.basename(model.vae_file))[0]
    if p.eta:
        pairs["Eta"] = p.eta
    ensd = p.override_settings.get("eta_noise_seed_delta",
                                   opts.get("eta_noise_seed_delta", 0))
    if ensd and get_sampler(p.sampler_name).uses_ensd:
        # the reference's rule: only samplers that draw noise after the
        # first draw record it (JAX records it for every sampler)
        pairs["ENSD"] = ensd
    if p.tiling:
        pairs["Tiling"] = "True"
    tome = float(opts.get("token_merging_ratio", 0.0) or 0.0)
    if tome > 0:
        pairs["Token merging ratio"] = tome
    emphasis = opts.get("emphasis", "Original")
    if emphasis != "Original":
        pairs["Emphasis"] = emphasis
    if p.user and opts.get("add_user_name_to_info", False):
        pairs["User"] = p.user
    db = model.conditioner.embedding_db
    if db is not None and db.used_names and opts.get(
            "textual_inversion_add_hashes_to_infotext", True):   # processing.py:997-1004
        pairs["TI hashes"] = ", ".join(
            f"{n}: {db.embeddings[n].shorthash or 'unknown'}" for n in sorted(db.used_names))
    pairs.update(p.extra_generation_params)
    return infotext_util.build(
        p.all_prompts[index] if p.all_prompts else p.prompt,
        p.all_negative_prompts[index] if p.all_negative_prompts else p.negative_prompt,
        pairs)


_FACE_SKIPS_LOGGED: set = set()


def maybe_restore_faces(p: GenerationParams, images: list, device) -> list:
    """``restore_faces``: each image through opts.face_restoration_model at
    opts.code_former_weight on `device` (processing.py:894-912); without the
    restorer's weights the images stay as they are, logged once per
    restorer, and the infotext still names it, as in JAX."""
    if not p.restore_faces:
        return images
    name = opts.get("face_restoration_model", "CodeFormer")
    weight = float(opts.get("code_former_weight", 0.5))
    try:
        return [faces.restore_faces(im, name, weight=weight, device=device) for im in images]
    except faces.FaceRestorerNotFound as e:
        if name not in _FACE_SKIPS_LOGGED:
            _FACE_SKIPS_LOGGED.add(name)
            log.warning("face restoration skipped: %s", e)
        return images


def _grid_rows(n: int, batch_size: int) -> int:
    n_rows = int(opts.get("n_rows", -1))
    if n_rows > 0:
        rows = n_rows
    elif n_rows == 0:
        rows = batch_size
    elif opts.get("grid_prevent_empty_spots", False):
        rows = max(math.floor(math.sqrt(n)), 1)
        while n % rows != 0:
            rows -= 1
    else:
        rows = max(round(math.sqrt(n)), 1)
    return min(rows, n)


class ImageGridLoopParams:
    """The ``image_grid`` callback's argument (the reference's
    script_callbacks.ImageGridLoopParams): callbacks may change the images
    and the grid's columns and rows."""

    def __init__(self, imgs, cols, rows):
        self.imgs = imgs
        self.cols = cols
        self.rows = rows


def image_grid(images: list, batch_size: int = 1, rows: int | None = None) -> np.ndarray:
    """uint8 HWC images → one RGB grid image, row-major (utils/images.py:333):
    `rows` given, or from opts.n_rows; each cell the largest image's size,
    an image centred in its cell, the rest opts.grid_background_color; the
    ``image_grid`` callbacks see the images, columns and rows first.  An
    RGBA image (img2img's mask composite) loses its alpha, as Pillow's
    paste into an RGB grid drops it."""
    if rows is None:
        rows = _grid_rows(len(images), batch_size)
    rows = min(rows, len(images))
    params = ImageGridLoopParams(images, -(-len(images) // rows), rows)
    framework.invoke("image_grid", params)
    h = max(img.shape[0] for img in images)
    w = max(img.shape[1] for img in images)
    color = str(opts.get("grid_background_color", "#ffffff") or "#ffffff").lstrip("#")
    try:
        bg = [int(color[i:i + 2], 16) for i in (0, 2, 4)]
    except ValueError:
        bg = [255, 255, 255]
    grid = np.empty((params.rows * h, params.cols * w, 3), np.uint8)
    grid[...] = np.asarray(bg, np.uint8)
    for i, img in enumerate(params.imgs):
        ih, iw = img.shape[:2]
        y = (i // params.cols) * h + (h - ih) // 2
        x = (i % params.cols) * w + (w - iw) // 2
        grid[y:y + ih, x:x + iw] = img[:, :, :3]
    return grid


def should_save_samples(p: GenerationParams, outdir: str | None,
                        interrupted: Callable | None = None) -> bool:
    """processing.py:829-841: an outdir, no do_not_save_samples,
    opts.samples_save, and an interrupted job's images only with
    opts.save_incomplete_images."""
    if not outdir or p.do_not_save_samples or not opts.get("samples_save", True):
        return False
    return bool(opts.get("save_incomplete_images", False)) or \
        not bool(interrupted and interrupted())


def save_extra_copies(images: list, p: GenerationParams, model: SDModel, outdir: str | None,
                      seeds, suffix: str, lo: int = 0, interrupted: Callable | None = None):
    """The "-before-*" and mask copies beside the samples (processing.py:844-855),
    in opts.samples_format."""
    if not should_save_samples(p, outdir, interrupted):
        return
    for i, img in enumerate(images):
        saving.save_image(img, outdir, seed=seeds[i] if i < len(seeds) else p.seed,
                          prompt=p.all_prompts[lo + i] if lo + i < len(p.all_prompts)
                          else p.prompt, info=create_infotext(p, model, lo + i),
                          extension=opts.get("samples_format", "png") or "png", p=p,
                          suffix=suffix)


def save_samples(images: list, infotexts: list, p: GenerationParams, model: SDModel,
                 outdir: str | None, seeds, lo: int, n: int,
                 interrupted: Callable | None = None):
    """Batch n's images under their infotexts, in opts.samples_format
    (processing.py:1508-1520, whose save passes no format: the JAX package
    writes PNG whatever samples_format says, the port the format it names,
    as the reference does): the filename tokens read the batch position,
    the model's title and hash and its VAE file from the request."""
    for i, img in enumerate(images):
        if should_save_samples(p, outdir, interrupted):
            p.batch_index, p.iteration = i, n
            p.sd_model_name, p.sd_model_hash = model.title, (model.sha256 or "")[:10]
            p.sd_vae_file = model.vae_file
            saving.save_image(img, outdir, seed=seeds[i], prompt=p.all_prompts[lo + i],
                              info=infotexts[i],
                              extension=opts.get("samples_format", "png") or "png", p=p)


def _apply_grid(all_images: list, infotexts: list, p: GenerationParams,
                model: SDModel) -> int:
    """The grid stage (processing.py:858-891): a grid when opts.return_grid
    or opts.grid_save asks for one, prepended to the images with
    return_grid and saved under p.outpath_grids in opts.grid_format with
    grid_save; returns index_of_first_image."""
    unwanted = len(all_images) < 2 and opts.get("grid_only_if_multiple", True)
    return_grid = opts.get("return_grid", True)
    grid_save = opts.get("grid_save", True)
    if not (return_grid or grid_save) or p.do_not_save_grid or unwanted:
        return 0
    grid = image_grid(all_images, p.batch_size)
    text = infotexts[0] if infotexts else create_infotext(p, model, 0)
    first = 0
    if return_grid:
        infotexts.insert(0, text)
        all_images.insert(0, grid)
        first = 1
    if grid_save and p.outpath_grids:
        saving.save_image(grid, p.outpath_grids, basename="grid",
                          seed=p.all_seeds[0] if p.all_seeds else p.seed,
                          prompt=p.all_prompts[0] if p.all_prompts else p.prompt, info=text,
                          extension=opts.get("grid_format", "png") or "png",
                          short_filename=not opts.get("grid_extended_filename", False),
                          p=p, grid=True)
    return first


def process_txt2img(model: SDModel, p: GenerationParams,
                    step_callback: Callable | None = None,
                    refiner_model: SDModel | None = None,
                    interrupted: Callable | None = None,
                    callback: Callable | None = None,
                    outdir: str | None = None) -> Processed:
    """txt2img with per-request override_settings applied and restored
    (processing.py:1304).  ``step_callback(i, n, latents)`` returning False
    stops sampling; ``interrupted()`` true at the decode lets
    opts.live_preview_fast_interrupt decode with the preview method;
    ``callback("batch", n, None)`` before batch n (False ends the job
    there) and ``callback("batch_done", n, images)`` after it
    (processing.py:1404,1524).  A request with ``refiner_checkpoint`` and
    0 < ``refiner_switch_at`` < 1 needs `refiner_model`; with
    ``enable_hr``, opts.hires_fix_refiner_pass says which pass it refines.
    With `outdir` the images are saved there (``should_save_samples``)."""
    with opts.override(p.override_settings):
        return _process_txt2img(sd_unet.resolve(model), p, step_callback, refiner_model,
                                interrupted, callback, outdir)


def with_tiling(model: SDModel, p: GenerationParams) -> SDModel:
    """The model with circular padding in its UNet and VAE for a `tiling`
    request (processing.py:1348-1354): a copy of the bundle, the same
    modules."""
    if not p.tiling:
        return model
    return dataclasses.replace(model, unet_cfg=dataclasses.replace(model.unet_cfg, tiling=True),
                               vae_cfg=dataclasses.replace(model.vae_cfg, tiling=True))


def check_hybrid(model: SDModel) -> None:
    """Raise for a UNet whose extra input channels the port cannot fill:
    only the inpainting (9), instruct-pix2pix (8) and SD2-depth (5, with
    its depth tower) layouts are known; inpainting_mask_weight other than
    1.0 is not ported (JAX never reads it)."""
    n = model.unet_cfg.in_channels
    if n == model.latent_channels:
        return
    if n not in (5, 8, 9) or (n == 5 and not model.is_depth):
        raise ValueError(f"a {n}-channel UNet{' without a depth model' if n == 5 else ''} "
                         "has no image conditioning the port can build")
    if n == 9 and float(opts.get("inpainting_mask_weight", 1.0)) != 1.0:
        raise NotImplementedError("option 'inpainting_mask_weight' other than 1.0 is not "
                                  "ported (the JAX package never reads it)")


def txt2img_image_conditioning(model: SDModel, batch: int, height: int, width: int):
    """A hybrid UNet's fixed c_concat in txt2img (processing.py:1386-1399,
    the reference's txt2img_image_conditioning), or None: the inpainting
    model sees the latent of a 0.5-grey image under an all-ones mask, the
    depth model a zero depth plane."""
    n = model.unet_cfg.in_channels
    h, w = height // 8, width // 8
    if n == 9:
        grey = np.full((batch, height, width, 3), 0.5, np.float32)
        ones = torch.ones((batch, 1, h, w), device=model.device)
        return torch.cat([ones, encode_first_stage(model, grey)], dim=1)
    if n == 5:
        return torch.zeros((batch, 1, h, w), device=model.device)
    return None


@torch.inference_mode()
def _process_txt2img(model: SDModel, p: GenerationParams,
                     step_callback: Callable | None,
                     refiner_model: SDModel | None,
                     interrupted: Callable | None = None,
                     callback: Callable | None = None,
                     outdir: str | None = None) -> Processed:
    _check_slice(p, txt2img=True)
    check_hybrid(model)
    check_family(model, p, refiner_model)
    hybrid = model.unet_cfg.in_channels != model.latent_channels
    if model.unet_cfg.in_channels == 8:
        raise NotImplementedError(
            "txt2img with an 8-channel (instruct-pix2pix) UNet is not ported: it needs an "
            "init image, and the JAX package builds no c_concat for it")
    if hybrid and p.enable_hr:
        raise NotImplementedError(
            f"enable_hr with a {model.unet_cfg.in_channels}-channel UNet is not ported (the "
            "JAX package's hires pass drops the image conditioning)")
    if uses_refiner(p) and refiner_model is None:
        raise ValueError(f"refiner {p.refiner_checkpoint!r} was requested, "
                         "but no refiner model was given")
    # the always-on scripts' hooks fire where JAX fires them (processing.py:1333-1535)
    runner = get_runner()
    runner.setup_scripts(p)
    runner.before_process(p)
    _reset_ti_usage(model)
    apply_old_hires_behavior(p)
    _resolve_seeds(p)
    _strip_prompt_comments(p)
    # extra networks (processing.py:1340-1346): the tags leave the prompt the
    # conds see, a LoRA set swaps in the merged model; the infotext keeps them
    clean_prompt, model, hypernet = extra_networks.activate(model, p.prompt)
    if p.hypernet_override is not None:     # a training preview's live network
        hypernet = p.hypernet_override
    runner.after_extra_networks_activate(p)
    runner.process(p)
    model = with_tiling(model, p)
    model = apply_attention_options(model)
    model = apply_schedule_overrides(model, p)
    sampler, spec, sigmas, solver_extra = prepare_sampler(model, p, p.steps)
    # which passes the refiner takes when hires fix is on
    # (processing.py:1449-1453,1488; sd_samplers_common.py:183)
    ref_pass = str(opts.get("hires_fix_refiner_pass", "second pass"))
    refine_first = uses_refiner(p) and (not p.enable_hr
                                        or ref_pass in ("first pass", "both passes"))
    hr_refiner = refiner_model if ref_pass in ("second pass", "both passes") else None
    h, w = p.latent_size()
    c = model.latent_channels
    if p.controlnet_units and uses_refiner(p):
        raise NotImplementedError("ControlNet units with a refiner are not ported yet")
    controls = _prepare_units(model, p, p.width, p.height, p.steps)
    c_concat = txt2img_image_conditioning(model, p.batch_size, p.height, p.width)

    all_images, infotexts = [], []
    for n in range(p.n_iter):
        if callback is not None and callback("batch", n, None) is False:
            break
        lo = n * p.batch_size
        seeds = p.all_seeds[lo: lo + p.batch_size]
        subseeds = p.all_subseeds[lo: lo + p.batch_size]
        runner.before_process_batch(p, batch_number=n, seeds=seeds)
        # unclip: a zero adm vector in txt2img (processing.py:1416-1418)
        adm = unclip_adm(model) if model.is_unclip else None
        sched = _build_conds(model, p, p.steps, prompt=clean_prompt, adm_vector=adm)
        sched.skip_uncond = _skip_uncond_mask(sigmas, p)
        sched.c_concat = c_concat
        runner.process_batch(p, batch_number=n, seeds=seeds)
        runner.process_before_every_sampling(p, batch_number=n)
        rng = create_rng((c, h, w), seeds, model.device, subseeds=subseeds,
                         subseed_strength=p.subseed_strength,
                         seed_resize_from_h=max(p.seed_resize_from_h, 0),
                         seed_resize_from_w=max(p.seed_resize_from_w, 0),
                         eta_noise_seed_delta=p.override_settings.get(
                             "eta_noise_seed_delta", 0))
        x = torch.as_tensor(rng.first(), device=model.device) * initial_noise_scale(
            p, float(np.float32(sigmas[0])))
        noise = prepare_noise(spec, len(sigmas) - 1, rng, model.device)
        if refine_first:
            # base → refiner at the switch-point sigma; the refiner's run is
            # a fresh sampler, so multistep history restarts there
            # (processing.py:1447-1468)
            s_idx = _refiner_split_idx(model, sigmas, p.refiner_switch_at, p.steps)
            latents = sample_latents(model, sched, x, sigmas[: s_idx + 1], noise[:s_idx],
                                     sampler.solver, solver_extra,
                                     step_callback=step_callback, total_steps=p.steps,
                                     hypernet=hypernet)
            r_sched = _build_conds(refiner_model, p, p.steps - s_idx, prompt=clean_prompt)
            if sched.skip_uncond is not None:
                r_sched.skip_uncond = sched.skip_uncond[s_idx:]
            latents = sample_latents(refiner_model, r_sched, latents, sigmas[s_idx:],
                                     noise[s_idx:], sampler.solver, solver_extra,
                                     step_callback=step_callback, first_step=s_idx,
                                     total_steps=p.steps)
        else:
            latents = sample_latents(model, sched, x, sigmas, noise, sampler.solver,
                                     solver_extra, step_callback=step_callback,
                                     hypernet=hypernet, controls=controls)
        if p.enable_hr:
            runner.process_before_every_sampling(p, batch_number=n, is_hr_pass=True)
            if opts.get("save_images_before_highres_fix", False) and outdir \
                    and not p.do_not_save_samples:
                save_extra_copies(list(decode_first_stage_u8(model, latents)), p, model, outdir,
                                  seeds, "-before-highres-fix", lo, interrupted)
            latents = _hires_pass(model, p, latents, seeds, subseeds, refiner_model=hr_refiner,
                                  step_callback=step_callback, hypernet=hypernet)
        runner.post_sample(p, PostSampleArgs(latents))
        images = list(decode_first_stage_u8(model, latents,
                                            bool(interrupted and interrupted())))
        images = postprocess_batch(runner, p, images, n)
        if p.restore_faces and opts.get("save_images_before_face_restoration", False):
            save_extra_copies(images, p, model, outdir, seeds, "-before-face-restoration", lo,
                              interrupted)
        images = maybe_restore_faces(p, images, model.device)
        # a script's postprocess_image may replace an image or add to the
        # infotext, so it runs before the infotexts are written
        images = [runner.postprocess_image(p, img) for img in images]
        texts = [create_infotext(p, model, lo + i) for i in range(len(images))]
        save_samples(images, texts, p, model, outdir, seeds, lo, n, interrupted)
        infotexts.extend(texts)
        all_images.extend(images)
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


def postprocess_batch(runner, p: GenerationParams, images: list, n: int) -> list:
    """The postprocess_batch and postprocess_batch_list hooks over batch n's
    decoded images; the list a script left in the latter's argument."""
    runner.postprocess_batch(p, images=images, batch_number=n)
    blist = PostprocessBatchListArgs(images)
    runner.postprocess_batch_list(p, blist)
    return blist.images
