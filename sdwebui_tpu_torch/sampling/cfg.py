"""Classifier-free-guidance denoiser — the per-step hot loop.

Port of ``sdwebui_tpu/sampling/cfg.py:30-241``.  Prompt-edit schedules are
pre-gathered cond banks indexed per step; cond and uncond ride one batched
UNet call; AND weights and skip-uncond steps are applied in the combine.
The per-step indices stay on the host (the step loop is Python), the banks
on the device.

Cond layout (per run):
    cond_bank    (K, n_sched, S, D)  K composable prompts (AND), each with a
                                     prompt-edit schedule bank
    cond_idx     (K, n_steps)        host ints: schedule entry per step
    cond_weights (K,)                host floats: AND weights
    uncond_bank  (n_sched_u, S, D) + uncond_idx (n_steps,)
    vector_bank  (K, n_sched, D_adm)  SDXL y vectors, indexed like the
                                     conds; vector_uncond_bank (n_sched_u, D_adm)
x is (B, C, H, W) and the UNet call carries B·(K+1) items.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Callable

import numpy as np
import torch


@dataclasses.dataclass
class CondSchedule:
    cond_bank: torch.Tensor
    cond_idx: np.ndarray
    cond_weights: np.ndarray
    uncond_bank: torch.Tensor
    uncond_idx: np.ndarray
    cond_scale: float = 7.5
    # NGMS: per-step bool, True = uncond contribution skipped this step
    skip_uncond: np.ndarray | None = None
    # SDXL vector conds (pooled text + size/crop embeds), scheduled like the
    # crossattn banks
    vector_bank: torch.Tensor | None = None
    vector_uncond_bank: torch.Tensor | None = None
    # hybrid UNets' image conditioning (N, C', H, W), concatenated onto the
    # latent's channels: the inpainting model's [mask, masked latent], the
    # edit model's init latent, SD2-depth's depth plane
    c_concat: torch.Tensor | None = None
    # instruct-pix2pix's image guidance scale: set, the 3-way edit CFG runs
    image_cfg_scale: float | None = None


def soft_latent_blend(a, b, t, detail_preservation: float = 4.0):
    """Magnitude-corrected lerp of soft inpainting (cfg.py:91-105; the
    reference's soft-inpainting ``latent_blend``): directions lerp linearly,
    magnitudes (norms over the channel axis, dim 1 in NCHW) lerp in a
    power-`detail_preservation` space, biased toward the stronger one."""
    interp = (a * (1 - t) + b * t).float()
    cur_mag = torch.linalg.vector_norm(interp, dim=1, keepdim=True) + 1e-5
    a_mag = torch.linalg.vector_norm(a.float(), dim=1, keepdim=True) ** detail_preservation
    b_mag = torch.linalg.vector_norm(b.float(), dim=1, keepdim=True) ** detail_preservation
    t1 = t[:, :1].float()
    desired = (a_mag * (1 - t1) + b_mag * t1) ** (1 / detail_preservation)
    return (interp * desired / cur_mag).to(a.dtype)


def make_cfg_denoiser(denoise_fn: Callable, sched: CondSchedule,
                      mask=None, nmask=None, init_latent=None,
                      mask_before_denoising: bool = False,
                      soft_inpainting=None, return_uncond: bool = False) -> Callable:
    """Build model(x, sigma, i) -> denoised for the solver loop.

    denoise_fn(x, sigma, context) -> denoised for x (N, C, H, W) at the
    scalar noise level sigma (shared by the whole CFG batch); with vector
    banks it is called as denoise_fn(x, sigma, context, y), y (N, D_adm) in
    the context's row order.  mask (keep weight) / nmask (repaint weight)
    / init_latent are the latent mask blend: on the denoised output, or on
    the input with mask_before_denoising (cfg.py:145-146,195-197).
    return_uncond (DDIM CFG++): the guidance scale is divided by 12.5 and
    the model returns stacked [cfg, uncond] (cfg.py:178-202).  A step past
    the schedule (a Restart plan's or a DPM driver's extra calls) takes
    its last entry, as JAX's clamped gather does.  A denoise_fn with a
    `step` parameter is also given the step index (cfg.py:122-131: the
    ControlNet guidance range reads it).  A schedule's c_concat goes to
    denoise_fn as ``c_concat=``, tiled over the K+1 CFG rows
    (cfg.py:168-170); with image_cfg_scale set, the edit model's 3-way
    CFG runs instead (:func:`_make_edit_denoiser`).  soft_inpainting
    (power, scale, detail) with a mask: the input is blended with the
    init latent by the σ-scheduled mask nmask^(σ^power · scale) before
    denoising, and no blend follows (cfg.py:138-145,195-197).
    """
    if sched.image_cfg_scale is not None:
        if soft_inpainting is not None:
            raise NotImplementedError(
                "soft inpainting with the instruct-pix2pix edit CFG is not ported (the "
                "JAX package's edit denoiser drops it)")
        return _make_edit_denoiser(denoise_fn, sched, mask, nmask, init_latent,
                                   mask_before_denoising)
    k = sched.cond_bank.shape[0]
    rows = torch.arange(k, device=sched.cond_bank.device)
    pass_step = "step" in inspect.signature(denoise_fn).parameters

    scale = sched.cond_scale * (1.0 / 12.5 if return_uncond else 1.0)
    last = sched.cond_idx.shape[1] - 1

    def combine(out, i):
        out_conds, out_uncond = out[:k], out[k]
        w = torch.as_tensor(np.asarray(sched.cond_weights, np.float32),
                            device=out.device).to(out.dtype)[:, None, None, None, None]
        if sched.skip_uncond is not None and bool(sched.skip_uncond[i]):
            # NGMS: the skipped-uncond step returns the weighted cond mean
            return (w * out_conds).sum(0) / float(np.sum(sched.cond_weights))
        return out_uncond + (w * (out_conds - out_uncond[None])).sum(0) * scale

    soft = soft_inpainting is not None and nmask is not None

    def model(x, sigma: float, i: int):
        step_kw = {"step": i} if pass_step else {}
        i = min(i, last)
        if soft:
            power, soft_scale, detail = soft_inpainting
            f32 = np.float32
            t = torch.pow(nmask, float(f32(f32(sigma) ** f32(power)) * f32(soft_scale)))
            x = soft_latent_blend(init_latent, x, t, detail)
        elif mask is not None and mask_before_denoising:
            x = init_latent * mask + nmask * x
        b = x.shape[0]
        idx = torch.as_tensor(sched.cond_idx[:, i], device=rows.device)
        u = int(sched.uncond_idx[i])
        # context: K cond copies per image, then uncond — (B·(K+1), S, D)
        ctx = torch.cat([sched.cond_bank[rows, idx], sched.uncond_bank[u][None]],
                        dim=0).repeat_interleave(b, dim=0)
        x_in = x.repeat(k + 1, 1, 1, 1)
        if sched.c_concat is not None:
            step_kw["c_concat"] = sched.c_concat.repeat(k + 1, 1, 1, 1)
        if sched.vector_bank is None:
            out = denoise_fn(x_in, sigma, ctx, **step_kw)
        else:
            y = torch.cat([sched.vector_bank[rows, idx], sched.vector_uncond_bank[u][None]],
                          dim=0).repeat_interleave(b, dim=0)
            out = denoise_fn(x_in, sigma, ctx, y, **step_kw)
        out = out.reshape(k + 1, b, *out.shape[1:])
        cfg = combine(out, i)
        if not soft and mask is not None and not mask_before_denoising:
            cfg = cfg * nmask + init_latent * mask
        if return_uncond:
            return torch.stack([cfg, out[k]])
        return cfg

    return model


def _make_edit_denoiser(denoise_fn: Callable, sched: CondSchedule, mask, nmask, init_latent,
                        mask_before_denoising: bool) -> Callable:
    """instruct-pix2pix's 3-way CFG (cfg.py:205-241; the reference's
    combine_denoised_for_edit_model): rows [cond + image, uncond + image,
    uncond + zero image], then uncond + s_txt·(cond − image) +
    s_img·(image − uncond).  The first cond only (AND is not composed for
    edit models), no vector conds, and no step index: JAX's edit denoiser
    passes none, so ControlNet guidance ranges do not run with it."""
    last = sched.cond_idx.shape[1] - 1

    def model(x, sigma: float, i: int):
        i = min(i, last)
        if mask is not None and mask_before_denoising:
            x = init_latent * mask + nmask * x
        b = x.shape[0]
        cond = sched.cond_bank[0, int(sched.cond_idx[0, i])]
        uncond = sched.uncond_bank[int(sched.uncond_idx[i])]
        ctx = torch.stack([cond, uncond, uncond]).repeat_interleave(b, dim=0)
        cc = sched.c_concat
        c_concat = torch.cat([cc, cc, torch.zeros_like(cc)], dim=0)
        out = denoise_fn(x.repeat(3, 1, 1, 1), sigma, ctx, c_concat=c_concat)
        out_cond, out_img, out_uncond = out.reshape(3, b, *out.shape[1:])
        cfg = out_uncond + sched.cond_scale * (out_cond - out_img) \
            + float(sched.image_cfg_scale) * (out_img - out_uncond)
        if mask is not None and not mask_before_denoising:
            cfg = cfg * nmask + init_latent * mask
        return cfg

    return model
