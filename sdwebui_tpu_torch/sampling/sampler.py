"""Sampling driver: a Python step loop over a solver's step function.

Port of ``sdwebui_tpu/sampling/sampler.py:22-94`` plus the step loop that
replaces the JAX ``lax.scan`` (whole-loop CUDA graphs are later work).
The host-side tables a solver needs are built here from the schedule:
LMS's coefficients, UniPC's (order, variant and lower-order-final from
`extra`), and Restart's plan, whose longer run reuses the step noise
cyclically (``processing.py:393-404``).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from sdwebui_tpu_torch.sampling.solvers import (SolverSpec, build_restart_plan,
                                                get_solver, lms_coefficients,
                                                unipc_coefficients)


def prepare_noise(spec: SolverSpec, n_steps: int, image_rng, device) -> torch.Tensor:
    """(n_steps, noises_per_step, B, C, H, W) solver noise from the seeded
    per-image stream (``next_k`` of an NCHW ImageRNG, or of the device
    source's ``DevicePhiloxRNG``, which draws on the device)."""
    flat = image_rng.next_k(n_steps * spec.noises_per_step)   # (n·per, B, C, H, W)
    noise = torch.as_tensor(flat, device=device)
    return noise.reshape(n_steps, spec.noises_per_step, *noise.shape[1:])


def solver_tables(spec: SolverSpec, sigmas: np.ndarray, extra: dict) -> dict:
    """`extra` plus the host tables of LMS, UniPC and Restart for `sigmas`."""
    extra = dict(extra)
    sig64 = np.asarray(sigmas, np.float64)
    if spec.uses_lms_coeffs:
        extra["lms_coeffs"] = lms_coefficients(sig64).astype(np.float32)
    elif spec.uses_unipc:
        extra.update(unipc_coefficients(
            sig64, order=int(extra.pop("uni_pc_order", 3)),
            variant=extra.pop("uni_pc_variant", "bh1"),
            lower_order_final=bool(extra.pop("uni_pc_lower_order_final", True))))
    elif spec.name == "restart":
        extra["restart_pairs"], extra["restart_noise_scale"] = build_restart_plan(sig64)
    return extra


def sample(model: Callable, x, sigmas, solver: str, noise, extra: dict | None = None,
           callback: Callable | None = None):
    """Run `solver` from sigmas[0] to sigmas[-1]; x is already scaled by
    sigmas[0].  callback(i, x) returning False stops the loop."""
    spec = get_solver(solver)
    sigmas = np.asarray(sigmas, np.float32)
    extra = solver_tables(spec, sigmas, extra or {})
    if spec.custom_driver is not None:
        return spec.custom_driver(model, x, sigmas, noise, extra)
    n = len(sigmas) - 1
    if "restart_pairs" in extra:
        n = len(extra["restart_pairs"])
        if noise.shape[0] != n:
            reps = -(-n // max(noise.shape[0], 1))
            noise = noise.repeat(reps, *(1,) * (noise.dim() - 1))[:n]
    state = spec.init_state(x)
    for i in range(n):
        x, state = spec.step(model, x, i, sigmas, noise[i], state, extra)
        if callback is not None and callback(i, x) is False:
            break
    return x
