"""Sampling driver: a Python step loop over a solver's step function.

Port of ``sdwebui_tpu/sampling/sampler.py:22-30`` plus the step loop that
replaces the JAX ``lax.scan`` (whole-loop CUDA graphs are later work).
"""

from __future__ import annotations

from typing import Callable

import torch

from sdwebui_tpu_torch.sampling.solvers import SolverSpec, get_solver


def prepare_noise(spec: SolverSpec, n_steps: int, image_rng, device) -> torch.Tensor:
    """(n_steps, noises_per_step, B, C, H, W) solver noise from the seeded
    per-image stream (ImageRNG.next_k with channels_last=False)."""
    flat = image_rng.next_k(n_steps * spec.noises_per_step)   # (n·per, B, C, H, W)
    noise = torch.from_numpy(flat).to(device)
    return noise.reshape(n_steps, spec.noises_per_step, *noise.shape[1:])


def sample(model: Callable, x, sigmas, solver: str, noise, extra: dict | None = None,
           callback: Callable | None = None):
    """Run `solver` from sigmas[0] to sigmas[-1]; x is already scaled by
    sigmas[0].  callback(i, x) returning False stops the loop."""
    spec = get_solver(solver)
    extra = dict(extra or {})
    state = spec.init_state(x)
    for i in range(len(sigmas) - 1):
        x, state = spec.step(model, x, i, sigmas, noise[i], state, extra)
        if callback is not None and callback(i, x) is False:
            break
    return x
