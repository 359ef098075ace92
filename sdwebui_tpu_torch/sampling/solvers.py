"""Diffusion solvers as step functions.

Port of ``sdwebui_tpu/sampling/solvers.py``: every solver is

    step(model, x, i, sigmas, noise, state, extra) -> (x_next, state)

with ``model(x, sigma, i) -> denoised``.  Ported: Euler ancestral
(``solvers.py:39-47,85-92``) and DPM++ 2M (``solvers.py:199-215``); the
sigma arithmetic runs on the host in float32, as the JAX scan does on
device.  Other solvers raise ``NotImplementedError`` naming the solver.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

_EPS = np.float32(1e-12)


def _log(s):
    return np.log(np.maximum(np.float32(s), _EPS))


def _ancestral(sigma_from, sigma_to, eta):
    sf, st = np.float32(sigma_from), np.float32(sigma_to)
    su = np.minimum(st, np.float32(eta) * np.sqrt(np.maximum(
        st ** 2 * (sf ** 2 - st ** 2) / np.maximum(sf ** 2, _EPS), np.float32(0))))
    sd = np.sqrt(np.maximum(st ** 2 - su ** 2, np.float32(0)))
    return float(sd), float(su)


def euler_ancestral_step(model, x, i, sigmas, noise, state, extra):
    s, s_next = np.float32(sigmas[i]), np.float32(sigmas[i + 1])
    denoised = model(x, float(s), i)
    sd, su = _ancestral(s, s_next, extra.get("eta", 1.0))
    x = x + (x - denoised) / float(np.maximum(s, _EPS)) * (sd - float(s))
    if s_next > 0:
        x = x + noise[0] * su * extra.get("s_noise", 1.0)
    return x, state


def dpmpp_2m_step(model, x, i, sigmas, noise, state, extra):
    """DPM-Solver++(2M): one model call, the previous denoised carried in
    `state`.  The first step (and a step to σ = 0) is first order, so a
    fresh ``sample`` call — the refiner handoff — restarts the history."""
    s, s_next = np.float32(sigmas[i]), np.float32(sigmas[i + 1])
    denoised = model(x, float(s), i)
    t, t_next = -_log(s), -_log(s_next)
    h = t_next - t
    if i > 0 and s_next != 0:
        h_last = t + _log(sigmas[i - 1])
        r = h_last / (h if h != 0 else _EPS)
        c = np.float32(1) / (np.float32(2) * r)
        denoised_d = denoised * float(np.float32(1) + c) - state["old_denoised"] * float(c)
    else:
        denoised_d = denoised
    x = x * float(s_next / np.maximum(s, _EPS)) - denoised_d * float(np.expm1(-h))
    return x, {"old_denoised": denoised}


@dataclasses.dataclass(frozen=True)
class SolverSpec:
    name: str
    step: Callable
    noises_per_step: int = 0

    def init_state(self, x):
        return {}


SOLVERS = {
    "euler_ancestral": SolverSpec("euler_ancestral", euler_ancestral_step,
                                  noises_per_step=1),
    "dpmpp_2m": SolverSpec("dpmpp_2m", dpmpp_2m_step),
}


def get_solver(name: str) -> SolverSpec:
    if name not in SOLVERS:
        raise NotImplementedError(f"solver {name!r} is not ported yet")
    return SOLVERS[name]
