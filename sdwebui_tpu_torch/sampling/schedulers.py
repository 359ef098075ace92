"""Named sigma schedules (numpy), copied from ``sdwebui_tpu/sampling/schedulers.py``.

The slice accepts the k-diffusion schedules; the timestep-sampler
schedules (DDIM, UniPC's quadratic) come with their solvers.  Tests hold
each copy equal to the JAX package's output.
"""

from __future__ import annotations

import numpy as np

from sdwebui_tpu_torch.sampling.discretization import Discretization


def uniform(n, sigma_min, sigma_max, disc: Discretization, **kw):
    return disc.get_sigmas(n)


def karras(n, sigma_min, sigma_max, disc=None, rho=7.0, **kw):
    ramp = np.linspace(0, 1, n)
    min_inv_rho = sigma_min ** (1 / rho)
    max_inv_rho = sigma_max ** (1 / rho)
    sigmas = (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho
    return np.append(sigmas, 0.0)


def exponential(n, sigma_min, sigma_max, disc=None, **kw):
    sigmas = np.exp(np.linspace(np.log(sigma_max), np.log(sigma_min), n))
    return np.append(sigmas, 0.0)


def polyexponential(n, sigma_min, sigma_max, disc=None, rho=1.0, **kw):
    ramp = np.linspace(1, 0, n) ** rho
    sigmas = np.exp(ramp * (np.log(sigma_max) - np.log(sigma_min)) + np.log(sigma_min))
    return np.append(sigmas, 0.0)


def sgm_uniform(n, sigma_min, sigma_max, disc: Discretization, **kw):
    start = disc.sigma_to_t(np.float64(sigma_max), do_quantize=False)
    end = disc.sigma_to_t(np.float64(sigma_min), do_quantize=False)
    ts = np.linspace(start, end, n + 1)[:-1]
    return np.append(disc.t_to_sigma(ts), 0.0)


def kl_optimal(n, sigma_min, sigma_max, disc=None, **kw):
    alpha_min = np.arctan(sigma_min)
    alpha_max = np.arctan(sigma_max)
    idx = np.arange(n + 1, dtype=np.float64)
    return np.tan(idx / n * alpha_min + (1.0 - idx / n) * alpha_max)


_AYS_SDXL = [14.615, 6.315, 3.771, 2.181, 1.342, 0.862, 0.555, 0.380, 0.234, 0.113, 0.029]
_AYS_SD15 = [14.615, 6.475, 3.861, 2.697, 1.886, 1.396, 0.963, 0.652, 0.399, 0.152, 0.029]


def align_your_steps(n, sigma_min, sigma_max, disc=None, is_sdxl=False, **kw):
    table = _AYS_SDXL if is_sdxl else _AYS_SD15
    if n != len(table):
        xs = np.linspace(0, 1, len(table))
        ys = np.log(np.asarray(table)[::-1])
        new_ys = np.interp(np.linspace(0, 1, n), xs, ys)
        sigmas = np.exp(new_ys)[::-1]
    else:
        sigmas = np.asarray(table, dtype=np.float64)
    return np.append(sigmas, 0.0)


def simple(n, sigma_min, sigma_max, disc: Discretization, **kw):
    ss = len(disc.sigmas) / n
    sigs = [float(disc.sigmas[-(1 + int(x * ss))]) for x in range(n)]
    return np.append(np.asarray(sigs), 0.0)


def normal(n, sigma_min, sigma_max, disc: Discretization, **kw):
    start = disc.sigma_to_t(np.float64(sigma_max), do_quantize=False)
    end = disc.sigma_to_t(np.float64(sigma_min), do_quantize=False)
    ts = np.linspace(start, end, n)
    return np.append(disc.t_to_sigma(ts), 0.0)


def beta(n, sigma_min, sigma_max, disc=None, beta_alpha=0.6, beta_beta=0.6, **kw):
    from scipy import stats

    timesteps = 1 - np.linspace(0, 1, n)
    timesteps = np.asarray([stats.beta.ppf(x, beta_alpha, beta_beta) for x in timesteps])
    sigmas = sigma_min + timesteps * (sigma_max - sigma_min)
    return np.append(sigmas, 0.0)


SCHEDULERS = {
    "automatic": uniform,
    "uniform": uniform,
    "karras": karras,
    "exponential": exponential,
    "polyexponential": polyexponential,
    "sgm_uniform": sgm_uniform,
    "kl_optimal": kl_optimal,
    "align_your_steps": align_your_steps,
    "simple": simple,
    "normal": normal,
    "beta": beta,
}

ALIASES = {
    "Automatic": "automatic", "Uniform": "uniform", "Karras": "karras",
    "Exponential": "exponential", "Polyexponential": "polyexponential",
    "SGM Uniform": "sgm_uniform", "SGMUniform": "sgm_uniform",
    "KL Optimal": "kl_optimal", "Align Your Steps": "align_your_steps",
    "Simple": "simple", "Normal": "normal", "Beta": "beta",
}

#: option names whose non-default values reshape every schedule
_SCHEDULE_OPTS = ("sigma_min", "sigma_max", "rho")


def schedule_key(name: str) -> str:
    key = ALIASES.get(name, name.lower() if name else "automatic")
    if key not in SCHEDULERS:
        raise ValueError(f"unknown or unported scheduler {name!r}")
    return key


def get_schedule(name: str, n: int, disc: Discretization, **kw) -> np.ndarray:
    from sdwebui_tpu_torch.utils.options import opts

    for opt in _SCHEDULE_OPTS:
        if float(opts.get(opt, 0.0) or 0.0) > 0:
            raise NotImplementedError(f"option {opt!r} is not ported yet")
    fn = SCHEDULERS[schedule_key(name)]
    return fn(n, disc.sigma_min, disc.sigma_max, disc, **kw).astype(np.float64)
