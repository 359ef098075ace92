"""The 12 named sigma schedules (reference modules/sd_schedulers.py:130-143).

Copy of ``sdwebui_tpu/sampling/schedulers.py``: pure host-side numpy; each
returns an (n+1,) float64 array ending in 0.  Tests hold every schedule
equal to the JAX package's.
"""

from __future__ import annotations

import numpy as np

from sdwebui_tpu_torch.sampling.discretization import Discretization


def uniform(n, sigma_min, sigma_max, disc: Discretization, **kw):
    """k-diffusion DiscreteSchedule.get_sigmas (reference 'uniform'/'automatic')."""
    return disc.get_sigmas(n)


def karras(n, sigma_min, sigma_max, disc=None, rho=7.0, **kw):
    """Karras et al. 2022 eq.5 power ramp (k_diffusion.sampling.get_sigmas_karras)."""
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
    """reference sd_schedulers.py:33 — n+1 timesteps, drop last, no final interp."""
    start = disc.sigma_to_t(np.float64(sigma_max), do_quantize=False)
    end = disc.sigma_to_t(np.float64(sigma_min), do_quantize=False)
    ts = np.linspace(start, end, n + 1)[:-1]
    return np.append(disc.t_to_sigma(ts), 0.0)


def kl_optimal(n, sigma_min, sigma_max, disc=None, **kw):
    """reference sd_schedulers.py:73 (arXiv:2404.xxxx KL-optimal ancestral)."""
    alpha_min = np.arctan(sigma_min)
    alpha_max = np.arctan(sigma_max)
    idx = np.arange(n + 1, dtype=np.float64)
    return np.tan(idx / n * alpha_min + (1.0 - idx / n) * alpha_max)


_AYS_SDXL = [14.615, 6.315, 3.771, 2.181, 1.342, 0.862, 0.555, 0.380, 0.234, 0.113, 0.029]
_AYS_SD15 = [14.615, 6.475, 3.861, 2.697, 1.886, 1.396, 0.963, 0.652, 0.399, 0.152, 0.029]


def align_your_steps(n, sigma_min, sigma_max, disc=None, is_sdxl=False, **kw):
    """NVIDIA Align-Your-Steps (reference sd_schedulers.py:44)."""
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
    """reference sd_schedulers.py:81 — evenly strided raw table entries."""
    ss = len(disc.sigmas) / n
    sigs = [float(disc.sigmas[-(1 + int(x * ss))]) for x in range(n)]
    return np.append(np.asarray(sigs), 0.0)


def normal(n, sigma_min, sigma_max, disc: Discretization, **kw):
    """reference sd_schedulers.py:90 — t-linspace, t_to_sigma per step."""
    start = disc.sigma_to_t(np.float64(sigma_max), do_quantize=False)
    end = disc.sigma_to_t(np.float64(sigma_min), do_quantize=False)
    ts = np.linspace(start, end, n)
    return np.append(disc.t_to_sigma(ts), 0.0)


def ddim(n, sigma_min, sigma_max, disc: Discretization, **kw):
    """reference sd_schedulers.py:107 — classic DDIM integer stride; the
    opts.ddim_discretize='quad' variant uses the quadratic timestep spacing
    of the original CompVis DDIMSampler (reference
    modules/sd_samplers_timesteps.py make_ddim_timesteps)."""
    from sdwebui_tpu_torch.utils.options import opts as _opts

    total = len(disc.sigmas)
    if _opts.get("ddim_discretize", "uniform") == "quad":
        idx = (np.linspace(0, np.sqrt(total * 0.8), n) ** 2).astype(int) + 1
        idx = np.clip(idx, 1, total - 1)
    else:
        ss = max(total // n, 1)
        idx = np.arange(1, total, ss)
    sigs = [float(disc.sigmas[x]) for x in idx]
    return np.append(np.asarray(sigs[::-1]), 0.0)


def beta(n, sigma_min, sigma_max, disc=None, beta_alpha=0.6, beta_beta=0.6, **kw):
    """'Beta Sampling is All You Need' (arXiv:2407.12173); reference :119."""
    from scipy import stats

    timesteps = 1 - np.linspace(0, 1, n)
    timesteps = np.asarray([stats.beta.ppf(x, beta_alpha, beta_beta) for x in timesteps])
    sigmas = sigma_min + timesteps * (sigma_max - sigma_min)
    return np.append(sigmas, 0.0)


def unipc_quadratic(n, sigma_min, sigma_max, disc: Discretization, **kw):
    """UniPC skip_type='time_quadratic': timesteps spaced quadratically in
    √t (reference modules/models/diffusion/uni_pc/uni_pc.py
    get_time_steps); internal — selected via the uni_pc_skip_type option,
    not the scheduler dropdown."""
    t_max = disc.sigma_to_t(np.float64(sigma_max), do_quantize=False)
    t_min = disc.sigma_to_t(np.float64(sigma_min), do_quantize=False)
    ts = np.linspace(np.sqrt(t_max), np.sqrt(t_min), n) ** 2
    return np.append(disc.t_to_sigma(ts), 0.0)


SCHEDULERS = {
    "automatic": uniform,
    "unipc_quadratic": unipc_quadratic,
    "uniform": uniform,
    "karras": karras,
    "exponential": exponential,
    "polyexponential": polyexponential,
    "sgm_uniform": sgm_uniform,
    "kl_optimal": kl_optimal,
    "align_your_steps": align_your_steps,
    "simple": simple,
    "normal": normal,
    "ddim": ddim,
    "beta": beta,
}

ALIASES = {
    "Automatic": "automatic", "Uniform": "uniform", "Karras": "karras",
    "Exponential": "exponential", "Polyexponential": "polyexponential",
    "SGM Uniform": "sgm_uniform", "SGMUniform": "sgm_uniform",
    "KL Optimal": "kl_optimal", "Align Your Steps": "align_your_steps",
    "Simple": "simple", "Normal": "normal", "DDIM": "ddim", "Beta": "beta",
}


def get_schedule(name: str, n: int, disc: Discretization,
                 sigma_min: float | None = None, sigma_max: float | None = None,
                 **kw) -> np.ndarray:
    key = ALIASES.get(name, name.lower() if name else "automatic")
    if key not in SCHEDULERS:
        raise ValueError(f"unknown scheduler {name!r}")
    fn = SCHEDULERS[key]
    # opts overrides (reference sd_samplers_kdiffusion.get_sigmas: nonzero
    # sigma_min/sigma_max/rho options replace the model/scheduler defaults;
    # drives the XYZ "Schedule min/max sigma" and "Schedule rho" axes)
    from sdwebui_tpu_torch.utils.options import opts as _opts

    if sigma_min is None and float(_opts.get("sigma_min", 0.0) or 0.0) > 0:
        sigma_min = float(_opts.get("sigma_min"))
    if sigma_max is None and float(_opts.get("sigma_max", 0.0) or 0.0) > 0:
        sigma_max = float(_opts.get("sigma_max"))
    if "rho" not in kw and float(_opts.get("rho", 0.0) or 0.0) > 0 \
            and key in ("karras", "polyexponential"):
        kw["rho"] = float(_opts.get("rho"))
    return fn(n, sigma_min if sigma_min is not None else disc.sigma_min,
              sigma_max if sigma_max is not None else disc.sigma_max,
              disc, **kw).astype(np.float64)
