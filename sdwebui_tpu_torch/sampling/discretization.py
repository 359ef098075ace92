"""Noise-schedule discretization: alphas_cumprod ↔ sigma tables (numpy, fp64).

A copy of what the port's samplers need from
``sdwebui_tpu/sampling/discretization.py`` (the JAX package's ``sampling``
``__init__`` imports jax, so the module cannot be reused from there): the
sigma table, LCM's distillation subtable and SD3's rectified-flow table.
Tests hold both equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def rescale_zero_terminal_snr_abar(alphas_cumprod: np.ndarray) -> np.ndarray:
    """Shift/scale √ᾱ so the terminal step has zero SNR (Lin et al. 2023;
    the reference's rescale_zero_terminal_snr_abar, applied by the
    sd_noise_schedule='Zero Terminal SNR' setting): discretization.py:17."""
    sqrt = np.sqrt(np.asarray(alphas_cumprod, np.float64))
    sqrt_0, sqrt_t = sqrt[0], sqrt[-1]
    sqrt = (sqrt - sqrt_t) * sqrt_0 / (sqrt_0 - sqrt_t)
    abar = sqrt ** 2
    abar[-1] = 4.8973451890853435e-08   # the reference's terminal epsilon
    return abar


def make_alphas_cumprod(linear_start: float = 0.00085, linear_end: float = 0.0120,
                        timesteps: int = 1000) -> np.ndarray:
    """ldm 'linear' schedule: betas linear in sqrt-space."""
    betas = np.linspace(linear_start ** 0.5, linear_end ** 0.5, timesteps,
                        dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas, axis=0)


@dataclasses.dataclass
class Discretization:
    """sigma table + parameterization for one trained diffusion model."""

    alphas_cumprod: np.ndarray
    prediction_type: str = "eps"
    quantize: bool = True

    def __post_init__(self):
        ac = np.asarray(self.alphas_cumprod, dtype=np.float64)
        self.sigmas = np.sqrt((1.0 - ac) / ac)  # (T,)
        self.log_sigmas = np.log(self.sigmas)

    @property
    def sigma_min(self) -> float:
        return float(self.sigmas[0])

    @property
    def sigma_max(self) -> float:
        return float(self.sigmas[-1])

    def sigma_to_t(self, sigma, do_quantize: bool | None = None):
        """Continuous (interpolated) or quantized timestep for sigma."""
        sigma = np.asarray(sigma, dtype=np.float64)
        log_sigma = np.log(sigma)
        dists = log_sigma[..., None] - self.log_sigmas[None, :]
        if do_quantize if do_quantize is not None else self.quantize:
            return np.abs(dists).argmin(axis=-1).astype(np.float64)
        low_idx = np.clip((dists >= 0).cumsum(axis=-1).argmax(axis=-1),
                          0, len(self.sigmas) - 2)
        high_idx = low_idx + 1
        low = self.log_sigmas[low_idx]
        high = self.log_sigmas[high_idx]
        w = np.clip((low - log_sigma) / (low - high), 0, 1)
        return (1 - w) * low_idx + w * high_idx

    def t_to_sigma(self, t):
        t = np.asarray(t, dtype=np.float64)
        low_idx = np.floor(t).astype(int)
        high_idx = np.ceil(t).astype(int)
        w = t - low_idx
        return np.exp((1 - w) * self.log_sigmas[low_idx] + w * self.log_sigmas[high_idx])

    def get_sigmas(self, n: int) -> np.ndarray:
        """k-diffusion default ('Automatic'/'Uniform') schedule."""
        t = np.linspace(len(self.sigmas) - 1, 0, n)
        return np.append(self.t_to_sigma(t), 0.0).astype(np.float64)


def lcm_subtable(disc, original_timesteps: int = 50):
    """LCM's 50-entry distillation sigma subtable (reference
    modules/sd_samplers_lcm.py LCMCompVisDenoiser.__init__):
    alphas_cumprod_valid[orig-1-x] = alphas_cumprod[T-1-x*skip], i.e. full
    timesteps t = skip-1, 2*skip-1, …, T-1 ascending.  Returns
    (t_full (orig,), sigmas (orig,)) both ascending."""
    ac = np.asarray(disc.alphas_cumprod, np.float64)
    T = len(ac)
    skip = T // original_timesteps
    t_full = np.arange(skip - 1, T, skip)
    sub_ac = ac[t_full]
    return t_full, np.sqrt((1.0 - sub_ac) / sub_ac)


def lcm_schedule(disc, n: int, original_timesteps: int = 50) -> np.ndarray:
    """LCM 'Automatic' schedule (LCMCompVisDenoiser.get_sigmas(n)): uniform
    in full-range timestep between the subtable's max and min, each mapped
    back through the subtable's interpolated t→sigma, then append zero."""
    t_full, sub_sigmas = lcm_subtable(disc, original_timesteps)
    log_sub = np.log(sub_sigmas)
    skip = len(disc.alphas_cumprod) // original_timesteps
    start, end = float(t_full[-1]), float(t_full[0])
    t = np.linspace(start, end, n)
    # t_to_sigma: clamp to subtable index space, lerp in log sigma
    ts = np.clip((t - (skip - 1)) / skip, 0, original_timesteps - 1)
    low = np.floor(ts).astype(int)
    high = np.ceil(ts).astype(int)
    w = ts - low
    log_sigma = (1 - w) * log_sub[low] + w * log_sub[high]
    return np.concatenate([np.exp(log_sigma), [0.0]])


class FlowDiscretization(Discretization):
    """Rectified-flow (SD3) sigma table (discretization.py:111-136):
    σ(t) = shift·t / (1 + (shift−1)·t), t = 1/T … 1, so σ_max = 1; the model
    timestep is σ·1000.  x_t is the LERP σ·noise + (1−σ)·x0, not variance
    exploding: the pipeline branches on prediction_type == "flow"."""

    def __init__(self, shift: float = 3.0, timesteps: int = 1000):
        self.shift = shift
        t = np.arange(1, timesteps + 1, dtype=np.float64) / timesteps
        self.prediction_type = "flow"
        self.quantize = False
        self.alphas_cumprod = None
        self.sigmas = self.shift * t / (1 + (self.shift - 1) * t)
        self.log_sigmas = np.log(self.sigmas)

    def noise_scaling(self, sigma, noise, latent):
        return sigma * noise + (1.0 - sigma) * latent
