"""Noise-schedule discretization: alphas_cumprod ↔ sigma tables (numpy, fp64).

A copy of what the txt2img slice needs from
``sdwebui_tpu/sampling/discretization.py`` (the JAX package's ``sampling``
``__init__`` imports jax, so the module cannot be reused from there);
tests hold both equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np


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
