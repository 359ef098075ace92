"""Spectrally-matched noise fill for outpainting.

Reimplements the behaviour of the reference's outpainting mk2 noise
synthesis (scripts/outpainting_mk_2.py get_matched_noise, itself from the
g-diffuser project): the region to be outpainted is filled with noise whose
magnitude spectrum and phase follow the (windowed) source image and whose
per-channel histogram matches the unmasked pixels — so the sampler starts
from texture that already "belongs" to the image.

Differences from the reference, by construction rather than omission:
histogram matching uses direct quantile mapping (equivalent to
skimage.exposure.match_histograms up to value ties; skimage is not a
dependency).

Copy of ``sdwebui_tpu/postprocessing/noise_match.py`` (numpy only);
``tests/test_torch_copies.py`` holds it equal.
"""

from __future__ import annotations

import numpy as np


def _fft2c(data: np.ndarray) -> np.ndarray:
    """Centered, ortho-normalized 2D FFT over leading two axes, per channel."""
    out = np.empty(data.shape, np.complex128)
    for c in range(data.shape[2]):
        out[:, :, c] = np.fft.ifftshift(
            np.fft.fft2(np.fft.fftshift(data[:, :, c]), norm="ortho"))
    return out


def _ifft2c(data: np.ndarray) -> np.ndarray:
    out = np.empty(data.shape, np.complex128)
    for c in range(data.shape[2]):
        out[:, :, c] = np.fft.ifftshift(
            np.fft.ifft2(np.fft.fftshift(data[:, :, c]), norm="ortho"))
    return out


def _lowpass_window(h: int, w: int, std: float = 3.14) -> np.ndarray:
    """Rational low-pass window (the reference's mode-1 'not actually
    gaussian' window), aspect-normalized."""
    sy = h / min(h, w)
    sx = w / min(h, w)
    fy = ((np.arange(h) / h * 2.0 - 1.0) * sy)[:, None]
    fx = ((np.arange(w) / w * 2.0 - 1.0) * sx)[None, :]
    return (1.0 / ((fy ** 2 + 1.0) * (fx ** 2 + 1.0))) ** (std / 3.14)


def match_histograms_1d(values: np.ndarray, template: np.ndarray) -> np.ndarray:
    """Quantile-map `values` onto the distribution of `template`."""
    order = np.argsort(values, kind="stable")
    ranks = np.empty(len(values), np.float64)
    ranks[order] = np.arange(len(values))
    quantiles = ranks / max(len(values) - 1, 1)
    t_sorted = np.sort(template)
    t_q = np.linspace(0.0, 1.0, len(t_sorted))
    return np.interp(quantiles, t_q, t_sorted)


def matched_noise(src: np.ndarray, mask_rgb: np.ndarray,
                  noise_q: float = 1.0,
                  color_variation: float = 0.05) -> np.ndarray:
    """src: (H,W,3) float in [0,1]; mask_rgb: (H,W,3) float in [0,1]
    (1 = region to fill).  Returns (H,W,3) in [0,1] with the masked region
    replaced by source-spectrum-shaped, histogram-matched noise."""
    h, w, nc = src.shape
    mask_grey = mask_rgb.sum(axis=2) / 3.0
    fill_px = mask_grey > 1e-6
    ref_px = mask_grey < 1e-3

    # windowed source: keep unmasked content, fill masked area with the
    # average color so the FFT sees sane statistics
    windowed = src * (1.0 - mask_rgb)
    peak = np.max(windowed)
    if peak > 0:
        windowed = windowed / peak
    windowed = windowed + np.average(src) * mask_rgb

    src_fft = _fft2c(windowed)
    src_mag = np.absolute(src_fft)
    src_mag = np.where(src_mag == 0, 1e-12, src_mag)
    src_phase = src_fft / src_mag

    # seeded start noise, blended toward grey by (1 - color_variation)
    rng = np.random.default_rng(0)
    noise = rng.random((h, w, nc))
    grey = noise.sum(axis=2) / 3.0
    noise = noise * color_variation + (1.0 - color_variation) * grey[..., None]

    # low-pass the start noise, then shape it with the source spectrum
    window = _lowpass_window(h, w)
    noise_fft = _fft2c(noise) * window[..., None]
    noise = np.real(_ifft2c(noise_fft))
    shaped_fft = _fft2c(noise)
    shaped_fft = (np.absolute(shaped_fft) ** 2) * (src_mag ** noise_q) * src_phase
    shaped = np.real(_ifft2c(shaped_fft))

    shaped -= shaped.min()
    m = shaped.max()
    if m > 0:
        shaped /= m

    # per-channel histogram match of the fill region to the untouched pixels
    if fill_px.any() and ref_px.any():
        for c in range(nc):
            shaped[fill_px, c] = match_histograms_1d(
                shaped[fill_px, c], src[ref_px, c])

    out = src * (1.0 - mask_rgb) + shaped * mask_rgb
    return np.clip(out, 0.0, 1.0)
