"""Colour correction for img2img — a copy of ``sdwebui_tpu/utils/color.py``.

The reference's cv2 LAB conversion and skimage ``match_histograms``,
restated in numpy by the JAX package (LAB through linear sRGB and XYZ at
D65, per-channel quantile matching).  This copy takes and returns uint8
(H, W, 3) arrays where the JAX module takes PIL images; its arithmetic is
the same, line for line.
"""

from __future__ import annotations

import numpy as np

from sdwebui_tpu_torch.utils.images import to_rgb

_RGB2XYZ = np.array([[0.4124564, 0.3575761, 0.1804375],
                     [0.2126729, 0.7151522, 0.0721750],
                     [0.0193339, 0.1191920, 0.9503041]], np.float32)
_XYZ2RGB = np.linalg.inv(_RGB2XYZ).astype(np.float32)
_WHITE = np.array([0.95047, 1.0, 1.08883], np.float32)


def _srgb_to_linear(c):
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _linear_to_srgb(c):
    return np.where(c <= 0.0031308, c * 12.92, 1.055 * np.maximum(c, 0) ** (1 / 2.4) - 0.055)


def _f(t):
    d = 6 / 29
    return np.where(t > d ** 3, np.cbrt(t), t / (3 * d * d) + 4 / 29)


def _finv(t):
    d = 6 / 29
    return np.where(t > d, t ** 3, 3 * d * d * (t - 4 / 29))


def rgb_to_lab(rgb: np.ndarray) -> np.ndarray:
    """rgb float [0,1] (H,W,3) → LAB."""
    xyz = _srgb_to_linear(rgb.astype(np.float32)) @ _RGB2XYZ.T / _WHITE
    fx, fy, fz = _f(xyz[..., 0]), _f(xyz[..., 1]), _f(xyz[..., 2])
    return np.stack([116 * fy - 16, 500 * (fx - fy), 200 * (fy - fz)], -1)


def lab_to_rgb(lab: np.ndarray) -> np.ndarray:
    fy = (lab[..., 0] + 16) / 116
    fx = fy + lab[..., 1] / 500
    fz = fy - lab[..., 2] / 200
    xyz = np.stack([_finv(fx), _finv(fy), _finv(fz)], -1) * _WHITE
    rgb = _linear_to_srgb(xyz @ _XYZ2RGB.T)
    return np.clip(rgb, 0, 1)


def match_histograms(source: np.ndarray, template: np.ndarray) -> np.ndarray:
    """Per-channel quantile mapping (skimage match_histograms equivalent)."""
    out = np.empty_like(source)
    for c in range(source.shape[-1]):
        s = source[..., c].ravel()
        t = template[..., c].ravel()
        s_idx = np.argsort(s, kind="stable")
        t_sorted = np.sort(t)
        quantiles = np.linspace(0, len(t_sorted) - 1, len(s)).astype(int)
        matched = np.empty_like(s)
        matched[s_idx] = t_sorted[quantiles]
        out[..., c] = matched.reshape(source[..., c].shape)
    return out


def setup_color_correction(image) -> np.ndarray:
    """Target LAB statistics captured from the init image (uint8 RGB(A))."""
    return rgb_to_lab(to_rgb(image).astype(np.float32) / 255.0)


def apply_color_correction(correction_target: np.ndarray, image) -> np.ndarray:
    """The uint8 RGB image with its LAB histograms matched to the target's."""
    lab = rgb_to_lab(to_rgb(image).astype(np.float32) / 255.0)
    matched = match_histograms(lab, correction_target)
    rgb = lab_to_rgb(matched)
    return (rgb * 255 + 0.5).astype(np.uint8)
