"""Mask utilities for inpainting, on uint8 numpy arrays.

Port of the parts of ``sdwebui_tpu/utils/masking.py`` that img2img runs
without ``inpaint_full_res`` (whose crop-region helpers come with it).
``binarize_mask`` and ``blur_mask`` restate the Pillow operations the JAX
package calls: ``blur_mask`` is Pillow's ``GaussianBlur``, an extended box
blur of three passes per axis in 24-bit fixed point, each pass rounded to
uint8 (tests hold it against Pillow).  ``fill`` (inpainting_fill 0) is not
ported.
"""

from __future__ import annotations

import numpy as np

from sdwebui_tpu_torch.utils.images import to_l


def binarize_mask(mask, threshold: int = 127, invert: bool = False) -> np.ndarray:
    """Any L/LA/RGB(A) mask → (H, W) uint8 of 0 and 255."""
    m = np.where(to_l(mask) > threshold, 255, 0).astype(np.uint8)
    return 255 - m if invert else m


def _box_radius(radius: float, passes: int = 3) -> np.float32:
    """Pillow's ``_gaussian_blur_radius``: the extended box radius whose
    `passes` box blurs have the Gaussian's variance, in its float32 steps."""
    f32 = np.float32
    sigma2 = f32(radius) * f32(radius) / f32(passes)
    big_l = f32(np.sqrt(12.0 * float(sigma2) + 1.0))
    small_l = f32(np.floor((float(big_l) - 1.0) / 2.0))
    a = (f32(2) * small_l + f32(1)) * (small_l * (small_l + f32(1)) - f32(3) * sigma2)
    a = a / (f32(6) * (sigma2 - (small_l + f32(1)) * (small_l + f32(1))))
    return small_l + a


def _box_blur_rows(a: np.ndarray, radius: np.float32) -> np.ndarray:
    """One Pillow ``ImagingLineBoxBlur8`` pass along axis 1: the clamped
    window of 2R+1 pixels weighted ww and its two outer neighbours weighted
    fw, with ww = 2²⁴/(2r+1) in float32, rounded back to uint8."""
    r = int(radius)
    ww = int(np.float32(1 << 24) / (radius * np.float32(2) + np.float32(1)))
    fw = ((1 << 24) - (2 * r + 1) * ww) // 2
    w = a.shape[1]
    p = np.pad(a.astype(np.int64), ((0, 0), (r + 1, r + 1)), mode="edge")
    c = np.concatenate([np.zeros((a.shape[0], 1), np.int64), np.cumsum(p, axis=1)], axis=1)
    x = np.arange(w)
    window = c[:, x + 2 * r + 2] - c[:, x + 1]
    far = p[:, x] + p[:, x + 2 * r + 2]
    return ((window * ww + far * fw + (1 << 23)) >> 24).astype(np.uint8)


def gaussian_blur(image, radius: float) -> np.ndarray:
    """Pillow's ``ImageFilter.GaussianBlur(radius)`` of an (H, W) uint8 image:
    three box passes along the rows, then three along the columns."""
    a = np.asarray(image, np.uint8)
    br = _box_radius(radius)
    if br == 0:
        return a.copy()
    for _ in range(3):
        a = _box_blur_rows(a, br)
    a = a.T
    for _ in range(3):
        a = _box_blur_rows(a, br)
    return np.ascontiguousarray(a.T)


def blur_mask(mask: np.ndarray, blur: int) -> np.ndarray:
    if blur <= 0:
        return mask
    return gaussian_blur(mask, blur)
