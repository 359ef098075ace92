"""Mask utilities for inpainting, on uint8 numpy arrays.

Port of ``sdwebui_tpu/utils/masking.py``.  ``binarize_mask``,
``blur_mask`` and ``fill`` restate the Pillow operations the JAX package
calls, each with Pillow's own integer rounding (tests hold them against
Pillow in every pixel):

    gaussian_blur     ``ImageFilter.GaussianBlur``: an extended box blur of
                      three passes per axis in 24-bit fixed point, each
                      pass rounded to uint8, every channel on its own
    premultiply       ``convert("RGBA" → "RGBa")``: c·a / 255 rounded
    unpremultiply     ``convert("RGBa" → "RGBA")``: 255·c / a truncated,
                      clipped to 255 (a of 0 or 255 leaves c as it is)
    alpha_composite   ``Image.alpha_composite`` (AlphaComposite.c: 7 extra
                      bits of precision, divisions by 255 rounded)
    fill              ``masking.fill`` (inpainting_fill 0): the image
                      outside the mask, premultiplied, blurred at radii
                      256 … 0 and composited over itself 1–4 times

The blurs and the RGBa arithmetic are integer torch ops on (C, H, W)
planes: exact on any device, so img2img runs ``fill`` on the model's.
``get_crop_region_v2`` and ``expand_crop_region`` are the inpaint-full-res
crop, copied as they are.
"""

from __future__ import annotations

import numpy as np
import torch

from sdwebui_tpu_torch.utils.images import _div255, to_l, to_rgb


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


def _box_blur_last(a: torch.Tensor, radius: np.float32) -> torch.Tensor:
    """One Pillow ``ImagingLineBoxBlur`` pass along the last axis: the
    clamped window of 2R+1 pixels weighted ww and its two outer neighbours
    weighted fw, with ww = 2²⁴/(2r+1) in float32, rounded back to uint8
    (int64 integer arithmetic, exact on any device)."""
    r = int(radius)
    ww = int(np.float32(1 << 24) / (radius * np.float32(2) + np.float32(1)))
    fw = ((1 << 24) - (2 * r + 1) * ww) // 2
    w = a.shape[-1]
    edge = (*a.shape[:-1], r + 1)
    p = a.to(torch.int64)
    p = torch.cat([p[..., :1].expand(edge), p, p[..., -1:].expand(edge)], dim=-1)
    c = torch.cumsum(p, dim=-1)
    # the window p[x+1 .. x+2r+1] is c[x+2r+1] - c[x]
    acc = (c[..., 2 * r + 1:2 * r + 1 + w] - c[..., :w]) * ww
    acc += (p[..., :w] + p[..., 2 * r + 2:2 * r + 2 + w]) * fw + (1 << 23)
    return (acc >> 24).to(torch.uint8)


def _blur_planes(planes: torch.Tensor, radius: float) -> torch.Tensor:
    """GaussianBlur of (C, H, W) uint8 planes: three box passes along the
    rows, three along the columns."""
    br = _box_radius(radius)
    if br == 0:
        return planes.clone()
    for _ in range(3):
        planes = _box_blur_last(planes, br)
    planes = planes.transpose(1, 2)
    for _ in range(3):
        planes = _box_blur_last(planes, br)
    return planes.transpose(1, 2).contiguous()


def _planes(image, device="cpu") -> torch.Tensor:
    """(H, W[, C]) uint8 → (C, H, W) uint8 tensor on `device`."""
    a = np.asarray(image, np.uint8)
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(a[..., None] if a.ndim == 2 else a, -1, 0))).to(device)


def _pixels(planes: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(planes.permute(1, 2, 0).cpu().numpy())


def gaussian_blur(image, radius: float) -> np.ndarray:
    """Pillow's ``ImageFilter.GaussianBlur(radius)`` of an (H, W) or
    (H, W, C) uint8 image, each channel on its own."""
    a = np.asarray(image, np.uint8)
    out = _pixels(_blur_planes(_planes(a), radius))
    return out[..., 0] if a.ndim == 2 else out


def blur_mask(mask: np.ndarray, blur: int) -> np.ndarray:
    if blur <= 0:
        return mask
    return gaussian_blur(mask, blur)


# the RGBa operations on (4, H, W) planes; the (H, W, 4) functions wrap them

def _premultiply_planes(p: torch.Tensor) -> torch.Tensor:
    out = p.clone()
    out[:3] = _div255(p[:3].to(torch.int32) * p[3].to(torch.int32)).to(torch.uint8)
    return out


def _unpremultiply_planes(p: torch.Tensor) -> torch.Tensor:
    a = p[3].to(torch.int32)
    c = p[:3].to(torch.int32)
    scaled = torch.clamp(torch.div(255 * c, torch.clamp(a, min=1), rounding_mode="floor"),
                         max=255)
    out = p.clone()
    out[:3] = torch.where((a == 0) | (a == 255), c, scaled).to(torch.uint8)
    return out


def _alpha_composite_planes(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """(every intermediate fits int32: 255³·2⁷ < 2³¹)"""
    d, s = dst.to(torch.int32), src.to(torch.int32)
    sa = s[3]
    outa255 = sa * 255 + d[3] * (255 - sa)
    coef1 = torch.div(sa * (255 * 255 * (1 << 7)), torch.clamp(outa255, min=1),
                      rounding_mode="floor")
    tmp = s[:3] * coef1 + d[:3] * (255 * (1 << 7) - coef1) + (0x80 << 7)
    t = outa255 + 0x80
    out = torch.cat([(((tmp >> 8) + tmp) >> 8) >> 7, (((t >> 8) + t) >> 8)[None]])
    return torch.where(sa == 0, dst, out.to(torch.uint8))


def premultiply(rgba: np.ndarray) -> np.ndarray:
    """RGBA → RGBa (Pillow's ``rgbA2rgba``: MULDIV255 of each colour)."""
    return _pixels(_premultiply_planes(_planes(rgba)))


def unpremultiply(rgba: np.ndarray) -> np.ndarray:
    """RGBa → RGBA (Pillow's ``rgba2rgbA``): 255·c // a clipped to 255,
    the colours as they are where a is 0 or 255."""
    return _pixels(_unpremultiply_planes(_planes(rgba)))


def alpha_composite(dst: np.ndarray, src: np.ndarray) -> np.ndarray:
    """``Image.alpha_composite(dst, src)`` of two RGBA arrays of one size
    (AlphaComposite.c's integer arithmetic)."""
    return _pixels(_alpha_composite_planes(_planes(dst), _planes(src)))


def fill(image, mask, device="cpu") -> np.ndarray:
    """``masking.fill``: the RGB image's colours outside the L mask spread
    into it by progressive blurs; (H, W, 3) uint8 (the colours of the whole
    image are replaced, the caller composites under the mask).  The integer
    arithmetic runs on `device` (the model's, in img2img) and gives the
    same bytes on every device."""
    rgb = _planes(to_rgb(image), device)
    keep = 255 - _planes(to_l(mask), device).to(torch.int32)
    rgba = torch.cat([rgb, torch.full_like(rgb[:1], 255)])
    # paste(RGBa image, mask=255 - mask) onto a zero RGBa canvas: Pillow's
    # BLEND of 0 and each byte (alpha included) by the mask
    masked = _div255(_premultiply_planes(rgba).to(torch.int32) * keep).to(torch.uint8)
    out = torch.zeros_like(rgba)
    for radius, repeats in [(256, 1), (64, 1), (16, 2), (4, 4), (2, 2), (0, 1)]:
        blurred = _unpremultiply_planes(_blur_planes(masked, radius))
        for _ in range(repeats):
            out = _alpha_composite_planes(out, blurred)
    return _pixels(out[:3])


def get_crop_region_v2(mask: np.ndarray, pad: int = 0):
    """Bounding box (x1, y1, x2, y2) of nonzero mask area + padding, clamped.

    mask: (H, W) uint8/bool array."""
    h, w = mask.shape
    ys, xs = np.nonzero(mask)
    if len(xs) == 0:
        return 0, 0, w, h
    x1 = max(int(xs.min()) - pad, 0)
    y1 = max(int(ys.min()) - pad, 0)
    x2 = min(int(xs.max()) + 1 + pad, w)
    y2 = min(int(ys.max()) + 1 + pad, h)
    return x1, y1, x2, y2


def expand_crop_region(crop_region, processing_width, processing_height,
                       image_width, image_height):
    """Expand the crop box to the processing aspect ratio
    (reference modules/masking.py:40)."""
    x1, y1, x2, y2 = crop_region
    ratio_crop_region = (x2 - x1) / (y2 - y1)
    ratio_processing = processing_width / processing_height

    if ratio_crop_region > ratio_processing:
        desired_height = (x2 - x1) / ratio_processing
        desired_height_diff = int(desired_height - (y2 - y1))
        y1 -= desired_height_diff // 2
        y2 += desired_height_diff - desired_height_diff // 2
        if y2 >= image_height:
            diff = y2 - image_height
            y2 -= diff
            y1 -= diff
        if y1 < 0:
            y2 -= y1
            y1 = 0
        if y2 >= image_height:
            y2 = image_height
    else:
        desired_width = (y2 - y1) * ratio_processing
        desired_width_diff = int(desired_width - (x2 - x1))
        x1 -= desired_width_diff // 2
        x2 += desired_width_diff - desired_width_diff // 2
        if x2 >= image_width:
            diff = x2 - image_width
            x2 -= diff
            x1 -= diff
        if x1 < 0:
            x2 -= x1
            x1 = 0
        if x2 >= image_width:
            x2 = image_width

    return x1, y1, x2, y2
