"""The PIL operations of the img2img path, on uint8 numpy arrays.

The JAX package does these with Pillow (``sdwebui_tpu/utils/images.py``,
``sdwebui_tpu/pipeline/img2img.py``); the port runs where Pillow is not
installed, so each is restated here with Pillow's own integer arithmetic
(tests hold every one against Pillow):

    to_rgb / to_l     ``Image.convert("RGB" | "L")`` of an L, LA, RGB or
                      RGBA array (ITU-R 601-2 luma in 16-bit fixed point)
    flatten           ``images.flatten``: RGBA over a background colour
    composite         ``Image.composite`` with an L mask
    resize_bicubic    ``Image.resize`` of an L image with the default
                      bicubic filter (8-bit fixed-point coefficients)

An image is (H, W) or (H, W, C) uint8 with C = 1 (L), 2 (LA), 3 (RGB) or
4 (RGBA).
"""

from __future__ import annotations

import numpy as np

_PRECISION_BITS = 22          # Pillow's Resample.c: 32 - 8 - 2


def as_hwc(image) -> np.ndarray:
    a = np.asarray(image)
    if a.dtype != np.uint8:
        raise ValueError(f"expected a uint8 image, got {a.dtype}")
    if a.ndim == 2:
        a = a[:, :, None]
    if a.ndim != 3 or a.shape[2] not in (1, 2, 3, 4):
        raise ValueError(f"expected (H, W) or (H, W, 1-4) uint8, got {a.shape}")
    return a


def to_l(image) -> np.ndarray:
    """→ (H, W) uint8: grey channels as they are, RGB(A) through
    (R·19595 + G·38470 + B·7471 + 0x8000) >> 16 (Pillow's ``rgb2l``)."""
    a = as_hwc(image)
    if a.shape[2] <= 2:
        return a[:, :, 0].copy()
    rgb = a[:, :, :3].astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


def to_rgb(image) -> np.ndarray:
    """→ (H, W, 3) uint8; alpha is dropped, grey replicated."""
    a = as_hwc(image)
    if a.shape[2] <= 2:
        return np.repeat(a[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(a[:, :, :3])


def _div255(v):
    """Pillow's DIV255: round(v / 255) for 0 <= v <= 255·255, in integers."""
    t = v + 128
    return ((t >> 8) + t) >> 8


def _blend(mask, under, over):
    """Pillow's BLEND: under·(255 − mask) + over·mask, over 255."""
    m = mask.astype(np.int32)
    return _div255(under.astype(np.int32) * (255 - m) + over.astype(np.int32) * m
                   ).astype(np.uint8)


def parse_color(color: str) -> tuple:
    """'#rrggbb' or '#rgb' → (r, g, b)."""
    s = str(color).strip()
    if s.startswith("#") and len(s) in (4, 7):
        try:
            digits = s[1:]
            if len(digits) == 3:
                return tuple(int(c, 16) * 17 for c in digits)
            return tuple(int(digits[i:i + 2], 16) for i in (0, 2, 4))
        except ValueError:
            pass
    raise NotImplementedError(f"colour {color!r} is not ported yet (use #rrggbb or #rgb)")


def flatten(image, bgcolor: str) -> np.ndarray:
    """Alpha over `bgcolor`, then RGB (``images.flatten``: only RGBA is
    composited; LA, like Pillow's ``convert("RGB")``, drops its alpha)."""
    a = as_hwc(image)
    if a.shape[2] != 4:
        return to_rgb(a)
    bg = np.broadcast_to(np.asarray(parse_color(bgcolor), np.uint8), a.shape[:2] + (3,))
    return _blend(a[:, :, 3:4], bg, a[:, :, :3])


def composite(image1, image2, mask) -> np.ndarray:
    """``Image.composite(image1, image2, mask)``: image1 where the L mask is
    255, image2 where it is 0, Pillow's rounding between; RGB arrays."""
    m = as_hwc(mask)
    if m.shape[2] != 1:
        raise ValueError("composite takes an L mask")
    return _blend(m, to_rgb(image2), to_rgb(image1))


def _bicubic(x):
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _coeffs(in_size: int, out_size: int):
    """Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for the
    bicubic filter (support 2) over the whole input: per output index the
    first input index and the fixed-point weights."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    out = []
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = _bicubic((np.arange(xmax) + xmin - center + 0.5) * (1.0 / filterscale))
        ww = w.sum()
        if ww != 0.0:
            w = w / ww
        k = np.trunc(w * (1 << _PRECISION_BITS) + np.where(w < 0, -0.5, 0.5))
        out.append((xmin, k.astype(np.int64)))
    return out


def _resample_axis0(a, out_size: int):
    """One Pillow 8-bit resample pass along axis 0 of an integer array."""
    rows = []
    for xmin, k in _coeffs(a.shape[0], out_size):
        ss = (1 << (_PRECISION_BITS - 1)) + np.tensordot(k, a[xmin:xmin + len(k)], axes=1)
        rows.append(np.clip(ss >> _PRECISION_BITS, 0, 255))
    return np.stack(rows)


def resize_bicubic(image, size) -> np.ndarray:
    """``Image.resize((w, h))`` of an L image: Pillow's two 8-bit passes,
    horizontal then vertical, each rounded to uint8."""
    a = as_hwc(image)
    if a.shape[2] != 1:
        raise ValueError("resize_bicubic takes an L image")
    w, h = size
    out = a[:, :, 0].astype(np.int64)
    if out.shape == (h, w):
        return out.astype(np.uint8)
    if out.shape[1] != w:
        out = _resample_axis0(out.T, w).T
    if out.shape[0] != h:
        out = _resample_axis0(out, h)
    return out.astype(np.uint8)
