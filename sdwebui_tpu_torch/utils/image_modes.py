"""Pillow's image modes as the port's decoders hand them on: uint8
(H, W, C) pixels as ``convert`` sees the mode ``Image.open`` gives.

"1" reads as grey 0 / 255, "L" as grey, "LA" as grey + alpha, "P" and "PA"
through their palette's RGB (``convert("RGB")`` drops a palette's alpha,
and JAX composites only "RGBA"), "RGB" and "RGBA" as they are, the
integer modes ("I", "I;16", "I;16B") clipped to 0..255 and "F" truncated
and clipped (Pillow's ``i2l`` / ``I16_L`` / ``f2l``; NaN reads 0), "CMYK"
through Pillow's ``cmyk2rgb``."""

from __future__ import annotations

import numpy as np


def from_palette(index: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """(H, W) indices through an (N, 3+) palette → (H, W, 3) RGB; an index
    past the palette reads black, as Pillow's zero-filled palette."""
    pal = np.zeros((256, 3), np.uint8)
    p = np.asarray(palette, np.uint8).reshape(-1, np.asarray(palette).shape[-1])[:256, :3]
    pal[:len(p)] = p
    return pal[index]


def clip_grey(values: np.ndarray) -> np.ndarray:
    """Integer or float samples → (H, W, 1) grey as Pillow's convert("L")."""
    v = np.asarray(values)
    if v.dtype.kind == "f":
        v = np.nan_to_num(v.astype(np.float64), nan=0.0, posinf=255.0, neginf=0.0)
        v = np.trunc(v)
    return np.clip(v, 0, 255).astype(np.uint8).reshape(v.shape[:2] + (1,))


def cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """(H, W, 4) CMYK → (H, W, 3) RGB, Pillow's ``cmyk2rgb``:
    255 - k - round(c · (255 - k) / 255) per channel."""
    c = cmyk.astype(np.int32)
    nk = 255 - c[..., 3:4]
    t = c[..., :3] * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def bits_to_grey(bits: np.ndarray) -> np.ndarray:
    """0/1 samples of a "1" image → (H, W, 1) 0 / 255."""
    return (np.asarray(bits, np.uint8) * np.uint8(255)).reshape(bits.shape[:2] + (1,))


def as_output(mode: str, a: np.ndarray, palette=None) -> np.ndarray:
    """Samples of a Pillow `mode` (uint8 unless an integer or float mode)
    → uint8 (H, W, C) as the port's decoders give them."""
    a = np.asarray(a)
    if mode == "1":
        return bits_to_grey(a[..., 0] if a.ndim == 3 else a)
    if mode in ("I", "I;16", "I;16B", "F"):
        return clip_grey(a[..., 0] if a.ndim == 3 else a)
    if mode in ("P", "PA"):
        return from_palette(a[..., 0] if a.ndim == 3 else a, palette)
    if mode == "CMYK":
        return cmyk_to_rgb(a)
    if a.ndim == 2:
        a = a[:, :, None]
    channels = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}.get(mode)
    if channels is None or a.shape[2] != channels:
        raise ValueError(f"no output for Pillow mode {mode} with {a.shape[2]} samples")
    return np.ascontiguousarray(a.astype(np.uint8))


class NotThisFormat(ValueError):
    """Bytes that a plugin's ``_open`` refuses with a ``SyntaxError`` (or an
    error Pillow turns into one): ``Image.open`` then tries the next plugin
    in its order (``utils/image_io``)."""
