"""Kodak PhotoCD (PCD) reading on numpy, as Pillow's ``PcdImagePlugin`` and
its ``pcd`` decoder do: the 768×512 base image at sector 96, two luma rows
then one row of each 2×2-subsampled chroma plane, converted from PhotoYCC
to RGB with Pillow's tables (``UnpackYCC.c``: luma 1.3584·Y, chroma
2.2179·(C1 - 156) and 1.8215·(C2 - 137), green -0.194 and -0.509 of them,
each rounded as ``(int)(x + 0.5)``, the sums clipped), then turned by the
header's orientation (90 or 270 degrees, Pillow's ``rotate(expand=True)``)."""

from __future__ import annotations

import numpy as np

from sdwebui_tpu_torch.utils.image_modes import NotThisFormat


def _table(scale: float, centre: int) -> np.ndarray:
    return np.trunc(scale * (np.arange(256) - centre) + 0.5).astype(np.int32)


_L = _table(1.3584, 0)
_CB, _GB = _table(2.2179, 156), _table(-0.194 * 2.2179, 156)
_CR, _GR = _table(1.8215, 137), _table(-0.509 * 1.8215, 137)


def is_pcd(data: bytes) -> bool:
    return data[2048:2052] == b"PCD_"


def decode_pcd(data: bytes) -> tuple[np.ndarray, dict]:
    """PCD bytes → (uint8 (512, 768, 3) or (768, 512, 3), {})."""
    if not is_pcd(data) or len(data) < 2048 + 1539:
        raise NotThisFormat("not a PCD file")
    orientation = data[2048 + 1538] & 3
    need = 256 * 2304
    raw = data[96 * 2048:96 * 2048 + need]
    if len(raw) < need:
        raise ValueError("PCD: image file is truncated")
    chunks = np.frombuffer(raw, np.uint8).reshape(256, 2304)
    y = chunks[:, :1536].reshape(512, 768).astype(np.int32)
    c1 = np.repeat(np.repeat(chunks[:, 1536:1920], 2, axis=0), 2, axis=1).astype(np.int32)
    c2 = np.repeat(np.repeat(chunks[:, 1920:], 2, axis=0), 2, axis=1).astype(np.int32)
    lum = _L[y]
    rgb = np.stack([lum + _CR[c2], lum + _GR[c2] + _GB[c1], lum + _CB[c1]], axis=2)
    rgb = np.clip(rgb, 0, 255).astype(np.uint8)
    if orientation == 1:
        rgb = np.rot90(rgb, 1)
    elif orientation == 3:
        rgb = np.rot90(rgb, 3)
    return np.ascontiguousarray(rgb), {}
