"""PNG embedding cards: the decode side of ``sdwebui_tpu/training/image_embedding.py``
(the reference's image_embedding.py byte format).

A card carries its embedding either in an ``sd-ti-embedding`` text chunk
(base64 JSON, tensors as ``{"TORCHTENSOR": nested list}``) or in two data
panels beside the preview: the zlib-compressed JSON split into high and low
nibbles, each panel XOR-scrambled with an LCG stream and dotted, separated
from the preview by black columns.  This module reads both from the image
``utils/png.decode_png`` gives (no Pillow); the encode side comes with
training.
"""

from __future__ import annotations

import base64
import json
import zlib

import numpy as np


def _tensor_hook(d):
    if "TORCHTENSOR" in d:
        return np.asarray(d["TORCHTENSOR"], np.float32)
    return d


def embedding_from_b64(data) -> dict:
    """The ``sd-ti-embedding`` text chunk → the embedding dict
    (image_embedding.py:43-58)."""
    return json.loads(base64.b64decode(data), object_hook=_tensor_hook)


def _lcg_block(shape, m=2 ** 32, a=1664525, c=1013904223, seed=0) -> np.ndarray:
    n = int(np.prod(shape))
    out = np.empty(n, np.uint8)
    s = seed
    for i in range(n):
        s = (a * s + c) % m
        out[i] = s % 255
    return out.reshape(shape)


def xor_block(block: np.ndarray) -> np.ndarray:
    """The panels' LCG scramble (its own inverse)."""
    return np.bitwise_xor(block.astype(np.uint8), _lcg_block(block.shape) & 0x0F)


def _crop_black(img: np.ndarray, tol=0) -> np.ndarray:
    mask = (img > tol).all(2)
    mask0, mask1 = mask.any(0), mask.any(1)
    col_start = int(mask0.argmax())
    col_end = int(mask.shape[1] - mask0[::-1].argmax())
    row_start = int(mask1.argmax())
    row_end = int(mask.shape[0] - mask1[::-1].argmax())
    return img[row_start:row_end, col_start:col_end]


def as_rgb(img: np.ndarray) -> np.ndarray:
    """A decoded PNG's (H, W, C) uint8 as RGB, as Pillow's convert("RGB"):
    grey replicated, alpha dropped."""
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[2] in (1, 2):
        return np.repeat(img[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


def extract_image_data_embed(image: np.ndarray):
    """A card's (H, W, C) uint8 pixels → the embedding dict, or None when
    it has no data panels (image_embedding.py:119-141)."""
    arr = _crop_black(as_rgb(image)) & 0x0F
    black_cols = np.where(np.sum(arr, axis=(0, 2)) == 0)
    if black_cols[0].shape[0] < 2:
        return None
    lower = xor_block(arr[:, : black_cols[0].min(), :].astype(np.uint8))
    upper = xor_block(arr[:, black_cols[0].max() + 1:, :].astype(np.uint8))
    data = ((upper << 4) | lower).flatten().tobytes()
    return json.loads(zlib.decompress(data), object_hook=_tensor_hook)
