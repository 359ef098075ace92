"""PNG embedding cards: ``sdwebui_tpu/training/image_embedding.py`` (the
reference's image_embedding.py byte format), writer and reader.

A card carries its embedding either in an ``sd-ti-embedding`` text chunk
(base64 JSON, tensors as ``{"TORCHTENSOR": nested list}``) or in two data
panels beside the preview: the zlib-compressed JSON split into high and low
nibbles, each panel XOR-scrambled with an LCG stream and dotted, separated
from the preview by black columns.  This module reads both from the image
``utils/image_io`` gives (a PNG or WebP card) and writes the panels around a preview
(no Pillow): the dots Pillow's ``ImageDraw.ellipse`` draws are
:data:`DOT`, a fixed 7×7 mask equal to Pillow's in every pixel.
"""

from __future__ import annotations

import base64
import json
import zlib

import numpy as np
import torch


def _tensor_hook(d):
    if "TORCHTENSOR" in d:
        return np.asarray(d["TORCHTENSOR"], np.float32)
    return d


class _Encoder(json.JSONEncoder):
    """Arrays and tensors as ``{"TORCHTENSOR": nested list}``."""

    def default(self, obj):
        if isinstance(obj, torch.Tensor):
            obj = obj.detach().cpu().numpy()
        if isinstance(obj, np.ndarray):
            return {"TORCHTENSOR": obj.tolist()}
        if isinstance(obj, (np.floating, np.integer)):
            return obj.item()
        return json.JSONEncoder.default(self, obj)


def embedding_to_b64(data: dict) -> bytes:
    """The embedding dict → the ``sd-ti-embedding`` text chunk."""
    return base64.b64encode(json.dumps(data, cls=_Encoder).encode())


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


#: the dot ``ImageDraw.ellipse((x, y, x + 6, y + 6))`` fills (Pillow 12)
DOT = np.array([[0, 0, 1, 1, 1, 0, 0],
                [0, 1, 1, 1, 1, 1, 0],
                [1, 1, 1, 1, 1, 1, 1],
                [1, 1, 1, 1, 1, 1, 1],
                [1, 1, 1, 1, 1, 1, 1],
                [0, 1, 1, 1, 1, 1, 0],
                [0, 0, 1, 1, 1, 0, 0]], bool)


def style_block(block: np.ndarray, sequence) -> np.ndarray:
    """The panel's dots (image_embedding.py:81-95): a grey dot every 8
    pixels, every other row shifted by 4, its shade the next value of
    `sequence`; the dots' high nibbles are XORed into `block`."""
    h, w = block.shape[:2]
    fg = np.zeros((h, w), np.uint8)
    i = 0
    for x in range(-6, w, 8):
        for yi, y in enumerate(range(-6, h, 8)):
            x0 = x + (4 if yi % 2 == 0 else 0)
            shade = int(sequence[i % len(sequence)])
            i += 1
            ys, xs = slice(max(y, 0), min(y + 7, h)), slice(max(x0, 0), min(x0 + 7, w))
            if ys.start >= ys.stop or xs.start >= xs.stop:
                continue
            dot = DOT[ys.start - y: ys.stop - y, xs.start - x0: xs.stop - x0]
            fg[ys, xs] = np.where(dot, shade, fg[ys, xs])
    return block ^ (fg & 0xF0)[:, :, None]


def insert_image_data_embed(image: np.ndarray, data: dict) -> np.ndarray:
    """A preview's uint8 (H, W, 3) pixels and an embedding dict → the card
    (image_embedding.py:98-116): the low-nibble panel, a black column, the
    preview, a black column, the high-nibble panel."""
    d = 3
    compressed = zlib.compress(json.dumps(data, cls=_Encoder).encode(), level=9)
    data_np = np.frombuffer(compressed, np.uint8).copy()
    high, low = data_np >> 4, data_np & 0x0F
    h = image.shape[0]
    next_size = low.shape[0] + (h - (low.shape[0] % h))
    next_size = next_size + ((h * d) - (next_size % (h * d)))
    low = np.resize(low, next_size).reshape((h, -1, d))
    high = np.resize(high, next_size).reshape((h, -1, d))
    vec = np.asarray(next(iter(data["string_to_param"].values())), np.float32).reshape(-1)[:1024]
    edge = (np.abs(vec) / max(np.max(np.abs(vec)), 1e-12) * 255).astype(np.uint8)
    if edge.size == 0:
        edge = np.zeros(1, np.uint8)
    low = xor_block(style_block(low, sequence=edge.tolist()))
    high = xor_block(style_block(high, sequence=edge.tolist()[::-1]))
    sep = np.zeros((h, 1, 3), np.uint8)
    return np.concatenate([low, sep, as_rgb(image), sep, high], axis=1)


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
