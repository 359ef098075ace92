"""Upscaler registry — port of ``sdwebui_tpu/postprocessing/upscalers.py``.

Built-ins None, Lanczos and Nearest (the restated Pillow resizes of
``utils/images``); model upscalers (ESRGAN, Real-ESRGAN: ``models/esrgan``;
SwinIR and Swin2SR, HAT, DAT, SCUNet and LDSR: their ``models/`` modules)
register through ``register_upscaler``; ``register_model_dirs`` registers
every family's directories, as the server does at start.  ``upscale`` runs up to three
passes of an upscaler's own factor towards the target, then LANCZOS to the
exact size (the reference's ``Upscaler.upscale``), and keeps the last
``upscaling_max_images_in_cache`` results of model upscalers keyed on the
image's SHA-1.  Images are RGB uint8 (H, W, 3) arrays.  An unknown name
raises ``UpscalerNotFound``: nothing falls back to another upscaler.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable

import numpy as np

from sdwebui_tpu_torch.utils import images as images_util
from sdwebui_tpu_torch.utils.options import opts


class UpscalerNotFound(LookupError):
    """An upscaler name the registry does not hold."""


@dataclasses.dataclass
class UpscalerEntry:
    name: str
    scale_fn: Callable          # (image, factor) -> image
    default_scale: int = 4
    path: str | None = None     # a model upscaler's file


_REGISTRY: dict[str, UpscalerEntry] = {}
BUILTIN = ("None", "Lanczos", "Nearest")


def register_upscaler(name: str, scale_fn: Callable, default_scale: int = 4,
                      path: str | None = None):
    _REGISTRY[name] = UpscalerEntry(name, scale_fn, default_scale, path)


def unregister_upscaler(name: str):
    """Drop `name` and its cached results (a model upscaler's net goes
    with its entry)."""
    _REGISTRY.pop(name, None)
    for key in [k for k in _CACHE if k[0] == name]:
        del _CACHE[key]


def get_upscaler(name: str) -> UpscalerEntry:
    entry = _REGISTRY.get(name)
    if entry is None:
        raise UpscalerNotFound(f"upscaler {name!r} not found (available: "
                               f"{', '.join(_REGISTRY)})")
    return entry


def tiled_sr_upscale(run_batch: Callable, scale: int, pad_multiple: int, image,
                     tile: int | None = None, overlap: int | None = None) -> np.ndarray:
    """A xscale super-resolution net over overlapping tiles: every tile in
    one call of `run_batch` ((N, H, W, 3) float32 in [0, 1] → (N, sH, sW, 3)),
    feathered back together at the output scale.  Inputs are reflect-padded
    to `pad_multiple`.  tile / overlap default to opts.ESRGAN_tile /
    ESRGAN_tile_overlap (tile 0: one tile)."""
    if tile is None:
        tile = int(opts.get("ESRGAN_tile", 192) or 0)
    if overlap is None:
        overlap = int(opts.get("ESRGAN_tile_overlap", 8))
    img = images_util.to_rgb(image)
    if tile <= 0:
        tile = max(img.shape[:2])

    def run(arr):
        h, w = arr.shape[1:3]
        ph, pw = (-h) % pad_multiple, (-w) % pad_multiple
        if ph or pw:
            arr = np.pad(arr, ((0, 0), (0, ph), (0, pw), (0, 0)), "reflect")
        return np.asarray(run_batch(arr))[:, : h * scale, : w * scale]

    if img.shape[1] <= tile and img.shape[0] <= tile:
        out = np.clip(run(img.astype(np.float32)[None] / 255.0)[0], 0, 1)
        return (out * 255 + 0.5).astype(np.uint8)

    grid = images_util.split_grid(img, tile, tile, overlap)
    tiles = [t for _, _, row in grid.tiles for _, _, t in row]
    arr = np.stack([t.astype(np.float32) / 255.0 for t in tiles])
    outs = (np.clip(run(arr), 0, 1) * 255 + 0.5).astype(np.uint8)
    s, i, new_tiles = scale, 0, []
    for y, h, row in grid.tiles:
        new_row = []
        for x, w, _ in row:
            new_row.append([x * s, w * s, outs[i]])
            i += 1
        new_tiles.append([y * s, h * s, new_row])
    return images_util.combine_grid(images_util.Grid(
        new_tiles, grid.tile_w * s, grid.tile_h * s, grid.image_w * s, grid.image_h * s,
        grid.overlap * s))


def _resize_upscaler(resample: str):
    def fn(image, scale: float):
        h, w = image.shape[:2]
        return images_util.resize(image, (round(w * scale), round(h * scale)), resample)
    return fn


register_upscaler("None", lambda im, s: im, 1)
register_upscaler("Lanczos", _resize_upscaler("lanczos"))
register_upscaler("Nearest", _resize_upscaler("nearest"))


def upscaler_names() -> list:
    """Registered names, less the R-ESRGAN and DAT ones that
    opts.realesrgan_enabled_models / dat_enabled_models leave out
    (upscalers.py:102-117); a name left out still works when asked for."""
    re_on = opts.get("realesrgan_enabled_models", None)
    dat_on = opts.get("dat_enabled_models", None)

    def visible(name):
        if re_on is not None and name.startswith("R-ESRGAN"):
            return name in re_on
        if dat_on is not None and name.startswith("DAT"):
            return name in dat_on
        return True
    return [n for n in _REGISTRY if visible(n)]


_CACHE: dict = {}


def upscale(name: str, image, scale: float) -> np.ndarray:
    """`image` upscaled by `scale` with the named upscaler (the model
    upscalers' results cached: opts.upscaling_max_images_in_cache)."""
    entry = get_upscaler(name)
    image = np.ascontiguousarray(images_util.to_rgb(image))
    cache_n = int(opts.get("upscaling_max_images_in_cache", 5) or 0)
    key = None
    if cache_n > 0 and name not in BUILTIN:
        key = (name, float(scale), image.shape, hashlib.sha1(image.tobytes()).hexdigest())
        hit = _CACHE.get(key)
        if hit is not None:
            return hit.copy()
    out = _upscale_uncached(entry, image, scale)
    if key is not None:
        _CACHE[key] = out.copy()
        while len(_CACHE) > cache_n:
            _CACHE.pop(next(iter(_CACHE)))
    return out


def _upscale_uncached(entry: UpscalerEntry, image: np.ndarray, scale: float) -> np.ndarray:
    h, w = image.shape[:2]
    dest_w, dest_h = round(w * scale), round(h * scale)
    for _ in range(3):
        if image.shape[1] >= dest_w and image.shape[0] >= dest_h:
            break
        shape = image.shape
        image = entry.scale_fn(image, scale if entry.default_scale == 1 else entry.default_scale)
        if image.shape == shape:
            break
    return images_util.resize(image, (dest_w, dest_h), "lanczos")


def upscale_by_name(name: str, image, width: int, height: int) -> np.ndarray:
    """`image` upscaled to exactly width x height."""
    h, w = np.asarray(image).shape[:2]
    out = upscale(name, image, max(width / w, height / h))
    return images_util.resize(out, (width, height), "lanczos")


def register_model_dirs(esrgan_dirs=(), models_root: str = "models", dat_dir=None,
                        device="cuda") -> tuple:
    """Register every model upscaler's files on `device`, the way the JAX
    Engine does at start (sdwebui_tpu/server/app.py:44-56): `esrgan_dirs`
    through ``register_esrgan_dir``, then `models_root`'s SwinIR, ScuNET,
    LDSR and HAT directories and `dat_dir` (default `models_root`/DAT).
    Returns (all names, the names from the last of `esrgan_dirs`)."""
    import os

    from sdwebui_tpu_torch.models import dat, esrgan, hat, ldsr, scunet, swinir

    names, last = [], []
    for d in esrgan_dirs:
        last = esrgan.register_esrgan_dir((d,), device=device)
        names += last
    sub = lambda name: (os.path.join(models_root, name),)   # noqa: E731
    names += swinir.register_swinir_dir(sub("SwinIR"), device=device)
    names += scunet.register_scunet_dir(sub("ScuNET"), device=device)
    names += ldsr.register_ldsr_dir(sub("LDSR"), device=device)
    names += hat.register_hat_dir(sub("HAT"), device=device)
    names += dat.register_dat_dir((dat_dir,) if dat_dir else sub("DAT"), device=device)
    return names, last
