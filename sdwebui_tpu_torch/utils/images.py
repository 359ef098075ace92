"""The PIL operations of the img2img, hires-fix and upscale paths, on uint8
numpy arrays.

The JAX package does these with Pillow (``sdwebui_tpu/utils/images.py``,
``sdwebui_tpu/pipeline/img2img.py``, ``sdwebui_tpu/postprocessing/``); the
port runs where Pillow is not installed, so each is restated here with
Pillow's own arithmetic (tests hold every one against Pillow):

    to_rgb / to_l     ``Image.convert("RGB" | "L")`` of an L, LA, RGB or
                      RGBA array (ITU-R 601-2 luma in 16-bit fixed point)
    flatten           ``images.flatten``: RGBA over a background colour
    composite         ``Image.composite`` with an L mask
    resize            ``Image.resize`` of an L or RGB image with LANCZOS,
                      BICUBIC (Pillow's default) or NEAREST: two 8-bit
                      fixed-point passes, or the nearest source pixel
    blend / crop / paste
                      ``Image.blend`` (single-precision float), ``crop``
                      (zeros outside the image) and ``paste`` (clipped to
                      the target, with an optional L mask)
    split_grid / combine_grid / resize_image
                      ``images.split_grid`` / ``combine_grid`` (overlapping
                      tiles, feathered re-assembly) and ``resize_image``
                      (resize modes 0-3 with the upscaler hook)
    mask_composite    the RGBa composite of img2img's
                      ``return_mask_composite``
    affine_transform  ``Image.transform(size, AFFINE, coeffs, BILINEAR)``
                      (Geometry.c's generic transform: double-precision
                      coordinates at pixel centres, bilinear taps clamped
                      at the edges, truncated to uint8; 0 outside)
    min_filter        ``ImageFilter.MinFilter(size)``: the minimum over a
                      size x size window, the image's edges replicated

An image is (H, W) or (H, W, C) uint8 with C = 1 (L), 2 (LA), 3 (RGB) or
4 (RGBA).  The decoders (``utils/image_io``) give Pillow's other modes in
the form its ``convert`` makes of them, so ``to_rgb``, ``to_l`` and
``flatten`` give JAX's results for those too: "1" as 0/255 grey, "P" and
"PA" expanded through the palette with the transparency dropped, "I;16"
clipped at 255, 16-bit grey + alpha as RGBA (Pillow opens it so), a
32-bit BI_RGB BMP as RGB.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
from scipy import ndimage

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


def blend(image1, image2, alpha: float) -> np.ndarray:
    """``Image.blend``: in1 + alpha·(in2 − in1) in single precision,
    truncated to uint8 (Pillow's ``ImagingBlend`` for 0 <= alpha <= 1)."""
    a, b = np.asarray(image1), np.asarray(image2)
    if a.shape != b.shape or a.dtype != np.uint8 or b.dtype != np.uint8:
        raise ValueError(f"blend takes two uint8 images of one shape, got {a.shape}, {b.shape}")
    if not 0.0 <= alpha <= 1.0:
        raise NotImplementedError(f"blend alpha {alpha} outside [0, 1] is not ported yet")
    diff = (b.astype(np.int32) - a.astype(np.int32)).astype(np.float32)
    return (a.astype(np.float32) + np.float32(alpha) * diff).astype(np.uint8)


def crop(image, box) -> np.ndarray:
    """``Image.crop((left, upper, right, lower))``: zeros where the box
    leaves the image."""
    a = np.asarray(image)
    x0, y0, x1, y1 = (int(v) for v in box)
    out = np.zeros((max(y1 - y0, 0), max(x1 - x0, 0)) + a.shape[2:], a.dtype)
    paste(out, a, (-x0, -y0))
    return out


def paste(target: np.ndarray, image, xy, mask=None) -> np.ndarray:
    """``target.paste(image, xy, mask)`` in place: the part of `image` that
    lands inside `target`; with an L `mask` (the image's size) Pillow's
    BLEND of target and image."""
    src = np.asarray(image)
    x, y = (int(v) for v in xy)
    h, w = src.shape[:2]
    th, tw = target.shape[:2]
    sx0, sy0 = max(-x, 0), max(-y, 0)
    sx1, sy1 = min(w, tw - x), min(h, th - y)
    if sx1 <= sx0 or sy1 <= sy0:
        return target
    region = (slice(y + sy0, y + sy1), slice(x + sx0, x + sx1))
    piece = src[sy0:sy1, sx0:sx1]
    if mask is None:
        target[region] = piece
        return target
    m = np.asarray(mask)[sy0:sy1, sx0:sx1]
    if target.ndim == 3:
        m = m[:, :, None]
    target[region] = _blend(m, target[region], piece)
    return target


# --------------------------------------------------------------------------
# Image.resize
# --------------------------------------------------------------------------

def _bicubic(x: float) -> float:
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    if -3.0 <= x < 3.0:
        return _sinc(x) * _sinc(x / 3)
    return 0.0


#: Pillow's resampling filters: (function, support)
FILTERS = {"bicubic": (_bicubic, 2.0), "lanczos": (_lanczos, 3.0)}


@functools.lru_cache(maxsize=64)
def _coeffs(in_size: int, out_size: int, resample: str, in0: float = 0.0,
            in1: float | None = None):
    """Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc``: per
    output index the first input index (xmin, (out,)) and the fixed-point
    weights ((out, ksize) int32, zero past each window), evaluated in
    double precision in Pillow's order (the weights through libm, their sum
    left to right).  in0, in1: the source span a resize box gives (the
    whole axis by default)."""
    fn, support = FILTERS[resample]
    in1 = in_size if in1 is None else in1
    scale = float(np.float32(in1) - np.float32(in0)) / out_size     # a C float difference
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    xmins = np.zeros((out_size,), np.int64)
    kk = np.zeros((out_size, ksize), np.int32)
    for xx in range(out_size):
        center = in0 + (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [fn((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in w:
            ww += v
        for x, v in enumerate(w):
            if ww != 0.0:
                v = v / ww
            kk[xx, x] = int(-0.5 + v * (1 << _PRECISION_BITS)) if v < 0 \
                else int(0.5 + v * (1 << _PRECISION_BITS))
        xmins[xx] = xmin
    xmins.setflags(write=False)      # shared by every caller through the cache
    kk.setflags(write=False)
    return xmins, kk


def _resample_axis0(a: np.ndarray, out_size: int, resample: str, span=(0.0, None)) -> np.ndarray:
    """One Pillow 8-bit resample pass along axis 0 (int32 accumulators, as
    Pillow's; on torch's CPU kernels, which run it on every core):
    (in, ...) int32 → (out, ...) in [0, 255]."""
    xmins, kk = _coeffs(a.shape[0], out_size, resample, *span)
    src = torch.from_numpy(np.ascontiguousarray(a))
    idx = torch.from_numpy(np.minimum(xmins[:, None] + np.arange(kk.shape[1]), a.shape[0] - 1))
    k = torch.tensor(kk).view((out_size, kk.shape[1]) + (1,) * (a.ndim - 1))
    ss = torch.full((out_size,) + a.shape[1:], 1 << (_PRECISION_BITS - 1), dtype=torch.int32)
    for j in range(kk.shape[1]):
        ss += k[:, j] * src.index_select(0, idx[:, j])
    return (ss >> _PRECISION_BITS).clamp_(0, 255).numpy()


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Pillow's ``ImagingScaleAffine`` source index per output index: the
    position starts at scale / 2 and accumulates `scale` in double."""
    scale = in_size / out_size
    pos, idx = scale * 0.5, np.empty((out_size,), np.int64)
    for x in range(out_size):
        idx[x] = -1 if pos < 0.0 else int(pos)
        pos += scale
    return np.clip(idx, 0, in_size - 1)


def _span(lo, hi) -> tuple:
    """A box's span as Pillow takes it: C floats."""
    return float(np.float32(lo)), float(np.float32(hi))


def resize(image, size, resample: str = "bicubic", box=None) -> np.ndarray:
    """``Image.resize((w, h), resample, box)`` of an L ((H, W) or (H, W, 1))
    or RGB image, in its own layout.  LANCZOS and BICUBIC resample
    horizontally, then vertically, each pass rounded to uint8 (Pillow's
    ``ImagingResample``; a pass runs when its size or its box span
    changes); NEAREST takes one source pixel (no box)."""
    a = np.asarray(image)
    hwc = as_hwc(a)
    if hwc.shape[2] not in (1, 3):
        raise ValueError(f"resize takes L or RGB images, got {hwc.shape[2]} channels")
    w, h = (int(v) for v in size)
    if w < 1 or h < 1:
        raise ValueError(f"resize to {w}x{h}")
    ih, iw = hwc.shape[:2]
    x0, y0, x1, y1 = (0, 0, iw, ih) if box is None else box
    if (ih, iw) == (h, w) and (x0, y0, x1, y1) == (0, 0, iw, ih):
        return a.copy()
    if resample == "nearest":
        if box is not None:
            raise NotImplementedError("a resize box with NEAREST is not ported")
        out = hwc[_nearest_index(hwc.shape[0], h)][:, _nearest_index(hwc.shape[1], w)]
    elif resample in FILTERS:
        out = hwc.astype(np.int32)
        if iw != w or x0 or x1 != w:
            out = _resample_axis0(out.transpose(1, 0, 2), w, resample,
                                  _span(x0, x1)).transpose(1, 0, 2)
        if ih != h or y0 or y1 != h:
            out = _resample_axis0(out, h, resample, _span(y0, y1))
        out = out.astype(np.uint8)
    else:
        raise NotImplementedError(f"resample filter {resample!r} is not ported yet")
    return np.ascontiguousarray(out.reshape((h, w) + a.shape[2:]))


# --------------------------------------------------------------------------
# tiles and resize modes (sdwebui_tpu/utils/images.py:379-483)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Grid:
    """Rows of [y, h, [[x, w, tile], ...]] over an image_w x image_h image."""
    tiles: list
    tile_w: int
    tile_h: int
    image_w: int
    image_h: int
    overlap: int


def split_grid(image, tile_w: int = 512, tile_h: int = 512, overlap: int = 64) -> Grid:
    """Overlapping tiles of an RGB image (images.py:388)."""
    a = np.asarray(image)
    h, w = a.shape[:2]
    non_overlap_width = tile_w - overlap
    non_overlap_height = tile_h - overlap
    cols = max((w - overlap + non_overlap_width - 1) // non_overlap_width, 1)
    rows = max((h - overlap + non_overlap_height - 1) // non_overlap_height, 1)
    dx = (w - tile_w) / (cols - 1) if cols > 1 else 0
    dy = (h - tile_h) / (rows - 1) if rows > 1 else 0
    grid = Grid([], tile_w, tile_h, w, h, overlap)
    for row in range(rows):
        row_images = []
        y = min(int(row * dy), h - tile_h) if h >= tile_h else 0
        for col in range(cols):
            x = min(int(col * dx), w - tile_w) if w >= tile_w else 0
            row_images.append([x, tile_w, crop(a, (x, y, x + tile_w, y + tile_h))])
        grid.tiles.append([y, tile_h, row_images])
    return grid


def _feather(r: np.ndarray, overlap: int) -> np.ndarray:
    r = r * 255 / overlap
    return np.clip(r, 0, 255).astype(np.uint8)


def combine_grid(grid: Grid) -> np.ndarray:
    """Tiles back into one RGB image, each overlap feathered over its
    neighbour by a linear L ramp (images.py:414)."""
    mask_w = _feather(np.arange(grid.overlap, dtype=np.float32).reshape((1, grid.overlap))
                      .repeat(grid.tile_h, axis=0), grid.overlap)
    mask_h = _feather(np.arange(grid.overlap, dtype=np.float32).reshape((grid.overlap, 1))
                      .repeat(grid.image_w, axis=1), grid.overlap)
    combined = np.zeros((grid.image_h, grid.image_w, 3), np.uint8)
    for y, h, row in grid.tiles:
        combined_row = np.zeros((h, grid.image_w, 3), np.uint8)
        for x, w, tile in row:
            if x == 0:
                paste(combined_row, tile, (0, 0))
                continue
            paste(combined_row, crop(tile, (0, 0, grid.overlap, h)), (x, 0), mask=mask_w)
            paste(combined_row, crop(tile, (grid.overlap, 0, w, h)), (x + grid.overlap, 0))
        if y == 0:
            paste(combined, combined_row, (0, 0))
            continue
        paste(combined, crop(combined_row, (0, 0, grid.image_w, grid.overlap)), (0, y),
              mask=mask_h)
        paste(combined, crop(combined_row, (0, grid.overlap, grid.image_w, h)),
              (0, y + grid.overlap))
    return combined


def resize_image(resize_mode: int, im, width: int, height: int,
                 upscaler_name: str | None = None) -> np.ndarray:
    """RGB image → (height, width, 3) (images.py:445): 0 stretch, 1 crop to
    fill, 2 (and any other) pad to fit (black bars), 3 as 0 (JAX's "just resize (latent
    upscale)" resizes the image and leaves the latent alone).  A leg that
    upscales runs the named upscaler first (opts.upscaler_for_img2img);
    LANCZOS makes the size."""
    from sdwebui_tpu_torch.postprocessing import upscalers

    def _resize(img, w, h):
        if upscaler_name and upscaler_name != "None" and (w > img.shape[1] or h > img.shape[0]):
            img = upscalers.upscale(upscaler_name, img,
                                    max(w / img.shape[1], h / img.shape[0]))
        return resize(img, (w, h), "lanczos")

    a = to_rgb(im)
    if resize_mode in (0, 3):
        return _resize(a, width, height)
    iw, ih = a.shape[1], a.shape[0]
    ratio, src_ratio = width / height, iw / ih
    if resize_mode == 1:            # crop
        src_w = width if ratio > src_ratio else iw * height // ih
        src_h = height if ratio <= src_ratio else ih * width // iw
    else:                           # pad
        src_w = width if ratio < src_ratio else iw * height // ih
        src_h = height if ratio >= src_ratio else ih * width // iw
    res = np.zeros((height, width, 3), np.uint8)
    return paste(res, _resize(a, src_w, src_h),
                 (width // 2 - src_w // 2, height // 2 - src_h // 2))


def mask_composite(image, mask) -> np.ndarray:
    """``Image.composite(image as RGBa, an empty RGBa, mask).convert("RGBA")``
    (img2img's return_mask_composite): each RGBa byte of the image blended
    with 0 by the L mask, then unpremultiplied; (H, W, 4) uint8."""
    from sdwebui_tpu_torch.utils.masking import unpremultiply

    rgb = to_rgb(image)
    m = as_hwc(mask).astype(np.int32)
    rgba = np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)], axis=-1)
    return unpremultiply(_div255(rgba.astype(np.int32) * m).astype(np.uint8))


# --------------------------------------------------------------------------
# Image.transform(AFFINE, BILINEAR) and MinFilter (the face paste-back)
# --------------------------------------------------------------------------

def affine_transform(image, size, coeffs) -> np.ndarray:
    """``image.transform(size, Image.AFFINE, coeffs, Image.BILINEAR)`` of an
    L or RGB uint8 image: output pixel (x, y) samples the input at
    (a·(x+½) + b·(y+½) + c, d·(x+½) + e·(y+½) + f), in double precision as
    Geometry.c's ``affine_transform`` and ``bilinear_filter`` compute it;
    a point outside the input is 0, a tap past the edge reads the edge."""
    a = np.asarray(image)
    hwc = as_hwc(a)
    ih, iw = hwc.shape[:2]
    w, h = (int(v) for v in size)
    c0, c1, c2, c3, c4, c5 = (float(v) for v in coeffs)
    xin = np.arange(w, dtype=np.float64)[None, :] + 0.5
    yin = np.arange(h, dtype=np.float64)[:, None] + 0.5
    xx = c0 * xin + c1 * yin + c2
    yy = c3 * xin + c4 * yin + c5
    inside = (xx >= 0.0) & (xx < iw) & (yy >= 0.0) & (yy < ih)
    xx, yy = np.where(inside, xx - 0.5, 0.0), np.where(inside, yy - 0.5, 0.0)
    x0, y0 = np.floor(xx).astype(np.int64), np.floor(yy).astype(np.int64)
    dx, dy = (xx - x0)[..., None], (yy - y0)[..., None]
    xa, xb = np.clip(x0, 0, iw - 1), np.clip(x0 + 1, 0, iw - 1)
    ya, yb = np.clip(y0, 0, ih - 1), np.clip(y0 + 1, 0, ih - 1)
    px = hwc.astype(np.int64)

    def row(y):       # BILINEAR(v, in[x0], in[x1], dx) along one input row
        left = px[y, xa]
        return left + (px[y, xb] - left) * dx

    v1 = row(ya)
    v2 = np.where(((y0 + 1 >= 0) & (y0 + 1 < ih))[..., None], row(yb), v1)
    v = v1 + (v2 - v1) * dy
    out = np.where(inside[..., None], v, 0.0).astype(np.uint8)
    return np.ascontiguousarray(out.reshape((h, w) + a.shape[2:]))


def min_filter(image, size: int) -> np.ndarray:
    """``image.filter(ImageFilter.MinFilter(size))`` of an L or RGB uint8
    image: Pillow expands the image by size // 2 replicated edge pixels and
    takes each size x size window's minimum, each channel on its own."""
    a = np.asarray(image, np.uint8)
    return ndimage.minimum_filter(a, size=(size, size) + (1,) * (a.ndim - 2), mode="nearest")
