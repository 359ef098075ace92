"""ControlNet annotators (hint preprocessors) on uint8 numpy images.

Port of ``sdwebui_tpu/pipeline/annotators.py:33-69,205-236``.  The JAX
package calls OpenCV; the port has no cv2, so the annotators it runs are
restated in numpy / scipy and equal OpenCV's output in every pixel
(``tests/test_torch_controlnet.py`` holds them to cv2):

- ``canny``: ``cv2.Canny(rgb, low, high)``: a 3×3 Sobel per channel with
  replicated borders, at each pixel the channel whose L1 magnitude
  |dx| + |dy| is largest (the first on a tie), OpenCV's non-maximum
  suppression (its fixed-point tan 22.5° test, ``>`` against one
  neighbour and ``>=`` against the other along the axes, ``>`` against
  both on the diagonals), then hysteresis: candidates above `low`
  8-connected to one above `high`;
- ``invert``: 255 − image;
- ``threshold``: RGB → grey with OpenCV's fixed-point weights, then
  THRESH_BINARY.

Every annotator: uint8 RGB (H, W, 3) → uint8 (H, W) or (H, W, 3) hint,
white where the feature is.  The model-based modules, ``blur_gaussian``,
``scribble_xdog`` and ``shuffle`` raise ``NotImplementedError``, and so
does a ``processor_res`` that would resize the image (cv2's INTER_AREA /
LANCZOS4); a resize to the same size is a copy, as in cv2.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

from sdwebui_tpu_torch.networks import NetworkNotFound

# tan(22.5°) in OpenCV's Q15 fixed point (imgproc/src/canny.cpp)
_TG22 = 13573


def _resize_for_detect(img: np.ndarray, res: int) -> np.ndarray:
    """processor_res: the short side to `res`, both sides rounded to /8."""
    if not res:
        return img
    h, w = img.shape[:2]
    k = res / min(h, w)
    nh, nw = int(round(h * k / 8)) * 8, int(round(w * k / 8)) * 8
    if (nh, nw) == (h, w):
        return img.copy()
    raise NotImplementedError(
        f"annotator resize {w}x{h} -> {nw}x{nh} (cv2 {'INTER_AREA' if k < 1 else 'LANCZOS4'}) "
        "is not ported yet; send the image at the processor resolution")


def _sobel(ch: np.ndarray):
    """3×3 Sobel dx, dy (int32) of one uint8 channel, replicated border."""
    p = np.pad(ch.astype(np.int32), 1, mode="edge")
    h, w = ch.shape
    win = lambda r, c: p[r:r + h, c:c + w]  # noqa: E731
    dx = (win(0, 2) - win(0, 0)) + 2 * (win(1, 2) - win(1, 0)) + (win(2, 2) - win(2, 0))
    dy = (win(2, 0) - win(0, 0)) + 2 * (win(2, 1) - win(0, 1)) + (win(2, 2) - win(0, 2))
    return dx, dy


def canny_edges(img: np.ndarray, low: float, high: float) -> np.ndarray:
    """``cv2.Canny(img, low, high)`` (aperture 3, L1 gradient) of a uint8
    (H, W) or (H, W, C) image → uint8 (H, W) in {0, 255}."""
    low, high = int(np.floor(low)), int(np.floor(high))
    if low > high:
        low, high = high, low
    a = img[:, :, None] if img.ndim == 2 else img
    grads = [_sobel(a[:, :, c]) for c in range(a.shape[2])]
    dx, dy = grads[0]
    mag = np.abs(dx) + np.abs(dy)
    for cdx, cdy in grads[1:]:
        cmag = np.abs(cdx) + np.abs(cdy)
        better = cmag > mag
        mag = np.where(better, cmag, mag)
        dx = np.where(better, cdx, dx)
        dy = np.where(better, cdy, dy)
    h, w = mag.shape
    m = np.pad(mag, 1)                       # magnitude 0 outside the image
    nb = lambda dr, dc: m[1 + dr:1 + dr + h, 1 + dc:1 + dc + w]  # noqa: E731
    x = np.abs(dx).astype(np.int64)
    y = np.abs(dy).astype(np.int64) << 15
    tg22x = x * _TG22
    tg67x = tg22x + (x << 16)
    horizontal = y < tg22x
    vertical = ~horizontal & (y > tg67x)
    diagonal = ~horizontal & ~vertical
    s = np.where((dx ^ dy) < 0, -1, 1)
    diag_max = np.where(s > 0, (mag > nb(-1, -1)) & (mag > nb(1, 1)),
                        (mag > nb(-1, 1)) & (mag > nb(1, -1)))
    local_max = (horizontal & (mag > nb(0, -1)) & (mag >= nb(0, 1))) \
        | (vertical & (mag > nb(-1, 0)) & (mag >= nb(1, 0))) | (diagonal & diag_max)
    candidate = (mag > low) & local_max
    strong = candidate & (mag > high)
    labels, n = ndimage.label(candidate, structure=np.ones((3, 3), bool))
    keep = np.zeros(n + 1, bool)
    keep[np.unique(labels[strong])] = True
    keep[0] = False
    return np.where(keep[labels], 255, 0).astype(np.uint8)


def canny(img, res: int = 512, low: float = 100, high: float = 200):
    """Canny edges, the reference ecosystem's default module."""
    return canny_edges(_resize_for_detect(img, res), low, high)


def invert(img, res: int = 0, a: float = 0, b: float = 0):
    """White-background lineart → white-on-black hint."""
    return 255 - np.asarray(img)


def rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, COLOR_RGB2GRAY)`` on uint8: (R·9798 + G·19235 +
    B·3735 + 2¹⁴) >> 15, the weights 0.299, 0.587, 0.114 in Q15 summing to
    2¹⁵."""
    rgb = img.astype(np.int32)
    return ((rgb[..., 0] * 9798 + rgb[..., 1] * 19235 + rgb[..., 2] * 3735 + (1 << 14))
            >> 15).astype(np.uint8)


def threshold(img, res: int = 512, thr: float = 127, b: float = 0):
    """Grey above `thr` → 255, else 0 (cv2.THRESH_BINARY)."""
    gray = rgb_to_gray(_resize_for_detect(img, res))
    return np.where(gray > int(thr), 255, 0).astype(np.uint8)


def _not_ported(name: str):
    def run(img, *args):
        raise NotImplementedError(f"annotator {name!r} (a controlnet_units module) is not "
                                  "ported yet (canny, invert and threshold are)")
    return run


ANNOTATORS = {
    "none": None,
    "canny": canny,
    "invert": invert,
    "invert (from white bg & black line)": invert,
    "threshold": threshold,
    **{name: _not_ported(name) for name in (
        "blur_gaussian", "scribble_xdog", "shuffle", "hed", "hed_safe", "softedge_hed",
        "scribble_hed", "depth", "depth_midas", "openpose")},
}


def list_modules() -> list[str]:
    return list(ANNOTATORS)


def run_annotator(module: str, image: np.ndarray, res: int = 512,
                  threshold_a: float | None = None,
                  threshold_b: float | None = None) -> np.ndarray:
    """The annotator `module` on an image (uint8, or float in [0, 1]);
    threshold_a / threshold_b follow the extension's per-module meaning
    (canny low / high, the threshold)."""
    if module not in ANNOTATORS:
        raise NetworkNotFound(f"annotator module {module!r} is unknown "
                              f"(one of {list_modules()})")
    fn = ANNOTATORS[module]
    if fn is None:
        return np.asarray(image)
    img = np.asarray(image)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    args = [t for t in (threshold_a, threshold_b) if t is not None]
    return fn(img, res, *args)
