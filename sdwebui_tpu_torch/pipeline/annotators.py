"""ControlNet annotators (hint preprocessors) on uint8 numpy images.

Port of ``sdwebui_tpu/pipeline/annotators.py``.  The JAX package calls
OpenCV; the port has no cv2, so what the annotators take from it is
restated in numpy / scipy (``utils/cv``, and canny here) and held to
OpenCV in the tests:

- ``canny``: ``cv2.Canny(rgb, low, high)``: a 3×3 Sobel per channel with
  replicated borders, at each pixel the channel whose L1 magnitude
  |dx| + |dy| is largest (the first on a tie), OpenCV's non-maximum
  suppression (its fixed-point tan 22.5° test, ``>`` against one
  neighbour and ``>=`` against the other along the axes, ``>`` against
  both on the diagonals), then hysteresis: candidates above `low`
  8-connected to one above `high`;
- ``invert``: 255 − image;
- ``threshold``: RGB → grey with OpenCV's fixed-point weights, then
  THRESH_BINARY;
- ``blur_gaussian``, ``scribble_xdog``, ``shuffle`` (numpy's
  ``RandomState`` flow field, as JAX);
- the model-based ``depth`` / ``depth_midas`` (``models/midas``),
  ``hed`` / ``softedge_hed``, ``hed_safe`` and ``scribble_hed``
  (``models/hed``), whose weights are looked up as JAX looks them up
  (:func:`set_annotator_dirs`, default ``models/Annotators`` and
  ``models/annotator``: the first file, by sorted name, whose lowered name
  holds one of the module's substrings) and read through the port's
  ``read_checkpoint``; the nets run in fp32 on the caller's device.

``processor_res`` resizes the short side to `res` (both sides rounded to
/8) with cv2's INTER_AREA when it shrinks and INTER_LANCZOS4 when it
grows.  Every annotator: uint8 RGB (H, W, 3) → uint8 (H, W) or (H, W, 3)
hint, white where the feature is; ``openpose`` draws the body-pose
skeleton (``models/openpose``, its cv2 calls restated in ``utils/cv``).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage

from sdwebui_tpu_torch.networks import NetworkNotFound
from sdwebui_tpu_torch.utils import cv
from sdwebui_tpu_torch.utils.devices import get_device

# tan(22.5°) in OpenCV's Q15 fixed point (imgproc/src/canny.cpp)
_TG22 = 13573


def _resize_for_detect(img: np.ndarray, res: int) -> np.ndarray:
    """processor_res: the short side to `res`, both sides rounded to /8
    (INTER_AREA shrinking, INTER_LANCZOS4 growing; the same size is a
    copy, as in cv2)."""
    if not res:
        return img
    h, w = img.shape[:2]
    k = res / min(h, w)
    nh, nw = int(round(h * k / 8)) * 8, int(round(w * k / 8)) * 8
    return cv.resize(img, (nw, nh), "area" if k < 1 else "lanczos4")


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


def blur_gaussian(img, res: int = 512, sigma: float = 9, b: float = 0):
    """Gaussian blur (tile / blur control models)."""
    return cv.gaussian_blur(_resize_for_detect(img, res), float(sigma) or 9)


def scribble_xdog(img, res: int = 512, xdog_threshold: float = 32, b: float = 0):
    """XDoG sketch: the difference of two Gaussians of the float image, its
    channel minimum, thresholded to a white-on-black scribble."""
    img = _resize_for_detect(img, res).astype(np.float32)
    g1, g2 = cv.gaussian_blur(img, 0.5), cv.gaussian_blur(img, 5.0)
    dog = np.clip(255 - np.min(g2 - g1, axis=2), 0, 255)
    return ((2 * (255 - dog) > float(xdog_threshold)) * 255).astype(np.uint8)


def shuffle(img, res: int = 512, a: float = 0, b: float = 0, seed: int = 0):
    """Content shuffle by a random flow warp: numpy RandomState(seed) flow
    on a /8 grid, resized (INTER_LINEAR) to the image, ×256, remapped."""
    img = _resize_for_detect(img, res)
    h, w = img.shape[:2]
    rng = np.random.RandomState(seed)
    flow = [cv.resize(rng.uniform(-1, 1, (h // 8 + 1, w // 8 + 1)).astype(np.float32),
                      (w, h), "linear") * 256 for _ in range(2)]
    xs = np.clip(np.arange(w)[None, :] + flow[0], 0, w - 1).astype(np.float32)
    ys = np.clip(np.arange(h)[:, None] + flow[1], 0, h - 1).astype(np.float32)
    return cv.remap_linear(img, xs, ys)


# --------------------------------------------------------------------------
# model-based annotators (annotators.py:110-196)
# --------------------------------------------------------------------------

_model_dirs = ["models/Annotators", "models/annotator"]
_loaded: dict = {}


def set_annotator_dirs(dirs):
    """The directories the model-based annotators' files are looked up in
    (the cached nets are dropped)."""
    _model_dirs[:] = list(dirs)
    _loaded.clear()


def _find_weights(*substrings) -> str | None:
    for d in _model_dirs:
        if not os.path.isdir(d):
            continue
        for fn in sorted(os.listdir(d)):
            low = fn.lower()
            if any(s in low for s in substrings) and \
                    low.endswith((".pth", ".pt", ".safetensors", ".ckpt")):
                return os.path.join(d, fn)
    return None


def _load(name: str, substrings, build, device):
    """The net of annotator `name` on `device`, built once from the first
    file matching `substrings`."""
    key = (name, str(device))
    if key not in _loaded:
        path = _find_weights(*substrings)
        if path is None:
            raise RuntimeError(
                f"annotator '{name}' needs weights matching {substrings} under "
                f"{_model_dirs}: put the extension's model file there")
        from sdwebui_tpu_torch.loader.load import read_checkpoint

        _loaded[key] = build(read_checkpoint(path), device)
    return _loaded[key]


def _build_hed(sd: dict, device):
    from sdwebui_tpu_torch.loader.convert import convert_hed
    from sdwebui_tpu_torch.loader.load import build

    flat, widths = convert_hed(sd)
    return build("hed", widths, flat, device, torch.float32)


def _build_dpt(sd: dict, device):
    from sdwebui_tpu_torch.loader.convert import convert_dpt
    from sdwebui_tpu_torch.loader.load import build

    flat, cfg = convert_dpt(sd, prefix="")
    return build("dpt", cfg, flat, device, torch.float32).standardize_()


def hed(img, res: int = 512, a: float = 0, b: float = 0, device=None):
    """HED soft edges (ControlNetHED.pth)."""
    from sdwebui_tpu_torch.models.hed import estimate

    img = _resize_for_detect(img, res)
    net = _load("hed", ("controlnethed", "hed"), _build_hed, get_device(device or "cuda"))
    return (estimate(net, img) * 255.0).clip(0, 255).astype(np.uint8)


def hed_safe(img, res: int = 512, a: float = 0, b: float = 0, device=None):
    from sdwebui_tpu_torch.models.hed import safe_step

    return (safe_step(hed(img, res, device=device) / 255.0) * 255).clip(0, 255) \
        .astype(np.uint8)


def scribble_hed(img, res: int = 512, a: float = 0, b: float = 0, device=None):
    """HED → directional NMS → a binary scribble."""
    from sdwebui_tpu_torch.models.hed import nms

    detected = nms(hed(img, res, device=device), 127, 3.0)
    detected[detected > 4] = 255
    detected[detected < 255] = 0
    return detected


@torch.inference_mode()
def depth_midas(img, res: int = 512, a: float = 0, b: float = 0, device=None):
    """MiDaS DPT-hybrid inverse depth, min-max normalised (white = near):
    the image in [-1, 1] resized (bicubic, as jax.image.resize) to the
    tower's size, the depth back to the image's with cv2's INTER_CUBIC."""
    img = _resize_for_detect(img, res)
    tower = _load("depth_midas", ("dpt_hybrid", "midas"), _build_dpt,
                  get_device(device or "cuda"))
    h, w = img.shape[:2]
    s = tower.cfg.image_size
    x = torch.from_numpy(np.ascontiguousarray(img.transpose(2, 0, 1)))[None]
    x = x.to(tower.pretrained.model.cls_token.device, torch.float32) / 127.5 - 1.0
    x = F.interpolate(x, size=(s, s), mode="bicubic", align_corners=False, antialias=True)
    depth = tower(x)[0, 0].float().cpu().numpy()
    depth = cv.resize(depth, (w, h), "cubic")
    lo, hi = float(depth.min()), float(depth.max())
    return ((depth - lo) / max(hi - lo, 1e-8) * 255).astype(np.uint8)


def _build_openpose(sd: dict, device):
    from sdwebui_tpu_torch.models.openpose import openpose_from_state_dict

    return openpose_from_state_dict(sd, device)


def openpose(img, res: int = 512, a: float = 0, b: float = 0, device=None):
    """The body-pose skeleton (``models/openpose``; body_pose_model.pth),
    annotators.py:183-191 of the JAX package."""
    from sdwebui_tpu_torch.models import openpose as pose

    img = _resize_for_detect(img, res)
    net = _load("openpose", ("body_pose",), _build_openpose, get_device(device or "cuda"))
    candidate, subset = pose.estimate(net, img)
    return pose.draw_bodypose(img.shape[0], img.shape[1], candidate, subset)


_MODEL_BASED = (hed, hed_safe, scribble_hed, depth_midas, openpose)

ANNOTATORS = {
    "none": None,
    "canny": canny,
    "invert": invert,
    "invert (from white bg & black line)": invert,
    "blur_gaussian": blur_gaussian,
    "threshold": threshold,
    "scribble_xdog": scribble_xdog,
    "shuffle": shuffle,
    "hed": hed,
    "hed_safe": hed_safe,
    "softedge_hed": hed,
    "scribble_hed": scribble_hed,
    "depth": depth_midas,
    "depth_midas": depth_midas,
    "openpose": openpose,
}


def list_modules() -> list[str]:
    return list(ANNOTATORS)


def run_annotator(module: str, image: np.ndarray, res: int = 512,
                  threshold_a: float | None = None,
                  threshold_b: float | None = None, device=None) -> np.ndarray:
    """The annotator `module` on an image (uint8, or float in [0, 1]);
    threshold_a / threshold_b follow the extension's per-module meaning
    (canny low / high, the threshold, blur sigma, xdog threshold).  The
    model-based modules run on `device` (default: the card)."""
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
    kw = {"device": device} if fn in _MODEL_BASED else {}
    return fn(img, res, *args, **kw)
