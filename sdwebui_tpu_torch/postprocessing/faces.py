"""Face restoration: align → restore (GFPGAN / CodeFormer) → paste back.

Port of ``sdwebui_tpu/postprocessing/faces.py`` (the reference's
face_restoration_utils flow): each face's 5 landmarks are fitted to the
FFHQ 512 template by a least-squares similarity (Umeyama), the face is
warped to a crop at the restorer's size, restored, warped back and pasted
through a mask eroded by a 9x9 minimum and feathered by a Gaussian blur of
radius 8; the result is blended with the input by ``visibility``.  Without
a detector (``set_face_detector``), or when it finds no face, the whole
frame is one face, resized to the crop and back with Lanczos.  The Pillow
operations are ``utils/images`` / ``utils/masking`` restatements, equal to
Pillow in every pixel.

The restorer weights are the first ``.pth`` / ``.pt`` / ``.safetensors`` /
``.ckpt`` file under each restorer's directories (``set_model_dirs``;
``models/GFPGAN`` and ``models/Codeformer`` by default).  One face model
is resident at a time, in f32 on the device the caller names (the Engine's
device; ``cuda`` unless the caller asks for the CPU).  A restorer with no
file raises :class:`FaceRestorerNotFound`.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from sdwebui_tpu_torch.utils import images as images_util
from sdwebui_tpu_torch.utils import masking
from sdwebui_tpu_torch.utils.devices import get_device

# FFHQ 5-point template for a 512x512 crop (facexlib convention)
FACE_TEMPLATE_512 = np.array([
    [192.98138, 239.94708], [318.90277, 240.19360], [256.63416, 314.01935],
    [201.26117, 371.41043], [313.08905, 371.15118]], np.float64)

RESTORERS = ("CodeFormer", "GFPGAN")
DEFAULT_DIRS = {"GFPGAN": (os.path.join("models", "GFPGAN"),),
                "CodeFormer": (os.path.join("models", "Codeformer"),)}

_detector = None        # callable: uint8 RGB (H, W, 3) → list of (5, 2) landmarks
_models: dict = {}      # (name, device) → (net, crop size): at most one entry
_dirs = {name: list(dirs) for name, dirs in DEFAULT_DIRS.items()}


class FaceRestorerNotFound(FileNotFoundError):
    """A restorer whose weights are in none of its directories."""


def set_face_detector(fn):
    """fn(uint8 RGB image) → list of (5, 2) float landmark arrays (eyes,
    nose, mouth corners), one per face; None: no detector."""
    global _detector
    _detector = fn


def set_model_dirs(name: str, dirs):
    """The directories searched for `name`'s weights; drops a resident
    model of that name."""
    _dirs[name] = list(dirs)
    for key in [k for k in _models if k[0] == name]:
        del _models[key]


def _find_model(name: str) -> str | None:
    for d in _dirs.get(name, []):
        if not os.path.isdir(d):
            continue
        for fn in sorted(os.listdir(d)):
            if fn.endswith((".pth", ".pt", ".safetensors", ".ckpt")):
                return os.path.join(d, fn)
    return None


def available_restorers() -> list:
    """"None" and each restorer with a weights file (``/face-restorers``)."""
    return ["None"] + [name for name in RESTORERS if _find_model(name)]


# --------------------------------------------------------------------------
# geometry
# --------------------------------------------------------------------------

def similarity_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Umeyama least-squares similarity (rotation, scale, translation):
    2x3 matrix M with dst ≈ src @ M[:, :2].T + M[:, 2]."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    src_mean = src.mean(0)
    dst_mean = dst.mean(0)
    src_c = src - src_mean
    dst_c = dst - dst_mean
    cov = dst_c.T @ src_c / len(src)
    u, s, vt = np.linalg.svd(cov)
    d = np.sign(np.linalg.det(u) * np.linalg.det(vt))
    diag = np.diag([1.0, d])
    var_src = (src_c ** 2).sum() / len(src)
    scale = np.trace(np.diag(s) @ diag) / var_src
    rot = scale * (u @ diag @ vt)
    t = dst_mean - rot @ src_mean
    return np.concatenate([rot, t[:, None]], axis=1)


def invert_affine(m: np.ndarray) -> np.ndarray:
    rot_inv = np.linalg.inv(m[:, :2])
    t_inv = -rot_inv @ m[:, 2]
    return np.concatenate([rot_inv, t_inv[:, None]], axis=1)


def warp(image: np.ndarray, m: np.ndarray, size: tuple) -> np.ndarray:
    """out(x) = in(M⁻¹ x) at `size` (w, h): Pillow's AFFINE transform,
    which takes the inverse map."""
    inv = invert_affine(m)
    return images_util.affine_transform(image, size, (inv[0, 0], inv[0, 1], inv[0, 2],
                                                      inv[1, 0], inv[1, 1], inv[1, 2]))


def paste_mask(m: np.ndarray, crop_size: int, size: tuple) -> np.ndarray:
    """The L mask a restored crop is pasted through: the crop's square
    warped back by M⁻¹, eroded by MinFilter(9), feathered by GaussianBlur(8)."""
    mask = warp(np.full((crop_size, crop_size), 255, np.uint8), invert_affine(m), size)
    return masking.gaussian_blur(images_util.min_filter(mask, 9), 8)


# --------------------------------------------------------------------------
# restorers
# --------------------------------------------------------------------------

def _load_restorer(name: str, device):
    """(net, crop size) of `name` on `device`, loaded when not resident;
    loading it drops whatever face model was resident."""
    key = (name, str(device))
    if key in _models:
        return _models[key]
    if name not in RESTORERS:
        raise NotImplementedError(f"face restorer {name!r} is not ported (one of {RESTORERS})")
    path = _find_model(name)
    if path is None:
        raise FaceRestorerNotFound(f"no {name} weights under {_dirs.get(name)}: put the "
                                   f"official checkpoint there")
    from sdwebui_tpu_torch.loader.load import read_checkpoint

    sd = read_checkpoint(path)
    if name == "GFPGAN":
        from sdwebui_tpu_torch.models.gfpgan import gfpgan_from_state_dict

        net = gfpgan_from_state_dict(sd, device)
        size = net.cfg.out_size
    else:
        from sdwebui_tpu_torch.models.codeformer import codeformer_from_state_dict

        net = codeformer_from_state_dict(sd, device)
        size = net.cfg.img_size
    _models.clear()
    _models[key] = (net, size)
    return _models[key]


@torch.inference_mode()
def restore_crop(crop: np.ndarray, name: str, weight: float, device) -> np.ndarray:
    """One aligned uint8 crop through the restorer: [-1, 1] in, the output
    mapped back to uint8 as JAX's ``_restore_crop`` maps it."""
    net, _ = _load_restorer(name, device)
    x = np.asarray(crop, np.float32)[None] / 127.5 - 1.0
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).to(device)
    out = net(xt) if name == "GFPGAN" else net(xt, w=float(weight), adain=True)
    out = out[0].permute(1, 2, 0).float().cpu().numpy()
    return np.clip((out + 1.0) * 127.5 + 0.5, 0, 255).astype(np.uint8)


def restore_faces(image, restorer: str = "CodeFormer", weight: float = 0.5,
                  visibility: float = 1.0, crop_size: int | None = None,
                  device="cuda") -> np.ndarray:
    """The reference's restore_with_helper flow on a uint8 image: per
    detected face align, restore and paste back; blend the result with the
    input by `visibility` (the Extras sliders).  crop_size defaults to the
    restorer's native face size (512 for the official checkpoints).  The
    input comes back as it is for restorer "None" or visibility 0."""
    if restorer in (None, "", "None") or visibility <= 0:
        return image
    device = get_device(device)
    image = images_util.to_rgb(image)
    if crop_size is None:
        crop_size = _load_restorer(restorer, device)[1]
    found = _detector(image) if _detector is not None else None
    h, w = image.shape[:2]
    if not found:
        crop = images_util.resize(image, (crop_size, crop_size), "lanczos")
        result = images_util.resize(restore_crop(crop, restorer, weight, device), (w, h),
                                    "lanczos")
    else:
        result = image.copy()
        for lm in found:
            m = similarity_transform(np.asarray(lm, np.float64),
                                     FACE_TEMPLATE_512 * (crop_size / 512.0))
            crop = warp(image, m, (crop_size, crop_size))
            restored = restore_crop(crop, restorer, weight, device)
            back = warp(restored, invert_affine(m), (w, h))
            result = images_util.composite(back, result, paste_mask(m, crop_size, (w, h)))
    if visibility < 1.0:
        result = images_util.blend(image, result, visibility)
    return result
