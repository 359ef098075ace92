"""The dataset preprocessing pass: split, focal crop, auto-sized crop, flip,
caption.

Port of ``sdwebui_tpu/training/preprocess.py:17-159``, on uint8 (H, W, 3)
arrays: Pillow's resizes are ``utils/images.resize`` (bicubic, and
Lanczos over a fractional box for the centre crop), the focal crop is
``training/dataset.autocrop_image``, the captions DeepDanbooru's
(``models/deepbooru``), the outputs PNG files written by
``utils/png.encode_png``.  The inputs are files in any format
``utils/image_io`` reads; another format raises, naming the file
(``training/dataset.read_image``).
"""

from __future__ import annotations

import glob
import math
import os

import numpy as np

from sdwebui_tpu_torch.training.dataset import IMAGE_EXTS, autocrop_image, read_image
from sdwebui_tpu_torch.utils import images as images_util
from sdwebui_tpu_torch.utils.options import opts
from sdwebui_tpu_torch.utils.png import encode_png

#: where DeepDanbooru's weights are found (``.pt`` or ``.pth``)
DEEPBOORU_DIR = os.path.join("models", "torch_deepdanbooru")


def split_oversized(image: np.ndarray, width: int, height: int, overlap_ratio: float = 0.2,
                    threshold: float = 2.0) -> list:
    """An image whose long side passes `threshold` × the target ratio,
    resized to the target's short side and cut into overlapping crops;
    else [image]."""
    ih, iw = image.shape[:2]
    if ih > iw and ih / iw > threshold:
        inverse_xy = False
    elif iw > ih and iw / ih > threshold:
        inverse_xy = True
    else:
        return [image]
    if inverse_xy:
        from_w, from_h, to_w, to_h = ih, iw, height, width
    else:
        from_w, from_h, to_w, to_h = iw, ih, width, height
    h = from_h * to_w // from_w
    image = images_util.resize(image, (h, to_w) if inverse_xy else (to_w, h), "bicubic")
    split_count = math.ceil((h - to_h * overlap_ratio) / (to_h * (1.0 - overlap_ratio)))
    if split_count < 2:
        return [image]
    y_step = (h - to_h) / (split_count - 1)
    out = []
    for i in range(split_count):
        y = int(y_step * i)
        out.append(image[:, y: y + to_h] if inverse_xy else image[y: y + to_h, :to_w])
    return [np.ascontiguousarray(o) for o in out]


def center_crop(image: np.ndarray, w: int, h: int) -> np.ndarray:
    """The centred w:h box of the image, Lanczos-resized to w × h."""
    ih, iw = image.shape[:2]
    if ih / h < iw / w:
        sw = w * ih / h
        box = ((iw - sw) / 2, 0, iw - (iw - sw) / 2, ih)
    else:
        sh = h * iw / w
        box = (0, (ih - sh) / 2, iw, ih - (ih - sh) / 2)
    return images_util.resize(image, (w, h), "lanczos", box)


def autosized_crop(image: np.ndarray, mindim: int = 384, maxdim: int = 768,
                   minarea: int = 64 * 64, maxarea: int = 640 * 640,
                   objective: str = "Maximize area", threshold: float = 0.15):
    """The centre crop at the grid size of least aspect error within the
    bounds, or None when no size qualifies."""
    ih, iw = image.shape[:2]

    def err(w, h):
        x = iw / ih / (w / h)
        return 1 - (x if x < 1 else 1 / x)

    candidates = [(w, h) for w in range(mindim, maxdim + 1, 64)
                  for h in range(mindim, maxdim + 1, 64)
                  if minarea <= w * h <= maxarea and err(w, h) <= threshold]
    if not candidates:
        return None
    rev = 1 if objective == "Maximize area" else -1
    wh = max(candidates, key=lambda p: (p[0] * p[1] * rev, -err(*p) * rev))
    return center_crop(image, *wh)


def find_deepbooru(dirpath: str = DEEPBOORU_DIR) -> str | None:
    files = sorted(glob.glob(os.path.join(dirpath, "*.pt"))) + \
        sorted(glob.glob(os.path.join(dirpath, "*.pth")))
    return files[0] if files else None


def preprocess_dir(input_dir: str, output_dir: str, width: int = 512, height: int = 512,
                   split: bool = False, split_threshold: float = 2.0,
                   overlap_ratio: float = 0.2, flip: bool = False, focal_crop: bool = False,
                   auto_size_crop: bool = False, caption_deepbooru: bool = False,
                   existing_caption_action: str = "ignore", device="cuda",
                   deepbooru_dir: str = DEEPBOORU_DIR) -> list[str]:
    """Every image of input_dir through split → focal crop or auto-sized
    crop → flip → caption, written to output_dir as PNG (with a .txt
    caption beside it); returns the written paths.  DeepDanbooru runs on
    `device`."""
    from sdwebui_tpu_torch.models import deepbooru

    os.makedirs(output_dir, exist_ok=True)
    booru = None
    if caption_deepbooru:
        path = find_deepbooru(deepbooru_dir)
        if path:
            booru = deepbooru.load_deepbooru(path, device)
    written = []
    for fn in sorted(os.listdir(input_dir)):
        if not fn.lower().endswith(IMAGE_EXTS):
            continue
        src_path = os.path.join(input_dir, fn)
        img = images_util.to_rgb(read_image(src_path))
        existing_txt = os.path.splitext(src_path)[0] + ".txt"
        caption = ""
        if os.path.exists(existing_txt) and existing_caption_action != "ignore":
            with open(existing_txt, encoding="utf8") as f:
                caption = f.read().strip()
        crops = split_oversized(img, width, height, overlap_ratio, split_threshold) \
            if split else [img]
        outs = []
        for c in crops:
            if focal_crop:
                c = autocrop_image(c, width, height)
            elif auto_size_crop:
                cropped = autosized_crop(c)
                c = c if cropped is None else cropped
            outs.append(c)
            if flip:
                outs.append(np.ascontiguousarray(c[:, ::-1]))
        stem = os.path.splitext(fn)[0]
        for i, c in enumerate(outs):
            suffix = f"-{i}" if len(outs) > 1 else ""
            out_path = os.path.join(output_dir, f"{stem}{suffix}.png")
            with open(out_path, "wb") as f:
                f.write(encode_png(c))
            written.append(out_path)
            text = caption
            if booru is not None:
                tags = deepbooru.tag_image(booru, c, threshold=float(opts.get(
                    "interrogate_deepbooru_score_threshold", 0.5)))
                if text and existing_caption_action == "prepend":
                    text = f"{text}, {tags}"
                elif text and existing_caption_action == "append":
                    text = f"{tags}, {text}"
                elif not text or existing_caption_action == "copy":
                    text = tags
            if text:
                with open(os.path.splitext(out_path)[0] + ".txt", "w", encoding="utf8") as f:
                    f.write(text)
    return written
