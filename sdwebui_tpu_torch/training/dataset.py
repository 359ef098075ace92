"""The training dataset: templates, captions, the learn-rate schedule, the
pre-encoded latents and the focal-point crop.

Port of ``sdwebui_tpu/training/dataset.py:21-384``.  Images are files read
by ``utils/image_io.decode_image`` in any format it reads, as JAX reads
them through Pillow (a file in a format it does not read, AVIF say, raises
naming the file and its format), resized with ``utils/images.resize``
(Pillow's bicubic) and encoded once by the port's first stage.  Every
draw of ``np.random.default_rng(seed)`` (the flips, the bucket and entry
choices, the template line, tag dropout and shuffling) comes in JAX's
order, so one seed gives both packages the same batches.  Latents and
weights are NCHW tensors on the model's device.

The focal crop's corner points restate ``cv2.goodFeaturesToTrack``
(``utils/cv.good_features_to_track``); its Haar-cascade face points need
cv2's cascade evaluator and its XML file, which the port does not have:
they are logged once as not ported and left out.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
from collections import defaultdict

import numpy as np
import torch

from sdwebui_tpu_torch.utils import cv
from sdwebui_tpu_torch.utils import images as images_util
from sdwebui_tpu_torch.utils.options import opts
from sdwebui_tpu_torch.utils.image_io import UnsupportedImageFormat, read_image_file

log = logging.getLogger(__name__)

re_numbers_at_start = re.compile(r"^[-\d]+\s*")

# the standard TI prompt-template corpus (the reference's
# textual_inversion_templates/*.txt)
_TEMPLATES = {
    "none": ["picture"],
    "subject": [
        "a photo of a [name]", "a rendering of a [name]",
        "a cropped photo of the [name]", "the photo of a [name]",
        "a photo of a clean [name]", "a photo of a dirty [name]",
        "a dark photo of the [name]", "a photo of my [name]",
        "a photo of the cool [name]", "a close-up photo of a [name]",
        "a bright photo of the [name]", "a cropped photo of a [name]",
        "a photo of the [name]", "a good photo of the [name]",
        "a photo of one [name]", "a close-up photo of the [name]",
        "a rendition of the [name]", "a photo of the clean [name]",
        "a rendition of a [name]", "a photo of a nice [name]",
        "a good photo of a [name]", "a photo of the nice [name]",
        "a photo of the small [name]", "a photo of the weird [name]",
        "a photo of the large [name]", "a photo of a cool [name]",
        "a photo of a small [name]",
    ],
    "style": [
        "a painting, art by [name]", "a rendering, art by [name]",
        "a cropped painting, art by [name]", "the painting, art by [name]",
        "a clean painting, art by [name]", "a dirty painting, art by [name]",
        "a dark painting, art by [name]", "a picture, art by [name]",
        "a cool painting, art by [name]", "a close-up painting, art by [name]",
        "a bright painting, art by [name]", "a cropped painting, art by [name]",
        "a good painting, art by [name]", "a close-up painting, art by [name]",
        "a rendition, art by [name]", "a nice painting, art by [name]",
        "a small painting, art by [name]", "a weird painting, art by [name]",
        "a large painting, art by [name]",
    ],
}
_TEMPLATES["subject_filewords"] = [t.replace("[name]", "[name], [filewords]")
                                   for t in _TEMPLATES["subject"]]
_TEMPLATES["style_filewords"] = [t.replace(", art by [name]", " of [filewords], art by [name]")
                                 for t in _TEMPLATES["style"]]
_TEMPLATES["hypernetwork"] = ["a photo of a [filewords]", "a painting of a [filewords]"]

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".webp", ".bmp")

def load_template(name_or_path: str) -> list[str]:
    """A template set by its name, or the non-empty lines of a template file."""
    if name_or_path in _TEMPLATES:
        return list(_TEMPLATES[name_or_path])
    if os.path.isfile(name_or_path):
        with open(name_or_path, encoding="utf8") as f:
            lines = [x.strip() for x in f.readlines() if x.strip()]
        if lines:
            return lines
    raise ValueError(f"unknown training template: {name_or_path!r}")


def filename_caption(path: str, word_regex: str = "", join_string: str = " ") -> str:
    """An image's caption: its sidecar .txt, else its file name without
    leading numbers, re-joined from `word_regex`'s matches when given."""
    text_filename = os.path.splitext(path)[0] + ".txt"
    if os.path.exists(text_filename):
        with open(text_filename, encoding="utf8") as f:
            return f.read().strip()
    name = re_numbers_at_start.sub("", os.path.splitext(os.path.basename(path))[0])
    if word_regex:
        name = (join_string or "").join(re.compile(word_regex).findall(name))
    return name


def create_text(template_line: str, filename_text: str, placeholder: str,
                tag_drop_out: float = 0.0, shuffle_tags: bool = False,
                rng: np.random.Generator | None = None) -> str:
    """[filewords] and [name] expanded, tags dropped and shuffled."""
    tags = filename_text.split(",")
    if tag_drop_out and rng is not None:
        tags = [t for t in tags if rng.random() > tag_drop_out]
    if shuffle_tags and rng is not None:
        tags = list(tags)
        rng.shuffle(tags)
    return template_line.replace("[filewords]", ",".join(tags)).replace("[name]", placeholder)


class LearnRateScheduler:
    """"0.001:100, 0.00001:1000, 1e-5:10000": 0.001 until step 100, and so
    on; a bare number is constant; step -1 is max_steps."""

    def __init__(self, learn_rate, max_steps: int, cur_step: int = 0):
        self.rates: list[tuple[float, int]] = []
        for pair in str(learn_rate).split(","):
            if not pair.strip():
                continue
            parts = pair.split(":")
            try:
                if len(parts) == 2:
                    step = int(parts[1])
                    if step > cur_step:
                        self.rates.append((float(parts[0]), min(step, max_steps)))
                        if step > max_steps:
                            break
                    elif step == -1:
                        self.rates.append((float(parts[0]), max_steps))
                        break
                else:
                    self.rates.append((float(parts[0]), max_steps))
                    break
            except ValueError as e:
                raise ValueError('Invalid learning rate schedule — use a number or '
                                 '"0.001:100, 0.00001:1000"') from e
        if not self.rates:
            raise ValueError("Invalid learning rate schedule (empty)")
        self._it = 0
        self.learn_rate, self.end_step = self.rates[0]
        self.finished = False

    def rate_at(self, step_number: int) -> float:
        """Advance to `step_number` and return the active rate."""
        while step_number >= self.end_step:
            if self._it + 1 < len(self.rates):
                self._it += 1
                self.learn_rate, self.end_step = self.rates[self._it]
            else:
                self.finished = True
                break
        return self.learn_rate


def read_image(path: str) -> np.ndarray:
    """A dataset file's uint8 (H, W, C) pixels; a format the port does not
    read raises NotImplementedError, naming the file and the format."""
    try:
        return read_image_file(path)[0]
    except UnsupportedImageFormat as e:
        raise NotImplementedError(f"{path}: a {e.fmt} image, which the port does not "
                                  "read") from e


@dataclasses.dataclass
class DatasetEntry:
    filename: str
    filename_text: str
    bucket: tuple                  # (w, h)
    latent: torch.Tensor           # (C, h/8, w/8) scaled latent
    weight: torch.Tensor | None = None    # the same shape, from the alpha


class PersonalizedDataset:
    """A directory of images → latents encoded once, in (w, h) buckets.

    model: the SDModel whose first stage encodes.  varsize: each image
    keeps its own size (multiples of 64) and a batch comes from one
    bucket; else every image is resized to width × height."""

    def __init__(self, data_root: str, model, width: int = 512, height: int = 512,
                 placeholder: str = "*", template: str = "subject", flip_p: float = 0.5,
                 varsize: bool = False, use_weight: bool = False, shuffle_tags: bool = False,
                 tag_drop_out: float = 0.0, word_regex: str | None = None,
                 join_string: str | None = None, latent_sampling_method: str = "once",
                 seed: int = 0, encode_batch: int = 8):
        from sdwebui_tpu_torch.pipeline.processing import encode_first_stage
        from sdwebui_tpu_torch.rng.philox import PhiloxGenerator

        if word_regex is None:
            word_regex = str(opts.get("dataset_filename_word_regex", ""))
        if join_string is None:
            join_string = str(opts.get("dataset_filename_join_string", " "))
        assert os.path.isdir(data_root), f"Dataset directory doesn't exist: {data_root}"
        paths = sorted(os.path.join(data_root, f) for f in os.listdir(data_root)
                       if f.lower().endswith(IMAGE_EXTS))
        assert paths, "No images found in the dataset directory."

        self.placeholder = placeholder
        self.lines = load_template(template)
        self.shuffle_tags = shuffle_tags
        self.tag_drop_out = tag_drop_out
        self.rng = np.random.default_rng(seed)
        self.entries: list[DatasetEntry] = []

        pending = defaultdict(list)      # (w, h) → [(path, text, pixels, alpha)]
        for path in paths:
            try:
                pixels = read_image(path)
            except ValueError:           # not a readable image: skipped, as JAX skips it
                continue
            alpha = pixels[:, :, -1] if use_weight and pixels.shape[2] in (2, 4) else None
            img = images_util.to_rgb(pixels)
            ih, iw = img.shape[:2]
            if varsize:
                w, h = max((iw // 64) * 64, 64), max((ih // 64) * 64, 64)
            else:
                w, h = width, height
            if (iw, ih) != (w, h):
                img = images_util.resize(img, (w, h), "bicubic")
                if alpha is not None:
                    alpha = images_util.resize(alpha, (w, h), "bicubic")
            if flip_p and self.rng.random() < flip_p:
                img = img[:, ::-1]
                if alpha is not None:
                    alpha = alpha[:, ::-1]
            pending[(w, h)].append((path, filename_caption(path, word_regex, join_string),
                                    img.astype(np.float32) / 255.0, alpha))

        vae = model.vae
        for size, items in pending.items():
            for lo in range(0, len(items), encode_batch):
                chunk = items[lo: lo + encode_batch]
                batch = np.stack([c[2] for c in chunk])
                if latent_sampling_method == "random":
                    shape = (batch.shape[0], size[1] // 8, size[0] // 8, model.latent_channels)
                    noise = np.asarray(PhiloxGenerator(seed + lo).randn(shape), np.float32)
                    x = torch.from_numpy(np.ascontiguousarray(batch.transpose(0, 3, 1, 2)))
                    with torch.inference_mode():
                        moments = vae.encode_moments(x.to(model.device) * 2.0 - 1.0)
                        lats = vae.sample_latent(moments, torch.from_numpy(
                            noise.transpose(0, 3, 1, 2)).to(model.device))
                else:                    # "once" and "deterministic": the mean
                    with torch.inference_mode():
                        lats = encode_first_stage(model, batch)
                lats = lats.float().clone()
                for (path, text, _pixels, alpha), lat in zip(chunk, lats):
                    weight = None
                    if use_weight:
                        weight = torch.ones_like(lat)
                        if alpha is not None:
                            wmap = images_util.resize(np.ascontiguousarray(alpha),
                                                      (lat.shape[2], lat.shape[1]),
                                                      "bicubic").astype(np.float32)
                            wmap = wmap - wmap.min()
                            mean = wmap.mean()
                            if mean > 0:
                                weight = torch.from_numpy(wmap / mean).to(lat.device)[None] \
                                    .expand_as(lat).contiguous()
                    self.entries.append(DatasetEntry(path, text, size, lat, weight))

        self.buckets = defaultdict(list)
        for i, e in enumerate(self.entries):
            self.buckets[e.bucket].append(i)

    def __len__(self):
        return len(self.entries)

    def caption_for(self, entry: DatasetEntry) -> str:
        line = self.lines[int(self.rng.integers(0, len(self.lines)))]
        return create_text(line, entry.filename_text, self.placeholder, self.tag_drop_out,
                           self.shuffle_tags, self.rng)

    def sample_batch(self, batch_size: int):
        """One batch from one bucket → (latents (B, C, h, w), texts,
        weights (B, C, h, w) or None)."""
        sizes = list(self.buckets)
        counts = np.asarray([len(self.buckets[s]) for s in sizes], np.float64)
        bucket = sizes[int(self.rng.choice(len(sizes), p=counts / counts.sum()))]
        ids = self.rng.choice(self.buckets[bucket], size=min(batch_size, len(self.buckets[bucket])),
                              replace=len(self.buckets[bucket]) < batch_size)
        entries = [self.entries[int(i)] for i in np.atleast_1d(ids)]
        latents = torch.stack([e.latent for e in entries])
        texts = [self.caption_for(e) for e in entries]
        weights = None
        if entries[0].weight is not None:
            weights = torch.stack([e.weight for e in entries])
        return latents, texts, weights


# --------------------------------------------------------------------------
# the focal-point crop (dataset.py:331-384)
# --------------------------------------------------------------------------

_faces_logged = False


def autocrop_image(image: np.ndarray, crop_width: int = 512, crop_height: int = 512,
                   corner_points_weight: float = 0.5, entropy_points_weight: float = 0.5,
                   face_points_weight: float = 0.5) -> np.ndarray:
    """uint8 (H, W, C) → (crop_height, crop_width, 3): resized to cover the
    crop, then cropped around the weighted mean of its corner points and
    its most entropic 64² tile."""
    global _faces_logged
    img = images_util.to_rgb(image)
    h, w = img.shape[:2]
    scale = max(crop_width / w, crop_height / h)
    img = images_util.resize(img, (max(int(w * scale), crop_width),
                                   max(int(h * scale), crop_height)), "bicubic")
    h, w = img.shape[:2]
    pois = []
    corners = cv.good_features_to_track(cv.rgb_to_gray(img), 50, 0.04, 10)
    if corners is not None:
        pois += [(float(x), float(y), corner_points_weight) for x, y in corners.reshape(-1, 2)]
    if not _faces_logged:
        _faces_logged = True
        log.warning("autocrop: the Haar-cascade face points are not ported (no cascade "
                    "evaluator); the focal point uses corners and entropy only")
    arr = images_util.to_l(img).astype(np.float64)
    tile = 64
    best, best_e = (w / 2, h / 2), -1.0
    for y0 in range(0, max(arr.shape[0] - tile, 1), tile // 2):
        for x0 in range(0, max(arr.shape[1] - tile, 1), tile // 2):
            hist, _ = np.histogram(arr[y0: y0 + tile, x0: x0 + tile], bins=64, range=(0, 255))
            p = hist / max(hist.sum(), 1)
            e = -np.sum(p[p > 0] * np.log2(p[p > 0]))
            if e > best_e:
                best_e, best = e, (x0 + tile / 2, y0 + tile / 2)
    pois.append((best[0], best[1], entropy_points_weight))
    wsum = sum(p[2] for p in pois)
    fx = sum(p[0] * p[2] for p in pois) / wsum
    fy = sum(p[1] * p[2] for p in pois) / wsum
    left = int(min(max(fx - crop_width / 2, 0), w - crop_width))
    top = int(min(max(fy - crop_height / 2, 0), h - crop_height))
    return np.ascontiguousarray(img[top: top + crop_height, left: left + crop_width])
