"""DeepDanbooru, the tagger of interrogate and the preprocess captions.

Port of ``sdwebui_tpu/models/deepbooru.py:24-168``: the bottleneck ResNet
of the TorchDeepDanbooru checkpoint (``n_Conv_N`` convs, 179 in the
published plan) run from its stage plan, NCHW in fp32 (TF32 off, as the
other aux nets): a 7×7/2 stem padded (2, 3) on each axis, a 3×3/2 max pool
padded (0, 1) with −inf, bottleneck stages (1×1 reduce, 3×3 — padded
(0, 1) when strided, else 1 — and 1×1 expand; the conv shortcut of a
stage's first block before its triplet, the mid-network 1024→1024/2
block's after it), a 1×1 tag head, the spatial mean and a sigmoid.  The
convs are plain ``F.conv2d`` (the 3×3 kernel B4 is an entry of its own,
as in JAX).  ``load_deepbooru`` reads the tag list from the checkpoint
itself (JAX's restricted loader drops it and reads a ``.tags.txt``
sidecar, which the port reads when the file has none).
"""

from __future__ import annotations

import dataclasses
import os
import re

import numpy as np
import torch
import torch.nn.functional as F

from sdwebui_tpu_torch.loader.torch_ckpt import load_torch_object
from sdwebui_tpu_torch.utils import images as images_util
from sdwebui_tpu_torch.utils.devices import get_device

#: the published stage plan: ("stage", blocks, mid, out, stride) with the
#: shortcut before the triplet, ("mid_down", mid, out, stride) with it after,
#: ("blocks", n, mid, out) identity blocks
PLAN = (
    ("stage", 3, 64, 256, 1),
    ("stage", 8, 128, 512, 2),
    ("stage", 20, 256, 1024, 2),
    ("mid_down", 256, 1024, 2),
    ("blocks", 19, 256, 1024),
    ("stage", 3, 512, 2048, 2),
    ("stage", 3, 1024, 4096, 2),
)


@dataclasses.dataclass
class DeepDanbooru:
    convs: dict                 # index → {"weight": OIHW, "bias"?} fp32
    tags: list
    plan: tuple = PLAN

    @property
    def device(self) -> torch.device:
        return self.convs["0"]["weight"].device

    def to(self, device) -> "DeepDanbooru":
        self.convs = {i: {k: t.to(device) for k, t in c.items()} for i, c in self.convs.items()}
        return self

    def _conv(self, i: int, x, stride: int = 1, pad=None):
        if pad is not None:       # (top, bottom, left, right)
            x = F.pad(x, (pad[2], pad[3], pad[0], pad[1]))
        c = self.convs[str(i)]
        return F.conv2d(x, c["weight"], c.get("bias"), stride)

    def _triplet(self, i: int, x, stride: int):
        h = F.relu(self._conv(i, x))
        h = F.relu(self._conv(i + 1, h, stride, (0, 1, 0, 1) if stride == 2 else (1, 1, 1, 1)))
        return self._conv(i + 2, h)

    def __call__(self, x):
        """x (B, 3, H, W) in [0, 1] → (B, tags) sigmoid scores."""
        h = F.relu(self._conv(0, x, 2, (2, 3, 2, 3)))
        h = F.max_pool2d(F.pad(h, (0, 1, 0, 1), value=float("-inf")), 3, 2)
        i = 1
        for item in self.plan:
            if item[0] == "stage":
                _, n, _mid, _out, stride = item
                sc = self._conv(i, h, stride)
                h = F.relu(self._triplet(i + 1, h, stride) + sc)
                i += 4
                n -= 1
            elif item[0] == "mid_down":
                stride = item[3]
                body = self._triplet(i, h, stride)
                h = F.relu(body + self._conv(i + 3, h, stride))
                i += 4
                n = 0
            else:
                n = item[1]
            for _ in range(n):
                h = F.relu(self._triplet(i, h, 1) + h)
                i += 3
        return torch.sigmoid(self._conv(i, h).mean(dim=(2, 3)))


def plan_convs(plan=PLAN, stem: int = 64, n_tags: int = 1):
    """[(index, in, out, kernel, bias)] of every conv of the net of `plan`,
    the stem `stem` wide, the bias-free head `n_tags` wide."""
    convs = [(0, 3, stem, 7, True)]
    i, c = 1, stem

    def triplet(i, cin, mid, out):
        return [(i, cin, mid, 1, True), (i + 1, mid, mid, 3, True), (i + 2, mid, out, 1, True)]

    for item in plan:
        if item[0] == "stage":
            _, n, mid, out, _ = item
            convs += [(i, c, out, 1, True)] + triplet(i + 1, c, mid, out)
            i += 4
            for _ in range(n - 1):
                convs += triplet(i, out, mid, out)
                i += 3
        elif item[0] == "mid_down":
            _, mid, out, _ = item
            convs += triplet(i, c, mid, out) + [(i + 3, c, out, 1, True)]
            i += 4
        else:
            _, n, mid, out = item
            for _ in range(n):
                convs += triplet(i, out, mid, out)
                i += 3
        c = out
    return convs + [(i, c, n_tags, 1, False)]


def random_state_dict(tags, seed: int = 0, plan=PLAN, stem: int = 64) -> dict:
    """A TorchDeepDanbooru state dict of random weights from `seed`
    (normal · 1/√fan-in, biases 0.05·normal) and `tags`."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for i, cin, cout, k, bias in plan_convs(plan, stem, len(tags)):
        sd[f"n_Conv_{i}.weight"] = torch.randn((cout, cin, k, k), generator=gen) \
            / float(np.sqrt(cin * k * k))
        if bias:
            sd[f"n_Conv_{i}.bias"] = torch.randn((cout,), generator=gen) * 0.05
    sd["tags"] = list(tags)
    return sd


def convert_deepbooru(sd: dict, plan=None, device="cpu") -> DeepDanbooru:
    """A TorchDeepDanbooru state dict (``n_Conv_N.weight`` OIHW, ``tags``)
    → the net, its expand widths and head index checked against the plan
    (and, for the published plan, the 7×7×3→64 stem)."""
    tags = list(sd.get("tags", []))
    convs: dict = {}
    for k, v in sd.items():
        if isinstance(k, str) and k.startswith("n_Conv_") and isinstance(v, torch.Tensor):
            idx, leaf = k[len("n_Conv_"):].split(".", 1)
            convs.setdefault(idx, {})[leaf] = v.to(get_device(device), torch.float32)
    n = 1 + max(int(i) for i in convs)
    if plan is None:
        assert tuple(convs["0"]["weight"].shape) == (64, 3, 7, 7), "unexpected stem"
    i = 1
    for item in (plan or PLAN):
        if item[0] == "stage":
            _, blocks, _mid, out, _ = item
            assert convs[str(i)]["weight"].shape[0] == out, (i, out)
            i += 4 + (blocks - 1) * 3
        elif item[0] == "mid_down":
            i += 4
        else:
            i += item[1] * 3
    assert str(i) in convs and i == n - 1, f"head at {i} != {n - 1}"
    return DeepDanbooru(convs, tags, tuple(plan or PLAN))


def load_deepbooru(path: str, device="cuda", plan=None) -> DeepDanbooru:
    """A TorchDeepDanbooru ``.pt`` / ``.pth`` → the net on `device`; the
    tags from the file, else from ``<stem>.tags.txt`` beside it."""
    obj = load_torch_object(path)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    net = convert_deepbooru(sd, plan, device)
    sidecar = os.path.splitext(path)[0] + ".tags.txt"
    if not net.tags and os.path.isfile(sidecar):
        with open(sidecar, encoding="utf-8") as f:
            net.tags = [line.strip() for line in f if line.strip()]
    return net


def deepbooru_from_jax(params: dict, tags, plan=None, device="cpu") -> DeepDanbooru:
    """The net from a JAX ``convert_deepbooru`` tree (HWIO convs)."""
    convs = {i: {k: torch.from_numpy(np.ascontiguousarray(
        np.asarray(v, np.float32).transpose(3, 2, 0, 1) if k == "weight" else
        np.asarray(v, np.float32))).to(get_device(device)) for k, v in c.items()}
        for i, c in params.items()}
    return DeepDanbooru(convs, list(tags), tuple(plan or PLAN))


@torch.inference_mode()
def scores(net: DeepDanbooru, image: np.ndarray) -> np.ndarray:
    """An image's tag scores: RGB, Lanczos-resized to 512², in [0, 1]."""
    img = images_util.resize(images_util.to_rgb(image), (512, 512), "lanczos")
    x = torch.from_numpy(np.ascontiguousarray(img.transpose(2, 0, 1))[None]).float() / 255.0
    return net(x.to(net.device))[0].float().cpu().numpy()


def tag_image(net: DeepDanbooru, image: np.ndarray, threshold: float = 0.5,
              alpha_sort: bool = False, use_spaces: bool = True, use_escape: bool = True,
              filter_tags: str = "", include_ranks: bool = False) -> str:
    """uint8 (H, W, C) → the comma-joined tags at or above `threshold`,
    rating tags and deepbooru_filter_tags left out, by score or
    alphabetically, with spaces, escaped brackets and "(tag:score)" as
    asked (deepbooru.py:140-168)."""
    probs = scores(net, image)
    tags = net.tags
    excluded = {t.strip().replace(" ", "_") for t in filter_tags.split(",") if t.strip()}
    picked = [(tags[i], float(probs[i])) for i in np.nonzero(probs >= threshold)[0]
              if i < len(tags) and not tags[i].startswith("rating:") and tags[i] not in excluded]
    picked.sort(key=lambda t: t[0] if alpha_sort else -t[1])
    out = []
    for name, prob in picked:
        if use_spaces:
            name = name.replace("_", " ")
        if use_escape:
            name = re.sub(r"([\\()])", r"\\\1", name)
        out.append(f"({name}:{prob:.3f})" if include_ranks else name)
    return ", ".join(out)
