"""RetinaFace face detector (ResNet50 + FPN + SSH), NCHW.

Port of ``sdwebui_tpu/models/retinaface.py`` (the public Pytorch_Retinaface
ResNet50 config that facexlib ships as ``detection_Resnet50_Final.pth``): a
torchvision ResNet50 trunk whose layer2/3/4 outputs feed a 3-level FPN at
256 channels, an SSH context module per level, and 2-anchor class, box and
5-landmark heads over anchors of min sizes [[16, 32], [64, 128], [256,
512]] at steps [8, 16, 32] (variances [0.1, 0.2]).  Parameter names are the
checkpoint's (``body.*``, ``fpn.*``, ``ssh{1,2,3}.*``, ``ClassHead.*``,
``BboxHead.*``, ``LandmarkHead.*``; a ``module.`` prefix is dropped).

BatchNorms run in inference form: the running statistics folded into one
scale and shift, as JAX folds them.  The SSH's LeakyReLU slope is 0.1 when
the module is at most 64 wide, else 0 (plain ReLU), as Pytorch_Retinaface
sets it from the module's width; JAX takes it from each conv's own width
(``retinaface.py:48-51``), which differs at full width only.  Priors, box
and landmark decoding and NMS are numpy, as in JAX.  The net runs in f32;
TF32 stays off (``utils/devices``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sdwebui_tpu_torch.models.layers import Conv2d, assign_f32, reset_random
from sdwebui_tpu_torch.utils.devices import get_device

MEAN_BGR = np.asarray([104.0, 117.0, 123.0], np.float32)
MIN_SIZES = ((16, 32), (64, 128), (256, 512))
STEPS = (8, 16, 32)
VARIANCES = (0.1, 0.2)
RESNET50_LAYERS = (3, 4, 6, 3)


class BatchNorm(nn.Module):
    """An inference BatchNorm: x · scale + shift from the running stats."""

    def __init__(self, c: int, eps: float = 1e-5, *, device, dtype):
        super().__init__()
        for name in ("weight", "bias", "running_mean", "running_var"):
            self.register_buffer(name, torch.empty(c, device=device, dtype=dtype))
        self.eps = eps

    def forward(self, x):
        scale = self.weight / torch.sqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        return x * scale[:, None, None] + shift[:, None, None]

    @torch.no_grad()
    def reset_random(self, gen):
        for buf, value in ((self.weight, 1.0), (self.bias, 0.0), (self.running_mean, 0.0),
                           (self.running_var, 1.0)):
            buf.fill_(value)


class ConvBN(nn.ModuleDict):
    """``conv_bn``: "0" the bias-free conv, "1" its BatchNorm."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, **kw):
        super().__init__({"0": Conv2d(cin, cout, k, stride, bias=False, **kw),
                          "1": BatchNorm(cout, **kw)})

    def forward(self, x, slope: float | None = None):
        """slope None: no activation; 0: ReLU; else LeakyReLU(slope)."""
        x = self["1"](self["0"](x))
        if slope is None:
            return x
        return F.relu(x) if slope == 0 else F.leaky_relu(x, slope)


class Bottleneck(nn.Module):
    """torchvision's bottleneck: 1x1, 3x3 (the stride), 1x1, each with a
    BatchNorm; the first of a layer carries the projection shortcut."""

    def __init__(self, cin: int, mid: int, cout: int, stride: int, downsample: bool, **kw):
        super().__init__()
        self.conv1, self.bn1 = Conv2d(cin, mid, 1, bias=False, **kw), BatchNorm(mid, **kw)
        self.conv2 = Conv2d(mid, mid, 3, stride, bias=False, **kw)
        self.bn2 = BatchNorm(mid, **kw)
        self.conv3, self.bn3 = Conv2d(mid, cout, 1, bias=False, **kw), BatchNorm(cout, **kw)
        self.downsample = ConvBN(cin, cout, 1, stride, **kw) if downsample else None

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        shortcut = self.downsample(x) if self.downsample is not None else x
        return F.relu(shortcut + out)


class SSH(nn.Module):
    def __init__(self, cin: int, cout: int, **kw):
        super().__init__()
        self.conv3X3 = ConvBN(cin, cout // 2, 3, **kw)
        self.conv5X5_1 = ConvBN(cin, cout // 4, 3, **kw)
        self.conv5X5_2 = ConvBN(cout // 4, cout // 4, 3, **kw)
        self.conv7X7_2 = ConvBN(cout // 4, cout // 4, 3, **kw)
        self.conv7x7_3 = ConvBN(cout // 4, cout // 4, 3, **kw)
        self.slope = 0.1 if cout <= 64 else 0.0

    def forward(self, x):
        c5_1 = self.conv5X5_1(x, self.slope)
        c7_2 = self.conv7X7_2(c5_1, self.slope)
        return F.relu(torch.cat([self.conv3X3(x), self.conv5X5_2(c5_1),
                                 self.conv7x7_3(c7_2)], dim=1))


class _Head(nn.Module):
    def __init__(self, cin: int, cout: int, **kw):
        super().__init__()
        self.conv1x1 = Conv2d(cin, cout, 1, **kw)


class RetinaFace(nn.Module):
    """width_mult scales every channel count (1.0: the published net; the
    tests use 0.25), as JAX's ``init_params`` does."""

    def __init__(self, width_mult: float = 1.0, *, device="cpu", dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)

        def ch(c):
            return max(int(c * width_mult), 4)

        body = nn.Module()
        body.conv1, body.bn1 = Conv2d(3, ch(64), 7, 2, bias=False, **kw), BatchNorm(ch(64), **kw)
        cin = ch(64)
        for li, (n, mid) in enumerate(zip(RESNET50_LAYERS, (64, 128, 256, 512)), start=1):
            cout = ch(mid * 4)
            setattr(body, f"layer{li}", nn.ModuleList(
                Bottleneck(cin if b == 0 else cout, ch(mid), cout,
                           2 if b == 0 and li > 1 else 1, b == 0, **kw) for b in range(n)))
            cin = cout
        self.body = body
        fc = ch(256)
        self.fpn = nn.ModuleDict({
            "output1": ConvBN(ch(512), fc, 1, **kw), "output2": ConvBN(ch(1024), fc, 1, **kw),
            "output3": ConvBN(ch(2048), fc, 1, **kw),
            "merge1": ConvBN(fc, fc, 3, **kw), "merge2": ConvBN(fc, fc, 3, **kw)})
        self.fpn_slope = 0.1 if fc <= 64 else 0.0
        self.ssh1, self.ssh2, self.ssh3 = (SSH(fc, fc, **kw) for _ in range(3))
        self.ClassHead = nn.ModuleList(_Head(fc, 2 * 2, **kw) for _ in range(3))
        self.BboxHead = nn.ModuleList(_Head(fc, 2 * 4, **kw) for _ in range(3))
        self.LandmarkHead = nn.ModuleList(_Head(fc, 2 * 10, **kw) for _ in range(3))

    def _taps(self, x):
        body = self.body
        x = F.relu(body.bn1(body.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        taps = []
        for li in range(1, 5):
            for block in getattr(body, f"layer{li}"):
                x = block(x)
            if li >= 2:
                taps.append(x)
        return taps

    def forward(self, images):
        """images (1, 3, H, W) RGB in [0, 255] → (loc (N, 4), conf (N, 2)
        softmaxed, landm (N, 10)): the heads over the anchor grid."""
        bgr = images.flip(1) - torch.as_tensor(MEAN_BGR, device=images.device)[:, None, None]
        f1, f2, f3 = self._taps(bgr)
        fpn, slope = self.fpn, self.fpn_slope
        out1, out2, out3 = (fpn[f"output{i}"](f, slope) for i, f in enumerate((f1, f2, f3), 1))
        out2 = out2 + F.interpolate(out3, size=out2.shape[2:], mode="nearest-exact")
        out2 = fpn["merge2"](out2, slope)
        out1 = out1 + F.interpolate(out2, size=out1.shape[2:], mode="nearest-exact")
        out1 = fpn["merge1"](out1, slope)
        feats = (self.ssh1(out1), self.ssh2(out2), self.ssh3(out3))

        def head(heads, n):
            return torch.cat([h.conv1x1(f).permute(0, 2, 3, 1).reshape(f.shape[0], -1, n)
                              for h, f in zip(heads, feats)], dim=1)[0]

        return (head(self.BboxHead, 4), torch.softmax(head(self.ClassHead, 2), dim=-1),
                head(self.LandmarkHead, 10))

    @torch.no_grad()
    def reset_random(self, gen: torch.Generator) -> "RetinaFace":
        reset_random(self, gen)
        for m in self.modules():
            if isinstance(m, BatchNorm):
                m.reset_random(gen)
        return self


# --------------------------------------------------------------------------
# anchors / decode / nms (numpy, retinaface.py:129-198)
# --------------------------------------------------------------------------

def priors(height: int, width: int) -> np.ndarray:
    """(N, 4) anchor boxes (cx, cy, w, h) normalised to [0, 1]."""
    out = []
    for sizes, step in zip(MIN_SIZES, STEPS):
        fh = int(np.ceil(height / step))
        fw = int(np.ceil(width / step))
        for i in range(fh):
            for j in range(fw):
                for m in sizes:
                    out.append([(j + 0.5) * step / width, (i + 0.5) * step / height,
                                m / width, m / height])
    return np.asarray(out, np.float32)


def decode_boxes(loc: np.ndarray, pri: np.ndarray) -> np.ndarray:
    """→ (N, 4) corner boxes, normalised."""
    cxcy = pri[:, :2] + loc[:, :2] * VARIANCES[0] * pri[:, 2:]
    wh = pri[:, 2:] * np.exp(loc[:, 2:] * VARIANCES[1])
    return np.concatenate([cxcy - wh / 2, cxcy + wh / 2], axis=1)


def decode_landms(landm: np.ndarray, pri: np.ndarray) -> np.ndarray:
    """→ (N, 5, 2) landmark points, normalised."""
    pts = landm.reshape(-1, 5, 2)
    return pri[:, None, :2] + pts * VARIANCES[0] * pri[:, None, 2:]


def nms(boxes: np.ndarray, scores: np.ndarray, thresh: float = 0.4) -> list:
    order = scores.argsort()[::-1]
    keep = []
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    while order.size:
        i = order[0]
        keep.append(int(i))
        if order.size == 1:
            break
        rest = order[1:]
        xx1 = np.maximum(boxes[i, 0], boxes[rest, 0])
        yy1 = np.maximum(boxes[i, 1], boxes[rest, 1])
        xx2 = np.minimum(boxes[i, 2], boxes[rest, 2])
        yy2 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.maximum(xx2 - xx1, 0) * np.maximum(yy2 - yy1, 0)
        iou = inter / (areas[i] + areas[rest] - inter + 1e-9)
        order = rest[iou <= thresh]
    return keep


@torch.inference_mode()
def detect_faces(net: RetinaFace, image, conf_threshold: float = 0.8,
                 nms_threshold: float = 0.4) -> list:
    """An RGB image (H, W, 3) → [((5, 2) landmarks, score, box)] in pixels,
    the contract ``postprocessing/faces`` consumes.  An image whose values
    are all <= 1 is scaled by 255 first, as JAX does (``:193``)."""
    arr = np.asarray(image, np.float32)
    if arr.max() <= 1.0:
        arr = arr * 255.0
    h, w = arr.shape[:2]
    device = net.body.conv1.weight.device
    x = torch.from_numpy(np.ascontiguousarray(arr.transpose(2, 0, 1)))[None].to(device)
    loc, conf, landm = (t.float().cpu().numpy() for t in net(x))
    pri = priors(h, w)
    scores = conf[:, 1]
    mask = scores > conf_threshold
    if not mask.any():
        return []
    boxes = decode_boxes(loc[mask], pri[mask]) * [w, h, w, h]
    pts = decode_landms(landm[mask], pri[mask]) * [w, h]
    scores = scores[mask]
    keep = nms(boxes, scores, nms_threshold)
    return [(pts[i], float(scores[i]), boxes[i]) for i in keep]


# --------------------------------------------------------------------------
# loading
# --------------------------------------------------------------------------

def _width_mult(sd: dict) -> float:
    return sd["body.conv1.weight"].shape[0] / 64


def retinaface_from_state_dict(sd: dict, device="cuda") -> RetinaFace:
    """facexlib's state dict (``module.`` prefix allowed; the BatchNorms'
    ``num_batches_tracked`` dropped) → the net on `device`, in f32."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()
          if not k.endswith("num_batches_tracked")}
    device = get_device(device)
    net = RetinaFace(_width_mult(sd), device="meta")
    return assign_f32(net, sd, device)


def load_retinaface(path: str, device="cuda") -> RetinaFace:
    from sdwebui_tpu_torch.loader.load import read_checkpoint

    return retinaface_from_state_dict(read_checkpoint(path), device)


def retinaface_from_jax(tree: dict, device="cpu") -> RetinaFace:
    """The JAX package's tree (conv HWIO) → the net."""
    from sdwebui_tpu_torch.utils.pytree import flatten

    sd = {}
    for k, v in flatten(tree).items():
        t = torch.from_numpy(np.array(v, np.float32))
        sd[k] = t.permute(3, 2, 0, 1) if t.dim() == 4 else t
    return retinaface_from_state_dict(sd, device)


def install_detector(path: str, device="cuda"):
    """Load the weights at `path` and make their net ``postprocessing/faces``'
    detector; returns it (image → list of (5, 2) landmarks)."""
    from sdwebui_tpu_torch.postprocessing import faces

    net = load_retinaface(path, device)

    def detector(image):
        return [lm for lm, _score, _box in detect_faces(net, image)]

    faces.set_face_detector(detector)
    return detector


def create_random_retinaface(seed: int = 0, device="cuda",
                             width_mult: float = 1.0) -> RetinaFace:
    """A seeded random net (conv weights N(0, 1/fan_in), BatchNorms at
    their identity statistics), f32."""
    device = get_device(device)
    net = RetinaFace(width_mult, device=device)
    return net.reset_random(torch.Generator(device=device).manual_seed(seed)).eval()
