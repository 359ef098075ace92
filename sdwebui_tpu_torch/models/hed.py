"""HED soft-edge net (ControlNetHED), NCHW: the ``hed`` / ``scribble_hed``
annotators.

Port of ``sdwebui_tpu/models/hed.py`` (Xie & Tu, ICCV 2015; the
sd-webui-controlnet extension's ``ControlNetHED.pth`` layout, keys
optionally under ``netNetwork.``):

  norm                 (1, 3, 1, 1) per-channel input shift
  block1..block5       VGG-style stacks of 2, 2, 3, 3, 3 3x3 convs + ReLU
                       (published widths 64, 128, 256, 512, 512; a 2x2 max
                       pool before blocks 2..5)
  blockN.projection    1x1 conv → one side edge map per scale

:func:`estimate` resizes the five side maps to the input size (bilinear,
as ``jax.image.resize``), averages them and applies a sigmoid;
:func:`safe_step` and :func:`nms` are the extension's post-passes, the
latter on the numpy restatements of ``utils/cv``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sdwebui_tpu_torch.models.layers import Conv2d
from sdwebui_tpu_torch.utils import cv

#: (convs per block) and the published widths
BLOCK_CONVS = (2, 2, 3, 3, 3)
WIDTHS = (64, 128, 256, 512, 512)


class HEDBlock(nn.Module):
    def __init__(self, cin: int, cout: int, n_convs: int, **kw):
        super().__init__()
        self.convs = nn.ModuleList(Conv2d(cin if i == 0 else cout, cout, 3, **kw)
                                   for i in range(n_convs))
        self.projection = Conv2d(cout, 1, 1, **kw)


class ControlNetHED(nn.Module):
    def __init__(self, widths: tuple = WIDTHS, *, device="cpu", dtype=torch.float32):
        super().__init__()
        self.widths = tuple(widths)
        self.norm = nn.Parameter(torch.zeros((1, 3, 1, 1), device=device, dtype=dtype),
                                 requires_grad=False)
        cin = 3
        for i, (w, n) in enumerate(zip(self.widths, BLOCK_CONVS), start=1):
            setattr(self, f"block{i}", HEDBlock(cin, w, n, device=device, dtype=dtype))
            cin = w

    def forward(self, x):
        """x (N, 3, H, W) float RGB in 0..255 → the five pre-sigmoid side
        maps, (N, 1, h_i, w_i) each."""
        h = x - self.norm
        sides = []
        for i in range(1, 6):
            block = getattr(self, f"block{i}")
            if i > 1:
                h = F.max_pool2d(h, 2, 2)
            for conv in block.convs:
                h = F.relu(conv(h))
            sides.append(block.projection(h))
        return sides


@torch.inference_mode()
def estimate(net: ControlNetHED, image_u8: np.ndarray) -> np.ndarray:
    """uint8 RGB (H, W, 3) → float32 edge map (H, W) in 0..1: the sigmoid
    of the mean of the five side maps resized to the input size
    (hed.py:81-93)."""
    h, w = image_u8.shape[:2]
    x = torch.from_numpy(np.ascontiguousarray(image_u8.transpose(2, 0, 1)))[None]
    x = x.to(net.norm.device, torch.float32)
    maps = [F.interpolate(s, size=(h, w), mode="bilinear", align_corners=False,
                          antialias=True) for s in net(x)]
    edge = torch.sigmoid(torch.stack(maps).mean(dim=0))
    return edge[0, 0].cpu().numpy()


def safe_step(x: np.ndarray, step: int = 2) -> np.ndarray:
    """The extension's quantising "safe" post-pass (annotator/util.py)."""
    y = x.astype(np.float32) * float(step + 1)
    return y.astype(np.int32).astype(np.float32) / float(step)


_NMS_KERNELS = [np.array(k, np.uint8) for k in (
    [[0, 0, 0], [1, 1, 1], [0, 0, 0]], [[0, 1, 0], [0, 1, 0], [0, 1, 0]],
    [[1, 0, 0], [0, 1, 0], [0, 0, 1]], [[0, 0, 1], [0, 1, 0], [1, 0, 0]])]


def nms(x: np.ndarray, threshold: float, sigma: float) -> np.ndarray:
    """Directional non-maximum suppression (hed.py:96-117): a float32
    Gaussian blur, pixels kept where they equal their max along any of
    four 3-pixel lines, binarised at `threshold` → uint8 (H, W)."""
    x = cv.gaussian_blur(x.astype(np.float32), sigma)
    y = np.zeros_like(x)
    for k in _NMS_KERNELS:
        np.putmask(y, cv.dilate(x, k) == x, x)
    z = np.zeros_like(y, dtype=np.uint8)
    z[y > threshold] = 255
    return z


def create_random_hed(seed: int = 0, device="cuda", widths: tuple = WIDTHS) -> ControlNetHED:
    """A random-weight net at `widths` (default: the published ones), fp32:
    the layers' HostInit distributions, the input shift 120 + N(0, 4²) per
    channel (near the mean pixel a trained net subtracts, so that the side
    maps are centred and the edge map is not saturated flat)."""
    from sdwebui_tpu_torch.models.layers import reset_random
    from sdwebui_tpu_torch.utils.devices import get_device

    device = get_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    net = ControlNetHED(widths, device=device)
    with torch.no_grad():
        reset_random(net, gen)
        net.norm.copy_(120.0 + torch.randn(net.norm.shape, generator=gen, device=device) * 4)
    return net
