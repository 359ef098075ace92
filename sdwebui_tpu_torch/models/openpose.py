"""OpenPose body estimator: the ``openpose`` ControlNet annotator.

Port of ``sdwebui_tpu/models/openpose.py``: the CMU two-branch body-pose
CNN (Cao et al., CVPR 2017) in the layout of the extension's
``body_pose_model.pth`` (flat layer-name keys, ``conv1_1.weight`` …
``Mconv7_stage6_L2.bias``), NCHW, fp32 on the caller's device.

  backbone    VGG19 conv1_1..conv4_2 + conv4_3_CPM, conv4_4_CPM: 128
              channels at stride 8
  stage 1     two 5-conv branches: L1 → 38-channel part-affinity fields,
              L2 → 19-channel joint heatmaps (18 joints + background)
  stages 2-6  both branches again over concat(PAF, heatmap, features)
              with 7×7 convs

The host post-processing is the JAX package's numpy (copied): peaks of
the σ = 3 gaussian-smoothed heatmaps (scipy), limbs by PAF line integrals,
greedy person assembly.  Where JAX calls cv2 the port calls ``utils/cv``'s
restatements: the uint8 INTER_CUBIC input resize by fx = fy (OpenCV maps
through 1/fx there, not through w/dw), the float32 INTER_CUBIC heatmap
resizes, and for the drawing ``ellipse2Poly``, ``fillConvexPoly`` and the
filled ``circle``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sdwebui_tpu_torch.models.layers import Conv2d, reset_random
from sdwebui_tpu_torch.utils import cv

N_JOINTS = 18        # + the background channel of the heatmap
STRIDE = 8
BOXSIZE = 368
PAD_VALUE = 128
THRE1 = 0.1          # heatmap peak threshold
THRE2 = 0.05         # PAF midpoint score threshold

# limb k joins joints LIMB_SEQ[k] (1-based, the CMU convention); its PAF
# channels are MAP_IDX[k] (x, y) less 19
LIMB_SEQ = [
    [2, 3], [2, 6], [3, 4], [4, 5], [6, 7], [7, 8], [2, 9], [9, 10],
    [10, 11], [2, 12], [12, 13], [13, 14], [2, 1], [1, 15], [15, 17],
    [1, 16], [16, 18], [3, 17], [6, 18],
]
MAP_IDX = [
    [31, 32], [39, 40], [33, 34], [35, 36], [41, 42], [43, 44], [19, 20],
    [21, 22], [23, 24], [25, 26], [27, 28], [29, 30], [47, 48], [49, 50],
    [53, 54], [51, 52], [55, 56], [37, 38], [45, 46],
]
COLORS = [
    [255, 0, 0], [255, 85, 0], [255, 170, 0], [255, 255, 0], [170, 255, 0],
    [85, 255, 0], [0, 255, 0], [0, 255, 85], [0, 255, 170], [0, 255, 255],
    [0, 170, 255], [0, 85, 255], [0, 0, 255], [85, 0, 255], [170, 0, 255],
    [255, 0, 255], [255, 0, 170], [255, 0, 85],
]

# (name, cin, cout, kernel) of the backbone in order; "pool": a 2×2/2 max pool
_BACKBONE = [
    ("conv1_1", 3, 64, 3), ("conv1_2", 64, 64, 3), "pool",
    ("conv2_1", 64, 128, 3), ("conv2_2", 128, 128, 3), "pool",
    ("conv3_1", 128, 256, 3), ("conv3_2", 256, 256, 3), ("conv3_3", 256, 256, 3),
    ("conv3_4", 256, 256, 3), "pool",
    ("conv4_1", 256, 512, 3), ("conv4_2", 512, 512, 3),
    ("conv4_3_CPM", 512, 256, 3), ("conv4_4_CPM", 256, 128, 3),
]
_OUT = {1: 38, 2: 19}


def _stage_layers(stage: int, branch: int):
    """(name, cin, cout, kernel, relu) of one stage's branch."""
    out = _OUT[branch]
    if stage == 1:
        return ([(f"conv5_{i}_CPM_L{branch}", 128, 128, 3, True) for i in range(1, 4)]
                + [(f"conv5_4_CPM_L{branch}", 128, 512, 1, True),
                   (f"conv5_5_CPM_L{branch}", 512, out, 1, False)])
    cin = 38 + 19 + 128
    return ([(f"Mconv1_stage{stage}_L{branch}", cin, 128, 7, True)]
            + [(f"Mconv{i}_stage{stage}_L{branch}", 128, 128, 7, True) for i in range(2, 6)]
            + [(f"Mconv6_stage{stage}_L{branch}", 128, 128, 1, True),
               (f"Mconv7_stage{stage}_L{branch}", 128, out, 1, False)])


class BodyPoseNet(nn.Module):
    """The body net; parameter names are the checkpoint's (no prefix)."""

    def __init__(self, *, device, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        convs = {}
        for layer in _BACKBONE:
            if layer != "pool":
                name, cin, cout, k = layer
                convs[name] = Conv2d(cin, cout, k, **kw)
        for stage in range(1, 7):
            for branch in (1, 2):
                for name, cin, cout, k, _ in _stage_layers(stage, branch):
                    convs[name] = Conv2d(cin, cout, k, **kw)
        self.convs = nn.ModuleDict(convs)

    def forward(self, x):
        """x: (N, 3, H, W) BGR in [-0.5, 0.5) (im/256 − 0.5), H and W
        divisible by 8 → (paf (N, 38, H/8, W/8), heatmap (N, 19, H/8, W/8))."""
        h = x
        for layer in _BACKBONE:
            h = F.max_pool2d(h, 2, 2) if layer == "pool" else F.relu(self.convs[layer[0]](h))
        feat = h

        def branch(stage, b, inp):
            for name, _, _, _, relu in _stage_layers(stage, b):
                inp = self.convs[name](inp)
                inp = F.relu(inp) if relu else inp
            return inp

        paf, heat = branch(1, 1, feat), branch(1, 2, feat)
        for stage in range(2, 7):
            inp = torch.cat([paf, heat, feat], dim=1)
            paf, heat = branch(stage, 1, inp), branch(stage, 2, inp)
        return paf, heat


def convert_openpose(sd: dict) -> dict:
    """A ``body_pose_model.pth`` state dict (flat layer names, or with a
    ``modelX.`` module prefix as the extension's modules hold them) → the
    port's ``convs.<name>.<leaf>`` names (openpose.py:106-122)."""
    out = {}
    for k, v in sd.items():
        parts = k.split(".")
        if parts[0].startswith("model") and len(parts) == 3:
            parts = parts[1:]
        name, leaf = parts
        out[f"convs.{name}.{leaf}"] = torch.as_tensor(v)
    return out


def openpose_from_state_dict(sd: dict, device) -> BodyPoseNet:
    from sdwebui_tpu_torch.models.layers import assign_f32

    return assign_f32(BodyPoseNet(device="meta"), convert_openpose(sd), device).eval()


def openpose_from_jax(params: dict, device="cpu") -> BodyPoseNet:
    """The port's net from a JAX ``convert_openpose`` tree ({layer:
    {"weight" HWIO, "bias"}})."""
    sd = {}
    for name, leaves in params.items():
        sd[f"{name}.weight"] = np.asarray(leaves["weight"], np.float32).transpose(3, 2, 0, 1)
        sd[f"{name}.bias"] = np.asarray(leaves["bias"], np.float32)
    return openpose_from_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                                     for k, v in sd.items()}, device)


def create_random_openpose(seed: int = 0, device="cpu") -> BodyPoseNet:
    """The body net at the published widths, weights from `seed`
    (normal·1/√fan_in, zero biases)."""
    from sdwebui_tpu_torch.utils.devices import get_device

    device = get_device(device)
    net = BodyPoseNet(device=device)
    with torch.no_grad():
        reset_random(net, torch.Generator(device=device).manual_seed(seed))
    return net.eval()


def body_pose_state_dict(net: BodyPoseNet) -> dict:
    """The net's tensors under ``body_pose_model.pth``'s flat names."""
    return {k.split(".", 1)[1]: v for k, v in net.state_dict().items()}


# --------------------------------------------------------------------------
# host-side decoding (openpose.py:129-254, numpy and scipy)
# --------------------------------------------------------------------------

def _pad_right_down(img: np.ndarray, stride: int, value: int):
    h, w = img.shape[:2]
    pad_d = (stride - h % stride) % stride
    pad_r = (stride - w % stride) % stride
    out = np.pad(img, ((0, pad_d), (0, pad_r), (0, 0)), mode="constant",
                 constant_values=value)
    return out, (pad_d, pad_r)


def _find_peaks(heatmap: np.ndarray):
    """Per-joint local maxima of the σ = 3 gaussian-smoothed map above
    THRE1: per joint a list of (x, y, score, global id)."""
    from scipy.ndimage import gaussian_filter

    all_peaks = []
    peak_id = 0
    for part in range(N_JOINTS):
        map_ori = heatmap[:, :, part]
        smoothed = gaussian_filter(map_ori, sigma=3)
        m = np.zeros_like(smoothed, dtype=bool)
        m[1:-1, 1:-1] = (
            (smoothed[1:-1, 1:-1] >= smoothed[:-2, 1:-1])
            & (smoothed[1:-1, 1:-1] >= smoothed[2:, 1:-1])
            & (smoothed[1:-1, 1:-1] >= smoothed[1:-1, :-2])
            & (smoothed[1:-1, 1:-1] >= smoothed[1:-1, 2:])
            & (smoothed[1:-1, 1:-1] > THRE1))
        ys, xs = np.nonzero(m)
        peaks = [(int(x), int(y), float(map_ori[y, x]), peak_id + i)
                 for i, (x, y) in enumerate(zip(xs, ys))]
        peak_id += len(peaks)
        all_peaks.append(peaks)
    return all_peaks


def _match_limbs(paf: np.ndarray, all_peaks, img_h: int):
    """PAF line-integral scores and greedy unique matching per limb type."""
    connection_all = []
    special_k = []
    for k in range(len(MAP_IDX)):
        score_mid = paf[:, :, [i - 19 for i in MAP_IDX[k]]]
        cand_a = all_peaks[LIMB_SEQ[k][0] - 1]
        cand_b = all_peaks[LIMB_SEQ[k][1] - 1]
        if not cand_a or not cand_b:
            special_k.append(k)
            connection_all.append([])
            continue
        candidates = []
        for i, a in enumerate(cand_a):
            for j, b in enumerate(cand_b):
                vec = np.array([b[0] - a[0], b[1] - a[1]], np.float64)
                norm = max(math.hypot(*vec), 1e-8)
                vec = vec / norm
                xs = np.linspace(a[0], b[0], num=10)
                ys = np.linspace(a[1], b[1], num=10)
                mids = np.array([score_mid[int(round(y)), int(round(x))]
                                 for x, y in zip(xs, ys)])
                scores = mids[:, 0] * vec[0] + mids[:, 1] * vec[1]
                prior = min(0.5 * img_h / norm - 1, 0)
                score = float(scores.mean()) + prior
                if (scores > THRE2).sum() > 0.8 * len(scores) and score > 0:
                    candidates.append((i, j, score, a[3], b[3]))
        candidates.sort(key=lambda c: c[2], reverse=True)
        connection = []
        used_a, used_b = set(), set()
        for i, j, score, ida, idb in candidates:
            if i not in used_a and j not in used_b:
                connection.append([ida, idb, score, i, j])
                used_a.add(i)
                used_b.add(j)
                if len(connection) >= min(len(cand_a), len(cand_b)):
                    break
        connection_all.append(np.array(connection).reshape(-1, 5))
    return connection_all, special_k


def _assemble(all_peaks, connection_all, special_k):
    """Greedy person assembly over the limb connections; subset rows: 18
    candidate ids (-1 absent), [18] score, [19] parts."""
    candidate = np.array([p for peaks in all_peaks for p in peaks], np.float64).reshape(-1, 4)
    subset = np.empty((0, 20))
    for k in range(len(MAP_IDX)):
        if k in special_k or len(connection_all[k]) == 0:
            continue
        part_as = connection_all[k][:, 0]
        part_bs = connection_all[k][:, 1]
        idx_a, idx_b = np.array(LIMB_SEQ[k]) - 1
        for i in range(len(connection_all[k])):
            found = []
            for j in range(len(subset)):
                if subset[j][idx_a] == part_as[i] or subset[j][idx_b] == part_bs[i]:
                    found.append(j)
            if len(found) == 1:
                j = found[0]
                if subset[j][idx_b] != part_bs[i]:
                    subset[j][idx_b] = part_bs[i]
                    subset[j][-1] += 1
                    subset[j][-2] += candidate[int(part_bs[i]), 2] + connection_all[k][i][2]
            elif len(found) == 2:
                j1, j2 = found
                membership = ((subset[j1] >= 0).astype(int)
                              + (subset[j2] >= 0).astype(int))[:-2]
                if (membership == 2).sum() == 0:   # disjoint: merge
                    subset[j1][:-2] += subset[j2][:-2] + 1
                    subset[j1][-2:] += subset[j2][-2:]
                    subset[j1][-2] += connection_all[k][i][2]
                    subset = np.delete(subset, j2, 0)
                else:
                    subset[j1][idx_b] = part_bs[i]
                    subset[j1][-1] += 1
                    subset[j1][-2] += candidate[int(part_bs[i]), 2] + connection_all[k][i][2]
            elif k < 17:
                row = -1 * np.ones(20)
                row[idx_a] = part_as[i]
                row[idx_b] = part_bs[i]
                row[-1] = 2
                row[-2] = (candidate[connection_all[k][i, :2].astype(int), 2].sum()
                           + connection_all[k][i][2])
                subset = np.vstack([subset, row])
    keep = [i for i in range(len(subset))
            if subset[i][-1] >= 4 and subset[i][-2] / subset[i][-1] >= 0.4]
    return candidate, subset[keep]


@torch.inference_mode()
def pose_maps(net: BodyPoseNet, image_rgb_u8: np.ndarray, scales=(0.5,)):
    """(heatmap (H, W, 19), paf (H, W, 38)) float64 at the image's size,
    averaged over `scales` (openpose.py:256-284)."""
    ori = np.ascontiguousarray(image_rgb_u8[:, :, ::-1])   # the net was trained on BGR
    h, w = ori.shape[:2]
    heat_avg = np.zeros((h, w, 19))
    paf_avg = np.zeros((h, w, 38))
    device = net.convs["conv1_1"].weight.device
    for s in scales:
        scale = s * BOXSIZE / h
        resized = cv.resize_by(ori, scale, scale, "cubic")
        padded, (pad_d, pad_r) = _pad_right_down(resized, STRIDE, PAD_VALUE)
        x = torch.from_numpy(np.ascontiguousarray(padded.transpose(2, 0, 1)))[None]
        x = x.to(device, torch.float32) / 256.0 - 0.5
        paf, heat = net(x)
        paf = paf[0].permute(1, 2, 0).float().cpu().numpy()
        heat = heat[0].permute(1, 2, 0).float().cpu().numpy()

        def up(m):
            m = cv.resize_by(np.ascontiguousarray(m), STRIDE, STRIDE, "cubic")
            m = m[:padded.shape[0] - pad_d, :padded.shape[1] - pad_r]
            return cv.resize(np.ascontiguousarray(m), (w, h), "cubic")

        heat_avg += up(heat) / len(scales)
        paf_avg += up(paf) / len(scales)
    return heat_avg, paf_avg


def estimate(net: BodyPoseNet, image_rgb_u8: np.ndarray, scales=(0.5,)) -> tuple:
    """uint8 RGB (H, W, 3) → (candidate (n, 4) [x, y, score, id], subset
    (people, 20)), coordinates in the input's pixels."""
    heat_avg, paf_avg = pose_maps(net, image_rgb_u8, scales)
    all_peaks = _find_peaks(heat_avg)
    connections, special_k = _match_limbs(paf_avg, all_peaks, image_rgb_u8.shape[0])
    return _assemble(all_peaks, connections, special_k)


def draw_bodypose(h: int, w: int, candidate: np.ndarray, subset: np.ndarray) -> np.ndarray:
    """The skeleton the control models expect (openpose.py:287-316): a
    4-px ellipse a limb of the first 17 types, the canvas × 0.6, a
    radius-4 disc a joint, on black."""
    canvas = np.zeros((h, w, 3), np.uint8)
    stickwidth = 4
    for k in range(17):
        for person in subset:
            idx = person[np.array(LIMB_SEQ[k]) - 1]
            if -1 in idx:
                continue
            ys = candidate[idx.astype(int), 1]
            xs = candidate[idx.astype(int), 0]
            m_x, m_y = xs.mean(), ys.mean()
            length = math.hypot(xs[0] - xs[1], ys[0] - ys[1])
            angle = math.degrees(math.atan2(ys[0] - ys[1], xs[0] - xs[1]))
            poly = cv.ellipse2poly((int(m_x), int(m_y)), (int(length / 2), stickwidth),
                                   int(angle), 0, 360, 1)
            cv.fill_convex_poly(canvas, poly, COLORS[k])
    canvas = (canvas * 0.6).astype(np.uint8)
    for i in range(N_JOINTS):
        for person in subset:
            idx = int(person[i])
            if idx == -1:
                continue
            x, y = candidate[idx][:2]
            cv.fill_circle(canvas, (int(x), int(y)), 4, COLORS[i])
    return canvas
