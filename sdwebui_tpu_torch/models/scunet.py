"""SCUNet blind denoiser (Swin-Conv-UNet, Zhang et al. 2022) — port of
``sdwebui_tpu/models/scunet.py``.

A UNet over conv-trans blocks: each block 1x1-projects, splits its channels
into a conv residual half and a Swin half (pre-norm window attention with
KAIR's dense (heads, 2w−1, 2w−1) relative bias, ``scunet.py:42-75``), and
1x1-merges back with a residual.  Three stride-2 downsamples (dim → 8·dim)
around the body, 2x transposed convs back up with additive skips.  The net
does not upscale: the webui runs it at 1x and Lanczos does the resizing
(``denoise_image``, registered with ``default_scale=1``).  The windows
ride one batched ``torch.matmul`` with fp32 scores; every LayerNorm goes
through B5 (widths dim/2 … 4·dim: 32, 64, 128 and 256 at dim 64).

Parameter names are KAIR's keys (``m_head.0``, ``m_down1.{i}``,
``m_body.{i}``, ``m_up3.0`` the transposed conv, …, ``m_tail.0``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sdwebui_tpu_torch.models.layers import Conv2d, LayerNorm, Linear, assign_f32
from sdwebui_tpu_torch.models.swinir import (device_const, nhwc_runner, randomize,
                                             shift_attn_mask, state_dict_from_jax,
                                             window_partition, window_reverse,
                                             windowed_softmax_av)
from sdwebui_tpu_torch.utils import images as images_util
from sdwebui_tpu_torch.utils.devices import get_device


@dataclasses.dataclass(frozen=True)
class SCUNetConfig:
    dim: int = 64
    config: tuple = (4, 4, 4, 4, 4, 4, 4)   # blocks per stage
    head_dim: int = 32
    window_size: int = 8
    in_nc: int = 3


def relative_offsets(window: int) -> tuple:
    """(di, dj): (w², w²) row and column indices into the dense bias grid
    (scunet.py:58-62)."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij")).reshape(2, -1)
    di = coords[0][:, None] - coords[0][None, :] + window - 1
    dj = coords[1][:, None] - coords[1][None, :] + window - 1
    return np.stack([di, dj])


class WMSA(nn.Module):
    def __init__(self, c: int, heads: int, window: int, kw: dict):
        super().__init__()
        self.heads = heads
        self.embedding_layer = Linear(c, 3 * c, **kw)
        self.linear = Linear(c, c, **kw)
        self.relative_position_params = nn.Parameter(
            torch.empty((heads, 2 * window - 1, 2 * window - 1), **kw), requires_grad=False)

    def forward(self, x, window: int, shift: int, mask):
        """x: (B, H, W, C) NHWC → the same."""
        b, hh, ww, c = x.shape
        h, d = self.heads, c // self.heads
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        wins = window_partition(x, window)                 # (B_, N, C)
        b_, n, _ = wins.shape
        qkv = self.embedding_layer(wins).reshape(b_, n, 3, h, d).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        sim = torch.matmul(q * (d ** -0.5), k.transpose(-1, -2))
        off = device_const(relative_offsets, window, device=x.device)
        sim = sim + self.relative_position_params[:, off[0], off[1]][None]
        out = self.linear(windowed_softmax_av(sim, v, mask if shift > 0 else None))
        x = window_reverse(out, window, b, hh, ww)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        return x


class TransBlock(nn.Module):
    """Pre-norm Swin block on NHWC maps (KAIR Block)."""

    def __init__(self, c: int, heads: int, window: int, kw: dict):
        super().__init__()
        self.ln1 = LayerNorm(c, **kw)
        self.msa = WMSA(c, heads, window, kw)
        self.ln2 = LayerNorm(c, **kw)
        self.mlp = nn.ModuleDict({"0": Linear(c, 4 * c, **kw), "2": Linear(4 * c, c, **kw)})

    def forward(self, x, window: int, shift: int, mask):
        x = x + self.msa(self.ln1(x), window, shift, mask)
        return x + self.mlp["2"](F.gelu(self.mlp["0"](self.ln2(x))))


class ConvTransBlock(nn.Module):
    """1x1 split → [conv residual | swin] → 1x1 merge + residual; NCHW in
    and out, the Swin half NHWC."""

    def __init__(self, dim: int, cfg: SCUNetConfig, kw: dict):
        super().__init__()
        half = dim // 2
        self.conv1_1 = Conv2d(dim, dim, 1, **kw)
        self.conv1_2 = Conv2d(dim, dim, 1, **kw)
        self.conv_block = nn.ModuleDict({"0": Conv2d(half, half, 3, bias=False, **kw),
                                         "2": Conv2d(half, half, 3, bias=False, **kw)})
        self.trans_block = TransBlock(half, half // cfg.head_dim, cfg.window_size, kw)

    def forward(self, x, window: int, shift: int, mask):
        y = self.conv1_1(x)
        half = y.shape[1] // 2
        conv_x, trans_x = y[:, :half], y[:, half:]
        conv_x = conv_x + self.conv_block["2"](F.relu(self.conv_block["0"](conv_x)))
        trans_x = self.trans_block(trans_x.permute(0, 2, 3, 1).contiguous(), window, shift, mask)
        return x + self.conv1_2(torch.cat([conv_x, trans_x.permute(0, 3, 1, 2)], 1))


class _Conv(nn.Module):
    """A bias-free conv under a Sequential index (``m_down1.4``), stride
    2 for the 2x2 downsamples."""

    def __init__(self, cin: int, cout: int, k: int, kw: dict):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((cout, cin, k, k), **kw), requires_grad=False)
        self.stride = 2 if k == 2 else 1

    def forward(self, x):
        return F.conv2d(x, self.weight, None, self.stride, 1 if self.stride == 1 else 0)


class _ConvT(nn.Module):
    """ConvTranspose2d(k=2, s=2), weight (Cin, Cout, 2, 2), no bias."""

    def __init__(self, cin: int, cout: int, kw: dict):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((cin, cout, 2, 2), **kw), requires_grad=False)

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight, None, 2)


class SCUNet(nn.Module):
    """forward: (B, H, W, in_nc) in [0, 1], H and W multiples of 64 → the
    denoised (B, H, W, in_nc) clipped to [0, 1]."""

    scale = 1
    pad_multiple = 64

    def __init__(self, cfg: SCUNetConfig, device="cpu", dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        d, n = cfg.dim, cfg.config
        self.m_head = nn.ModuleDict({"0": _Conv(cfg.in_nc, d, 3, kw)})

        def stage(dim, count, first=0):
            return {str(first + i): ConvTransBlock(dim, cfg, kw) for i in range(count)}

        self.m_down1 = nn.ModuleDict({**stage(d, n[0]), str(n[0]): _Conv(d, 2 * d, 2, kw)})
        self.m_down2 = nn.ModuleDict({**stage(2 * d, n[1]), str(n[1]): _Conv(2 * d, 4 * d, 2, kw)})
        self.m_down3 = nn.ModuleDict({**stage(4 * d, n[2]), str(n[2]): _Conv(4 * d, 8 * d, 2, kw)})
        self.m_body = nn.ModuleDict(stage(8 * d, n[3]))
        self.m_up3 = nn.ModuleDict({"0": _ConvT(8 * d, 4 * d, kw), **stage(4 * d, n[4], 1)})
        self.m_up2 = nn.ModuleDict({"0": _ConvT(4 * d, 2 * d, kw), **stage(2 * d, n[5], 1)})
        self.m_up1 = nn.ModuleDict({"0": _ConvT(2 * d, d, kw), **stage(d, n[6], 1)})
        self.m_tail = nn.ModuleDict({"0": _Conv(d, cfg.in_nc, 3, kw)})

    def _stage(self, blocks: nn.ModuleDict, x, idxs):
        """The conv-trans blocks at `idxs`, W and SW alternating."""
        win = self.cfg.window_size
        mask = device_const(shift_attn_mask, x.shape[2], x.shape[3], win, win // 2,
                            device=x.device)
        for n, i in enumerate(idxs):
            x = blocks[str(i)](x, win, 0 if n % 2 == 0 else win // 2, mask)
        return x

    def forward(self, x):
        b, h, w, _ = x.shape
        if h % 64 or w % 64:
            raise ValueError(f"input {h}x{w} is not a multiple of 64")
        n = self.cfg.config
        x1 = self.m_head["0"](x.permute(0, 3, 1, 2))
        x2 = self.m_down1[str(n[0])](self._stage(self.m_down1, x1, range(n[0])))
        x3 = self.m_down2[str(n[1])](self._stage(self.m_down2, x2, range(n[1])))
        x4 = self.m_down3[str(n[2])](self._stage(self.m_down3, x3, range(n[2])))
        y = self._stage(self.m_body, x4, range(n[3]))
        y = self._stage(self.m_up3, self.m_up3["0"](y + x4), range(1, n[4] + 1))
        y = self._stage(self.m_up2, self.m_up2["0"](y + x3), range(1, n[5] + 1))
        y = self._stage(self.m_up1, self.m_up1["0"](y + x2), range(1, n[6] + 1))
        y = self.m_tail["0"](y + x1)
        return torch.clamp(y.permute(0, 2, 3, 1), 0.0, 1.0)


# --------------------------------------------------------------------------
# loading
# --------------------------------------------------------------------------

def derive_scunet_config(sd: dict) -> SCUNetConfig:
    """The architecture from weight shapes (scunet.py:160-179)."""
    dim, in_nc = (int(n) for n in sd["m_head.0.weight"].shape[:2])

    def stage_blocks(prefix):
        return len({k.split(".")[1] for k in sd
                    if k.startswith(prefix) and k.endswith("conv1_1.weight")})

    config = tuple(stage_blocks(p) for p in ("m_down1.", "m_down2.", "m_down3.", "m_body.",
                                             "m_up3.", "m_up2.", "m_up1."))
    rp = sd["m_down1.0.trans_block.msa.relative_position_params"]
    heads = rp.shape[0] if rp.dim() == 3 else rp.shape[-1]
    window = (rp.shape[1] + 1) // 2 if rp.dim() == 3 else \
        (int(round(rp.shape[0] ** 0.5)) + 1) // 2
    return SCUNetConfig(dim=dim, config=config, head_dim=(dim // 2) // int(heads),
                        window_size=int(window), in_nc=in_nc)


def scunet_from_state_dict(sd: dict, device="cuda") -> SCUNet:
    """KAIR's state dict → the net in f32 on `device`; a flat
    ((2w−1)², heads) relative table is reshaped to (heads, 2w−1, 2w−1)
    (scunet.py:188-196)."""
    sd = {k: torch.as_tensor(v) for k, v in sd.items()}
    cfg = derive_scunet_config(sd)
    w = cfg.window_size
    for k, v in sd.items():
        if k.endswith("relative_position_params") and v.dim() == 2:
            sd[k] = v.reshape(2 * w - 1, 2 * w - 1, -1).permute(2, 0, 1).contiguous()
    return assign_f32(SCUNet(cfg, device="meta"), sd, get_device(device))


def scunet_from_jax(tree: dict, device="cpu") -> SCUNet:
    """The JAX package's SCUNet tree (``convert_scunet`` / ``init_params``)
    → the net (its transposed convs kept (Cin, Cout, 2, 2), as JAX keeps
    them)."""
    sd = state_dict_from_jax(tree)
    for k in [k for k in sd if k.startswith("m_up") and k.split(".")[1] == "0"]:
        sd[k] = sd[k].permute(2, 3, 1, 0).contiguous()      # undo the HWIO turn
    return scunet_from_state_dict(sd, device)


def create_random_scunet(seed: int = 0, device="cuda",
                         cfg: SCUNetConfig = SCUNetConfig()) -> SCUNet:
    """A seeded random SCUNet at `cfg` (default the release's: dim 64,
    4 blocks a stage, head_dim 32, window 8), f32: the head conv
    N(0, 1/fan-in), every later weight N(0, 0.25/fan-in), which keeps the
    residual stream from growing block by block (the transposed convs'
    fan-in 4·Cin)."""
    net = randomize(SCUNet(cfg, device=get_device(device)), seed)
    gen = torch.Generator(device=get_device(device)).manual_seed(seed + 1)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, (_Conv, _ConvT)):
                fan = m.weight[0].numel() if isinstance(m, _Conv) else 4 * m.weight.shape[0]
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen,
                                           device=m.weight.device) / fan ** 0.5)
            if isinstance(m, (Conv2d, Linear, _Conv, _ConvT)) and m is not net.m_head["0"]:
                m.weight.mul_(0.5)
    return net


# --------------------------------------------------------------------------
# tiled inference and the registry
# --------------------------------------------------------------------------

def denoise_image(net: SCUNet, image: np.ndarray, tile: int = 256,
                  overlap: int = 8) -> np.ndarray:
    """Tiled 1x denoise of an RGB uint8 (H, W, 3) image, every tile in one
    batched call, 64-multiple reflect pad (scunet.py:278-307; 256 / 8 as
    JAX fixes them)."""
    run_batch = nhwc_runner(net)
    img = images_util.to_rgb(image)

    def run(arr):
        h, w = arr.shape[1:3]
        ph, pw = (-h) % 64, (-w) % 64
        if ph or pw:
            arr = np.pad(arr, ((0, 0), (0, ph), (0, pw), (0, 0)), "reflect")
        return run_batch(arr)[:, :h, :w]

    if img.shape[1] <= tile and img.shape[0] <= tile:
        out = run(img.astype(np.float32)[None] / 255.0)[0]
        return (np.clip(out, 0, 1) * 255 + 0.5).astype(np.uint8)
    grid = images_util.split_grid(img, tile, tile, overlap)
    tiles = [t for _, _, row in grid.tiles for _, _, t in row]
    outs = (np.clip(run(np.stack([t.astype(np.float32) / 255.0 for t in tiles])), 0, 1)
            * 255 + 0.5).astype(np.uint8)
    i = 0
    for _, _, row in grid.tiles:
        for j, (xx, ww, _) in enumerate(row):
            row[j] = [xx, ww, outs[i]]
            i += 1
    return images_util.combine_grid(grid)


def register_scunet_dir(dirs=("models/ScuNET",), device="cuda") -> list:
    """Register every .pth / .pt / .safetensors file of `dirs` as a 1x
    denoising upscaler run on `device` (scunet.py:310): ``default_scale=1``,
    so ``upscalers.upscale`` resizes with Lanczos after it."""
    from sdwebui_tpu_torch.models.swinir import model_files, read_state_dict, register_lazy

    device = get_device(device)
    found = []
    for name, path in model_files(dirs):
        register_lazy(name, path, lambda p: scunet_from_state_dict(read_state_dict(p), device),
                      lambda net, image, scale: denoise_image(net, image), default_scale=1)
        found.append(name)
    return found
