"""The on-card noise source: ``randn_source`` "TPU", "GPU" or "JAX".

Port of ``sdwebui_tpu/rng/philox_jax.py``: the same Philox4x32-10 counter
stream as the host "NV" source (``rng/philox.py``: counter (offset, 0,
lane, 0), key = the 64-bit seed's two words), generated on the model's
device.  The uint32 words are carried in int64 tensors with masks, and
the 32×32→64-bit products are built from 16-bit limbs, so no product
leaves int64's range: the same code runs on the CPU (the tests) and on the
card (service).  The Box–Muller sine branch is evaluated as the host path
evaluates it, in float64 rounded once to float32 (JAX's device source
uses float32, whose log and sin differ by 3 ulps between the card and the
CPU, and XLA's CPU sin by ~330 near π: ROADMAP C), so the card, the CPU
and the "NV" source give the same floats but where float64's libm and
CUDA's differ across a float32 rounding boundary.
"""

from __future__ import annotations

import numpy as np
import torch

_M0 = 0xD2511F53
_M1 = 0xCD9E8D57
_W0 = 0x9E3779B9
_W1 = 0xBB67AE85
_MASK16 = 0xFFFF
_MASK32 = 0xFFFFFFFF

# the host path's float32-rounded Box–Muller constants, used in float64
# (rng/philox.py:36-39)
_INV32 = float(np.float32(2.3283064e-10))
_INV32_HALF = float(np.float32(np.float32(2.3283064e-10) / np.float32(2)))
_INV32_2PI = float(np.float32(2.3283064e-10 * 6.2831855))
_INV32_2PI_HALF = float(np.float32(np.float32(2.3283064e-10 * 6.2831855) / np.float32(2)))


def _mulhilo(a, m: int):
    """(hi, lo) words of the 64-bit product of uint32 words `a` (int64
    tensor) and the constant `m`, from 16-bit limbs."""
    a_lo, a_hi = a & _MASK16, a >> 16
    m_lo, m_hi = m & _MASK16, m >> 16
    ll, hl, lh, hh = a_lo * m_lo, a_hi * m_lo, a_lo * m_hi, a_hi * m_hi
    cross = (ll >> 16) + (hl & _MASK16) + (lh & _MASK16)
    hi = (hh + (hl >> 16) + (lh >> 16) + (cross >> 16)) & _MASK32
    lo = ((cross << 16) | (ll & _MASK16)) & _MASK32
    return hi, lo


def philox10_words(c0, c1, c2, c3, k0, k1):
    """10 Philox rounds on uint32 words held in int64 tensors; the (x0, x1)
    output words (philox_jax.py:66-79)."""
    for r in range(10):
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        if r != 9:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
    return c0, c1


def randn_blocks(seed_words, offsets, n: int):
    """(…, n) float32 normals: block `offsets[...]` of the generators keyed
    by `seed_words[..., 0:2]` (int64 tensors that broadcast together), lanes
    0..n-1 in the reference's CHW order (philox_jax.py:88-106), the
    transform in float64 as the host's."""
    device = offsets.device
    lanes = torch.arange(n, dtype=torch.int64, device=device)
    c0 = offsets[..., None].expand(*offsets.shape, n)
    zeros = torch.zeros_like(c0)
    k0 = seed_words[..., 0, None].expand_as(c0)
    k1 = seed_words[..., 1, None].expand_as(c0)
    x0, x1 = philox10_words(c0, zeros, lanes.expand_as(c0), zeros, k0, k1)
    u = x0.to(torch.float64) * _INV32 + _INV32_HALF
    v = x1.to(torch.float64) * _INV32_2PI + _INV32_2PI_HALF
    return (torch.sqrt(-2.0 * torch.log(u)) * torch.sin(v)).to(torch.float32)


def _seed_words(seeds, device) -> torch.Tensor:
    words = [[(int(s) & 0xFFFFFFFFFFFFFFFF) & _MASK32, (int(s) & 0xFFFFFFFFFFFFFFFF) >> 32]
             for s in seeds]
    return torch.tensor(words, dtype=torch.int64, device=device)


def slerp(val: float, low, high):
    """The host ImageRNG's slerp on (B, C, H, W) tensors, image by image:
    normalised along each image's axis 1 (H, the reference's quirk), lerp
    when nearly colinear (philox_jax.py:200-220)."""
    low, high = low.float(), high.float()
    low_n = low / torch.linalg.vector_norm(low, dim=2, keepdim=True)
    high_n = high / torch.linalg.vector_norm(high, dim=2, keepdim=True)
    dot = (low_n * high_n).sum(2)                                  # (B, C, W)
    omega = torch.arccos(dot.clamp(-1.0, 1.0))
    so = torch.sin(omega)
    res = (torch.sin((1.0 - val) * omega) / so)[:, :, None] * low \
        + (torch.sin(val * omega) / so)[:, :, None] * high
    lerp = low * val + high * (1 - val)
    colinear = dot.mean(dim=(1, 2)) > 0.9995
    return torch.where(colinear[:, None, None, None], lerp, res)


class DevicePhiloxRNG:
    """The ImageRNG surface (``first``, ``next``, ``next_k``) for the device
    source, in NCHW on `device` (philox_jax.py:129-197): subseed slerp and
    eta_noise_seed_delta as the host streams; a seed resize takes the host
    path (``image_rng.create_rng``)."""

    def __init__(self, shape, seeds, device, subseeds=None, subseed_strength=0.0,
                 eta_noise_seed_delta=0):
        self.shape = tuple(int(x) for x in shape)     # (C, H, W)
        self.seeds = [int(s) for s in seeds]
        self.subseeds = [int(s) for s in subseeds] if subseeds is not None else None
        self.subseed_strength = float(subseed_strength)
        self.eta_noise_seed_delta = int(eta_noise_seed_delta or 0)
        self.device = torch.device(device)
        self.offsets = np.zeros(len(self.seeds), np.int64)
        self._seeds = _seed_words(self.seeds, self.device)
        self.is_first = True

    def _batch(self, seed_words, offsets0, count: int):
        """(count, B, C, H, W): draw i of image b at offset offsets0[b] + i."""
        offs = torch.as_tensor(offsets0, device=self.device)[None, :] + torch.arange(
            count, dtype=torch.int64, device=self.device)[:, None]
        c, h, w = self.shape
        out = randn_blocks(seed_words[None], offs, c * h * w)
        return out.reshape(count, len(offsets0), c, h, w)

    def _draw(self, count: int):
        out = self._batch(self._seeds, self.offsets, count)
        self.offsets = self.offsets + count
        return out

    def first(self):
        noise = self._draw(1)[0]
        if self.subseeds is not None and self.subseed_strength != 0:
            subs = [0 if i >= len(self.subseeds) else self.subseeds[i]
                    for i in range(len(self.seeds))]
            sub = self._batch(_seed_words(subs, self.device), np.zeros(len(subs), np.int64), 1)
            noise = slerp(self.subseed_strength, noise, sub[0])
        if self.eta_noise_seed_delta:
            self._seeds = _seed_words([s + self.eta_noise_seed_delta for s in self.seeds],
                                      self.device)
            self.offsets = np.zeros(len(self.seeds), np.int64)
        return noise

    def next(self):
        if self.is_first:
            self.is_first = False
            return self.first()
        return self._draw(1)[0]

    def next_k(self, k: int):
        if k == 0:
            c, h, w = self.shape
            return torch.zeros((0, len(self.seeds), c, h, w), device=self.device)
        if self.is_first:
            head = self.next()[None]
            return head if k == 1 else torch.cat([head, self.next_k(k - 1)], dim=0)
        return self._draw(k)
