"""Counter-based Philox4x32-10 gaussian RNG — the determinism anchor.

Copy of ``sdwebui_tpu/rng/philox.py``, pure numpy: the multithreaded C++
path of the JAX package (``sdwebui_tpu.native``) is not carried over.

Produces bit-identical output to ``torch.randn(..., device='cuda')`` for a
given seed (i.e. the reference's "NV" randn source, modules/rng_philox.py,
modules/rng.py:13 — behaviour replicated, implementation our own).

Being counter-based it is embarrassingly parallel: any (offset, index)
rectangle can be generated independently, so the entire noise schedule of a
sampling run (initial latent + every ancestral/SDE step) can be produced in
one vectorized call — ``randn_batch`` — and shipped to device as a single
``(steps, *shape)`` array instead of a host→device transfer per step.

Algorithm (public): J. K. Salmon et al., "Parallel random numbers: as easy
as 1, 2, 3" (SC'11).  Each 4x32 counter block is bumped through 10 rounds
of the Philox S-box; two of the four output words feed a Box–Muller
transform of which only the sine branch is kept — matching the layout CUDA's
curand normal generator uses (one normal per counter block, offset =
generation index).
"""

from __future__ import annotations

import numpy as np

_M0 = np.uint64(0xD2511F53)
_M1 = np.uint64(0xCD9E8D57)
_W0 = np.uint32(0x9E3779B9)
_W1 = np.uint32(0xBB67AE85)

# Box–Muller constants.  The reference stores these as float32 but numpy's
# uint32*float32 promotion computes the transform in float64 before the final
# float32 cast — replicate that exactly (bit-exactness is the whole point).
_INV32 = np.float64(np.float32(2.3283064e-10))                     # 2**-32
_INV32_HALF = np.float64(np.float32(2.3283064e-10) / np.float32(2))
_INV32_2PI = np.float64(np.float32(2.3283064e-10 * 6.2831855))
_INV32_2PI_HALF = np.float64(np.float32(2.3283064e-10 * 6.2831855) / np.float32(2))


def _philox10(c0, c1, c2, c3, k0, k1):
    """Run 10 Philox rounds on flat uint32 arrays. Returns (x0, x1)."""
    with np.errstate(over="ignore"):
        for r in range(10):
            p0 = c0.astype(np.uint64) * _M0
            p1 = c2.astype(np.uint64) * _M1
            hi0 = (p0 >> np.uint64(32)).astype(np.uint32)
            lo0 = p0.astype(np.uint32)
            hi1 = (p1 >> np.uint64(32)).astype(np.uint32)
            lo1 = p1.astype(np.uint32)
            c0 = hi1 ^ c1 ^ k0
            c1 = lo1
            c2 = hi0 ^ c3 ^ k1
            c3 = lo0
            if r != 9:
                k0 = k0 + _W0
                k1 = k1 + _W1
    return c0, c1


def _box_muller_sin(x0, x1):
    """First Box–Muller output (sine branch) from two uint32 words."""
    u = x0.astype(np.float64) * _INV32 + _INV32_HALF
    v = x1.astype(np.float64) * _INV32_2PI + _INV32_2PI_HALF
    return (np.sqrt(-2.0 * np.log(u)) * np.sin(v)).astype(np.float32)


def randn_at(seed: int, offsets: np.ndarray, n: int) -> np.ndarray:
    """Gaussian block for each offset in `offsets`: shape (len(offsets), n).

    Stateless core — offset o, lane i maps to counter (o, 0, i_lo, i_hi),
    key = seed. `n` may exceed 2**32 via the counter[3] spill (the reference
    caps at 2**32; we don't).
    """
    offsets = np.asarray(offsets, dtype=np.uint32).reshape(-1)
    m = offsets.shape[0]
    lanes = np.arange(n, dtype=np.uint64)
    c2 = np.broadcast_to(lanes.astype(np.uint32), (m, n)).reshape(-1)
    c3 = np.broadcast_to((lanes >> np.uint64(32)).astype(np.uint32), (m, n)).reshape(-1)
    c0 = np.repeat(offsets, n)
    c1 = np.zeros(m * n, dtype=np.uint32)
    seed64 = np.uint64(seed & 0xFFFFFFFFFFFFFFFF)
    k0 = np.full(m * n, np.uint32(seed64 & np.uint64(0xFFFFFFFF)), dtype=np.uint32)
    k1 = np.full(m * n, np.uint32(seed64 >> np.uint64(32)), dtype=np.uint32)
    x0, x1 = _philox10(c0, c1, c2, c3, k0, k1)
    return _box_muller_sin(x0, x1).reshape(m, n)


class PhiloxGenerator:
    """Stateful wrapper matching torch-CUDA generator semantics.

    Each ``randn`` call consumes one offset regardless of shape (curand
    semantics: offset is the generation counter, lane index the element).
    """

    def __init__(self, seed: int):
        self.seed = int(seed)
        self.offset = 0

    def randn(self, shape) -> np.ndarray:
        n = int(np.prod(shape)) if len(tuple(shape)) else 1
        out = randn_at(self.seed, np.array([self.offset]), n)
        self.offset += 1
        return out.reshape(shape)

    def randn_batch(self, count: int, shape) -> np.ndarray:
        """`count` consecutive draws in one vectorized call: (count, *shape).

        Equivalent to stacking `count` calls to :meth:`randn` — used to
        pre-generate every ancestral/SDE noise of a sampling run at once.
        """
        n = int(np.prod(shape)) if len(tuple(shape)) else 1
        offs = self.offset + np.arange(count, dtype=np.uint32)
        out = randn_at(self.seed, offs, n)
        self.offset += count
        return out.reshape((count, *shape))
