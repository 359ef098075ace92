"""The JPEG 2000 wavelets as OpenJPEG computes them: the reversible 5/3
(integer lifting, ``opj_dwt_encode_1`` / ``opj_idwt53_h`` / ``opj_idwt53_v``;
the inverse in int32, as OpenJPEG's)
and the irreversible 9/7 inverse in float32 with OpenJPEG's constants and
order of operations (``opj_v8dwt_decode``: K and OpenJPEG's 2/K on the two
bands, then the four lifting steps, no fused multiply-add).

Any length and any parity of the first coordinate (``cas``: 1 when the
first sample sits on an odd coordinate of its resolution, so that it is a
high-pass sample) are handled; every function works along the last axis of
a 2-D array, a row at a time in numpy.  The 2-D inverse runs each level's
rows, then its columns; the forward 5/3 runs columns, then rows, as
OpenJPEG does."""

from __future__ import annotations

import numpy as np

_K = np.float32(1.230174105)
_TWO_INVK = np.float32(1.625732422)
_ALPHA = np.float32(-1.586134342)
_BETA = np.float32(-0.052980118)
_GAMMA = np.float32(0.882911075)
_DELTA = np.float32(0.443506852)


def _clamp(i, n):
    return np.clip(i, 0, n - 1)


def _trunc_half(x):
    """C's x / 2 on integers (toward zero)."""
    return np.where(x < 0, -((-x) >> 1), x >> 1)


def idwt53_1d(low: np.ndarray, high: np.ndarray, cas: int) -> np.ndarray:
    """(R, sn) low and (R, dn) high samples → (R, sn + dn) interleaved."""
    sn, dn = low.shape[1], high.shape[1]
    n = sn + dn
    out = np.empty((low.shape[0], n), np.int32)
    lo, hi = low.astype(np.int32), high.astype(np.int32)
    if cas == 0:
        if n > 1:
            i = np.arange(sn)
            lo = lo - ((hi[:, _clamp(i - 1, dn)] + hi[:, _clamp(i, dn)] + 2) >> 2)
            j = np.arange(dn)
            hi = hi + ((lo[:, _clamp(j, sn)] + lo[:, _clamp(j + 1, sn)]) >> 1)
        out[:, 0::2] = lo
        out[:, 1::2] = hi
    else:
        if n == 1:
            out[:, 0] = _trunc_half(hi[:, 0])
            return out
        i = np.arange(sn)
        lo = lo - ((hi[:, _clamp(i, dn)] + hi[:, _clamp(i + 1, dn)] + 2) >> 2)
        j = np.arange(dn)
        hi = hi + ((lo[:, _clamp(j, sn)] + lo[:, _clamp(j - 1, sn)]) >> 1)
        out[:, 1::2] = lo
        out[:, 0::2] = hi
    return out


def fdwt53_1d(x: np.ndarray, cas: int) -> tuple[np.ndarray, np.ndarray]:
    """(R, n) samples → (R, sn) low, (R, dn) high (``opj_dwt_encode_1``)."""
    n = x.shape[1]
    x = x.astype(np.int64)
    if cas == 0:
        lo, hi = x[:, 0::2], x[:, 1::2]
        sn, dn = lo.shape[1], hi.shape[1]
        if n > 1:
            j = np.arange(dn)
            hi = hi - ((lo[:, _clamp(j, sn)] + lo[:, _clamp(j + 1, sn)]) >> 1)
            i = np.arange(sn)
            lo = lo + ((hi[:, _clamp(i - 1, dn)] + hi[:, _clamp(i, dn)] + 2) >> 2)
        return lo, hi
    hi, lo = x[:, 0::2], x[:, 1::2]
    sn, dn = lo.shape[1], hi.shape[1]
    if n == 1:
        return lo, hi * 2
    j = np.arange(dn)
    hi = hi - ((lo[:, _clamp(j, sn)] + lo[:, _clamp(j - 1, sn)]) >> 1)
    i = np.arange(sn)
    lo = lo + ((hi[:, _clamp(i, dn)] + hi[:, _clamp(i + 1, dn)] + 2) >> 2)
    return lo, hi


def _step2(x, t0, count, m, c):
    """``opj_v8dwt_decode_step2``: x[t] += (x[t − 1] + x[t + 1])·c for the
    targets t = t0, t0 + 2, ... (the first's left neighbour mirrored), and
    x[t] += x[t − 1]·2c for a last target past `m`."""
    if count <= 0:
        return
    k = min(count, m)
    if k > 0:
        t = t0 + 2 * np.arange(k)
        left = np.where(t - 1 < 0, t + 1, t - 1)
        x[:, t] = x[:, t] + (x[:, left] + x[:, t + 1]) * c
    if m < count:
        t = t0 + 2 * m
        x[:, t] = x[:, t] + x[:, t - 1] * (c + c)


def idwt97_1d(low: np.ndarray, high: np.ndarray, cas: int) -> np.ndarray:
    """(R, sn), (R, dn) float32 → (R, sn + dn) float32, ``opj_v8dwt_decode``."""
    sn, dn = low.shape[1], high.shape[1]
    x = np.empty((low.shape[0], sn + dn), np.float32)
    a, b = (0, 1) if cas == 0 else (1, 0)
    x[:, a::2] = low
    x[:, b::2] = high
    if cas == 0 and not (dn > 0 or sn > 1):
        return x
    if cas == 1 and not (sn > 0 or dn > 1):
        return x
    x[:, a::2] *= _K
    x[:, b::2] *= _TWO_INVK
    _step2(x, a, sn, min(sn, dn - a), -_DELTA)
    _step2(x, b, dn, min(dn, sn - b), -_GAMMA)
    _step2(x, a, sn, min(sn, dn - a), -_BETA)
    _step2(x, b, dn, min(dn, sn - b), -_ALPHA)
    return x


def inverse(ll: np.ndarray, levels: list, reversible: bool) -> np.ndarray:
    """Rebuild a tile-component from its LL band and, per level from the
    coarsest, ``(hl, lh, hh, cas_x, cas_y)``."""
    one = idwt53_1d if reversible else idwt97_1d
    a = ll
    for hl, lh, hh, cas_x, cas_y in levels:
        top = one(a, hl, cas_x) if a.shape[0] else np.zeros((0, a.shape[1] + hl.shape[1]))
        bottom = one(lh, hh, cas_x) if lh.shape[0] else \
            np.zeros((0, lh.shape[1] + hh.shape[1]))
        w = top.shape[1] if top.shape[0] else bottom.shape[1]
        if w == 0:
            a = np.zeros((top.shape[0] + bottom.shape[0], 0), top.dtype)
            continue
        a = one(top.reshape(-1, w).T if top.shape[0] else np.zeros((w, 0), top.dtype),
                bottom.T if bottom.shape[0] else np.zeros((w, 0), top.dtype), cas_y).T
    return a


def forward53(x: np.ndarray, res: list) -> tuple[np.ndarray, list]:
    """The forward 5/3 over the resolutions `res` (finest first, each
    ``(cas_x, cas_y)``): the LL band and, finest first, ``(hl, lh, hh)``."""
    bands = []
    a = x.astype(np.int64)
    for cas_x, cas_y in res:
        if a.shape[0] and a.shape[1]:
            lo, hi = fdwt53_1d(a.T, cas_y)
            top, bottom = lo.T, hi.T
        else:
            sn = (a.shape[0] + (1 - cas_y)) // 2
            top, bottom = a[:sn], a[sn:]
        if top.shape[0] and top.shape[1]:
            ll, hl = fdwt53_1d(top, cas_x)
        else:
            sn = (top.shape[1] + (1 - cas_x)) // 2
            ll, hl = top[:, :sn], top[:, sn:]
        if bottom.shape[0] and bottom.shape[1]:
            lh, hh = fdwt53_1d(bottom, cas_x)
        else:
            sn = (bottom.shape[1] + (1 - cas_x)) // 2
            lh, hh = bottom[:, :sn], bottom[:, sn:]
        bands.append((hl, lh, hh))
        a = ll
    return a, bands
