"""The OpenCV operations of the ControlNet annotators, restated in numpy.

The JAX package's annotators call ``cv2``; the card's machine has no cv2,
so the port computes the same arrays itself.  Each function equals OpenCV's
output in every pixel, but where stated below (``tests/test_torch_annotators.py``
holds them to cv2 over grids of sizes, sigmas and scales).  cv2's 8-bit paths are fixed
point and its float paths round in a fixed order, so the restatements
follow the arithmetic and not only the formula:

- :func:`gaussian_blur` (``GaussianBlur(img, (0, 0), sigma)``, border
  reflect-101): the kernel of ``getGaussianKernelBitExact``.  uint8: ksize
  ``round(6σ + 1) | 1``, the kernel quantised to 8 fraction bits with
  error diffusion (the centre takes the rest of 256), a row pass into
  16-bit fixed point and a column pass into 32-bit, rounded off 16 bits.
  float32: ksize ``round(8σ + 1) | 1``, the row and column passes in
  float32 with OpenCV's order of operations: where its SIMD body uses
  fused multiply-adds (every element but a row's tail of fewer than 4,
  or a column pass's tail of fewer than 8) the restatement fuses them too
  (a float32 product is exact in float64, so float64 arithmetic rounded
  once to float32 is a fused multiply-add but for double rounding, which
  the tests find nowhere); at ksize 7 the image's last column still
  differs in a few pixels by one rounding;
- :func:`dilate` with a 3x3 structuring element (max over the element,
  pixels outside the image ignored);
- :func:`resize`: INTER_AREA on uint8 (the integer-scale fast path and the
  float area-weight path), INTER_LANCZOS4 on uint8 (coefficients
  quantised to ``INTER_RESIZE_COEF_SCALE`` 2048, integer passes,
  replicated border), INTER_CUBIC (a = -0.75) and INTER_LINEAR on
  float32.  The float32 modes restate OpenCV's own code, which is what
  cv2 runs without Intel IPP; a cv2 built with IPP (such as opencv-python 5.0.0)
  takes IPP's float resize instead, up to 3.3e-5 of the largest magnitude
  away (ROADMAP queue C);
- :func:`good_features_to_track`: ``goodFeaturesToTrack(gray,
  maxCorners, qualityLevel, minDistance)`` on uint8 (Shi–Tomasi: the
  3×3 Sobel derivatives in float32, scaled by 1/(4·3·255), the 3×3
  unnormalised box sums of their products in float64, the smaller
  eigenvalue in float32; the quality threshold, the 3×3 non-maximum
  dilation, interior pixels only, strongest first with ties to the later
  pixel, then the greedy minimum distance).  The Sobel row pass fuses its
  taps in cv2's vectorised body (32 elements a step) and not in the row's tail, as the build in
  this repository's test environment does;
- :func:`remap_linear`: ``remap(img, map_x, map_y, INTER_LINEAR)`` on
  uint8 with float maps, which OpenCV 5 interpolates in float32 (not on
  the 1/32 grid of its fixed-point tables), a constant 0 border.
"""

from __future__ import annotations

import math

import numpy as np

_RESIZE_COEF_BITS = 11          # INTER_RESIZE_COEF_BITS


# --------------------------------------------------------------------------
# Gaussian blur
# --------------------------------------------------------------------------

def gaussian_kernel(n: int, sigma: float) -> np.ndarray:
    """``getGaussianKernelBitExact(n, sigma)`` in float64 (odd n, sigma > 0):
    exp(-x²/(2σ²)) at x = i - (n-1)/2, normalised by one reciprocal of the
    sum, the centre 1 · that reciprocal."""
    scale2x = -0.125 / (sigma * sigma)          # x runs over 2·offset
    half = (n - 1) // 2
    vals = [math.exp(float(x * x) * scale2x) for x in range(1 - n, 0, 2)]
    mul = 1.0 / (2.0 * sum(vals) + 1.0)
    k = np.empty(n)
    for i, v in enumerate(vals):
        k[i] = k[n - 1 - i] = v * mul
    k[half] = mul
    return k


def _kernel_fixed(n: int, sigma: float, bits: int = 8) -> np.ndarray:
    """The kernel in `bits` fraction bits with error diffusion from the
    ends inwards (``getGaussianKernelFixedPoint_ED``); the centre takes
    what makes the sum exactly 2**bits."""
    k = gaussian_kernel(n, sigma)
    one = 1 << bits
    out = np.empty(n, np.int64)
    err, total = 0.0, 0
    for i in range(n // 2):
        adj = k[i] * one + err
        v = int(np.rint(adj))
        err = adj - v
        out[i] = out[n - 1 - i] = v
        total += v
    out[n // 2] = one - 2 * total
    return out


def _fma(a, b, c):
    """float32 a·b + c rounded once (the product is exact in float64)."""
    return (a.astype(np.float64) * np.float64(b) + c).astype(np.float32)


def _mad(a, b, c):
    """float32 c + a·b with two roundings."""
    return c + a * np.float32(b)



def _blur_f32(x: np.ndarray, sigma: float) -> np.ndarray:
    n = int(round(sigma * 8 + 1)) | 1
    k = gaussian_kernel(n, sigma).astype(np.float32)
    r = n // 2
    h, w = x.shape[:2]
    cn = x.shape[2] if x.ndim == 3 else 1
    wc = w * cn
    pad = np.pad(x.reshape(h, w, cn), ((r, r), (r, r), (0, 0)), mode="reflect")
    rows = pad.reshape(h + 2 * r, -1)
    col = lambda j: rows[:, j * cn: j * cn + wc]   # noqa: E731
    idx = np.arange(wc)
    if n <= 5:
        # SymmRowSmallFilter: centre-adjacent pair first, then the centre,
        # then the outer pair, each fused; an odd row's last element takes
        # the centre first (fused for ksize 3, unfused pair 1 for ksize 5)
        pair = lambda d: col(r + d) + col(r - d)   # noqa: E731
        s = pair(1) * k[r + 1]
        s = _fma(col(r), k[r], s)
        if n == 5:
            s = _fma(pair(2), k[r + 2], s)
        if wc % 2:
            t = col(r)[:, -1:] * k[r]
            if n == 3:
                t = _fma(pair(1)[:, -1:], k[r + 1], t)
            else:
                t = _fma(pair(2)[:, -1:], k[r + 2], _mad(pair(1)[:, -1:], k[r + 1], t))
            s[:, -1:] = t
    else:
        # RowFilter: the taps in order, fused but for a tail of < 4
        fused = idx < (wc // 4) * 4
        s = col(0) * k[0]
        for j in range(1, n):
            s = np.where(fused, _fma(col(j), k[j], s), _mad(col(j), k[j], s))
    # the symmetric column filter: centre, then each pair, fused but for a
    # tail of < 8 (ksize 3: all fused)
    fused = idx < (wc // 8) * 8 if n > 3 else np.ones(wc, bool)
    band = lambda d: s[r + d: r + d + h]            # noqa: E731
    out = band(0) * k[r]
    for d in range(1, r + 1):
        p = band(d) + band(-d)
        out = np.where(fused, _fma(p, k[r + d], out), _mad(p, k[r + d], out))
    return out.reshape(x.shape)


def _blur_u8(x: np.ndarray, sigma: float) -> np.ndarray:
    n = int(round(sigma * 6 + 1)) | 1
    k = _kernel_fixed(n, sigma)
    r = n // 2
    h, w = x.shape[:2]
    cn = x.shape[2] if x.ndim == 3 else 1
    pad = np.pad(x.reshape(h, w, cn).astype(np.int64), ((r, r), (r, r), (0, 0)),
                 mode="reflect")
    rows = sum(pad[:, j:j + w] * k[j] for j in range(n))       # 8 fraction bits
    cols = sum(rows[j:j + h] * k[j] for j in range(n))        # 16 fraction bits
    return ((cols + (1 << 15)) >> 16).astype(np.uint8).reshape(x.shape)


def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """``cv2.GaussianBlur(img, (0, 0), sigma)`` of a uint8 or float32
    (H, W) or (H, W, C) image."""
    if img.dtype == np.uint8:
        return _blur_u8(img, float(sigma))
    if img.dtype == np.float32:
        return _blur_f32(img, float(sigma))
    raise TypeError(f"gaussian_blur takes uint8 or float32, not {img.dtype}")


def dilate(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """``cv2.dilate(img, kernel)`` with a 3x3 0/1 kernel: the max over the
    element's pixels inside the image."""
    h, w = img.shape[:2]
    low = np.iinfo(img.dtype).min if img.dtype.kind in "ui" else -np.inf
    pad = np.pad(img, ((1, 1), (1, 1)) + ((0, 0),) * (img.ndim - 2), constant_values=low)
    out = np.full_like(img, low)
    for dy, dx in zip(*np.nonzero(kernel)):
        out = np.maximum(out, pad[dy:dy + h, dx:dx + w])
    return out


# --------------------------------------------------------------------------
# Shi-Tomasi corners
# --------------------------------------------------------------------------

_SOBEL_LANES = 32     # elements a step of cv2's vectorised Sobel row pass


def rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)`` of uint8 (H, W, 3): the
    weights 0.299, 0.587, 0.114 in 15-bit fixed point, rounded."""
    rgb = img.astype(np.int32)
    return ((rgb[..., 0] * 9798 + rgb[..., 1] * 19235 + rgb[..., 2] * 3735 + (1 << 14))
            >> 15).astype(np.uint8)


def _box3_sum(x: np.ndarray) -> np.ndarray:
    """``cv2.boxFilter(x, -1, (3, 3), normalize=False)`` of float32 (H, W),
    border reflect-101: row sums in float64, then the column sums as cv2
    keeps them, one running float64 sum down the padded rows (add the new
    row, write, subtract the oldest)."""
    q = np.pad(x.astype(np.float64), 1, mode="reflect")
    rows = q[:, :-2] + q[:, 1:-1] + q[:, 2:]
    out = np.empty(x.shape, np.float32)
    run = rows[0] + rows[1]
    for y in range(x.shape[0]):
        total = run + rows[y + 2]
        out[y] = total
        run = total - rows[y]
    return out


def corner_min_eigen_val(gray: np.ndarray) -> np.ndarray:
    """``cv2.cornerMinEigenVal(gray, 3, 3)`` of a uint8 (H, W) image (border
    reflect-101), float32."""
    h, w = gray.shape
    s = np.float32(1.0 / (4 * 3 * 255.0))
    p = np.pad(gray.astype(np.float32), 1, mode="reflect")
    r = p[:, 2:] - p[:, :-2]                   # d/dx row pass: exact
    dx = _fma(r[:-2] + r[2:], s, r[1:-1] * np.float32(2 * s))
    x0, x1, x2 = p[:, :-2], p[:, 1:-1], p[:, 2:]
    t = np.where(np.arange(w) < (w // _SOBEL_LANES) * _SOBEL_LANES,
                 _fma(x2, s, _fma(x1, 2 * s, x0 * s)),
                 (x0 * s + x1 * np.float32(2 * s)) + x2 * s)
    dy = t[2:] - t[:-2]
    sums = [_box3_sum(prod) for prod in (dx * dx, dx * dy, dy * dy)]
    a, b, c = sums[0] * np.float32(0.5), sums[1], sums[2] * np.float32(0.5)
    return (a + c) - np.sqrt((a - c) * (a - c) + b * b)


def good_features_to_track(gray: np.ndarray, max_corners: int, quality_level: float,
                           min_distance: float) -> np.ndarray | None:
    """``cv2.goodFeaturesToTrack(gray, maxCorners=max_corners,
    qualityLevel=quality_level, minDistance=min_distance)`` of a uint8
    (H, W) image: float32 (N, 1, 2) (x, y) corners, strongest first, or
    None when there are none."""
    eig = corner_min_eigen_val(gray)
    eig = np.where(eig > np.float32(float(eig.max()) * quality_level), eig, np.float32(0))
    peak = dilate(eig, np.ones((3, 3), np.uint8))
    h, w = eig.shape
    inner = np.zeros_like(eig, bool)
    inner[1:h - 1, 1:w - 1] = True
    ys, xs = np.nonzero(inner & (eig != 0) & (eig == peak))
    vals = eig[ys, xs]
    order = np.lexsort((-(ys * w + xs), -vals.astype(np.float64)))
    min_d2 = float(min_distance) ** 2
    picked: list = []
    for i in order:
        x, y = float(xs[i]), float(ys[i])
        if min_distance > 0 and any((x - px) ** 2 + (y - py) ** 2 < min_d2 for px, py in picked):
            continue
        picked.append((x, y))
        if max_corners > 0 and len(picked) == max_corners:
            break
    if not picked:
        return None
    return np.asarray(picked, np.float32).reshape(-1, 1, 2)


# --------------------------------------------------------------------------
# resize
# --------------------------------------------------------------------------

def _area_tab(ssize: int, dsize: int, scale: float):
    """``computeResizeAreaTab`` as passes: pass j holds, for every
    destination index with a j-th entry, (dst indices, src indices, float32
    weights); a destination index sums its entries in pass order."""
    entries = []
    for d in range(dsize):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, ssize - f1)
        s1, s2 = math.ceil(f1), math.floor(f2)
        s2 = min(s2, ssize - 1)
        s1 = min(s1, s2)
        mine = []
        if s1 - f1 > 1e-3:
            mine.append((s1 - 1, (s1 - f1) / cell))
        mine += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            mine.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        entries.append(mine)
    passes = []
    for j in range(max(len(e) for e in entries)):
        ds = [d for d, e in enumerate(entries) if len(e) > j]
        passes.append((np.array(ds), np.array([entries[d][j][0] for d in ds]),
                       np.array([entries[d][j][1] for d in ds], np.float32)))
    return passes


def _round_u8(v: np.ndarray) -> np.ndarray:
    """saturate_cast<uchar>(float): round half to even, clamp."""
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)


def _resize_area(img: np.ndarray, dw: int, dh: int) -> np.ndarray:
    h, w = img.shape[:2]
    sx, sy = 1.0 / (dw / w), 1.0 / (dh / h)
    ix, iy = int(round(sx)), int(round(sy))
    x = img.reshape(h, w, -1)
    if abs(sx - ix) < 2.220446049250313e-16 and abs(sy - iy) < 2.220446049250313e-16:
        blocks = x[:dh * iy, :dw * ix].astype(np.int64).reshape(dh, iy, dw, ix, -1)
        total = blocks.sum(axis=(1, 3))
        if ix == 2 and iy == 2:
            out = ((total + 2) >> 2).astype(np.uint8)
        else:
            out = _round_u8(total.astype(np.float32) * np.float32(1.0 / (ix * iy)))
        return out.reshape((dh, dw) + img.shape[2:])
    # rows: buf[dx] += S[sx]·α per entry; columns: sum = β·buf, then
    # sum += β·buf, unfused (ResizeArea_Invoker, WT = float)
    xf = x.astype(np.float32)
    buf = np.zeros((h, dw, x.shape[2]), np.float32)
    for ds, ss, alpha in _area_tab(w, dw, sx):
        buf[:, ds] = buf[:, ds] + xf[:, ss] * alpha[None, :, None]
    total = np.zeros((dh, dw, x.shape[2]), np.float32)
    for j, (ds, ss, beta) in enumerate(_area_tab(h, dh, sy)):
        term = beta[:, None, None] * buf[ss]
        total[ds] = term if j == 0 else total[ds] + term
    return _round_u8(total).reshape((dh, dw) + img.shape[2:])


def _lanczos4(x: np.float32) -> np.ndarray:
    """``interpolateLanczos4``: the 8 float coefficients at fraction x."""
    s45 = 0.70710678118654752440084436210485
    cs = ((1, 0), (-s45, -s45), (0, 1), (s45, -s45), (-1, 0), (s45, s45), (0, -1),
          (-s45, s45))
    y0 = -(float(x) + 3) * math.pi * 0.25
    s0, c0 = math.sin(y0), math.cos(y0)
    coeffs = np.empty(8, np.float32)
    total = np.float32(0)
    for i in range(8):
        y0_ = np.float32(np.float32(x) + np.float32(3 - i))
        if abs(y0_) >= np.float32(1e-6):
            y = -float(y0_) * math.pi * 0.25
            coeffs[i] = np.float32((cs[i][0] * s0 + cs[i][1] * c0) / (y * y))
        else:
            coeffs[i] = np.float32(1e30)
        total = np.float32(total + coeffs[i])
    return coeffs * (np.float32(1.0) / total)


def _cubic(x: np.float32) -> np.ndarray:
    """``interpolateCubic`` (a = -0.75) in float32."""
    a = np.float32(-0.75)
    x = np.float32(x)
    one = np.float32(1)
    c0 = ((a * (x + one) - np.float32(5) * a) * (x + one) + np.float32(8) * a) * (x + one) \
        - np.float32(4) * a
    c1 = ((a + np.float32(2)) * x - (a + np.float32(3))) * x * x + one
    c2 = ((a + np.float32(2)) * (one - x) - (a + np.float32(3))) * (one - x) * (one - x) + one
    return np.array([c0, c1, c2, one - c0 - c1 - c2], np.float32)


def _taps_coeffs(ssize: int, dsize: int, ksize: int, coeff_fn, inv_scale: float | None = None):
    """Source index of each tap and its coefficient, per destination index:
    fx = (d + 0.5)·scale - 0.5 in float32, the taps replicated at the
    border (cubic and Lanczos keep their fraction there); scale is
    1 / inv_scale, dsize / ssize unless given (``resize_by``'s fx)."""
    scale = 1.0 / (dsize / ssize if inv_scale is None else inv_scale)
    idx = np.empty((dsize, ksize), np.int64)
    coef = np.empty((dsize, ksize), np.float32)
    for d in range(dsize):
        fx = np.float32((d + 0.5) * scale - 0.5)
        sx = int(np.floor(fx))
        fx = np.float32(fx - np.float32(sx))
        idx[d] = np.clip(np.arange(sx - ksize // 2 + 1, sx + ksize // 2 + 1), 0, ssize - 1)
        coef[d] = coeff_fn(fx)
    return idx, coef


def _coef_fixed(c: np.ndarray) -> np.ndarray:
    """saturate_cast<short>(c · INTER_RESIZE_COEF_SCALE)."""
    return np.clip(np.rint(c.astype(np.float64) * (1 << _RESIZE_COEF_BITS)), -32768,
                   32767).astype(np.int64)


#: the lanes of VResizeCubicVec_32s8u's float loop (v_int16 of the build's
#: SIMD width): the row's last width·cn % 16 values take the integer path
_CUBIC_U8_LANES = 16


def _resize_cubic_u8(img: np.ndarray, dw: int, dh: int, fx=None, fy=None) -> np.ndarray:
    """INTER_CUBIC on uint8: coefficients quantised to 2048, the row pass in
    integers (HResizeCubic), the column pass as VResizeCubicVec_32s8u does
    it: the sums in float32 with the coefficients times 2⁻²², each product
    rounded and added from the last tap to the first (the baseline build's
    v_muladd), rounded half to even and saturated; the row's tail of < 16 values in integers rounded off 22
    bits (VResizeCubic, FixedPtCast)."""
    h, w = img.shape[:2]
    x = img.reshape(h, w, -1).astype(np.int64)
    xi, xc = _taps_coeffs(w, dw, 4, _cubic, fx)
    yi, yc = _taps_coeffs(h, dh, 4, _cubic, fy)
    qx, qy = _coef_fixed(xc), _coef_fixed(yc)
    rows = sum(x[:, xi[:, k]] * qx[None, :, k, None] for k in range(4))   # (h, dw, cn)
    rows = rows.reshape(h, -1)
    width = rows.shape[1]
    vec = width - width % _CUBIC_U8_LANES if width >= _CUBIC_U8_LANES else 0
    scale = np.float32(1.0 / (1 << (2 * _RESIZE_COEF_BITS)))
    b = (qy.astype(np.float32) * scale).astype(np.float32)          # (dh, 4)
    s = [rows[yi[:, k], :vec].astype(np.float32) for k in range(4)]
    acc = (s[3] * b[:, 3, None]).astype(np.float32)
    for k in (2, 1, 0):      # v_muladd of the baseline build: a product, then a sum
        acc = (s[k] * b[:, k, None]).astype(np.float32) + acc
    out = np.empty((dh, width), np.int64)
    out[:, :vec] = np.rint(acc).astype(np.int64)
    tail = sum(rows[yi[:, k], vec:] * qy[:, k, None] for k in range(4))
    out[:, vec:] = (tail + (1 << (2 * _RESIZE_COEF_BITS - 1))) >> (2 * _RESIZE_COEF_BITS)
    return np.clip(out, 0, 255).astype(np.uint8).reshape((dh, dw) + img.shape[2:])


def _resize_lanczos4_u8(img: np.ndarray, dw: int, dh: int) -> np.ndarray:
    h, w = img.shape[:2]
    x = img.reshape(h, w, -1).astype(np.int64)
    q = _coef_fixed
    xi, xc = _taps_coeffs(w, dw, 8, _lanczos4)
    yi, yc = _taps_coeffs(h, dh, 8, _lanczos4)
    rows = sum(x[:, xi[:, k]] * q(xc[:, k])[None, :, None] for k in range(8))
    cols = sum(rows[yi[:, k]] * q(yc[:, k])[:, None, None] for k in range(8))
    out = (cols + (1 << (2 * _RESIZE_COEF_BITS - 1))) >> (2 * _RESIZE_COEF_BITS)
    return np.clip(out, 0, 255).astype(np.uint8).reshape((dh, dw) + img.shape[2:])


def _resize_cubic_f32(img: np.ndarray, dw: int, dh: int, fx=None, fy=None) -> np.ndarray:
    """Rows: the four taps in order, unfused; columns: the taps last to
    first (VResizeCubicVec_32f), but for a tail of < 4 in order."""
    h, w = img.shape[:2]
    x = img.reshape(h, w, -1)
    xi, xc = _taps_coeffs(w, dw, 4, _cubic, fx)
    yi, yc = _taps_coeffs(h, dh, 4, _cubic, fy)
    rows = x[:, xi[:, 0]] * xc[None, :, 0, None]
    for k in range(1, 4):
        rows = rows + x[:, xi[:, k]] * xc[None, :, k, None]
    term = lambda k: rows[yi[:, k]] * yc[:, k, None, None]   # noqa: E731
    fwd = term(0) + term(1) + term(2) + term(3)
    rev = term(3) + term(2) + term(1) + term(0)
    cols = np.arange(dw * x.shape[2]).reshape(dw, x.shape[2])
    out = np.where(cols < (dw * x.shape[2]) // 4 * 4, rev, fwd)
    return out.reshape((dh, dw) + img.shape[2:])


def _linear_coeffs(ssize: int, dsize: int, clamp: bool):
    """INTER_LINEAR's taps; with `clamp` (the x direction) the fraction is
    0 past either border, the y direction keeps it on replicated taps."""
    scale = 1.0 / (dsize / ssize)
    idx = np.empty((dsize, 2), np.int64)
    coef = np.empty((dsize, 2), np.float32)
    for d in range(dsize):
        fx = np.float32((d + 0.5) * scale - 0.5)
        sx = int(np.floor(fx))
        fx = np.float32(fx - np.float32(sx))
        if clamp and sx < 0:
            fx, sx = np.float32(0), 0
        if clamp and sx >= ssize - 1:
            fx, sx = np.float32(0), ssize - 1
        idx[d] = np.clip((sx, sx + 1), 0, ssize - 1)
        coef[d] = (np.float32(1) - fx, fx)
    return idx, coef


def _resize_linear_f32(img: np.ndarray, dw: int, dh: int) -> np.ndarray:
    h, w = img.shape[:2]
    x = img.reshape(h, w, -1)
    xi, xc = _linear_coeffs(w, dw, True)
    yi, yc = _linear_coeffs(h, dh, False)
    rows = x[:, xi[:, 0]] * xc[None, :, 0, None] + x[:, xi[:, 1]] * xc[None, :, 1, None]
    out = rows[yi[:, 0]] * yc[:, 0, None, None] + rows[yi[:, 1]] * yc[:, 1, None, None]
    return out.reshape((dh, dw) + img.shape[2:])


def resize(img: np.ndarray, size: tuple, interpolation: str) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=...)`` for "area" and
    "lanczos4" on uint8, "cubic" and "linear" on float32."""
    dw, dh = int(size[0]), int(size[1])
    h, w = img.shape[:2]
    if (dw, dh) == (w, h):
        return img.copy()
    key = (interpolation, img.dtype.name)
    if key == ("area", "uint8"):
        if dw > w or dh > h:
            raise NotImplementedError(f"cv2 INTER_AREA enlarging {w}x{h} -> {dw}x{dh} "
                                      "(its linear path) is not restated")
        return _resize_area(img, dw, dh)
    if key == ("lanczos4", "uint8"):
        return _resize_lanczos4_u8(img, dw, dh)
    if key == ("cubic", "float32"):
        return _resize_cubic_f32(img, dw, dh)
    if key == ("cubic", "uint8"):
        return _resize_cubic_u8(img, dw, dh)
    if key == ("linear", "float32"):
        return _resize_linear_f32(img, dw, dh)
    raise NotImplementedError(f"cv2.resize {interpolation} on {img.dtype} is not restated")


def resize_by(img: np.ndarray, fx: float, fy: float, interpolation: str) -> np.ndarray:
    """``cv2.resize(img, (0, 0), fx=fx, fy=fy, interpolation=...)`` for
    "cubic" on uint8 and float32: the size rounds w·fx and h·fy to the
    nearest (half to even, cvRound), and the map goes through 1/fx and 1/fy,
    not through w/dw."""
    h, w = img.shape[:2]
    dw, dh = int(np.rint(w * fx)), int(np.rint(h * fy))
    if interpolation != "cubic" or img.dtype.name not in ("uint8", "float32"):
        raise NotImplementedError(f"cv2.resize by fx, fy {interpolation} on {img.dtype} "
                                  "is not restated")
    fn = _resize_cubic_u8 if img.dtype == np.uint8 else _resize_cubic_f32
    return fn(img, dw, dh, fx, fy)


# --------------------------------------------------------------------------
# remap
# --------------------------------------------------------------------------

def remap_linear(img: np.ndarray, map_x: np.ndarray, map_y: np.ndarray) -> np.ndarray:
    """``cv2.remap(img, map_x, map_y, cv2.INTER_LINEAR)`` of a uint8 image
    with float32 maps, as OpenCV 5 computes it in float32: the fractions
    α = x - ⌊x⌋, β = y - ⌊y⌋, each row lerped as p0 + α·(p1 - p0), the two
    rows as v0 + β·(v1 - v0) in one fused multiply-add, rounded half to
    even; taps outside the image
    read 0 (the constant border)."""
    h, w = img.shape[:2]
    x = img.reshape(h, w, -1).astype(np.float32)
    mx, my = map_x.astype(np.float32), map_y.astype(np.float32)
    fx, fy = np.floor(mx), np.floor(my)
    sx, sy = fx.astype(np.int64), fy.astype(np.int64)
    a, b = (mx - fx)[..., None], (my - fy)[..., None]

    def tap(dy, dx):
        yy, xx = sy + dy, sx + dx
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        return np.where(inside[..., None], x[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)],
                        np.float32(0))

    p00, p01, p10, p11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
    v0 = p00 + a * (p01 - p00)
    v1 = p10 + a * (p11 - p10)
    out = np.clip(np.rint(_fma(b, v1 - v0, v0)), 0, 255).astype(np.uint8)
    return out.reshape(map_x.shape + img.shape[2:])


# --------------------------------------------------------------------------
# drawing (imgproc/src/drawing.cpp): LINE_8, shift 0
# --------------------------------------------------------------------------

#: drawing.cpp's SinTable: sin of 0..450 degrees as float constants of 7
#: decimals
_SIN_TABLE = np.array([round(math.sin(math.radians(d)), 7) for d in range(451)], np.float32)


def _cv_round(v: float) -> int:
    """cvRound: to the nearest integer, halves to even."""
    return int(np.rint(v))


def ellipse2poly(center, axes, angle: int, arc_start: int, arc_end: int, delta: int) -> np.ndarray:
    """``cv2.ellipse2Poly``: (n, 2) int32 points, consecutive repeats dropped."""
    while angle < 0:
        angle += 360
    while angle > 360:
        angle -= 360
    if arc_start > arc_end:
        arc_start, arc_end = arc_end, arc_start
    while arc_start < 0:
        arc_start += 360
        arc_end += 360
    while arc_end > 360:
        arc_end -= 360
        arc_start -= 360
    if arc_end - arc_start > 360:
        arc_start, arc_end = 0, 360
    alpha = float(_SIN_TABLE[450 - angle])      # cos
    beta = float(_SIN_TABLE[angle])             # sin
    cx, cy = float(center[0]), float(center[1])
    pts = []
    for i in range(arc_start, arc_end + delta, delta):
        a = min(i, arc_end)
        if a < 0:
            a += 360
        x = axes[0] * float(_SIN_TABLE[450 - a])
        y = axes[1] * float(_SIN_TABLE[a])
        pts.append((cx + x * alpha - y * beta, cy + x * beta + y * alpha))
    if len(pts) == 1:
        pts = [(cx, cy)] * 2
    out, prev = [], None
    for px, py in pts:
        pt = (_cv_round(px), _cv_round(py))
        if pt != prev:
            out.append(pt)
            prev = pt
    if len(out) == 1:
        out = [(int(center[0]), int(center[1]))] * 2
    return np.array(out, np.int32)


def _clip_line(w: int, h: int, p1, p2):
    """clipLine: the segment inside the image, or None."""
    (x1, y1), (x2, y2) = p1, p2
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return ((x1, y1), (x2, y2)) if (c1 | c2) == 0 else None


def _line8(img: np.ndarray, p1, p2, color) -> None:
    """Line(img, pt1, pt2, color, 8): the 8-connected LineIterator, left
    to right, clipped to the image."""
    h, w = img.shape[:2]
    if not (0 <= p1[0] < w and 0 <= p2[0] < w and 0 <= p1[1] < h and 0 <= p2[1] < h):
        clipped = _clip_line(w, h, p1, p2)
        if clipped is None:
            return
        p1, p2 = clipped
    dx, dy = p2[0] - p1[0], p2[1] - p1[1]
    if dx < 0:
        dx, dy = -dx, -dy
        p1, p2 = p2, p1
    sx, sy = 1, 1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err = dx - 2 * dy
    x, y = p1
    for _ in range(dx + 1):
        img[y, x] = color
        step_minor = err < 0
        err += -2 * dy + (2 * dx if step_minor else 0)
        if vert:
            y += sy
            x += sx if step_minor else 0
        else:
            x += sx
            y += sy if step_minor else 0


def fill_convex_poly(img: np.ndarray, pts: np.ndarray, color) -> None:
    """``cv2.fillConvexPoly(img, pts, color)`` (LINE_8, shift 0), in place:
    the outline by 8-connected lines, then the rows between the two edges
    walked in 16.16 fixed point from the topmost vertex (FillConvexPoly)."""
    shift_xy, one = 16, 1 << 16
    v = [(int(p[0]), int(p[1])) for p in pts]
    n = len(v)
    h, w = img.shape[:2]
    color = np.asarray(color, img.dtype)
    xs = [p[0] for p in v]
    ys = [p[1] for p in v]
    imin = int(np.argmin(ys))
    p0 = v[-1]
    for p in v:
        _line8(img, p0, p, color)
        p0 = p
    xmin, xmax, ymin, ymax = min(xs), max(xs), min(ys), max(ys)
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    delta1 = delta2 = one >> 1
    edges = n
    edge = [dict(idx=imin, di=1, x=-one, dx=0, ye=ymin),
            dict(idx=imin, di=n - 1, x=-one, dx=0, ye=ymin)]
    y = ymin
    while True:
        for e in edge:
            if y >= e["ye"]:
                idx0, di = e["idx"], e["di"]
                idx = idx0 + di
                if idx >= n:
                    idx -= n
                while edges > 0:
                    edges -= 1
                    ty = v[idx][1]
                    if ty > y:
                        xs_, xe_ = v[idx0][0] << shift_xy, v[idx][0] << shift_xy
                        e["ye"] = ty
                        num = (xe_ - xs_) * 2 + (ty - y)
                        q = abs(num) // (2 * (ty - y))          # C's division: toward 0
                        e["dx"] = -q if num < 0 else q
                        e["x"] = xs_
                        e["idx"] = idx
                        break
                    idx0 = idx
                    idx += di
                    if idx >= n:
                        idx -= n
                else:
                    edges -= 1
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge[0]["x"] > edge[1]["x"] else (0, 1)
            xx1 = (edge[left]["x"] + delta1) >> shift_xy
            xx2 = (edge[right]["x"] + delta2) >> shift_xy
            if xx2 >= 0 and xx1 < w:
                img[y, max(xx1, 0):min(xx2, w - 1) + 1] = color
        edge[0]["x"] += edge[0]["dx"]
        edge[1]["x"] += edge[1]["dx"]
        y += 1
        if y > ymax:
            break


def fill_circle(img: np.ndarray, center, radius: int, color) -> None:
    """``cv2.circle(img, center, radius, color, -1)`` (LINE_8, shift 0), in
    place: drawing.cpp's Circle with fill, rows of the midpoint walk."""
    h, w = img.shape[:2]
    color = np.asarray(color, img.dtype)
    cx, cy = int(center[0]), int(center[1])
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    inside = radius <= cx < w - radius and radius <= cy < h - radius

    def hline(y, x1, x2):
        img[y, x1:x2 + 1] = color

    while dx >= dy:
        y11, y12, y21, y22 = cy - dy, cy + dy, cy - dx, cy + dx
        x11, x12, x21, x22 = cx - dx, cx + dx, cx - dy, cx + dy
        if inside:
            hline(y11, x11, x12)
            hline(y12, x11, x12)
            hline(y21, x21, x22)
            hline(y22, x21, x22)
        elif x11 < w and x12 >= 0 and y21 < h and y22 >= 0:
            x11, x12 = max(x11, 0), min(x12, w - 1)
            if 0 <= y11 < h:
                hline(y11, x11, x12)
            if 0 <= y12 < h:
                hline(y12, x11, x12)
            if x21 < w and x22 >= 0:
                x21, x22 = max(x21, 0), min(x22, w - 1)
                if 0 <= y21 < h:
                    hline(y21, x21, x22)
                if 0 <= y22 < h:
                    hline(y22, x21, x22)
        dy += 1
        err += plus
        plus += 2
        mask = -1 if err > 0 else 0      # (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
