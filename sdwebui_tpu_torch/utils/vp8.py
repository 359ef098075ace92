"""The lossy WebP decoder: a VP8 key frame (RFC 6386), restated as libwebp
decodes it, and libwebp's conversion of its YUV 4:2:0 planes to RGB.

``decode_frame`` parses the frame header (segmentation, the loop filter's
settings, the token partitions, the quantizers and the coefficient
probability updates), the intra modes of every macroblock (16×16, or
sixteen 4×4 sub-block modes under their key-frame contexts, and the chroma
mode) and the DCT tokens with the boolean decoder, one symbol at a time:
the bitstream allows no other way.  The rest is vectorised with numpy: the
dequantised coefficients of the whole frame go through the inverse WHT and
DCT at once (libwebp's ``TransformWHT`` / ``TransformOne`` arithmetic);
the prediction is then added macroblock by macroblock (sub-block by
sub-block in 4×4 macroblocks), since each predicts from its reconstructed
neighbours, with libwebp's borders (127 above the frame, 129 left of it)
and its top-right rule; the loop filter (simple, or normal with its
macroblock-edge and inner-edge filters, high-edge-variance test and
per-segment levels) runs on every macroblock at once along a wavefront of
macroblocks that do not touch.  ``yuv_to_rgb`` is libwebp's "fancy"
upsampler (each chroma sample weighted 9-3-3-1 toward the pixel, in the
same integer steps) and its 14-bit YUV → RGB, the path Pillow's
``WebPAnimDecoder`` takes.
"""

from __future__ import annotations

import struct

import numpy as np

from sdwebui_tpu_torch.utils import vp8_tables as T

ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
CAT3456 = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
           (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
#: the 4×4 mode tree (libwebp's kYModesIntra4): leaves are -mode
YMODES_INTRA4 = (0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9)
# 16×16 and chroma modes, and the 4×4 modes (their first four share numbers)
DC_PRED, TM_PRED, V_PRED, H_PRED = 0, 1, 2, 3
B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU = range(10)

_SHIFT = [0] + [7 ^ (r.bit_length() - 1) for r in range(1, 256)]


def _coeff_probas(flat) -> list:
    """Flat [4][8][3][11] → nested lists."""
    return [[[list(flat[((t * 8 + b) * 3 + c) * 11:((t * 8 + b) * 3 + c + 1) * 11])
              for c in range(3)] for b in range(8)] for t in range(4)]


class BoolDecoder:
    """RFC 6386's boolean decoder (section 7) in libwebp's form: `range` is
    the range less one, `bits` counts the bits buffered below the 8-bit
    window, and a read that needs a byte past the end sets `eof` and reads
    zeros, as libwebp's ``VP8LoadFinalBytes`` does.  ``sign`` is libwebp's
    ``VP8GetSigned``, which always takes one bit, so `eof` is set on the
    same read as in libwebp."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.value = 0
        self.bits = -8
        self.range = 254
        self.eof = False
        self._load()

    def _load(self):
        chunk = self.data[self.pos:self.pos + 4]
        if chunk:
            self.pos += len(chunk)
            self.value = (self.value << (8 * len(chunk))) | int.from_bytes(chunk, "big")
            self.bits += 8 * len(chunk)
        else:
            self.eof = True
            self.value <<= 8
            self.bits += 8

    def get(self, prob: int) -> int:
        if self.bits < 0:
            self._load()
        pos = self.bits
        split = (self.range * prob) >> 8
        if (self.value >> pos) > split:
            r = self.range - split
            self.value -= (split + 1) << pos
            bit = 1
        else:
            r = split + 1
            bit = 0
        shift = _SHIFT[r]
        self.range = (r << shift) - 1
        self.bits = pos - shift
        return bit

    def sign(self, v: int) -> int:
        """`v` with the sign of the next bit read at probability one half."""
        if self.bits < 0:
            self._load()
        pos = self.bits
        split = self.range >> 1
        self.bits = pos - 1
        if (self.value >> pos) > split:
            self.value -= (split + 1) << pos
            self.range = (self.range - 1) | 1
            return -v
        self.range |= 1
        return v

    def value_bits(self, bits: int) -> int:
        v = 0
        for _ in range(bits):
            v = (v << 1) | self.get(128)
        return v

    def signed(self, bits: int) -> int:
        v = self.value_bits(bits)
        return -v if self.get(128) else v


def _large_value(br: BoolDecoder, p) -> int:
    get = br.get
    if not get(p[3]):
        if not get(p[4]):
            return 2
        return 3 + get(p[5])
    if not get(p[6]):
        if not get(p[7]):
            return 5 + get(159)
        v = 7 + 2 * get(165)
        return v + get(145)
    bit1 = get(p[8])
    bit0 = get(p[9 + bit1])
    cat = 2 * bit1 + bit0
    v = 0
    for prob in CAT3456[cat]:
        v += v + get(prob)
    return v + 3 + (8 << cat)


def _get_coeffs(br: BoolDecoder, prob, ctx: int, dq, n: int, out: np.ndarray) -> int:
    """One block's tokens (libwebp's GetCoeffs) → the index after the last
    non-zero coefficient; dequantised values go to `out` in natural order."""
    get = br.get
    p = prob[n][ctx]
    while n < 16:
        if not get(p[0]):
            return n
        while not get(p[1]):
            n += 1
            p = prob[n][0]
            if n == 16:
                return 16
        if not get(p[2]):
            v = 1
            p = prob[n + 1][1]
        else:
            v = _large_value(br, p)
            p = prob[n + 1][2]
        out[ZIGZAG[n]] = br.sign(v) * (dq[1] if n else dq[0])
        n += 1
    return 16


def _clip(x, top=127):
    return 0 if x < 0 else top if x > top else x


def _mul1(a):
    return ((a * 20091) >> 16) + a


def _mul2(a):
    return (a * 35468) >> 16


def idct(coeffs: np.ndarray) -> np.ndarray:
    """(N, 16) dequantised coefficients → (N, 4, 4) residuals, libwebp's
    TransformOne (the ``>> 3`` of its STORE included)."""
    c = coeffs.astype(np.int64).reshape(-1, 4, 4)       # [row][col]
    i0, i1, i2, i3 = c[:, 0], c[:, 1], c[:, 2], c[:, 3]  # rows, each (N, 4) over columns
    a = i0 + i2
    b = i0 - i2
    cc = _mul2(i1) - _mul1(i3)
    d = _mul1(i1) + _mul2(i3)
    tmp = np.stack([a + d, b + cc, b - cc, a - d], axis=1)   # [k][col] = vertical pass
    # horizontal pass: row i reads tmp[0..3][i] across the columns
    t0, t1, t2, t3 = tmp[:, :, 0], tmp[:, :, 1], tmp[:, :, 2], tmp[:, :, 3]
    dc = t0 + 4
    a = dc + t2
    b = dc - t2
    cc = _mul2(t1) - _mul1(t3)
    d = _mul1(t1) + _mul2(t3)
    out = np.stack([a + d, b + cc, b - cc, a - d], axis=2) >> 3   # [n][row = k][x]
    return out


def _iwht(dc):
    """libwebp's TransformWHT: 16 Y2 coefficients → the 16 luma DCs."""
    tmp = [0] * 16
    for i in range(4):
        a0 = dc[i] + dc[12 + i]
        a1 = dc[4 + i] + dc[8 + i]
        a2 = dc[4 + i] - dc[8 + i]
        a3 = dc[i] - dc[12 + i]
        tmp[i] = a0 + a1
        tmp[8 + i] = a0 - a1
        tmp[4 + i] = a3 + a2
        tmp[12 + i] = a3 - a2
    out = [0] * 16
    for i in range(4):
        d = tmp[i * 4] + 3
        a0 = d + tmp[3 + i * 4]
        a1 = tmp[1 + i * 4] + tmp[2 + i * 4]
        a2 = tmp[1 + i * 4] - tmp[2 + i * 4]
        a3 = d - tmp[3 + i * 4]
        out[4 * i] = (a0 + a1) >> 3
        out[4 * i + 1] = (a3 + a2) >> 3
        out[4 * i + 2] = (a0 - a1) >> 3
        out[4 * i + 3] = (a3 - a2) >> 3
    return out


# --------------------------------------------------------------------------
# prediction
# --------------------------------------------------------------------------


def _pred_block(mode: int, top, left, tl, size: int, mb_x: int, mb_y: int) -> np.ndarray:
    """16×16 or 8×8 prediction; top/left int32 arrays, tl an int."""
    if mode == DC_PRED:
        shift = 5 if size == 16 else 4
        if mb_x and mb_y:
            v = (int(top.sum()) + int(left.sum()) + (1 << (shift - 1))) >> shift
        elif mb_y:
            v = (int(top.sum()) + (1 << (shift - 2))) >> (shift - 1)
        elif mb_x:
            v = (int(left.sum()) + (1 << (shift - 2))) >> (shift - 1)
        else:
            v = 128
        return np.full((size, size), v, np.int32)
    if mode == V_PRED:
        return np.broadcast_to(top, (size, size)).astype(np.int32)
    if mode == H_PRED:
        return np.broadcast_to(left[:, None], (size, size)).astype(np.int32)
    return np.clip(left[:, None] + top[None, :] - tl, 0, 255).astype(np.int32)


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def _pred4(mode: int, t, left, x) -> list:
    """One 4×4 prediction (libwebp's dec.c), row-major 16 values.  t: the 8
    pixels above (the last four above-right), left: the 4 to the left, x:
    the one above-left."""
    A, B, C, D, E, F, G, H = t
    I, J, K, L = left
    if mode == B_DC:
        v = (A + B + C + D + I + J + K + L + 4) >> 3
        return [v] * 16
    if mode == B_TM:
        return [_clip(left[r] + t[c] - x, 255) for r in range(4) for c in range(4)]
    if mode == B_VE:
        row = [_avg3(x, A, B), _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E)]
        return row * 4
    if mode == B_HE:
        out = []
        for v in (_avg3(x, I, J), _avg3(I, J, K), _avg3(J, K, L), _avg3(K, L, L)):
            out += [v] * 4
        return out
    o = [0] * 16
    if mode == B_RD:
        o[12] = _avg3(J, K, L)
        o[13] = o[8] = _avg3(I, J, K)
        o[14] = o[9] = o[4] = _avg3(x, I, J)
        o[15] = o[10] = o[5] = o[0] = _avg3(A, x, I)
        o[11] = o[6] = o[1] = _avg3(B, A, x)
        o[7] = o[2] = _avg3(C, B, A)
        o[3] = _avg3(D, C, B)
    elif mode == B_LD:
        o[0] = _avg3(A, B, C)
        o[1] = o[4] = _avg3(B, C, D)
        o[2] = o[5] = o[8] = _avg3(C, D, E)
        o[3] = o[6] = o[9] = o[12] = _avg3(D, E, F)
        o[7] = o[10] = o[13] = _avg3(E, F, G)
        o[11] = o[14] = _avg3(F, G, H)
        o[15] = _avg3(G, H, H)
    elif mode == B_VR:
        o[0] = o[9] = _avg2(x, A)
        o[1] = o[10] = _avg2(A, B)
        o[2] = o[11] = _avg2(B, C)
        o[3] = _avg2(C, D)
        o[12] = _avg3(K, J, I)
        o[8] = _avg3(J, I, x)
        o[4] = o[13] = _avg3(I, x, A)
        o[5] = o[14] = _avg3(x, A, B)
        o[6] = o[15] = _avg3(A, B, C)
        o[7] = _avg3(B, C, D)
    elif mode == B_VL:
        o[0] = _avg2(A, B)
        o[1] = o[8] = _avg2(B, C)
        o[2] = o[9] = _avg2(C, D)
        o[3] = o[10] = _avg2(D, E)
        o[4] = _avg3(A, B, C)
        o[5] = o[12] = _avg3(B, C, D)
        o[6] = o[13] = _avg3(C, D, E)
        o[7] = o[14] = _avg3(D, E, F)
        o[11] = _avg3(E, F, G)
        o[15] = _avg3(F, G, H)
    elif mode == B_HD:
        o[0] = o[6] = _avg2(I, x)
        o[4] = o[10] = _avg2(J, I)
        o[8] = o[14] = _avg2(K, J)
        o[12] = _avg2(L, K)
        o[3] = _avg3(A, B, C)
        o[2] = _avg3(x, A, B)
        o[1] = o[7] = _avg3(I, x, A)
        o[5] = o[11] = _avg3(J, I, x)
        o[9] = o[15] = _avg3(K, J, I)
        o[13] = _avg3(L, K, J)
    else:   # B_HU
        o[0] = _avg2(I, J)
        o[2] = o[4] = _avg2(J, K)
        o[6] = o[8] = _avg2(K, L)
        o[1] = _avg3(I, J, K)
        o[3] = o[5] = _avg3(J, K, L)
        o[7] = o[9] = _avg3(K, L, L)
        o[10] = o[11] = o[12] = o[13] = o[14] = o[15] = L
    return o


# --------------------------------------------------------------------------
# the loop filter
# --------------------------------------------------------------------------


def _filter(seg: np.ndarray, thresh, ithresh, hev_t, kind: str) -> None:
    """Filter across one edge, in place: seg is (8, N) int32, rows p3 p2 p1
    p0 q0 q1 q2 q3; thresholds broadcast over N.  kind: "simple", "mb"
    (FilterLoop26) or "inner" (FilterLoop24)."""
    p3, p2, p1, p0, q0, q1, q2, q3 = seg
    thresh2 = 2 * thresh + 1
    mask = 4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= thresh2
    if kind == "simple":
        hev = mask
    else:
        for a, b in ((p3, p2), (p2, p1), (p1, p0), (q3, q2), (q2, q1), (q1, q0)):
            mask &= np.abs(a - b) <= ithresh
        hev = (np.abs(p1 - p0) > hev_t) | (np.abs(q1 - q0) > hev_t)
        hev &= mask
    if hev.any():   # DoFilter2
        a = 3 * (q0 - p0) + np.clip(p1 - q1, -128, 127)
        a1 = np.clip((a + 4) >> 3, -16, 15)
        a2 = np.clip((a + 3) >> 3, -16, 15)
        seg[3] = np.where(hev, np.clip(p0 + a2, 0, 255), p0)
        seg[4] = np.where(hev, np.clip(q0 - a1, 0, 255), q0)
    if kind == "simple":
        return
    rest = mask & ~hev
    if not rest.any():
        return
    if kind == "mb":   # DoFilter6
        a = np.clip(3 * (q0 - p0) + np.clip(p1 - q1, -128, 127), -128, 127)
        a1 = (27 * a + 63) >> 7
        a2 = (18 * a + 63) >> 7
        a3 = (9 * a + 63) >> 7
        for row, v in ((1, p2 + a3), (2, p1 + a2), (3, p0 + a1), (4, q0 - a1), (5, q1 - a2),
                       (6, q2 - a3)):
            seg[row] = np.where(rest, np.clip(v, 0, 255), seg[row])
    else:              # DoFilter4
        a = 3 * (q0 - p0)
        a1 = np.clip((a + 4) >> 3, -16, 15)
        a2 = np.clip((a + 3) >> 3, -16, 15)
        a3 = (a1 + 1) >> 1
        for row, v in ((2, p1 + a3), (3, p0 + a2), (4, q0 - a1), (5, q1 - a3)):
            seg[row] = np.where(rest, np.clip(v, 0, 255), seg[row])


def _edges(plane: np.ndarray, mbs: np.ndarray, size: int, offset: int, vertical: bool,
           params, kind: str) -> None:
    """Filter one edge of each macroblock in `mbs` ((K, 2) of (mb_x, mb_y)),
    `offset` pixels into it, across columns (`vertical` edge) or rows.
    plane: (P, H, W) int32 planes; params: (thresh, ithresh, hev) arrays
    over K."""
    k = len(mbs)
    along = np.arange(size)
    across = np.arange(-4, 4)
    mx, my = mbs[:, 0], mbs[:, 1]
    if vertical:
        rows = (my * size)[:, None, None] + along[None, :, None]
        cols = (mx * size + offset)[:, None, None] + across[None, None, :]
    else:
        rows = (my * size + offset)[:, None, None] + across[None, None, :]
        cols = (mx * size)[:, None, None] + along[None, :, None]
    seg = plane[:, rows, cols]                      # (P, K, size, 8)
    p = seg.shape[0]
    flat = np.ascontiguousarray(seg.transpose(3, 0, 1, 2).reshape(8, -1))
    th, it, hv = (np.broadcast_to(np.asarray(v)[None, :, None], (p, k, size)).reshape(-1)
                  for v in params)
    _filter(flat, th, it, hv, kind)
    plane[:, rows, cols] = flat.reshape(8, p, k, size).transpose(1, 2, 3, 0)


def loop_filter(y: np.ndarray, uv: np.ndarray, fparams: np.ndarray, simple: bool,
                mbw: int, mbh: int) -> None:
    """Filter the whole frame in place.  fparams: (mbh, mbw, 4) of (limit,
    ilevel, hev_thresh, inner); a macroblock of limit 0 is left alone.
    Macroblock (x, y) reads what (x - 1, y), (x, y - 1) and (x + 1, y - 1)
    wrote, so the macroblocks of one wave 2·y + x are filtered together."""
    yy = y[None]
    for wave in range(mbw + 2 * mbh):
        ys = np.arange(max(0, (wave - mbw + 2) // 2), min(mbh - 1, wave // 2) + 1)
        xs = wave - 2 * ys
        ok = (xs >= 0) & (xs < mbw)
        ys, xs = ys[ok], xs[ok]
        if not len(ys):
            continue
        fp = fparams[ys, xs]
        live = fp[:, 0] > 0
        if not live.any():
            continue
        mbs = np.stack([xs, ys], 1)[live]
        fp = fp[live]
        limit, ilevel, hev, inner = fp[:, 0], fp[:, 1], fp[:, 2], fp[:, 3].astype(bool)
        left = mbs[:, 0] > 0
        top = mbs[:, 1] > 0
        stages = ((left, 0, True, limit + 4, "mb"), (inner, 4, True, limit, "inner"),
                  (inner, 8, True, limit, "inner"), (inner, 12, True, limit, "inner"),
                  (top, 0, False, limit + 4, "mb"), (inner, 4, False, limit, "inner"),
                  (inner, 8, False, limit, "inner"), (inner, 12, False, limit, "inner"))
        for sel, off, vertical, th, kind in stages:
            if not sel.any():
                continue
            params = (th[sel], ilevel[sel], hev[sel])
            if simple:
                _edges(yy, mbs[sel], 16, off, vertical, params, "simple")
                continue
            _edges(yy, mbs[sel], 16, off, vertical, params, kind)
            if off in (0, 4):   # chroma: the macroblock edge and the middle one
                if off == 4 or kind == "mb":
                    _edges(uv, mbs[sel], 8, off, vertical, params, kind)


# --------------------------------------------------------------------------
# the frame
# --------------------------------------------------------------------------


class Frame:
    """A decoded key frame: the unfiltered-then-filtered planes at the
    macroblock-padded size, and the picture's own width and height."""

    def __init__(self, width, height, y, u, v):
        self.width, self.height = width, height
        self.y, self.u, self.v = y, u, v


def _header(data: bytes):
    if len(data) < 10:
        raise ValueError("truncated VP8 frame")
    bits = data[0] | (data[1] << 8) | (data[2] << 16)
    if bits & 1:
        raise ValueError("a VP8 inter frame in a WebP file")
    if (bits >> 1) & 7 > 3:
        raise ValueError(f"unknown VP8 profile {(bits >> 1) & 7}")
    if not (bits >> 4) & 1:
        raise ValueError("a VP8 frame that is not shown")
    part0 = bits >> 5
    if data[3:6] != b"\x9d\x01\x2a":
        raise ValueError("bad VP8 start code")
    w, h = struct.unpack_from("<HH", data, 6)
    return w & 0x3FFF, h & 0x3FFF, part0


def decode_frame(data: bytes) -> Frame:
    """A VP8 key frame's bytes (the body of a ``VP8 `` chunk) → its Y, U and
    V planes."""
    from sdwebui_tpu_torch.utils.png import check_image_size

    width, height, part0 = _header(data)
    if width == 0 or height == 0:
        raise ValueError("VP8 frame of no pixels")
    check_image_size(width, height)
    if 10 + part0 > len(data):
        raise ValueError("truncated VP8 first partition")
    br = BoolDecoder(data[10:10 + part0])
    mbw, mbh = (width + 15) >> 4, (height + 15) >> 4
    br.get(128)                      # colour space
    br.get(128)                      # clamping type
    use_segment = br.get(128)
    update_map, absolute, seg_q, seg_f, seg_probs = 0, 0, [0] * 4, [0] * 4, [255] * 3
    if use_segment:
        update_map = br.get(128)
        if br.get(128):              # update data
            absolute = br.get(128)
            seg_q = [br.signed(7) if br.get(128) else 0 for _ in range(4)]
            seg_f = [br.signed(6) if br.get(128) else 0 for _ in range(4)]
        if update_map:
            seg_probs = [br.value_bits(8) if br.get(128) else 255 for _ in range(3)]
    simple = br.get(128)
    level = br.value_bits(6)
    sharpness = br.value_bits(3)
    ref_delta, mode_delta = [0] * 4, [0] * 4
    use_lf_delta = br.get(128)
    if use_lf_delta and br.get(128):
        for i in range(4):
            if br.get(128):
                ref_delta[i] = br.signed(6)
        for i in range(4):
            if br.get(128):
                mode_delta[i] = br.signed(6)
    if br.eof:
        raise ValueError("premature end of the VP8 frame header")
    # the token partitions, as libwebp's ParsePartitions cuts them
    num_parts = 1 << br.value_bits(2)
    rest = data[10 + part0:]
    pos = 3 * (num_parts - 1)
    if len(rest) < pos:
        raise ValueError("truncated VP8 partition sizes")
    parts = []
    for p in range(num_parts - 1):
        size = min(int.from_bytes(rest[3 * p:3 * p + 3], "little"), len(rest) - pos)
        parts.append(BoolDecoder(rest[pos:pos + size]))
        pos += size
    if pos >= len(rest):
        raise ValueError("truncated VP8 token partitions")
    parts.append(BoolDecoder(rest[pos:]))
    base_q = br.value_bits(7)
    dq = [br.signed(4) if br.get(128) else 0 for _ in range(5)]  # y1dc y2dc y2ac uvdc uvac
    quant = []
    for s in range(4):
        q = (seg_q[s] + (0 if absolute else base_q)) if use_segment else base_q
        if not use_segment and s:
            quant.append(quant[0])
            continue
        y1 = (T.DC_TABLE[_clip(q + dq[0])], T.AC_TABLE[_clip(q)])
        y2ac = (T.AC_TABLE[_clip(q + dq[2])] * 101581) >> 16
        y2 = (T.DC_TABLE[_clip(q + dq[1])] * 2, max(y2ac, 8))
        uv = (T.DC_TABLE[_clip(q + dq[3], 117)], T.AC_TABLE[_clip(q + dq[4])])
        quant.append((y1, y2, uv))
    br.get(128)                      # refresh entropy probabilities: ignored
    probas = _coeff_probas(T.COEFFS_PROBA0)
    upd = T.COEFFS_UPDATE_PROBA
    for t in range(4):
        for b in range(8):
            for c in range(3):
                row = probas[t][b][c]
                base = ((t * 8 + b) * 3 + c) * 11
                for i in range(11):
                    if br.get(upd[base + i]):
                        row[i] = br.value_bits(8)
    skip_p = br.value_bits(8) if br.get(128) else None
    bands = [[probas[t][BANDS[n]] for n in range(17)] for t in range(4)]

    # intra modes of every macroblock (partition 0)
    n_mb = mbw * mbh
    seg = np.zeros(n_mb, np.int32)
    skip = np.zeros(n_mb, bool)
    is4 = np.zeros(n_mb, bool)
    ymode = np.zeros(n_mb, np.int32)
    uvmode = np.zeros(n_mb, np.int32)
    bmodes = np.zeros((n_mb, 16), np.int32)
    top_modes = [0] * (4 * mbw)
    bm = T.BMODES_PROBA
    get = br.get
    for my in range(mbh):
        left = [0] * 4
        for mx in range(mbw):
            i = my * mbw + mx
            if update_map:
                seg[i] = get(seg_probs[2]) + 2 if get(seg_probs[0]) else get(seg_probs[1])
            if skip_p is not None:
                skip[i] = get(skip_p)
            if not get(145):
                is4[i] = True
                for y4 in range(4):
                    m = left[y4]
                    for x4 in range(4):
                        base = (top_modes[4 * mx + x4] * 10 + m) * 9
                        k = YMODES_INTRA4[get(bm[base])]
                        while k > 0:
                            k = YMODES_INTRA4[2 * k + get(bm[base + k])]
                        m = -k
                        top_modes[4 * mx + x4] = m
                        bmodes[i, 4 * y4 + x4] = m
                    left[y4] = m
            else:
                if get(156):
                    m = TM_PRED if get(128) else H_PRED
                else:
                    m = V_PRED if get(163) else DC_PRED
                ymode[i] = m
                top_modes[4 * mx:4 * mx + 4] = [m] * 4
                left = [m] * 4
            uvmode[i] = DC_PRED if not get(142) else V_PRED if not get(114) else \
                TM_PRED if get(183) else H_PRED
        if br.eof:
            raise ValueError("premature end of VP8 partition 0")

    # tokens
    coeffs = np.zeros((n_mb, 25, 16), np.int32)   # 16 Y, 4 U, 4 V, Y2
    nonzero = np.zeros(n_mb, bool)
    top_nz = np.zeros((mbw, 9), np.int8)           # 4 Y, 2 U, 2 V, DC
    for my in range(mbh):
        tb = parts[my & (num_parts - 1)]
        left_nz = [0] * 9
        for mx in range(mbw):
            i = my * mbw + mx
            tn = top_nz[mx]
            if tb.eof:
                raise ValueError("premature end of the VP8 data")
            if skip[i]:
                tn[:8] = 0
                left_nz[:8] = [0] * 8
                if not is4[i]:
                    tn[8] = 0
                    left_nz[8] = 0
                continue
            y1, y2, uvq = quant[seg[i]]
            c = coeffs[i]
            if not is4[i]:
                dc = np.zeros(16, np.int32)
                ctx = int(tn[8]) + left_nz[8]
                nz = _get_coeffs(tb, bands[1], ctx, y2, 0, dc)
                tn[8] = left_nz[8] = int(nz > 0)
                if nz > 1:
                    c[:16, 0] = _iwht(dc.tolist())
                else:
                    c[:16, 0] = (int(dc[0]) + 3) >> 3
                first, ac = 1, bands[0]
            else:
                first, ac = 0, bands[3]
            any_nz = False
            for y4 in range(4):
                lnz = left_nz[y4]
                for x4 in range(4):
                    blk = c[4 * y4 + x4]
                    nz = _get_coeffs(tb, ac, lnz + int(tn[x4]), y1, first, blk)
                    lnz = int(nz > first)
                    tn[x4] = lnz
                    any_nz = any_nz or nz > 1 or blk[0] != 0
                left_nz[y4] = lnz
            for ch in (0, 2):
                for y2_ in range(2):
                    lnz = left_nz[4 + ch + y2_]
                    for x2 in range(2):
                        blk = c[16 + 2 * ch + 2 * y2_ + x2]
                        nz = _get_coeffs(tb, bands[2], lnz + int(tn[4 + ch + x2]), uvq, 0, blk)
                        lnz = int(nz > 0)
                        tn[4 + ch + x2] = lnz
                        any_nz = any_nz or nz > 1 or blk[0] != 0
                    left_nz[4 + ch + y2_] = lnz
            nonzero[i] = any_nz
        if tb.eof:
            raise ValueError("premature end of the VP8 data")

    # reconstruction: residuals of the whole frame at once, then prediction
    res = idct(coeffs[:, :24].reshape(-1, 16)).reshape(n_mb, 24, 4, 4)
    res_y = res[:, :16].reshape(n_mb, 4, 4, 4, 4).transpose(0, 1, 3, 2, 4).reshape(n_mb, 16, 16)
    res_uv = res[:, 16:].reshape(n_mb, 2, 2, 2, 4, 4).transpose(0, 1, 2, 4, 3, 5) \
        .reshape(n_mb, 2, 8, 8)
    Y = np.zeros((mbh * 16, mbw * 16), np.int32)
    UV = np.zeros((2, mbh * 8, mbw * 8), np.int32)
    for my in range(mbh):
        for mx in range(mbw):
            i = my * mbw + mx
            y0, x0 = my * 16, mx * 16
            top = Y[y0 - 1, x0:x0 + 16] if my else np.full(16, 127, np.int32)
            left = Y[y0:y0 + 16, x0 - 1] if mx else np.full(16, 129, np.int32)
            tl = int(Y[y0 - 1, x0 - 1]) if my and mx else 127 if not my else 129
            if not is4[i]:
                pred = _pred_block(int(ymode[i]), top, left, tl, 16, mx, my)
                Y[y0:y0 + 16, x0:x0 + 16] = np.clip(pred + res_y[i], 0, 255)
            else:
                if not my:
                    tr = [127] * 4
                elif mx < mbw - 1:
                    tr = Y[y0 - 1, x0 + 16:x0 + 20].tolist()
                else:
                    tr = [int(Y[y0 - 1, x0 + 15])] * 4
                ctx = np.zeros((17, 21), np.int32)
                ctx[0, 0] = tl
                ctx[0, 1:17] = top
                ctx[0, 17:21] = tr
                ctx[1:17, 0] = left
                for k in (4, 8, 12):
                    ctx[k, 17:21] = tr
                r = res_y[i]
                modes = bmodes[i].tolist()
                for y4 in range(4):
                    for x4 in range(4):
                        ry, rx = 4 * y4, 4 * x4
                        above = ctx[ry, rx:rx + 9].tolist()
                        lft = ctx[ry + 1:ry + 5, rx].tolist()
                        p = np.array(_pred4(modes[4 * y4 + x4], above[1:9], lft, above[0]),
                                     np.int32).reshape(4, 4)
                        ctx[ry + 1:ry + 5, rx + 1:rx + 5] = np.clip(
                            p + r[ry:ry + 4, rx:rx + 4], 0, 255)
                Y[y0:y0 + 16, x0:x0 + 16] = ctx[1:17, 1:17]
            cy, cx = my * 8, mx * 8
            for ch in range(2):
                P = UV[ch]
                top = P[cy - 1, cx:cx + 8] if my else np.full(8, 127, np.int32)
                left = P[cy:cy + 8, cx - 1] if mx else np.full(8, 129, np.int32)
                tl = int(P[cy - 1, cx - 1]) if my and mx else 127 if not my else 129
                pred = _pred_block(int(uvmode[i]), top, left, tl, 8, mx, my)
                P[cy:cy + 8, cx:cx + 8] = np.clip(pred + res_uv[i, ch], 0, 255)

    # the loop filter
    if level:
        fparams = np.zeros((mbh, mbw, 4), np.int32)
        for s in range(4):
            base = (seg_f[s] + (0 if absolute else level)) if use_segment else level
            for i4 in (0, 1):
                lv = base
                if use_lf_delta:
                    lv += ref_delta[0]
                    if i4:
                        lv += mode_delta[0]
                lv = _clip(lv, 63)
                if lv == 0:
                    continue
                il = lv
                if sharpness:
                    il >>= 2 if sharpness > 4 else 1
                    il = min(il, 9 - sharpness)
                il = max(il, 1)
                sel = ((seg == s) & (is4 == bool(i4))).reshape(mbh, mbw)
                fparams[sel] = (2 * lv + il, il, 2 if lv >= 40 else 1 if lv >= 15 else 0, 0)
        fparams[..., 3] = (is4 | nonzero).reshape(mbh, mbw)
        loop_filter(Y, UV, fparams, bool(simple), mbw, mbh)
    return Frame(width, height, Y.astype(np.uint8), UV[0].astype(np.uint8),
                 UV[1].astype(np.uint8))


# --------------------------------------------------------------------------
# YUV → RGB
# --------------------------------------------------------------------------


def _upsample(plane: np.ndarray, width: int, height: int) -> np.ndarray:
    """libwebp's fancy upsampler of one chroma plane ((H+1)/2, (W+1)/2
    samples used) → (height, width)."""
    ch, cw = (height + 1) // 2, (width + 1) // 2
    c = plane[:ch, :cw].astype(np.int32)
    rows = np.arange(height)
    near = rows >> 1
    far = np.clip(near + np.where(rows & 1, 1, -1), 0, ch - 1)
    n, f = c[near], c[far]                              # (height, cw)
    out = np.empty((height, width), np.int32)
    out[:, 0] = (3 * n[:, 0] + f[:, 0] + 2) >> 2
    cols = np.arange(1, width)
    last_pair = (width - 1) >> 1
    inner = cols[cols <= 2 * last_pair]
    N = inner >> 1
    O = np.where(inner & 1, N + 1, N - 1)
    out[:, inner] = (((n[:, N] + 3 * n[:, O] + 3 * f[:, N] + f[:, O] + 8) >> 3) + n[:, N]) >> 1
    if not width & 1 and width > 1:
        k = cw - 1
        out[:, width - 1] = (3 * n[:, k] + f[:, k] + 2) >> 2
    return out


def yuv_to_rgb(frame: Frame) -> np.ndarray:
    """→ (H, W, 3) uint8 RGB, libwebp's VP8YuvToRgb (14-bit) after fancy
    upsampling."""
    w, h = frame.width, frame.height
    y = frame.y[:h, :w].astype(np.int32)
    u = _upsample(frame.u, w, h)
    v = _upsample(frame.v, w, h)

    def hi(a, k):
        return (a * k) >> 8

    def clip8(x):
        return np.where((x & ~16383) == 0, x >> 6, np.where(x < 0, 0, 255))

    yy = hi(y, 19077)
    r = clip8(yy + hi(v, 26149) - 14234)
    g = clip8(yy - hi(u, 6419) - hi(v, 13320) + 8708)
    b = clip8(yy + hi(u, 33050) - 17685)
    return np.stack([r, g, b], axis=2).astype(np.uint8)
