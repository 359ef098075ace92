"""A JPEG decoder and baseline encoder on numpy and the standard library.

What Pillow does for the JAX package (``Image.open(...).convert("RGB")`` at
``sdwebui_tpu/server/app.py:496`` and every image route, ``image.save(...,
"JPEG", quality=..., exif=...)`` at ``sdwebui_tpu/utils/images.py:122-137``),
restated with libjpeg-turbo's integer arithmetic so that the pixels, and
the encoder's bytes, are Pillow's:

decoder   baseline, extended-sequential and progressive Huffman files of
          8-bit samples: grey, YCbCr (JFIF) and RGB (an Adobe marker with
          transform 0, or component ids "R", "G", "B"); sampling factors of
          1 or 2 (4:4:4, 4:2:2, 4:2:0, 4:4:0); DRI restart intervals.  The
          entropy decoding is sequential host work over 32-bit windows of
          the scan's bits (one per bit position); dequantisation, the ISLOW
          integer IDCT (``jidctint.c``), fancy upsampling (``jdsample.c``:
          the h2v1 and h2v2 triangle filters, h1v2 as libjpeg-turbo >= 2
          does it, box replication where a downsampled row is 2 samples or
          fewer) and the fixed-point YCbCr → RGB tables (``jdcolor.c``) are
          vectorised over blocks and planes.  A complete progressive file
          needs no block smoothing.  CMYK/YCCK, 12-bit samples, arithmetic
          coding, lossless and hierarchical files, sampling factors above 2,
          truncated files and frames over Pillow's pixel limit (its
          decompression-bomb check, before anything is allocated) raise
          ``ValueError``.  The coefficients are held as 16-bit integers
          (libjpeg's JCOEF), and the stages after the entropy decoding run
          over bands of rows, so that a large frame costs a few times its
          pixels in memory, as it does in Pillow.
encoder   baseline only, Pillow's defaults: the standard tables scaled by
          ``jpeg_quality_scaling``, 4:2:0 (``h2v2_downsample`` with its
          alternating bias, edges replicated as ``jcprepct.c`` does, dummy
          blocks as ``jccoefct.c`` makes them), the ISLOW forward DCT
          (``jfdctint.c``), libjpeg-turbo's reciprocal quantisation
          (``jcdctmgr.c``) and the standard Huffman tables; a JFIF APP0, then
          the EXIF APP1 when one is given.  A grey image is written as one
          component.  The bit stream is packed with numpy.
"""

from __future__ import annotations

import array
import struct

import numpy as np

from sdwebui_tpu_torch.utils import exif as exif_util
from sdwebui_tpu_torch.utils.png import check_image_size


def _natural_order() -> np.ndarray:
    """Zigzag position k → natural (row-major) index of the 8×8 block."""
    order = sorted(((r, c) for r in range(8) for c in range(8)),
                   key=lambda rc: (rc[0] + rc[1], rc[0] if (rc[0] + rc[1]) % 2 else rc[1]))
    return np.array([r * 8 + c for r, c in order], np.int64)


ZIGZAG = _natural_order()
#: libjpeg's jpeg_natural_order with the 16 extra entries that absorb a
#: corrupt run past position 63
_ZZ = ZIGZAG.tolist() + [63] * 16

STD_LUMINANCE_QT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)
STD_CHROMINANCE_QT = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32, np.int64)

_AC_LUMINANCE_VALS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa")
_AC_CHROMINANCE_VALS = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa")
#: the standard Huffman tables (ITU T.81 K.3): (counts of codes of length
#: 1..16, symbols)
STD_HUFFMAN = {
    "dc_luminance": (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]), bytes(range(12))),
    "dc_chrominance": (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]), bytes(range(12))),
    "ac_luminance": (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d]),
                     _AC_LUMINANCE_VALS),
    "ac_chrominance": (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]),
                       _AC_CHROMINANCE_VALS),
}

# the ISLOW DCTs' constants: FIX(x) = round(x * 2**13)
_CONST_BITS, _PASS1_BITS = 13, 2
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172

# SOF markers: the ones decoded here, and what the others are
_SOF_HUFFMAN = {0xC0: False, 0xC1: False, 0xC2: True}
_SOF_REFUSED = {0xC3: "lossless", 0xC5: "hierarchical", 0xC6: "hierarchical progressive",
                0xC7: "hierarchical lossless", 0xC9: "arithmetic-coded",
                0xCA: "arithmetic-coded progressive", 0xCB: "arithmetic-coded lossless",
                0xCD: "arithmetic-coded hierarchical",
                0xCE: "arithmetic-coded hierarchical progressive",
                0xCF: "arithmetic-coded hierarchical lossless"}


def quality_scaling(quality: int) -> int:
    """libjpeg's jpeg_quality_scaling: the percentage the standard tables
    are scaled by."""
    quality = min(max(int(quality), 1), 100)
    return 5000 // quality if quality < 50 else 200 - quality * 2


def scaled_table(basic: np.ndarray, quality: int) -> np.ndarray:
    """jpeg_add_quant_table with force_baseline: (basic·scale + 50) / 100
    within [1, 255], in natural order."""
    return np.clip((basic * quality_scaling(quality) + 50) // 100, 1, 255)


# --------------------------------------------------------------------------
# the integer DCTs, vectorised over blocks
# --------------------------------------------------------------------------

def _descale(x, n: int):
    return (x + (1 << (n - 1))) >> n


def _idct_1d(d, shift: int):
    """jpeg_idct_islow's butterfly over the 8 inputs d[0..7] (arrays of
    equal shape); outputs descaled by `shift`."""
    z2, z3 = d[2], d[6]
    z1 = (z2 + z3) * _F0541
    tmp2 = z1 - z3 * _F1847
    tmp3 = z1 + z2 * _F0765
    tmp0 = (d[0] + d[4]) << _CONST_BITS
    tmp1 = (d[0] - d[4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = d[7], d[5], d[3], d[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1175
    t0, t1, t2, t3 = t0 * _F0298, t1 * _F2053, t2 * _F3072, t3 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    return [_descale(tmp10 + t3, shift), _descale(tmp11 + t2, shift),
            _descale(tmp12 + t1, shift), _descale(tmp13 + t0, shift),
            _descale(tmp13 - t0, shift), _descale(tmp12 - t1, shift),
            _descale(tmp11 - t2, shift), _descale(tmp10 - t3, shift)]


def idct_islow(coefs: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """(N, 64) quantised coefficients in natural order and their table →
    (N, 8, 8) uint8 samples: columns then rows, the range limit a clamp."""
    x = (coefs.astype(np.int64) * qtable.astype(np.int64)).reshape(-1, 8, 8)
    ws = np.stack(_idct_1d([x[:, k, :] for k in range(8)], _CONST_BITS - _PASS1_BITS), axis=1)
    out = np.stack(_idct_1d([ws[:, :, k] for k in range(8)],
                            _CONST_BITS + _PASS1_BITS + 3), axis=2)
    return np.clip(out + 128, 0, 255).astype(np.uint8)


def fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """(N, 8, 8) uint8 samples → (N, 8, 8) int64 coefficients scaled by 8
    (jpeg_fdct_islow): rows then columns."""
    x = blocks.astype(np.int64) - 128

    def fdct_1d(d, last: bool):
        tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
        tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
        tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
        tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
        tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
        tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
        shift = _CONST_BITS + _PASS1_BITS if last else _CONST_BITS - _PASS1_BITS
        out = [None] * 8
        if last:
            out[0], out[4] = _descale(tmp10 + tmp11, _PASS1_BITS), _descale(tmp10 - tmp11,
                                                                            _PASS1_BITS)
        else:
            out[0], out[4] = (tmp10 + tmp11) << _PASS1_BITS, (tmp10 - tmp11) << _PASS1_BITS
        z1 = (tmp12 + tmp13) * _F0541
        out[2] = _descale(z1 + tmp13 * _F0765, shift)
        out[6] = _descale(z1 - tmp12 * _F1847, shift)
        z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
        z5 = (z3 + z4) * _F1175
        tmp4, tmp5, tmp6, tmp7 = tmp4 * _F0298, tmp5 * _F2053, tmp6 * _F3072, tmp7 * _F1501
        z1, z2 = z1 * -_F0899, z2 * -_F2562
        z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
        out[7] = _descale(tmp4 + z1 + z3, shift)
        out[5] = _descale(tmp5 + z2 + z4, shift)
        out[3] = _descale(tmp6 + z2 + z3, shift)
        out[1] = _descale(tmp7 + z1 + z4, shift)
        return out

    rows = np.stack(fdct_1d([x[:, :, k] for k in range(8)], False), axis=2)
    return np.stack(fdct_1d([rows[:, k, :] for k in range(8)], True), axis=1)


def _reciprocals(qtable: np.ndarray):
    """jcdctmgr.c compute_reciprocal for divisors qtable·8: (reciprocal,
    correction, shift) with 16-bit DCTELEMs."""
    recip, corr, shift = [], [], []
    for q in (int(v) << 3 for v in qtable):
        b = q.bit_length() - 1
        r = 16 + b
        fq, fr = divmod(1 << r, q)
        c = q // 2
        if fr == 0:
            fq >>= 1
            r -= 1
        elif fr <= q // 2:
            c += 1
        else:
            fq += 1
        recip.append(fq)
        corr.append(c)
        shift.append(r)
    return np.array(recip, np.int64), np.array(corr, np.int64), np.array(shift, np.int64)


def quantize(coefs: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """libjpeg-turbo's quantize(): |x| + correction times the reciprocal,
    shifted down, the sign put back.  (N, 64) natural order."""
    recip, corr, shift = _reciprocals(qtable)
    mag = ((np.abs(coefs) + corr) * recip) >> shift
    return np.where(coefs < 0, -mag, mag)


# --------------------------------------------------------------------------
# colour conversion and resampling
# --------------------------------------------------------------------------

_SCALEBITS, _ONE_HALF = 16, 1 << 15


def _fix16(x: float) -> int:
    return int(x * (1 << _SCALEBITS) + 0.5)


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c ycc_rgb_convert with its fixed-point tables."""
    xb = cb.astype(np.int64) - 128
    xr = cr.astype(np.int64) - 128
    yy = y.astype(np.int64)
    r = yy + ((_fix16(1.40200) * xr + _ONE_HALF) >> _SCALEBITS)
    g = yy + ((-_fix16(0.34414) * xb + _ONE_HALF - _fix16(0.71414) * xr) >> _SCALEBITS)
    b = yy + ((_fix16(1.77200) * xb + _ONE_HALF) >> _SCALEBITS)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def rgb_to_ycc(rgb: np.ndarray):
    """jccolor.c rgb_ycc_convert: (Y, Cb, Cr) uint8 planes; Cb and Cr round
    with 0.5 - epsilon so they need no range limit."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    cbcr = (128 << _SCALEBITS) + _ONE_HALF - 1
    y = (_fix16(0.29900) * r + _fix16(0.58700) * g + _fix16(0.11400) * b + _ONE_HALF) >> 16
    cb = (-_fix16(0.16874) * r - _fix16(0.33126) * g + _fix16(0.5) * b + cbcr) >> 16
    cr = (_fix16(0.5) * r - _fix16(0.41869) * g - _fix16(0.08131) * b + cbcr) >> 16
    return y.astype(np.uint8), cb.astype(np.uint8), cr.astype(np.uint8)


def _upsample(plane: np.ndarray, dw: int, dh: int, fx: int, fy: int, a: int,
              b: int) -> np.ndarray:
    """Rows a..b-1 of a component's decoded samples (its padded block grid)
    → those rows at full resolution (jdsample.c): fancy triangle filters
    over the dw × dh samples that hold the image, the rows next to the band
    its context, edges replicated as jdmainct.c's context rows and the
    filters' edge cases do; box replication for h2 when dw <= 2."""
    if fx == 1 and fy == 1:
        return plane[a:b]
    if fx == 2 and dw <= 2:
        return np.repeat(np.repeat(plane[a:b], 2, axis=1), fy, axis=0)
    p = plane[a:b, :dw].astype(np.int32)
    if fy == 2:
        above = plane[a - 1 if a else 0:b - 1, :dw].astype(np.int32)
        if not a:
            above = np.concatenate([p[:1], above], axis=0)
        below = plane[a + 1:b + 1 if b < dh else b, :dw].astype(np.int32)
        if b >= dh:
            below = np.concatenate([below, p[-1:]], axis=0)
        if fx == 1:                                   # h1v2
            out = np.empty((2 * (b - a), dw), np.int32)
            out[0::2] = (3 * p + above + 1) >> 2
            out[1::2] = (3 * p + below + 2) >> 2
            return out.astype(np.uint8)
        out = np.empty((2 * (b - a), 2 * dw), np.int32)    # h2v2
        for v, near in ((0, above), (1, below)):
            colsum = 3 * p + near
            left = np.concatenate([colsum[:, :1], colsum[:, :-1]], axis=1)
            right = np.concatenate([colsum[:, 1:], colsum[:, -1:]], axis=1)
            out[v::2, 0::2] = (3 * colsum + left + 8) >> 4
            out[v::2, 1::2] = (3 * colsum + right + 7) >> 4
        return out.astype(np.uint8)
    left = np.concatenate([p[:, :1], p[:, :-1]], axis=1)     # h2v1
    right = np.concatenate([p[:, 1:], p[:, -1:]], axis=1)
    out = np.empty((b - a, 2 * dw), np.int32)
    out[:, 0::2] = (3 * p + left + 1) >> 2
    out[:, 1::2] = (3 * p + right + 2) >> 2
    return out.astype(np.uint8)


# --------------------------------------------------------------------------
# decoding
# --------------------------------------------------------------------------

class _Component:
    __slots__ = ("cid", "h", "v", "tq", "nbx", "nby", "wib", "hib", "dw", "dh", "coefs",
                 "td", "ta")

    def __init__(self, cid, h, v, tq):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.td = self.ta = 0


def _huffman_lut(counts: bytes, symbols: bytes) -> list:
    """A 16-bit-prefix lookup table: entry = (code length << 8) | symbol,
    0 where no code starts (jdhuff.c's canonical code assignment)."""
    lut = np.zeros(1 << 16, np.int32)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            if k >= len(symbols):
                raise ValueError("bad Huffman table")
            if code >= 1 << length:
                raise ValueError("bad Huffman table")
            span = 1 << (16 - length)
            lut[code * span:(code + 1) * span] = (length << 8) | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


def _windows(segment: bytes) -> array.array:
    """The 32-bit big-endian window at every bit position of an unstuffed
    entropy-coded segment, zero bits past its end (libjpeg fills with zeros
    when a segment runs short)."""
    b = np.frombuffer(segment + bytes(16), np.uint8).astype(np.uint64)
    n = len(segment) + 12
    v = (b[:n] << 32) | (b[1:n + 1] << 24) | (b[2:n + 2] << 16) | (b[3:n + 3] << 8) | b[4:n + 4]
    win = np.empty((n, 8), np.uint32)
    for j in range(8):
        win[:, j] = (v >> np.uint64(8 - j)) & np.uint64(0xFFFFFFFF)
    out = array.array("I")
    out.frombytes(win.tobytes())
    return out


def _code(lut, win, pos):
    e = lut[win[pos] >> 16]
    if not e:
        raise ValueError("corrupt JPEG data: bad Huffman code")
    return e


def _decode_segment(kind, win, comps, blocks, ss, se, al, dc_luts, ac_luts):
    """Decode one restart segment: `blocks` is [(component index, its block
    offset into the coefficient list), ...] in scan order.  kind: "seq"
    (baseline / extended), "dc" / "dc_ref" / "ac" / "ac_ref" (progressive)."""
    pos = 0
    preds = [0] * len(comps)
    zz = _ZZ
    if kind == "seq":
        for ci, base in blocks:
            coef = comps[ci].coefs
            dlut, alut = dc_luts[ci], ac_luts[ci]
            e = _code(dlut, win, pos)
            pos += e >> 8
            s = e & 15
            if s:
                v = win[pos] >> (32 - s)
                pos += s
                if v < 1 << (s - 1):
                    v += 1 - (1 << s)
                preds[ci] += v
            coef[base] = preds[ci]
            k = 1
            while k < 64:
                e = alut[win[pos] >> 16]
                if not e:
                    raise ValueError("corrupt JPEG data: bad Huffman code")
                pos += e >> 8
                s = e & 15
                if s:
                    k += (e >> 4) & 15
                    v = win[pos] >> (32 - s)
                    pos += s
                    if v < 1 << (s - 1):
                        v += 1 - (1 << s)
                    coef[base + zz[k]] = v
                    k += 1
                elif e & 255 == 0xF0:
                    k += 16
                else:
                    break
        return pos
    if kind == "dc":
        for ci, base in blocks:
            e = _code(dc_luts[ci], win, pos)
            pos += e >> 8
            s = e & 15
            if s:
                v = win[pos] >> (32 - s)
                pos += s
                if v < 1 << (s - 1):
                    v += 1 - (1 << s)
                preds[ci] += v
            comps[ci].coefs[base] = preds[ci] << al
        return pos
    if kind == "dc_ref":
        p1 = 1 << al
        for ci, base in blocks:
            if win[pos] >> 31:
                comps[ci].coefs[base] |= p1
            pos += 1
        return pos
    eobrun = 0
    if kind == "ac":
        for ci, base in blocks:
            if eobrun:
                eobrun -= 1
                continue
            coef, alut = comps[ci].coefs, ac_luts[ci]
            k = ss
            while k <= se:
                e = _code(alut, win, pos)
                pos += e >> 8
                r, s = (e >> 4) & 15, e & 15
                if s:
                    k += r
                    v = win[pos] >> (32 - s)
                    pos += s
                    if v < 1 << (s - 1):
                        v += 1 - (1 << s)
                    coef[base + zz[k]] = v << al
                elif r == 15:
                    k += 15
                else:
                    eobrun = 1 << r
                    if r:
                        eobrun += win[pos] >> (32 - r)
                        pos += r
                    eobrun -= 1
                    break
                k += 1
        return pos
    # "ac_ref": jdphuff.c decode_mcu_AC_refine
    p1, m1 = 1 << al, -1 << al
    for ci, base in blocks:
        coef, alut = comps[ci].coefs, ac_luts[ci]
        k = ss
        if eobrun == 0:
            while k <= se:
                e = _code(alut, win, pos)
                pos += e >> 8
                r, s = (e >> 4) & 15, e & 15
                if s:
                    s = p1 if win[pos] >> 31 else m1
                    pos += 1
                elif r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += win[pos] >> (32 - r)
                        pos += r
                    break
                while k <= se:
                    at = base + zz[k]
                    c = coef[at]
                    if c:
                        if win[pos] >> 31 and not c & p1:
                            coef[at] = c + p1 if c >= 0 else c + m1
                        pos += 1
                    else:
                        if r == 0:
                            break
                        r -= 1
                    k += 1
                if s:
                    coef[base + zz[k]] = s
                k += 1
        if eobrun > 0:
            while k <= se:
                at = base + zz[k]
                c = coef[at]
                if c:
                    if win[pos] >> 31 and not c & p1:
                        coef[at] = c + p1 if c >= 0 else c + m1
                    pos += 1
                k += 1
            eobrun -= 1
    return pos


def _split_scan(data: bytes, pos: int):
    """The entropy-coded data from `pos`: (unstuffed segments split at RST
    markers, offset of the marker that ends the scan)."""
    segments, start = [], pos
    n = len(data)
    while True:
        i = data.find(b"\xff", pos)
        if i < 0 or i + 1 >= n:
            raise ValueError("truncated JPEG file: the scan data has no end")
        nxt = data[i + 1]
        if nxt == 0x00:
            pos = i + 2
            continue
        if nxt == 0xFF:           # fill byte before a marker
            pos = i + 1
            continue
        segments.append(data[start:i].replace(b"\xff\x00", b"\xff"))
        if 0xD0 <= nxt <= 0xD7:
            start = pos = i + 2
            continue
        return segments, i


def _scan_blocks(comps, scomps, mcux, mcuy):
    """[(component, block offset)] of a scan in its MCU order: interleaved
    scans walk the MCU grid, a one-component scan the component's own
    blocks (jdcoefct.c / jdphuff.c)."""
    out = []
    if len(scomps) == 1:
        c = comps[scomps[0]]
        for by in range(c.hib):
            row = by * c.nbx
            out.extend((scomps[0], (row + bx) * 64) for bx in range(c.wib))
        return out
    for my in range(mcuy):
        for mx in range(mcux):
            for ci in scomps:
                c = comps[ci]
                for by in range(c.v):
                    row = (my * c.v + by) * c.nbx + mx * c.h
                    out.extend((ci, (row + bx) * 64) for bx in range(c.h))
    return out


#: the most bytes one block's codes can take in any kind of scan
_MAX_BLOCK_BYTES = 512
#: the pixels converted at a time after the IDCT: a band of whole rows
_BAND_PIXELS = 1 << 20
#: the blocks put through the IDCT at a time
_IDCT_BLOCKS = 1 << 15


def _idct_plane(c: _Component, qt: np.ndarray) -> np.ndarray:
    """A component's coefficients → its uint8 samples over the padded block
    grid (nby·8, nbx·8), the IDCT run over bands of block rows."""
    coef = np.frombuffer(c.coefs, np.int16).reshape(c.nby, c.nbx, 64)
    plane = np.empty((c.nby * 8, c.nbx * 8), np.uint8)
    rows = max(1, _IDCT_BLOCKS // c.nbx)
    for r in range(0, c.nby, rows):
        blocks = idct_islow(coef[r:r + rows].reshape(-1, 64), qt).reshape(-1, c.nbx, 8, 8)
        plane[r * 8:(r + len(blocks)) * 8] = blocks.transpose(0, 2, 1, 3).reshape(-1, c.nbx * 8)
    return plane


def _info_dpi(info: dict) -> None:
    """Pillow's dpi from the EXIF resolution when the JFIF header gave none
    (72 × 72 when the EXIF block has none either)."""
    if "dpi" in info or "exif" not in info:
        return
    try:
        ifd0, _ = exif_util.read_exif_tags(info["exif"])
        order = ">" if info["exif"][6:8] == b"MM" else "<"
        unit = struct.unpack(order + "H", ifd0[0x0128][1][:2])[0]
        num, den = struct.unpack(order + "II", ifd0[0x011A][1][:8])
        dpi = num / den
        if dpi != dpi:
            raise ValueError("DPI is not a number")
        if unit == 3:
            dpi *= 2.54
        info["dpi"] = (dpi, dpi)
    except (KeyError, ValueError, ZeroDivisionError, struct.error):
        info["dpi"] = (72, 72)


def decode_jpeg(data: bytes, ycc: bool | None = None,
                raw_planes: bool = False) -> tuple[np.ndarray, dict]:
    """JPEG bytes → (uint8 (H, W, 1) grey or (H, W, 3) RGB, info): info holds
    what Pillow's JPEG reader puts in ``img.info`` (jfif, jfif_version,
    jfif_unit, jfif_density, dpi, exif — the APP1 payload with its
    ``Exif\\0\\0`` header —, adobe, adobe_transform, progressive,
    progression, comment).  `ycc` overrides libjpeg's guess of a
    three-component stream's colour space (libtiff sets it from the TIFF's
    photometric interpretation).  With `raw_planes`, a list of each
    component's samples at its own resolution (libjpeg's raw data output)
    stands in for the image."""
    if not data.startswith(b"\xff\xd8"):
        raise ValueError("not a JPEG file")
    info: dict = {}
    qtables: dict = {}
    dc_tables: dict = {}
    ac_tables: dict = {}
    comps: list = []
    progressive = None
    restart = 0
    width = height = 0
    saw_jfif = saw_adobe = False
    adobe_transform = None
    done = False
    pos, n = 2, len(data)
    while pos < n:
        if data[pos] != 0xFF:
            pos += 1                           # garbage between markers
            continue
        marker = data[pos + 1] if pos + 1 < n else None
        if marker is None:
            break
        if marker == 0xFF:
            pos += 1
            continue
        if marker == 0xD9:
            done = True
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            pos += 2
            continue
        if pos + 4 > n:
            break
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        seg = data[pos + 4:pos + 2 + length]
        if len(seg) < length - 2:
            break
        pos += 2 + length
        if marker == 0xE0 and seg[:4] == b"JFIF":
            saw_jfif = True
            info["jfif"] = version = struct.unpack(">H", seg[5:7])[0]
            info["jfif_version"] = divmod(version, 256)
            if len(seg) >= 12:
                unit = seg[7]
                density = struct.unpack(">HH", seg[8:12])
                if unit == 1:
                    info["dpi"] = density
                elif unit == 2:
                    info["dpi"] = tuple(d * 2.54 for d in density)
                info["jfif_unit"] = unit
                info["jfif_density"] = density
        elif marker == 0xE1 and seg[:6] == b"Exif\x00\x00":
            info["exif"] = info["exif"] + seg[6:] if "exif" in info else seg
        elif marker == 0xEE and seg[:5] == b"Adobe":
            saw_adobe = True
            info["adobe"] = struct.unpack(">H", seg[5:7])[0]
            if len(seg) > 11:
                info["adobe_transform"] = adobe_transform = seg[11]
        elif marker == 0xFE:
            info["comment"] = seg
        elif marker == 0xDB:
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                if pq:
                    qtables[tq] = np.frombuffer(seg[i + 1:i + 129], ">u2").astype(np.int64)
                    i += 129
                else:
                    qtables[tq] = np.frombuffer(seg[i + 1:i + 65], np.uint8).astype(np.int64)
                    i += 65
        elif marker == 0xC4:
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = seg[i + 1:i + 17]
                total = sum(counts)
                lut = _huffman_lut(counts, seg[i + 17:i + 17 + total])
                (ac_tables if tc else dc_tables)[th] = lut
                i += 17 + total
        elif marker == 0xDD:
            (restart,) = struct.unpack(">H", seg[:2])
        elif marker in _SOF_REFUSED:
            raise ValueError(f"{_SOF_REFUSED[marker]} JPEG files are not supported")
        elif marker in _SOF_HUFFMAN:
            progressive = _SOF_HUFFMAN[marker]
            if progressive:
                info["progressive"] = info["progression"] = 1
            precision, height, width, nc = struct.unpack(">BHHB", seg[:6])
            if precision != 8:
                raise ValueError(f"{precision}-bit JPEG samples are not supported (8-bit only)")
            if height == 0 or width == 0:
                raise ValueError("JPEG without a frame size")
            check_image_size(width, height)
            if nc not in (1, 3):
                raise ValueError(f"{nc}-component (CMYK/YCCK) JPEG files are not supported")
            for c in range(nc):
                cid, hv, tq = seg[6 + 3 * c:9 + 3 * c]
                if not (1 <= hv >> 4 <= 2 and 1 <= hv & 15 <= 2):
                    raise ValueError(f"JPEG sampling factors {hv >> 4}x{hv & 15} are not "
                                     "supported (1 or 2 only)")
                comps.append(_Component(cid, hv >> 4, hv & 15, tq))
            hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
            mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
            if nc == 1:        # a lone component is never interleaved
                mcux, mcuy = -(-width // 8), -(-height // 8)
                comps[0].h = comps[0].v = hmax = vmax = 1
            for c in comps:
                c.dw = -(-width * c.h // hmax)
                c.dh = -(-height * c.v // vmax)
                c.wib, c.hib = -(-c.dw // 8), -(-c.dh // 8)
                c.nbx, c.nby = mcux * c.h, mcuy * c.v
                c.coefs = array.array("h", [0]) * (c.nbx * c.nby * 64)
        elif marker == 0xDA:
            if progressive is None:
                raise ValueError("JPEG scan before its frame header")
            ns = seg[0]
            scomps = []
            for j in range(ns):
                cid, t = seg[1 + 2 * j], seg[2 + 2 * j]
                ci = next((i for i, c in enumerate(comps) if c.cid == cid), None)
                if ci is None:
                    raise ValueError(f"JPEG scan names unknown component {cid}")
                comps[ci].td, comps[ci].ta = t >> 4, t & 15
                scomps.append(ci)
            ss, se, a = seg[1 + 2 * ns:4 + 2 * ns]
            ah, al = a >> 4, a & 15
            if not progressive:
                kind = "seq"
            elif ss == 0:
                kind = "dc_ref" if ah else "dc"
            else:
                kind = "ac_ref" if ah else "ac"
            try:
                dc_luts = {ci: dc_tables[comps[ci].td] for ci in scomps
                           if kind in ("seq", "dc")}
                ac_luts = {ci: ac_tables[comps[ci].ta] for ci in scomps
                           if kind in ("seq", "ac", "ac_ref")}
            except KeyError as e:
                raise ValueError(f"JPEG scan uses undefined Huffman table {e}") from e
            blocks = _scan_blocks(comps, scomps, mcux, mcuy)
            units = 1 if len(scomps) == 1 else sum(comps[ci].h * comps[ci].v for ci in scomps)
            step = restart * units if restart else len(blocks)
            segments, pos = _split_scan(data, pos)
            chunks = [blocks[i:i + step] for i in range(0, len(blocks), step)] or [[]]
            if len(segments) < len(chunks):
                raise ValueError("truncated JPEG file: missing restart segments")
            for chunk, segment in zip(chunks, segments):
                # no block takes more than 64 codes of 16 bits and their 15
                # value bits, and the refinement bits: bytes past that bound
                # are never read
                win = _windows(segment[:_MAX_BLOCK_BYTES * len(chunk) + 8])
                try:
                    _decode_segment(kind, win, comps, chunk, ss, se, al, dc_luts, ac_luts)
                except IndexError as e:
                    raise ValueError("truncated JPEG file: a scan ran past its data") from e
                except OverflowError as e:
                    raise ValueError("corrupt JPEG data: a coefficient out of range") from e
    if not done:
        raise ValueError("truncated JPEG file (no end-of-image marker)")
    _info_dpi(info)
    if not comps:
        raise ValueError("JPEG without a frame")
    hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
    planes = []
    for c in comps:
        if c.tq not in qtables:
            raise ValueError(f"JPEG component uses undefined quantisation table {c.tq}")
        qt = np.empty(64, np.int64)
        qt[ZIGZAG] = qtables[c.tq]
        planes.append(_idct_plane(c, qt))
    if raw_planes:
        return [p[:c.dh, :c.dw] for c, p in zip(comps, planes)], info
    # jdapimin.c: JFIF means YCbCr; else an Adobe marker's transform, else
    # the component ids "R", "G", "B" mean RGB
    if ycc is None:
        ycc = saw_jfif or not (adobe_transform == 0 if saw_adobe else
                               [c.cid for c in comps] == [82, 71, 66])
    ycc = ycc and len(comps) == 3
    out = np.empty((height, width, len(comps)), np.uint8)
    step = max(2, (_BAND_PIXELS // width) & ~1)
    for y0 in range(0, height, step):
        y1 = min(y0 + step, height)
        band = []
        for c, plane in zip(comps, planes):
            fx, fy = hmax // c.h, vmax // c.v
            full = _upsample(plane, c.dw, c.dh, fx, fy, y0 // fy, -(-y1 // fy))
            band.append(full[:y1 - y0, :width])
        out[y0:y1] = ycc_to_rgb(*band) if ycc else np.stack(band, axis=-1)
    return out, info


def decode_jpeg_rgb(data: bytes) -> np.ndarray:
    """JPEG bytes → uint8 (H, W, 3), as Pillow's ``convert("RGB")``."""
    image, _ = decode_jpeg(data)
    return np.repeat(image, 3, axis=2) if image.shape[2] == 1 else image


# --------------------------------------------------------------------------
# encoding
# --------------------------------------------------------------------------

def _huffman_codes(counts: bytes, symbols: bytes):
    """(codes, lengths) indexed by symbol, canonical assignment."""
    codes = np.zeros(256, np.int64)
    lengths = np.zeros(256, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            codes[symbols[k]], lengths[symbols[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return codes, lengths


_TABLES = None


def _std_tables():
    global _TABLES
    if _TABLES is None:
        _TABLES = {k: _huffman_codes(*v) for k, v in STD_HUFFMAN.items()}
    return _TABLES


def _nbits(x: np.ndarray) -> np.ndarray:
    """Bit length of non-negative integers (< 2**16)."""
    return np.searchsorted(1 << np.arange(17, dtype=np.int64), x, side="right")


def _marker(code: int, payload: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, code, len(payload) + 2) + payload


def _padded(plane: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """Edges replicated to rows × cols (expand_right_edge /
    expand_bottom_edge)."""
    return np.pad(plane, ((0, rows - plane.shape[0]), (0, cols - plane.shape[1])), mode="edge")


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(8·by, 8·bx) → (by, bx, 8, 8)."""
    by, bx = plane.shape[0] // 8, plane.shape[1] // 8
    return plane.reshape(by, 8, bx, 8).transpose(0, 2, 1, 3)


def _component_coefs(plane: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """A padded component plane → (by, bx, 64) quantised coefficients in
    natural order."""
    b = _blocks(plane)
    by, bx = b.shape[:2]
    coefs = fdct_islow(b.reshape(-1, 8, 8)).reshape(-1, 64)
    return quantize(coefs, qtable).reshape(by, bx, 64)


def _mcu_grid(coefs: np.ndarray, wib: int, hib: int, h: int, v: int, mcux: int, mcuy: int):
    """The component's blocks over the whole MCU grid, with jccoefct.c's
    dummy blocks: past the right edge each takes its left neighbour's DC,
    a row below the bottom the DC of the block before it in the MCU."""
    grid = np.zeros((mcuy * v, mcux * h, 64), np.int64)
    grid[:hib, :wib] = coefs[:hib, :wib]
    for bx in range(wib, mcux * h):
        if bx % h:
            grid[:hib, bx, 0] = grid[:hib, bx - 1, 0]
    for by in range(hib, mcuy * v):
        if by % v:
            last = grid[by - 1, h - 1::h, 0]
            grid[by, :, 0] = np.repeat(last, h)
    return grid


def _entropy_code(blocks: np.ndarray, tables: np.ndarray, comp: np.ndarray) -> bytes:
    """Huffman-code (N, 64) quantised blocks (natural order) in scan order;
    tables[i] ∈ {0, 1} picks the luminance or chrominance tables, comp[i]
    the DC predictor.  Returns the byte-stuffed scan with its last byte
    padded with 1 bits (jchuff.c)."""
    std = _std_tables()
    dc_codes = np.stack([std["dc_luminance"][0], std["dc_chrominance"][0]])
    dc_lens = np.stack([std["dc_luminance"][1], std["dc_chrominance"][1]])
    ac_codes = np.stack([std["ac_luminance"][0], std["ac_chrominance"][0]])
    ac_lens = np.stack([std["ac_luminance"][1], std["ac_chrominance"][1]])
    z = blocks[:, ZIGZAG]
    n = z.shape[0]
    dc = z[:, 0]
    diff = np.empty(n, np.int64)
    for c in np.unique(comp):
        sel = np.nonzero(comp == c)[0]
        diff[sel] = np.diff(dc[sel], prepend=0)

    def magnitude(v):
        size = _nbits(np.abs(v))
        bits = np.where(v < 0, v - 1, v) & ((1 << size) - 1)
        return size, bits

    keys, vals, lens = [], [], []
    size, bits = magnitude(diff)
    keys.append(np.arange(n, dtype=np.int64) * 260)
    vals.append((dc_codes[tables, size] << size) | bits)
    lens.append(dc_lens[tables, size] + size)
    b, k = np.nonzero(z[:, 1:])
    k = k + 1
    if len(b):
        first = np.ones(len(b), bool)
        first[1:] = b[1:] != b[:-1]
        prev = np.where(first, 0, np.concatenate([[0], k[:-1]]))
        run = k - prev - 1
        v = z[b, k]
        size, bits = magnitude(v)
        t = tables[b]
        sym = ((run & 15) << 4) | size
        keys.append(b * 260 + k * 4 + 3)
        vals.append((ac_codes[t, sym] << size) | bits)
        lens.append(ac_lens[t, sym] + size)
        zrl = run >> 4
        for i in range(3):
            sel = zrl > i
            if sel.any():
                keys.append(b[sel] * 260 + k[sel] * 4 + i)
                vals.append(ac_codes[t[sel], 0xF0])
                lens.append(ac_lens[t[sel], 0xF0])
    last = np.zeros(n, np.int64)
    np.maximum.at(last, b, k)            # the last nonzero position per block
    eob = np.nonzero(last < 63)[0]
    keys.append(eob * 260 + 256)
    vals.append(ac_codes[tables[eob], 0x00])
    lens.append(ac_lens[tables[eob], 0x00])
    keys, vals, lens = (np.concatenate(x) for x in (keys, vals, lens))
    order = np.argsort(keys, kind="stable")
    vals, lens = vals[order], lens[order]
    total = int(lens.sum())
    event = np.repeat(np.arange(len(lens), dtype=np.int32), lens)
    ends = np.cumsum(lens)
    shift = np.repeat(ends, lens) - 1 - np.arange(total, dtype=np.int64)
    bitstream = ((vals[event] >> shift) & 1).astype(np.uint8)
    pad = (-total) % 8
    packed = np.packbits(np.concatenate([bitstream, np.ones(pad, np.uint8)]))
    ff = np.nonzero(packed == 0xFF)[0]
    return np.insert(packed, ff + 1, 0).tobytes()


def _h2v2_downsample(plane: np.ndarray) -> np.ndarray:
    """jcsample.c h2v2_downsample: the mean of each 2×2, biased 1, 2, 1, 2
    along a row."""
    p = plane.astype(np.int64)
    bias = 1 + (np.arange(p.shape[1] // 2, dtype=np.int64) & 1)
    return ((p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2] + bias)
            >> 2).astype(np.uint8)


def _headers(quality: int, exif: bytes | None, tables: int):
    """SOI, Pillow's JFIF APP0, the EXIF APP1 and the first `tables` of the
    luminance and chrominance quantisation tables; returns (those segments,
    both tables in natural order)."""
    qts = [scaled_table(STD_LUMINANCE_QT, quality), scaled_table(STD_CHROMINANCE_QT, quality)]
    out = [b"\xff\xd8", _marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    if exif:
        if len(exif) > 65533:
            raise ValueError("EXIF data is too long")
        out.append(_marker(0xE1, exif))
    for i in range(tables):
        out.append(_marker(0xDB, bytes([i]) + qts[i][ZIGZAG].astype(np.uint8).tobytes()))
    return out, qts


def _checked(image) -> np.ndarray:
    """An image the encoder takes: uint8 (H, W, 3) or (H, W), sides 1..65535."""
    image = np.asarray(image)
    if image.ndim == 3 and image.shape[2] == 1:
        image = image[:, :, 0]
    if image.dtype != np.uint8 or image.ndim not in (2, 3) or \
            (image.ndim == 3 and image.shape[2] != 3):
        raise ValueError(f"expected uint8 (H, W[, 1|3]), got {image.dtype} {image.shape}")
    height, width = image.shape[:2]
    if not (0 < height <= 65535 and 0 < width <= 65535):
        raise ValueError(f"JPEG sides are 1..65535, got {width}x{height}")
    return image


def encode_jpeg(image: np.ndarray, quality: int = 80, exif: bytes | None = None) -> bytes:
    """uint8 (H, W, 3) RGB, or grey (H, W) / (H, W, 1) → baseline JPEG bytes
    as Pillow writes them with ``quality`` and its default 4:2:0 (and
    ``exif``, an APP1 payload such as ``exif.build_exif_bytes`` makes)."""
    image = _checked(image)
    if image.ndim == 3:
        return _encode_ycc(image, quality, exif, (2, 2), _h2v2_downsample)
    height, width = image.shape
    out, (lum, _) = _headers(quality, exif, 1)
    wib, hib = -(-width // 8), -(-height // 8)
    coefs = _component_coefs(_padded(image, hib * 8, wib * 8), lum).reshape(-1, 64)
    out.append(_marker(0xC0, struct.pack(">BHHB", 8, height, width, 1) + b"\x01\x11\x00"))
    for tc, name in ((0x00, "dc_luminance"), (0x10, "ac_luminance")):
        out.append(_marker(0xC4, bytes([tc]) + b"".join(STD_HUFFMAN[name])))
    out.append(_marker(0xDA, b"\x01\x01\x00\x00\x3f\x00"))
    nb = len(coefs)
    out.append(_entropy_code(coefs, np.zeros(nb, np.int64), np.zeros(nb, np.int64)))
    out.append(b"\xff\xd9")
    return b"".join(out)


def _encode_ycc(image: np.ndarray, quality: int, exif: bytes | None, factors: tuple,
                downsample) -> bytes:
    """An RGB image → YCbCr JPEG bytes, the luma sampled `factors` = (h, v)
    times as densely as the chroma, which `downsample` reduces from the
    padded plane (encode_jpeg's 4:2:0: (2, 2) and h2v2_downsample)."""
    height, width = image.shape[:2]
    out, (lum, chrom) = _headers(quality, exif, 2)
    hs, vs = factors
    y, cb, cr = rgb_to_ycc(image)
    mcux, mcuy = -(-width // (8 * hs)), -(-height // (8 * vs))
    # the luma plane: edges replicated to whole blocks and the MCU height;
    # the chroma planes: rows to a multiple of the luma's v, columns to the
    # MCU width, downsampled, then rows to the MCU height (jcprepct.c
    # pre_process_data, jcsample.c)
    wib, hib = -(-width // 8), -(-height // 8)
    yplane = _padded(y, mcuy * 8 * vs, wib * 8)
    grids = [_mcu_grid(_component_coefs(yplane, lum), wib, hib, hs, vs, mcux, mcuy)]
    rows = height + (-height) % vs
    for plane in (cb, cr):
        small = downsample(_padded(plane, rows, mcux * 8 * hs))
        grids.append(_component_coefs(_padded(small, mcuy * 8, mcux * 8), chrom))
    # MCU order: the luma blocks row by row, then Cb, then Cr
    yb = grids[0].reshape(mcuy, vs, mcux, hs, 64).transpose(0, 2, 1, 3, 4).reshape(
        mcuy, mcux, vs * hs, 64)
    mcus = np.concatenate([yb, grids[1][:, :, None], grids[2][:, :, None]], axis=2)
    blocks = mcus.reshape(-1, 64)
    comp = np.tile(np.array([0] * (hs * vs) + [1, 2], np.int64), mcux * mcuy)
    tables = np.minimum(comp, 1)
    out.append(_marker(0xC0, struct.pack(">BHHB", 8, height, width, 3)
                       + bytes([1, hs << 4 | vs, 0]) + b"\x02\x11\x01\x03\x11\x01"))
    for tc, name in ((0x00, "dc_luminance"), (0x10, "ac_luminance"),
                     (0x01, "dc_chrominance"), (0x11, "ac_chrominance")):
        out.append(_marker(0xC4, bytes([tc]) + b"".join(STD_HUFFMAN[name])))
    out.append(_marker(0xDA, b"\x03\x01\x00\x02\x11\x03\x11\x00\x3f\x00"))
    out.append(_entropy_code(blocks, tables, comp))
    out.append(b"\xff\xd9")
    return b"".join(out)
