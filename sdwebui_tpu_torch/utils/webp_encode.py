"""WebP encoders: VP8L (lossless) and VP8 (lossy), plain designs that
libwebp and ``utils/vp8l`` / ``utils/vp8`` decode.  Neither gives
libwebp's bytes.

Lossless (``encode_vp8l``): the subtract-green transform and one predictor
(the pixel above, mode 2, on 512-pixel tiles), then one prefix code per
channel built from the residuals' histograms (length-limited to 15 bits)
and written as code lengths under a code-length code; runs of a repeated
residual pixel become LZ77 copies at distance 1.  Vectorised with numpy
but for the runs.

Lossy (``encode_vp8``): libwebp's RGB → YUV 4:2:0 and its mapping of
quality to a quantizer index (one segment, no per-segment tuning); each
macroblock takes the 16×16 luma mode and the chroma mode of least SAD
against its reconstructed neighbours; the forward DCT and WHT of libwebp's
encoder, quantization with libwebp's rounding biases, and the
reconstruction the decoder will make (so that the next macroblock
predicts from the same pixels).  The tokens go out through the boolean
encoder under the default probabilities, with no skip flags, and a
loop-filter level from the quantizer as libwebp sets it at its default
strength.
"""

from __future__ import annotations

import heapq
import struct

import numpy as np

from sdwebui_tpu_torch.utils import vp8
from sdwebui_tpu_torch.utils import vp8_tables as T
from sdwebui_tpu_torch.utils.vp8l import _CODE_LENGTH_ORDER

# --------------------------------------------------------------------------
# bits
# --------------------------------------------------------------------------


def pack_lsb(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """Each value's low `length` bits, LSB first, one after another."""
    values = np.asarray(values, np.uint64)
    lengths = np.asarray(lengths, np.int64)
    keep = lengths > 0
    values, lengths = values[keep], lengths[keep]
    total = int(lengths.sum())
    if not total:
        return b""
    starts = np.cumsum(lengths) - lengths
    idx = np.arange(total) - np.repeat(starts, lengths)
    bits = ((np.repeat(values, lengths) >> idx.astype(np.uint64)) & np.uint64(1)).astype(np.uint8)
    return np.packbits(bits, bitorder="little").tobytes()


def code_lengths(counts, limit: int = 15) -> list:
    """Huffman code lengths of a histogram, at most `limit` bits (counts
    are flattened until the tree fits); unused symbols get 0."""
    counts = np.asarray(counts, np.int64)
    used = np.nonzero(counts)[0]
    lengths = [0] * len(counts)
    if len(used) == 0:
        return lengths
    if len(used) == 1:
        lengths[int(used[0])] = 1
        return lengths
    c = counts.copy()
    while True:
        heap = [(int(c[s]), int(s), None) for s in used]
        heapq.heapify(heap)
        tie = len(counts)
        while len(heap) > 1:
            a = heapq.heappop(heap)
            b = heapq.heappop(heap)
            heapq.heappush(heap, (a[0] + b[0], tie, (a, b)))
            tie += 1
        depth = {}
        stack = [(heap[0], 0)]
        while stack:
            node, d = stack.pop()
            if node[2] is None:
                depth[node[1]] = d
            else:
                stack += [(node[2][0], d + 1), (node[2][1], d + 1)]
        if max(depth.values()) <= limit:
            for s, d in depth.items():
                lengths[s] = d
            return lengths
        c = (c >> 1) | (c > 0)


def canonical_codes(lengths) -> list:
    """Canonical codes of the lengths, bit-reversed for LSB-first writing."""
    max_len = max(lengths) if lengths else 0
    counts = [0] * (max_len + 1)
    for n in lengths:
        if n:
            counts[n] += 1
    code, next_code = 0, [0] * (max_len + 1)
    for n in range(1, max_len + 1):
        code = (code + counts[n - 1]) << 1 if n > 1 else 0
        next_code[n] = code
    out = [0] * len(lengths)
    for s, n in enumerate(lengths):
        if n:
            out[s] = int(format(next_code[n], f"0{n}b")[::-1], 2)
            next_code[n] += 1
    return out


# --------------------------------------------------------------------------
# VP8L
# --------------------------------------------------------------------------


def _prefix(values: np.ndarray):
    """Length / distance values (>= 1) → (symbol, extra bits, extra value)."""
    v = np.asarray(values, np.int64)
    x = v - 1
    h = np.where(x > 0, np.floor(np.log2(np.maximum(x, 1))).astype(np.int64), 0)
    big = v > 4
    second = np.where(big, (x >> np.maximum(h - 1, 0)) & 1, 0)
    symbol = np.where(big, 2 * h + second, x)
    nbits = np.where(big, h - 1, 0)
    extra = np.where(big, x & ((1 << nbits) - 1), 0)
    return symbol, nbits, extra


def _write_code(lengths: list, parts: list) -> list:
    """Append the bits that describe one prefix code to `parts` ((value,
    nbits) pairs) → the codes to write its symbols with."""
    used = [s for s, n in enumerate(lengths) if n]
    if len(used) <= 2 and all(s < 256 for s in used):   # a simple code
        syms = used or [0]
        parts += [(1, 1), (len(syms) - 1, 1)]
        if syms[0] < 2:
            parts += [(0, 1), (syms[0], 1)]
        else:
            parts += [(1, 1), (syms[0], 8)]
        if len(syms) == 2:
            parts.append((syms[1], 8))
        lengths = [0] * len(lengths)
        for s in syms:
            lengths[s] = 1 if len(syms) == 2 else 0
        return canonical_codes(lengths), lengths
    parts.append((0, 1))
    hist = np.bincount(np.asarray(lengths), minlength=19)
    cl = code_lengths(hist, 7)
    cl_codes = canonical_codes(cl)
    cl_bits = cl if sum(1 for n in cl if n) > 1 else [0] * 19   # one length: a code of no bits
    parts.append((19 - 4, 4))
    for s in _CODE_LENGTH_ORDER:
        parts.append((cl[s], 3))
    parts.append((0, 1))                                 # every symbol's length follows
    for n in lengths:
        parts.append((cl_codes[n], cl_bits[n]))
    if len(used) == 1:                                   # read as a code of no bits
        return [0] * len(lengths), [0] * len(lengths)
    return canonical_codes(lengths), lengths


def _sub(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per-channel a − b mod 256 of ARGB words."""
    hi, lo = np.uint32(0xFF00FF00), np.uint32(0x00FF00FF)
    return ((lo + (a & hi) - (b & hi)) & hi) | ((hi + (a & lo) - (b & lo)) & lo)


def _stream(argb: np.ndarray, transforms: bool) -> list:
    """The bits of a VP8L image stream (header excluded) as (value, nbits)
    arrays in order."""
    h, w = argb.shape
    parts: list = []
    data = argb
    if transforms:
        g = (data >> 8) & 255
        data = _sub(data, (g << 16) | g)
        pred = np.empty_like(data)
        pred[1:] = data[:-1]
        pred[0, 1:] = data[0, :-1]
        pred[0, 0] = 0xFF000000
        data = _sub(data, pred)
        bits = 9
        tiles = ((w + 511) >> 9) * ((h + 511) >> 9)
        parts += [(1, 1), (2, 2), (1, 1), (0, 2), (bits - 2, 3)]
        # the predictor's sub-image: every tile mode 2, i.e. green 2
        sub = np.full(tiles, 0x00000200, np.uint32)
        parts += _stream_bits(sub, 1, False)
        parts.append((0, 1))                            # no more transforms
    parts += _stream_bits(data.reshape(-1), w, True)
    return parts


def _stream_bits(pixels: np.ndarray, width: int, level0: bool) -> list:
    """An entropy-coded image: no colour cache, no meta codes, runs of the
    previous pixel as copies at distance 1."""
    parts: list = [(0, 1)]                               # no colour cache
    if level0:
        parts.append((0, 1))                             # no meta prefix codes
    n = len(pixels)
    same = np.zeros(n, bool)
    same[1:] = pixels[1:] == pixels[:-1]
    # runs: positions where same starts a stretch of >= 3
    starts, lengths = [], []
    if same.any():
        edges = np.diff(np.concatenate([[0], same.astype(np.int8), [0]]))
        rs, re_ = np.nonzero(edges == 1)[0], np.nonzero(edges == -1)[0]
        for a, b in zip(rs.tolist(), re_.tolist()):
            pos = a
            while b - pos >= 3:
                k = min(b - pos, 4096)
                starts.append(pos)
                lengths.append(k)
                pos += k
    is_lit = np.ones(n, bool)
    for a, k in zip(starts, lengths):
        is_lit[a:a + k] = False
    lit_pos = np.nonzero(is_lit)[0]
    lit = pixels[lit_pos]
    a = (lit >> 24) & 255
    r = (lit >> 16) & 255
    g = (lit >> 8) & 255
    b = lit & 255
    lsym, lbits, lextra = _prefix(np.asarray(lengths, np.int64)) if lengths else \
        (np.zeros(0, np.int64),) * 3
    green_hist = np.bincount(g.astype(np.int64), minlength=280)
    green_hist[256:280] += np.bincount(lsym, minlength=24)[:24] if len(lsym) else 0
    dist_hist = np.zeros(40, np.int64)
    if lengths:
        dist_hist[1] = len(lengths)                      # distance code 2: the pixel to the left
    hists = [green_hist, np.bincount(r.astype(np.int64), minlength=256),
             np.bincount(b.astype(np.int64), minlength=256),
             np.bincount(a.astype(np.int64), minlength=256), dist_hist]
    codes = []
    for hist in hists:
        lens = code_lengths(hist)
        codes.append(_write_code(lens, parts))
    # the symbols in order: literals (g, r, b, a) and copies (len, extra, dist)
    gc, gl = (np.asarray(x, np.uint64) for x in codes[0])
    rc, rl = (np.asarray(x, np.uint64) for x in codes[1])
    bc, bl = (np.asarray(x, np.uint64) for x in codes[2])
    ac, al = (np.asarray(x, np.uint64) for x in codes[3])
    dc, dl = codes[4]
    order = np.concatenate([lit_pos, np.asarray(starts, np.int64)])
    kind = np.concatenate([np.zeros(len(lit_pos), np.int8), np.ones(len(starts), np.int8)])
    sort = np.argsort(order, kind="stable")
    vals = np.zeros((len(order), 4), np.uint64)
    lens = np.zeros((len(order), 4), np.int64)
    li = np.nonzero(kind[sort] == 0)[0]
    ci = np.nonzero(kind[sort] == 1)[0]
    gi, ri, bi, ai = (x.astype(np.int64) for x in (g, r, b, a))
    vals[li] = np.stack([gc[gi], rc[ri], bc[bi], ac[ai]], 1)
    lens[li] = np.stack([gl[gi], rl[ri], bl[bi], al[ai]], 1).astype(np.int64)
    if len(ci):
        ls = 256 + lsym
        vals[ci, 0] = gc[ls]
        lens[ci, 0] = gl[ls].astype(np.int64)
        vals[ci, 1] = lextra.astype(np.uint64)
        lens[ci, 1] = lbits
        vals[ci, 2] = dc[1]
        lens[ci, 2] = dl[1]
    header = np.array([v for v, _ in parts], np.uint64), np.array([k for _, k in parts], np.int64)
    return [header, (vals.reshape(-1), lens.reshape(-1))]


def _flatten(parts) -> tuple:
    vals, lens = [], []
    for p in parts:
        if isinstance(p, tuple) and isinstance(p[0], np.ndarray):
            vals.append(p[0])
            lens.append(p[1])
        elif isinstance(p, list):
            v, ln = _flatten(p)
            vals.append(v)
            lens.append(ln)
        else:
            vals.append(np.array([p[0]], np.uint64))
            lens.append(np.array([p[1]], np.int64))
    return np.concatenate(vals), np.concatenate(lens)


def _argb(image: np.ndarray) -> np.ndarray:
    a = np.asarray(image, np.uint8)
    if a.ndim == 2:
        a = a[:, :, None]
    if a.shape[2] in (1, 2):
        rgb = np.repeat(a[:, :, :1], 3, 2)
        alpha = a[:, :, 1] if a.shape[2] == 2 else np.full(a.shape[:2], 255, np.uint8)
    else:
        rgb = a[:, :, :3]
        alpha = a[:, :, 3] if a.shape[2] == 4 else np.full(a.shape[:2], 255, np.uint8)
    return ((alpha.astype(np.uint32) << 24) | (rgb[:, :, 0].astype(np.uint32) << 16)
            | (rgb[:, :, 1].astype(np.uint32) << 8) | rgb[:, :, 2].astype(np.uint32))


def encode_vp8l(image: np.ndarray) -> tuple[bytes, bool]:
    """uint8 (H, W[, C]) → (a ``VP8L`` chunk's body, whether it has an
    alpha channel that is not all 255)."""
    argb = _argb(image)
    h, w = argb.shape
    if not (1 <= w <= 16384 and 1 <= h <= 16384):
        raise ValueError(f"a WebP side is at most 16384 pixels, got {w}x{h}")
    alpha = bool((argb >> 24 != 255).any())
    head = [(0x2F, 8), (w - 1, 14), (h - 1, 14), (int(alpha), 1), (0, 3)]
    vals, lens = _flatten(head + _stream(argb, True))
    return pack_lsb(vals, lens), alpha


def encode_alpha_stream(alpha: np.ndarray) -> bytes:
    """An (H, W) uint8 alpha plane → the header-less VP8L stream of an ALPH
    chunk (compression 1, no filter): the values in the green channel."""
    argb = (np.uint32(0xFF000000) | (alpha.astype(np.uint32) << 8)).astype(np.uint32)
    vals, lens = _flatten(_stream(argb, True))
    return pack_lsb(vals, lens)


# --------------------------------------------------------------------------
# VP8
# --------------------------------------------------------------------------


class BoolEncoder:
    """RFC 6386's boolean encoder (section 7.3)."""

    def __init__(self):
        self.out = bytearray()
        self.range = 255
        self.bottom = 0
        self.count = 24

    def put(self, bit: int, prob: int) -> int:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & 0x80000000:
                out = self.out
                i = len(out) - 1
                while out[i] == 255:
                    out[i] = 0
                    i -= 1
                out[i] += 1
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.count -= 1
            if self.count == 0:
                self.out.append(self.bottom >> 24)
                self.bottom &= 0xFFFFFF
                self.count = 8
        return bit

    def value(self, v: int, bits: int):
        for i in range(bits - 1, -1, -1):
            self.put((v >> i) & 1, 128)

    def finish(self) -> bytes:
        for _ in range(32):
            self.put(0, 128)
        return bytes(self.out)


def quality_to_q(quality: float) -> int:
    """libwebp's mapping of quality (0..100) to a quantizer index at one
    segment: 127 · (1 − c), c = linear_c ** (1/3)."""
    c = max(0.0, min(100.0, float(quality))) / 100.0
    linear = c * 2.0 / 3.0 if c < 0.75 else 2.0 * c - 1.0
    return int(127.0 * (1.0 - linear ** (1.0 / 3.0)))


def _filter_level(q: int) -> int:
    """The loop-filter level libwebp gives one segment at its default
    strength (60) and sharpness 0."""
    qstep = T.AC_TABLE[q] >> 2
    levels = _levels_from_delta(qstep)
    return min(63, levels * 300 // 256) if levels * 300 // 256 >= 2 else 0


def _levels_from_delta(delta: int) -> int:
    # libwebp's kLevelsFromDelta[0]: the smallest level whose filter limit
    # (2·level + interior) reaches the step
    for level in range(64):
        if 2 * level + max(1, level) >= 2 * delta + 1:
            return level
    return 63


def rgb_to_yuv420(rgb: np.ndarray):
    """libwebp's RGB → Y (16-bit fixed point) and U, V from each 2×2 sum,
    the image padded by replication to whole macroblocks."""
    h, w = rgb.shape[:2]
    H, W = (h + 15) & ~15, (w + 15) & ~15
    p = np.pad(rgb, ((0, H - h), (0, W - w), (0, 0)), mode="edge").astype(np.int64)
    r, g, b = p[..., 0], p[..., 1], p[..., 2]
    y = (16839 * r + 33059 * g + 6420 * b + (16 << 16) + (1 << 15)) >> 16
    rs = r.reshape(H // 2, 2, W // 2, 2).sum((1, 3))
    gs = g.reshape(H // 2, 2, W // 2, 2).sum((1, 3))
    bs = b.reshape(H // 2, 2, W // 2, 2).sum((1, 3))
    half = (1 << 15) << 2

    def uv(v):
        return np.clip((v + half + (128 << 18)) >> 18, 0, 255)

    u = uv(-9719 * rs - 19081 * gs + 28800 * bs)
    v = uv(28800 * rs - 24116 * gs - 4684 * bs)
    return y.astype(np.int32), u.astype(np.int32), v.astype(np.int32)


def fdct(blocks: np.ndarray) -> np.ndarray:
    """(N, 4, 4) residuals → (N, 16) coefficients, libwebp's FTransform."""
    d = blocks.astype(np.int64)
    d0, d1, d2, d3 = d[:, :, 0], d[:, :, 1], d[:, :, 2], d[:, :, 3]   # (N, rows)
    a0, a1, a2, a3 = d0 + d3, d1 + d2, d1 - d2, d0 - d3
    t0 = (a0 + a1) * 8
    t1 = (a2 * 2217 + a3 * 5352 + 1812) >> 9
    t2 = (a0 - a1) * 8
    t3 = (a3 * 2217 - a2 * 5352 + 937) >> 9
    tmp = np.stack([t0, t1, t2, t3], 2)                 # [n][row][k]
    r0, r1, r2, r3 = tmp[:, 0], tmp[:, 1], tmp[:, 2], tmp[:, 3]   # (N, k)
    a0, a1, a2, a3 = r0 + r3, r1 + r2, r1 - r2, r0 - r3
    o0 = (a0 + a1 + 7) >> 4
    o1 = ((a2 * 2217 + a3 * 5352 + 12000) >> 16) + (a3 != 0)
    o2 = (a0 - a1 + 7) >> 4
    o3 = (a3 * 2217 - a2 * 5352 + 51000) >> 16
    return np.stack([o0, o1, o2, o3], 1).reshape(-1, 16)   # [n][row o][col k]


def fwht(dcs: np.ndarray) -> np.ndarray:
    """16 luma DCs (raster order of the blocks) → the Y2 coefficients,
    libwebp's FTransformWHT."""
    d = dcs.astype(np.int64).reshape(4, 4)
    a0, a1, a2, a3 = d[:, 0] + d[:, 2], d[:, 1] + d[:, 3], d[:, 1] - d[:, 3], d[:, 0] - d[:, 2]
    tmp = np.stack([a0 + a1, a3 + a2, a3 - a2, a0 - a1], 1)   # [row][k]
    t0, t1, t2, t3 = tmp[0], tmp[1], tmp[2], tmp[3]
    a0, a1, a2, a3 = t0 + t2, t1 + t3, t1 - t3, t0 - t2
    return (np.stack([a0 + a1, a3 + a2, a3 - a2, a0 - a1], 0) >> 1).reshape(16)


def _quantize(coeffs: np.ndarray, dq: tuple, bias: tuple) -> np.ndarray:
    """Levels of (N, 16) coefficients: |c| / q + bias, truncated, signed."""
    q = np.full(16, dq[1], np.float64)
    q[0] = dq[0]
    b = np.full(16, bias[1])
    b[0] = bias[0]
    lv = np.floor(np.abs(coeffs) / q + b).astype(np.int64)
    return np.sign(coeffs) * np.minimum(lv, 2047)


_ZZ = np.array(vp8.ZIGZAG)


def _put_coeffs(bw: BoolEncoder, prob, ctx: int, levels_zz, first: int) -> int:
    """One block's tokens (libwebp's PutCoeffs) → 1 if it has a non-zero
    level at or after `first`."""
    put = bw.put
    last = -1
    for i in range(15, first - 1, -1):
        if levels_zz[i]:
            last = i
            break
    n = first
    p = prob[n][ctx]
    if not put(int(last >= 0), p[0]):
        return 0
    while n < 16:
        c = levels_zz[n]
        n += 1
        v = -c if c < 0 else c
        if not put(int(v != 0), p[1]):
            p = prob[n][0]
            continue
        if not put(int(v > 1), p[2]):
            p = prob[n][1]
        else:
            if not put(int(v > 4), p[3]):
                if put(int(v != 2), p[4]):
                    put(int(v == 4), p[5])
            elif not put(int(v > 10), p[6]):
                if not put(int(v > 6), p[7]):
                    put(int(v == 6), 159)
                else:
                    put(int(v >= 9), 165)
                    put(int(not v & 1), 145)
            else:
                if v < 3 + (8 << 1):
                    put(0, p[8])
                    put(0, p[9])
                    v -= 3 + 8
                    cat = 0
                elif v < 3 + (8 << 2):
                    put(0, p[8])
                    put(1, p[9])
                    v -= 3 + (8 << 1)
                    cat = 1
                elif v < 3 + (8 << 3):
                    put(1, p[8])
                    put(0, p[10])
                    v -= 3 + (8 << 2)
                    cat = 2
                else:
                    put(1, p[8])
                    put(1, p[10])
                    v -= 3 + (8 << 3)
                    cat = 3
                tab = vp8.CAT3456[cat]
                for k, prob_k in enumerate(tab):
                    put((v >> (len(tab) - 1 - k)) & 1, prob_k)
            p = prob[n][2]
        put(int(c < 0), 128)
        if n == 16 or not put(int(n <= last), p[0]):
            return 1
    return 1


def _luma_16x16(src, pred, y1, y2, out, tn, left_nz, put_tokens):
    """Code one macroblock's luma with a 16×16 prediction: its Y2 and AC
    tokens written through `put_tokens`, its reconstruction to `out`."""
    blocks = (src - pred).reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 4, 4)
    coeffs = fdct(blocks)
    y2lv = _quantize(fwht(coeffs[:, 0])[None], y2, (96 / 256, 108 / 256))[0]
    ac = coeffs.copy()
    ac[:, 0] = 0
    aclv = _quantize(ac, y1, (96 / 256, 110 / 256))
    aclv[:, 0] = 0
    # the reconstruction, as the decoder makes it
    dcs = vp8._iwht((y2lv * np.array([y2[0]] + [y2[1]] * 15)).tolist())
    deq = aclv * np.array([y1[0]] + [y1[1]] * 15)
    deq[:, 0] = dcs
    res = vp8.idct(deq).reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 16)
    out[...] = np.clip(pred + res, 0, 255)
    nz = put_tokens(1, int(tn[8]) + left_nz[8], y2lv[_ZZ].tolist(), 0)
    tn[8] = left_nz[8] = nz
    zz = aclv[:, _ZZ].tolist()
    for y4 in range(4):
        lnz = left_nz[y4]
        for x4 in range(4):
            lnz = put_tokens(0, lnz + int(tn[x4]), zz[4 * y4 + x4], 1)
            tn[x4] = lnz
        left_nz[y4] = lnz


def _recon_blocks(levels: np.ndarray, dq: tuple) -> np.ndarray:
    deq = levels * np.array([dq[0]] + [dq[1]] * 15)
    return vp8.idct(deq)


def encode_vp8(rgb: np.ndarray, quality: float = 80) -> bytes:
    """uint8 (H, W, 3) RGB → a VP8 key frame (a ``VP8 `` chunk's body)."""
    rgb = np.asarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    if not (1 <= w <= 16383 and 1 <= h <= 16383):
        raise ValueError(f"a lossy WebP side is at most 16383 pixels, got {w}x{h}")
    Ys, Us, Vs = rgb_to_yuv420(rgb)
    mbh, mbw = Ys.shape[0] // 16, Ys.shape[1] // 16
    q = quality_to_q(quality)
    y1 = (T.DC_TABLE[q], T.AC_TABLE[q])
    y2 = (T.DC_TABLE[q] * 2, max((T.AC_TABLE[q] * 101581) >> 16, 8))
    uvq = (T.DC_TABLE[min(q, 117)], T.AC_TABLE[q])
    Y = np.zeros_like(Ys)
    UV = np.zeros((2,) + Us.shape, np.int32)
    src_uv = np.stack([Us, Vs])
    tokens = BoolEncoder()               # the one token partition
    nested = vp8._coeff_probas(T.COEFFS_PROBA0)
    bands = [[nested[t][vp8.BANDS[n]] for n in range(17)] for t in range(4)]

    def put_tokens(t: int, ctx: int, zz: list, first: int) -> int:
        return _put_coeffs(tokens, bands[t], ctx, zz, first)

    ymodes, uvmodes = [], []
    top_nz = np.zeros((mbw, 9), np.int8)
    for my in range(mbh):
        left_nz = [0] * 9
        for mx in range(mbw):
            y0, x0 = my * 16, mx * 16
            top = Y[y0 - 1, x0:x0 + 16] if my else np.full(16, 127, np.int32)
            left = Y[y0:y0 + 16, x0 - 1] if mx else np.full(16, 129, np.int32)
            tl = int(Y[y0 - 1, x0 - 1]) if my and mx else 127 if not my else 129
            src = Ys[y0:y0 + 16, x0:x0 + 16]
            best = None
            for mode in (vp8.DC_PRED, vp8.V_PRED, vp8.H_PRED, vp8.TM_PRED):
                pred = vp8._pred_block(mode, top, left, tl, 16, mx, my)
                sad = int(np.abs(src - pred).sum())
                if best is None or sad < best[0]:
                    best = (sad, mode, pred)
            _, ymode, pred = best
            tn = top_nz[mx]
            ymodes.append(ymode)
            _luma_16x16(src, pred, y1, y2, Y[y0:y0 + 16, x0:x0 + 16], tn, left_nz,
                        put_tokens)
            # chroma
            cy, cx = my * 8, mx * 8
            preds = []
            for ch in range(2):
                P = UV[ch]
                ctop = P[cy - 1, cx:cx + 8] if my else np.full(8, 127, np.int32)
                cleft = P[cy:cy + 8, cx - 1] if mx else np.full(8, 129, np.int32)
                ctl = int(P[cy - 1, cx - 1]) if my and mx else 127 if not my else 129
                preds.append((ctop, cleft, ctl))
            best = None
            for mode in (vp8.DC_PRED, vp8.V_PRED, vp8.H_PRED, vp8.TM_PRED):
                pr = [vp8._pred_block(mode, *preds[ch], 8, mx, my) for ch in range(2)]
                sad = sum(int(np.abs(src_uv[ch, cy:cy + 8, cx:cx + 8] - pr[ch]).sum())
                          for ch in range(2))
                if best is None or sad < best[0]:
                    best = (sad, mode, pr)
            _, uvmode, pr = best
            uvmodes.append(uvmode)
            for ch in range(2):
                blocks = (src_uv[ch, cy:cy + 8, cx:cx + 8] - pr[ch]).reshape(2, 4, 2, 4) \
                    .transpose(0, 2, 1, 3).reshape(4, 4, 4)
                lv = _quantize(fdct(blocks), uvq, (110 / 256, 115 / 256))
                res = _recon_blocks(lv, uvq).reshape(2, 2, 4, 4).transpose(0, 2, 1, 3) \
                    .reshape(8, 8)
                UV[ch, cy:cy + 8, cx:cx + 8] = np.clip(pr[ch] + res, 0, 255)
                zz = lv[:, _ZZ].tolist()
                for y2_ in range(2):
                    lnz = left_nz[4 + 2 * ch + y2_]
                    for x2 in range(2):
                        lnz = put_tokens(2, lnz + int(tn[4 + 2 * ch + x2]), zz[2 * y2_ + x2], 0)
                        tn[4 + 2 * ch + x2] = lnz
                    left_nz[4 + 2 * ch + y2_] = lnz
    # the first partition: the frame header and the modes
    bw = BoolEncoder()
    bw.put(0, 128)                  # colour space
    bw.put(0, 128)                  # clamping
    bw.put(0, 128)                  # no segmentation
    bw.put(0, 128)                  # normal loop filter
    bw.value(_filter_level(q), 6)
    bw.value(0, 3)                  # sharpness
    bw.put(0, 128)                  # no loop-filter deltas
    bw.value(0, 2)                  # one token partition
    bw.value(q, 7)
    for _ in range(5):
        bw.put(0, 128)              # no quantizer deltas
    bw.put(0, 128)                  # refresh entropy probabilities
    for p in T.COEFFS_UPDATE_PROBA:
        bw.put(0, p)                # the default token probabilities
    bw.put(0, 128)                  # no skip flags
    for ymode, uvmode in zip(ymodes, uvmodes):
        bw.put(1, 145)              # 16×16
        if ymode in (vp8.H_PRED, vp8.TM_PRED):
            bw.put(1, 156)
            bw.put(int(ymode == vp8.TM_PRED), 128)
        else:
            bw.put(0, 156)
            bw.put(int(ymode == vp8.V_PRED), 163)
        if bw.put(int(uvmode != vp8.DC_PRED), 142):
            if bw.put(int(uvmode != vp8.V_PRED), 114):
                bw.put(int(uvmode == vp8.TM_PRED), 183)
    part0 = bw.finish()
    frame_tag = (0 | (0 << 1) | (1 << 4) | (len(part0) << 5))
    return (struct.pack("<I", frame_tag)[:3] + b"\x9d\x01\x2a" + struct.pack("<HH", w, h)
            + part0 + tokens.finish())
