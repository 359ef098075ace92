"""EBCOT tier-1 of JPEG 2000 (ISO 15444-1 annex D), decoding and encoding
as OpenJPEG does, one code-block at a time in plain Python (code-blocks are
coded independently; ``utils/mq`` holds the MQ coder).

The state of a coefficient and its eight neighbours is one int word
(``F``; a one-coefficient border round each block):

* bits 0-7: the significance of the NW, N, NE, W, E, SW, S, SE neighbours;
* bit 8: significant, 9: coded in this bit-plane's significance
  propagation pass, 10: refined before, 11: inside the block;
* bits 12-13: the sub-band orientation (0 LL, 1 HL, 2 LH, 3 HH);
* bits 14-21: the signs of the significant N, W, E, S neighbours
  (positive, negative).

The contexts come from tables over the low 14 bits (zero coding, magnitude
refinement, run length) and bits 14-21 (sign coding): tables D.1-D.4 (the
HL band's zero coding swaps H and V).  Every code-block style is coded:
BYPASS (raw significance and refinement passes below the fourth
bit-plane), RESET, TERMALL, VSC (a stripe's last row does not see the next
stripe), PTERM (decoding is the same; the encoder flushes as usual) and
SEGSYM.  HT code-blocks (Part 15) are refused by the codestream reader.

Decoded values are OpenJPEG's: ±(2m + 1)·2^(p−1) for a magnitude m known to
bit-plane p, then the ROI max-shift, then halved (reversible) or scaled by
half the step size (irreversible)."""

from __future__ import annotations

import numpy as np

from sdwebui_tpu_torch.utils import mq

SIG, PI, MU, PRES = 1 << 8, 1 << 9, 1 << 10, 1 << 11
LOW = (1 << 14) - 1
#: a stripe's last row under VSC: the south neighbours and the south sign unseen
VSC_MASK = ~((1 << 5) | (1 << 6) | (1 << 7) | (1 << 20) | (1 << 21))

STYLE_BYPASS, STYLE_RESET, STYLE_TERMALL, STYLE_VSC, STYLE_PTERM, STYLE_SEGSYM = \
    1, 2, 4, 8, 16, 32


def _tables():
    f = np.arange(1 << 14)
    bit = lambda k: (f >> k) & 1  # noqa: E731
    nbr = f & 0xFF
    h = bit(3) + bit(4)
    v = bit(1) + bit(6)
    d = bit(0) + bit(2) + bit(5) + bit(7)
    orient = (f >> 12) & 3
    hs = np.where(orient == 1, v, h)
    vs = np.where(orient == 1, h, v)
    zc = np.select([hs == 2, (hs == 1) & (vs >= 1), (hs == 1) & (d >= 1), hs == 1,
                    vs == 2, vs == 1, d >= 2, d == 1], [8, 7, 6, 5, 4, 3, 2, 1], 0)
    hv = h + v
    zhh = np.select([d >= 3, (d == 2) & (hv >= 1), d == 2, (d == 1) & (hv >= 2),
                     (d == 1) & (hv == 1), d == 1, hv >= 2, hv == 1], [8, 7, 6, 5, 4, 3, 2, 1], 0)
    zc = np.where(orient == 3, zhh, zc) + mq.CTX_ZC
    sig, pi, mu, pres = (f & SIG) != 0, (f & PI) != 0, (f & MU) != 0, (f & PRES) != 0
    sp = np.where(pres & ~sig & ~pi & (nbr != 0), zc, 0)
    cl = np.where(pres & ~sig & ~pi, zc, 0)
    rl = (pres & ~sig & ~pi & (nbr == 0)).astype(np.int64)
    ref = np.where(pres & sig & ~pi,
                   np.where(mu, mq.CTX_MAG + 2, np.where(nbr != 0, mq.CTX_MAG + 1, mq.CTX_MAG)), 0)
    s = np.arange(256)
    sb = lambda k: (s >> k) & 1  # noqa: E731
    hc = np.clip(sb(2) - sb(3) + sb(4) - sb(5), -1, 1)
    vc = np.clip(sb(0) - sb(1) + sb(6) - sb(7), -1, 1)
    key = (hc + 1) * 3 + (vc + 1)
    # table D.3 in (H, V) order -1..1: context, XOR bit
    ctx = np.array([13, 12, 11, 10, 9, 10, 11, 12, 13])[key] - 9 + mq.CTX_SC
    xor = np.array([1, 1, 1, 1, 0, 0, 0, 0, 0])[key]
    sc = ctx | (xor << 5)
    return sp, cl, rl, ref, sc


SP_LUT, CL_LUT, RL_LUT, REF_LUT, SC_LUT = _tables()

# the bits a newly significant coefficient sets in its 3x3 neighbourhood
# (row-major, centre included), for a positive / negative sign, and with the
# row above left alone (VSC, first row of a stripe)
_REL_BIT = {(-1, -1): 0, (-1, 0): 1, (-1, 1): 2, (0, -1): 3, (0, 1): 4,
            (1, -1): 5, (1, 0): 6, (1, 1): 7}
_SIGN_BIT = {(-1, 0): 14, (0, -1): 16, (0, 1): 18, (1, 0): 20}


def _patterns():
    pats = np.zeros((4, 3, 3), np.int64)
    for neg in (0, 1):
        for vsc in (0, 1):
            p = pats[neg + 2 * vsc]
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    if dy == 0 and dx == 0:
                        p[1, 1] = SIG | PI
                        continue
                    if vsc and dy == -1:
                        continue
                    rel = (-dy, -dx)      # where the new coefficient sits for that neighbour
                    val = 1 << _REL_BIT[rel]
                    if rel in _SIGN_BIT:
                        val |= 1 << (_SIGN_BIT[rel] + neg)
                    p[dy + 1, dx + 1] = val
    return pats


NB_PATTERNS = _patterns()


class CodeBlock:
    """A code-block for tier-1: its size, sub-band orientation, bit-planes
    (``numbps``: those the packet headers signal; ``roishift`` more are
    coded), style bits, and for decoding its codeword segments
    ``[(passes, bytes)]``; for encoding its coefficients."""

    __slots__ = ("w", "h", "orient", "numbps", "roishift", "style", "segments", "coefs",
                 "passes", "data", "pass_ends", "pass_terms", "in_roi")

    def __init__(self, w, h, orient, numbps, style=0, roishift=0, segments=None, coefs=None):
        self.w, self.h, self.orient, self.numbps = int(w), int(h), int(orient), int(numbps)
        self.style, self.roishift = int(style), int(roishift)
        self.segments = segments or []
        self.coefs = coefs
        self.in_roi = False


def decode_blocks(blocks: list[CodeBlock]) -> list[np.ndarray]:
    """Tier-1 decoding: each block's (h, w) int64 values as OpenJPEG's
    ``opj_t1_decode_cblk`` leaves them, after the ROI shift (not yet halved
    or scaled)."""
    return [_decode_one(b) for b in blocks]


def encode_blocks(blocks: list[CodeBlock]):
    """Tier-1 encoding as ``opj_t1_encode_cblk`` (each block's ``coefs``:
    (h, w) integers, already ROI-shifted; its ``numbps`` the fewest
    bit-planes to code, 0 for as many as the coefficients need).  Sets on
    each block ``numbps`` (its bit-planes), ``passes``, ``data`` (its bytes),
    ``pass_ends`` (the rate of each pass: the bytes a layer ending there
    takes) and ``pass_terms`` (whether the pass ends a codeword segment)."""
    for b in blocks:
        m = int(np.abs(np.asarray(b.coefs, np.int64)).max()) if b.coefs.size else 0
        b.numbps = max(m.bit_length(), b.numbps) if m else 0
        b.passes = 3 * b.numbps - 2 if b.numbps else 0
        b.roishift = 0
        b.data, b.pass_ends, b.pass_terms = b"", [], []
        if b.passes:
            _rates(b, *_encode_one(b))


def _rates(b, data: bytes, e: list, terms: list):
    last = e[-1]
    for p in range(len(e) - 1, -1, -1):          # make the rates increase
        if e[p] > last:
            e[p] = last
        else:
            last = e[p]
    for p in range(len(e)):
        if e[p] > 0 and data[e[p] - 1] == 0xFF:
            e[p] -= 1
    b.data = data
    b.pass_ends = e
    b.pass_terms = terms


_SP, _CL, _RL, _REF, _SC = (t.tolist() for t in (SP_LUT, CL_LUT, RL_LUT, REF_LUT, SC_LUT))


def _layout(b: CodeBlock):
    """A block's state words (its border included), the neighbour updates
    of a newly significant coefficient by sign and stripe row, the scan
    (state index, value index, row in the stripe), and the stripes' columns
    (first row, rows, column) for the cleanup's run-length mode."""
    w, h = b.w, b.h
    w2 = w + 2
    F = [b.orient << 12] * ((h + 2) * w2)
    for y in range(h):
        F[(y + 1) * w2 + 1:(y + 1) * w2 + 1 + w] = [(b.orient << 12) | PRES] * w
    offs = [(dy * w2 + dx, dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1) if dy or dx]
    pats = [[(o, int(NB_PATTERNS[neg + 2 * top][dy + 1, dx + 1]))
             for o, dy, dx in offs if NB_PATTERNS[neg + 2 * top][dy + 1, dx + 1]]
            for top in (0, 1) for neg in (0, 1)]
    scan = [((y0 + row + 1) * w2 + x + 1, (y0 + row) * w + x, row)
            for y0 in range(0, h, 4) for x in range(w) for row in range(min(4, h - y0))]
    cols = [(y0, min(4, h - y0), x) for y0 in range(0, h, 4) for x in range(w)]
    return F, pats, scan, cols


def _raw_pass(b: CodeBlock, kind: int, plane1: int) -> bool:
    """Whether a pass is raw under BYPASS (``plane1``: bpno_plus_one)."""
    return bool(b.style & STYLE_BYPASS) and kind < 2 and plane1 <= b.numbps - 4


def _decode_one(b: CodeBlock) -> np.ndarray:
    """``opj_t1_decode_cblk`` for one block."""
    w, h = b.w, b.h
    p0 = b.numbps + b.roishift
    total = min(sum(s[0] for s in b.segments), max(3 * p0 - 2, 0))
    if not total or not w or not h:
        return np.zeros((h, w), np.int64)
    F, pats, scan, cols = _layout(b)
    w2 = w + 2
    val = [0] * (w * h)
    vsc = bool(b.style & STYLE_VSC)
    mask3 = VSC_MASK if vsc else -1
    cx = mq.initial_contexts()
    starts = {}
    p = 0
    for npass, data in b.segments:
        if p >= total:
            break
        starts[p] = data
        p += npass
    seg = None
    raw = False
    touched = []                # positions coded in this bit-plane's propagation pass
    for i in range(total):
        kind = (i + 2) % 3
        plane1 = p0 - (i + 2) // 3
        if i in starts:
            raw = _raw_pass(b, kind, plane1)
            seg = mq.MQDecoder(starts[i], raw, cx)
        one = 1 << plane1
        half = one >> 1
        oph = one | half
        dec, rbit = seg.decode, seg.raw
        if kind == 0:
            for pp, vp, row in scan:
                f = F[pp]
                if row == 3:
                    f &= mask3
                c = _SP[f & LOW]
                if not c:
                    continue
                touched.append(pp)
                if raw:
                    if rbit():
                        neg = rbit()
                    else:
                        F[pp] |= PI
                        continue
                elif dec(c):
                    sc = _SC[f >> 14]
                    neg = dec(sc & 31) ^ (sc >> 5)
                else:
                    F[pp] |= PI
                    continue
                val[vp] = -oph if neg else oph
                F[pp] |= SIG | PI
                for o, bits in pats[neg + (2 if vsc and row == 0 else 0)]:
                    F[pp + o] |= bits
        elif kind == 1:
            for pp, vp, row in scan:
                f = F[pp]
                if row == 3:
                    f &= mask3
                c = _REF[f & LOW]
                if not c:
                    continue
                v = rbit() if raw else dec(c)
                cur = val[vp]
                val[vp] = cur + (half if v != (cur < 0) else -half)
                F[pp] |= MU
        else:
            for y0, rows, x in cols:
                start = 0
                base = (y0 + 1) * w2 + x + 1
                if rows == 4 and _RL[F[base] & LOW] and _RL[F[base + w2] & LOW] \
                        and _RL[F[base + 2 * w2] & LOW] and _RL[F[base + 3 * w2] & mask3 & LOW]:
                    if not dec(mq.CTX_AGG):
                        continue
                    r = dec(mq.CTX_UNI) << 1
                    r |= dec(mq.CTX_UNI)
                    pp = base + r * w2
                    f = F[pp]
                    if r == 3:
                        f &= mask3
                    sc = _SC[f >> 14]
                    neg = dec(sc & 31) ^ (sc >> 5)
                    val[(y0 + r) * w + x] = -oph if neg else oph
                    F[pp] |= SIG
                    for o, bits in pats[neg + (2 if vsc and r == 0 else 0)]:
                        F[pp + o] |= bits
                    start = r + 1
                for row in range(start, rows):
                    pp = base + row * w2
                    f = F[pp]
                    if row == 3:
                        f &= mask3
                    c = _CL[f & LOW]
                    if c and dec(c):
                        sc = _SC[f >> 14]
                        neg = dec(sc & 31) ^ (sc >> 5)
                        val[(y0 + row) * w + x] = -oph if neg else oph
                        F[pp] |= SIG
                        for o, bits in pats[neg + (2 if vsc and row == 0 else 0)]:
                            F[pp + o] |= bits
            for pp in touched:
                F[pp] &= ~PI
            touched = []
            if b.style & STYLE_SEGSYM:
                for _ in range(4):
                    dec(mq.CTX_UNI)
        if b.style & STYLE_RESET and not raw:
            cx[:] = mq.initial_contexts()
    v = np.array(val, np.int64).reshape(h, w)
    if b.roishift:
        mag = np.abs(v)
        v = np.where(mag >= (1 << b.roishift), np.sign(v) * (mag >> b.roishift), v)
    return v




def _terminates(b: CodeBlock, kind: int, plane: int) -> bool:
    """``opj_t1_enc_is_term_pass``: whether a pass (``plane``: bpno) ends a
    codeword segment."""
    if kind == 2 and plane == 0:
        return True
    if b.style & STYLE_TERMALL:
        return True
    if b.style & STYLE_BYPASS:
        return (kind == 2 and plane == b.numbps - 4) or (plane < b.numbps - 4 and kind > 0)
    return False


def _encode_one(b: CodeBlock):
    """``opj_t1_encode_cblk`` for one block: its bytes, each pass's rate,
    and whether each pass ends a codeword segment."""
    w, h = b.w, b.h
    w2 = w + 2
    coefs = np.asarray(b.coefs, np.int64)
    mag = np.abs(coefs).reshape(-1).tolist()
    neg_of = (coefs < 0).reshape(-1).tolist()
    F, pats, scan, cols = _layout(b)
    vsc = bool(b.style & STYLE_VSC)
    mask3 = VSC_MASK if vsc else -1
    coder = mq.MQEncoder()
    enc, bit = coder.encode, coder.bypass
    ends, terms = [], []
    touched = []
    for i in range(b.passes):
        kind = (i + 2) % 3
        plane = b.numbps - 1 - (i + 2) // 3
        raw = _raw_pass(b, kind, plane + 1)
        if terms and terms[-1]:
            if raw:
                coder.bypass_start()
            else:
                coder.restart()
        if kind == 0:
            for pp, vp, row in scan:
                f = F[pp]
                if row == 3:
                    f &= mask3
                c = _SP[f & LOW]
                if not c:
                    continue
                touched.append(pp)
                v = (mag[vp] >> plane) & 1
                if raw:
                    bit(v)
                else:
                    enc(c, v)
                if not v:
                    F[pp] |= PI
                    continue
                neg = neg_of[vp]
                if raw:
                    bit(neg)
                else:
                    sc = _SC[f >> 14]
                    enc(sc & 31, neg ^ (sc >> 5))
                F[pp] |= SIG | PI
                for o, bits in pats[neg + (2 if vsc and row == 0 else 0)]:
                    F[pp + o] |= bits
        elif kind == 1:
            for pp, vp, row in scan:
                f = F[pp]
                if row == 3:
                    f &= mask3
                c = _REF[f & LOW]
                if c:
                    if raw:
                        bit((mag[vp] >> plane) & 1)
                    else:
                        enc(c, (mag[vp] >> plane) & 1)
                    F[pp] |= MU
        else:
            for y0, rows, x in cols:
                start = 0
                base = (y0 + 1) * w2 + x + 1
                vbase = y0 * w + x
                if rows == 4 and _RL[F[base] & LOW] and _RL[F[base + w2] & LOW] \
                        and _RL[F[base + 2 * w2] & LOW] and _RL[F[base + 3 * w2] & mask3 & LOW]:
                    bits4 = [(mag[vbase + r * w] >> plane) & 1 for r in range(4)]
                    if not any(bits4):
                        enc(mq.CTX_AGG, 0)
                        continue
                    enc(mq.CTX_AGG, 1)
                    r = bits4.index(1)
                    enc(mq.CTX_UNI, r >> 1)
                    enc(mq.CTX_UNI, r & 1)
                    pp = base + r * w2
                    f = F[pp]
                    if r == 3:
                        f &= mask3
                    sc = _SC[f >> 14]
                    neg = neg_of[vbase + r * w]
                    enc(sc & 31, neg ^ (sc >> 5))
                    F[pp] |= SIG
                    for o, bits in pats[neg + (2 if vsc and r == 0 else 0)]:
                        F[pp + o] |= bits
                    start = r + 1
                for row in range(start, rows):
                    pp = base + row * w2
                    f = F[pp]
                    if row == 3:
                        f &= mask3
                    c = _CL[f & LOW]
                    if not c:
                        continue
                    vp = vbase + row * w
                    v = (mag[vp] >> plane) & 1
                    enc(c, v)
                    if v:
                        sc = _SC[f >> 14]
                        neg = neg_of[vp]
                        enc(sc & 31, neg ^ (sc >> 5))
                        F[pp] |= SIG
                        for o, bits in pats[neg + (2 if vsc and row == 0 else 0)]:
                            F[pp + o] |= bits
            for pp in touched:
                F[pp] &= ~PI
            touched = []
            if b.style & STYLE_SEGSYM:
                for k in (1, 0, 1, 0):
                    enc(mq.CTX_UNI, k)
        if b.style & STYLE_RESET:
            coder.reset_contexts()
        term = _terminates(b, kind, plane)
        if term:
            if raw:
                coder.bypass_flush()
            else:
                coder.flush()
            ends.append(coder.numbytes())
        else:
            ends.append(coder.numbytes() + (coder.bypass_extra() if raw else 3))
        terms.append(term)
    return coder.data(), ends, terms
