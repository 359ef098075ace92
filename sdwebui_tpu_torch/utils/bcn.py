"""Block-compressed texture decoding (BC1-BC7) on numpy, as Pillow's
``bcn`` decoder (``BcnDecode.c``) decodes it, on whole arrays of blocks.

BC1 colours expand 5-6-5 endpoints by bit replication and interpolate in
thirds (or halves with a transparent fourth colour when c0 <= c1; BC2 and
BC3 always take thirds); BC2 carries 4-bit alpha, BC3 and BC4 the 8-value
alpha ramp (6 values and 0 / 255 when a0 <= a1), BC5 two such ramps in red
and green (blue 0), BC5S the same with signed endpoints offset by 128 (and
blue 128).  BC7
covers its eight modes: partitions of one to three subsets, endpoint
p-bits, rotation and the index selector, 2-, 3- and 4-bit weights with
``(e0 · (64 - w) + e1 · w + 32) >> 6``; a block whose first byte is 0 reads
opaque black.  BC6H (half-float HDR, unsigned and signed) takes its
fourteen modes' endpoint layouts, sign extension, deltas and
unquantization, interpolates with BC7's weights, then goes to 8 bits as
Pillow's does: the half float of ``v · 31 / 64`` (``/ 32`` signed), times
255 in float32, truncated and clipped to 0..255.  Pillow leaves a signed
block's endpoints unextended after its deltas; so does this.

``decode(data, n, width, height, signed)`` returns uint8 (H, W, 4) RGBA
(BC4 in its first channel)."""

from __future__ import annotations

import numpy as np

#: bytes a block for each BCn number
BLOCK_BYTES = {1: 8, 2: 16, 3: 16, 4: 8, 5: 16, 6: 16, 7: 16}


def _565(c: np.ndarray) -> np.ndarray:
    c = c.astype(np.int32)
    r = (c & 0xF800) >> 8
    g = (c & 0x7E0) >> 3
    b = (c & 0x1F) << 3
    return np.stack([r | (r >> 5), g | (g >> 6), b | (b >> 5)], axis=-1)


def _bc1_colour(blocks: np.ndarray, separate_alpha: bool) -> np.ndarray:
    """(N, 8) colour blocks → (N, 16, 4) RGBA."""
    c0 = blocks[:, 0].astype(np.int32) | (blocks[:, 1].astype(np.int32) << 8)
    c1 = blocks[:, 2].astype(np.int32) | (blocks[:, 3].astype(np.int32) << 8)
    lut = blocks[:, 4:8].astype(np.int64) @ (1 << (8 * np.arange(4, dtype=np.int64)))
    p0, p1 = _565(c0), _565(c1)
    thirds = (c0 > c1) | separate_alpha
    n = len(blocks)
    pal = np.zeros((n, 4, 4), np.int32)
    pal[:, 0, :3], pal[:, 1, :3] = p0, p1
    pal[:, :2, 3] = 255
    pal[:, 2, :3] = np.where(thirds[:, None], (2 * p0 + p1) // 3, (p0 + p1) // 2)
    pal[:, 2, 3] = 255
    pal[:, 3, :3] = np.where(thirds[:, None], (p0 + 2 * p1) // 3, 0)
    pal[:, 3, 3] = np.where(thirds, 255, 0)
    idx = (lut[:, None] >> (2 * np.arange(16))) & 3
    return np.take_along_axis(pal, idx[:, :, None].astype(np.intp), axis=1)


def _alpha_ramp(blocks: np.ndarray, signed: bool = False) -> np.ndarray:
    """(N, 8) BC3-style alpha blocks → (N, 16) values."""
    if signed:
        a0 = blocks[:, 0].view(np.int8).astype(np.int32) + 128
        a1 = blocks[:, 1].view(np.int8).astype(np.int32) + 128
    else:
        a0, a1 = blocks[:, 0].astype(np.int32), blocks[:, 1].astype(np.int32)
    bits = blocks[:, 2:8].astype(np.int64) @ (1 << (8 * np.arange(6, dtype=np.int64)))
    wide = a0 > a1
    ramp = np.zeros((len(blocks), 8), np.int32)
    ramp[:, 0], ramp[:, 1] = a0, a1
    for k in range(2, 8):
        seven = ((8 - k) * a0 + (k - 1) * a1) // 7
        five = ((6 - k) * a0 + (k - 1) * a1) // 5 if k < 6 else (0 if k == 6 else 255)
        ramp[:, k] = np.where(wide, seven, five)
    ramp &= 255
    idx = (bits[:, None] >> (3 * np.arange(16))) & 7
    return np.take_along_axis(ramp, idx.astype(np.intp), axis=1)


# --------------------------------------------------------------------------
# BC7
# --------------------------------------------------------------------------

#: per mode: subsets, partition bits, rotation bits, index-selector bits,
#: colour bits, alpha bits, endpoint p-bits, shared p-bits, index bits,
#: second index bits
_BC7_MODES = ((3, 4, 0, 0, 4, 0, 1, 0, 3, 0), (2, 6, 0, 0, 6, 0, 0, 1, 3, 0),
              (3, 6, 0, 0, 5, 0, 0, 0, 2, 0), (2, 6, 0, 0, 7, 0, 1, 0, 2, 0),
              (1, 0, 2, 1, 5, 6, 0, 0, 2, 3), (1, 0, 2, 0, 7, 8, 0, 0, 2, 2),
              (1, 0, 0, 0, 7, 7, 1, 0, 4, 0), (2, 6, 0, 0, 5, 5, 1, 0, 2, 0))
_BC7_PARTITION2 = (
    0xCCCC, 0x8888, 0xEEEE, 0xECC8, 0xC880, 0xFEEC, 0xFEC8, 0xEC80, 0xC800, 0xFFEC, 0xFE80,
    0xE800, 0xFFE8, 0xFF00, 0xFFF0, 0xF000, 0xF710, 0x008E, 0x7100, 0x08CE, 0x008C, 0x7310,
    0x3100, 0x8CCE, 0x088C, 0x3110, 0x6666, 0x366C, 0x17E8, 0x0FF0, 0x718E, 0x399C, 0xAAAA,
    0xF0F0, 0x5A5A, 0x33CC, 0x3C3C, 0x55AA, 0x9696, 0xA55A, 0x73CE, 0x13C8, 0x324C, 0x3BDC,
    0x6996, 0xC33C, 0x9966, 0x0660, 0x0272, 0x04E4, 0x4E40, 0x2720, 0xC936, 0x936C, 0x39C6,
    0x639C, 0x9336, 0x9CC6, 0x817E, 0xE718, 0xCCF0, 0x0FCC, 0x7744, 0xEE22)
_BC7_PARTITION3 = (
    0xAA685050, 0x6A5A5040, 0x5A5A4200, 0x5450A0A8, 0xA5A50000, 0xA0A05050, 0x5555A0A0,
    0x5A5A5050, 0xAA550000, 0xAA555500, 0xAAAA5500, 0x90909090, 0x94949494, 0xA4A4A4A4,
    0xA9A59450, 0x2A0A4250, 0xA5945040, 0x0A425054, 0xA5A5A500, 0x55A0A0A0, 0xA8A85454,
    0x6A6A4040, 0xA4A45000, 0x1A1A0500, 0x0050A4A4, 0xAAA59090, 0x14696914, 0x69691400,
    0xA08585A0, 0xAA821414, 0x50A4A450, 0x6A5A0200, 0xA9A58000, 0x5090A0A8, 0xA8A09050,
    0x24242424, 0x00AA5500, 0x24924924, 0x24499224, 0x50A50A50, 0x500AA550, 0xAAAA4444,
    0x66660000, 0xA5A0A5A0, 0x50A050A0, 0x69286928, 0x44AAAA44, 0x66666600, 0xAA444444,
    0x54A854A8, 0x95809580, 0x96969600, 0xA85454A8, 0x80959580, 0xAA141414, 0x96960000,
    0xAAAA1414, 0xA05050A0, 0xA0A5A5A0, 0x96000000, 0x40804080, 0xA9A8A9A8, 0xAAAAAA44,
    0x2A4A5254)
_BC7_ANCHOR2 = (15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 2, 8, 2, 2,
                8, 8, 15, 2, 8, 2, 2, 8, 8, 2, 2, 15, 15, 6, 8, 2, 8, 15, 15, 2, 8, 2, 2, 2, 15,
                15, 6, 6, 2, 6, 8, 15, 15, 2, 2, 15, 15, 15, 15, 15, 2, 2, 15)
_BC7_ANCHOR3A = (3, 3, 15, 15, 8, 3, 15, 15, 8, 8, 6, 6, 6, 5, 3, 3, 3, 3, 8, 15, 3, 3, 6, 10,
                 5, 8, 8, 6, 8, 5, 15, 15, 8, 15, 3, 5, 6, 10, 8, 15, 15, 3, 15, 5, 15, 15, 15,
                 15, 3, 15, 5, 5, 5, 8, 5, 10, 5, 10, 8, 13, 15, 12, 3, 3)
_BC7_ANCHOR3B = (15, 8, 8, 3, 15, 15, 3, 8, 15, 15, 15, 15, 15, 15, 15, 8, 15, 8, 15, 3, 15, 8,
                 15, 8, 3, 15, 6, 10, 15, 15, 10, 8, 15, 3, 15, 10, 10, 8, 9, 10, 6, 15, 8, 15,
                 3, 6, 6, 8, 15, 3, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3, 15, 15, 8)
_WEIGHTS = {2: np.array([0, 21, 43, 64]), 3: np.array([0, 9, 18, 27, 37, 46, 55, 64]),
            4: np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64])}


def _subsets(ns: int, partition: np.ndarray) -> np.ndarray:
    """(N,) partitions → (N, 16) subset of each pixel."""
    px = np.arange(16)
    if ns == 2:
        table = np.array(_BC7_PARTITION2, np.int64)[partition]
        return (table[:, None] >> px) & 1
    if ns == 3:
        table = np.array(_BC7_PARTITION3, np.int64)[partition]
        return (table[:, None] >> (2 * px)) & 3
    return np.zeros((len(partition), 16), np.int64)


def _anchors(ns: int, partition: np.ndarray) -> np.ndarray:
    """(N, 16) True where a pixel's index has one bit fewer."""
    px = np.arange(16)
    out = np.zeros((len(partition), 16), bool)
    out[:, 0] = True
    if ns == 2:
        out |= px == np.array(_BC7_ANCHOR2)[partition][:, None]
    elif ns == 3:
        out |= px == np.array(_BC7_ANCHOR3A)[partition][:, None]
        out |= px == np.array(_BC7_ANCHOR3B)[partition][:, None]
    return out


def _gather(bits: np.ndarray, start: np.ndarray, width: np.ndarray) -> np.ndarray:
    """Little-endian fields of `width` bits at `start` (both (N, K)) of
    (N, 128) bit rows."""
    out = np.zeros(start.shape, np.int64)
    for k in range(int(width.max(initial=0))):
        pos = np.minimum(start + k, 127)
        bit = np.take_along_axis(bits, pos.astype(np.intp), axis=1).astype(np.int64)
        out |= np.where(k < width, bit, 0) << k
    return out


def _bc7_mode(blocks: np.ndarray, mode: int) -> np.ndarray:
    """(N, 16) blocks of one mode → (N, 16, 4) RGBA."""
    ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2 = _BC7_MODES[mode]
    n = len(blocks)
    bits = np.unpackbits(blocks, axis=1, bitorder="little")
    pos = mode + 1

    def take(count: int) -> np.ndarray:
        nonlocal pos
        v = (bits[:, pos:pos + count].astype(np.int64) << np.arange(count)).sum(axis=1) \
            if count else np.zeros(n, np.int64)
        pos += count
        return v

    partition, rotation, index_sel = take(pb), take(rb), take(isb)
    numep = 2 * ns
    ep = np.zeros((n, numep, 4), np.int64)
    for ch in range(3):
        for i in range(numep):
            ep[:, i, ch] = take(cb)
    for i in range(numep):
        ep[:, i, 3] = take(ab) if ab else 255
    cbits, abits = cb, ab
    if epb:
        cbits += 1
        abits += 1 if ab else 0
        for i in range(numep):
            p = take(1)
            ep[:, i, :3] = (ep[:, i, :3] << 1) | p[:, None]
            if ab:
                ep[:, i, 3] = (ep[:, i, 3] << 1) | p
    if spb:
        cbits += 1
        abits += 1 if ab else 0
        for i in range(0, numep, 2):
            p = take(1)
            for j in (i, i + 1):
                ep[:, j, :3] = (ep[:, j, :3] << 1) | p[:, None]
                if ab:
                    ep[:, j, 3] = (ep[:, j, 3] << 1) | p
    ep[:, :, :3] = _expand(ep[:, :, :3], cbits)
    if ab:
        ep[:, :, 3] = _expand(ep[:, :, 3], abits)
    ep &= 255

    anchors = _anchors(ns, partition)
    width = ib - anchors.astype(np.int64)
    start = pos + np.cumsum(width, axis=1) - width
    i0 = _gather(bits, start, width)
    if ab and ib2:
        width2 = np.full((n, 16), ib2, np.int64)
        width2[:, 0] -= 1
        start2 = pos + 16 * ib - ns + np.cumsum(width2, axis=1) - width2
        i1 = _gather(bits, start2, width2)
        cw, aw = _WEIGHTS[ib], _WEIGHTS[ib2]
        colour_w = np.where(index_sel[:, None] == 1, aw[np.minimum(i1, len(aw) - 1)],
                            cw[np.minimum(i0, len(cw) - 1)])
        alpha_w = np.where(index_sel[:, None] == 1, cw[np.minimum(i0, len(cw) - 1)],
                           aw[np.minimum(i1, len(aw) - 1)])
    else:
        colour_w = alpha_w = _WEIGHTS[ib][i0]
    s = _subsets(ns, partition)
    e0 = np.take_along_axis(ep, (2 * s)[:, :, None].astype(np.intp), axis=1)
    e1 = np.take_along_axis(ep, (2 * s + 1)[:, :, None].astype(np.intp), axis=1)
    w = np.concatenate([np.repeat(colour_w[:, :, None], 3, axis=2), alpha_w[:, :, None]], 2)
    out = (e0 * (64 - w) + e1 * w + 32) >> 6
    for r, ch in ((1, 0), (2, 1), (3, 2)):
        m = rotation == r
        out[m, :, ch], out[m, :, 3] = out[m, :, 3].copy(), out[m, :, ch].copy()
    return out & 255


def _expand(v: np.ndarray, nbits: int) -> np.ndarray:
    """Pillow's ``expand_quantized``: (v << (8 - n)) | (v >> n), in 8 bits."""
    v = (v << (8 - nbits)) & 255
    return v | (v >> nbits)


# --------------------------------------------------------------------------
# BC6H
# --------------------------------------------------------------------------

#: per mode: subsets, deltas, partition bits, endpoint bits, then the delta
#: bits of red, green and blue
_BC6_MODES = ((2, 1, 5, 10, 5, 5, 5), (2, 1, 5, 7, 6, 6, 6), (2, 1, 5, 11, 5, 4, 4),
              (2, 1, 5, 11, 4, 5, 4), (2, 1, 5, 11, 4, 4, 5), (2, 1, 5, 9, 5, 5, 5),
              (2, 1, 5, 8, 6, 5, 5), (2, 1, 5, 8, 5, 6, 5), (2, 1, 5, 8, 5, 5, 6),
              (2, 0, 5, 6, 6, 6, 6), (1, 0, 0, 10, 10, 10, 10), (1, 1, 0, 11, 9, 9, 9),
              (1, 1, 0, 12, 8, 8, 8), (1, 1, 0, 16, 4, 4, 4))
#: each mode's endpoint bits in stream order (the BC6H format's layouts, its
#: mode bits and partition left out): component[bits], a high-to-low range
#: read from its low bit, a low-to-high range (the reversed fields) from its
#: high bit; components w, x (subset 0) and y, z (subset 1) of r, g, b
_BC6_LAYOUTS = (
    "gy[4] by[4] bz[4] rw[9:0] gw[9:0] bw[9:0] rx[4:0] gz[4] gy[3:0] gx[4:0] bz[0] gz[3:0] "
    "bx[4:0] bz[1] by[3:0] ry[4:0] bz[2] rz[4:0] bz[3]",
    "gy[5] gz[4] gz[5] rw[6:0] bz[0] bz[1] by[4] gw[6:0] by[5] bz[2] gy[4] bw[6:0] bz[3] bz[5] "
    "bz[4] rx[5:0] gy[3:0] gx[5:0] gz[3:0] bx[5:0] by[3:0] ry[5:0] rz[5:0]",
    "rw[9:0] gw[9:0] bw[9:0] rx[4:0] rw[10] gy[3:0] gx[3:0] gw[10] bz[0] gz[3:0] bx[3:0] "
    "bw[10] bz[1] by[3:0] ry[4:0] bz[2] rz[4:0] bz[3]",
    "rw[9:0] gw[9:0] bw[9:0] rx[3:0] rw[10] gz[4] gy[3:0] gx[4:0] gw[10] gz[3:0] bx[3:0] "
    "bw[10] bz[1] by[3:0] ry[3:0] bz[0] bz[2] rz[3:0] gy[4] bz[3]",
    "rw[9:0] gw[9:0] bw[9:0] rx[3:0] rw[10] by[4] gy[3:0] gx[3:0] gw[10] bz[0] gz[3:0] "
    "bx[4:0] bw[10] by[3:0] ry[3:0] bz[1] bz[2] rz[3:0] bz[4] bz[3]",
    "rw[8:0] by[4] gw[8:0] gy[4] bw[8:0] bz[4] rx[4:0] gz[4] gy[3:0] gx[4:0] bz[0] gz[3:0] "
    "bx[4:0] bz[1] by[3:0] ry[4:0] bz[2] rz[4:0] bz[3]",
    "rw[7:0] gz[4] by[4] gw[7:0] bz[2] gy[4] bw[7:0] bz[3] bz[4] rx[5:0] gy[3:0] gx[4:0] bz[0] "
    "gz[3:0] bx[4:0] bz[1] by[3:0] ry[5:0] rz[5:0]",
    "rw[7:0] bz[0] by[4] gw[7:0] gy[5] gy[4] bw[7:0] gz[5] bz[4] rx[4:0] gz[4] gy[3:0] gx[5:0] "
    "gz[3:0] bx[4:0] bz[1] by[3:0] ry[4:0] bz[2] rz[4:0] bz[3]",
    "rw[7:0] bz[1] by[4] gw[7:0] by[5] gy[4] bw[7:0] bz[5] bz[4] rx[4:0] gz[4] gy[3:0] gx[4:0] "
    "bz[0] gz[3:0] bx[5:0] by[3:0] ry[4:0] bz[2] rz[4:0] bz[3]",
    "rw[5:0] gz[4] bz[0] bz[1] by[4] gw[5:0] gy[5] by[5] bz[2] gy[4] bw[5:0] gz[5] bz[3] bz[5] "
    "bz[4] rx[5:0] gy[3:0] gx[5:0] gz[3:0] bx[5:0] by[3:0] ry[5:0] rz[5:0]",
    "rw[9:0] gw[9:0] bw[9:0] rx[9:0] gx[9:0] bx[9:0]",
    "rw[9:0] gw[9:0] bw[9:0] rx[8:0] rw[10] gx[8:0] gw[10] bx[8:0] bw[10]",
    "rw[9:0] gw[9:0] bw[9:0] rx[7:0] rw[10:11] gx[7:0] gw[10:11] bx[7:0] bw[10:11]",
    "rw[9:0] gw[9:0] bw[9:0] rx[3:0] rw[10:15] gx[3:0] gw[10:15] bx[3:0] bw[10:15]")
_BC6_COMPONENTS = ("rw", "gw", "bw", "rx", "gx", "bx", "ry", "gy", "by", "rz", "gz", "bz")


def _bc6_packing(layout: str) -> list:
    """A layout → [(endpoint component, bit)] in stream order."""
    out = []
    for field in layout.split():
        comp = _BC6_COMPONENTS.index(field[:2])
        span = field[3:-1]
        if ":" in span:
            a, b = (int(v) for v in span.split(":"))
            order = range(b, a + 1) if a >= b else range(b, a - 1, -1)
        else:
            order = (int(span),)
        out += [(comp, k) for k in order]
    return out


_BC6_PACKINGS = tuple(_bc6_packing(layout) for layout in _BC6_LAYOUTS)


def _sign_extend(v: np.ndarray, bits: int) -> np.ndarray:
    """Into 16 bits, as Pillow stores it."""
    v = v & 0xFFFF
    return np.where(v & (1 << (bits - 1)), (v | (-1 << bits)) & 0xFFFF, v)


def _bc6_mode(blocks: np.ndarray, mode: int, signed: bool) -> np.ndarray:
    """(N, 16) blocks of one BC6H mode → (N, 16, 4) RGBA, alpha 255."""
    ns, tr, pb, epb, rb, gb, bb = _BC6_MODES[mode]
    n = len(blocks)
    bits = np.unpackbits(blocks, axis=1, bitorder="little").astype(np.int64)
    pos = 2 if mode < 2 else 5
    ib = 4 if mode >= 10 else 3
    e = np.zeros((n, 12), np.int64)
    for i, (comp, k) in enumerate(_BC6_PACKINGS[mode]):
        e[:, comp] |= bits[:, pos + i] << k
    pos += len(_BC6_PACKINGS[mode])
    partition = (bits[:, pos:pos + pb] << np.arange(pb)).sum(axis=1) if pb else \
        np.zeros(n, np.int64)
    pos += pb
    numep = 12 if ns == 2 else 6
    if signed:
        e[:, :3] = _sign_extend(e[:, :3], epb)
    if signed or tr:
        for i in range(3, numep, 3):
            for ch, width in enumerate((rb, gb, bb)):
                e[:, i + ch] = _sign_extend(e[:, i + ch], width)
    if tr:
        for i in range(3, numep):
            e[:, i] = (e[:, i] + e[:, i % 3]) & ((1 << epb) - 1)
    e = e[:, :numep]
    if signed:                       # unquantize (Pillow's bc6_unquantize)
        x = np.where(e >= 32768, e - 65536, e)
        neg = x < 0
        x = np.abs(x)
        if epb < 16:
            x = np.where(x == 0, 0, np.where(x >= (1 << (epb - 1)) - 1, 0x7FFF,
                                             ((x << 15) + 0x4000) >> (epb - 1)))
        u = np.where(neg, -x, x)
    elif epb >= 15:
        u = e
    else:
        u = np.where(e == 0, 0, np.where(e == (1 << epb) - 1, 0xFFFF,
                                         ((e << 15) + 0x4000) >> (epb - 1)))
    anchors = np.zeros((n, 16), bool)
    anchors[:, 0] = True
    if ns == 2:
        anchors |= np.arange(16) == np.array(_BC7_ANCHOR2)[partition][:, None]
    width = ib - anchors.astype(np.int64)
    start = pos + np.cumsum(width, axis=1) - width
    w = _WEIGHTS[ib][_gather(bits.astype(np.uint8), start, width)]
    s = _subsets(ns, partition) * 6
    e0 = np.take_along_axis(u, (s[:, :, None] + np.arange(3)).reshape(n, -1), axis=1)
    e1 = np.take_along_axis(u, (s[:, :, None] + 3 + np.arange(3)).reshape(n, -1), axis=1)
    t = np.repeat(w, 3, axis=1)
    v = (e0 * (64 - t) + e1 * t) >> 6
    if signed:
        half = np.where(v < 0, 0x8000 | ((-v) * 31 // 32), v * 31 // 32)
    else:
        half = v * 31 // 64
    f = (half & 0xFFFF).astype(np.uint16).view(np.float16).astype(np.float32)
    with np.errstate(invalid="ignore"):
        eight = np.where(f < 0, 0, np.where(f > 1, 255,
                                             (np.nan_to_num(f) * np.float32(255)).astype(np.int64)))
    out = np.full((n, 16, 4), 255, np.int64)
    out[:, :, :3] = eight.reshape(n, 16, 3)
    return out


def _bc6(blocks: np.ndarray, signed: bool) -> np.ndarray:
    out = np.zeros((len(blocks), 16, 4), np.int64)
    low = blocks[:, 0].astype(np.int64) & 0x1F
    mode = np.where((low & 3) < 2, low & 3, np.where((low & 3) == 2, 2 + (low >> 2),
                                                     10 + (low >> 2)))
    for m in range(14):
        sel = mode == m
        if sel.any():
            out[sel] = _bc6_mode(blocks[sel], m, signed)
    return out                       # a reserved mode reads all zero, alpha too


def _bc7(blocks: np.ndarray) -> np.ndarray:
    out = np.zeros((len(blocks), 16, 4), np.int64)
    out[:, :, 3] = 255
    first = blocks[:, 0]
    mode = np.full(len(blocks), -1)
    for m in range(7, -1, -1):
        mode = np.where(first & (1 << m), m, mode)
    for m in range(8):
        sel = mode == m
        if sel.any():
            out[sel] = _bc7_mode(blocks[sel], m)
    return out


def decode(data: bytes, n: int, width: int, height: int, signed: bool = False) -> np.ndarray:
    """BCn blocks (row-major over the 4×4 block grid) → uint8 (H, W, 4)."""
    size = BLOCK_BYTES[n]
    bw, bh = (width + 3) // 4, (height + 3) // 4
    need = bw * bh * size
    if len(data) < need:
        raise ValueError("BCn: image file is truncated")
    blocks = np.frombuffer(data, np.uint8, need).reshape(-1, size)
    if n == 1:
        px = _bc1_colour(blocks, False)
    elif n == 2:
        px = _bc1_colour(blocks[:, 8:], True)
        nib = np.stack([blocks[:, :8] & 15, blocks[:, :8] >> 4], axis=2).reshape(-1, 16)
        px[:, :, 3] = nib * 17
    elif n == 3:
        px = _bc1_colour(blocks[:, 8:], True)
        px[:, :, 3] = _alpha_ramp(blocks[:, :8])
    elif n == 4:
        px = np.zeros((len(blocks), 16, 4), np.int32)
        px[:, :, 0] = _alpha_ramp(blocks)
    elif n == 5:
        px = np.zeros((len(blocks), 16, 4), np.int32)
        px[:, :, 0] = _alpha_ramp(blocks[:, :8], signed)
        px[:, :, 1] = _alpha_ramp(blocks[:, 8:], signed)
        px[:, :, 2] = 128 if signed else 0           # a signed zero, as Pillow fills it
    elif n == 6:
        px = _bc6(blocks, signed)
    else:
        px = _bc7(blocks)
    grid = px.reshape(bh, bw, 4, 4, 4).transpose(0, 2, 1, 3, 4).reshape(bh * 4, bw * 4, 4)
    return np.ascontiguousarray(grid[:height, :width]).astype(np.uint8)
