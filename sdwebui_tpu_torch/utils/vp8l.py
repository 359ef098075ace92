"""The lossless WebP decoder: a VP8L bitstream (the WebP lossless
specification), restated as libwebp's ``vp8l_dec.c`` decodes it.

The entropy-coded image is read one symbol at a time, as the bitstream
forces: canonical prefix codes (simple one- or two-symbol codes, or code
lengths under a code-length code with its repeat codes), read through
two-level lookup tables; meta prefix codes chosen per tile from an entropy
image; LZ77 backward references with the 120 short distance codes of the
distance map; the colour cache (a multiplicative hash of every pixel
passed).  The inverse transforms follow, the last read first: colour
indexing (1, 2, 4 or 8 bits an index) and cross-colour and subtract-green
are vectorised with numpy; the predictor transform's fourteen modes go
row by row, vectorised over the pixels of a row whose mode does not read
the pixel to the left, and pixel by pixel for the rest.  The result is
(H, W) ARGB in uint32.
"""

from __future__ import annotations

import numpy as np

from sdwebui_tpu_torch.utils.vp8_tables import CODE_TO_PLANE

_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
_ROOT_BITS = 8
_ALPHABETS = (256 + 24, 256, 256, 256, 40)   # green (+ cache), red, blue, alpha, distance


class BitReader:
    """LSB-first bits of a VP8L stream."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos
        self.buf = 0
        self.nbits = 0

    def fill(self):
        if self.nbits < 32:
            chunk = self.data[self.pos:self.pos + 4]
            self.buf |= int.from_bytes(chunk.ljust(4, b"\0"), "little") << self.nbits
            self.pos += 4
            self.nbits += 32
            if self.pos > len(self.data) + 8:
                raise ValueError("truncated VP8L data")

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        if self.nbits < n:
            self.fill()
        v = self.buf & ((1 << n) - 1)
        self.buf >>= n
        self.nbits -= n
        return v


class Huffman:
    """A canonical prefix code as a two-level lookup table: a root of
    `_ROOT_BITS` bits and second-level tables for the longer codes.
    Entries are symbol << 4 | length, or -(1 + subtable) in the root."""

    def __init__(self, lengths):
        lengths = list(lengths)
        used = [s for s, n in enumerate(lengths) if n]
        self.subs = []
        if not used:
            raise ValueError("VP8L prefix code without symbols")
        if len(used) == 1:                       # a code of no bits
            self.root = [used[0] << 4] * (1 << _ROOT_BITS)
            return
        max_len = max(lengths)
        counts = [0] * (max_len + 1)
        for n in lengths:
            if n:
                counts[n] += 1
        code, next_code = 0, [0] * (max_len + 2)
        for n in range(1, max_len + 1):
            code = (code + counts[n - 1]) << 1 if n > 1 else 0
            next_code[n] = code
        if sum(c << (max_len - n) for n, c in enumerate(counts) if n) != 1 << max_len:
            raise ValueError("VP8L prefix code is not complete")
        root = [0] * (1 << _ROOT_BITS)
        long_codes: dict = {}
        for sym in range(len(lengths)):
            n = lengths[sym]
            if not n:
                continue
            c = next_code[n]
            next_code[n] += 1
            rev = int(format(c, f"0{n}b")[::-1], 2)
            entry = (sym << 4) | n
            if n <= _ROOT_BITS:
                for k in range(rev, 1 << _ROOT_BITS, 1 << n):
                    root[k] = entry
            else:
                long_codes.setdefault(rev & ((1 << _ROOT_BITS) - 1), []).append((rev, n, entry))
        for prefix, codes in long_codes.items():
            bits = max(n for _, n, _ in codes) - _ROOT_BITS
            table = [0] * (1 << bits)
            for rev, n, entry in codes:
                for k in range(rev >> _ROOT_BITS, 1 << bits, 1 << (n - _ROOT_BITS)):
                    table[k] = entry
            root[prefix] = -(1 + len(self.subs))
            self.subs.append((table, (1 << bits) - 1))
        self.root = root

    def read(self, br: BitReader) -> int:
        if br.nbits < 15:
            br.fill()
        e = self.root[br.buf & 255]
        if e < 0:
            table, mask = self.subs[-1 - e]
            e = table[(br.buf >> _ROOT_BITS) & mask]
        n = e & 15
        br.buf >>= n
        br.nbits -= n
        return e >> 4


def _read_code(br: BitReader, alphabet: int) -> Huffman:
    lengths = [0] * alphabet
    if br.read(1):                               # simple code
        two = br.read(1)
        first = br.read(8 if br.read(1) else 1)
        lengths[first] = 1
        if two:
            lengths[br.read(8)] = 1
        return Huffman(lengths)
    cl = [0] * 19
    for i in range(br.read(4) + 4):
        cl[_CODE_LENGTH_ORDER[i]] = br.read(3)
    table = Huffman(cl)
    if br.read(1):
        max_symbol = 2 + br.read(2 + 2 * br.read(3))
        if max_symbol > alphabet:
            raise ValueError("bad VP8L code length count")
    else:
        max_symbol = alphabet
    sym, prev = 0, 8
    while sym < alphabet:
        if max_symbol == 0:
            break
        max_symbol -= 1
        n = table.read(br)
        if n < 16:
            lengths[sym] = n
            sym += 1
            if n:
                prev = n
        else:
            extra, offset = ((2, 3), (3, 3), (7, 11))[n - 16]
            repeat = br.read(extra) + offset
            if sym + repeat > alphabet:
                raise ValueError("bad VP8L code lengths")
            value = prev if n == 16 else 0
            lengths[sym:sym + repeat] = [value] * repeat
            sym += repeat
    return Huffman(lengths)


def _div_round_up(n: int, bits: int) -> int:
    return (n + (1 << bits) - 1) >> bits


def _prefix_value(symbol: int, br: BitReader) -> int:
    if symbol < 4:
        return symbol + 1
    extra = (symbol - 2) >> 1
    return ((2 + (symbol & 1)) << extra) + br.read(extra) + 1


def _entropy_image(br: BitReader, xsize: int, ysize: int, level0: bool) -> np.ndarray:
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise ValueError(f"bad VP8L colour cache size {cache_bits}")
    meta, hbits = None, 0
    if level0 and br.read(1):
        hbits = br.read(3) + 2
        himg = _image_stream(br, _div_round_up(xsize, hbits), _div_round_up(ysize, hbits), False)
        meta = ((himg >> 8) & 0xFFFF).astype(np.int64)
        groups = int(meta.max()) + 1
    else:
        groups = 1
    sizes = (_ALPHABETS[0] + ((1 << cache_bits) if cache_bits else 0),) + _ALPHABETS[1:]
    codes = [[_read_code(br, n) for n in sizes] for _ in range(groups)]
    return _pixels(br, xsize, ysize, codes, meta, hbits, cache_bits)


def _pixels(br, xsize, ysize, codes, meta, hbits, cache_bits) -> np.ndarray:
    """The entropy-coded pixels (libwebp's DecodeImageData)."""
    total = xsize * ysize
    out = [0] * total
    cache = [0] * (1 << cache_bits) if cache_bits else None
    cache_shift = 32 - cache_bits
    last_cached = 0
    mask = (1 << hbits) - 1 if meta is not None else -1
    tiles_w = _div_round_up(xsize, hbits) if meta is not None else 1
    meta_flat = meta.reshape(-1).tolist() if meta is not None else [0]
    group = codes[0]
    pos = col = row = 0
    while pos < total:
        if col & mask == 0:
            group = codes[meta_flat[(row >> hbits) * tiles_w + (col >> hbits)]] \
                if meta is not None else codes[0]
        g = group[0].read(br)
        if g < 256:
            r = group[1].read(br)
            b = group[2].read(br)
            a = group[3].read(br)
            out[pos] = (a << 24) | (r << 16) | (g << 8) | b
            pos += 1
            col += 1
            if col >= xsize:
                col = 0
                row += 1
                if cache is not None:
                    while last_cached < pos:
                        p = out[last_cached]
                        cache[((p * 0x1E35A7BD) & 0xFFFFFFFF) >> cache_shift] = p
                        last_cached += 1
        elif g < 256 + 24:
            length = _prefix_value(g - 256, br)
            dist_code = _prefix_value(group[4].read(br), br)
            if dist_code > 120:
                dist = dist_code - 120
            else:
                d = CODE_TO_PLANE[dist_code - 1]
                dist = max(1, (d >> 4) * xsize + 8 - (d & 15))
            if dist > pos or length > total - pos:
                raise ValueError("bad VP8L backward reference")
            if dist >= length:
                out[pos:pos + length] = out[pos - dist:pos - dist + length]
            else:
                for i in range(pos, pos + length):
                    out[i] = out[i - dist]
            pos += length
            col += length
            while col >= xsize:
                col -= xsize
                row += 1
            if pos < total and col & mask and meta is not None:
                group = codes[meta_flat[(row >> hbits) * tiles_w + (col >> hbits)]]
            if cache is not None:
                while last_cached < pos:
                    p = out[last_cached]
                    cache[((p * 0x1E35A7BD) & 0xFFFFFFFF) >> cache_shift] = p
                    last_cached += 1
        elif cache is not None and g < 256 + 24 + len(cache):
            while last_cached < pos:
                p = out[last_cached]
                cache[((p * 0x1E35A7BD) & 0xFFFFFFFF) >> cache_shift] = p
                last_cached += 1
            out[pos] = cache[g - 280]
            pos += 1
            col += 1
            if col >= xsize:
                col = 0
                row += 1
                while last_cached < pos:
                    p = out[last_cached]
                    cache[((p * 0x1E35A7BD) & 0xFFFFFFFF) >> cache_shift] = p
                    last_cached += 1
        else:
            raise ValueError("bad VP8L symbol")
    return np.array(out, np.uint32).reshape(ysize, xsize)


# --------------------------------------------------------------------------
# inverse transforms
# --------------------------------------------------------------------------


def _channels(p: np.ndarray):
    return [(p >> s).astype(np.int32) & 255 for s in (24, 16, 8, 0)]


def _pack(a, r, g, b) -> np.ndarray:
    return ((np.asarray(a, np.uint32) & 255) << 24) | ((np.asarray(r, np.uint32) & 255) << 16) \
        | ((np.asarray(g, np.uint32) & 255) << 8) | (np.asarray(b, np.uint32) & 255)


def _add(x: int, y: int) -> int:
    return (((x & 0xFF00FF00) + (y & 0xFF00FF00)) & 0xFF00FF00) | \
        (((x & 0x00FF00FF) + (y & 0x00FF00FF)) & 0x00FF00FF)


def _avg2(x: int, y: int) -> int:
    return (((x ^ y) & 0xFEFEFEFE) >> 1) + (x & y)


def _clamp_full(c0: int, c1: int, c2: int) -> int:
    out = 0
    for s in (24, 16, 8, 0):
        v = ((c0 >> s) & 255) + ((c1 >> s) & 255) - ((c2 >> s) & 255)
        out |= (0 if v < 0 else 255 if v > 255 else v) << s
    return out


def _clamp_half(c0: int, c1: int) -> int:
    out = 0
    for s in (24, 16, 8, 0):
        a = (c0 >> s) & 255
        d = a - ((c1 >> s) & 255)
        v = a + (d // 2 if d >= 0 else -((-d) // 2))     # C's truncating division
        out |= (0 if v < 0 else 255 if v > 255 else v) << s
    return out


def _select(t: int, left: int, tl: int) -> int:
    s = 0
    for sh in (24, 16, 8, 0):
        c = (tl >> sh) & 255
        s += abs(((left >> sh) & 255) - c) - abs(((t >> sh) & 255) - c)
    return t if s <= 0 else left


def _predict(mode: int, L: int, T: int, TR: int, TL: int) -> int:
    if mode == 1:
        return L
    if mode == 5:
        return _avg2(_avg2(L, TR), T)
    if mode == 6:
        return _avg2(L, TL)
    if mode == 7:
        return _avg2(L, T)
    if mode == 10:
        return _avg2(_avg2(L, TL), _avg2(T, TR))
    if mode == 11:
        return _select(T, L, TL)
    if mode == 12:
        return _clamp_full(L, T, TL)
    if mode == 13:
        return _clamp_half(_avg2(L, T), TL)
    if mode == 2:
        return T
    if mode == 3:
        return TR
    if mode == 4:
        return TL
    if mode == 8:
        return _avg2(TL, T)
    if mode == 9:
        return _avg2(T, TR)
    return 0xFF000000


_LEFT_MODES = (1, 5, 6, 7, 10, 11, 12, 13)


def _avg2_v(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    return (((x ^ y) & np.uint32(0xFEFEFEFE)) >> np.uint32(1)) + (x & y)


def _add_v(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    hi = np.uint32(0xFF00FF00)
    lo = np.uint32(0x00FF00FF)
    return (((x & hi) + (y & hi)) & hi) | (((x & lo) + (y & lo)) & lo)


def _inverse_predictor(res: np.ndarray, bits: int, sub: np.ndarray) -> np.ndarray:
    h, w = res.shape
    out = np.empty_like(res)
    modes_img = ((sub >> 8) & 15).astype(np.int64)
    first = res[0].tolist()
    acc = _add(first[0], 0xFF000000)
    row0 = [acc]
    for v in first[1:]:
        acc = _add(v, acc)
        row0.append(acc)
    out[0] = np.array(row0, np.uint32)
    cols = np.arange(w)
    for y in range(1, h):
        top = out[y - 1]
        modes = modes_img[y >> bits][cols >> bits]
        modes[0] = 2                                      # the first pixel predicts from T
        tr = np.empty_like(top)
        tr[:-1] = top[1:]
        tr[-1] = _add(int(res[y, 0]), int(top[0]))        # right of the last: this row's first
        tl = np.empty_like(top)
        tl[1:] = top[:-1]
        tl[0] = top[0]
        pred = np.full(w, 0xFF000000, np.uint32)
        for m, v in ((2, top), (3, tr), (4, tl), (8, _avg2_v(tl, top)), (9, _avg2_v(top, tr))):
            sel = modes == m
            if sel.any():
                pred[sel] = v[sel]
        row = _add_v(res[y], pred)
        seq = np.nonzero(np.isin(modes, _LEFT_MODES))[0].tolist()
        if seq:
            rowl = row.tolist()
            resl = res[y].tolist()
            topl = top.tolist() + [rowl[0]]
            ml = modes.tolist()
            for x in seq:
                rowl[x] = _add(resl[x], _predict(ml[x], rowl[x - 1], topl[x], topl[x + 1],
                                                 topl[x - 1]))
            row = np.array(rowl, np.uint32)
        out[y] = row
    return out


def _inverse_cross_color(res: np.ndarray, bits: int, sub: np.ndarray) -> np.ndarray:
    h, w = res.shape
    m = sub[np.arange(h)[:, None] >> bits, np.arange(w)[None, :] >> bits]
    g2r = (m & 255).astype(np.uint8).view(np.int8).astype(np.int32)
    g2b = ((m >> 8) & 255).astype(np.uint8).view(np.int8).astype(np.int32)
    r2b = ((m >> 16) & 255).astype(np.uint8).view(np.int8).astype(np.int32)
    green = ((res >> 8) & 255).astype(np.uint8).view(np.int8).astype(np.int32)
    red = ((res >> 16) & 255).astype(np.int32)
    blue = (res & 255).astype(np.int32)
    red = (red + ((g2r * green) >> 5)) & 255
    blue = blue + ((g2b * green) >> 5)
    blue = (blue + ((r2b * red.astype(np.uint8).view(np.int8).astype(np.int32)) >> 5)) & 255
    return (res & np.uint32(0xFF00FF00)) | (red.astype(np.uint32) << 16) | blue.astype(np.uint32)


def _inverse_subtract_green(res: np.ndarray) -> np.ndarray:
    g = (res >> 8) & 255
    rb = ((res & np.uint32(0x00FF00FF)) + ((g << 16) | g)) & np.uint32(0x00FF00FF)
    return (res & np.uint32(0xFF00FF00)) | rb


def _inverse_color_index(res: np.ndarray, bits: int, palette: np.ndarray, width: int):
    h = res.shape[0]
    idx = ((res >> 8) & 255).astype(np.int64)
    if bits:
        per = 1 << bits
        bpp = 8 >> bits
        shifts = np.arange(per) * bpp
        idx = ((idx[:, :, None] >> shifts) & ((1 << bpp) - 1)).reshape(h, -1)[:, :width]
    table = np.zeros(256, np.uint32)
    table[:len(palette)] = palette[:256]
    return table[idx]


def _image_stream(br: BitReader, xsize: int, ysize: int, level0: bool) -> np.ndarray:
    transforms = []
    width = xsize
    if level0:
        seen = set()
        while br.read(1):
            kind = br.read(2)
            if kind in seen:
                raise ValueError("a VP8L transform used twice")
            seen.add(kind)
            if kind in (0, 1):
                bits = br.read(3) + 2
                sub = _image_stream(br, _div_round_up(width, bits),
                                    _div_round_up(ysize, bits), False)
                transforms.append((kind, bits, sub, width))
            elif kind == 2:
                transforms.append((2, 0, None, width))
            else:
                n = br.read(8) + 1
                bits = 0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3
                pal = _image_stream(br, n, 1, False)[0]
                a, r, g, b = _channels(pal)
                pal = _pack(np.cumsum(a), np.cumsum(r), np.cumsum(g), np.cumsum(b))
                transforms.append((3, bits, pal, width))
                width = _div_round_up(width, bits)
    data = _entropy_image(br, width, ysize, level0)
    for kind, bits, sub, w in reversed(transforms):
        if kind == 0:
            data = _inverse_predictor(data, bits, sub)
        elif kind == 1:
            data = _inverse_cross_color(data, bits, sub)
        elif kind == 2:
            data = _inverse_subtract_green(data)
        else:
            data = _inverse_color_index(data, bits, sub, w)
    return data


def decode_stream(data: bytes, width: int, height: int) -> np.ndarray:
    """A header-less VP8L image stream (an ALPH chunk's) → (H, W) ARGB."""
    return _image_stream(BitReader(data), width, height, True)


def decode(data: bytes) -> tuple[np.ndarray, bool]:
    """A ``VP8L`` chunk's body → ((H, W) ARGB uint32, the header's
    alpha-is-used bit)."""
    from sdwebui_tpu_torch.utils.png import check_image_size

    if len(data) < 5 or data[0] != 0x2F:
        raise ValueError("bad VP8L signature")
    br = BitReader(data, 1)
    width = br.read(14) + 1
    height = br.read(14) + 1
    alpha = br.read(1)
    if br.read(3) != 0:
        raise ValueError("unknown VP8L version")
    check_image_size(width, height)
    return _image_stream(br, width, height, True), bool(alpha)
