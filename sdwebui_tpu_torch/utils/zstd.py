"""A Zstandard frame decoder (RFC 8878), for TIFF's compression 50000.

It takes what libzstd writes into a TIFF strip or tile: one or more frames
(skippable frames skipped; libtiff, and so ``utils/tiff``, reads only a
strip's first frame), each of raw, RLE and compressed blocks.  A
compressed block holds literals (raw, RLE, or Huffman-coded in one or four
streams, with a tree given directly, by FSE-coded weights, or repeated
from the block before) and sequences (literal, match and offset codes
under the predefined, RLE, FSE-described or repeated tables, the three
repeat offsets carried across the frame's blocks).  Dictionaries, which
TIFF never uses, raise ``ValueError``; the optional content checksum is
not verified.  A block that would hold or regenerate more than its
frame's window, or more than 128 KiB (RFC 8878 Block_Maximum_Size), raises
``ValueError``, as libzstd does, and ``limit``
stops the output at the caller's buffer, as libtiff's stream does, so the
bytes a file makes it write are bounded by that buffer and not by its
headers.

It runs one symbol at a time on the host (a Huffman code by one lookup in
a table of the stream's bit windows): a TIFF strip of a few kilobytes
decodes in milliseconds, a 512² RGB image in a few hundred.
"""

from __future__ import annotations

import numpy as np

#: literal-length and match-length codes → (baseline, extra bits)
_LL = [(i, 0) for i in range(16)] + [
    (16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3), (48, 4), (64, 6),
    (128, 7), (256, 8), (512, 9), (1024, 10), (2048, 11), (4096, 12), (8192, 13), (16384, 14),
    (32768, 15), (65536, 16)]
_ML = [(i + 3, 0) for i in range(32)] + [
    (35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3), (67, 4), (83, 4),
    (99, 5), (131, 7), (259, 8), (515, 9), (1027, 10), (2051, 11), (4099, 12), (8195, 13),
    (16387, 14), (32771, 15), (65539, 16)]
#: the predefined distributions (RFC 8878 3.1.1.3.2.2) and their accuracy
_LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1,
                1, 1, 1, 1, -1, -1, -1, -1], 6)
_ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1],
               6)
_OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
                -1, -1, -1], 5)
_MAGIC = 0xFD2FB528
#: RFC 8878 Block_Maximum_Size: the most a block holds or regenerates
BLOCK_MAX = 1 << 17


class _Back:
    """A backward bit stream (RFC 8878 4.1): read from the end, the last
    byte's highest set bit a start marker; bits past the start read 0."""

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            raise ValueError("zstd: a bit stream without its end marker")
        self.data = data
        self.pos = 8 * (len(data) - 1) + data[-1].bit_length() - 1

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        self.pos -= n
        return self.peek_at(self.pos, n)

    def peek_at(self, pos: int, n: int) -> int:
        if pos >= 0:
            lo = pos >> 3
            v = int.from_bytes(self.data[lo:(pos + n + 7) >> 3], "little") >> (pos & 7)
            return v & ((1 << n) - 1)
        if pos + n <= 0:
            return 0
        v = int.from_bytes(self.data[:(pos + n + 7) >> 3], "little")
        return (v << -pos) & ((1 << n) - 1)

    def overflowed(self) -> bool:
        return self.pos < 0


def _read_ncount(data: bytes, pos: int, max_symbol: int) -> tuple[list, int, int]:
    """An FSE table description (RFC 8878 4.1.1) → (normalized counts,
    accuracy log, the position after it)."""
    bits = int.from_bytes(data[pos:pos + 512], "little")     # a description is shorter
    at = 4
    log = (bits & 15) + 5
    if log > 9:
        raise ValueError(f"zstd: FSE accuracy log {log} too large")
    remaining = (1 << log) + 1
    threshold = 1 << log
    nb = log + 1
    counts: list = []
    prev0 = False
    while remaining > 1 and len(counts) <= max_symbol:
        if prev0:
            n0 = len(counts)
            while True:
                rep = (bits >> at) & 3
                at += 2
                n0 += rep
                if rep != 3:
                    break
            counts += [0] * (n0 - len(counts))
            if len(counts) > max_symbol:
                break
        top = 2 * threshold - 1 - remaining
        v = bits >> at
        if (v & (threshold - 1)) < top:
            count = v & (threshold - 1)
            at += nb - 1
        else:
            count = v & (2 * threshold - 1)
            if count >= threshold:
                count -= top
            at += nb
        count -= 1
        remaining -= -count if count < 0 else count
        counts.append(count)
        prev0 = count == 0
        while remaining < threshold:
            nb -= 1
            threshold >>= 1
    if remaining != 1 or len(counts) > max_symbol + 1:
        raise ValueError("zstd: corrupt FSE table description")
    end = pos + ((at + 7) >> 3)
    if end > len(data):
        raise ValueError("zstd: FSE table description past its data")
    return counts, log, end


def _fse_table(counts: list, log: int) -> list:
    """Normalized counts → the decoding table: (symbol, bits, base) per state."""
    size = 1 << log
    symbol = [0] * size
    high = size - 1
    nxt = [0] * len(counts)
    for s, c in enumerate(counts):
        if c == -1:
            symbol[high] = s
            high -= 1
            nxt[s] = 1
        else:
            nxt[s] = c
    step = (size >> 1) + (size >> 3) + 3
    mask = size - 1
    p = 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            symbol[p] = s
            p = (p + step) & mask
            while p > high:
                p = (p + step) & mask
    if p != 0:
        raise ValueError("zstd: corrupt FSE distribution")
    table = []
    for u in range(size):
        s = symbol[u]
        state = nxt[s]
        nxt[s] += 1
        nb = log - (state.bit_length() - 1)
        table.append((s, nb, (state << nb) - size))
    return table


_PREDEFINED = {name: (_fse_table(c, log), log) for name, (c, log) in
               (("ll", _LL_DEFAULT), ("ml", _ML_DEFAULT), ("of", _OF_DEFAULT))}


def _huffman_from_weights(weights: list) -> tuple[list, int]:
    """Huffman weights (the last one implied) → (decoding table indexed by
    the next max-bits bits: (symbol, bits)), max bits)."""
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        raise ValueError("zstd: Huffman weights of no symbol")
    max_bits = total.bit_length()
    left = (1 << max_bits) - total
    if left & (left - 1):
        raise ValueError("zstd: Huffman weights that do not sum to a power of two")
    weights = weights + [left.bit_length()]
    if max_bits > 11:
        raise ValueError(f"zstd: Huffman codes of {max_bits} bits")
    rank = [0] * (max_bits + 2)
    for w in weights:
        rank[w] += 1
    start = [0] * (max_bits + 2)
    nxt = 0
    for w in range(1, max_bits + 1):
        start[w] = nxt
        nxt += rank[w] << (w - 1)
    table = [(0, 0)] * (1 << max_bits)
    for s, w in enumerate(weights):
        if not w:
            continue
        length = (1 << w) >> 1
        entry = (s, max_bits + 1 - w)
        table[start[w]:start[w] + length] = [entry] * length
        start[w] += length
    return table, max_bits


def _huffman_tree(data: bytes, pos: int) -> tuple[tuple, int]:
    """A Huffman tree description → ((table, max bits), position after)."""
    head = data[pos]
    pos += 1
    if head >= 128:
        n = head - 127
        raw = data[pos:pos + (n + 1) // 2]
        pos += (n + 1) // 2
        weights = []
        for b in raw:
            weights += [b >> 4, b & 15]
        weights = weights[:n]
    else:
        end = pos + head
        counts, log, at = _read_ncount(data[:end], pos, 255)
        table = _fse_table(counts, log)
        bits = _Back(data[at:end])
        s1, s2 = bits.read(log), bits.read(log)
        weights = []
        while True:
            for which in (0, 1):
                sym, nb, base = table[s1 if which == 0 else s2]
                weights.append(sym)
                if which == 0:
                    s1 = base + bits.read(nb)
                else:
                    s2 = base + bits.read(nb)
                if bits.overflowed():
                    weights.append(table[s2 if which == 0 else s1][0])
                    break
                if len(weights) > 255:
                    raise ValueError("zstd: too many Huffman weights")
            else:
                continue
            break
        pos = end
    return _huffman_from_weights(weights), pos


def _windows(data: bytes, width: int) -> list:
    """The `width`-bit value ending below each bit position of `data`
    (entry p holds bits [p - width, p), zeros before the start), for
    backward reading by table lookup."""
    bits = np.unpackbits(np.frombuffer(data, np.uint8), bitorder="little").astype(np.int64)
    padded = np.concatenate([np.zeros(width, np.int64), bits])
    win = np.zeros(len(bits) + 1, np.int64)
    for k in range(width):
        win += padded[k:k + len(bits) + 1] << k
    return win.tolist()


def _huffman_stream(data: bytes, count: int, table: list, max_bits: int, out: bytearray):
    pos = _Back(data).pos
    win = _windows(data, max_bits)
    if count > pos + 1:
        raise ValueError("zstd: a Huffman stream shorter than its symbols")
    syms = bytearray(count)
    for i in range(count):
        sym, nb = table[win[pos]]
        syms[i] = sym
        pos -= nb
        if pos < 0:
            raise ValueError("zstd: a Huffman stream read past its start")
    out += syms
    if pos != 0:
        raise ValueError("zstd: a Huffman stream of the wrong length")


class _FrameState:
    def __init__(self):
        self.huffman = None
        self.tables = {"ll": None, "ml": None, "of": None}
        self.reps = [1, 4, 8]


def _literals(data: bytes, pos: int, st: _FrameState) -> tuple[bytes, int]:
    h0 = data[pos]
    kind, fmt = h0 & 3, (h0 >> 2) & 3
    if kind in (0, 1):
        if fmt in (0, 2):
            size, pos = h0 >> 3, pos + 1
        elif fmt == 1:
            size, pos = (h0 >> 4) + (data[pos + 1] << 4), pos + 2
        else:
            size, pos = (h0 >> 4) + (data[pos + 1] << 4) + (data[pos + 2] << 12), pos + 3
        if size > BLOCK_MAX:
            raise ValueError(f"zstd: {size} literals in one block")
        if kind == 0:
            if pos + size > len(data):
                raise ValueError("zstd: raw literals past the block")
            return data[pos:pos + size], pos + size
        return data[pos:pos + 1] * size, pos + 1
    head_len = {0: 3, 1: 3, 2: 4, 3: 5}[fmt]
    h = int.from_bytes(data[pos:pos + head_len], "little")
    bits = {0: 10, 1: 10, 2: 14, 3: 18}[fmt]
    regen = (h >> 4) & ((1 << bits) - 1)
    comp = (h >> (4 + bits)) & ((1 << bits) - 1)
    pos += head_len
    end = pos + comp
    if regen > BLOCK_MAX:
        raise ValueError(f"zstd: {regen} literals in one block")
    if end > len(data):
        raise ValueError("zstd: compressed literals past the block")
    if kind == 2:
        st.huffman, pos = _huffman_tree(data[:end], pos)
    elif st.huffman is None:
        raise ValueError("zstd: treeless literals with no earlier tree")
    table, max_bits = st.huffman
    out = bytearray()
    if fmt == 0:
        _huffman_stream(data[pos:end], regen, table, max_bits, out)
    else:
        s1, s2, s3 = (int.from_bytes(data[pos + 2 * i:pos + 2 * i + 2], "little")
                      for i in range(3))
        at = pos + 6
        sizes = [s1, s2, s3, end - at - s1 - s2 - s3]
        each = (regen + 3) // 4
        for i, size in enumerate(sizes):
            n = each if i < 3 else regen - 3 * each
            _huffman_stream(data[at:at + size], n, table, max_bits, out)
            at += size
    return bytes(out), end


def _seq_table(mode: int, name: str, data: bytes, pos: int, st: _FrameState, max_sym: int):
    if mode == 0:
        st.tables[name] = _PREDEFINED[name]
    elif mode == 1:
        st.tables[name] = ([(data[pos], 0, 0)], 0)
        pos += 1
    elif mode == 2:
        counts, log, pos = _read_ncount(data, pos, max_sym)
        st.tables[name] = (_fse_table(counts, log), log)
    elif st.tables[name] is None:
        raise ValueError(f"zstd: a repeated {name} table with none before")
    return pos


def _block(data: bytes, st: _FrameState, out: bytearray, block_max: int) -> None:
    """One compressed block appended to `out`; it may regenerate at most
    `block_max` bytes."""
    cap = len(out) + block_max
    literals, pos = _literals(data, 0, st)
    b0 = data[pos]
    if b0 == 0:
        out += literals
        return
    if b0 < 128:
        nseq, pos = b0, pos + 1
    elif b0 < 255:
        nseq, pos = ((b0 - 128) << 8) + data[pos + 1], pos + 2
    else:
        nseq, pos = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00, pos + 3
    modes = data[pos]
    pos += 1
    pos = _seq_table(modes >> 6, "ll", data, pos, st, 35)
    pos = _seq_table((modes >> 4) & 3, "of", data, pos, st, 31)
    pos = _seq_table((modes >> 2) & 3, "ml", data, pos, st, 52)
    (ll_t, ll_log), (of_t, of_log), (ml_t, ml_log) = (st.tables[k] for k in ("ll", "of", "ml"))
    bits = _Back(data[pos:])
    read = bits.read
    ll_s, of_s, ml_s = read(ll_log), read(of_log), read(ml_log)
    reps = st.reps
    lit = 0
    for i in range(nseq):
        of_code = of_t[of_s][0]
        ml_code = ml_t[ml_s][0]
        ll_code = ll_t[ll_s][0]
        if of_code > 31 or ml_code > 52 or ll_code > 35:
            raise ValueError("zstd: a sequence code out of range")
        value = (1 << of_code) + read(of_code)
        base, extra = _ML[ml_code]
        ml = base + read(extra)
        base, extra = _LL[ll_code]
        ll = base + read(extra)
        if value > 3:
            offset = value - 3
            reps[2], reps[1], reps[0] = reps[1], reps[0], offset
        else:
            k = value - 1 if ll else value
            if k == 0:
                offset = reps[0]
            elif k == 3:
                offset = reps[0] - 1
                reps[2], reps[1], reps[0] = reps[1], reps[0], offset
            else:
                offset = reps[k]
                if k == 2:
                    reps[2] = reps[1]
                reps[1], reps[0] = reps[0], offset
        if i + 1 < nseq:
            _, nb, b = ll_t[ll_s]
            ll_s = b + read(nb)
            _, nb, b = ml_t[ml_s]
            ml_s = b + read(nb)
            _, nb, b = of_t[of_s]
            of_s = b + read(nb)
        if lit + ll > len(literals):
            raise ValueError("zstd: a sequence past its literals")
        if len(out) + ll + ml > cap:
            raise ValueError("zstd: a block that regenerates more than its maximum")
        out += literals[lit:lit + ll]
        lit += ll
        if offset <= 0 or offset > len(out):
            raise ValueError("zstd: a match before the start of the output")
        start = len(out) - offset
        if offset >= ml:
            out += out[start:start + ml]
        else:
            chunk = out[start:]
            out += (chunk * (ml // offset + 1))[:ml]
    if bits.pos != 0:
        raise ValueError("zstd: a sequence bit stream of the wrong length")
    if len(out) + len(literals) - lit > cap:
        raise ValueError("zstd: a block that regenerates more than its maximum")
    out += literals[lit:]


def decompress(data: bytes, frames: int | None = None, limit: int | None = None) -> bytes:
    """Zstandard frames → their content; `frames` stops after that many
    frames, a skippable one included (libtiff decodes one a strip), and
    `limit` after that many bytes of content (libtiff's strip buffer): the
    output then holds the first `limit` bytes, decoded one block at a time,
    never more than a block past them."""
    out = bytearray()
    pos, n = 0, len(data)
    full = limit is not None and limit <= 0
    while pos < n and frames != 0 and not full:
        if frames is not None:
            frames -= 1
        if n - pos < 4:
            raise ValueError("zstd: truncated frame")
        magic = int.from_bytes(data[pos:pos + 4], "little")
        if magic & 0xFFFFFFF0 == 0x184D2A50:
            size = int.from_bytes(data[pos + 4:pos + 8], "little")
            pos += 8 + size
            continue
        if magic != _MAGIC:
            if out:
                break
            raise ValueError("not a Zstandard frame")
        desc = data[pos + 4]
        pos += 5
        fcs_flag, single, checksum, dict_flag = desc >> 6, (desc >> 5) & 1, (desc >> 2) & 1, \
            desc & 3
        if desc & 8:
            raise ValueError("zstd: reserved frame header bit set")
        if not single:
            exponent, mantissa = data[pos] >> 3, data[pos] & 7
            window = (1 << (10 + exponent)) + ((1 << (7 + exponent)) * mantissa)
            pos += 1
        if dict_flag:
            dict_id = int.from_bytes(data[pos:pos + (1, 2, 4)[dict_flag - 1]], "little")
            pos += (1, 2, 4)[dict_flag - 1]
            if dict_id:
                raise ValueError("zstd: frames that need a dictionary are not read")
        fcs_len = (1 if single else 0, 2, 4, 8)[fcs_flag]
        if single:      # the window is the content, as libzstd takes it
            window = int.from_bytes(data[pos:pos + fcs_len], "little") + (256 if fcs_len == 2
                                                                           else 0)
        pos += fcs_len
        block_max = min(window, BLOCK_MAX)
        st = _FrameState()
        while True:
            if pos + 3 > n:
                raise ValueError("zstd: truncated block header")
            head = int.from_bytes(data[pos:pos + 3], "little")
            pos += 3
            last, kind, size = head & 1, (head >> 1) & 3, head >> 3
            if size > block_max:
                raise ValueError(f"zstd: a block of {size} bytes, more than its maximum "
                                 f"{block_max}")
            if kind == 0:
                if pos + size > n:
                    raise ValueError("zstd: truncated raw block")
                out += data[pos:pos + size]
                pos += size
            elif kind == 1:
                out += data[pos:pos + 1] * size
                pos += 1
            elif kind == 2:
                if pos + size > n:
                    raise ValueError("zstd: truncated compressed block")
                _block(data[pos:pos + size], st, out, block_max)
                pos += size
            else:
                raise ValueError("zstd: reserved block type")
            if limit is not None and len(out) >= limit:
                full = True
                break
            if last:
                break
        if checksum:
            pos += 4
    return bytes(out if limit is None else out[:limit])
