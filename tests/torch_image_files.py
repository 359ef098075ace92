"""Image files in the variants the port reads but never writes, for decoder
tests and the card's smoke run: PNG at every bit depth and interlaced, BMP
with RLE, bitfields, top-down rows and the other headers, TIFF compressed
with PackBits, LZW (with the horizontal predictor), Deflate, LZMA,
Zstandard (raw and RLE blocks), JPEG and CCITT (Modified Huffman, Group 3
1-D and 2-D, Group 4), in strips, tiles or planes, either fill order, in
grey, RGB, CMYK, YCbCr or float samples; a palette BMP as Pillow writes
it; and the rarer formats (``rare_files``: TGA, Netpbm, SGI, PCX and DCX,
ICO, CUR, ICNS, PSD, DDS with BC1 / BC3 / BC7, FTEX, BLP, IM, IMT, SUN,
MSP, XBM, XPM, PIXAR, SPIDER, GBR, XV thumbnails, FITS, McIdas, IPTC, FLI
and PCD).  numpy and the standard library only, so that it also runs
where Pillow is absent."""

from __future__ import annotations

import lzma
import os
import struct
import zlib

import numpy as np

from sdwebui_tpu_torch.utils.png import _ADAM7

# --------------------------------------------------------------------------
# PNG
# --------------------------------------------------------------------------


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, c) samples → (h, row bytes) uint8, MSB first, big-endian."""
    h, w, c = samples.shape
    if depth == 16:
        return np.frombuffer(samples.astype(">u2").tobytes(), np.uint8).reshape(h, w * c * 2)
    if depth == 8:
        return samples.reshape(h, w * c).astype(np.uint8)
    per = 8 // depth
    flat = samples.reshape(h, w * c)
    flat = np.pad(flat, ((0, 0), (0, -flat.shape[1] % per))).reshape(h, -1, per).astype(np.uint8)
    out = np.zeros(flat.shape[:2], np.uint8)
    for i in range(per):
        out |= flat[:, :, i] << (8 - depth * (i + 1))
    return out


def _filtered(rows: np.ndarray, bpp: int, seed: int) -> bytes:
    """Each row under filter None, Sub or Up, picked from a seed."""
    h, n = rows.shape
    kinds = np.random.default_rng(seed).integers(0, 3, h)
    r = rows.astype(np.int16)
    left = np.zeros_like(r)
    left[:, bpp:] = r[:, :-bpp]
    up = np.zeros_like(r)
    up[1:] = r[:-1]
    pred = np.where(kinds[:, None] == 1, left, np.where(kinds[:, None] == 2, up, 0))
    out = np.empty((h, n + 1), np.uint8)
    out[:, 0] = kinds
    out[:, 1:] = (r - pred) & 255
    return out.tobytes()


def png_file(samples: np.ndarray, depth: int, ctype: int, interlace: bool = False,
             palette: np.ndarray | None = None, trns: bytes | None = None, seed: int = 0) -> bytes:
    """A PNG of (H, W, C) samples (uint8 or uint16 for depth 16) at `depth`
    bits and colour type `ctype`, optionally Adam7-interlaced."""
    h, w, c = samples.shape
    bpp = max(1, depth * c // 8)
    if interlace:
        subs = [samples[y0::dy, x0::dx] for x0, y0, dx, dy in _ADAM7]
        raw = b"".join(_filtered(_pack(s, depth), bpp, seed + i) for i, s in enumerate(subs)
                       if s.size)
    else:
        raw = _filtered(_pack(samples, depth), bpp, seed)
    parts = [b"\x89PNG\r\n\x1a\n",
             _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))]
    if palette is not None:
        parts.append(_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes()))
    if trns is not None:
        parts.append(_chunk(b"tRNS", trns))
    parts += [_chunk(b"IDAT", zlib.compress(raw, 6)), _chunk(b"IEND", b"")]
    return b"".join(parts)


# --------------------------------------------------------------------------
# BMP
# --------------------------------------------------------------------------


def _rle8_rows(index: np.ndarray) -> bytes:
    """BI_RLE8: runs of equal bytes, absolute runs of the rest, one
    end-of-line a row, end of bitmap."""
    out = bytearray()
    for row in index:
        row = bytes(row)
        x = 0
        while x < len(row):
            run = 1
            while x + run < len(row) and run < 255 and row[x + run] == row[x]:
                run += 1
            if run >= 3 or len(row) - x < 3:
                out += bytes([run, row[x]])
                x += run
                continue
            end = x
            while end < len(row) and end - x < 255 and not (
                    end + 2 < len(row) and row[end] == row[end + 1] == row[end + 2]):
                end += 1
            if end - x < 3:
                out += bytes([1, row[x]])
                x += 1
                continue
            out += bytes([0, end - x]) + row[x:end] + (b"\0" if (end - x) & 1 else b"")
            x = end
        out += b"\0\0"
    return bytes(out + b"\0\1")


def _rle4_rows(index: np.ndarray) -> bytes:
    """BI_RLE4: runs of one alternating pair of nibbles, one end-of-line a
    row, end of bitmap."""
    out = bytearray()
    for row in index:
        x = 0
        while x < len(row):
            run = 1
            while x + run < len(row) and run < 255 and row[x + run] == row[x + (run & 1)]:
                run += 1
            second = row[x + 1] if run > 1 else 0
            out += bytes([run, (int(row[x]) << 4) | int(second)])
            x += run
        out += b"\0\0"
    return bytes(out + b"\0\1")


def bmp_file(image: np.ndarray, kind: str, palette: np.ndarray | None = None) -> bytes:
    """A BMP the port's writer never makes: `kind` is "rle8" or "rle4"
    ((H, W) indices into `palette`, or a seeded palette of 256 or 16
    colours), "4bit" (indices, palette), "555" / "565" (RGB through 16-bit
    pixels), "bgra" (RGBA through BI_BITFIELDS with an alpha mask, V5
    header), "top-down" (24-bit, negative height) or "os2" (24-bit, 12-byte
    header)."""
    a = np.asarray(image)
    h, w = a.shape[:2]
    header, compression, masks, table = 40, 0, b"", b""
    height = h
    if kind in ("rle8", "rle4", "4bit"):
        colors = 256 if kind == "rle8" else 16
        pal = np.random.default_rng(colors).integers(0, 256, (colors, 3), dtype=np.uint8)
        if palette is not None:
            pal[:len(palette)] = palette
        table = np.concatenate([pal[:, ::-1], np.zeros((colors, 1), np.uint8)], 1).tobytes()
        bits = 8 if kind == "rle8" else 4
        rows = a[::-1]
        if kind == "4bit":
            stride = ((w * 4 + 31) >> 5) << 2
            packed = _pack(rows[:, :, None], 4)
            body = np.zeros((h, stride), np.uint8)
            body[:, :packed.shape[1]] = packed
            data = body.tobytes()
        else:
            compression = 1 if kind == "rle8" else 2
            data = _rle8_rows(rows) if kind == "rle8" else _rle4_rows(rows)
    elif kind in ("555", "565"):
        bits = 16
        r, g, b = (a[:, :, i].astype(np.uint16) for i in range(3))
        if kind == "555":
            v = ((r >> 3) << 10) | ((g >> 3) << 5) | (b >> 3)
        else:
            v = ((r >> 3) << 11) | ((g >> 2) << 5) | (b >> 3)
            compression, masks = 3, struct.pack("<III", 0xF800, 0x7E0, 0x1F)
        stride = ((w * 16 + 31) >> 5) << 2
        body = np.zeros((h, stride), np.uint8)
        body[:, :w * 2] = v[::-1].astype("<u2").view(np.uint8).reshape(h, -1)
        data = body.tobytes()
    elif kind == "bgra":
        bits, compression, header = 32, 3, 124
        data = a[::-1][:, :, [2, 1, 0, 3]].tobytes()
    elif kind in ("top-down", "os2"):
        bits = 24
        stride = ((w * 24 + 31) >> 5) << 2
        body = np.zeros((h, stride), np.uint8)
        rows = a if kind == "top-down" else a[::-1]
        body[:, :w * 3] = rows[:, :, ::-1].reshape(h, -1)
        data = body.tobytes()
        if kind == "top-down":
            height = -h
        else:
            header = 12
    else:
        raise ValueError(kind)
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, height, 1, bits, compression, len(data),
                           2835, 2835, len(table) // 4, 0)
        if header == 124:
            info += struct.pack("<IIII", 0xFF0000, 0xFF00, 0xFF, 0xFF000000)
            info += b"\0" * (124 - len(info))
    offset = 14 + len(info) + len(masks) + len(table)
    return (b"BM" + struct.pack("<III", offset + len(data), 0, offset) + info + masks + table
            + data)


def bmp_palette_file(indices: np.ndarray, palette: np.ndarray) -> bytes:
    """The BMP Pillow writes for a "P" image of (H, W) `indices` into
    `palette` ((N, 3) uint8): 8 bits, N colours, 96 dpi, bottom-up rows."""
    h, w = indices.shape
    pal = np.asarray(palette, np.uint8).reshape(-1, 3)
    table = np.concatenate([pal[:, ::-1], np.zeros((len(pal), 1), np.uint8)], 1).tobytes()
    stride = (w + 3) & ~3
    body = np.zeros((h, stride), np.uint8)
    body[:, :w] = indices[::-1]
    offset = 14 + 40 + len(table)
    return (b"BM" + struct.pack("<III", offset + body.size, 0, offset)
            + struct.pack("<IiiHHIIiiII", 40, w, h, 1, 8, 0, body.size, 3780, 3780, len(pal),
                          len(pal))
            + table + body.tobytes())


# --------------------------------------------------------------------------
# TIFF
# --------------------------------------------------------------------------

def lzw_tiff(data: bytes) -> bytes:
    """Bytes → one TIFF LZW strip (MSB-first codes, early change, the table
    cleared when it is full), as libtiff writes it."""
    out = bytearray()
    acc = nacc = 0
    size = 9

    def emit(code: int):
        nonlocal acc, nacc
        acc = (acc << size) | code
        nacc += size
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 255)
        acc &= (1 << nacc) - 1

    def grow():
        nonlocal dec_len, size, first
        if not first and dec_len < 4096:
            dec_len += 1
            if dec_len == (1 << size) - 1 and size < 12:
                size += 1
        first = False

    emit(256)
    table: dict = {}
    next_code, dec_len, first = 258, 258, True
    if data:
        prefix = data[0]
        for b in data[1:]:
            key = (prefix << 8) | b
            code = table.get(key)
            if code is not None:
                prefix = code
                continue
            emit(prefix)
            grow()
            table[key] = next_code
            next_code += 1
            if next_code == 4094:
                emit(256)
                table.clear()
                next_code, dec_len, first, size = 258, 258, True, 9
            prefix = b
        emit(prefix)
        grow()
    emit(257)
    if nacc:
        out.append((acc << (8 - nacc)) & 255)
    return bytes(out)


_TYPES = {1: "B", 3: "H", 4: "I", 5: "I", 7: "B"}    # rationals: two longs a value
_WIDE = (np.dtype(np.float32), np.dtype(np.int16), np.dtype(np.int32))
_BIT_REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _packbits(row: bytes) -> bytes:
    out = bytearray()
    i = 0
    while i < len(row):
        run = 1
        while i + run < len(row) and run < 128 and row[i + run] == row[i]:
            run += 1
        if run >= 2:
            out += bytes([257 - run, row[i]])
            i += run
            continue
        j = i
        while j < len(row) and j - i < 128 and not (j + 1 < len(row) and row[j] == row[j + 1]):
            j += 1
        out += bytes([j - i - 1]) + row[i:j]
        i = j
    return bytes(out)


def tiff_file(image: np.ndarray, compression: str = "none", predictor: bool = False,
              big_endian: bool = False, rows_per_strip: int | None = None,
              tile: int | None = None, planar: bool = False, depth: int = 8,
              photometric: int | None = None, palette: np.ndarray | None = None,
              extra: int | None = None, fill_order: int = 1, tags: dict | None = None,
              encoder=None, seed: int = 0) -> bytes:
    """A TIFF of (H, W[, C]) samples (uint16 for depth 16; 1/2/4-bit samples
    as uint8): `compression` "none", "packbits", "lzw", "deflate" (8) or
    "zip" (32946), the horizontal predictor, strips of `rows_per_strip`
    rows or square tiles of `tile`, chunky or planar, either byte order;
    `photometric` 0 (white is zero), 1, 2, 3 (with `palette`, (2**depth,
    3) uint16), 5 or 6; `extra` the ExtraSamples value of a fourth (or
    second) sample.  Also "lzma", "zstd" (raw and RLE blocks, split from
    `seed`), "ccitt", "g3" and "g4" (1-bit samples, 1 coded black; `tags`
    292 = 1 for 2-D Group 3 rows) and "jpeg" (with `encoder`, a callable of
    a strip's samples); float32 and int16 / int32 samples as they are;
    `fill_order` 2 reverses each byte's bits; `tags` adds or replaces
    entries, {tag: (type, values)}."""
    a = np.asarray(image)
    if a.ndim == 2:
        a = a[:, :, None]
    h, w, c = a.shape
    order = ">" if big_endian else "<"
    t4 = (tags or {}).get(292, (4, [0]))[1][0]
    if a.dtype in _WIDE:
        depth = 8 * a.dtype.itemsize
    if photometric is None:
        photometric = 2 if c >= 3 else 1
    code = {"none": 1, "packbits": 32773, "lzw": 5, "deflate": 8, "zip": 32946, "lzma": 34925,
            "zstd": 50000, "jpeg": 7, "ccitt": 2, "g3": 3, "g4": 4}[compression]

    def encode(block: np.ndarray) -> bytes:
        """(rows, cols, samples) → one strip or tile, compressed."""
        rows, cols, s = block.shape
        b = block.astype(np.int64)
        if predictor:
            mod = 1 << depth
            diff = b.copy()
            diff[:, 1:] = (b[:, 1:] - b[:, :-1]) % mod
            b = diff
        if encoder is not None:
            return encoder(block)
        if code in (2, 3, 4):
            return ccitt_encode(block[:, :, 0], {2: "rle", 3: "g3", 4: "g4"}[code], t4)
        if block.dtype in _WIDE:
            raw = block.astype(order + block.dtype.str[1:]).tobytes()
            row_bytes = cols * s * block.dtype.itemsize
        elif depth == 16:
            raw = b.astype(order + "u2").tobytes()
            row_bytes = cols * s * 2
        else:
            packed = _pack(b.astype(np.uint8).reshape(rows, cols * s, 1), depth)
            raw = packed.tobytes()
            row_bytes = packed.shape[1]
        if code == 1:
            return raw
        if code == 32773:
            return b"".join(_packbits(raw[i:i + row_bytes]) for i in range(0, len(raw), row_bytes))
        if code == 5:
            return lzw_tiff(raw)
        if code == 34925:
            return lzma.compress(raw, format=lzma.FORMAT_XZ)
        if code == 50000:
            return zstd_frames(raw, seed)
        return zlib.compress(raw)

    planes = [a[:, :, i:i + 1] for i in range(c)] if planar else [a]
    chunks = []
    if tile:
        for p in planes:
            for ty in range(0, h, tile):
                for tx in range(0, w, tile):
                    t = np.zeros((tile, tile, p.shape[2]), a.dtype)
                    part = p[ty:ty + tile, tx:tx + tile]
                    t[:part.shape[0], :part.shape[1]] = part
                    chunks.append(encode(t))
    else:
        rps = rows_per_strip or h
        for p in planes:
            for y in range(0, h, rps):
                chunks.append(encode(p[y:y + rps]))
    extra_tags = dict(tags or {})
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [depth] * c), 259: (3, [code]),
            262: (3, [photometric]), 277: (3, [c])}
    if planar:
        tags[284] = (3, [2])
    if predictor:
        tags[317] = (3, [2])
    if palette is not None:
        tags[320] = (3, list(np.asarray(palette, np.uint16).T.reshape(-1)))
    if extra is not None:
        tags[338] = (3, [extra])
    if fill_order != 1:
        tags[266] = (3, [fill_order])
        chunks = [bytes(_BIT_REVERSED[np.frombuffer(x, np.uint8)]) for x in chunks]
    if a.dtype in _WIDE:
        tags[339] = (3, [3 if a.dtype.kind == "f" else 2] * c)
    tags.update(extra_tags)
    if tile:
        tags[322] = (3, [tile])
        tags[323] = (3, [tile])
        offsets_tag, counts_tag = 324, 325
    else:
        tags[278] = (4, [rows_per_strip or h])
        offsets_tag, counts_tag = 273, 279
    tags[offsets_tag] = (4, [0] * len(chunks))
    tags[counts_tag] = (4, [len(x) for x in chunks])
    n = len(tags)
    ifd_size = 2 + 12 * n + 4
    extra_at = 8 + ifd_size
    blobs = bytearray()
    data_at = extra_at + sum(len(v) * struct.calcsize(_TYPES[t]) for t, v in tags.values()
                             if len(v) * struct.calcsize(_TYPES[t]) > 4)
    offs, pos = [], data_at
    for x in chunks:
        offs.append(pos)
        pos += len(x)
    tags[offsets_tag] = (4, offs)
    entries = bytearray()
    for tag in sorted(tags):
        typ, vals = tags[tag]
        raw = struct.pack(order + _TYPES[typ] * len(vals), *vals)
        count = len(vals) // 2 if typ == 5 else len(vals)
        if len(raw) <= 4:
            entries += struct.pack(order + "HHI", tag, typ, count) + raw.ljust(4, b"\0")
        else:
            entries += struct.pack(order + "HHII", tag, typ, count, extra_at + len(blobs))
            blobs += raw
    head = (b"MM\x00*" if big_endian else b"II*\x00") + struct.pack(order + "I", 8)
    return (head + struct.pack(order + "H", n) + bytes(entries) + struct.pack(order + "I", 0)
            + bytes(blobs) + b"".join(chunks))


# --------------------------------------------------------------------------
# TIFF codecs: CCITT, Zstandard, YCbCr
# --------------------------------------------------------------------------

_CCITT = None


def _ccitt_tables():
    """The T.4 run codes ({run: code} for white and black), from the port's
    decoder tables."""
    global _CCITT
    if _CCITT is None:
        from sdwebui_tpu_torch.utils import ccitt as c
        _CCITT = tuple({n: code for code, n in table.items()} for table in c._RUNS)
    return _CCITT


def _run_code(run: int, colour: int) -> str:
    codes = _ccitt_tables()[colour]
    out = ""
    while run >= 2560 + 64:
        out += codes[2560]
        run -= 2560
    if run >= 64:
        out += codes[run // 64 * 64]
        run %= 64
    return out + codes[run]


def _runs(row: np.ndarray) -> list:
    """A row of 0/1 (1 coded black) → run lengths, white first."""
    edges = np.flatnonzero(np.diff(np.concatenate([[0], row.astype(np.int8), [2]])) != 0)
    bounds = np.concatenate([[0], edges])
    runs = list(np.diff(bounds))
    if row[-1] == 1:
        runs = runs[:-1] + [runs[-1]]
    return [int(r) for r in runs][:len(runs)]


def _row_runs(row: np.ndarray) -> list:
    w = len(row)
    out, x, colour = [], 0, 0
    while x < w:
        end = x
        while end < w and row[end] == colour:
            end += 1
        out.append(end - x)
        x, colour = end, colour ^ 1
    return out


def ccitt_encode(bits: np.ndarray, kind: str, t4_options: int = 0) -> bytes:
    """(rows, cols) 0/1 samples → CCITT data: "rle" (byte-aligned Modified
    Huffman rows), "g3" (an EOL before each row; 2-D rows, coded in
    horizontal mode, when `t4_options` bit 0 is set) or "g4" (horizontal
    mode rows, then EOFB)."""
    out = []
    for y, row in enumerate(np.asarray(bits)):
        runs = _row_runs(row)
        one_d = "".join(_run_code(r, i & 1) for i, r in enumerate(runs))
        if len(runs) % 2:
            runs = runs + [0]
        two_d = "".join("001" + _run_code(runs[i], 0) + _run_code(runs[i + 1], 1)
                        for i in range(0, len(runs), 2))
        if kind == "rle":
            out.append(one_d + "0" * (-len(one_d) % 8))
        elif kind == "g3":
            tag = ("1" if y % 2 == 0 else "0") if t4_options & 1 else ""
            body = one_d if not tag or tag == "1" else two_d
            out.append("000000000001" + tag + body)
        else:
            out.append(two_d)
    if kind == "g4":
        out.append("000000000001" * 2)
    s = "".join(out)
    s += "0" * (-len(s) % 8)
    return np.packbits(np.frombuffer(s.encode(), np.uint8) - 48).tobytes()


def zstd_frames(data: bytes, seed: int = 0, split: bool = False) -> bytes:
    """A Zstandard frame of raw and RLE blocks of seeded sizes (an RLE block
    for each stretch of one byte value); with `split`, a skippable frame,
    then the data over one or two frames (libtiff reads one frame a strip)."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    cut = len(data)
    if split:
        out += struct.pack("<II", 0x184D2A50 + int(rng.integers(0, 16)), 3) + b"sk!"
        if len(data) > 1 and rng.random() < 0.5:
            cut = int(rng.integers(0, len(data) + 1))
    for part in (data[:cut], data[cut:]):
        if not part and cut != len(data):
            continue
        out += struct.pack("<IB", 0xFD2FB528, 0x20 | (2 << 6)) + struct.pack("<I", len(part))
        pos = 0
        blocks = []
        while pos < len(part):
            size = int(rng.integers(1, 4096))
            chunk = part[pos:pos + size]
            run = 1
            while run < len(chunk) and chunk[run] == chunk[0]:
                run += 1
            if run >= 8 or run == len(chunk):
                blocks.append((1, chunk[:run], run))
                pos += run
            else:
                blocks.append((0, chunk, len(chunk)))
                pos += len(chunk)
        if not blocks:
            blocks = [(0, b"", 0)]
        for i, (kind, chunk, size) in enumerate(blocks):
            last = i == len(blocks) - 1
            out += struct.pack("<I", last | (kind << 1) | (size << 3))[:3]
            out += chunk[:1] if kind == 1 else chunk
    return bytes(out)


def ycbcr_tiff(rgb: np.ndarray, sub=(2, 2), compression: str = "none") -> bytes:
    """A YCbCr TIFF (photometric 6) of an RGB image: JPEG's full-range
    conversion, the chroma of each sub[0] × sub[1] unit its top-left
    pixel's, in chunky data units."""
    a = np.asarray(rgb, np.float64)
    h, w, _ = a.shape
    sh, sv = sub
    ycc = np.stack([0.299 * a[..., 0] + 0.587 * a[..., 1] + 0.114 * a[..., 2],
                    128 - 0.168736 * a[..., 0] - 0.331264 * a[..., 1] + 0.5 * a[..., 2],
                    128 + 0.5 * a[..., 0] - 0.418688 * a[..., 1] - 0.081312 * a[..., 2]], 2)
    ycc = np.clip(np.round(ycc), 0, 255).astype(np.uint8)
    uy, ux = -(-h // sv), -(-w // sh)
    pad = np.zeros((uy * sv, ux * sh, 3), np.uint8)
    pad[:h, :w] = ycc
    units = []
    ys = pad[:, :, 0].reshape(uy, sv, ux, sh).transpose(0, 2, 1, 3).reshape(uy, ux, sv * sh)
    cb = pad[::sv, ::sh, 1][:, :, None]
    cr = pad[::sv, ::sh, 2][:, :, None]
    units = np.concatenate([ys, cb, cr], axis=2).tobytes()

    def encoder(block):
        raw = units
        return raw if compression == "none" else zlib.compress(raw)
    return tiff_file(np.zeros((h, w, 3), np.uint8), "none" if compression == "none" else
                     "deflate", photometric=6, encoder=encoder,
                     tags={530: (3, list(sub)), 532: (5, [0, 1, 255, 1, 128, 1, 255, 1,
                                                          128, 1, 255, 1])})


# --------------------------------------------------------------------------
# the rarer formats
# --------------------------------------------------------------------------

def _rle_packets(rows: bytes, px: int) -> bytes:
    """TGA RLE: runs of equal pixels (2-128) as run packets, the rest raw."""
    n = len(rows) // px
    pix = [rows[i * px:(i + 1) * px] for i in range(n)]
    out, i = bytearray(), 0
    while i < n:
        run = 1
        while i + run < n and run < 128 and pix[i + run] == pix[i]:
            run += 1
        if run > 1:
            out += bytes([0x80 | (run - 1)]) + pix[i]
            i += run
            continue
        j = i
        while j < n and j - i < 128 and not (j + 1 < n and pix[j] == pix[j + 1]):
            j += 1
        out += bytes([j - i - 1]) + b"".join(pix[i:j])
        i = j
    return bytes(out)


def _555(rgb: np.ndarray) -> np.ndarray:
    """RGB (..., 3+) → 5-5-5 uint16, red in the top bits."""
    r, g, b = (rgb[..., ch].astype(np.uint16) >> 3 for ch in range(3))
    return (r << 10) | (g << 5) | b


def tga_file(image: np.ndarray, rle: bool = False, top: bool = False, right: bool = False,
             palette: np.ndarray | None = None, map_depth: int = 24,
             bits16: bool = False, id_section: bytes = b"") -> bytes:
    """A TGA: true colour (BGR / BGRA, or 5-5-5 with `bits16`, its top bit
    an inverted alpha), grey, or indices through `palette` ((N, 3) RGB,
    stored at `map_depth` 16, 24 or 32 bits), raw or RLE (runs across
    rows), with its origin top and / or right."""
    a = np.asarray(image)
    if a.ndim == 2:
        a = a[:, :, None]
    h, w, c = a.shape
    cmap_head = b"\0\0\0\0\0"
    cmap = b""
    if palette is not None:
        itype, depth = 1, 8
        pal = np.asarray(palette, np.uint8)
        if map_depth == 16:
            cmap = _555(pal).astype("<u2").tobytes()
        else:
            bgr = pal[:, ::-1]
            if map_depth == 32:
                bgr = np.concatenate([bgr, np.full((len(pal), 1), 255, np.uint8)], 1)
            cmap = bgr.tobytes()
        cmap_head = struct.pack("<HHB", 0, len(pal), map_depth)
        pixels = a
    elif bits16:
        itype, depth = 2, 16
        v = _555(a)
        if c == 4:
            v |= np.where(a[:, :, 3] < 128, 0x8000, 0).astype(np.uint16)
        pixels = v.astype("<u2").view(np.uint8).reshape(h, w, 2)
    elif c <= 2:
        itype, depth = 3, 8 * c
        pixels = a
    else:
        itype, depth = 2, 8 * c
        pixels = np.concatenate([a[:, :, 2::-1], a[:, :, 3:]], axis=2)
    if not top:
        pixels = pixels[::-1]
    if right:
        pixels = pixels[:, ::-1]
    body = np.ascontiguousarray(pixels).tobytes()
    if rle:
        itype |= 8
        body = _rle_packets(body, max(1, depth // 8))
    flags = (0x20 if top else 0) | (0x10 if right else 0) | (8 if c in (2, 4) and not bits16 else 0)
    head = struct.pack("<BB", len(id_section), 1 if palette is not None else 0) + bytes([itype]) \
        + cmap_head + struct.pack("<HHHHBB", 0, 0, w, h, depth, flags)
    return head + id_section + cmap + body


def _bgra15_expected(a: np.ndarray) -> np.ndarray:
    """The pixels a 16-bit TGA of `a` reads back as (5 bits a channel)."""
    v = (a[:, :, :3].astype(np.int32) >> 3) * 255 // 31
    return v.astype(np.uint8)


def pcx_file(index: np.ndarray, palette: np.ndarray | None, bits: int = 8,
             planes: int = 1) -> bytes:
    """A PCX of palette indices: 8-bit (the 769-byte palette trailer, or
    a grey ramp with `palette` None), 1-bit (one plane) or 1-bit in 4
    planes (the header's 16 colours), each row of planes RLE-coded."""
    h, w = index.shape
    stride = (w * bits + 7) // 8
    stride += stride % 2
    if bits == 8:
        lines = [index[y].tobytes().ljust(stride, b"\0") for y in range(h)]
    else:
        lines = []
        for y in range(h):
            for p in range(planes):
                plane = ((index[y] >> p) & 1).astype(np.uint8)
                lines.append(np.packbits(plane).tobytes().ljust(stride, b"\0"))
    body = bytearray()
    for line in lines:
        i = 0
        while i < len(line):
            run = 1
            while i + run < len(line) and run < 63 and line[i + run] == line[i]:
                run += 1
            if run > 1 or line[i] >= 0xC0:
                body += bytes([0xC0 | run, line[i]])
            else:
                body.append(line[i])
            i += run
    head_pal = bytes(48)
    if bits == 1 and planes == 4:
        head_pal = np.asarray(palette, np.uint8)[:16].tobytes().ljust(48, b"\0")
    head = (struct.pack("<BBBBHHHHHH", 10, 5, 1, bits, 0, 0, w - 1, h - 1, 72, 72) + head_pal
            + b"\0" + struct.pack("<BHHHH", planes, stride, 1, w, h) + bytes(54))
    tail = b""
    if bits == 8:
        pal = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1) if palette is None \
            else np.asarray(palette, np.uint8)
        tail = b"\x0c" + pal.tobytes().ljust(768, b"\0")
    return head + bytes(body) + tail


def dcx_file(pages: list) -> bytes:
    """A DCX holding PCX `pages`."""
    at = 4 + 4 * (len(pages) + 1)
    offs = []
    for p in pages:
        offs.append(at)
        at += len(p)
    return struct.pack("<I", 0x3ADE68B1) + struct.pack(f"<{len(pages) + 1}I", *offs, 0) \
        + b"".join(pages)


def sgi_rle_file(a: np.ndarray, bpc: int = 1) -> bytes:
    """An RLE SGI of (H, W, Z) samples (< 256, or < 65536 with bpc 2)."""
    h, w, z = a.shape
    rows = []
    for c in range(z):
        for y in range(h):
            row = a[h - 1 - y, :, c]
            out, x = bytearray(), 0
            while x < w:
                run = 1
                while x + run < w and run < 127 and row[x + run] == row[x]:
                    run += 1
                if run > 2:
                    out += run.to_bytes(bpc, "big") + int(row[x]).to_bytes(bpc, "big")
                    x += run
                else:
                    n = min(127, w - x, 5)
                    out += (0x80 | n).to_bytes(bpc, "big") + b"".join(
                        int(v).to_bytes(bpc, "big") for v in row[x:x + n])
                    x += n
            out += (0).to_bytes(bpc, "big")
            rows.append(bytes(out))
    off = 512 + 8 * h * z
    starts, lens = [], []
    for r in rows:
        starts.append(off)
        lens.append(len(r))
        off += len(r)
    head = bytearray(512)
    head[0:2] = (474).to_bytes(2, "big")
    head[2], head[3] = 1, bpc
    head[4:12] = np.array([3 if z > 1 else 2, w, h, z], ">u2").tobytes()
    return bytes(head) + np.array(starts + lens, ">u4").tobytes() + b"".join(rows)


def _dib(image: np.ndarray, bits: int, mask: np.ndarray | None, palette=None) -> bytes:
    """An ICO / CUR BMP entry: a 40-byte header of twice the height, the
    pixels bottom-up (32-bit BGRA, 24-bit BGR or 8-bit indices), then the
    AND mask (1 = transparent) for fewer than 32 bits."""
    a = np.asarray(image)
    h, w = a.shape[:2]
    colors = 256 if bits == 8 else 0
    head = struct.pack("<IiiHHIIiiII", 40, w, 2 * h, 1, bits, 0, 0, 0, 0, colors, 0)
    pal = b""
    if bits == 8:
        pal = np.concatenate([np.asarray(palette, np.uint8)[:, ::-1],
                              np.zeros((256, 1), np.uint8)], 1).tobytes()
        rows = a.astype(np.uint8)
    elif bits == 24:
        rows = a[:, :, 2::-1].reshape(h, w * 3)
    else:
        rows = np.concatenate([a[:, :, 2::-1], a[:, :, 3:4]], 2).reshape(h, w * 4)
    stride = -(-rows.shape[1] // 4) * 4
    body = b"".join(rows[y].tobytes().ljust(stride, b"\0") for y in range(h - 1, -1, -1))
    and_mask = b""
    if bits != 32:
        m = np.zeros((h, w), np.uint8) if mask is None else mask
        mstride = (w + 31) // 32 * 4
        and_mask = b"".join(np.packbits(m[y]).tobytes().ljust(mstride, b"\0")
                            for y in range(h - 1, -1, -1))
    return head + pal + body + and_mask


def ico_file(entries: list, cursor: bool = False) -> bytes:
    """An ICO (or CUR) of entries (width, height, bits, bytes)."""
    out = bytearray(b"\0\0" + (b"\2\0" if cursor else b"\1\0") + struct.pack("<H", len(entries)))
    at = 6 + 16 * len(entries)
    blobs = b""
    for w, h, bits, blob in entries:
        out += struct.pack("<BBBBHHII", w % 256, h % 256, 0, 0, 1, bits, len(blob), at)
        at += len(blob)
        blobs += blob
    return bytes(out) + blobs


def _icns_rle(plane: bytes) -> bytes:
    out, i, n = bytearray(), 0, len(plane)
    while i < n:
        run = 1
        while i + run < n and run < 130 and plane[i + run] == plane[i]:
            run += 1
        if run >= 3:
            out += bytes([run + 125, plane[i]])
            i += run
            continue
        j = i
        while j < n and j - i < 128 and not (j + 2 < n
                                              and plane[j] == plane[j + 1] == plane[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + plane[i:j]
        i = j
    return bytes(out)


def icns_file(rgb: np.ndarray, alpha: np.ndarray | None = None, kind: bytes = b"it32",
              png: bytes | None = None) -> bytes:
    """An ICNS of one RGB entry (`kind` it32 / ih32 / il32 / is32, RLE-packed
    planes) with its 8-bit mask, or of one PNG entry (ic08 and the like, as
    `kind`)."""
    blocks = []
    if png is not None:
        blocks.append((kind, png))
    else:
        planes = b"".join(_icns_rle(rgb[:, :, c].tobytes()) for c in range(3))
        blocks.append((kind, (b"\0\0\0\0" if kind == b"it32" else b"") + planes))
        if alpha is not None:
            mk = {b"it32": b"t8mk", b"ih32": b"h8mk", b"il32": b"l8mk", b"is32": b"s8mk"}[kind]
            blocks.append((mk, alpha.astype(np.uint8).tobytes()))
    body = b"".join(k + struct.pack(">I", 8 + len(d)) + d for k, d in blocks)
    return b"icns" + struct.pack(">I", 8 + len(body)) + body


def psd_file(planes: np.ndarray, mode: int, packbits: bool = False, bits: int = 8,
             palette: np.ndarray | None = None) -> bytes:
    """A PSD's merged image: (C, H, W) channel planes (bitmap: 0/1 bits,
    packed), colour mode 0 bitmap, 1 grey, 2 indexed (with `palette`), 3
    RGB, 4 CMYK (as stored, inverted), raw or PackBits; a layer section
    that is empty."""
    c, h, w = planes.shape
    head = b"8BPS" + struct.pack(">H6xHIIHH", 1, c, h, w, bits, mode)
    cmode = b""
    if palette is not None:
        cmode = np.asarray(palette, np.uint8).T.tobytes()
    rows = []
    for p in planes:
        for y in range(h):
            rows.append(np.packbits(p[y]).tobytes() if bits == 1 else p[y].astype(np.uint8)
                        .tobytes())
    if packbits:
        coded = [_packbits(r) for r in rows]
        data = struct.pack(">H", 1) + b"".join(struct.pack(">H", len(r)) for r in coded) \
            + b"".join(coded)
    else:
        data = struct.pack(">H", 0) + b"".join(rows)
    resources = b"8BIM" + struct.pack(">H", 1005) + b"\0\0" + struct.pack(">I", 4) + b"abcd"
    return (head + struct.pack(">I", len(cmode)) + cmode + struct.pack(">I", len(resources))
            + resources + struct.pack(">I", 0) + data)


def _565(rgb: np.ndarray) -> np.ndarray:
    a = rgb.astype(np.uint16)
    return ((a[..., 0] >> 3) << 11) | ((a[..., 1] >> 2) << 5) | (a[..., 2] >> 3)


def _expand565(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.int32)
    r, g, b = (v >> 11) & 31, (v >> 5) & 63, v & 31
    return np.stack([(r << 3) | (r >> 2), (g << 2) | (g >> 4), (b << 3) | (b >> 2)], -1) \
        .astype(np.uint8)


def bc_blocks(image: np.ndarray, kind: str) -> tuple:
    """BCn blocks of an RGBA image whose pixels decode exactly: each 4×4
    block one colour (its top-left pixel's): "bc1" (a 5-6-5 colour, c0 =
    c1), "bc3" (and its alpha, a0 = a1), "bc6h" (mode 11, the colour as
    10-bit unsigned endpoints; it decodes through the half float of its
    unquantized value) or "bc7" (mode 6, both endpoints the 8-bit colour
    and alpha).  → (blocks, the pixels they decode to)."""
    a = np.asarray(image)
    h, w = a.shape[:2]
    bh, bw = -(-h // 4), -(-w // 4)
    pad = np.zeros((bh * 4, bw * 4, 4), np.uint8)
    pad[:h, :w, :a.shape[2]] = a
    if a.shape[2] < 4:
        pad[:, :, 3] = 255
    top = pad[::4, ::4].reshape(-1, 4)
    if kind in ("bc1", "bc3"):
        c = _565(top[:, :3])
        colour = np.zeros((len(top), 8), np.uint8)
        colour[:, 0], colour[:, 1] = c & 255, c >> 8
        colour[:, 2], colour[:, 3] = c & 255, c >> 8
        value = np.concatenate([_expand565(c), np.full((len(top), 1), 255, np.uint8)], 1)
        blocks = colour
        if kind == "bc3":
            alpha = np.zeros((len(top), 8), np.uint8)
            alpha[:, 0] = alpha[:, 1] = top[:, 3]
            blocks = np.concatenate([alpha, colour], 1)
            value[:, 3] = top[:, 3]
    elif kind == "bc6h":    # BC6H mode 11 (10-bit endpoints, no deltas), every index 0
        bits = np.zeros((len(top), 128), np.uint8)
        bits[:, 0] = bits[:, 1] = 1                        # mode bits 00011
        q = top[:, :3].astype(np.int64) * 1023 // 255       # 10-bit endpoints
        pos = 5
        for _ in range(2):
            for ch in range(3):
                for k in range(10):
                    bits[:, pos + k] = (q[:, ch] >> k) & 1
                pos += 10
        un = np.where(q == 0, 0, np.where(q == 1023, 0xFFFF, ((q << 15) + 0x4000) >> 9))
        half = (un * 31 // 64).astype(np.uint16).view(np.float16).astype(np.float32)
        value = np.full((len(top), 4), 255, np.int64)
        value[:, :3] = np.where(half > 1, 255, (half * np.float32(255)).astype(np.int64))
        blocks = np.packbits(bits, axis=1, bitorder="little")
    else:   # BC7 mode 6: 7-bit endpoints and a p-bit each, every index 0
        bits = np.zeros((len(top), 128), np.uint8)
        bits[:, 6] = 1
        pos = 7
        for ch in range(4):
            for _ in range(2):
                v = top[:, ch] >> 1
                for k in range(7):
                    bits[:, pos + k] = (v >> k) & 1
                pos += 7
        pbit = top[:, 0] & 1
        bits[:, pos] = bits[:, pos + 1] = pbit
        value = (top & 0xFE) | pbit[:, None]
        blocks = np.packbits(bits, axis=1, bitorder="little")
    grid = np.repeat(np.repeat(value.reshape(bh, bw, 4), 4, 0), 4, 1)[:h, :w]
    return np.ascontiguousarray(blocks).tobytes(), grid


def dds_file(w: int, h: int, body: bytes, fourcc: bytes | None = None,
             dxgi: int | None = None) -> bytes:
    """A DDS header (a FourCC, or DX10 with `dxgi`), then `body`."""
    head = bytearray(b"DDS " + struct.pack("<7I", 124, 0x1007, h, w, 0, 0, 0) + bytes(44)
                     + struct.pack("<4I", 32, 0x4, 0, 0) + bytes(16)
                     + struct.pack("<5I", 0x1000, 0, 0, 0, 0))
    head[84:88] = fourcc or b"DX10"
    if dxgi is not None:
        head += struct.pack("<5I", dxgi, 3, 0, 0, 1)
    return bytes(head) + body


def ftex_file(w: int, h: int, body: bytes, fmt: int) -> bytes:
    return b"FTEX" + struct.pack("<5i", 1, w, h, 1, 1) + struct.pack("<2i", fmt, 32) \
        + struct.pack("<i", len(body)) + body


def blp_file(version: int, w: int, h: int, body: bytes, palette: np.ndarray | None = None,
             encoding: int = 1, alpha: bool = False, alpha_encoding: int = 0,
             compression: int = 1, jpeg_header: bytes = b"") -> bytes:
    """BLP1 (compression 0 JPEG with its shared header, or 1 palette,
    encoding 4 or 5) or BLP2 (encoding 1 palette, 2 DXT with
    `alpha_encoding` 0, 1 or 7)."""
    if version == 1:
        head = b"BLP1" + struct.pack("<iI", compression, int(alpha)) + struct.pack("<II", w, h) \
            + struct.pack("<ii", encoding if compression else 5, 0)
    else:
        head = b"BLP2" + struct.pack("<i", compression) + struct.pack(
            "<bbbb", encoding, 8 if alpha else 0, alpha_encoding, 0) + struct.pack("<II", w, h)
    pal = b""
    if palette is not None:
        p = np.asarray(palette, np.uint8)
        if p.shape[1] == 3:
            p = np.concatenate([p, np.full((len(p), 1), 255, np.uint8)], 1)
        pal = np.concatenate([p[:, 2::-1], p[:, 3:]], 1).tobytes().ljust(1024, b"\0")
    if version == 1 and compression == 0:
        pal = struct.pack("<I", len(jpeg_header)) + jpeg_header
    data_at = len(head) + 128 + len(pal)
    offsets = struct.pack("<16I", data_at, *([0] * 15))
    lengths = struct.pack("<16I", len(body), *([0] * 15))
    return head + offsets + lengths + pal + body


def sun_file(image: np.ndarray, depth: int, rle: bool = False,
             palette: np.ndarray | None = None, rgb_order: bool = False) -> bytes:
    """A SUN raster: 1-bit (1 = black), 8-bit grey or palette indices, 24-
    or 32-bit (BGR, or RGB with `rgb_order`, file type 3); rows padded to 16
    bits, or RLE (type 2)."""
    a = np.asarray(image)
    h, w = a.shape[:2]
    if depth == 1:
        rows = np.packbits(1 - a.astype(np.uint8), axis=1)
    elif depth == 8:
        rows = a.astype(np.uint8).reshape(h, w)
    else:
        px = a[:, :, :3] if rgb_order else a[:, :, 2::-1]
        if depth == 32:
            px = np.concatenate([px, np.zeros((h, w, 1), np.uint8)], 2) if not rgb_order else \
                np.concatenate([px, np.zeros((h, w, 1), np.uint8)], 2)
        rows = px.reshape(h, -1)
    if rle:
        raw = rows.tobytes()
        body = bytearray()
        i = 0
        while i < len(raw):
            run = 1
            while i + run < len(raw) and run < 256 and raw[i + run] == raw[i]:
                run += 1
            if run >= 3:
                body += bytes([0x80, run - 1, raw[i]])
            elif raw[i] == 0x80:
                body += b"\x80\x00" * run
            else:
                body += raw[i:i + run]
            i += run
        body = bytes(body)
        ftype = 2
    else:
        stride = ((w * depth + 15) // 16) * 2
        body = b"".join(rows[y].tobytes().ljust(stride, b"\0") for y in range(h))
        ftype = 3 if rgb_order else 1
    pal = b""
    if palette is not None:
        pal = np.asarray(palette, np.uint8).T.tobytes()
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(body), ftype, 1 if pal else 0,
                       len(pal)) + pal + body


def msp_file(bits: np.ndarray, rle: bool) -> bytes:
    """An MSP of 0/1 samples (1 white): version 1 raw, or version 2 RLE."""
    h, w = bits.shape
    header = [0] * 16
    magic = b"LinS" if rle else b"DanM"
    header[0], header[1] = struct.unpack("<HH", magic)
    header[2], header[3] = w, h
    header[4] = header[5] = header[6] = header[7] = 1
    header[8], header[9] = w, h
    check = 0
    for v in header:
        check ^= v
    header[12] = check
    head = struct.pack("<16H", *header)
    rows = [np.packbits(bits[y].astype(np.uint8)).tobytes() for y in range(h)]
    if not rle:
        return head + b"".join(rows)
    coded = []
    for r in rows:
        out, i = bytearray(), 0
        while i < len(r):
            run = 1
            while i + run < len(r) and run < 255 and r[i + run] == r[i]:
                run += 1
            if run >= 3:
                out += bytes([0, run, r[i]])
                i += run
            else:
                n = min(run, 255)
                out += bytes([n]) + r[i:i + n]
                i += n
        coded.append(bytes(out))
    return head + struct.pack(f"<{h}H", *[len(c) for c in coded]) + b"".join(coded)


def xbm_file(bits: np.ndarray, hotspot=None) -> bytes:
    """An XBM of 0/1 samples (1 reads white in Pillow)."""
    h, w = bits.shape
    rows = np.packbits(bits.astype(np.uint8), axis=1, bitorder="little")
    values = ", ".join(f"0x{v:02x}" for v in rows.reshape(-1))
    head = f"#define im_width {w}\n#define im_height {h}\n"
    if hotspot:
        head += f"#define im_x_hot {hotspot[0]}\n#define im_y_hot {hotspot[1]}\n"
    return (head + f"static char im_bits[] = {{\n{values}\n}};\n").encode()


def xpm_file(index: np.ndarray, palette: np.ndarray) -> bytes:
    """An XPM of palette indices, two characters a pixel."""
    h, w = index.shape
    chars = [chr(65 + i // 26) + chr(97 + i % 26) for i in range(len(palette))]
    lines = ["/* XPM */", "static char *x[] = {", f'"{w} {h} {len(palette)} 2",']
    lines += [f'"{chars[i]} c #{r:02x}{g:02x}{b:02x}",' for i, (r, g, b) in enumerate(palette)]
    lines.append("/* pixels */")
    lines += ['"' + "".join(chars[v] for v in row) + '",' for row in index]
    lines.append("};")
    return ("\n".join(lines) + "\n").encode()


def pixar_file(rgb: np.ndarray) -> bytes:
    h, w = rgb.shape[:2]
    head = bytearray(1024)
    head[0:4] = b"\x80\xe8\x00\x00"
    struct.pack_into("<HH", head, 416, h, w)
    struct.pack_into("<HH", head, 424, 14, 2)
    return bytes(head) + rgb.astype(np.uint8).tobytes()


def gbr_file(image: np.ndarray, version: int = 2, comment: bytes = b"brush") -> bytes:
    a = np.asarray(image)
    h, w = a.shape[:2]
    depth = 1 if a.ndim == 2 or a.shape[2] == 1 else 4
    name = comment + b"\0"
    size = (28 if version == 2 else 20) + len(name)
    head = struct.pack(">5I", size, version, w, h, depth)
    if version == 2:
        head += b"GIMP" + struct.pack(">I", 25)
    return head + name + a.astype(np.uint8).tobytes()


def xvthumb_file(index: np.ndarray) -> bytes:
    h, w = index.shape
    return b"P7 332\n#comment\n" + b"%d %d 255\n" % (w, h) + index.astype(np.uint8).tobytes()


def fits_file(samples: np.ndarray, bitpix: int) -> bytes:
    """A FITS primary array: 8-bit samples, or the 16 / 32-bit integer and
    32-bit float samples Pillow reads little-endian, rows bottom-up."""
    h, w = samples.shape
    cards = [f"SIMPLE  = {'T':>20}", f"BITPIX  = {bitpix:>20}", f"NAXIS   = {2:>20}",
             f"NAXIS1  = {w:>20}", f"NAXIS2  = {h:>20}", "END"]
    head = "".join(c.ljust(80) for c in cards).encode()
    head = head.ljust(-(-len(head) // 2880) * 2880, b" ")
    dtype = {8: "u1", 16: "<u2", 32: "<i4", -32: "<f4"}[bitpix]
    return head + samples[::-1].astype(dtype).tobytes()


def mcidas_file(samples: np.ndarray, size: int = 1) -> bytes:
    h, w = samples.shape
    words = [0] * 64
    words[1] = 4
    words[8], words[9], words[10], words[13] = h, w, size, 1     # w[9], w[10], w[11], w[14]
    words[14] = 0                                                 # w[15]: row prefix
    words[33] = 256                                               # w[34]: data offset
    return struct.pack("!64i", *words) + samples.astype({1: ">u1", 2: ">u2", 4: ">i4"}[size]) \
        .tobytes()


def iptc_file(grey: np.ndarray, layers: int = 1, band: int | None = None,
              jpeg: bytes | None = None) -> bytes:
    """An IPTC/NAA record of one grey layer (raw, or `jpeg` bytes), or one
    band (1-based) of a `layers`-band (3 or 4) image."""
    h, w = grey.shape

    def field(rec: int, tag: int, data: bytes) -> bytes:
        if len(data) < 0x8000:
            return bytes([0x1C, rec, tag]) + struct.pack(">H", len(data)) + data
        return bytes([0x1C, rec, tag, 0x80 | 4, 0]) + struct.pack(">I", len(data)) + data

    out = field(3, 20, struct.pack(">H", w)) + field(3, 30, struct.pack(">H", h)) \
        + field(3, 60, bytes([layers, int(layers > 1)])) \
        + field(3, 120, bytes([5 if jpeg else 1]))
    if band is not None:
        out += field(3, 65, bytes([band]))
    raw = jpeg or grey.astype(np.uint8).tobytes()
    for i in range(0, len(raw), 30000):
        out += field(8, 10, raw[i:i + 30000])
    return out


def imt_file(grey: np.ndarray) -> bytes:
    h, w = grey.shape
    return b"width %d\nheight %d\npixel n8\n\x0c" % (w, h) + grey.astype(np.uint8).tobytes()


def fli_file(index: np.ndarray, palette: np.ndarray, chunks=("COLOR256", "BRUN")) -> bytes:
    """An FLC of one frame: the palette (COLOR256, or COLOR at 6 bits) and
    the pixels as BRUN, COPY, or BLACK then LC or SS2 deltas."""
    h, w = index.shape
    subs = []
    for kind in chunks:
        if kind == "COLOR256":
            body = struct.pack("<HBB", 1, 0, 0) + np.asarray(palette, np.uint8).tobytes()
            subs.append((4, body))
        elif kind == "COLOR":
            body = struct.pack("<HBB", 1, 0, 0) + (np.asarray(palette, np.uint8) >> 2).tobytes()
            subs.append((11, body))
        elif kind == "BRUN":
            body = bytearray()
            for row in index:
                body.append(0)
                x = 0
                while x < w:
                    run = 1
                    while x + run < w and run < 127 and row[x + run] == row[x]:
                        run += 1
                    if run > 2:
                        body += bytes([run, row[x]])
                        x += run
                    else:
                        n = min(w - x, 64)
                        body += bytes([256 - n]) + row[x:x + n].astype(np.uint8).tobytes()
                        x += n
            subs.append((15, bytes(body)))
        elif kind == "COPY":
            subs.append((16, index.astype(np.uint8).tobytes()))
        elif kind == "BLACK":
            subs.append((13, b""))
        elif kind == "LC":
            body = bytearray(struct.pack("<HH", 0, h))
            for row in index:
                body.append(2)
                half = w // 2
                body += bytes([0, half]) + row[:half].astype(np.uint8).tobytes()
                body += bytes([0, 256 - (w - half)]) + bytes([int(row[half])])
            subs.append((12, bytes(body)))
        elif kind == "SS2":
            body = bytearray(struct.pack("<H", h))
            for row in index:
                body += struct.pack("<H", 1) + bytes([0, w // 2]) + row[:w // 2 * 2] \
                    .astype(np.uint8).tobytes()
            subs.append((7, bytes(body)))
    frame_body = b"".join(struct.pack("<IH", 6 + len(b) + len(b) % 2, k) + b + b"\0" * (len(b) % 2)
                          for k, b in subs)
    frame = struct.pack("<IHH8x", 16 + len(frame_body), 0xF1FA, len(subs)) + frame_body
    head = bytearray(128)
    struct.pack_into("<IHHHHHHI", head, 0, 128 + len(frame), 0xAF12, 1, w, h, 8, 0, 70)
    return bytes(head) + frame


def pcd_file(y: np.ndarray, c1: np.ndarray, c2: np.ndarray, orientation: int = 0) -> bytes:
    """A PhotoCD base image: (512, 768) luma, (256, 384) chroma planes."""
    head = bytearray(96 * 2048)
    head[2048:2052] = b"PCD_"
    head[2048 + 1538] = orientation
    body = bytearray()
    for r in range(256):
        body += y[2 * r].tobytes() + y[2 * r + 1].tobytes() + c1[r].tobytes() + c2[r].tobytes()
    return bytes(head) + bytes(body)


def _cmyk_rgb(cmyk: np.ndarray) -> np.ndarray:
    c = cmyk.astype(np.int32)
    nk = 255 - c[..., 3:4]
    t = c[..., :3] * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def rare_files(sample: np.ndarray, seed: int = 0) -> dict:
    """Every format and variant of the rarer readers, written by the numpy
    writers above from an (H, W, 3) uint8 sample (H and W multiples of 4;
    the ICNS entry needs 128 × 128) →
    {name: (bytes, the uint8 (H', W', C) pixels the file decodes to)}.
    The YCbCr-coded files (JPEG and uncompressed YCbCr in TIFF, PhotoCD)
    decode through a conversion the tests hold to libtiff and Pillow; the
    others to exact pixels."""
    from sdwebui_tpu_torch.utils.jpeg import decode_jpeg, encode_jpeg

    a = np.ascontiguousarray(sample[:, :, :3])
    h, w = a.shape[:2]
    rng = np.random.default_rng(seed)
    grey = a[:, :, 1].copy()
    g1 = grey[:, :, None]
    white = (grey > 127).astype(np.uint8)
    alpha = ((np.arange(w)[None, :] * 255) // max(1, w - 1) + np.zeros((h, 1), int)) \
        .astype(np.uint8)
    rgba = np.concatenate([a, alpha[:, :, None]], 2)
    pal = rng.integers(0, 256, (256, 3), dtype=np.uint8)
    idx = grey.copy()
    sq = a[:min(h, 256), :min(w, 256)]
    out = {}
    # Netpbm
    out["ppm_p6"] = (b"P6\n%d %d\n255\n" % (w, h) + a.tobytes(), a)
    out["pgm_p5_16bit"] = (b"P5 %d %d 65535\n" % (w, h) + grey.astype(">u2").tobytes(), g1)
    out["pbm_p4"] = (b"P4\n%d %d\n" % (w, h) + np.packbits(1 - white, axis=1).tobytes(),
                     white[:, :, None] * np.uint8(255))
    out["ppm_p3_plain"] = (b"P3\n# plain\n%d %d\n255\n" % (w, h)
                           + " ".join(map(str, a.ravel().tolist())).encode(), a)
    v200 = grey.astype(np.int64) * 200 // 255
    out["pgm_p2_maxval"] = (b"P2 %d %d 200 " % (w, h)
                            + " ".join(map(str, v200.ravel().tolist())).encode(),
                            np.round(v200 / 200 * 255).astype(np.uint8)[:, :, None])
    out["pfm"] = (b"Pf\n%d %d\n-1.0\n" % (w, h) + (grey[::-1].astype("<f4") + 0.75).tobytes(),
                  g1)
    # TGA
    out["tga"] = (tga_file(a), a)
    out["tga_rle_top_right"] = (tga_file(a, rle=True, top=True, right=True), a)
    out["tga_rgba_rle"] = (tga_file(rgba, rle=True), rgba)
    out["tga_grey"] = (tga_file(grey), g1)
    exp16 = np.concatenate([_bgra15_expected(rgba), np.where(rgba[:, :, 3:] < 128, 0, 255)
                            .astype(np.uint8)], 2)
    out["tga_16bit"] = (tga_file(rgba, bits16=True), exp16)
    out["tga_map24"] = (tga_file(idx, palette=pal), pal[idx])
    # SGI
    out["sgi_rle"] = (sgi_rle_file(a), a)
    out["sgi_rle_16bit"] = (sgi_rle_file(a.astype(np.int64) * 256 + 7, 2), a)
    # PCX, DCX
    out["pcx_palette"] = (pcx_file(idx, pal), pal[idx])
    out["pcx_1bit"] = (pcx_file(white, None, bits=1), white[:, :, None] * np.uint8(255))
    out["pcx_4planes"] = (pcx_file(idx % 16, pal[:16], bits=1, planes=4), pal[idx % 16])
    out["dcx"] = (dcx_file([pcx_file(idx, None)]), g1)
    # ICO, CUR, ICNS
    sh, sw = sq.shape[:2]
    sq_rgba = rgba[:sh, :sw]
    mask = white[:sh, :sw]
    ico8 = np.concatenate([pal[idx[:sh, :sw]], ((1 - mask) * 255)[:, :, None].astype(np.uint8)],
                          2)
    out["ico_bmp32"] = (ico_file([(sw, sh, 32, _dib(sq_rgba, 32, None))]), sq_rgba)
    out["ico_bmp8_mask"] = (ico_file([(sw, sh, 8, _dib(idx[:sh, :sw], 8, mask, pal))]), ico8)
    cur = a[:min(h, 200), :min(w, 200)]      # CUR compares its directory's size bytes
    out["cur"] = (ico_file([(16, 16, 24, _dib(a[:16, :16], 24, None)),
                            (cur.shape[1], cur.shape[0], 24, _dib(cur, 24, None))],
                           cursor=True), cur)
    if min(h, w) >= 128:
        s128 = np.ascontiguousarray(a[:128, :128])
        out["icns_it32_mask"] = (icns_file(s128, alpha[:128, :128], b"it32"),
                                 np.concatenate([s128, alpha[:128, :128, None]], 2))
    # PSD
    for pb in (False, True):
        tag = "packbits" if pb else "raw"
        out[f"psd_rgb_{tag}"] = (psd_file(a.transpose(2, 0, 1), 3, pb), a)
        out[f"psd_rgba_{tag}"] = (psd_file(rgba.transpose(2, 0, 1), 3, pb), rgba)
    stored = np.concatenate([a, grey[:, :, None] // 3], 2)
    out["psd_cmyk_packbits"] = (psd_file(stored.transpose(2, 0, 1), 4, True),
                                _cmyk_rgb(255 - stored))
    out["psd_grey_packbits"] = (psd_file(grey[None], 1, True), g1)
    out["psd_indexed"] = (psd_file(idx[None], 2, True, palette=pal), pal[idx])
    out["psd_bitmap"] = (psd_file(white[None], 0, True, bits=1),
                         white[:, :, None] * np.uint8(255))
    # DDS, FTEX, BLP
    for kind, fourcc, dxgi in (("bc1", b"DXT1", None), ("bc3", b"DXT5", None),
                               ("bc7", None, 98)):
        blocks, expect = bc_blocks(rgba, kind)
        out[f"dds_{kind}"] = (dds_file(w, h, blocks, fourcc, dxgi), expect)
    blocks, expect = bc_blocks(a, "bc6h")
    out["dds_bc6h"] = (dds_file(w, h, blocks, dxgi=95), expect[:, :, :3])
    out["dds_rgba8_dx10"] = (dds_file(w, h, rgba.tobytes(), dxgi=28), rgba)
    blocks, expect = bc_blocks(a, "bc1")
    out["ftex_dxt1"] = (ftex_file(w, h, blocks, 0), expect)
    out["blp1_palette"] = (blp_file(1, w, h, idx.tobytes(), pal, encoding=5), pal[idx])
    out["blp2_palette"] = (blp_file(2, w, h, idx.tobytes(), pal, encoding=1), pal[idx])
    # IMT, the small rasters
    out["imt"] = (imt_file(grey), g1)
    out["sun_24"] = (sun_file(a, 24), a)
    out["sun_8_rle"] = (sun_file(idx, 8, True), g1)
    out["sun_1"] = (sun_file(white, 1), white[:, :, None] * np.uint8(255))
    out["msp_rle"] = (msp_file(white, True), white[:, :, None] * np.uint8(255))
    out["xbm"] = (xbm_file(white), white[:, :, None] * np.uint8(255))
    out["xpm"] = (xpm_file(idx % 64, pal[:64]), pal[idx % 64])
    out["pixar"] = (pixar_file(a), a)
    out["spider"] = (_spider(grey.astype(np.float32) + 0.25), g1)
    out["gbr"] = (gbr_file(grey, 2), g1)
    xv = np.array([((r * 255) // 7, (g * 255) // 7, (b * 255) // 3)
                   for r in range(8) for g in range(8) for b in range(4)], np.uint8)
    out["xvthumb"] = (xvthumb_file(idx), xv[idx])
    out["fits_8"] = (fits_file(grey, 8), g1)
    out["mcidas"] = (mcidas_file(grey, 1), g1)
    out["iptc"] = (iptc_file(grey), g1)
    out["fli_brun"] = (fli_file(idx, pal, ("COLOR256", "BRUN")), pal[idx])
    # TIFF
    jpeg = encode_jpeg(a, 85)
    out["tiff_jpeg_ycbcr"] = (tiff_file(a, "jpeg", photometric=6, encoder=lambda b: jpeg,
                                        tags={530: (3, [2, 2])}), decode_jpeg(jpeg)[0])
    out["tiff_lzma"] = (tiff_file(a, "lzma", True, rows_per_strip=64), a)
    out["tiff_zstd"] = (tiff_file(a, "zstd", rows_per_strip=64, seed=seed), a)
    for kind in ("ccitt", "g3", "g4"):
        out[f"tiff_{kind}"] = (tiff_file(1 - white, kind, depth=1, photometric=0,
                                         rows_per_strip=64), white[:, :, None] * np.uint8(255))
    out["tiff_g3_2d_fill2"] = (tiff_file(white, "g3", depth=1, photometric=1, fill_order=2,
                                         tags={292: (4, [1])}),
                               white[:, :, None] * np.uint8(255))
    out["tiff_cmyk"] = (tiff_file(stored, "deflate", photometric=5), _cmyk_rgb(stored))
    out["tiff_float"] = (tiff_file(grey.astype(np.float32) + 0.5, "zip"), g1)
    return out


def _spider(grey: np.ndarray) -> bytes:
    """A SPIDER 2-D image of float32 samples (big-endian)."""
    h, w = grey.shape
    lenbyt = w * 4
    labrec = -(-1024 // lenbyt)
    labbyt = labrec * lenbyt
    head = np.zeros(labbyt // 4, ">f4")
    for k, v in ((1, h), (2, h), (5, 1), (12, w), (13, labrec), (22, labbyt), (23, lenbyt)):
        head[k - 1] = v
    return head.tobytes() + grey.astype(">f4").tobytes()


def scanned_page(seed: int = 0, width: int = 1728, height: int = 2200) -> np.ndarray:
    """A fax-width page of text-like strokes: 0/1 samples, 1 black (lines of
    word-sized blocks of short runs, as a scanned page of print)."""
    rng = np.random.default_rng(seed)
    page = np.zeros((height, width), np.uint8)
    for top in range(120, height - 160, 48):
        x = 100
        while x < width - 200:
            word = int(rng.integers(40, 180))
            glyphs = rng.random((28, word)) < 0.35
            glyphs[:, ::6] = False
            page[top:top + 28, x:x + word] = glyphs
            x += word + int(rng.integers(16, 40))
    return page


# --------------------------------------------------------------------------
# files the libraries wrote: libzstd's compressed blocks and libtiff's
# Group 4, committed under tests/fixtures/libtiff (tools/write_libtiff_fixtures.py)
# --------------------------------------------------------------------------

LIBRARY_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "libtiff")


def _mix(*coords) -> np.ndarray:
    """A uint64 hash of integer coordinates (wrapping arithmetic, the same
    on every machine and numpy version, unlike a seeded generator's stream)."""
    h = np.uint64(0x9E3779B97F4A7C15)
    with np.errstate(over="ignore"):
        for v in coords:
            h = (h ^ np.asarray(v, np.uint64)) * np.uint64(0xBF58476D1CE4E5B9)
            h ^= h >> np.uint64(31)
    return h


def library_sample(h: int = 512, w: int = 512) -> np.ndarray:
    """(h, w, 3) uint8 for the Zstandard file: bands of a stepped gradient
    with sparse noise (Huffman literals) and of a repeated 24 × 40 tile
    (matches at repeating offsets)."""
    y, x = np.mgrid[0:h, 0:w].astype(np.int64)
    noise = (_mix(y, x) >> np.uint64(40)).astype(np.int64)
    tile = (_mix(y % 24, x % 40, 3) >> np.uint64(40)).astype(np.int64)
    base = np.stack([x // 4 * 2, y // 4 * 2, (x + y) // 8 * 2], 2)
    sparse = ((noise >> 20) & 7 == 0)[..., None]
    n = np.stack([(noise >> (5 * k)) & 7 for k in range(3)], 2) * sparse
    t = np.stack([(tile >> (8 * k)) & 63 for k in range(3)], 2)
    band = ((y // 64) % 2 == 0)[..., None]
    return np.clip(np.where(band, base + n, t + 100), 0, 255).astype(np.uint8)


def library_page(width: int = 1728, height: int = 2200) -> np.ndarray:
    """A fax-width page of hashed word blocks of 4 × 3 strokes: 0/1
    samples, 1 black."""
    y, x = np.mgrid[0:height, 0:width].astype(np.int64)
    line, word = (y - 120) // 48, (x - 100) // 96
    in_line = ((y - 120) % 48 < 28) & (y >= 120) & (y < height - 160)
    in_word = ((x - 100) % 96 < 64 + (_mix(line, word) & np.uint64(31)).astype(np.int64)) \
        & (x >= 100) & (x < width - 200)
    stroke = ((_mix(y // 4, x // 3, 7) & np.uint64(255)) < 90) & (x % 6 != 0)
    return (in_line & in_word & stroke).astype(np.uint8)


#: file under LIBRARY_DIR → (name, what Pillow wrote it from: (pixels, save options))
LIBRARY_FILES = {
    "zstd_512.tif": ("libzstd_tiff_512", lambda: (library_sample(), {"compression": "zstd"})),
    "g4_page.tif": ("libtiff_g4_page",
                    lambda: (((1 - library_page()) * 255).astype(np.uint8)[:, :, None],
                             {"compression": "group4", "mode": "1"})),
}


def library_files() -> dict:
    """The committed files → {name: (bytes, the uint8 (H, W, C) pixels they
    decode to)}: libzstd's compressed blocks (Huffman literals, FSE
    sequences) and libtiff's Group 4, as Pillow 12.1 wrote them."""
    out = {}
    for fname, (name, source) in LIBRARY_FILES.items():
        with open(os.path.join(LIBRARY_DIR, fname), "rb") as fh:
            out[name] = (fh.read(), source()[0])
    return out
