"""Image files in the variants the port reads but never writes, for decoder
tests and the card's smoke run: PNG at every bit depth and interlaced, BMP
with RLE, bitfields, top-down rows and the other headers, TIFF compressed
with PackBits, LZW (with the horizontal predictor) and Deflate, in strips,
tiles or planes, and a palette BMP as Pillow writes it.  numpy and the
standard library only, so that it also runs where Pillow is absent."""

from __future__ import annotations

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


_TYPES = {1: "B", 3: "H", 4: "I"}


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
              extra: int | None = None) -> bytes:
    """A TIFF of (H, W[, C]) samples (uint16 for depth 16; 1/2/4-bit samples
    as uint8): `compression` "none", "packbits", "lzw", "deflate" (8) or
    "zip" (32946), the horizontal predictor, strips of `rows_per_strip`
    rows or square tiles of `tile`, chunky or planar, either byte order;
    `photometric` 0 (white is zero), 1, 2 or 3 (with `palette`, (2**depth,
    3) uint16); `extra` the ExtraSamples value of a fourth (or second)
    sample."""
    a = np.asarray(image)
    if a.ndim == 2:
        a = a[:, :, None]
    h, w, c = a.shape
    order = ">" if big_endian else "<"
    if photometric is None:
        photometric = 2 if c >= 3 else 1
    code = {"none": 1, "packbits": 32773, "lzw": 5, "deflate": 8, "zip": 32946}[compression]

    def encode(block: np.ndarray) -> bytes:
        """(rows, cols, samples) → one strip or tile, compressed."""
        rows, cols, s = block.shape
        b = block.astype(np.int64)
        if predictor:
            mod = 1 << depth
            diff = b.copy()
            diff[:, 1:] = (b[:, 1:] - b[:, :-1]) % mod
            b = diff
        if depth == 16:
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
        if len(raw) <= 4:
            entries += struct.pack(order + "HHI", tag, typ, len(vals)) + raw.ljust(4, b"\0")
        else:
            entries += struct.pack(order + "HHII", tag, typ, len(vals), extra_at + len(blobs))
            blobs += raw
    head = (b"MM\x00*" if big_endian else b"II*\x00") + struct.pack(order + "I", 8)
    return (head + struct.pack(order + "H", n) + bytes(entries) + struct.pack(order + "I", 0)
            + bytes(blobs) + b"".join(chunks))
