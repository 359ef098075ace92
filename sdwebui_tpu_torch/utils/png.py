"""A small PNG writer and reader on numpy and the standard library.

Writes 8-bit grey, grey + alpha, RGB and RGBA images with text chunks —
the ``parameters`` chunk carries the infotext, as the JAX server writes it
through PIL (``sdwebui_tpu/server/app.py:499``); ``utils/saving`` writes
saved files with it, and ``utils/jpeg`` reads and writes JPEG.  The reader takes every PNG
Pillow opens: colour types 0 (grey, 1/2/4/8/16-bit), 2 (RGB), 3 (palette,
1/2/4/8-bit, expanded to RGB as PIL's ``convert("RGB")`` does), 4 (grey +
alpha) and 6 (RGBA), 8- or 16-bit, plain or Adam7-interlaced, rows under
any of the five filters.  An image over Pillow's pixel limit
(``check_image_size``, which the other readers share) raises
``ValueError`` before anything is allocated or inflated.
"""

from __future__ import annotations

import re
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {1: 0, 2: 4, 3: 2, 4: 6}  # channels → PNG colour type
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # PNG colour type → samples per pixel
#: Pillow's ``Image.MAX_IMAGE_PIXELS``; ``Image.open`` refuses twice that
MAX_IMAGE_PIXELS = 1024 * 1024 * 1024 // 4 // 3


def check_image_size(width: int, height: int) -> None:
    """Pillow's decompression-bomb check in ``Image.open``: a frame of more
    than 2 · MAX_IMAGE_PIXELS pixels raises (``ValueError`` here)."""
    pixels = max(1, width) * max(1, height)
    if pixels > 2 * MAX_IMAGE_PIXELS:
        raise ValueError(f"Image size ({pixels} pixels) exceeds limit of "
                         f"{2 * MAX_IMAGE_PIXELS} pixels, could be decompression bomb DOS attack.")


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def _text_chunk(key: str, value: str) -> bytes:
    try:
        return _chunk(b"tEXt", key.encode("latin-1") + b"\0" + value.encode("latin-1"))
    except UnicodeEncodeError:   # as PIL: non-latin-1 text goes to iTXt
        return _chunk(b"iTXt", key.encode("latin-1") + b"\0\0\0\0\0"
                      + value.encode("utf-8"))


def encode_png(image: np.ndarray, text: dict | None = None, level: int = 6) -> bytes:
    """uint8 (H, W, 3|4), or grey (H, W[, 1|2]) → PNG bytes with optional
    text chunks."""
    image = np.ascontiguousarray(image)
    if image.ndim == 2:
        image = image[:, :, None]
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] not in _COLOR_TYPES:
        raise ValueError(f"expected uint8 (H, W[, 1-4]), got {image.dtype} {image.shape}")
    h, w, c = image.shape
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    rows = np.empty((h, 1 + w * c), np.uint8)
    rows[:, 0] = 0                                   # filter type None
    rows[:, 1:] = image.reshape(h, w * c)
    parts = [_SIGNATURE, _chunk(b"IHDR", ihdr)]
    parts += [_text_chunk(k, v) for k, v in (text or {}).items()]
    parts += [_chunk(b"IDAT", zlib.compress(rows.tobytes(), level)), _chunk(b"IEND", b"")]
    return b"".join(parts)


def _unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the per-row filters of (H, 1 + W·bpp) scanlines → (H, W·bpp).

    A pixel depends on its left neighbour a, the pixel above b and the one
    above-left c, so every anti-diagonal of pixels depends only on the two
    before it.  The rows are skewed so that diagonal d is row d of a
    (H + W − 1, H + 1, bpp) array (column 0 is a zero border), and the
    diagonals are decoded in order, each in one vectorised step over its
    rows and channels, whatever mix of filters the rows use."""
    h = raw.shape[0]
    ftype = raw[:, 0]
    if (ftype > 4).any():
        raise ValueError(f"bad PNG filter type {int(ftype.max())}")
    data = raw[:, 1:].reshape(h, -1, bpp).astype(np.int16)
    w = data.shape[1]
    if not ftype.any():
        return raw[:, 1:]
    if (ftype <= 2).all() and not (ftype == 1).any():      # None and Up only
        out = data.copy()
        for r in np.nonzero(ftype == 2)[0]:
            if r > 0:
                out[r] = (out[r] + out[r - 1]) & 255
        return out.astype(np.uint8).reshape(h, w * bpp)
    rows = np.arange(h)
    skew = np.zeros((h + w - 1, h + 1, bpp), np.int16)   # skew[r + i, r + 1] = pixel (r, i)
    raw_skew = np.zeros_like(skew)
    cols = np.arange(w)
    raw_skew[rows[:, None] + cols[None, :], rows[:, None] + 1] = data
    f = np.zeros(h + 1, np.int16)
    f[1:] = ftype
    for d in range(h + w - 1):
        lo, hi = max(0, d - w + 1) + 1, min(d, h - 1) + 2   # columns r + 1 of this diagonal
        a = skew[d - 1, lo:hi] if d >= 1 else np.zeros((hi - lo, bpp), np.int16)
        b = skew[d - 1, lo - 1:hi - 1] if d >= 1 else a
        c = skew[d - 2, lo - 1:hi - 1] if d >= 2 else np.zeros_like(a)
        ft = f[lo:hi, None]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([ft == 1, ft == 2, ft == 3, ft == 4], [a, b, (a + b) >> 1, paeth], 0)
        skew[d, lo:hi] = (raw_skew[d, lo:hi] + pred) & 255
    out = skew[rows[:, None] + cols[None, :], rows[:, None] + 1]
    return out.astype(np.uint8).reshape(h, w * bpp)


#: Adam7's passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


def unpack_bits(packed: np.ndarray, depth: int, width: int) -> np.ndarray:
    """(H, row bytes) uint8 of `depth`-bit samples, MSB first → (H, width)."""
    if depth == 8:
        return packed[:, :width]
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    out = (packed[:, :, None] >> shifts) & ((1 << depth) - 1)
    return out.reshape(packed.shape[0], -1)[:, :width]


def _samples(rows: np.ndarray, w: int, h: int, depth: int, chans: int) -> np.ndarray:
    """Unfiltered rows of one (sub-)image → (h, w, chans) samples (uint8, or
    uint16 at depth 16)."""
    bpp = max(1, depth * chans // 8)
    pixels = _unfilter(rows, bpp)
    if depth == 16:
        pairs = pixels.reshape(h, w, chans, 2).astype(np.uint16)
        return (pairs[..., 0] << 8) | pairs[..., 1]
    return unpack_bits(pixels, depth, w * chans).reshape(h, w, chans)


def _passes(w: int, h: int, interlace: int):
    if not interlace:
        return [(0, 0, 1, 1, w, h)]
    out = []
    for x0, y0, dx, dy in _ADAM7:
        pw, ph = (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy
        if pw > 0 and ph > 0:
            out.append((x0, y0, dx, dy, pw, ph))
    return out


def decode_png(data: bytes) -> tuple[np.ndarray, dict]:
    """PNG bytes → (uint8 (H, W, C), info): the image as Pillow's
    ``convert`` sees the mode ``Image.open`` gives it, and the text chunks
    (plus ``transparency`` from ``tRNS``, as Pillow puts it in ``info``).

    C = 1 for grey: "1" as 0/255, 2- and 4-bit grey scaled by 85 and 17,
    16-bit grey ("I;16") clipped at 255 as Pillow's ``convert("RGB")`` and
    ``convert("L")`` clip it; 2 for grey + alpha; 3 for RGB and for palette
    images, expanded through the palette (transparency dropped, as
    ``convert("RGB")`` drops it); 4 for RGBA.  16-bit samples of the other
    colour types keep their high byte (16-bit grey + alpha opens as RGBA,
    C = 4, as in Pillow).  ``info`` also takes ``interlace``, ``gamma``,
    ``dpi`` / ``aspect``, ``srgb``, ``icc_profile`` and ``exif`` as Pillow
    reads them.  Adam7 interlacing is read."""
    if not data.startswith(_SIGNATURE):
        raise ValueError("not a PNG file")
    pos = len(_SIGNATURE)
    idat, text, info, hdr, palette, trns = [], {}, {}, None, None, None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"bad CRC in {kind!r} chunk")
        pos += 12 + length
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
            check_image_size(hdr[0], hdr[1])
        elif kind == b"PLTE":
            palette = np.frombuffer(body[:len(body) // 3 * 3], np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"tEXt":
            key, _, value = body.partition(b"\0")
            text[key.decode("latin-1")] = value.decode("latin-1")
        elif kind == b"iTXt":
            key, _, rest = body.partition(b"\0")
            rest = rest[2:]                               # compression flag/method
            _lang, _, rest = rest.partition(b"\0")
            _tkey, _, value = rest.partition(b"\0")
            text[key.decode("latin-1")] = value.decode("utf-8")
        elif kind == b"zTXt":
            key, _, value = body.partition(b"\0")
            text[key.decode("latin-1")] = zlib.decompress(value[1:]).decode("latin-1")
        elif kind == b"gAMA":
            info["gamma"] = struct.unpack(">I", body)[0] / 100000.0
        elif kind == b"pHYs":
            px, py, unit = struct.unpack(">IIB", body)
            info["dpi" if unit == 1 else "aspect"] = (px * 0.0254, py * 0.0254) if unit == 1 \
                else (px, py)
        elif kind == b"sRGB":
            info["srgb"] = body[0]
        elif kind == b"iCCP":
            info["icc_profile"] = zlib.decompress(body.partition(b"\0")[2][1:])
        elif kind == b"eXIf":
            info["exif"] = body
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype] or interlace > 1:
        raise ValueError(f"invalid PNG: depth {depth}, colour type {ctype}, "
                         f"interlace {interlace}")
    chans = _CHANNELS[ctype]
    passes = _passes(w, h, interlace)
    sizes = [ph * (1 + (pw * chans * depth + 7) // 8) for *_, pw, ph in passes]
    try:   # inflate no more than the image holds
        raw = np.frombuffer(zlib.decompressobj().decompress(b"".join(idat), sum(sizes)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"corrupt PNG image data: {e}") from e
    if raw.size < sum(sizes):
        raise ValueError("truncated PNG image data")
    image = np.zeros((h, w, chans), np.uint16 if depth == 16 else np.uint8)
    off = 0
    for (x0, y0, dx, dy, pw, ph), size in zip(passes, sizes):
        rows = raw[off:off + size].reshape(ph, -1)
        image[y0::dy, x0::dx] = _samples(rows, pw, ph, depth, chans)
        off += size
    text = {**info, **({"interlace": 1} if interlace else {}), **text}
    if trns is not None:
        if ctype == 3:
            if re.fullmatch(rb"\xff*\x00\xff*", trns):
                text["transparency"] = trns.index(b"\0")
            else:
                text["transparency"] = bytes(trns)
        elif ctype == 0:   # Pillow's "1" gives its 0/255 value
            text["transparency"] = struct.unpack(">H", trns[:2])[0] * (255 if depth == 1 else 1)
        elif ctype == 2:
            text["transparency"] = struct.unpack(">HHH", trns[:6])
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        full = np.zeros((256, 3), np.uint8)
        full[:len(palette)] = palette[:256]
        return np.ascontiguousarray(full[image[:, :, 0]]), text
    if depth == 16:
        image = (np.minimum(image, 255) if ctype == 0 else image >> 8).astype(np.uint8)
        if ctype == 4:   # Pillow opens 16-bit grey + alpha as RGBA
            image = image[:, :, [0, 0, 0, 1]]
        return np.ascontiguousarray(image), text
    if depth < 8:   # "1" reads as 0/255, 2- and 4-bit grey scaled to 0..255
        image = image * np.uint8(255 // ((1 << depth) - 1))
    return np.ascontiguousarray(image), text
