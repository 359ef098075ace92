"""A small PNG writer and reader on the standard library (zlib + struct).

Writes 8-bit RGB/RGBA images with text chunks — the ``parameters`` chunk
carries the infotext, as the JAX server writes it through PIL
(``sdwebui_tpu/server/app.py:499``).  The reader takes what the writer
produces: non-interlaced 8-bit RGB/RGBA with unfiltered rows.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {3: 2, 4: 6}        # channels → PNG colour type


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
    """uint8 (H, W, 3|4) → PNG bytes with optional text chunks."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] not in _COLOR_TYPES:
        raise ValueError(f"expected uint8 (H, W, 3|4), got {image.dtype} {image.shape}")
    h, w, c = image.shape
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    rows = np.empty((h, 1 + w * c), np.uint8)
    rows[:, 0] = 0                                   # filter type None
    rows[:, 1:] = image.reshape(h, w * c)
    parts = [_SIGNATURE, _chunk(b"IHDR", ihdr)]
    parts += [_text_chunk(k, v) for k, v in (text or {}).items()]
    parts += [_chunk(b"IDAT", zlib.compress(rows.tobytes(), level)), _chunk(b"IEND", b"")]
    return b"".join(parts)


def decode_png(data: bytes) -> tuple[np.ndarray, dict]:
    """PNG bytes → (uint8 (H, W, C), text chunks)."""
    if not data.startswith(_SIGNATURE):
        raise ValueError("not a PNG file")
    pos = len(_SIGNATURE)
    idat, text, hdr = [], {}, None
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
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    channels = {2: 3, 6: 4}.get(ctype)
    if depth != 8 or channels is None or interlace != 0:
        raise ValueError(f"unsupported PNG: depth {depth}, colour type {ctype}, "
                         f"interlace {interlace}")
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(h, 1 + w * channels)
    if rows[:, 0].any():
        raise ValueError("filtered PNG rows are not supported (encode_png writes none)")
    return rows[:, 1:].reshape(h, w, channels).copy(), text
