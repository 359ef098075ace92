"""TGA (Targa) reading and writing on numpy, as Pillow's
``TgaImagePlugin`` (and its ``tga_rle`` decoder) does.

TGA has no signature: Pillow opens any bytes whose 18-byte header holds a
colour-map type of 0 or 1, a positive size, a depth of 1, 8, 16, 24 or 32
bits and an image type it knows (``header_ok``), so the check runs where
Pillow tries the plugin (``utils/image_io``).  The reader takes raw and RLE
images (runs may cross rows), true colour at 16 bits (Pillow's "BGRA;15Z":
5-5-5 with the top bit an inverted alpha), 24 and 32 bits, grey at 1, 8 and
16 (grey + alpha) bits, colour-mapped images with 16- or 24-bit maps
(expanded to RGB; a 32-bit map raises, as Pillow's palette does), and all
four origins.  Info holds Pillow's
``orientation``, ``compression`` ("tga_rle") and ``id_section``.

The writer gives Pillow's bytes (no RLE, bottom-up rows, the TGA 2.0
footer) for grey, grey + alpha, RGB and RGBA images."""

from __future__ import annotations

import struct

import numpy as np

from sdwebui_tpu_torch.utils.image_modes import NotThisFormat, as_output, from_palette
from sdwebui_tpu_torch.utils.png import check_image_size, unpack_bits

#: (image type & 7, depth) → Pillow's mode of the samples
_MODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA", (2, 16): "BGRA;15Z",
          (2, 24): "BGR", (2, 32): "BGRA"}
_FOOTER = b"\0" * 8 + b"TRUEVISION-XFILE." + b"\0"


def header_ok(data: bytes) -> bool:
    """Whether Pillow's ``TgaImageFile._open`` takes the header (no
    ``SyntaxError`` or ``IndexError``)."""
    if len(data) < 18:
        return False
    cmap, itype, depth, flags = data[1], data[2], data[16], data[17]
    w, h = struct.unpack_from("<HH", data, 12)
    if cmap not in (0, 1) or w <= 0 or h <= 0 or depth not in (1, 8, 16, 24, 32):
        return False
    if itype not in (1, 2, 3, 9, 10, 11):
        return False
    return not cmap or data[7] in (16, 24, 32)


def _bgra15(v: np.ndarray) -> np.ndarray:
    """16-bit little-endian pixels → (..., 4) RGBA, Pillow's "BGRA;15Z"."""
    v = v.astype(np.uint32)
    out = np.empty(v.shape + (4,), np.uint8)
    for ch, shift in enumerate((10, 5, 0)):
        out[..., ch] = ((v >> shift) & 31) * 255 // 31
    out[..., 3] = np.where(v & 0x8000, 0, 255)
    return out


def _rle(data: bytes, pos: int, size: int, depth: int) -> bytes:
    """Pillow's ``tga_rle``: packets of a run (top bit set) or of raw
    pixels, n + 1 pixels each, until `size` bytes."""
    px = max(1, depth // 8)
    out = bytearray()
    n = len(data)
    while len(out) < size and pos < n:
        head = data[pos]
        pos += 1
        count = (head & 0x7F) + 1
        if head & 0x80:
            out += data[pos:pos + px] * count
            pos += px
        else:
            out += data[pos:pos + px * count]
            pos += px * count
    if len(out) < size:
        raise ValueError("TGA: image file is truncated")
    return bytes(out[:size])


def decode_tga(data: bytes) -> tuple[np.ndarray, dict]:
    """TGA bytes → (uint8 (H, W, C), info)."""
    if not header_ok(data):
        raise NotThisFormat("not a TGA file")
    id_len, cmap, itype = data[0], data[1], data[2]
    depth, flags = data[16], data[17]
    w, h = struct.unpack_from("<HH", data, 12)
    check_image_size(w, h)
    if itype in (3, 11):
        mode = {1: "1", 16: "LA"}.get(depth, "L")
    elif itype in (1, 9):
        mode = "P" if cmap else "L"
    else:
        mode = "RGB" if depth == 24 else "RGBA"
    orientation = flags & 0x30
    flip_x = orientation in (0x10, 0x30)
    info: dict = {"orientation": 1 if orientation in (0x20, 0x30) else -1}
    if itype & 8:
        info["compression"] = "tga_rle"
    pos = 18
    if id_len:
        info["id_section"] = data[pos:pos + id_len]
        pos += id_len
    palette = None
    if cmap:
        start, count, mapdepth = struct.unpack_from("<HHB", data, 3)
        if mapdepth == 32:
            raise ValueError("TGA with a 32-bit colour map: Pillow's palette has no BGRA "
                             "raw mode")
        entry = mapdepth // 8
        raw = bytes(entry * start) + data[pos:pos + entry * count]
        pos += entry * count
        if mapdepth == 16:
            raw = raw[:len(raw) // 2 * 2]
            palette = _bgra15(np.frombuffer(raw, "<u2"))[:, :3]
        else:
            p = np.frombuffer(raw[:len(raw) // entry * entry], np.uint8).reshape(-1, entry)
            palette = p[:, 2::-1]
    rawmode = _MODES.get((itype & 7, depth))
    if rawmode is None:
        raise ValueError(f"TGA: image type {itype} at {depth} bits is not read")
    row = (w * depth + 7) // 8
    if itype & 8:
        body = _rle(data, pos, row * h, depth)
    else:
        body = data[pos:pos + row * h]
        if len(body) < row * h:
            raise ValueError("TGA: image file is truncated")
    rows = np.frombuffer(body, np.uint8).reshape(h, row)
    if rawmode == "1":
        a = unpack_bits(rows, 1, w)
    elif rawmode == "BGRA;15Z":
        a = _bgra15(rows.view("<u2"))
    elif rawmode in ("BGR", "BGRA"):
        a = rows.reshape(h, w, -1)
        a = np.concatenate([a[:, :, 2::-1], a[:, :, 3:]], axis=2)
    else:
        a = rows.reshape(h, w, -1)
    if info["orientation"] == -1:
        a = a[::-1]
    if flip_x:
        a = a[:, ::-1]
    if mode == "P":
        return from_palette(a[:, :, 0], palette), info
    return as_output(mode, np.ascontiguousarray(a)), info


def encode_tga(image: np.ndarray) -> bytes:
    """uint8 (H, W, 1|2|3|4) → Pillow's uncompressed TGA bytes."""
    a = np.asarray(image)
    if a.ndim == 2:
        a = a[:, :, None]
    h, w, c = a.shape
    bits, itype = {1: (8, 3), 2: (16, 3), 3: (24, 2), 4: (32, 2)}[c]
    flags = 8 if c in (2, 4) else 0
    if c >= 3:
        a = np.concatenate([a[:, :, 2::-1], a[:, :, 3:]], axis=2)
    head = struct.pack("<BBBHHBHHHHBB", 0, 0, itype, 0, 0, 0, 0, 0, w, h, bits, flags)
    return head + np.ascontiguousarray(a[::-1]).tobytes() + _FOOTER
