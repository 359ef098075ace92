"""BMP reading and writing on numpy, as Pillow's ``BmpImagePlugin`` does.

The reader takes the Windows headers (40-byte INFO, 52/56-byte, V4 108 and
V5 124) and OS/2 v1 (12) and v2 (64): 1-, 4- and 8-bit palettes, 16-bit
(5-5-5, or 5-6-5 through BI_BITFIELDS), 24-bit and 32-bit pixels,
BI_RLE8 and BI_RLE4 (Pillow's ``BmpRleDecoder``, quirks included),
bottom-up and top-down rows.  A palette whose entries are the ordered
greys (two entries: black and white) reads as grey, as Pillow's "L" / "1";
any other is expanded to RGB, as ``convert("RGB")`` expands Pillow's "P".
A 32-bit BI_RGB file reads as RGB with the fourth byte ignored (Pillow's
"BGRX"), the file Pillow writes from RGBA included; BI_BITFIELDS with an
alpha mask reads as RGBA.

The writer gives Pillow's bytes for L, RGB and RGBA (32-bit BI_RGB, BGRA)
images: the 40-byte header, 96 dpi, rows bottom-up and padded to four
bytes.
"""

from __future__ import annotations

import struct

import numpy as np

from sdwebui_tpu_torch.utils.png import check_image_size, unpack_bits

#: Pillow's dpi → pixels per metre, 96 dpi
_PPM = int(96 * 39.3701 + 0.5)
_BI_RGB, _BI_RLE8, _BI_RLE4, _BI_BITFIELDS = 0, 1, 2, 3
#: the bitfield layouts Pillow reads → (shifts of R, G, B, A or None)
_MASKS_32 = {(0xFF0000, 0xFF00, 0xFF, 0x0): (16, 8, 0, None),
             (0xFF000000, 0xFF0000, 0xFF00, 0x0): (24, 16, 8, None),
             (0xFF000000, 0xFF00, 0xFF, 0x0): (24, 8, 0, None),
             (0xFF000000, 0xFF0000, 0xFF00, 0xFF): (24, 16, 8, 0),
             (0xFF, 0xFF00, 0xFF0000, 0xFF000000): (0, 8, 16, 24),
             (0xFF0000, 0xFF00, 0xFF, 0xFF000000): (16, 8, 0, 24),
             (0xFF000000, 0xFF00, 0xFF, 0xFF0000): (24, 8, 0, 16),
             (0x0, 0x0, 0x0, 0x0): (16, 8, 0, 24)}


def _rle(data: bytes, pos: int, width: int, height: int, rle4: bool) -> np.ndarray:
    """Pillow's BmpRleDecoder: (height, width) indices in file row order."""
    out = bytearray()
    x, end = 0, width * height
    n = len(data)
    while len(out) < end and pos + 1 < n:
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:                                   # encoded run
            count = min(count, max(0, width - x))
            if rle4:
                pair = bytes([byte >> 4, byte & 15])
                out += (pair * ((count + 1) // 2))[:count]
            else:
                out += bytes([byte]) * count
            x += count
        elif byte == 0:                             # end of line
            out += b"\0" * (-len(out) % width)
            x = 0
        elif byte == 1:                             # end of bitmap
            break
        elif byte == 2:                             # delta
            if pos + 2 > n:
                break
            right, up = data[pos], data[pos + 1]
            pos += 2
            out += b"\0" * (right + up * width)
            x = len(out) % width
        else:                                       # absolute run
            size = byte // 2 if rle4 else byte
            chunk = data[pos:pos + size]
            pos += size
            if rle4:
                out += bytes(v for b in chunk for v in (b >> 4, b & 15))
            else:
                out += chunk
            if len(chunk) < size:
                break
            x += byte
            pos += pos & 1                          # word alignment
    out = bytes(out[:end]).ljust(end, b"\0")
    return np.frombuffer(out, np.uint8).reshape(height, width)


def _expand(v: np.ndarray, mask: int) -> np.ndarray:
    """A bitfield of 16-bit pixels scaled to 0..255 as Pillow's unpackers:
    value · 255 // max."""
    shift = (mask & -mask).bit_length() - 1
    top = mask >> shift
    return (((v.astype(np.uint32) >> shift) & top) * 255 // top).astype(np.uint8)


def decode_bmp(data: bytes, dib: bool = False) -> tuple[np.ndarray, dict]:
    """BMP bytes → (uint8 (H, W, C), info): C = 1 for grey palettes, 3 for
    RGB (other palettes expanded), 4 for bitfields with alpha; info holds
    Pillow's ``compression`` and ``dpi``.  `dib`: the bytes have no file
    header (a ``.dib`` file, as Pillow's DIB reader takes it): the pixels
    follow the header and palette."""
    if dib:
        data = b"BM" + bytes(12) + data
    if not data.startswith(b"BM") or len(data) < 26:
        raise ValueError("not a BMP file")
    (offset,) = struct.unpack_from("<I", data, 10)
    (hsize,) = struct.unpack_from("<I", data, 14)
    info: dict = {}
    if hsize == 12:
        width, height, _planes, bits = struct.unpack_from("<HHHH", data, 18)
        compression, colors, pad = _BI_RGB, 0, 3
    elif hsize in (40, 52, 56, 64, 108, 124):
        width, height, _planes, bits, compression, _size, ppx, ppy, colors = \
            struct.unpack_from("<iiHHIIiiI", data, 18)
        pad = 4
        info["dpi"] = (ppx / 39.3701, ppy / 39.3701)
    else:
        raise ValueError(f"unsupported BMP header size ({hsize})")
    info["compression"] = compression
    top_down = height < 0
    height = abs(height)
    check_image_size(width, height)
    if width <= 0 or height == 0:
        raise ValueError("BMP of no pixels")
    pal_at = 14 + hsize
    masks = None
    if compression == _BI_BITFIELDS:
        if hsize >= 52:
            masks = struct.unpack_from("<IIII" if hsize >= 56 else "<III", data, 54)
        else:
            masks = struct.unpack_from("<III", data, pal_at)
            pal_at += 12
        masks = tuple(masks) + (0,) * (4 - len(masks))
    elif compression not in (_BI_RGB, _BI_RLE8, _BI_RLE4):
        raise ValueError(f"unsupported BMP compression {compression}")
    if (compression == _BI_RLE8 and bits != 8) or (compression == _BI_RLE4 and bits != 4):
        raise ValueError(f"BMP RLE with {bits}-bit pixels")
    if dib:
        offset = pal_at + (pad * (colors or (1 << bits)) if bits <= 8 else 0)
    if bits <= 8:
        colors = colors or (1 << bits)
        pal = np.frombuffer(data[pal_at:pal_at + pad * colors], np.uint8)
        pal = pal[:len(pal) // pad * pad].reshape(-1, pad)[:, 2::-1]
        if compression == _BI_RGB:
            stride = ((width * bits + 31) >> 5) << 2
            rows = np.frombuffer(data[offset:offset + stride * height].ljust(stride * height, b"\0"),
                                 np.uint8).reshape(height, stride)
            index = unpack_bits(rows, bits, width)
        else:
            index = _rle(data, offset, width, height, compression == _BI_RLE4)
        full = np.zeros((256, 3), np.uint8)
        full[:len(pal)] = pal[:256]
        greys = np.array((0, 255) if colors == 2 else range(colors))
        if len(pal) >= colors and (pal[:colors] == greys[:, None]).all():   # "1" or "L"
            image = (index * np.uint8(255) if colors == 2 else index)[:, :, None]
        else:
            image = full[index]
    elif bits in (16, 24, 32):
        stride = ((width * bits + 31) >> 5) << 2
        raw = np.frombuffer(data[offset:offset + stride * height].ljust(stride * height, b"\0"),
                            np.uint8).reshape(height, stride)
        if bits == 24:
            if masks is not None and masks[:3] != (0xFF0000, 0xFF00, 0xFF):
                raise ValueError("unsupported BMP bitfields layout")
            image = raw[:, :width * 3].reshape(height, width, 3)[:, :, ::-1]
        elif bits == 16:
            v = raw[:, :width * 2].copy().view("<u2")
            rgb = masks[:3] if masks is not None else (0x7C00, 0x3E0, 0x1F)
            if rgb not in ((0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F)):
                raise ValueError("unsupported BMP bitfields layout")
            image = np.stack([_expand(v, m) for m in rgb], axis=2)
        else:
            v = raw[:, :width * 4].copy().view("<u4")
            shifts = (16, 8, 0, None) if masks is None else _MASKS_32.get(masks)
            if shifts is None:
                raise ValueError("unsupported BMP bitfields layout")
            image = np.stack([((v >> s) & 255).astype(np.uint8) for s in shifts if s is not None],
                             axis=2)
    else:
        raise ValueError(f"unsupported BMP bit depth {bits}")
    if not top_down:
        image = image[::-1]
    return np.ascontiguousarray(image), info


def encode_bmp(image: np.ndarray, dib: bool = False) -> bytes:
    """uint8 (H, W) / (H, W, 1) grey, (H, W, 3) RGB or (H, W, 4) RGBA →
    Pillow's BMP bytes; `dib`: without the 14-byte file header, as Pillow
    writes ``.dib``."""
    a = np.asarray(image)
    if a.dtype != np.uint8:
        raise ValueError(f"expected uint8, got {a.dtype}")
    if a.ndim == 3 and a.shape[2] == 1:
        a = a[:, :, 0]
    h, w = a.shape[:2]
    if a.ndim == 2:
        table = bytes(b for i in range(256) for b in (i, i, i, 0))
        bits, rows = 8, a
    elif a.shape[2] in (3, 4):
        table = b""
        bits = 24 if a.shape[2] == 3 else 32
        rows = a[:, :, [2, 1, 0] + ([3] if bits == 32 else [])].reshape(h, -1)
    else:
        raise ValueError(f"cannot write a {a.shape[2]}-channel image as BMP")
    colors = len(table) // 4
    stride = ((w * bits + 7) // 8 + 3) & ~3
    size = stride * h
    offset = 14 + 40 + colors * 4
    body = np.zeros((h, stride), np.uint8)
    body[:, :rows.shape[1]] = rows[::-1]
    head = b"" if dib else b"BM" + struct.pack("<III", offset + size, 0, offset)
    return (head + struct.pack("<IiiHHIIiiII", 40, w, h, 1, bits, 0, size, _PPM, _PPM, colors,
                               colors)
            + table + body.tobytes())
