"""PCX and DCX reading and PCX writing on numpy, as Pillow's
``PcxImagePlugin`` and ``DcxImagePlugin`` (and the ``pcx`` codec) do.

The reader takes 1-bit bitmaps ("1"), 1-bit 2- and 4-plane images with the
header's 16-colour palette, 8-bit grey or palette images (the 769-byte
trailer; an ordered grey ramp reads as grey) and 24-bit images in three
planes, each row of planes RLE-coded as one stream of ``planes × stride``
bytes.  A DCX reads as its first page.  Other layouts raise as Pillow's
"unknown PCX mode" does.

The writer gives Pillow's bytes for grey and RGB images (version 5, RLE in
runs of at most 63, each plane row padded to an even length, 100 dpi, and
the grey ramp after a grey image)."""

from __future__ import annotations

import struct

import numpy as np

from sdwebui_tpu_torch.utils.image_modes import NotThisFormat, as_output, from_palette
from sdwebui_tpu_torch.utils.png import check_image_size, unpack_bits

DCX_MAGIC = 0x3ADE68B1


def accept(prefix: bytes) -> bool:
    return len(prefix) >= 2 and prefix[0] == 10 and prefix[1] in (0, 2, 3, 5)


def accept_dcx(prefix: bytes) -> bool:
    return len(prefix) >= 4 and struct.unpack_from("<I", prefix)[0] == DCX_MAGIC


def header_ok(data: bytes) -> bool:
    """Whether Pillow's ``_open`` gets past its SyntaxErrors."""
    if len(data) < 68 or not accept(data):
        return False
    x0, y0, x1, y1 = struct.unpack_from("<HHHH", data, 4)
    return x1 + 1 > x0 and y1 + 1 > y0


def _unrle(data: bytes, pos: int, size: int) -> bytes:
    """The ``pcx`` decoder: a byte with its top two bits set repeats the
    next byte (its low six bits) times; any other byte is itself."""
    out = bytearray()
    n = len(data)
    while len(out) < size and pos < n:
        b = data[pos]
        pos += 1
        if b & 0xC0 == 0xC0:
            if pos >= n:
                break
            out += bytes([data[pos]]) * (b & 0x3F)
            pos += 1
        else:
            out.append(b)
    if len(out) < size:
        raise ValueError("PCX: image file is truncated")
    return bytes(out[:size])


def decode_pcx(data: bytes, base: int = 0) -> tuple[np.ndarray, dict]:
    """PCX bytes (the image at `base`) → (uint8 (H, W, 1|3), info)."""
    s = data[base:base + 68]
    if not header_ok(s):
        raise NotThisFormat("not a PCX file")
    x0, y0, x1, y1 = struct.unpack_from("<HHHH", s, 4)
    version, bits, planes = s[1], s[3], s[65]
    (provided,) = struct.unpack_from("<H", s, 66)
    info = {"dpi": struct.unpack_from("<HH", s, 12)}
    palette = None
    if bits == 1 and planes == 1:
        mode = "1"
    elif bits == 1 and planes in (2, 4):
        mode = "P"
        palette = np.frombuffer(s[16:64], np.uint8).reshape(16, 3)
    elif version == 5 and bits == 8 and planes == 1:
        mode = "L"
        tail = data[-769:]
        if len(tail) == 769 and tail[0] == 12:
            ramp = np.repeat(np.arange(256, dtype=np.uint8), 3).tobytes()
            if tail[1:] != ramp:
                mode = "P"
                palette = np.frombuffer(tail[1:], np.uint8).reshape(256, 3)
    elif version == 5 and bits == 8 and planes == 3:
        mode = "RGB"
    else:
        raise ValueError(f"unknown PCX mode: version {version}, {bits} bits, {planes} planes")
    w, h = x1 + 1 - x0, y1 + 1 - y0
    check_image_size(w, h)
    stride = (w * bits + 7) // 8
    if provided != stride:
        stride += stride % 2
    raw = np.frombuffer(_unrle(data, base + 128, planes * stride * h), np.uint8)
    rows = raw.reshape(h, planes, stride)
    if bits == 1:
        need = (w + 7) // 8
        plane_bits = unpack_bits(rows[:, :, :need].reshape(h * planes, need), 1, w)
        plane_bits = plane_bits.reshape(h, planes, w)
        if mode == "1":
            return as_output("1", plane_bits[:, 0]), info
        index = sum(plane_bits[:, p].astype(np.uint8) << p for p in range(planes))
        return from_palette(index, palette), info
    if mode == "RGB":
        return np.ascontiguousarray(rows[:, :, :w].transpose(0, 2, 1)), info
    index = rows[:, 0, :w]
    if mode == "P":
        return from_palette(index, palette), info
    return np.ascontiguousarray(index[:, :, None]), info


def decode_dcx(data: bytes) -> tuple[np.ndarray, dict]:
    """DCX bytes → its first page, as PCX."""
    if len(data) < 8 or not accept_dcx(data):
        raise NotThisFormat("not a DCX file")
    (offset,) = struct.unpack_from("<I", data, 4)
    if not offset:
        raise ValueError("DCX without pages")
    return decode_pcx(data, offset)


def _rle_lines(lines: np.ndarray, padding: int) -> bytes:
    """Pillow's ``PcxEncode`` over (n, bytes) lines: runs of at most 63, a
    single byte below 0xC0 written as itself; `padding` zero bytes after
    each line."""
    n, length = lines.shape
    flat = lines.reshape(-1).astype(np.int32)
    start = np.ones(flat.size, bool)
    start[1:] = flat[1:] != flat[:-1]
    start[::length] = True
    starts = np.flatnonzero(start)
    runs = np.diff(np.append(starts, flat.size))
    values = flat[starts]
    chunks = (runs + 62) // 63
    key = np.repeat(starts, chunks)
    first = np.repeat(np.cumsum(chunks) - chunks, chunks)
    k = np.arange(len(key)) - first
    count = np.minimum(63, np.repeat(runs, chunks) - 63 * k)
    val = np.repeat(values, chunks)
    single = (count == 1) & (val < 0xC0)
    codes = np.stack([np.where(single, val, 0xC0 | count), val], axis=1)
    nb = np.where(single, 1, 2)
    if padding:
        pad_key = np.arange(n) * length + length - 0.5
        codes = np.concatenate([codes, np.zeros((n * padding, 2), np.int64)])
        nb = np.concatenate([nb, np.ones(n * padding, np.int64)])
        key = np.concatenate([key.astype(np.float64), np.repeat(pad_key, padding)])
        order = np.argsort(key, kind="stable")
        codes, nb = codes[order], nb[order]
    return codes[np.arange(2)[None, :] < nb[:, None]].astype(np.uint8).tobytes()


def encode_pcx(image: np.ndarray) -> bytes:
    """uint8 (H, W, 1|3) → Pillow's PCX bytes."""
    a = np.asarray(image)
    if a.ndim == 2:
        a = a[:, :, None]
    h, w, c = a.shape
    if c not in (1, 3):
        raise ValueError(f"Cannot save {'LA' if c == 2 else 'RGBA'} images as PCX")
    planes = c
    stride = w + w % 2
    head = (struct.pack("<BBBBHHHHHH", 10, 5, 1, 8, 0, 0, w - 1, h - 1, 100, 100)
            + b"\0" * 24 + b"\xff" * 24 + b"\0" + struct.pack("<BHHHH", planes, stride, 1, w, h)
            + b"\0" * 54)
    lines = np.ascontiguousarray(a.transpose(0, 2, 1))
    if w == 1:            # Pillow's encoder loses the last plane of a 1-byte line
        lines = lines[:, :-1]
    lines = lines.reshape(-1, w)
    body = _rle_lines(lines, stride - w)
    tail = b""
    if c == 1:
        tail = b"\x0c" + np.repeat(np.arange(256, dtype=np.uint8), 3).tobytes()
    return head + body + tail
