"""ICO, CUR and ICNS reading and ICO and ICNS writing on numpy, as Pillow's
``IcoImagePlugin``, ``CurImagePlugin`` and ``IcnsImagePlugin`` do.

ICO: the entry Pillow loads is the largest (entries sorted by colour depth,
then by area, largest first); a PNG entry reads through ``utils/png``, a BMP
entry through ``utils/bmp`` at half its header's height, with its alpha
from the fourth byte of 32-bit pixels or from the AND mask (set bits
transparent), as Pillow's ``IcoFile.frame``.  CUR: the first entry, or a
later one both wider and taller, read as its BMP with no mask.  ICNS: the
largest size's entries (Pillow's ``bestsize``): PNG entries, or the
RLE-packed ``it32`` / ``ih32`` / ``il32`` / ``is32`` RGB with its
``t8mk`` / ``h8mk`` / ``l8mk`` / ``s8mk`` mask, or JPEG 2000 entries (read
through ``utils/jpeg2000`` and converted to RGBA, as Pillow's
``read_png_or_jpeg2000``).

The writers follow Pillow's savers: ICO holds a PNG of each of Pillow's
sizes (16 to 256) that fits the image, thumbnailed with LANCZOS and its
aspect kept; ICNS holds a PNG of the image resized (BICUBIC, squared) to
32, 64, 128, 256, 512 and 1024, under Pillow's eight entry types.  The
PNGs are ``utils/png``'s, so the files are Pillow's in layout and pixels
but not in bytes."""

from __future__ import annotations

import math
import struct

import numpy as np

from sdwebui_tpu_torch.utils import images as images_util
from sdwebui_tpu_torch.utils.bmp import decode_bmp
from sdwebui_tpu_torch.utils.image_modes import NotThisFormat
from sdwebui_tpu_torch.utils.jpeg2000 import decode_jpeg2000
from sdwebui_tpu_torch.utils.png import decode_png, encode_png, unpack_bits

_PNG = b"\x89PNG\r\n\x1a\n"
_J2K = (b"\xff\x4f\xff\x51", b"\x0d\x0a\x87\x0a", b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a")
ICO_SIZES = [(16, 16), (24, 24), (32, 32), (48, 48), (64, 64), (128, 128), (256, 256)]


def accept_ico(prefix: bytes) -> bool:
    return prefix.startswith(b"\0\0\1\0")


def accept_cur(prefix: bytes) -> bool:
    return prefix.startswith(b"\0\0\2\0")


def accept_icns(prefix: bytes) -> bool:
    return prefix.startswith(b"icns")


def _dib(data: bytes) -> tuple[np.ndarray, dict]:
    """A BMP entry (a DIB with no file header, its header's height covering
    the AND mask too) read at half that height → (pixels, info)."""
    if len(data) < 16:
        raise ValueError("ICO: truncated BMP entry")
    (h2,) = struct.unpack_from("<i", data, 8)
    head = bytearray(data)
    rows = abs(h2) // 2
    struct.pack_into("<i", head, 8, rows if h2 > 0 else -rows)
    return decode_bmp(bytes(head), dib=True)


def _rgba(pixels: np.ndarray) -> np.ndarray:
    """Pillow's ``convert("RGBA")`` of a grey or RGB image, alpha 255."""
    rgb = images_util.to_rgb(pixels)
    return np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)], axis=2)


def decode_ico(data: bytes) -> tuple[np.ndarray, dict]:
    """ICO bytes → (uint8 (H, W, C) of the largest entry, info with
    Pillow's ``sizes``)."""
    if len(data) < 6 or not accept_ico(data):
        raise NotThisFormat("not an ICO file")
    (count,) = struct.unpack_from("<H", data, 4)
    entries = []
    for i in range(count):
        s = data[6 + 16 * i:22 + 16 * i]
        if len(s) < 16:
            raise NotThisFormat("truncated ICO directory")
        w, h, colors = s[0] or 256, s[1] or 256, s[2]
        bpp, size, offset = struct.unpack_from("<HII", s, 6)
        depth = bpp or (colors != 0 and math.ceil(math.log(colors, 2))) or 256
        entries.append(dict(dim=(w, h), bpp=bpp, size=size, offset=offset, depth=depth))
    if not entries:
        raise NotThisFormat("ICO without entries")
    entries.sort(key=lambda e: e["depth"])
    entries.sort(key=lambda e: e["dim"][0] * e["dim"][1], reverse=True)
    info = {"sizes": {e["dim"] for e in entries}}
    e = entries[0]
    body = data[e["offset"]:]
    if body[:8] == _PNG:
        return decode_png(body)[0], info
    pixels, _ = _dib(body)
    h, w = pixels.shape[:2]
    (hsize,) = struct.unpack_from("<I", body, 0)
    if e["bpp"] == 32:
        at = _pixel_offset(body, hsize)
        alpha = np.frombuffer(body[at:at + w * h * 4], np.uint8)[3::4]
        if len(alpha) < w * h:
            raise ValueError("ICO: truncated alpha")
        mask = alpha.reshape(h, w)[::-1]
    else:
        stride = (w + 31) // 32 * 4
        at = e["offset"] + e["size"] - stride * h
        raw = data[at:at + stride * h]
        if len(raw) < stride * h:
            raise ValueError("ICO: truncated AND mask")
        bits = unpack_bits(np.frombuffer(raw, np.uint8).reshape(h, stride), 1, w)
        mask = ((1 - bits) * 255).astype(np.uint8)[::-1]
    out = _rgba(pixels)
    out[:, :, 3] = mask
    return out, info


def _pixel_offset(body: bytes, hsize: int) -> int:
    """Where a DIB's pixels start: after the header, the bitfield masks
    of a 40-byte BI_BITFIELDS header and the palette."""
    bits, compression = struct.unpack_from("<HI", body, 14)
    colors = struct.unpack_from("<I", body, 32)[0] if hsize >= 40 else 0
    at = hsize + (12 if hsize == 40 and compression == 3 else 0)
    if bits <= 8:
        at += (4 if hsize != 12 else 3) * (colors or (1 << bits))
    return at


def decode_cur(data: bytes) -> tuple[np.ndarray, dict]:
    """CUR bytes → (uint8 (H, W, C), info) of Pillow's pick, with no mask."""
    if len(data) < 6 or not accept_cur(data):
        raise NotThisFormat("not a CUR file")
    (count,) = struct.unpack_from("<H", data, 4)
    m = b""
    for i in range(count):
        s = data[6 + 16 * i:22 + 16 * i]
        if not m:
            m = s
        elif s[0] > m[0] and s[1] > m[1]:
            m = s
    if not m:
        raise NotThisFormat("no cursors were found")
    (offset,) = struct.unpack_from("<I", m, 12)
    pixels, info = _dib(data[offset:])
    return pixels, info


# --------------------------------------------------------------------------
# ICNS
# --------------------------------------------------------------------------

#: Pillow's IcnsFile.SIZES: (w, h, scale) → entry types, in its order
ICNS_SIZES = {(512, 512, 2): (b"ic10",), (512, 512, 1): (b"ic09",), (256, 256, 2): (b"ic14",),
              (256, 256, 1): (b"ic08",), (128, 128, 2): (b"ic13",),
              (128, 128, 1): (b"ic07", b"it32", b"t8mk"), (64, 64, 1): (b"icp6",),
              (32, 32, 2): (b"ic12",), (48, 48, 1): (b"ih32", b"h8mk"),
              (32, 32, 1): (b"icp5", b"il32", b"l8mk"), (16, 16, 2): (b"ic11",),
              (16, 16, 1): (b"icp4", b"is32", b"s8mk")}


def _icns_rgb(data: bytes, pos: int, length: int, side: int) -> np.ndarray:
    """Pillow's ``read_32``: raw RGB, or three planes of a PackBits-like RLE
    (a byte with its top bit set repeats the next byte (b - 125) times,
    another is followed by b + 1 literal bytes)."""
    n = side * side
    if length == n * 3:
        return np.frombuffer(data, np.uint8, n * 3, pos).reshape(side, side, 3).copy()
    planes = []
    for _ in range(3):
        out = bytearray()
        left = n
        while left > 0:
            if pos >= len(data):
                break
            b = data[pos]
            pos += 1
            if b & 0x80:
                count = b - 125
                out += data[pos:pos + 1] * count
                pos += 1
            else:
                count = b + 1
                out += data[pos:pos + count]
                pos += count
            left -= count
        if left != 0:
            raise ValueError(f"ICNS: error reading channel [{left} left]")
        planes.append(np.frombuffer(bytes(out[:n]), np.uint8))
    return np.stack(planes, axis=1).reshape(side, side, 3)


def _rgba(px: np.ndarray) -> np.ndarray:
    """Decoded grey, grey + alpha, RGB or RGBA pixels → RGBA (``convert``)."""
    c = px.shape[2]
    if c == 4:
        return px
    alpha = px[:, :, 1:2] if c == 2 else np.full(px.shape[:2] + (1,), 255, np.uint8)
    rgb = px[:, :, :1].repeat(3, axis=2) if c in (1, 2) else px
    return np.concatenate([rgb, alpha], axis=2)


def decode_icns(data: bytes) -> tuple[np.ndarray, dict]:
    """ICNS bytes → (uint8 (H, W, C) of the largest size, info with
    Pillow's ``sizes``)."""
    if len(data) < 8 or not accept_icns(data):
        raise NotThisFormat("not an icns file")

    (filesize,) = struct.unpack_from(">I", data, 4)
    blocks = {}
    i = 8
    while i < filesize:
        if i + 8 > len(data):
            raise NotThisFormat("truncated icns file")
        sig, size = struct.unpack_from(">4sI", data, i)
        if size <= 0:
            raise NotThisFormat("invalid block header")
        blocks[sig] = (i + 8, size - 8)
        i += size
    sizes = [s for s, kinds in ICNS_SIZES.items() if any(k in blocks for k in kinds)]
    if not sizes:
        raise NotThisFormat("no 32bit icon resources found")
    best = max(sizes)
    channels = {}
    for kind in ICNS_SIZES[best]:
        if kind not in blocks:
            continue
        pos, length = blocks[kind]
        side = best[0] * best[2]
        if kind.endswith(b"mk"):
            channels["A"] = np.frombuffer(data, np.uint8, side * side, pos).reshape(side, side)
        elif kind in (b"it32", b"ih32", b"il32", b"is32"):
            if kind == b"it32":
                if data[pos:pos + 4] != b"\0\0\0\0":
                    raise NotThisFormat("unknown signature, expecting 0x00000000")
                pos, length = pos + 4, length - 4
            channels["RGB"] = _icns_rgb(data, pos, length, side)
        else:
            head = data[pos:pos + 12]
            if head.startswith(_PNG):
                channels["RGBA"] = decode_png(data[pos:pos + length])[0]
            elif head.startswith(_J2K[:2]) or head == _J2K[2]:
                try:
                    channels["RGBA"] = _rgba(decode_jpeg2000(data[pos:pos + length])[0])
                except NotThisFormat as e:       # Pillow raises it at load, past the search
                    raise ValueError(str(e)) from None
            else:
                raise ValueError("unsupported icon subimage format")
    info = {"sizes": sizes}
    if "RGBA" in channels:
        return channels["RGBA"], info
    rgb = channels["RGB"]
    if "A" in channels:
        return np.concatenate([rgb, channels["A"][:, :, None]], axis=2), info
    return rgb, info


# --------------------------------------------------------------------------
# writers
# --------------------------------------------------------------------------

def thumbnail_size(w: int, h: int, size: tuple) -> tuple[int, int]:
    """Pillow's ``thumbnail`` size: the box with the image's aspect kept
    (``preserve_aspect_ratio``), or the image's own when it fits."""
    x, y = size
    if x >= w and y >= h:
        return w, h
    aspect = w / h

    def round_aspect(number: float, key) -> int:
        return max(min(math.floor(number), math.ceil(number), key=key), 1)

    if x / y >= aspect:
        x = round_aspect(y * aspect, key=lambda n: abs(aspect - n / y))
    else:
        y = round_aspect(x / aspect, key=lambda n: 0 if n == 0 else abs(aspect - x / n))
    return x, y


def _grey_or_rgb(image: np.ndarray, what: str) -> np.ndarray:
    a = images_util.as_hwc(image)
    if a.shape[2] not in (1, 3):
        raise NotImplementedError(f"writing {what} from a {a.shape[2]}-channel image is not "
                                  "ported (Pillow resizes it premultiplied)")
    return a


def encode_ico(image: np.ndarray) -> bytes:
    """uint8 (H, W, 1|3) → an ICO of PNG entries, as Pillow's saver lays
    it out."""
    a = _grey_or_rgb(image, "ICO")
    h, w = a.shape[:2]
    frames = []
    for size in sorted(set(ICO_SIZES)):
        if size[0] > w or size[1] > h or size[0] > 256 or size[1] > 256:
            continue
        tw, th = thumbnail_size(w, h, size)
        frames.append(a if (tw, th) == (w, h) else
                      images_util.resize(a, (tw, th), "lanczos"))
    out = bytearray(b"\0\0\1\0" + struct.pack("<H", len(frames)))
    offset = len(out) + 16 * len(frames)
    blobs = []
    for frame in frames:
        fh, fw = frame.shape[:2]
        blob = encode_png(frame)
        out += struct.pack("<BBBBHHII", fw if fw < 256 else 0, fh if fh < 256 else 0, 0, 0,
                           0, 32, len(blob), offset)
        offset += len(blob)
        blobs.append(blob)
    return bytes(out) + b"".join(blobs)


#: Pillow's ICNS saver: entry type → side
ICNS_WRITTEN = {b"ic07": 128, b"ic08": 256, b"ic09": 512, b"ic10": 1024, b"ic11": 32,
                b"ic12": 64, b"ic13": 256, b"ic14": 512}


def encode_icns(image: np.ndarray) -> bytes:
    """uint8 (H, W, 1|3) → an ICNS of PNG entries, as Pillow's saver lays
    it out."""
    a = _grey_or_rgb(image, "ICNS")
    streams = {side: encode_png(images_util.resize(a, (side, side), "bicubic"))
               for side in sorted(set(ICNS_WRITTEN.values()))}
    entries = [(kind, 8 + len(streams[side]), streams[side])
               for kind, side in ICNS_WRITTEN.items()]
    length = 8 + 8 + 8 * len(entries) + sum(e[1] for e in entries)
    out = bytearray(b"icns" + struct.pack(">i", length) + b"TOC "
                    + struct.pack(">i", 8 + 8 * len(entries)))
    for kind, size, _ in entries:
        out += kind + struct.pack(">i", size)
    for kind, size, stream in entries:
        out += kind + struct.pack(">i", size) + stream
    return bytes(out)
