"""The small raster formats Pillow opens, read on numpy as its plugins
read them: SUN (``SunImagePlugin``, raw and RLE), MSP (``MspImagePlugin``,
version 1 and the RLE of version 2), XBM (``XbmImagePlugin``), XPM
(``XpmImagePlugin``), PIXAR (``PixarImagePlugin``), SPIDER
(``SpiderImagePlugin``, Pillow's "F"), GBR (``GbrImagePlugin``), XV
thumbnails (``XVThumbImagePlugin``), FITS (``FitsImagePlugin``),
McIdas areas (``McIdasImagePlugin``) and IPTC/NAA records
(``IptcImagePlugin``: a grey layer, raw or JPEG, or one band of an RGB or
CMYK image).

Each ``decode_x(data)`` gives uint8 (H, W, C) pixels as Pillow's convert
sees the mode ``Image.open`` gives (``utils/image_modes``) and Pillow's
``info``; where Pillow's ``_open`` would refuse the bytes with a
``SyntaxError`` it raises ``NotThisFormat``, so ``utils/image_io`` tries the
next plugin, as ``Image.open`` does.  MSP and XBM writers are not needed:
Pillow writes only mode "1" as either, and JAX's save path hands it RGB,
which Pillow refuses (``utils/saving``)."""

from __future__ import annotations

import re
import struct

import numpy as np

from sdwebui_tpu_torch.utils.image_modes import (NotThisFormat, as_output, cmyk_to_rgb,
                                                 from_palette)
from sdwebui_tpu_torch.utils.png import check_image_size, unpack_bits


def _checked(w: int, h: int, what: str) -> None:
    if w <= 0 or h <= 0:
        raise NotThisFormat(f"{what} of {w}×{h} pixels")
    check_image_size(w, h)


def _take(data: bytes, pos: int, need: int, what: str) -> bytes:
    raw = data[pos:pos + need]
    if len(raw) < need:
        raise ValueError(f"{what}: image file is truncated")
    return raw


# --------------------------------------------------------------------------
# SUN
# --------------------------------------------------------------------------

def accept_sun(prefix: bytes) -> bool:
    return len(prefix) >= 4 and struct.unpack_from(">I", prefix)[0] == 0x59A66A95


def _sun_rle(data: bytes, pos: int, size: int) -> bytes:
    """Pillow's ``sun_rle``: 0x80 0 is a literal 0x80, 0x80 n v a run of
    n + 1 bytes v, any other byte itself."""
    out = bytearray()
    n = len(data)
    while len(out) < size and pos < n:
        b = data[pos]
        if b == 0x80:
            if pos + 1 >= n:
                break
            if data[pos + 1] == 0:
                out.append(0x80)
                pos += 2
            else:
                if pos + 2 >= n:
                    break
                out += bytes([data[pos + 2]]) * (data[pos + 1] + 1)
                pos += 3
        else:
            out.append(b)
            pos += 1
    if len(out) < size:
        raise ValueError("SUN: image file is truncated")
    return bytes(out[:size])


def decode_sun(data: bytes) -> tuple[np.ndarray, dict]:
    if len(data) < 32 or not accept_sun(data):
        raise NotThisFormat("not a SUN raster file")
    w, h, depth, _length, ftype, ptype, plen = struct.unpack_from(">7I", data, 4)
    if depth not in (1, 4, 8, 24, 32):
        raise NotThisFormat("SUN: unsupported depth")
    pos = 32
    palette = None
    if plen:
        if plen > 1024:
            raise NotThisFormat("SUN: unsupported palette length")
        if ptype != 1:
            raise NotThisFormat("SUN: unsupported palette type")
        p = np.frombuffer(data[pos:pos + plen], np.uint8)
        palette = p[:len(p) // 3 * 3].reshape(3, -1).T
        pos += plen
    if ftype not in (0, 1, 2, 3, 4, 5):
        raise NotThisFormat("SUN: unsupported file type")
    _checked(w, h, "SUN")
    if ftype == 2:
        row = (w * depth + 7) // 8
        rows = np.frombuffer(_sun_rle(data, pos, row * h), np.uint8).reshape(h, row)
    else:
        row = ((w * depth + 15) // 16) * 2
        rows = np.frombuffer(_take(data, pos, row * h, "SUN"), np.uint8).reshape(h, row)
    if depth == 1:
        return as_output("1", 1 - unpack_bits(rows, 1, w)), {}
    if depth in (4, 8):
        index = unpack_bits(rows, 4, w) if depth == 4 else rows[:, :w]
        if palette is not None:
            return from_palette(index, palette), {}
        return as_output("L", index * 17 if depth == 4 else index), {}
    a = rows[:, :w * depth // 8].reshape(h, w, depth // 8)
    a = a[:, :, :3] if ftype == 3 else a[:, :, 2::-1]     # RGB(X), else BGR(X)
    return np.ascontiguousarray(a), {}


# --------------------------------------------------------------------------
# MSP
# --------------------------------------------------------------------------

def accept_msp(prefix: bytes) -> bool:
    return prefix.startswith((b"DanM", b"LinS"))


def decode_msp(data: bytes) -> tuple[np.ndarray, dict]:
    if len(data) < 32 or not accept_msp(data):
        raise NotThisFormat("not an MSP file")
    words = struct.unpack_from("<16H", data)
    check = 0
    for v in words:
        check ^= v
    if check:
        raise NotThisFormat("bad MSP checksum")
    w, h = words[2], words[3]
    _checked(w, h, "MSP")
    row = (w + 7) // 8
    if data.startswith(b"DanM"):
        rows = np.frombuffer(_take(data, 32, row * h, "MSP"), np.uint8).reshape(h, row)
        return as_output("1", unpack_bits(rows, 1, w)), {}
    try:
        rowmap = struct.unpack_from(f"<{h}H", data, 32)
    except struct.error as e:
        raise ValueError("truncated MSP file in row map") from e
    out = bytearray()
    pos = 32 + 2 * h
    for y, rowlen in enumerate(rowmap):
        if rowlen == 0:
            out += b"\xff" * row
            continue
        line = data[pos:pos + rowlen]
        pos += rowlen
        if len(line) != rowlen:
            raise ValueError(f"truncated MSP file, expected {rowlen} bytes on row {y}")
        i = 0
        while i < rowlen:
            kind = line[i]
            i += 1
            if kind == 0:
                if i + 2 > rowlen:
                    raise ValueError(f"corrupted MSP file in row {y}")
                out += line[i + 1:i + 2] * line[i]
                i += 2
            else:
                out += line[i:i + kind]
                i += kind
    need = row * h
    if len(out) < need:
        raise ValueError("MSP: not enough image data")
    rows = np.frombuffer(bytes(out[:need]), np.uint8).reshape(h, row)
    return as_output("1", unpack_bits(rows, 1, w)), {}


# --------------------------------------------------------------------------
# XBM and XPM
# --------------------------------------------------------------------------

_XBM_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    rb"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    rb"(?P<hotspot>"
    rb"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    rb"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    rb")?"
    rb"[\000-\377]*_bits\[]")
_HEX = re.compile(rb"0[xX]([0-9a-fA-F]{1,2})")


def accept_xbm(prefix: bytes) -> bool:
    return prefix.lstrip().startswith(b"#define")


def decode_xbm(data: bytes) -> tuple[np.ndarray, dict]:
    m = _XBM_HEAD.match(data[:512])
    if not m:
        raise NotThisFormat("not a XBM file")
    w, h = int(m.group("width")), int(m.group("height"))
    _checked(w, h, "XBM")
    info = {}
    if m.group("hotspot"):
        info["hotspot"] = (int(m.group("xhot")), int(m.group("yhot")))
    row = (w + 7) // 8
    values = [int(v, 16) for v in _HEX.findall(data, m.end())][:row * h]
    if len(values) < row * h:
        raise ValueError("XBM: not enough image data")
    rows = np.array(values, np.uint8).reshape(h, row)
    bits = np.unpackbits(rows, axis=1, bitorder="little")[:, :w]
    return as_output("1", bits), info


def accept_xpm(prefix: bytes) -> bool:
    return prefix.startswith(b"/* XPM */")


_XPM_HEAD = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


def decode_xpm(data: bytes) -> tuple[np.ndarray, dict]:
    if not accept_xpm(data):
        raise NotThisFormat("not an XPM file")
    lines = data[9:].splitlines(keepends=True)
    i = 0
    while True:
        if i >= len(lines):
            raise NotThisFormat("broken XPM file")
        m = _XPM_HEAD.match(lines[i])
        i += 1
        if m:
            break
    w, h, ncolors, bpp = (int(g) for g in m.groups())
    info: dict = {}
    palette: dict = {}
    for _ in range(ncolors):
        line = lines[i].rstrip() if i < len(lines) else b""
        i += 1
        c = line[1:bpp + 1]
        s = line[bpp + 1:-2].split()
        for j in range(0, len(s), 2):
            if s[j] == b"c":
                rgb = s[j + 1]
                if rgb == b"None":
                    info["transparency"] = c
                elif rgb.startswith(b"#"):
                    v = int(rgb[1:], 16)
                    palette[c] = ((v >> 16) & 255, (v >> 8) & 255, v & 255)
                else:
                    raise ValueError("cannot read this XPM file")
                break
        else:
            raise ValueError("cannot read this XPM file")
    _checked(w, h, "XPM")
    keys = list(palette)
    index = {key: n for n, key in enumerate(keys)}
    lookup = palette if ncolors > 256 else index
    out = []
    seen_header = False
    for line in lines[i:]:
        if len(out) >= w * h:
            break
        if line.rstrip() == b"/* pixels */" and not seen_header:
            seen_header = True
            continue
        body = b'"'.join(line.split(b'"')[1:-1])
        try:
            out += [lookup[body[k:k + bpp]] for k in range(0, len(body), bpp)]
        except KeyError as e:
            raise ValueError(f"XPM: {e.args[0]!r} is not in the palette") from e
    if len(out) < w * h:
        raise ValueError("XPM: not enough image data")
    if ncolors > 256:
        return np.array(out[:w * h], np.uint8).reshape(h, w, 3), info
    pal = np.array([palette[k] for k in keys] or [(0, 0, 0)], np.uint8)
    return from_palette(np.array(out[:w * h], np.uint8).reshape(h, w), pal), info


# --------------------------------------------------------------------------
# PIXAR, SPIDER, GBR, XV thumbnails
# --------------------------------------------------------------------------

def accept_pixar(prefix: bytes) -> bool:
    return prefix.startswith(b"\x80\xe8\x00\x00")


def decode_pixar(data: bytes) -> tuple[np.ndarray, dict]:
    if len(data) < 512 or not accept_pixar(data):
        raise NotThisFormat("not a PIXAR file")
    h, w = struct.unpack_from("<HH", data, 416)
    if struct.unpack_from("<HH", data, 424) != (14, 2):
        raise NotThisFormat("PIXAR: not an RGB image")
    _checked(w, h, "PIXAR")
    raw = _take(data, 1024, w * h * 3, "PIXAR")
    return np.frombuffer(raw, np.uint8).reshape(h, w, 3).copy(), {}


_SPIDER_IFORMS = (1, 3, -11, -12, -21, -22)


def _spider_header(t: tuple) -> int:
    h = (99,) + t
    for i in (1, 2, 5, 12, 13, 22, 23):
        try:
            if h[i] != int(h[i]):
                return 0
        except (ValueError, OverflowError):
            return 0
    if int(h[5]) not in _SPIDER_IFORMS:
        return 0
    labrec, labbyt, lenbyt = int(h[13]), int(h[22]), int(h[23])
    return labbyt if labbyt == labrec * lenbyt else 0


def decode_spider(data: bytes) -> tuple[np.ndarray, dict]:
    if len(data) < 108:
        raise NotThisFormat("not a valid Spider file")
    order = ">"
    t = struct.unpack_from(">27f", data)
    hdrlen = _spider_header(t)
    if not hdrlen:
        order = "<"
        t = struct.unpack_from("<27f", data)
        hdrlen = _spider_header(t)
    if not hdrlen:
        raise NotThisFormat("not a valid Spider file")
    h = (99,) + t
    if int(h[5]) != 1:
        raise NotThisFormat("not a Spider 2D image")
    width, height = int(h[12]), int(h[2])
    istack, imgnumber = int(h[24]), int(h[27])
    if istack == 0 and imgnumber == 0:
        offset = hdrlen
    elif istack > 0 and imgnumber == 0:
        offset = hdrlen * 2
    else:                 # Pillow's reader fails on these headers (an AttributeError)
        raise ValueError("SPIDER: a stack image header Pillow cannot open")
    _checked(width, height, "SPIDER")
    raw = _take(data, offset, width * height * 4, "SPIDER")
    return as_output("F", np.frombuffer(raw, order + "f4").reshape(height, width)), {}


def accept_gbr(prefix: bytes) -> bool:
    return (len(prefix) >= 8 and struct.unpack_from(">I", prefix)[0] >= 20
            and struct.unpack_from(">I", prefix, 4)[0] in (1, 2))


def decode_gbr(data: bytes) -> tuple[np.ndarray, dict]:
    if len(data) < 20:
        raise NotThisFormat("not a GIMP brush")
    size, version, w, h, depth = struct.unpack_from(">5I", data)
    if size < 20:
        raise NotThisFormat("not a GIMP brush")
    if version not in (1, 2):
        raise NotThisFormat(f"unsupported GIMP brush version: {version}")
    if w == 0 or h == 0:
        raise NotThisFormat("not a GIMP brush")
    if depth not in (1, 4):
        raise NotThisFormat(f"unsupported GIMP brush color depth: {depth}")
    info: dict = {}
    pos = 20
    if version == 1:
        comment = size - 20
    else:
        comment = size - 28
        if data[pos:pos + 4] != b"GIMP":
            raise NotThisFormat("not a GIMP brush, bad magic number")
        (info["spacing"],) = struct.unpack_from(">I", data, pos + 4)
        pos += 8
    info["comment"] = data[pos:pos + comment][:-1]
    pos += comment
    _checked(w, h, "GBR")
    raw = np.frombuffer(_take(data, pos, w * h * depth, "GBR"), np.uint8)
    return raw.reshape(h, w, depth).copy(), info


#: the XV thumbnail's 3-3-2 palette
_XV_PALETTE = np.array([((r * 255) // 7, (g * 255) // 7, (b * 255) // 3)
                        for r in range(8) for g in range(8) for b in range(4)], np.uint8)


def accept_xvthumb(prefix: bytes) -> bool:
    return prefix.startswith(b"P7 332")


def decode_xvthumb(data: bytes) -> tuple[np.ndarray, dict]:
    if not accept_xvthumb(data):
        raise NotThisFormat("not an XV thumbnail file")
    pos = data.find(b"\n", 6)
    pos = len(data) if pos < 0 else pos + 1
    while True:
        end = data.find(b"\n", pos)
        line = data[pos:] if end < 0 else data[pos:end + 1]
        pos = len(data) if end < 0 else end + 1
        if not line:
            raise NotThisFormat("unexpected end of an XV thumbnail file")
        if line[0] != 35:
            break
    parts = line.strip().split(maxsplit=2)
    if len(parts) < 2:
        raise ValueError("XV thumbnail without its size")
    w, h = int(parts[0]), int(parts[1])
    _checked(w, h, "XVThumb")
    index = np.frombuffer(_take(data, pos, w * h, "XVThumb"), np.uint8).reshape(h, w)
    return from_palette(index, _XV_PALETTE), {}


# --------------------------------------------------------------------------
# FITS, McIdas, IPTC
# --------------------------------------------------------------------------

def accept_fits(prefix: bytes) -> bool:
    return prefix.startswith(b"SIMPLE")


def decode_fits(data: bytes) -> tuple[np.ndarray, dict]:
    headers: dict = {}
    pos = 0
    in_header = False
    found = None
    while True:
        card = data[pos:pos + 80]
        pos += len(card)
        if not card:
            raise ValueError("truncated FITS file")
        keyword = card[:8].strip()
        if keyword in (b"SIMPLE", b"XTENSION"):
            in_header = True
        elif headers and not in_header:
            break
        elif keyword == b"END":
            pos = -(-pos // 2880) * 2880
            if found is None:
                found = _fits_layout(headers)
            in_header = False
            continue
        if found is not None:
            continue
        value = card[8:].split(b"/")[0].strip()
        if value.startswith(b"="):
            value = value[1:].strip()
        if not headers and (not accept_fits(keyword) or value != b"T"):
            raise NotThisFormat("not a FITS file")
        headers[keyword] = value
    if found is None or found[0] is None:
        raise ValueError("FITS file with no image data")
    (w, h), bits = found
    data_at = pos - 80        # Pillow's: 80 back from where its read of a card ended
    mode, dtype = {8: ("L", "u1"), 16: ("I;16", "<u2"), 32: ("I", "<i4"),
                   -32: ("F", "<f4"), -64: ("F", "<f4")}.get(bits, (None, None))
    if mode is None:
        raise NotThisFormat(f"FITS with BITPIX {bits}")
    _checked(w, h, "FITS")
    size = np.dtype(dtype).itemsize
    raw = _take(data, data_at, w * h * size, "FITS")
    return as_output(mode, np.frombuffer(raw, dtype).reshape(h, w)[::-1]), {}


def _fits_layout(headers: dict):
    if headers.get(b"XTENSION") == b"'BINTABLE'" and headers.get(b"ZIMAGE") == b"T":
        from sdwebui_tpu_torch.utils.image_io import UnsupportedImageFormat

        raise UnsupportedImageFormat("FITS tile-compressed (GZIP_1) image")
    naxis = int(headers[b"NAXIS"])
    if naxis == 0:
        return None, 0
    size = (1, int(headers[b"NAXIS1"])) if naxis == 1 else \
        (int(headers[b"NAXIS1"]), int(headers[b"NAXIS2"]))
    return size, int(headers[b"BITPIX"])


def accept_mcidas(prefix: bytes) -> bool:
    return prefix.startswith(b"\x00\x00\x00\x00\x00\x00\x00\x04")


def decode_mcidas(data: bytes) -> tuple[np.ndarray, dict]:
    if len(data) < 256 or not accept_mcidas(data):
        raise NotThisFormat("not an McIdas area file")
    w = (0,) + struct.unpack_from(">64i", data)
    dtype = {1: "u1", 2: ">u2", 4: ">i4"}.get(w[11])
    if dtype is None:
        raise NotThisFormat("unsupported McIdas format")
    width, height = w[10], w[9]
    _checked(width, height, "McIdas")
    offset = w[34] + w[15]
    stride = w[15] + w[10] * w[11] * w[14]
    size = np.dtype(dtype).itemsize
    rows = [np.frombuffer(_take(data, offset + y * stride, width * size, "McIdas"), dtype)
            for y in range(height)]
    return as_output("L" if w[11] == 1 else "I", np.stack(rows)), {}


def _iptc_field(data: bytes, pos: int):
    s = data[pos:pos + 5]
    pos += 5
    if not s.strip(b"\x00"):
        return None, 0, pos
    if len(s) < 5:
        raise NotThisFormat("truncated IPTC/NAA field")
    tag = (s[1], s[2])
    if s[0] != 0x1C or tag[0] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
        raise NotThisFormat("invalid IPTC/NAA file")
    size = s[3]
    if size > 132:
        raise ValueError("illegal field length in IPTC/NAA file")
    if size == 128:
        size = 0
    elif size > 128:
        size = int.from_bytes(data[pos:pos + size - 128], "big")
        pos += s[3] - 128
    else:
        (size,) = struct.unpack_from(">H", s, 3)
    return tag, size, pos


def decode_iptc(data: bytes) -> tuple[np.ndarray, dict]:
    info: dict = {}
    pos = 0
    while True:
        offset = pos
        tag, size, pos = _iptc_field(data, pos)
        if not tag or tag == (8, 10):
            break
        info[tag] = data[pos:pos + size] if size else None
        pos += size
    try:
        layers, component = info[(3, 60)][0], info[(3, 60)][1]
        w = int.from_bytes(info[(3, 20)], "big")
        h = int.from_bytes(info[(3, 30)], "big")
        compression = int.from_bytes(info[(3, 120)], "big")
    except (KeyError, IndexError, TypeError) as e:
        raise NotThisFormat("IPTC/NAA without an image") from e
    if layers == 1 and not component:
        bands = 1
    elif layers in (3, 4) and component:
        bands = layers
    else:
        raise NotThisFormat("IPTC/NAA of no mode Pillow knows")
    if compression not in (1, 5):
        raise ValueError(f"unknown IPTC/NAA image compression {compression}")
    _checked(w, h, "IPTC")
    if tag != (8, 10):
        raise NotThisFormat("IPTC/NAA without image data")
    out = bytearray()
    pos = offset
    while True:
        tag, size, pos = _iptc_field(data, pos)
        if tag != (8, 10):
            break
        out += data[pos:pos + size]
        pos += size
    if compression == 5:
        from sdwebui_tpu_torch.utils.jpeg import decode_jpeg

        grey = decode_jpeg(bytes(out))[0]
        if grey.shape[2] != 1:       # Pillow's band is one grey layer
            raise ValueError("an IPTC/NAA JPEG band that is not grey")
        grey = grey[:h, :w]
    else:
        grey = np.frombuffer(_take(bytes(out), 0, w * h, "IPTC"), np.uint8).reshape(h, w, 1)
    if bands == 1:
        return grey.copy(), {}
    # one band of an RGB or CMYK image, the others 0 (Pillow's merge)
    band = info[(3, 65)][0] - 1 if (3, 65) in info and info[(3, 65)] else 0
    planes = np.zeros((grey.shape[0], grey.shape[1], bands), np.uint8)
    planes[:, :, band] = grey[:, :, 0]
    return (planes if bands == 3 else cmyk_to_rgb(planes)), {}
