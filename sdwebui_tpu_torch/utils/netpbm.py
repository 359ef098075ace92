"""Netpbm reading and writing on numpy, as Pillow's ``PpmImagePlugin``
does.

The reader takes what Pillow opens: P1-P3 (plain, with comments between
samples), P4-P6 (binary) at any maxval below 65536 (a maxval other than
255 is rescaled as Pillow's ``ppm`` decoder rounds it; 16-bit grey is
Pillow's "I", clipped when converted), and PFM greyscale (``Pf``, bottom-up,
the scale's sign giving the byte order; Pillow's "F").  Pillow reads no PAM
(``P7``) and no colour PFM (``PF``): those bytes fall through to the other
plugins, as they do in Pillow.

The writer gives Pillow's bytes: ``P6`` for RGB and RGBA (alpha dropped),
``P5`` for grey, whatever the extension (.ppm, .pgm, .pbm, .pnm, .pfm):
Pillow picks the subtype by the image's mode."""

from __future__ import annotations

import numpy as np

from sdwebui_tpu_torch.utils.image_modes import NotThisFormat, as_output
from sdwebui_tpu_torch.utils.png import check_image_size, unpack_bits

_WHITESPACE = b"\x20\x09\x0a\x0b\x0c\x0d"
#: Pillow's magic numbers → modes
MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB",
         b"P0CMYK": "CMYK", b"Pf": "F", b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}


def accept(prefix: bytes) -> bool:
    return len(prefix) >= 2 and prefix[:1] == b"P" and prefix[1] in b"0123456fy"


def _magic(data: bytes) -> tuple[bytes, int]:
    magic, pos = b"", 0
    for _ in range(6):
        c = data[pos:pos + 1]
        pos += 1
        if not c or c in _WHITESPACE:
            break
        magic += c
    return magic, pos


def _token(data: bytes, pos: int) -> tuple[bytes, int]:
    """Pillow's ``_read_token``: the next token of at most 10 bytes, with
    whitespace and ``#`` comments skipped; pos is after its terminator."""
    token = b""
    n = len(data)
    while len(token) <= 10:
        if pos >= n:
            break
        c = data[pos:pos + 1]
        pos += 1
        if c in _WHITESPACE:
            if not token:
                continue
            break
        if c == b"#":
            while pos < n and data[pos:pos + 1] not in (b"\r", b"\n"):
                pos += 1
            pos += 1
            continue
        token += c
    if not token:
        raise ValueError("PPM: reached the end while reading the header")
    if len(token) > 10:
        raise ValueError("PPM: token too long in the header")
    return token, pos


def _strip_comments(body: bytes) -> bytes:
    out, pos = [], 0
    while True:
        at = body.find(b"#", pos)
        if at < 0:
            out.append(body[pos:])
            return b"".join(out)
        out.append(body[pos:at])
        ends = [e for e in (body.find(b"\n", at), body.find(b"\r", at)) if e >= 0]
        if not ends:
            return b"".join(out)
        pos = min(ends) + 1


def decode_netpbm(data: bytes) -> tuple[np.ndarray, dict]:
    """Netpbm bytes → (uint8 (H, W, C), info)."""
    magic, pos = _magic(data)
    if magic not in MODES:
        raise NotThisFormat("not a PPM file")
    mode = MODES[magic]
    t, pos = _token(data, pos)
    u, pos = _token(data, pos)
    w, h = int(t), int(u)
    check_image_size(w, h)
    info: dict = {}
    bands = {"1": 1, "L": 1, "RGB": 3, "CMYK": 4, "F": 1, "RGBA": 4}[mode]
    if mode == "F":
        t, pos = _token(data, pos)
        scale = float(t)
        if scale == 0.0 or not np.isfinite(scale):
            raise ValueError("PPM: scale must be finite and non-zero")
        info["scale"] = abs(scale)
        need = w * h * 4
        raw = data[pos:pos + need]
        if len(raw) < need:
            raise ValueError("PPM: image file is truncated")
        a = np.frombuffer(raw, "<f4" if scale < 0 else ">f4").reshape(h, w)[::-1]
        return as_output("F", a), info
    plain = magic in (b"P1", b"P2", b"P3")
    if mode == "1":
        if plain:
            body = bytes(b for b in _strip_comments(data[pos:]) if b not in _WHITESPACE)
            body = body[:w * h]
            if any(b not in (48, 49) for b in body):
                raise ValueError("PPM: invalid token for mode 1")
            bits = np.frombuffer(body.ljust(w * h, b"\0"), np.uint8)
            bits = np.where(bits == 48, 1, 0).astype(np.uint8)
            if len(body) < w * h:
                bits[len(body):] = 0
            return as_output("1", bits.reshape(h, w)), info
        row = (w + 7) // 8
        raw = data[pos:pos + row * h]
        if len(raw) < row * h:
            raise ValueError("PPM: image file is truncated")
        bits = unpack_bits(np.frombuffer(raw, np.uint8).reshape(h, row), 1, w)
        return as_output("1", 1 - bits), info
    t, pos = _token(data, pos)
    maxval = int(t)
    if not 0 < maxval < 65536:
        raise ValueError("PPM: maxval must be greater than 0 and less than 65536")
    out_max = 65535 if (mode == "L" and maxval > 255) else 255
    count = w * h * bands
    if plain:
        tokens = _strip_comments(data[pos:]).split()
        if any(len(tok) > 10 for tok in tokens[:count]):
            raise ValueError("PPM: token too long in the data")
        vals = np.array([int(tok) for tok in tokens[:count]], np.int64)
        if (vals < 0).any():
            raise ValueError("PPM: channel value is negative")
        if (vals > maxval).any():
            raise ValueError("PPM: channel value too large for this mode")
        if len(vals) < count:
            raise ValueError("PPM: not enough image data")
        v = np.round(vals / maxval * out_max)
    else:
        wide = maxval > 255
        need = count * (2 if wide else 1)
        raw = data[pos:pos + need]
        if maxval == 255 or (maxval == 65535 and mode == "L"):
            if len(raw) < need:
                raise ValueError("PPM: image file is truncated")
            v = np.frombuffer(raw, ">u2" if wide else np.uint8).astype(np.float64)
        else:
            if len(raw) < need:
                raise ValueError("PPM: not enough image data")
            got = np.frombuffer(raw, ">u2" if wide else np.uint8)
            v = np.minimum(out_max, np.round(got / maxval * out_max))
    a = v.reshape(h, w, bands)
    return as_output("I" if out_max == 65535 else mode, a), info


def encode_netpbm(image: np.ndarray) -> bytes:
    """uint8 (H, W, 1|3|4) → Pillow's bytes: P5 for grey, P6 for RGB and
    RGBA (its alpha dropped)."""
    a = np.asarray(image)
    if a.ndim == 2:
        a = a[:, :, None]
    h, w, c = a.shape
    if c == 1:
        return b"P5\n%d %d\n255\n" % (w, h) + a.tobytes()
    if c in (3, 4):
        return b"P6\n%d %d\n255\n" % (w, h) + np.ascontiguousarray(a[:, :, :3]).tobytes()
    raise OSError("cannot write mode LA as PPM")
