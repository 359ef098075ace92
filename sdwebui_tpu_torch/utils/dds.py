"""DirectDraw Surface (DDS) reading and writing, and FTEX and BLP reading,
as Pillow's ``DdsImagePlugin``, ``FtexImagePlugin`` and
``BlpImagePlugin`` do.

DDS: the 124-byte header, then the first surface: uncompressed pixels by
their bit masks (Pillow's ``dds_rgb``: each field scaled as
``int(value / max · 255)``), 8-bit luminance, 16-bit luminance + alpha,
8-bit palette (its RGBA table), the DXT1/3/5, BC4 (ATI1), BC5 (ATI2, BC5S)
FourCCs and the DX10 header's BC1-BC7 and R8G8B8A8 formats
(``utils/bcn``).  What Pillow raises on (another FourCC or DXGI format)
raises ``UnsupportedImageFormat`` naming it.  The writer gives Pillow's
uncompressed bytes for grey, grey + alpha, RGB and RGBA images.

FTEX: the first mipmap, DXT1 (BC1) or raw RGB.  BLP: BLP1 with its JPEG
(the JPEG's RGB read as BGR, as Pillow's decoder hands it on) or palette,
BLP2 with a palette or DXT1/3/5 blocks (Pillow's own Python DXT decoders,
which expand 5-6-5 colours by shifts, not bit replication)."""

from __future__ import annotations

import struct

import numpy as np

from sdwebui_tpu_torch.utils import bcn
from sdwebui_tpu_torch.utils.image_modes import NotThisFormat, from_palette
from sdwebui_tpu_torch.utils.png import check_image_size

_DDPF_ALPHAPIXELS, _DDPF_FOURCC, _DDPF_PAL8 = 0x1, 0x4, 0x20
_DDPF_RGB, _DDPF_LUMINANCE = 0x40, 0x20000
#: FourCC → (BCn number, signed)
_FOURCC = {b"DXT1": (1, False), b"DXT3": (2, False), b"DXT5": (3, False),
           b"BC4U": (4, False), b"ATI1": (4, False), b"BC5S": (5, True),
           b"BC5U": (5, False), b"ATI2": (5, False)}
#: DXGI format → (BCn number, signed), 0 for R8G8B8A8
_DXGI = {70: (1, False), 71: (1, False), 73: (2, False), 74: (2, False), 76: (3, False),
         77: (3, False), 79: (4, False), 80: (4, False), 82: (5, False), 83: (5, False),
         84: (5, True), 95: (6, False), 96: (6, True), 97: (7, False), 98: (7, False),
         99: (7, False), 27: (0, False), 28: (0, False), 29: (0, False)}


def accept(prefix: bytes) -> bool:
    return prefix.startswith(b"DDS ")


def _unsupported(what: str):
    from sdwebui_tpu_torch.utils.image_io import UnsupportedImageFormat

    return UnsupportedImageFormat(what)


def _masked(data: bytes, pos: int, w: int, h: int, bitcount: int, masks) -> np.ndarray:
    """Pillow's ``DdsRgbDecoder``."""
    nbytes = bitcount // 8
    need = w * h * nbytes
    raw = np.frombuffer(data[pos:pos + need].ljust(need, b"\0"), np.uint8).reshape(-1, nbytes)
    value = (raw.astype(np.uint64) << (8 * np.arange(nbytes, dtype=np.uint64))).sum(axis=1)
    out = []
    for mask in masks:
        if not mask:
            out.append(np.zeros(len(value), np.uint8))
            continue
        shift = (mask & -mask).bit_length() - 1
        top = mask >> shift
        v = (value & np.uint64(mask)) >> np.uint64(shift)
        out.append((v.astype(np.float64) / top * 255).astype(np.uint8))
    return np.stack(out, axis=1).reshape(h, w, len(masks))


def decode_dds(data: bytes) -> tuple[np.ndarray, dict]:
    """DDS bytes → (uint8 (H, W, C), info)."""
    if not accept(data):
        raise NotThisFormat("not a DDS file")
    if len(data) < 128 or struct.unpack_from("<I", data, 4)[0] != 124:
        raise ValueError("DDS: unsupported or incomplete header")
    _flags, h, w = struct.unpack_from("<3I", data, 8)
    pfflags, fourcc, bitcount = struct.unpack_from("<I4sI", data, 80)
    check_image_size(w, h)
    if w <= 0 or h <= 0:
        raise NotThisFormat("DDS of no pixels")
    info: dict = {}
    pos = 128
    if pfflags & _DDPF_RGB:
        count = 4 if pfflags & _DDPF_ALPHAPIXELS else 3
        masks = struct.unpack_from(f"<{count}I", data, 92)
        return _masked(data, pos, w, h, bitcount, masks), info
    if pfflags & _DDPF_LUMINANCE:
        if bitcount == 8:
            c = 1
        elif bitcount == 16 and pfflags & _DDPF_ALPHAPIXELS:
            c = 2
        else:
            raise ValueError(f"DDS: unsupported bitcount {bitcount} for flags {pfflags}")
        raw = data[pos:pos + w * h * c]
        if len(raw) < w * h * c:
            raise ValueError("DDS: image file is truncated")
        return np.frombuffer(raw, np.uint8).reshape(h, w, c).copy(), info
    if pfflags & _DDPF_PAL8:
        palette = np.frombuffer(data[pos:pos + 1024].ljust(1024, b"\0"), np.uint8).reshape(256, 4)
        pos += 1024
        raw = data[pos:pos + w * h]
        if len(raw) < w * h:
            raise ValueError("DDS: image file is truncated")
        return from_palette(np.frombuffer(raw, np.uint8).reshape(h, w), palette), info
    if not pfflags & _DDPF_FOURCC:
        raise _unsupported(f"DDS with pixel format flags {pfflags}")
    if fourcc == b"DX10":
        (dxgi,) = struct.unpack_from("<I", data, 128)
        pos += 20
        if dxgi not in _DXGI:
            raise _unsupported(f"DDS of DXGI format {dxgi}")
        n, signed = _DXGI[dxgi]
        if dxgi in (29, 99):
            info["gamma"] = 1 / 2.2
        if n == 0:
            raw = data[pos:pos + w * h * 4]
            if len(raw) < w * h * 4:
                raise ValueError("DDS: image file is truncated")
            return np.frombuffer(raw, np.uint8).reshape(h, w, 4).copy(), info
    elif fourcc in _FOURCC:
        n, signed = _FOURCC[fourcc]
    else:
        raise _unsupported(f"DDS of pixel format {fourcc!r}")
    rgba = bcn.decode(data[pos:], n, w, h, signed)
    if n == 4:
        return rgba[:, :, :1].copy(), info
    if n in (5, 6):
        return rgba[:, :, :3].copy(), info
    return rgba, info


def encode_dds(image: np.ndarray) -> bytes:
    """uint8 (H, W, 1|2|3|4) → Pillow's uncompressed DDS bytes."""
    a = np.asarray(image)
    if a.ndim == 2:
        a = a[:, :, None]
    h, w, c = a.shape
    bitcount = 8 * c
    flags = 0x1 | 0x2 | 0x4 | 0x1000 | 0x8
    pitch = (w * bitcount + 7) // 8
    alpha = c in (2, 4)
    if c <= 2:
        pf = _DDPF_LUMINANCE
        masks = [0xFF] * 3 if alpha else [0xFF000000] * 3
        body = a
    else:
        pf = _DDPF_RGB
        masks = [0xFF0000, 0xFF00, 0xFF]
        body = a[:, :, [2, 1, 0]] if c == 3 else a[:, :, [2, 1, 0, 3]]
    if alpha:
        pf |= _DDPF_ALPHAPIXELS
    masks.append(0xFF000000 if alpha else 0)
    head = (b"DDS " + struct.pack("<7I", 124, flags, h, w, pitch, 0, 0)
            + struct.pack("11I", *((0,) * 11)) + struct.pack("<4I", 32, pf, 0, bitcount)
            + struct.pack("<4I", *masks) + struct.pack("<5I", 0x1000, 0, 0, 0, 0))
    return head + np.ascontiguousarray(body).tobytes()


# --------------------------------------------------------------------------
# FTEX
# --------------------------------------------------------------------------

def accept_ftex(prefix: bytes) -> bool:
    return prefix.startswith(b"FTEX")


def decode_ftex(data: bytes) -> tuple[np.ndarray, dict]:
    if not accept_ftex(data) or len(data) < 32:
        raise NotThisFormat("not an FTEX file")
    w, h = struct.unpack_from("<2i", data, 8)
    _mipmaps, count = struct.unpack_from("<2i", data, 16)
    if count != 1:
        raise ValueError("FTEX with more than one format")
    fmt, where = struct.unpack_from("<2i", data, 24)
    (size,) = struct.unpack_from("<i", data, where)
    body = data[where + 4:where + 4 + size]
    check_image_size(w, h)
    if w <= 0 or h <= 0:
        raise NotThisFormat("FTEX of no pixels")
    if fmt == 0:
        return bcn.decode(body, 1, w, h), {}
    if fmt == 1:
        if len(body) < w * h * 3:
            raise ValueError("FTEX: image file is truncated")
        return np.frombuffer(body, np.uint8, w * h * 3).reshape(h, w, 3).copy(), {}
    raise ValueError(f"invalid FTEX texture compression format: {fmt}")


# --------------------------------------------------------------------------
# BLP
# --------------------------------------------------------------------------

def accept_blp(prefix: bytes) -> bool:
    return prefix.startswith((b"BLP1", b"BLP2"))


def _shift565(c: np.ndarray) -> np.ndarray:
    c = c.astype(np.int32)
    return np.stack([((c >> 11) & 0x1F) << 3, ((c >> 5) & 0x3F) << 2, (c & 0x1F) << 3], -1)


def _blp_dxt(body: bytes, w: int, h: int, kind: int, alpha: bool) -> np.ndarray:
    """Pillow's BLP ``decode_dxt1`` / ``decode_dxt3`` / ``decode_dxt5``."""
    size = 8 if kind == 0 else 16
    bw, bh = (w + 3) // 4, (h + 3) // 4
    need = bw * bh * size
    if len(body) < need:
        raise ValueError("BLP: truncated DXT data")
    blocks = np.frombuffer(body, np.uint8, need).reshape(-1, size)
    colour = blocks[:, -8:]
    c0 = colour[:, 0].astype(np.int32) | (colour[:, 1].astype(np.int32) << 8)
    c1 = colour[:, 2].astype(np.int32) | (colour[:, 3].astype(np.int32) << 8)
    code = colour[:, 4:8].astype(np.int64) @ (1 << (8 * np.arange(4, dtype=np.int64)))
    p0, p1 = _shift565(c0), _shift565(c1)
    thirds = (c0 > c1) if kind == 0 else np.ones(len(blocks), bool)
    pal = np.zeros((len(blocks), 4, 4), np.int32)
    pal[:, 0, :3], pal[:, 1, :3] = p0, p1
    pal[:, 2, :3] = np.where(thirds[:, None], (2 * p0 + p1) // 3, (p0 + p1) // 2)
    pal[:, 3, :3] = np.where(thirds[:, None], (2 * p1 + p0) // 3, 0)
    pal[:, :, 3] = 255
    pal[:, 3, 3] = np.where(thirds, 255, 0)
    idx = (code[:, None] >> (2 * np.arange(16))) & 3
    px = np.take_along_axis(pal, idx[:, :, None].astype(np.intp), axis=1)
    if kind == 1:
        nib = np.stack([blocks[:, :8] & 15, blocks[:, :8] >> 4], axis=2).reshape(-1, 16)
        px[:, :, 3] = nib * 17
    elif kind == 7:
        a0, a1 = blocks[:, 0].astype(np.int32), blocks[:, 1].astype(np.int32)
        bits = blocks[:, 2:8].astype(np.int64) @ (1 << (8 * np.arange(6, dtype=np.int64)))
        code_a = (bits[:, None] >> (3 * np.arange(16))) & 7
        k = code_a.astype(np.int32)
        wide = (a0 > a1)[:, None]
        a0b, a1b = a0[:, None], a1[:, None]
        seven = ((8 - k) * a0b + (k - 1) * a1b) // 7
        five = ((6 - k) * a0b + (k - 1) * a1b) // 5
        a = np.where(wide, seven, np.where(k == 6, 0, np.where(k == 7, 255, five)))
        a = np.where(k == 0, a0b, np.where(k == 1, a1b, a))
        px[:, :, 3] = a
    grid = px.reshape(bh, bw, 4, 4, 4).transpose(0, 2, 1, 3, 4).reshape(bh * 4, bw * 4, 4)
    out = grid[:h, :w].astype(np.uint8)
    return np.ascontiguousarray(out if alpha else out[:, :, :3])


def decode_blp(data: bytes) -> tuple[np.ndarray, dict]:
    """BLP bytes → (uint8 (H, W, 3|4), {})."""
    if not accept_blp(data) or len(data) < 20:
        raise ValueError("bad BLP magic")
    blp1 = data.startswith(b"BLP1")
    (compression,) = struct.unpack_from("<i", data, 4)
    if blp1:
        alpha = struct.unpack_from("<I", data, 8)[0] != 0
        w, h = struct.unpack_from("<II", data, 12)
        (encoding,) = struct.unpack_from("<i", data, 20)
        pos = 28
    else:
        encoding, alpha_depth, alpha_encoding = struct.unpack_from("<bbb", data, 8)
        alpha = alpha_depth != 0
        w, h = struct.unpack_from("<II", data, 12)
        pos = 20
    check_image_size(w, h)
    if w <= 0 or h <= 0:
        raise NotThisFormat("BLP of no pixels")
    try:
        offsets = struct.unpack_from("<16I", data, pos)
        lengths = struct.unpack_from("<16I", data, pos + 64)
    except struct.error as e:
        raise ValueError("truncated BLP file") from e
    pos += 128
    channels = 4 if alpha else 3

    def palette_at(at: int) -> np.ndarray:
        raw = data[at:at + 1024]
        bgra = np.frombuffer(raw[:len(raw) // 4 * 4], np.uint8).reshape(-1, 4)
        return np.concatenate([bgra[:, 2::-1], bgra[:, 3:]], axis=1)

    def indexed(pal: np.ndarray, at: int) -> np.ndarray:
        index = np.frombuffer(data[at:at + lengths[0]], np.uint8)
        if len(index) < w * h:
            raise ValueError("BLP: not enough image data")
        if index.max(initial=0) >= len(pal):
            raise ValueError("BLP: palette index out of range")
        return np.ascontiguousarray(pal[index[:w * h]][:, :channels].reshape(h, w, channels))

    if blp1:
        if compression == 0:
            from sdwebui_tpu_torch.utils.jpeg import decode_jpeg
            from sdwebui_tpu_torch.utils.images import to_rgb

            (head_size,) = struct.unpack_from("<I", data, pos)
            head = data[pos + 4:pos + 4 + head_size]
            jpeg = head + data[offsets[0]:offsets[0] + lengths[0]]
            rgb = to_rgb(decode_jpeg(jpeg)[0])[:, :, ::-1]        # Pillow's raw "BGR"
            if alpha:
                rgb = np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)], 2)
            return np.ascontiguousarray(rgb), {}
        if compression == 1 and encoding in (4, 5):       # the indices follow the palette
            return indexed(palette_at(pos), pos + 1024), {}
        raise _unsupported(f"BLP1 compression {compression}, encoding {encoding}")
    pal = palette_at(pos)
    if compression != 1:
        raise _unsupported(f"BLP2 compression {compression}")
    if encoding == 1:
        return indexed(pal, offsets[0]), {}
    if encoding == 2 and alpha_encoding in (0, 1, 7):
        return _blp_dxt(data[offsets[0]:], w, h, alpha_encoding, alpha), {}
    raise _unsupported(f"BLP2 encoding {encoding}, alpha encoding {alpha_encoding}")
