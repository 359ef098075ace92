"""TIFF reading and writing on numpy, as Pillow's ``TiffImagePlugin`` (with
libtiff for the compressed files) does.

The reader takes IFD0 of a little- or big-endian file (the IFD walker of
``utils/exif``): strips or tiles, chunky or planar samples, compression
none, PackBits, LZW (``utils/lzw``) or Deflate (8 and 32946), the last two with
the horizontal predictor (2), which libtiff ignores for the others; photometric 0 and 1
(1-, 2-, 4-, 8- and 16-bit grey, grey + alpha), 2 (8- and 16-bit RGB, with
an extra sample that is alpha, premultiplied alpha or unused) and 3
(1- to 8-bit palettes).  What it gives is what Pillow's ``convert`` sees of
the mode ``Image.open`` gives: grey (white-is-zero inverted, "1" as 0/255,
2- and 4-bit scaled, 16-bit "I;16" clipped at 255), LA, RGB (palettes
expanded, 16-bit samples by their high byte, an unused extra sample
dropped) or RGBA (premultiplied alpha divided out, as Pillow's "RGBa"
unpacker does).  Every other compression, photometric or layout raises
``ValueError`` naming itself.

The writer gives Pillow's own uncompressed bytes for L, RGB and RGBA
images (``image.save(f, "TIFF")``; the ``quality`` JAX passes is not read
by Pillow's TIFF writer): one strip, the tags Pillow writes, in its order.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from sdwebui_tpu_torch.utils import lzw
from sdwebui_tpu_torch.utils.exif import _TYPE_SIZES, _ifd_entries
from sdwebui_tpu_torch.utils.png import check_image_size, unpack_bits

#: Pillow's ``COMPRESSION_INFO`` names of the codes read here
COMPRESSIONS = {1: "raw", 5: "tiff_lzw", 8: "tiff_adobe_deflate", 32773: "packbits",
                32946: "tiff_deflate"}
_OTHER_COMPRESSIONS = {2: "CCITT", 3: "group3", 4: "group4", 6: "old-style JPEG", 7: "JPEG",
                       32771: "raw_16", 32809: "thunderscan", 34676: "sgilog",
                       34677: "sgilog24", 34925: "LZMA", 50000: "Zstandard", 50001: "WebP"}
_FORMATS = {1: "B", 2: "s", 3: "H", 4: "I", 5: "II", 6: "b", 7: "s", 8: "h", 9: "i", 10: "ii",
            11: "f", 12: "d", 16: "Q"}


def _values(entry, order: str):
    typ, raw = entry
    if typ in (2, 7):
        return raw
    size = _TYPE_SIZES.get(typ, 1)
    fmt = _FORMATS.get(typ, "B")
    vals = struct.unpack(order + fmt * (len(raw) // size), raw[:len(raw) // size * size])
    if typ in (5, 10):   # rationals
        return tuple(n / d if d else 0.0 for n, d in zip(vals[::2], vals[1::2]))
    return vals


def _packbits(data: bytes, limit: int) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n and len(out) < limit:
        c = data[i]
        i += 1
        if c < 128:
            out += data[i:i + c + 1]
            i += c + 1
        elif c > 128:
            if i < n:
                out += bytes([data[i]]) * (257 - c)
            i += 1
    return bytes(out)


def _inflate(data: bytes, code: int, limit: int) -> bytes:
    if code == 1:
        return data[:limit]
    if code == 32773:
        return _packbits(data, limit)
    if code == 5:
        return lzw.decode_tiff(data, limit)
    try:
        return zlib.decompressobj().decompress(data, limit)
    except zlib.error as e:
        raise ValueError(f"corrupt TIFF Deflate data: {e}") from e


def _chunk_samples(raw: bytes, rows: int, cols: int, spp: int, depth: int, order: str,
                   predictor: int) -> np.ndarray:
    """One decompressed strip or tile → (rows, cols, spp) samples."""
    if depth == 16:
        need = rows * cols * spp * 2
        a = np.frombuffer(raw[:need].ljust(need, b"\0"), order + "u2").astype(np.uint16)
        a = a.reshape(rows, cols, spp)
    else:
        row_bytes = (cols * spp * depth + 7) // 8
        need = rows * row_bytes
        packed = np.frombuffer(raw[:need].ljust(need, b"\0"), np.uint8).reshape(rows, row_bytes)
        a = unpack_bits(packed, depth, cols * spp).reshape(rows, cols, spp)
    if predictor == 2:
        a = np.cumsum(a, axis=1, dtype=a.dtype)
    return a


def decode_tiff(data: bytes) -> tuple[np.ndarray, dict]:
    """TIFF bytes → (uint8 (H, W, C), info): the first image, with Pillow's
    ``compression``, ``dpi`` and ``resolution`` in info."""
    if data[:4] not in (b"II*\x00", b"MM\x00*"):
        raise ValueError("not a TIFF file")
    order = "<" if data[:2] == b"II" else ">"
    try:
        (first,) = struct.unpack_from(order + "I", data, 4)
        tags = _ifd_entries(data, first, order)
    except struct.error as e:
        raise ValueError(f"truncated TIFF: {e}") from e

    def get(tag, default=None):
        return _values(tags[tag], order) if tag in tags else default

    try:
        width, height = get(256)[0], get(257)[0]
    except (TypeError, IndexError) as e:
        raise ValueError("TIFF without its dimensions") from e
    if width <= 0 or height <= 0:
        raise ValueError(f"TIFF of {width}×{height} pixels")
    check_image_size(width, height)
    code = get(259, (1,))[0]
    if code not in COMPRESSIONS:
        name = _OTHER_COMPRESSIONS.get(code, f"code {code}")
        raise ValueError(f"TIFF compression {name} is not read")
    photo = get(262, (0,))[0]
    spp = get(277, (1,))[0]
    bits = tuple(get(258, (1,)))
    extra = tuple(get(338, ()))
    if len(bits) == 1 and spp > 1:
        bits = bits * spp
    bits = bits[:spp]
    planar = get(284, (1,))[0]
    predictor = get(317, (1,))[0]
    if get(266, (1,))[0] != 1:
        raise ValueError("TIFF fill order 2 is not read")
    if tuple(get(339, (1,)))[:1] not in ((1,),):
        raise ValueError("TIFF sample format other than unsigned integers is not read")
    depth = bits[0]
    if len(set(bits)) != 1 or depth not in (1, 2, 4, 8, 16) or len(bits) != spp:
        raise ValueError(f"TIFF with {bits}-bit samples is not read")
    if code in (1, 32773):   # libtiff's predictor belongs to LZW and Deflate only
        predictor = 1
    if predictor not in (1, 2) or (predictor == 2 and depth not in (8, 16)):
        raise ValueError(f"TIFF predictor {predictor} with {depth}-bit samples is not read")
    kind = None
    if photo in (0, 1) and spp == 1:
        kind = "grey"
    elif photo == 1 and spp == 2 and depth == 8 and extra == (2,):
        kind = "LA"
    elif photo == 2 and spp == 3 and depth in (8, 16) and not extra:
        kind = "RGB"
    elif photo == 2 and spp == 4 and depth in (8, 16) and extra in ((), (0,), (1,), (2,)):
        kind = {(): "RGBA", (0,): "RGB", (1,): "RGBa", (2,): "RGBA"}[extra]
    elif photo == 3 and spp == 1 and depth <= 8 and 320 in tags:
        kind = "P"
    if kind is None:
        raise ValueError(f"TIFF layout not read: photometric {photo}, {bits}-bit samples, "
                         f"extra samples {extra}")

    # each strip or tile's box (y, x, rows, cols), by its number in a plane
    if 322 in tags:
        tw, th = (get(322) or (0,))[0], (get(323) or (0,))[0]
        if tw <= 0 or th <= 0:
            raise ValueError(f"TIFF tiles of {tw}×{th} pixels")
        offsets, counts = get(324), get(325)
        across = (width + tw - 1) // tw
        n = across * ((height + th - 1) // th)

        def box(i):
            ty, tx = divmod(i, across)
            return ty * th, tx * tw, th, tw
    else:
        rps = min(get(278, (height,))[0] or height, height)
        offsets, counts = get(273), get(279)
        n = (height + rps - 1) // rps

        def box(i):
            return i * rps, 0, min(rps, height - i * rps), width
    if offsets is None:
        raise ValueError("TIFF without strip or tile offsets")
    if counts is None:
        counts = [len(data) - o for o in offsets]
    planes = spp if planar == 2 else 1
    per = 1 if planar == 2 else spp
    if min(len(offsets), len(counts)) < n * planes:
        raise ValueError("TIFF with too few strips or tiles")
    dtype = np.uint16 if depth == 16 else np.uint8
    image = np.zeros((height, width, spp), dtype)
    for p in range(planes):
        for i in range(n):
            y, x, rows, cols = box(i)
            k = p * n + i
            row_bytes = (cols * per * depth + 7) // 8
            raw = _inflate(data[offsets[k]:offsets[k] + counts[k]], code, rows * row_bytes)
            block = _chunk_samples(raw, rows, cols, per, depth, order, predictor)
            block = block[:height - y, :width - x]
            image[y:y + block.shape[0], x:x + block.shape[1], p:p + per] = block

    info = {"compression": COMPRESSIONS[code]}
    xres, yres = get(282, (1,))[0], get(283, (1,))[0]
    if xres and yres:
        unit = get(296, (None,))[0]
        if unit == 2:
            info["dpi"] = (xres, yres)
        elif unit == 3:
            info["dpi"] = (xres * 2.54, yres * 2.54)
        elif unit is None:
            info["dpi"] = (xres, yres)
            info["resolution"] = (xres, yres)
        else:
            info["resolution"] = (xres, yres)

    if kind == "grey":
        if depth == 16:
            return np.minimum(image, 255).astype(np.uint8), info
        top = (1 << depth) - 1
        v = image if photo == 1 else top - image
        if depth == 1:
            return (v * np.uint8(255)).astype(np.uint8), info
        return (v * np.uint8(255 // top)).astype(np.uint8), info
    if kind == "P":
        cmap = np.asarray(get(320), np.uint32).reshape(3, -1).T // 256
        full = np.zeros((256, 3), np.uint8)
        full[:min(256, len(cmap))] = cmap[:256]
        return full[image[:, :, 0]], info
    if depth == 16:
        image = (image >> 8).astype(np.uint8)
    if kind == "LA":
        return image, info
    if kind == "RGB":
        return np.ascontiguousarray(image[:, :, :3]), info
    if kind == "RGBa":   # Pillow's unpackRGBa: c · 255 / a, clipped; a = 0 gives 0
        a = image[:, :, 3:4].astype(np.int32)
        rgb = np.where(a == 255, image[:, :, :3],
                       np.minimum(image[:, :, :3].astype(np.int32) * 255 // np.maximum(a, 1), 255))
        rgba = np.concatenate([np.where(a == 0, 0, rgb), a], axis=2).astype(np.uint8)
        return rgba, info
    return image, info


def encode_tiff(image: np.ndarray) -> bytes:
    """uint8 (H, W) / (H, W, 1) grey, (H, W, 3) RGB or (H, W, 4) RGBA →
    Pillow's uncompressed little-endian TIFF bytes."""
    a = np.asarray(image)
    if a.dtype != np.uint8:
        raise ValueError(f"expected uint8, got {a.dtype}")
    if a.ndim == 2:
        a = a[:, :, None]
    h, w, c = a.shape
    if c not in (1, 3, 4):
        raise ValueError(f"cannot write a {c}-channel image as TIFF")
    strip = a.tobytes()
    long_ = 4
    # (tag, type, values), in Pillow's order; 273 is filled in below
    tags = [(256, long_, [w]), (257, long_, [h]), (258, 3, [8] * c), (259, 3, [1]),
            (262, 3, [1 if c == 1 else 2]), (273, long_, [0])]
    if c == 4:
        tags.append((338, 3, [2]))
    if c > 1:
        tags.append((277, 3, [c]))
    tags += [(278, long_, [h]), (279, long_, [len(strip)]), (284, 3, [1])]
    tags.sort(key=lambda t: t[0])
    ifd_end = 8 + 2 + 12 * len(tags) + 4
    blobs = bytearray()
    for tag, typ, vals in tags:
        raw = struct.pack("<" + _FORMATS[typ] * len(vals), *vals)
        if len(raw) > 4:
            blobs += raw
    data_at = ifd_end + len(blobs)
    entries, blobs = bytearray(), bytearray()
    for tag, typ, vals in tags:
        if tag == 273:
            vals = [data_at]
        raw = struct.pack("<" + _FORMATS[typ] * len(vals), *vals)
        if len(raw) <= 4:
            entries += struct.pack("<HHI", tag, typ, len(vals)) + raw.ljust(4, b"\0")
        else:
            entries += struct.pack("<HHII", tag, typ, len(vals), ifd_end + len(blobs))
            blobs += raw
    return (b"II*\x00" + struct.pack("<IH", 8, len(tags)) + bytes(entries)
            + struct.pack("<I", 0) + bytes(blobs) + strip)
