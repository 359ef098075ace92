"""TIFF reading and writing on numpy, as Pillow's ``TiffImagePlugin`` (with
libtiff for the compressed files) does.

The reader takes IFD0 of a little- or big-endian file, classic (the IFD
walker of ``utils/exif``) or BigTIFF: strips or tiles, chunky or planar samples, either
``FillOrder`` (2 reverses each byte's bits before decoding, as libtiff
does), and the compressions none, PackBits, LZW (``utils/lzw``), Deflate (8
and 32946), LZMA (34925, the standard library's ``lzma``) and Zstandard
(50000, ``utils/zstd``) — those four with the horizontal predictor (2),
which libtiff ignores for the others —, JPEG (7, each strip or tile a
stream of ``utils/jpeg`` with the ``JPEGTables`` spliced in front; RGB
samples as they are, YCbCr converted as libjpeg does for libtiff's RGB
colour mode) and CCITT Modified Huffman (2), Group 3 (3, 1-D and 2-D) and
Group 4 (4) (``utils/ccitt``), and old-style JPEG (6) where each strip
holds a whole JPEG stream or the JPEG interchange format tags point at one
(libtiff's raw YCbCr planes, chroma repeated, converted as below).  WebP,
ThunderScan, SGILog and raw_16 raise ``UnsupportedImageFormat`` naming
themselves: libtiff on the JAX package's machine cannot decode them.

Layouts: photometric 0 and 1 (1-, 2-, 4-, 8- and 16-bit grey, grey +
alpha; signed 16- and 32-bit grey and 32-bit float grey, Pillow's "I" and
"F", clipped and truncated as ``convert`` does), 2 (8- and 16-bit RGB,
with an extra sample that is alpha, premultiplied alpha or unused), 3
(1- to 8-bit palettes), 5 (8-bit CMYK, converted as Pillow's ``cmyk2rgb``)
and 6 (YCbCr: through JPEG, or losslessly compressed with its chroma
subsampling, converted as libtiff's ``TIFFYCbCrtoRGB`` with the
``ReferenceBlackWhite`` and luma coefficients; uncompressed YCbCr raises, as
Pillow's raw "RGBX" reading of it does).  What it gives is what
Pillow's ``convert`` sees of the mode ``Image.open`` gives: grey
(white-is-zero inverted, "1" as 0/255, 2- and 4-bit scaled, 16-bit "I;16"
clipped at 255), LA, RGB (palettes expanded, 16-bit samples by their high
byte, an unused extra sample dropped) or RGBA (premultiplied alpha divided
out, as Pillow's "RGBa" unpacker does).  Every other layout raises
``ValueError`` naming itself.

The writer gives Pillow's own uncompressed bytes for L, RGB and RGBA
images (``image.save(f, "TIFF")``; the ``quality`` JAX passes is not read
by Pillow's TIFF writer): one strip, the tags Pillow writes, in its order.
"""

from __future__ import annotations

import lzma
import struct
import zlib

import numpy as np

from sdwebui_tpu_torch.utils import ccitt, lzw, zstd
from sdwebui_tpu_torch.utils.exif import _TYPE_SIZES, _ifd_entries
from sdwebui_tpu_torch.utils.image_modes import clip_grey, cmyk_to_rgb
from sdwebui_tpu_torch.utils.png import check_image_size, unpack_bits

#: Pillow's ``COMPRESSION_INFO`` names of the codes read here
COMPRESSIONS = {1: "raw", 2: "tiff_ccitt", 3: "group3", 4: "group4", 5: "tiff_lzw",
                6: "tiff_jpeg", 7: "jpeg",
                8: "tiff_adobe_deflate", 32773: "packbits", 32946: "tiff_deflate",
                34925: "lzma", 50000: "zstd"}
#: the codes libtiff on the JAX package's machine cannot decode
UNREAD_COMPRESSIONS = {32771: "raw_16", 32809: "ThunderScan",
                       34676: "SGILog", 34677: "SGILog24", 50001: "WebP"}
_PREDICTED = (5, 8, 32946, 34925, 50000)
_FORMATS = {1: "B", 2: "s", 3: "H", 4: "I", 5: "II", 6: "b", 7: "s", 8: "h", 9: "i", 10: "ii",
            11: "f", 12: "d", 13: "I", 16: "Q", 17: "q", 18: "Q"}
#: bytes a value of each type, BigTIFF's 8-byte integers and offsets included
_SIZES = {**_TYPE_SIZES, 13: 4, 16: 8, 17: 8, 18: 8}
_REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _values(entry, order: str):
    typ, raw = entry
    if typ in (2, 7):
        return raw
    size = _SIZES.get(typ, 1)
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
    if code == 34925:
        try:
            return lzma.LZMADecompressor().decompress(data, limit)
        except lzma.LZMAError as e:
            raise ValueError(f"corrupt TIFF LZMA data: {e}") from e
    if code == 50000:       # libtiff decodes a strip's first frame, and errs when it is short
        out = zstd.decompress(data, frames=1, limit=limit)
        if len(out) < limit:
            raise ValueError(f"TIFF Zstandard data {limit - len(out)} bytes short")
        return out
    try:
        return zlib.decompressobj().decompress(data, limit)
    except zlib.error as e:
        raise ValueError(f"corrupt TIFF Deflate data: {e}") from e


def _chunk_samples(raw: bytes, rows: int, cols: int, spp: int, depth: int, order: str,
                   predictor: int, dtype: str | None = None) -> np.ndarray:
    """One decompressed strip or tile → (rows, cols, spp) samples."""
    if dtype is not None or depth == 16:
        dt = np.dtype(order + (dtype or "u2"))
        need = rows * cols * spp * dt.itemsize
        a = np.frombuffer(raw[:need].ljust(need, b"\0"), dt).astype(dt.newbyteorder("="))
        a = a.reshape(rows, cols, spp)
    else:
        row_bytes = (cols * spp * depth + 7) // 8
        need = rows * row_bytes
        packed = np.frombuffer(raw[:need].ljust(need, b"\0"), np.uint8).reshape(rows, row_bytes)
        a = unpack_bits(packed, depth, cols * spp).reshape(rows, cols, spp)
    if predictor == 2:
        a = np.cumsum(a, axis=1, dtype=a.dtype)
    return a


def _jpeg_sampling(raw: bytes) -> tuple | None:
    """The first component's sampling factors in a JPEG's frame header."""
    pos = 2
    while pos + 4 <= len(raw):
        if raw[pos] != 0xFF:
            return None
        marker = raw[pos + 1]
        (size,) = struct.unpack_from(">H", raw, pos + 2)
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            f = raw[pos + 11] if pos + 11 < len(raw) else 0x11
            return f >> 4, f & 15
        pos += 2 + size
    return None


def _jpeg_chunk(raw: bytes, tables: bytes | None, photo: int, sub: tuple) -> np.ndarray:
    """A JPEG strip or tile (abbreviated when the file has ``JPEGTables``)
    → its samples: YCbCr converted to RGB (libtiff's JPEGCOLORMODE_RGB, as
    Pillow sets it), RGB and grey as coded.  A YCbCr stream whose luma
    sampling is not the ``YCbCrSubsampling`` tag's raises, as libtiff's
    ``JPEGPreDecode`` does."""
    from sdwebui_tpu_torch.utils.jpeg import decode_jpeg

    if photo == 6 and _jpeg_sampling(raw) not in (None, sub):
        raise ValueError(f"TIFF JPEG with sampling factors {_jpeg_sampling(raw)} against its "
                         f"YCbCrSubsampling {sub}")
    if tables and len(tables) > 4:
        raw = tables[:-2] + raw[2:]
    return decode_jpeg(raw, ycc=photo == 6)[0]


def _ojpeg_chunk(raw: bytes, sub: tuple) -> np.ndarray:
    """An old-style JPEG strip (a whole JPEG stream) → its YCbCr samples,
    chroma repeated over each ``sub`` unit: libtiff's OJPEG codec hands
    Pillow the raw downsampled planes, and its RGBA reader converts them
    (``_ycbcr_to_rgb``) with no interpolation."""
    from sdwebui_tpu_torch.utils.jpeg import decode_jpeg

    if _jpeg_sampling(raw) not in (None, sub):
        raise ValueError(f"TIFF old-style JPEG with sampling factors {_jpeg_sampling(raw)} "
                         f"against its YCbCrSubsampling {sub}")
    planes, _ = decode_jpeg(raw, raw_planes=True)
    if len(planes) != 3:
        raise ValueError(f"a TIFF old-style JPEG of {len(planes)} components is not read")
    y = planes[0]
    h, w = y.shape
    cb, cr = (np.repeat(np.repeat(p, sub[1], 0), sub[0], 1)[:h, :w] for p in planes[1:])
    return np.stack([y, cb, cr], axis=-1)


def _ycbcr_to_rgb(planes: np.ndarray, sub: tuple, luma: tuple, ref: tuple) -> np.ndarray:
    """Chunky YCbCr data units (each ``sub[0] · sub[1]`` luma samples, then
    Cb and Cr) → RGB, as libtiff's ``TIFFYCbCrToRGBInit`` tables and
    ``TIFFYCbCrtoRGB``, chroma repeated over each unit (its RGBA reader)."""
    f32 = np.float32
    lr, lg, lb = (f32(v) for v in luma)
    one = 1 << 16

    def fix(x):
        return np.int64(np.floor(np.float64(x) * one + 0.5))

    f1 = f32(2) - f32(2) * lr
    d1 = fix(min(max(f1, f32(0)), f32(2)))
    f2 = lr * f1 / lg
    d2 = -fix(min(max(f2, f32(0)), f32(2)))
    f3 = f32(2) - f32(2) * lb
    d3 = fix(min(max(f3, f32(0)), f32(2)))
    f4 = lb * f3 / lg
    d4 = -fix(min(max(f4, f32(0)), f32(2)))
    x = np.arange(256, dtype=np.int64) - 128
    rb = [f32(v) for v in ref]

    def code2v(c, black, white, span):
        width = white - black if white - black != 0 else f32(1)
        return ((c.astype(f32) - black) * f32(span)) / width

    cr = np.clip(code2v(x, rb[4] - f32(128), rb[5] - f32(128), 127), -128 * 32, 128 * 32)
    cb = np.clip(code2v(x, rb[2] - f32(128), rb[3] - f32(128), 127), -128 * 32, 128 * 32)
    cr, cb = cr.astype(np.int64), cb.astype(np.int64)
    half = 1 << 15
    cr_r, cb_b = (d1 * cr + half) >> 16, (d3 * cb + half) >> 16
    cr_g, cb_g = d2 * cr, d4 * cb + half
    y_tab = np.clip(code2v(x + 128, rb[0], rb[1], 255), -128 * 32, 128 * 32).astype(np.int64)
    yv = planes[..., 0].astype(np.int64)
    cbv, crv = planes[..., 1].astype(np.int64), planes[..., 2].astype(np.int64)
    yy = y_tab[np.minimum(yv, 255)]
    r = yy + cr_r[crv]
    g = yy + ((cb_g[cbv] + cr_g[crv]) >> 16)
    b = yy + cb_b[cbv]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def _ycbcr_units(raw: bytes, rows: int, cols: int, sub: tuple) -> np.ndarray:
    """Subsampled chunky YCbCr bytes → (rows, cols, 3) Y, Cb, Cr with each
    unit's chroma repeated."""
    sh, sv = sub
    ux, uy = -(-cols // sh), -(-rows // sv)
    unit = sh * sv + 2
    need = ux * uy * unit
    units = np.frombuffer(raw[:need].ljust(need, b"\0"), np.uint8).reshape(uy, ux, unit)
    y = units[:, :, :sh * sv].reshape(uy, ux, sv, sh).transpose(0, 2, 1, 3)
    y = y.reshape(uy * sv, ux * sh)
    cb = np.repeat(np.repeat(units[:, :, -2], sv, axis=0), sh, axis=1)
    cr = np.repeat(np.repeat(units[:, :, -1], sv, axis=0), sh, axis=1)
    return np.stack([y, cb, cr], axis=-1)[:rows, :cols]


def _big_ifd_entries(data: bytes, offset: int, order: str) -> dict:
    """{tag: (type, raw value bytes)} of a BigTIFF IFD: 8-byte counts, 20-byte
    entries, values of up to 8 bytes in place."""
    (count,) = struct.unpack_from(order + "Q", data, offset)
    out = {}
    for i in range(count):
        tag, typ, n, value = struct.unpack_from(order + "HHQ8s", data, offset + 8 + 20 * i)
        size = _SIZES.get(typ, 1) * n
        if size <= 8:
            out[tag] = (typ, value[:size])
        else:
            (pos,) = struct.unpack(order + "Q", value)
            out[tag] = (typ, data[pos:pos + size])
    return out


def decode_tiff(data: bytes) -> tuple[np.ndarray, dict]:
    """TIFF or BigTIFF bytes → (uint8 (H, W, C), info): the first image, with
    Pillow's ``compression``, ``dpi`` and ``resolution`` in info."""
    big = data[:4] in (b"II+\x00", b"MM\x00+")
    if data[:4] not in (b"II*\x00", b"MM\x00*") and not big:
        raise ValueError("not a TIFF file")
    order = "<" if data[:2] == b"II" else ">"
    try:
        if big:
            size, _, first = struct.unpack_from(order + "HHQ", data, 4)
            if size != 8:
                raise ValueError(f"BigTIFF with {size}-byte offsets")
            tags = _big_ifd_entries(data, first, order)
        else:
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
    if code in UNREAD_COMPRESSIONS:
        from sdwebui_tpu_torch.utils.image_io import UnsupportedImageFormat

        raise UnsupportedImageFormat(f"TIFF with {UNREAD_COMPRESSIONS[code]} compression")
    if code not in COMPRESSIONS:
        raise ValueError(f"TIFF compression code {code} is not read")
    photo = get(262, (0,))[0]
    if code == 6:            # Pillow takes old-style JPEG as YCbCr, three samples by default
        photo = 6
    spp = get(277, (3 if code in (6, 7) and photo in (2, 6) else 1,))[0]
    bits = tuple(get(258, (1,)))
    extra = tuple(get(338, ()))
    if len(bits) == 1 and spp > 1:
        bits = bits * spp
    bits = bits[:spp]
    planar = get(284, (1,))[0]
    predictor = get(317, (1,))[0]
    fill = get(266, (1,))[0]
    fmt = tuple(get(339, (1,)))
    if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
        fmt = (1,)
    fmt = fmt[0] if len(set(fmt)) == 1 else None
    depth = bits[0]
    if len(set(bits)) != 1 or len(bits) != spp or fmt not in (1, 2, 3) \
            or depth not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f"TIFF with {bits}-bit samples of format {fmt} is not read")
    if code not in _PREDICTED:   # libtiff's predictor belongs to LZW, Deflate, LZMA, Zstd
        predictor = 1
    if predictor not in (1, 2) or (predictor == 2 and depth not in (8, 16)):
        raise ValueError(f"TIFF predictor {predictor} with {depth}-bit samples is not read")
    sample_dtype = None
    kind = None
    if photo in (0, 1) and spp == 1:
        if (fmt == 1 and depth <= 16) or (fmt == 2 and depth == 8 and photo == 1):
            kind = "grey"
        else:   # Pillow's "I" and "F" modes
            sample_dtype = {(16, 2): "i2", (32, 1): "u4", (32, 2): "i4", (32, 3): "f4"}.get(
                (depth, fmt))
            kind = "wide" if sample_dtype else None
    elif fmt != 1:
        kind = None
    elif photo == 1 and spp == 2 and depth == 8 and extra == (2,):
        kind = "LA"
    elif photo == 2 and spp == 3 and depth in (8, 16) and not extra:
        kind = "RGB"
    elif photo == 2 and spp == 4 and depth in (8, 16) and extra in ((), (0,), (1,), (2,)):
        kind = {(): "RGBA", (0,): "RGB", (1,): "RGBa", (2,): "RGBA"}[extra]
    elif photo == 3 and spp == 1 and depth <= 8 and 320 in tags:
        kind = "P"
    elif photo == 5 and spp in (4, 5, 6) and depth == 8 and extra == (0,) * (spp - 4):
        kind = "CMYK"
    elif photo == 6 and spp == 3 and depth == 8 and not extra:
        kind = "YCbCr"
    if kind is None:
        raise ValueError(f"TIFF layout not read: photometric {photo}, {bits}-bit samples of "
                         f"format {fmt}, extra samples {extra}")
    if code == 6 and kind != "YCbCr" or code == 7 and kind not in ("grey", "RGB", "YCbCr") or \
            code in (2, 3, 4) and not (kind == "grey" and depth == 1):
        raise ValueError(f"TIFF {COMPRESSIONS[code]} of photometric {photo} at {depth} bits "
                         "is not read")
    if kind == "YCbCr" and code == 1:
        raise ValueError("an uncompressed YCbCr TIFF is not read: Pillow unpacks it as RGBX "
                         "and finds it truncated")
    sub = tuple(get(530, (2, 2)))[:2] if kind == "YCbCr" else (1, 1)

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
    dtype = sample_dtype or ("u2" if depth == 16 else "u1")
    image = np.zeros((height, width, spp), np.dtype(dtype))
    tables = get(347) if code == 7 else None
    t4 = get(292, (0,))[0] if code == 3 else 0
    for p in range(planes):
        for i in range(n):
            y, x, rows, cols = box(i)
            k = p * n + i
            raw = data[offsets[k]:offsets[k] + counts[k]]
            if fill == 2 and code != 7:
                raw = _REVERSED[np.frombuffer(raw, np.uint8)].tobytes()
            if code == 6:
                if not raw.startswith(b"\xff\xd8") and 513 in tags:
                    if n * planes != 1:
                        raise ValueError("an old-style JPEG TIFF of several strips with its "
                                         "JPEG interchange format is not read")
                    at, size = get(513)[0], get(514, (len(data),))[0]
                    raw = data[at:at + size]
                block = _ojpeg_chunk(raw, sub)
            elif code == 7:
                block = _jpeg_chunk(raw, tables, photo, sub)
            elif code in (2, 3, 4):
                block = ccitt.decode(raw, cols, rows, {2: "rle", 3: "g3", 4: "g4"}[code],
                                     t4)[:, :, None]
            elif kind == "YCbCr":
                units = -(-cols // sub[0]) * -(-rows // sub[1]) * (sub[0] * sub[1] + 2)
                block = _ycbcr_units(_inflate(raw, code, units), rows, cols, sub)
            else:
                row_bytes = (cols * per * (depth if dtype == "u1" else 8 * np.dtype(dtype)
                                           .itemsize) + 7) // 8
                raw = _inflate(raw, code, rows * row_bytes)
                block = _chunk_samples(raw, rows, cols, per, depth, order, predictor,
                                       sample_dtype)
            block = block[:height - y, :width - x]
            image[y:y + block.shape[0], x:x + block.shape[1], p:p + per] = block[:, :, :per]

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

    if kind == "wide":
        return clip_grey(image[:, :, 0]), info
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
    if kind == "CMYK":
        return cmyk_to_rgb(image[:, :, :4]), info
    if kind == "YCbCr":
        if code == 7:
            return image, info
        luma = tuple(get(529, (0.299, 0.587, 0.114)))
        ref = tuple(get(532, (0.0, 255.0, 128.0, 255.0, 128.0, 255.0)))
        return _ycbcr_to_rgb(image, sub, luma, ref), info
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
