"""The WebP container: reading every WebP as Pillow 12 opens it (through
libwebp's ``WebPAnimDecoder``), and writing what ``image.save(f, "WEBP",
quality=..., lossless=..., exif=...)`` writes, in the port's codecs.

Reading: a simple ``VP8 `` (lossy, ``utils/vp8``) or ``VP8L`` (lossless,
``utils/vp8l``) file, or ``VP8X`` with its ``ALPH`` chunk (raw or
VP8L-compressed alpha, under no, horizontal, vertical or gradient
filtering), ``ICCP``, ``EXIF`` and ``XMP `` chunks (``info["icc_profile"]``,
``info["exif"]``, ``info["xmp"]``) and, for an animation, the first frame
composited on a zero canvas at its offset, as ``WebPAnimDecoder`` makes it.
The image is RGBA when the file declares alpha (Pillow's "RGBA"), else
RGB; ``info`` also holds ``loop`` and ``background`` as Pillow reports them
(1 and opaque white for a still image; the ANIM chunk's for an animation).

Writing: a VP8L file (``webp_lossless``) or a VP8 one at `quality`, with
the EXIF block (its ``Exif\\0\\0`` header dropped, as Pillow drops it) in a
VP8X container when there is one.  An alpha channel is kept in a lossless
file; the lossy writer takes RGB only (JAX converts RGBA to RGB before a
WebP save).
"""

from __future__ import annotations

import struct

import numpy as np

from sdwebui_tpu_torch.utils import vp8, vp8l
from sdwebui_tpu_torch.utils.png import check_image_size

_ALPHA_FLAG, _EXIF_FLAG, _ANIM_FLAG = 0x10, 0x08, 0x02


def _chunks(data: bytes, pos: int, end: int, first_only: bool = False) -> list:
    """(kind, body) of each chunk up to `end`, refusing a chunk that does
    not fit whole (its pad byte included), as libwebp's demuxer does; a
    ``VP8 `` body keeps its pad byte, which the demuxer hands to the frame
    decoder with it."""
    out = []
    while pos < end:
        if pos + 8 > end:
            raise ValueError("truncated WebP chunk header")
        kind = data[pos:pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        padded = size + (size & 1)
        if pos + 8 + padded > end:
            raise ValueError(f"truncated WebP {kind.decode('latin-1')!r} chunk")
        out.append((kind, data[pos + 8:pos + 8 + (padded if kind == b"VP8 " else size)]))
        pos += 8 + padded
        if first_only:
            break
    return out


def _unfilter(alpha: np.ndarray, method: int) -> np.ndarray:
    """libwebp's alpha unfilters: 1 horizontal, 2 vertical, 3 gradient; the
    first row predicts from the left (its first pixel from 0), the first
    column of the others from above."""
    if method == 0:
        return alpha
    h, w = alpha.shape
    a = alpha.astype(np.int64)
    out = np.empty((h, w), np.int64)
    out[0] = np.cumsum(a[0]) & 255
    if method == 1:   # the first column runs down, each row from its first pixel
        b = a.copy()
        b[:, 0] = np.cumsum(a[:, 0])
        return (np.cumsum(b, axis=1) & 255).astype(np.uint8)
    if method == 2:
        out[1:] = a[1:]
        return (np.cumsum(out, axis=0) & 255).astype(np.uint8)
    for y in range(1, h):
        prev = out[y - 1].tolist()
        row = a[y].tolist()
        left = top_left = prev[0]
        res = [0] * w
        for x in range(w):
            top = prev[x]
            g = left + top - top_left
            g = 0 if g < 0 else 255 if g > 255 else g
            left = (row[x] + g) & 255
            top_left = top
            res[x] = left
        out[y] = res
    return out.astype(np.uint8)


def decode_alph(body: bytes, width: int, height: int) -> np.ndarray:
    """An ALPH chunk → (H, W) uint8 alpha."""
    if not body:
        raise ValueError("empty WebP ALPH chunk")
    head = body[0]
    method, filt = head & 3, (head >> 2) & 3
    if method == 0:
        raw = body[1:1 + width * height]
        if len(raw) < width * height:
            raise ValueError("truncated WebP alpha")
        alpha = np.frombuffer(raw, np.uint8).reshape(height, width)
    elif method == 1:
        alpha = ((vp8l.decode_stream(body[1:], width, height) >> 8) & 255).astype(np.uint8)
    else:
        raise ValueError(f"unknown WebP alpha compression {method}")
    return _unfilter(alpha, filt)


def _frame(chunks: list) -> tuple[np.ndarray, bool]:
    """The image chunks of one frame → ((H, W, 4) RGBA, has alpha data)."""
    alph = next((b for k, b in chunks if k == b"ALPH"), None)
    for kind, body in chunks:
        if kind == b"VP8 ":
            frame = vp8.decode_frame(body)
            rgb = vp8.yuv_to_rgb(frame)
            if alph is not None:
                a = decode_alph(alph, frame.width, frame.height)
            else:
                a = np.full(rgb.shape[:2], 255, np.uint8)
            return np.concatenate([rgb, a[:, :, None]], axis=2), alph is not None
        if kind == b"VP8L":
            argb, alpha = vp8l.decode(body)
            rgba = np.stack([(argb >> 16) & 255, (argb >> 8) & 255, argb & 255, argb >> 24],
                            axis=2).astype(np.uint8)
            return rgba, alpha
    raise ValueError("WebP without an image chunk")


def decode_webp(data: bytes) -> tuple[np.ndarray, dict]:
    """WebP bytes → (uint8 (H, W, 3 | 4), info)."""
    if len(data) < 20 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise ValueError("not a WebP file")
    (size,) = struct.unpack_from("<I", data, 4)
    if size < 8 or len(data) < 8 + size:
        raise ValueError("truncated WebP file")
    info: dict = {"loop": 1, "background": (255, 255, 255, 255)}
    if data[12:16] != b"VP8X":     # a simple file: its first chunk is the image
        rgba, alpha = _frame(_chunks(data, 12, 8 + size, first_only=True))
        return (rgba if alpha else np.ascontiguousarray(rgba[:, :, :3])), info
    chunks = _chunks(data, 12, 8 + size)
    body = chunks[0][1]
    if len(body) < 10:
        raise ValueError("truncated WebP VP8X chunk")
    flags = body[0]
    width = 1 + int.from_bytes(body[4:7], "little")
    height = 1 + int.from_bytes(body[7:10], "little")
    check_image_size(width, height)
    extra = {}
    for k, b in chunks[1:]:
        if k == b"ICCP":
            extra["icc_profile"] = b
        elif k == b"EXIF":
            extra["exif"] = b
        elif k == b"XMP ":
            extra["xmp"] = b
    alpha = bool(flags & _ALPHA_FLAG)
    if flags & _ANIM_FLAG:
        anim = next((b for k, b in chunks if k == b"ANIM"), None)
        if anim is not None and len(anim) >= 6:
            bg, loop = struct.unpack_from("<IH", anim)
            info = {"loop": loop, "background": ((bg >> 16) & 255, (bg >> 8) & 255, bg & 255,
                                                 bg >> 24)}
        first = next((b for k, b in chunks if k == b"ANMF"), None)
        canvas = np.zeros((height, width, 4), np.uint8)
        if first is not None:
            x0 = 2 * int.from_bytes(first[0:3], "little")
            y0 = 2 * int.from_bytes(first[3:6], "little")
            rgba, _ = _frame(_chunks(first, 16, len(first)))
            fh, fw = rgba.shape[:2]
            canvas[y0:y0 + fh, x0:x0 + fw] = rgba[:height - y0, :width - x0]
        image = canvas
    else:
        image, has_alph = _frame(chunks[1:])
        alpha = alpha or has_alph
    info.update(extra)
    return (image if alpha else np.ascontiguousarray(image[:, :, :3])), info


def _riff(chunks: list) -> bytes:
    body = b"".join(k + struct.pack("<I", len(b)) + b + (b"\0" if len(b) & 1 else b"")
                    for k, b in chunks)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def _vp8x(flags: int, width: int, height: int) -> bytes:
    return bytes([flags, 0, 0, 0]) + (width - 1).to_bytes(3, "little") \
        + (height - 1).to_bytes(3, "little")


def encode_webp(image: np.ndarray, quality: float = 80, lossless: bool = False,
                exif: bytes | None = None) -> bytes:
    """uint8 (H, W[, C]) → WebP bytes: VP8L when `lossless`, else VP8 at
    `quality`; `exif` (an APP1 payload, with or without its ``Exif\\0\\0``
    header) in a VP8X container."""
    from sdwebui_tpu_torch.utils import webp_encode

    a = np.asarray(image, np.uint8)
    if a.ndim == 2:
        a = a[:, :, None]
    h, w = a.shape[:2]
    if lossless:
        body, alpha = webp_encode.encode_vp8l(a)
        chunks = [(b"VP8L", body)]
    else:
        rgb = np.repeat(a[:, :, :1], 3, 2) if a.shape[2] <= 2 else a[:, :, :3]
        chunks = [(b"VP8 ", webp_encode.encode_vp8(rgb, quality))]
        alpha = False
    if exif:
        if exif.startswith(b"Exif\x00\x00"):
            exif = exif[6:]
        flags = _EXIF_FLAG | (_ALPHA_FLAG if alpha else 0)
        chunks = [(b"VP8X", _vp8x(flags, w, h))] + chunks + [(b"EXIF", exif)]
    return _riff(chunks)


def encode_webp_alpha(image: np.ndarray, quality: float = 80) -> bytes:
    """uint8 (H, W, 4) → a lossy WebP with its alpha in an ALPH chunk
    (VP8L-compressed, unfiltered), in a VP8X container."""
    from sdwebui_tpu_torch.utils import webp_encode

    a = np.asarray(image, np.uint8)
    h, w = a.shape[:2]
    alph = bytes([1]) + webp_encode.encode_alpha_stream(a[:, :, 3])
    return _riff([(b"VP8X", _vp8x(_ALPHA_FLAG, w, h)), (b"ALPH", alph),
                  (b"VP8 ", webp_encode.encode_vp8(a[:, :, :3], quality))])
