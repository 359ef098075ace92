"""GIF reading and writing on numpy, as Pillow's ``GifImagePlugin`` does for
the first frame.

The reader gives the first frame as ``Image.open`` gives it: placed at its
offset on the logical screen (grown to hold it, as Pillow grows it), the
rest filled with the transparent index, or 0; global or local palette,
interlaced rows, LZW through ``utils/lzw``.  A file with no palette, or
with the ordered grey palette, reads as grey (Pillow's "L"); any other is
expanded to RGB, as ``convert("RGB")`` expands Pillow's "P", the
transparent index included (``convert`` drops transparency).  ``info``
holds Pillow's ``version``, ``background``, ``transparency``,
``duration``, ``comment``, ``extension`` and ``loop``.

The writer is what ``image.save(f, "GIF", comment=geninfo)`` writes: one
frame, the image's colours as a palette when it has at most 256 of them
(the pixels then read back exactly), else 256 colours by median cut
refined by k-means (Pillow's own median cut is not restated: the palette
differs, the error is of the same size); the comment extension with the
UTF-8 infotext in 255-byte sub-blocks, and GIF89a when there is a
comment, GIF87a when there is none, as Pillow decides.  RGBA images are
written from their RGB.
"""

from __future__ import annotations

import struct

import numpy as np

from sdwebui_tpu_torch.utils import lzw
from sdwebui_tpu_torch.utils.png import check_image_size

_INTERLACE = ((0, 8), (4, 8), (2, 4), (1, 2))


def _blocks(data: bytes, pos: int) -> tuple[list, int]:
    """The data sub-blocks from `pos` → (their bytes, the position after
    the terminator)."""
    out = []
    n = len(data)
    while pos < n:
        size = data[pos]
        pos += 1
        if size == 0:
            break
        out.append(data[pos:pos + size])
        pos += size
    return out, pos


def _palette_needed(p: bytes) -> bool:
    return any(not (i // 3 == p[i] == p[i + 1] == p[i + 2]) for i in range(0, len(p) - 2, 3))


def decode_gif(data: bytes) -> tuple[np.ndarray, dict]:
    """GIF bytes → (uint8 (H, W, 1 | 3), info) of the first frame."""
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("not a GIF file")
    width, height, flags, bg = struct.unpack_from("<HHBB", data, 6)
    info: dict = {"version": data[:6]}
    pos = 13
    palette = None
    if flags & 0x80:
        info["background"] = bg
        size = 3 << ((flags & 7) + 1)
        p = data[pos:pos + size]
        pos += size
        if _palette_needed(p):
            palette = p
    transparency = None
    while True:
        if pos >= len(data):
            raise ValueError("GIF without an image")
        kind = data[pos]
        pos += 1
        if kind == 0x21:
            label = data[pos]
            after_first = pos + 2 + data[pos + 1] if pos + 1 < len(data) else pos
            blocks, pos = _blocks(data, pos + 1)
            first = blocks[0] if blocks else b""
            if label == 0xF9 and len(first) >= 4:
                if first[0] & 1:
                    transparency = first[3]
                info["duration"] = struct.unpack_from("<H", first, 1)[0] * 10
            elif label == 0xFE:
                comment = b"".join(blocks)
                info["comment"] = info["comment"] + b"\n" + comment if "comment" in info \
                    else comment
            elif label == 0xFF and blocks:
                info["extension"] = (first, after_first)   # Pillow's (block, file offset)
                if first[:11] == b"NETSCAPE2.0" and len(blocks) > 1 and len(blocks[1]) >= 3 \
                        and blocks[1][0] == 1:
                    info["loop"] = struct.unpack_from("<H", blocks[1], 1)[0]
        elif kind == 0x2C:
            break
        elif kind == 0x3B:
            raise ValueError("GIF without an image")
        else:
            raise ValueError(f"bad GIF block 0x{kind:02x}")
    x0, y0, fw, fh, lflags = struct.unpack_from("<HHHHB", data, pos)
    pos += 9
    if lflags & 0x80:
        size = 3 << ((lflags & 7) + 1)
        p = data[pos:pos + size]
        pos += size
        palette = p if _palette_needed(p) else None
    width, height = max(width, x0 + fw), max(height, y0 + fh)
    check_image_size(width, height)
    min_size = data[pos]
    blocks, pos = _blocks(data, pos + 1)
    pixels = lzw.decode_gif(b"".join(blocks), min_size, fw * fh)
    frame = np.zeros(fw * fh, np.uint8)
    frame[:len(pixels)] = np.frombuffer(pixels, np.uint8)
    frame = frame.reshape(fh, fw)
    if lflags & 0x40:
        rows = np.concatenate([np.arange(s, fh, step) for s, step in _INTERLACE])
        inter = np.empty_like(frame)
        inter[rows] = frame
        frame = inter
    if transparency is not None:
        info["transparency"] = transparency
    index = np.full((height, width), transparency or 0, np.uint8)
    index[y0:y0 + fh, x0:x0 + fw] = frame
    if palette is None:
        return index[:, :, None], info
    full = np.zeros((256, 3), np.uint8)
    pal = np.frombuffer(palette, np.uint8)
    pal = pal[:len(pal) // 3 * 3].reshape(-1, 3)[:256]
    full[:len(pal)] = pal
    return full[index], info


# --------------------------------------------------------------------------
# writing
# --------------------------------------------------------------------------


def _nearest(colors: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """The index of the nearest palette entry (squared distance) of each
    colour, in chunks."""
    pal = palette.astype(np.float32)     # exact: every sum stays below 2**24
    pn = (pal * pal).sum(1)
    out = np.empty(len(colors), np.intp)
    for i in range(0, len(colors), 16384):
        c = colors[i:i + 16384].astype(np.float32)
        d = pn[None, :] - 2 * c @ pal.T
        out[i:i + 16384] = d.argmin(1)
    return out


def quantize(rgb: np.ndarray, colors: int = 256, iterations: int = 3):
    """(N, 3) uint8 colours → (palette (K, 3) uint8, indices (N,)): every
    colour when there are at most `colors`, else median cut over the
    distinct colours (weighted by count) and `iterations` rounds of
    k-means."""
    rgb = np.asarray(rgb, np.uint8).reshape(-1, 3)
    keys = (rgb[:, 0].astype(np.int32) << 16) | (rgb[:, 1].astype(np.int32) << 8) | rgb[:, 2]
    ukeys, inverse, counts = np.unique(keys, return_inverse=True, return_counts=True)
    uniq = np.stack([ukeys >> 16, (ukeys >> 8) & 255, ukeys & 255], 1).astype(np.uint8)
    inverse = inverse.reshape(-1)
    if len(uniq) <= colors:
        return uniq, inverse
    u = uniq.astype(np.float64)
    w = counts.astype(np.float64)

    def scored(b):
        span = u[b].max(0) - u[b].min(0)
        return (span.max() * w[b].sum() if len(b) > 1 else -1.0), int(span.argmax()), b

    boxes = [scored(np.arange(len(uniq)))]
    while len(boxes) < colors:
        k = max(range(len(boxes)), key=lambda i: boxes[i][0])
        if boxes[k][0] <= 0:
            break
        _, axis, b = boxes.pop(k)
        b = b[np.argsort(u[b, axis], kind="stable")]
        cum = np.cumsum(w[b])
        cut = int(np.searchsorted(cum, cum[-1] / 2)) + 1
        cut = min(max(cut, 1), len(b) - 1)
        boxes += [scored(b[:cut]), scored(b[cut:])]
    boxes = [b for _, _, b in boxes]
    pal = np.stack([(u[b] * w[b, None]).sum(0) / w[b].sum() for b in boxes])
    for _ in range(iterations):
        assign = _nearest(uniq, np.rint(pal))
        sums = np.zeros_like(pal)
        np.add.at(sums, assign, u * w[:, None])
        total = np.bincount(assign, weights=w, minlength=len(pal))
        keep = total > 0
        pal[keep] = sums[keep] / total[keep, None]
    pal = np.clip(np.rint(pal), 0, 255).astype(np.uint8)
    return pal, _nearest(uniq, pal)[inverse]


def encode_gif(image: np.ndarray, comment: str | None = None) -> bytes:
    """uint8 grey (H, W[, 1]) or RGB(A) (H, W, 3|4) → GIF bytes."""
    a = np.asarray(image)
    if a.dtype != np.uint8:
        raise ValueError(f"expected uint8, got {a.dtype}")
    if a.ndim == 2:
        a = a[:, :, None]
    h, w, c = a.shape
    if c in (1, 2):
        pal, index = quantize(np.repeat(a[:, :, :1], 3, 2).reshape(-1, 3))
    else:
        pal, index = quantize(a[:, :, :3].reshape(-1, 3))
    bits = max(1, int(np.ceil(np.log2(max(len(pal), 2)))))
    table = np.zeros((1 << bits, 3), np.uint8)
    table[:len(pal)] = pal
    text = comment.encode() if isinstance(comment, str) else (comment or b"")
    version = b"GIF89a" if text else b"GIF87a"
    out = [version, struct.pack("<HHBBB", w, h, 0x80 | (bits - 1), 0, 0), table.tobytes()]
    if text:
        out.append(b"!\xfe" + b"".join(bytes([len(text[i:i + 255])]) + text[i:i + 255]
                                       for i in range(0, len(text), 255)) + b"\0")
    min_size = max(2, bits)
    coded = lzw.encode_gif(index.astype(np.uint8).tobytes(), min_size)
    out += [b",", struct.pack("<HHHHB", 0, 0, w, h, 0), bytes([min_size])]
    out += [bytes([len(coded[i:i + 255])]) + coded[i:i + 255] for i in range(0, len(coded), 255)]
    out.append(b"\0;")
    return b"".join(out)
