"""Autodesk FLI / FLC reading on numpy, as Pillow's ``FliImagePlugin`` and
its ``fli`` decoder (``FliDecode.c``) do: the first frame.

The palette is the first frame's first COLOR256 (chunk 4) or COLOR (chunk
11, 6-bit, shifted up by 2) chunk over a grey ramp; the frame's pixels
start black and take its BRUN (15), LC (12, byte delta), SS2 (7, word
delta), COPY (16) and BLACK (13) chunks in order (PSTAMP and the colour
chunks are skipped).  A chunk the decoder does not know, or one that runs
past the frame, raises as Pillow's decoder does.  Info holds Pillow's
``duration``."""

from __future__ import annotations

import struct

import numpy as np

from sdwebui_tpu_torch.utils.image_modes import NotThisFormat, from_palette
from sdwebui_tpu_torch.utils.png import check_image_size


def accept(prefix: bytes) -> bool:
    return (len(prefix) >= 16 and struct.unpack_from("<H", prefix, 4)[0] in (0xAF11, 0xAF12)
            and struct.unpack_from("<H", prefix, 14)[0] in (0, 3))


def _palette(data: bytes, pos: int, palette: np.ndarray, shift: int) -> None:
    (packets,) = struct.unpack_from("<H", data, pos)
    pos += 2
    i = 0
    for _ in range(packets):
        i += data[pos]
        n = data[pos + 1] or 256
        pos += 2
        rgb = np.frombuffer(data[pos:pos + 3 * n], np.uint8)
        pos += 3 * n
        rgb = rgb[:len(rgb) // 3 * 3].reshape(-1, 3).astype(np.int32) << shift
        palette[i:i + len(rgb)] = rgb[:256 - i] & 255
        i += len(rgb)


def _overrun(what: str):
    return ValueError(f"FLI: {what} runs past the frame")


def _frame(data: bytes, pos: int, w: int, h: int) -> np.ndarray:
    """Pillow's ``ImagingFliDecode`` of the frame at `pos`."""
    img = np.zeros((h, w), np.uint8)
    framesize, magic, chunks = struct.unpack_from("<IHH", data, pos)
    if magic != 0xF1FA:
        raise ValueError("FLI: unknown frame type")
    end = min(len(data), pos + framesize)
    ptr = pos + 16
    for _ in range(chunks):
        if end - ptr < 10:
            raise _overrun("a chunk header")
        size, kind = struct.unpack_from("<IH", data, ptr)
        d = ptr + 6
        if kind == 7:                                   # SS2: word delta
            (lines,) = struct.unpack_from("<H", data, d)
            d += 2
            y = 0
            done = 0
            while done < lines and y < h:
                (packets,) = struct.unpack_from("<H", data, d)
                d += 2
                while packets & 0x8000:
                    if packets & 0x4000:
                        y += 65536 - packets
                        if y >= h:
                            raise _overrun("an SS2 line skip")
                    else:
                        img[y, w - 1] = packets & 255
                    (packets,) = struct.unpack_from("<H", data, d)
                    d += 2
                x = 0
                for _ in range(packets):
                    x += data[d]
                    count = data[d + 1]
                    if count >= 128:
                        n = 256 - count
                        if x + 2 * n > w:
                            break
                        img[y, x:x + 2 * n] = np.tile(np.frombuffer(data, np.uint8, 2, d + 2), n)
                        x += 2 * n
                        d += 4
                    else:
                        n = 2 * count
                        if x + n > w:
                            break
                        img[y, x:x + n] = np.frombuffer(data, np.uint8, n, d + 2)
                        d += 2 + n
                        x += n
                else:
                    done += 1
                    y += 1
                    continue
                break
            if done < lines:
                raise _overrun("an SS2 chunk")
        elif kind == 12:                                # LC: byte delta
            y, count_lines = struct.unpack_from("<HH", data, d)
            ymax = y + count_lines
            d += 4
            while y < ymax and y < h:
                packets = data[d]
                d += 1
                x = 0
                for _ in range(packets):
                    x += data[d]
                    count = data[d + 1]
                    if count & 0x80:
                        n = 256 - count
                        if x + n > w:
                            break
                        img[y, x:x + n] = data[d + 2]
                        d += 3
                    else:
                        n = count
                        if x + n > w:
                            break
                        img[y, x:x + n] = np.frombuffer(data, np.uint8, n, d + 2)
                        d += 2 + n
                    x += n
                else:
                    y += 1
                    continue
                break
            if y < ymax:
                raise _overrun("an LC chunk")
        elif kind == 13:                                # BLACK
            img[:] = 0
        elif kind == 15:                                # BRUN
            for y in range(h):
                d += 1                                  # the packet count is ignored
                x = 0
                while x < w:
                    count = data[d]
                    if count & 0x80:
                        n = 256 - count
                        if x + n > w:
                            break
                        img[y, x:x + n] = np.frombuffer(data, np.uint8, n, d + 1)
                        d += n + 1
                    else:
                        n = count
                        if x + n > w:
                            break
                        img[y, x:x + n] = data[d + 1]
                        d += 2
                    x += n
                if x != w:
                    raise _overrun("a BRUN line")
        elif kind == 16:                                # COPY
            if w * h > end - d:
                raise _overrun("a COPY chunk")
            img[:] = np.frombuffer(data, np.uint8, w * h, d).reshape(h, w)
        elif kind not in (4, 11, 18):
            raise ValueError(f"FLI: unknown chunk type {kind}")
        if size == 0:
            raise ValueError("FLI: a chunk of no size")
        if size > end - ptr:
            raise _overrun("a chunk")
        ptr += size
    return img


def decode_fli(data: bytes) -> tuple[np.ndarray, dict]:
    """FLI / FLC bytes → (uint8 (H, W, 3) of the first frame, info)."""
    s = data[:128]
    if not (len(s) == 128 and accept(s) and s[20:22] == b"\0\0" and s[42:80] == bytes(38)
            and s[88:] == bytes(40)):
        raise NotThisFormat("not an FLI/FLC file")
    w, h = struct.unpack_from("<HH", s, 8)
    check_image_size(w, h)
    if w <= 0 or h <= 0:
        raise NotThisFormat("FLI of no pixels")
    (duration,) = struct.unpack_from("<I", s, 16)
    if struct.unpack_from("<H", s, 4)[0] == 0xAF11:
        duration = duration * 1000 // 70
    palette = np.repeat(np.arange(256, dtype=np.int32)[:, None], 3, axis=1)
    pos = 128
    head = data[pos:pos + 16]
    if len(head) >= 6 and struct.unpack_from("<H", head, 4)[0] == 0xF100:
        pos += struct.unpack_from("<I", head)[0]
        head = data[pos:pos + 16]
    frame_at = pos
    if len(head) >= 8 and struct.unpack_from("<H", head, 4)[0] == 0xF1FA:
        (subchunks,) = struct.unpack_from("<H", head, 6)
        at = pos + 16
        size = None
        for _ in range(subchunks):
            if size is not None:
                at += size
            (size, kind) = struct.unpack_from("<IH", data, at)
            if kind in (4, 11):
                _palette(data, at + 6, palette, 2 if kind == 11 else 0)
                break
            if not size:
                break
    if len(data) < frame_at + 4:
        raise ValueError("FLI: missing frame size")
    index = _frame(data, frame_at, w, h)
    return from_palette(index, palette.astype(np.uint8)), {"duration": duration}
