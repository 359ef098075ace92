"""Adobe Photoshop (PSD) reading on numpy, as Pillow's ``PsdImagePlugin``
does: the merged image after the header, the colour-mode data (a 768-byte
palette for indexed images), the image resources (an ICC profile goes in
``info``) and the layer section, which is skipped (``Image.open`` reads no
layer).

Pillow's modes: bitmap ("1", set bits white), grey, duotone and
multichannel as grey, indexed ("P", its planar palette), RGB (RGBA when
the file has exactly four channels) and CMYK (stored inverted), raw or
PackBits, at 8 bits a channel.  A 16- or 32-bit file is one Pillow's table
has no mode for: it refuses it, so its bytes fall through to the next
plugin, as in ``Image.open``.  Lab files raise naming themselves."""

from __future__ import annotations

import struct

import numpy as np

from sdwebui_tpu_torch.utils.image_modes import NotThisFormat, as_output, from_palette
from sdwebui_tpu_torch.utils.png import check_image_size, unpack_bits
from sdwebui_tpu_torch.utils.tiff import _packbits

#: (colour mode, bits) → (Pillow mode, channels read)
_MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1), (2, 8): ("P", 1),
          (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4), (7, 8): ("L", 1), (8, 8): ("L", 1),
          (9, 8): ("LAB", 3)}


def accept(prefix: bytes) -> bool:
    return prefix.startswith(b"8BPS")


def decode_psd(data: bytes) -> tuple[np.ndarray, dict]:
    """PSD bytes → (uint8 (H, W, C), info) of the merged image."""
    if len(data) < 26 or not accept(data) or struct.unpack_from(">H", data, 4)[0] != 1:
        raise NotThisFormat("not a PSD file")
    channels_in, h, w, bits, cmode = struct.unpack_from(">HIIHH", data, 12)
    if (cmode, bits) not in _MODES:
        raise NotThisFormat(f"PSD at {bits} bits in colour mode {cmode} has no Pillow mode")
    mode, channels = _MODES[(cmode, bits)]
    if channels > channels_in:
        raise ValueError("PSD: not enough channels")
    if mode == "RGB" and channels_in == 4:
        mode, channels = "RGBA", 4
    if mode == "LAB":
        raise ValueError("a PSD in Lab colour is not read")
    try:
        pos = 26
        (size,) = struct.unpack_from(">I", data, pos)
        pos += 4
        palette = None
        if size:
            if mode == "P" and size == 768:
                palette = np.frombuffer(data, np.uint8, 768, pos).reshape(3, 256).T
            pos += size
        info: dict = {}
        (size,) = struct.unpack_from(">I", data, pos)
        pos += 4
        end = pos + size
        while pos < end:
            rid = struct.unpack_from(">H", data, pos + 4)[0]
            pos += 6
            name_len = data[pos]
            pos += 1 + name_len
            if not name_len & 1:
                pos += 1
            (length,) = struct.unpack_from(">I", data, pos)
            pos += 4
            if rid == 1039:
                info["icc_profile"] = data[pos:pos + length]
            pos += length + (length & 1)
        pos = end
        (size,) = struct.unpack_from(">I", data, pos)
        pos += 4 + size
        (compression,) = struct.unpack_from(">H", data, pos)
        pos += 2
    except (struct.error, IndexError) as e:
        raise NotThisFormat(f"truncated PSD header: {e}") from e
    check_image_size(w, h)
    if w <= 0 or h <= 0:
        raise NotThisFormat("PSD of no pixels")
    row = (w + 7) // 8 if mode == "1" else w
    planes = []
    if compression == 0:
        for c in range(channels):
            at = pos + c * w * h
            raw = data[at:at + row * h]
            if len(raw) < row * h:
                raise ValueError("PSD: image file is truncated")
            planes.append(np.frombuffer(raw, np.uint8).reshape(h, row))
    elif compression == 1:
        counts = np.frombuffer(data, ">u2", channels * h, pos).astype(np.int64)
        at = pos + 2 * channels * h
        for c in range(channels):
            raw = _packbits(data[at:], row * h)
            if len(raw) < row * h:
                raise ValueError("PSD: image file is truncated")
            planes.append(np.frombuffer(raw, np.uint8).reshape(h, row))
            at += int(counts[c * h:(c + 1) * h].sum())
    else:
        raise ValueError(f"PSD compression {compression} is not read")
    if mode == "1":
        return as_output("1", unpack_bits(planes[0], 1, w)), info
    a = np.stack(planes, axis=2)
    if mode == "CMYK":
        a = 255 - a
    if mode == "P":
        return from_palette(a[:, :, 0], palette if palette is not None else
                            np.zeros((256, 3), np.uint8)), info
    return as_output(mode, a), info
