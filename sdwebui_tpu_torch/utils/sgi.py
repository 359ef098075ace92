"""SGI image reading and writing on numpy, as Pillow's ``SgiImagePlugin``
(and its ``sgi_rle`` decoder) does.

The reader takes verbatim and RLE files at 1 and 2 bytes a sample, grey,
RGB and RGBA (16-bit samples by their high byte, Pillow's "L;16B"), rows
bottom-up.  A layout Pillow does not know raises ``ValueError``, as
Pillow's plugin does.

The writer gives Pillow's bytes for grey, RGB and RGBA images: verbatim, one
byte a sample, the file's base name in the header (Pillow writes the name
of the file it saves to: a caller that writes through a temporary file
passes that file's name)."""

from __future__ import annotations

import os
import struct

import numpy as np

from sdwebui_tpu_torch.utils.png import check_image_size

#: (bytes a sample, dimension, zsize) → Pillow's mode
_MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L", (2, 2, 1): "L", (1, 3, 3): "RGB",
          (2, 3, 3): "RGB", (1, 3, 4): "RGBA", (2, 3, 4): "RGBA"}


def accept(prefix: bytes) -> bool:
    return len(prefix) >= 2 and struct.unpack_from(">H", prefix)[0] == 474


def _rle_row(data: bytes, pos: int, n: int, xsize: int, bpc: int) -> np.ndarray:
    """Pillow's ``expandrow`` / ``expandrow2``: one row of `n` bytes."""
    out = np.zeros(xsize, np.uint16 if bpc == 2 else np.uint8)
    x = 0
    fmt = ">H" if bpc == 2 else ">B"
    end = len(data)
    for left in range(n, 0, -1):
        if pos + bpc > end:
            raise ValueError("SGI: RLE row runs past the data")
        (pixel,) = struct.unpack_from(fmt, data, pos)
        pos += bpc
        if left == 1 and pixel != 0:
            break
        count = pixel & 0x7F
        if not count:
            break
        if x + count > xsize:
            raise ValueError("SGI: RLE row longer than the image")
        if pixel & 0x80:
            if pos + count * bpc > end:
                raise ValueError("SGI: RLE row runs past the data")
            out[x:x + count] = np.frombuffer(data, fmt[0] + ("u2" if bpc == 2 else "u1"),
                                             count, pos)
            pos += count * bpc
        else:
            if pos + bpc > end:
                raise ValueError("SGI: RLE row runs past the data")
            out[x:x + count] = struct.unpack_from(fmt, data, pos)[0]
            pos += bpc
        x += count
    return out


def decode_sgi(data: bytes) -> tuple[np.ndarray, dict]:
    """SGI bytes → (uint8 (H, W, 1|3|4), {})."""
    if len(data) < 512 or not accept(data):
        raise ValueError("Not an SGI image file")
    compression, bpc = data[2], data[3]
    dimension, xsize, ysize, zsize = struct.unpack_from(">HHHH", data, 4)
    mode = _MODES.get((bpc, dimension, zsize))
    if mode is None:
        raise ValueError("Unsupported SGI image mode")
    check_image_size(xsize, ysize)
    z = len(mode)
    if compression == 0:
        need = xsize * ysize * bpc * z
        if len(data) < 512 + need:
            raise ValueError("SGI: image file is truncated")
        planes = np.frombuffer(data, ">u2" if bpc == 2 else np.uint8, xsize * ysize * z, 512)
        planes = planes.reshape(z, ysize, xsize)
    elif compression == 1:
        table = np.frombuffer(data, ">u4", 2 * ysize * zsize, 512)
        starts, lengths = table[:ysize * zsize], table[ysize * zsize:]
        planes = np.stack([np.stack([_rle_row(data, int(starts[c * ysize + y]),
                                              int(lengths[c * ysize + y]), xsize, bpc)
                                     for y in range(ysize)]) for c in range(z)])
    else:
        raise ValueError(f"SGI compression {compression} is not read")
    if bpc == 2:
        planes = planes >> 8
    image = np.ascontiguousarray(planes.transpose(1, 2, 0)[::-1]).astype(np.uint8)
    return image, {}


def encode_sgi(image: np.ndarray, filename: str = "") -> bytes:
    """uint8 (H, W, 1|3|4) → Pillow's verbatim SGI bytes; `filename` is
    the file the bytes are written to (its base name goes in the header)."""
    a = np.asarray(image)
    if a.ndim == 2:
        a = a[:, :, None]
    h, w, c = a.shape
    if c == 2:
        raise ValueError("Unsupported SGI image mode")
    dimension = (1 if h == 1 else 2) if c == 1 else 3
    name = os.path.splitext(os.path.basename(filename))[0].encode("ascii", "ignore")
    head = (struct.pack(">hBBHHHHll", 474, 0, 1, dimension, w, h, c, 0, 255) + bytes(4)
            + struct.pack("79s", name) + b"\0" + struct.pack(">l", 0) + bytes(404))
    return head + np.ascontiguousarray(a[::-1].transpose(2, 0, 1)).tobytes()
