"""Reading image bytes as the JAX package's Pillow does: the format told by
its first bytes, then its decoder: PNG (``utils/png``), JPEG
(``utils/jpeg``), GIF (``utils/gif``), BMP and headerless DIB
(``utils/bmp``), TIFF (``utils/tiff``) and WebP (``utils/webp``).  Each
gives uint8 (H, W, C) pixels as Pillow's ``convert`` sees the mode
``Image.open`` gives (grey, grey + alpha, RGB or RGBA; palettes expanded)
and the ``info`` Pillow fills.  The other formats Pillow reads whose first
bytes tell them (AVIF and the rarer ones in ``OTHER_FORMATS``) raise
``UnsupportedImageFormat`` naming theirs."""

from __future__ import annotations

import struct

import numpy as np

from sdwebui_tpu_torch.utils.bmp import decode_bmp
from sdwebui_tpu_torch.utils.gif import decode_gif
from sdwebui_tpu_torch.utils.jpeg import decode_jpeg
from sdwebui_tpu_torch.utils.png import decode_png
from sdwebui_tpu_torch.utils.tiff import decode_tiff
from sdwebui_tpu_torch.utils.webp import decode_webp

#: magic bytes (at offset 0, or 4 for the ISO-BMFF brands) of formats Pillow
#: reads and the port does not
OTHER_FORMATS = ((b"ftypavif", "AVIF"), (b"ftypavis", "AVIF"), (b"8BPS", "PSD"),
                 (b"\x00\x00\x00\x0cjP  \r\n\x87\n", "JPEG 2000"), (b"\xff\x4f\xff\x51", "JPEG 2000"),
                 (b"DDS ", "DDS"), (b"qoif", "QOI"), (b"icns", "ICNS"), (b"\x00\x00\x01\x00", "ICO"),
                 (b"\x00\x00\x02\x00", "CUR"), (b"\x01\xda", "SGI"), (b"P1", "PPM"), (b"P2", "PPM"),
                 (b"P3", "PPM"), (b"P4", "PPM"), (b"P5", "PPM"), (b"P6", "PPM"), (b"P7", "PPM"),
                 (b"Pf", "PFM"), (b"PF", "PFM"))
#: the DIB header sizes Pillow's DIB reader takes as a headerless BMP
_DIB_HEADERS = (12, 40, 52, 56, 64, 108, 124)


class UnsupportedImageFormat(ValueError):
    """Image bytes of a format the port does not read; ``fmt`` names it."""

    def __init__(self, fmt: str):
        super().__init__(f"a {fmt} image; the port reads PNG, JPEG, GIF, BMP, TIFF and WebP")
        self.fmt = fmt


def other_format(data: bytes) -> str | None:
    """The name of a format Pillow reads and the port does not, or None."""
    for magic, fmt in OTHER_FORMATS:
        if data.startswith(magic) or (magic.startswith(b"ftyp") and data[4:12] == magic):
            return fmt
    if data[:1] == b"\x0a" and data[1:2] in (b"\x00", b"\x02", b"\x03", b"\x04", b"\x05"):
        return "PCX"
    return None


def decode_image(data: bytes) -> tuple[np.ndarray, dict]:
    """Image bytes → (uint8 (H, W, C), info)."""
    if data.startswith(b"\x89PNG"):
        return decode_png(data)
    if data.startswith(b"\xff\xd8"):
        return decode_jpeg(data)
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return decode_gif(data)
    if data.startswith(b"BM"):
        return decode_bmp(data)
    if data[:4] in (b"II*\x00", b"MM\x00*"):
        return decode_tiff(data)
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return decode_webp(data)
    fmt = other_format(data)
    if fmt is not None:
        raise UnsupportedImageFormat(fmt)
    if len(data) >= 16 and struct.unpack_from("<I", data)[0] in _DIB_HEADERS:
        return decode_bmp(data, dib=True)
    raise ValueError("not an image of a format the port reads")


def read_image_file(path: str) -> tuple[np.ndarray, dict]:
    with open(path, "rb") as f:
        return decode_image(f.read())
