"""Reading image bytes as the JAX package's Pillow does: PNG (``utils/png``)
and JPEG (``utils/jpeg``).  The other formats Pillow reads raise
``UnsupportedImageFormat`` naming theirs (GIF, BMP, WebP and TIFF are not
ported yet)."""

from __future__ import annotations

import numpy as np

from sdwebui_tpu_torch.utils.jpeg import decode_jpeg
from sdwebui_tpu_torch.utils.png import decode_png

#: magic bytes of the formats the port does not read yet
OTHER_FORMATS = ((b"GIF8", "GIF"), (b"BM", "BMP"), (b"RIFF", "WEBP"), (b"II*\x00", "TIFF"),
                 (b"MM\x00*", "TIFF"))


class UnsupportedImageFormat(ValueError):
    """Image bytes of a format the port does not read; ``fmt`` names it."""

    def __init__(self, fmt: str):
        super().__init__(f"a {fmt} image; the port reads PNG and JPEG only")
        self.fmt = fmt


def decode_image(data: bytes) -> tuple[np.ndarray, dict]:
    """PNG or JPEG bytes → (uint8 (H, W, C), info): a PNG's text chunks, or
    what Pillow's JPEG reader puts in ``img.info``."""
    if data.startswith(b"\x89PNG"):
        return decode_png(data)
    if data.startswith(b"\xff\xd8"):
        return decode_jpeg(data)
    for magic, fmt in OTHER_FORMATS:
        if data.startswith(magic):
            raise UnsupportedImageFormat(fmt)
    raise ValueError("not a PNG or JPEG image")


def read_image_file(path: str) -> tuple[np.ndarray, dict]:
    with open(path, "rb") as f:
        return decode_image(f.read())
