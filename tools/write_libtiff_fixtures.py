"""Write the TIFF files libzstd and libtiff make, which the card's machine
cannot (it has no Pillow), for the decoders' tests and chip_smoke 4t (a):

    python3 tools/write_libtiff_fixtures.py

Each file of ``tests/torch_image_files.LIBRARY_FILES`` is Pillow's TIFF of
its numpy pixels, written into ``tests/fixtures/libtiff``.  Needs Pillow.
"""

from __future__ import annotations

import io
import os
import sys

from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tests"))

import torch_image_files as files  # noqa: E402


def main() -> int:
    os.makedirs(files.LIBRARY_DIR, exist_ok=True)
    for fname, (_name, source) in files.LIBRARY_FILES.items():
        pixels, options = source()
        options = dict(options)
        im = Image.fromarray(pixels[:, :, 0] if pixels.shape[2] == 1 else pixels)
        if "mode" in options:
            im = im.convert(options.pop("mode"))
        buf = io.BytesIO()
        im.save(buf, "TIFF", **options)
        with open(os.path.join(files.LIBRARY_DIR, fname), "wb") as fh:
            fh.write(buf.getvalue())
        print(fname, len(buf.getvalue()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
