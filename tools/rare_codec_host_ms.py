"""Host milliseconds of the rarer image decoders on files libtiff, libzstd
and Pillow write (which the card's machine lacks: chip_smoke 4t times the
numpy writers' files there).

    python3 tools/rare_codec_host_ms.py [REPEATS]

Each decode at 512² (a 1728×2200 page for CCITT), the committed
``tests/fixtures/libtiff`` files among them, the median of REPEATS
(default 3) runs, printed as one JSON line.  Needs Pillow.
"""

from __future__ import annotations

import io
import json
import os
import statistics
import sys
import time

import numpy as np
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "tests"))

from sdwebui_tpu_torch.utils.image_io import decode_image  # noqa: E402
import torch_image_files as files  # noqa: E402


def _pillow(a: np.ndarray, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, fmt, **kw)
    return buf.getvalue()


def main() -> int:
    repeats = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:512, 0:512]
    photo = np.clip(np.stack([x // 2, y // 2, (x + y) // 4], 2) + rng.integers(0, 24, (512, 512, 3)),
                    0, 255).astype(np.uint8)
    page = files.scanned_page().astype(bool)
    cases = {
        "tiff_zstd_libzstd": _pillow(photo, "TIFF", compression="zstd"),
        "tiff_zstd_libzstd_one_strip": _pillow(photo, "TIFF", compression="zstd",
                                               tiffinfo={278: 512}),
        "tiff_lzma": _pillow(photo, "TIFF", compression="lzma"),
        "tiff_jpeg": _pillow(photo, "TIFF", compression="jpeg"),
        "tiff_g4_page": _pillow(~page, "TIFF", compression="group4"),
        "tiff_g3_page": _pillow(~page, "TIFF", compression="group3"),
        "qoi": _pillow(photo, "QOI"), "tga_rle": _pillow(photo, "TGA", rle=True),
        "sgi": _pillow(photo, "SGI"), "pcx": _pillow(photo, "PCX"),
        "psd_packbits": files.psd_file(photo.transpose(2, 0, 1), 3, True),
        "sgi_rle": files.sgi_rle_file(photo),
        "dds_bc7": files.dds_file(512, 512, files.bc_blocks(photo, "bc7")[0], dxgi=98),
        "dds_bc6h": files.dds_file(512, 512, rng.integers(0, 256, 128 * 128 * 16,
                                                          dtype=np.uint8).tobytes(), dxgi=95),
        "ppm_p3_plain": b"P3 512 512 255 " + " ".join(map(str, photo.ravel().tolist())).encode(),
    }
    cases.update({name: data for name, (data, _) in files.library_files().items()})
    out = {}
    for name, data in cases.items():
        times = []
        for _ in range(repeats):
            t = time.perf_counter()
            decode_image(data)
            times.append((time.perf_counter() - t) * 1e3)
        out[name] = round(statistics.median(times), 2)
    print(json.dumps({"host_ms": out, "cpus": os.cpu_count()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
