"""Host ms of the JPEG 2000 codec (``utils/jpeg2000``) on the committed
fixtures: Pillow's 512² lossless and 9/7 files decoded, the lossless one's
pixels encoded again (its bytes must be the file's), two small fixtures
decoded, and a 512² image of uniform noise (every bit-plane busy) encoded
and decoded; three runs each.

    python3 tools/jpeg2000_host_ms.py [--phase3]

``--phase3`` adds chip_smoke phase 3's image (SD1.5 txt2img at 512², seed
1234, random weights from seed 0), encoded losslessly and decoded, as a
workload; it needs a CUDA card.  Needs numpy only otherwise (no card, no
Pillow); prints the card's name and power limit first when ``nvidia-smi``
is there.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from sdwebui_tpu_torch.utils.jpeg2000 import decode_jpeg2000, encode_jpeg2000  # noqa: E402

FIXTURES = os.path.join(ROOT, "tests", "fixtures", "jpeg2000")


def _ms(fn, runs: int = 3) -> list:
    out = []
    for _ in range(runs):
        t = time.perf_counter()
        fn()
        out.append(round((time.perf_counter() - t) * 1e3, 1))
    return out


def _phase3_image() -> np.ndarray:
    """chip_smoke phase 3's first image, made on the card as phase 3 makes it."""
    import torch

    import chip_smoke as cs
    from sdwebui_tpu_torch.pipeline.sd_model import create_random_sd15
    from sdwebui_tpu_torch.server.app import Engine
    from sdwebui_tpu_torch.utils.options import opts

    cs.phase_env()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    opts.data["persistent_cond_cache"] = False
    model = create_random_sd15(seed=0, device=torch.device("cuda"))
    engine = Engine(model=model, device=torch.device("cuda"))
    return cs.phase_serve(engine, model)[0]["image"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phase3", action="store_true", help="add phase 3's image (needs a card)")
    args = ap.parse_args()
    try:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    except OSError:
        print("no nvidia-smi: not a card's host", flush=True)
    files = {n: open(os.path.join(FIXTURES, n), "rb").read()
             for n in ("pillow_512_lossless.jp2", "pillow_512_irreversible.jp2", "style_all.j2k",
                       "ppm.j2k")}
    pixels = decode_jpeg2000(files["pillow_512_lossless.jp2"])[0]
    if encode_jpeg2000(pixels, "jp2") != files["pillow_512_lossless.jp2"]:
        raise SystemExit("the 512² encode is not Pillow's file")
    images = {"512² noise": np.random.default_rng(0).integers(0, 256, (512, 512, 3),
                                                             dtype=np.uint8)}
    if args.phase3:
        images["phase 3's 512² image"] = _phase3_image()
    work = {f"decode {name}": (lambda data=data: decode_jpeg2000(data))
            for name, data in files.items()}
    work["encode 512² (Pillow's bytes)"] = lambda: encode_jpeg2000(pixels, "jp2")
    for name, image in images.items():
        data = encode_jpeg2000(image, "jp2")
        print(f"{name}: {len(data)} bytes as a lossless .jp2", flush=True)
        work[f"encode {name}"] = lambda image=image: encode_jpeg2000(image, "jp2")
        work[f"decode {name}"] = lambda data=data: decode_jpeg2000(data)
    print(json.dumps({"host_ms": {name: _ms(fn) for name, fn in work.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
