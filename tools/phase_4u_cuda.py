"""chip_smoke's phase 4u (JPEG 2000) alone, after phase 3's server
requests.

    python3 tools/phase_4u_cuda.py

Runs ``phase_env``, phase 3's requests on a random SD1.5 behind an
in-process server, then ``phase_jpeg2000`` on the first of them: every
committed fixture decoded with its host ms, phase 3's request again saving
its image as a lossless .jp2 (the encode's host ms), img2img from that
file, txt2img saving jp2 samples and a j2k grid, a PDF of an RGBA image.
Logs as chip_smoke does and prints 4u's seconds.  Needs a CUDA card.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from sdwebui_tpu_torch.pipeline.sd_model import create_random_sd15  # noqa: E402
from sdwebui_tpu_torch.server.app import Engine  # noqa: E402
from sdwebui_tpu_torch.utils.options import opts  # noqa: E402


def main() -> int:
    t_all = time.perf_counter()
    cs.phase_env()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    opts.data["persistent_cond_cache"] = False
    model = create_random_sd15(seed=0, device=torch.device("cuda"))
    engine = Engine(model=model, device=torch.device("cuda"))
    results = cs.phase_serve(engine, model)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        cs.phase_jpeg2000(engine, model, results[0], d)
    print(f"4u seconds {time.perf_counter() - t0:.1f}; all {time.perf_counter() - t_all:.1f}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
