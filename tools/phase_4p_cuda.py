"""chip_smoke's phase 4p (the page and the checkpoint merger) alone.

    python3 tools/phase_4p_cuda.py

Builds the kernels (phase 0), serves phase 3's config 1 requests on the
random SD1.5 for the seed-1234 image that 4p holds the Add difference
merge to, runs one profiled request (so that 4p's trace is not the
process's first, as in the whole script), then runs ``phase_ui`` in a
temporary directory.  Logs as
chip_smoke does and writes ``$OUT_DIR/phase_4p.json`` (default ``build``).  Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as c  # noqa: E402
from sdwebui_tpu_torch.pipeline.sd_model import create_random_sd15  # noqa: E402
from sdwebui_tpu_torch.server.app import Engine  # noqa: E402
from sdwebui_tpu_torch.utils.options import opts  # noqa: E402

OUT_DIR = os.environ.get("OUT_DIR", "build")


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    opts.data["persistent_cond_cache"] = False
    smi = c.phase_env()
    device = torch.device("cuda")
    model = create_random_sd15(seed=0, device=device)
    engine = Engine(model=model, device=device)
    results = c.phase_serve(engine, model)
    # a profiler session before 4p's, as the whole script's earlier phases make
    c.phase_profile(engine, dict(c.SD15_BASE, seed=7, batch_size=1), "earlier session")
    del engine
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ui_") as d:
        ui_results, ui_info = c.phase_ui(model, device, results[0], d)
    seconds = time.perf_counter() - t0
    c.log(f"phase 4p: {seconds:.1f} s")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "phase_4p.json"), "w") as f:
        json.dump({"card": smi, "ui": ui_info, "seconds_4p": seconds,
                   "requests": [{k: v for k, v in r.items()
                                 if k not in ("image", "png_b64", "extras")}
                                for r in ui_results]}, f, default=str, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
