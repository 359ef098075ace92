"""chip_smoke's phase 4q (the parallel runtime) alone, with phase 1's rows
at the shapes 4q gives the kernels.

    python3 tools/phase_4q_cuda.py [threads]

Builds the kernels (phase 0), checks and times B1 at (1, 4096, 16384, 512)
and B2 at (2, 4096, 4·40) and (2, 1024, 4·80) in bf16 and f32 against
their plain versions (phase 1's rows of 4q), then runs ``phase_parallel``
on a random SD1.5 behind an in-process server; with ``threads``, then
4q (a)'s data=4 request with its shards on threads against in turn.
Logs as chip_smoke does and writes ``$OUT_DIR/phase_4q.json`` (default
``build``).  Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as c  # noqa: E402
from sdwebui_tpu_torch.pipeline.sd_model import create_random_sd15  # noqa: E402
from sdwebui_tpu_torch.server.app import Engine  # noqa: E402
from sdwebui_tpu_torch.utils.options import opts  # noqa: E402

OUT_DIR = os.environ.get("OUT_DIR", "build")


def kernel_rows(device) -> list:
    """Phase 1 over 4q's rows only."""
    c.B1_SHAPES = [r for r in c.B1_SHAPES if r[0].startswith("vae_rows4")]
    c.B1_BLOCKED_SHAPES = []
    c.HEAD_SHAPES = [r for r in c.HEAD_SHAPES if r[0].startswith("sd15_tp2")]
    c.F32_HEAD_SHAPES = [r for r in c.F32_HEAD_SHAPES if r[0].startswith("sd15_tp2")]
    c.b1_at_ldsr_512 = lambda device: None
    c.layer_norm_cases = lambda device: []
    c.conv_cases = lambda device: []
    return c.phase_kernel(device)


def data_parallel_on_threads(engine, model) -> dict:
    """4q (a)'s data=4 request with the shards on threads (``Group.run``)
    against one after another (``Group.map``), each warm, twice."""
    from sdwebui_tpu_torch.parallel import collectives, mesh

    card = torch.device("cuda", torch.cuda.current_device())
    body = dict(c.SD15_BASE, seed=4321, batch_size=c.DP_DATA)
    out = {}
    real = collectives.Group.map
    try:
        mesh.set_runtime(mesh.MeshRuntime.create(data=c.DP_DATA, devices=[card] * c.DP_DATA))
        with c._server(engine) as url:
            for arm in ("sequential", "threads", "threads", "sequential"):
                collectives.Group.map = real if arm == "sequential" else collectives.Group.run
                r = c._request(url, "txt2img", body, c._sd15_check, 512, f"4q threads {arm}")
                out.setdefault(arm, []).append(r["seconds"])
    finally:
        collectives.Group.map = real
        mesh.set_runtime(None)
    c.log(f"4q data=4 on one card, seconds a request: {out}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    opts.data["persistent_cond_cache"] = False
    smi = c.phase_env()
    device = torch.device("cuda")
    rows = kernel_rows(device)
    model = create_random_sd15(seed=0, device=device)
    engine = Engine(model=model, device=device)
    t0 = time.perf_counter()
    results, info = c.phase_parallel(engine, model, device)
    seconds = time.perf_counter() - t0
    c.log(f"phase 4q: {seconds:.1f} s")
    if "threads" in sys.argv[1:]:
        info["threads"] = data_parallel_on_threads(engine, model)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "phase_4q.json"), "w") as f:
        json.dump({"card": smi, "kernel_rows": rows, "parallel": info, "seconds_4q": seconds,
                   "requests": [{k: v for k, v in r.items()
                                 if k not in ("image", "png_b64", "extras", "all_images")}
                                for r in results]}, f, default=str, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
