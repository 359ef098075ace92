"""Time and check the LayerNorm (B5) and 3x3 conv (B4) kernels of checkouts
of sdwebui_tpu_torch on one card.

    python3 tools/norms_conv_ab_cuda.py ROOT [ROOT ...]

Each ROOT is a checkout (the parent commit unpacked with ``git archive``,
say, and ``.``); the roots run in the order given, each in its own process
that imports ``sdwebui_tpu_torch`` from that root and builds its kernels
there, so "parent, change, change, parent" is
``build/parent . . build/parent``.  Every phase-1 B5 and B4 row of
``chip_smoke.py`` (``layer_norm_cases``, ``conv_cases``: the same inputs)
is timed as chip_smoke times it: the kernel's ms from CUDA events around 5
calls behind a sleep kernel, and the wrapper's host µs per call.  Each row
is also held against the root's plain version with chip_smoke's bound
(``chip_smoke.agreement``), so a checkout with a planted fault shows where
the bound catches it.  Prints one line per row and root, then one JSON
object with every reading.  Needs a CUDA card.
"""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def worker(root: str) -> list:
    import torch

    sys.path.insert(0, REPO)        # this tree's chip_smoke: the rows and the timers
    import chip_smoke as cs

    sys.path[0] = os.path.abspath(root)   # the root's kernels
    from sdwebui_tpu_torch.ops import conv, layer_norm

    for mod in (conv, layer_norm):
        assert mod.__file__.startswith(os.path.join(os.path.abspath(root), "sdwebui_tpu_torch"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rows = []
    # one case at a time: each case's tensors are its generator's locals
    for case in itertools.chain(cs.layer_norm_cases(dev), cs.conv_cases(dev)):
        out, ref = case["kernel"](), case["plain"]()
        torch.cuda.synchronize()
        agree = cs.agreement(out, ref, case["dtype"], case.get("rel_tol"), case.get("ulp_tol"))
        del out, ref
        rows.append(dict(root=root, entry=case["entry"], name=case["name"],
                         dtype=str(case["dtype"])[6:], text=agree["text"],
                         max_abs_err=agree["max_abs_err"], rel_err=agree["rel_err"],
                         ulps=agree["ulps"], within_bound=agree["ok"],
                         ms=cs.cuda_ms(case["kernel"]), host_us=cs.host_us(case["kernel"])))
    return rows


def main(roots) -> int:
    if not roots:
        print(__doc__)
        return 2
    readings = []
    for root in roots:
        proc = subprocess.run([sys.executable, __file__, "--worker", root],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return proc.returncode
        rows = json.loads(proc.stdout.strip().splitlines()[-1])
        for r in rows:
            print(f"{root} {r['entry']} {r['name']} {r['dtype']}: {r['ms']:.4f} ms, "
                  f"host {r['host_us']:.1f} µs/call, {r['text']}"
                  f"{'' if r['within_bound'] else ', OUTSIDE the bound'}", flush=True)
        readings += rows
    print(json.dumps({"card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), "rows": readings}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        print(json.dumps(worker(sys.argv[2])))
        sys.exit(0)
    sys.exit(main(sys.argv[1:]))
