"""Time and check the attention kernels of checkouts of sdwebui_tpu_torch on one card.

    python3 tools/attention_ab_cuda.py ROOT [ROOT ...]

Each ROOT is a checkout (the parent commit unpacked with ``git archive``,
say, and ``.``); the roots run in the order given, each in its own process
that imports ``sdwebui_tpu_torch`` from that root and builds its kernels
there, so "parent, change, change, parent" is
``build/parent . . build/parent``.  Every phase-1 attention row of
``chip_smoke.py`` (B1 at ``B1_SHAPES``, B2 and B3 at ``HEAD_SHAPES``) is
timed as chip_smoke times it: the kernel's ms from CUDA events around 5
calls behind a sleep kernel, and the wrapper's host µs per call.  Each row
is also held against the root's plain version, as chip_smoke phase 1 does:
max|Δ|, max|ref| and whether the row is within chip_smoke's bound, so a
checkout with a planted fault shows where the bound catches it.  Prints
one line per row and root, then one JSON object with every reading.
Needs a CUDA card.
"""

from __future__ import annotations

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
    from sdwebui_tpu_torch.ops import flash_attention as fa

    assert fa.__file__.startswith(os.path.join(os.path.abspath(root), "sdwebui_tpu_torch"))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rows = []

    def randn(shape, g, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def record(entry, name, dtype, fn, plain):
        out, ref = fn().float(), plain().float()
        err = (out - ref).abs().max().item()
        ref_max = ref.abs().max().item()
        ok = (err <= cs.ATTN_REL_TOL * ref_max if dtype == torch.bfloat16
              else err <= cs.F32_TOL)
        del out, ref
        rows.append(dict(root=root, entry=entry, name=name, dtype=str(dtype)[6:],
                         max_abs_err=err, max_ref=ref_max, within_bound=ok,
                         ms=cs.cuda_ms(fn), host_us=cs.host_us(fn)))

    for name, bh, sq, skv, d, dtype in cs.B1_SHAPES:
        g = torch.Generator(device=dev).manual_seed(0)
        q, k, v = randn((bh, sq, d), g, dtype), randn((bh, skv, d), g, dtype), \
            randn((bh, skv, d), g, dtype)
        record("flash_attention", name, dtype, lambda: fa.flash_attention(q, k, v),
               lambda: fa.flash_attention_plain(q, k, v))
        del q, k, v
    bf16 = torch.bfloat16
    for name, b, s, h, d in cs.HEAD_SHAPES:
        g = torch.Generator(device=dev).manual_seed(1)
        q, k, v = (randn((b, s, h * d), g, bf16) for _ in range(3))
        record("flash_attention_packed", name, bf16,
               lambda: fa.flash_attention_packed(q, k, v, num_heads=h),
               lambda: fa.flash_attention_packed_plain(q, k, v, num_heads=h))
        q4, k4, v4 = (t.unflatten(-1, (h, d)) for t in (q, k, v))
        record("flash_attention_4d", name, bf16, lambda: fa.flash_attention_4d(q4, k4, v4),
               lambda: fa.flash_attention_4d_plain(q4, k4, v4))
        if name in cs.FUSED_QKV_ROWS:
            qc, kc, vc = randn((b, s, 3 * h * d), g, bf16).chunk(3, dim=-1)
            record("flash_attention_packed", name + "_fused_qkv", bf16,
                   lambda: fa.flash_attention_packed(qc, kc, vc, num_heads=h),
                   lambda: fa.flash_attention_packed_plain(qc, kc, vc, num_heads=h))
        del q, k, v, q4, k4, v4
        torch.cuda.empty_cache()
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
                  f"host {r['host_us']:.1f} µs/call, max|Δ| {r['max_abs_err']:.3e} / max|ref| "
                  f"{r['max_ref']:.3e} = {r['max_abs_err'] / max(r['max_ref'], 1e-30):.3e}"
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
