"""Probe the attention kernels of csrc/flash_attention.cu on one card.

    python3 tools/attention_probe_cuda.py [ptxas] [host]

- ptxas: compiles the source with ``-Xptxas -v`` and prints what ptxas
  says of each kernel (registers, spills, and its notes on serialised
  wgmma), then chip_smoke's count of HGMMA (wgmma) and UTMALDG (TMA load)
  instructions in each kernel's SASS;
- host: where a B2 call's host time goes (µs per call over 2000 calls):
  the whole wrapper, the bare C call, and each piece of the Python around
  it.
No argument runs both.  Exits non-zero if the build fails.  Kernel times
are chip_smoke.py phase 1's (``tools/attention_ab_cuda.py .`` runs its
attention rows alone); whether the kernels are right is for the CUDA tests
and chip_smoke.py.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from sdwebui_tpu_torch.ops import _build  # noqa: E402
from sdwebui_tpu_torch.ops import flash_attention as fa  # noqa: E402


def ptxas(name: str = "flash_attention") -> bool:
    """Compile csrc/<name>.cu with -Xptxas -v; print ptxas's report and the
    SASS counts of each kernel."""
    src = _build._CSRC / f"{name}.cu"
    with tempfile.TemporaryDirectory() as tmp:
        lib = os.path.join(tmp, "probe.so")
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", lib,
                               str(src)], capture_output=True, text=True)
        for line in proc.stderr.splitlines():
            if "Function properties" not in line and "bytes gmem" not in line:
                print(line, flush=True)
        if proc.returncode != 0:
            return False
        print(json.dumps(chip_smoke.sass_counts(lib), indent=1), flush=True)
    return True


def host() -> bool:
    dev = torch.device("cuda")
    q, k, v = torch.randn((2, 1024, 3 * 320), device=dev).to(torch.bfloat16).chunk(3, dim=-1)
    out = torch.empty((2, 1024, 320), dtype=torch.bfloat16, device=dev)
    fn = fa._lib()
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 0, 2, 8, 1024, 1024, 40,
            q.stride(0), 40, q.stride(1), k.stride(0), 40, k.stride(1), v.stride(0), 40,
            v.stride(1), out.stride(0), 40, out.stride(1), 1 / math.sqrt(40),
            torch.cuda.current_stream().cuda_stream)

    def us(call, n=2000):
        for _ in range(50):
            call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt / n * 1e6

    def guard_and_stream():
        with torch.cuda.device(q.device):
            return torch.cuda.current_stream(q.device).cuda_stream

    for label, call in [
            ("the wrapper (B2, d = 40)", lambda: fa.flash_attention_packed(q, k, v, num_heads=8)),
            ("the C call: 3 tensor maps + launch", lambda: fn(*args)),
            ("torch.empty of the output", lambda: torch.empty((2, 1024, 320),
                                                              dtype=torch.bfloat16, device=dev)),
            ("the 16-byte check (_operands)", lambda: fa._operands(q, k, v)),
            ("the shape checks (_check_packed)", lambda: fa._check_packed(q, k, v, 8)),
            ("the device guard and stream", guard_and_stream),
            ("pointers and strides", lambda: [(t.data_ptr(), t.stride(0), t.stride(1))
                                              for t in (q, k, v, out)])]:
        print(f"host {label}: {us(call):.1f} µs/call", flush=True)
    return True


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    steps = {"ptxas": ptxas, "host": host}
    chosen = argv or list(steps)
    unknown = [a for a in chosen if a not in steps]
    if unknown:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return 0 if all(steps[a]() for a in chosen) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
