"""Probe the LayerNorm (B5) and 3x3 conv (B4) kernels on one card.

    python3 tools/norms_conv_probe_cuda.py [ptxas] [host] [splits]

- ptxas: compiles csrc/conv3x3.cu and csrc/layer_norm.cu with ``-Xptxas -v``
  and prints what ptxas says of each kernel (registers, spills, serialised
  wgmma notes) and the HGMMA / UTMALDG counts of each kernel's SASS;
- host: where a B5 call's host time goes at SDXL base's (2048, 1280) bf16
  LayerNorm, the path's most frequent (µs per call over 2000 calls, the
  launches queued on an idle stream): the whole wrapper, ``F.layer_norm``
  on the same tensors, the bare C call, and each piece of the Python around
  it;
- splits: the clusters of 1-8 blocks of the bf16 conv kernel the card
  holds at once (``conv.card_capacity``), and B4 bf16 at chip_smoke's
  phase-1 rows with fewer output tiles than SMs, timed at every k-step
  split 1-8 (``conv_plan``'s choice overridden), beside ``F.conv2d``: what
  the split rule picks against what each split reads.
No argument runs all three.  Exits non-zero if a build fails.  Kernel times are
chip_smoke.py phase 1's (``tools/norms_conv_ab_cuda.py .`` runs its B4 and
B5 rows alone).  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke  # noqa: E402
from sdwebui_tpu_torch.ops import conv  # noqa: E402
from sdwebui_tpu_torch.ops import layer_norm as ln  # noqa: E402
from sdwebui_tpu_torch.ops import norms  # noqa: E402
from tools import attention_probe_cuda  # noqa: E402


def ptxas() -> bool:
    return all(attention_probe_cuda.ptxas(name) for name in ("conv3x3", "layer_norm"))


def host() -> bool:
    dev = torch.device("cuda")
    rows, c = 2048, 1280
    x = torch.randn((2, rows // 2, c), device=dev).to(torch.bfloat16)
    w = torch.randn((c,), device=dev).to(torch.bfloat16)
    b = torch.randn((c,), device=dev).to(torch.bfloat16)
    out = torch.empty_like(x)
    fn = ln._fn or ln._bind()
    lanes, chunks = ln.ln_plan(c, 2)
    stream = torch._C._cuda_getCurrentRawStream(0)
    args = (x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), 0, 0, rows, c, c, c,
            1e-5, lanes, chunks, stream)

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

    for label, call in [
            ("the wrapper (B5, 2048 x 1280 bf16)", lambda: ln.layer_norm(x, w, b)),
            ("F.layer_norm on the same tensors", lambda: F.layer_norm(x, (c,), w, b, 1e-5)),
            ("the path's dispatch (ops/norms.layer_norm)", lambda: norms.layer_norm(x, w, b)),
            ("the C call alone", lambda: fn(*args)),
            ("the C call refused at once (rows = 0: ctypes' marshalling only)",
             lambda: fn(*args[:6], 0, *args[7:])),
            ("torch.empty_like of the output",
             lambda: torch.empty_like(x, memory_format=torch.contiguous_format)),
            ("the checks (_check)", lambda: ln._check(x, w, b)),
            ("pointers (4 data_ptr)", lambda: (x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                               out.data_ptr())),
            ("device test and raw stream",
             lambda: x.get_device() == torch._C._cuda_getDevice()
             and torch._C._cuda_getCurrentRawStream(0))]:
        print(f"host {label}: {us(call):.2f} µs/call", flush=True)
    return True


def splits() -> bool:
    dev = torch.device("cuda")
    chosen = conv.conv_splits
    try:
        for name, bsz, h, w, cin, cout in chip_smoke.CONV_SHAPES:
            capacity = conv.card_capacity(dev, conv.conv_bn(cout))
            plan = conv.conv_plan(bsz, h, w, cin, cout, capacity)
            tiles = plan.grid[1] * plan.grid[2]
            print(f"splits {name}: clusters of 1..8 blocks the card holds at once "
                  f"{capacity}", flush=True)
            if tiles >= capacity[0]:
                continue
            g = torch.Generator(device=dev).manual_seed(3)
            cl = torch.channels_last
            x = torch.randn((bsz, cin, h, w), generator=g, device=dev).to(
                torch.bfloat16).contiguous(memory_format=cl)
            wt = (torch.randn((cout, cin, 3, 3), generator=g, device=dev) * 0.05).to(
                torch.bfloat16).contiguous(memory_format=cl)
            lib = chip_smoke.cuda_ms(lambda: F.conv2d(x, wt, None, 1, 1))
            times = {}
            for s in range(1, min(8, plan.ksteps) + 1):
                conv.conv_splits = lambda *_, s=s: s
                times[s] = chip_smoke.cuda_ms(lambda: conv.conv3x3(x, wt))
            conv.conv_splits = chosen
            print(f"splits {name}: {tiles} tiles, plan {plan.splits}; ms by split "
                  + ", ".join(f"{s}: {t:.4f}" for s, t in times.items())
                  + f"; F.conv2d {lib:.4f}", flush=True)
    finally:
        conv.conv_splits = chosen
    return True


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    steps = {"ptxas": ptxas, "host": host, "splits": splits}
    chosen = argv or list(steps)
    if any(a not in steps for a in chosen):
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return 0 if all(steps[a]() for a in chosen) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
