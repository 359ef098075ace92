"""Where the MiDaS DPT-hybrid forward's time goes on one card (f32, TF32 off).

    python3 tools/midas_probe_cuda.py

- the forward at 384² (the tower at the published widths, random weights)
  in ms, and its device time by aten op and input shape under
  ``torch.profiler`` (the ten ops with the most device time);
- the tower's 3x3 convs with the largest outputs (the head's 256 → 128 at
  192², 128 → 32 at 384², a fusion block's 256 → 256 at 96²), each in the
  four layouts of input and weight (NCHW or channels-last) with cuDNN's
  heuristic and with ``cudnn.benchmark``, and with cuDNN off (PyTorch's
  own im2col + GEMM), in ms, with max|Δ|/max|ref| against float64.
Needs a CUDA card.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

CONVS = ((256, 128, 192), (128, 32, 384), (256, 256, 96))


def ms(fn, calls: int = 5) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e3


def forward(device):
    from torch.profiler import ProfilerActivity, profile

    from sdwebui_tpu_torch.models.midas import create_random_dpt

    tower = create_random_dpt(0, device)
    x = torch.rand((1, 3, 384, 384), device=device) * 2 - 1
    with torch.inference_mode():
        print(f"DPT-hybrid forward at 384², f32: {ms(lambda: tower(x)):.2f} ms", flush=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            tower(x)
            torch.cuda.synchronize()
    print(prof.key_averages(group_by_input_shape=True).table(
        sort_by="self_cuda_time_total", row_limit=10, max_name_column_width=50,
        max_shapes_column_width=70), flush=True)


def convs(device):
    g = torch.Generator(device=device).manual_seed(0)
    cl = torch.channels_last
    for cin, cout, hw in CONVS:
        x = torch.randn((1, cin, hw, hw), generator=g, device=device)
        w = torch.randn((cout, cin, 3, 3), generator=g, device=device) * 0.02
        b = torch.randn((cout,), generator=g, device=device)
        ref = F.conv2d(x.double(), w.double(), b.double(), 1, 1)
        layouts = (("NCHW/NCHW", x, w),
                   ("CL/CL", x.contiguous(memory_format=cl), w.contiguous(memory_format=cl)),
                   ("CL/NCHW", x.contiguous(memory_format=cl), w),
                   ("NCHW/CL", x, w.contiguous(memory_format=cl)))
        for name, xi, wi in layouts:
            for bench in (False, True):
                torch.backends.cudnn.benchmark = bench
                t = ms(lambda: F.conv2d(xi, wi, b, 1, 1))
                out = F.conv2d(xi, wi, b, 1, 1).double()
                err = ((out - ref).abs().max() / ref.abs().max()).item()
                print(f"conv3x3 {cin}->{cout} at {hw}² input/weight {name}, cudnn.benchmark "
                      f"{bench}: {t:.3f} ms, max|Δ|/max|ref| {err:.2e}", flush=True)
        torch.backends.cudnn.benchmark = False
        with torch.backends.cudnn.flags(enabled=False):
            t = ms(lambda: F.conv2d(x, w, b, 1, 1))
            err = ((F.conv2d(x, w, b, 1, 1).double() - ref).abs().max() / ref.abs().max()).item()
        print(f"conv3x3 {cin}->{cout} at {hw}² NCHW, cuDNN off: {t:.3f} ms, max|Δ|/max|ref| "
              f"{err:.2e}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("midas_probe_cuda: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    device = torch.device("cuda")
    forward(device)
    convs(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
