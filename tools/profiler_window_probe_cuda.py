"""Whether the kernel records a profiler trace loses are the kernels whose
stamps fall before the trace's window opens.

    python3 tools/profiler_window_probe_cuda.py [TRACES]

In one process, after a first trace: TRACES more traces (default 16),
each with the card's and the host's activity around LAUNCHES zero-cycle
spin kernels, every other one with IDLE_S of host idle after the trace
opens.  Per trace, from the profiler's own results: its start; the kernel
launches (the ``cudaLaunchKernel`` records) and the kernel records, matched
by correlation id; the launches with no kernel record, and when they were
made (ms after the start); the earliest kept kernel's stamp (ms after the
start); the time from a launch to its kernel's stamp (least and median: a
negative one means the stamp precedes its own launch).  If the profiler
drops the kernels stamped before its window, the lost launches are the
first ones, no kept stamp precedes the start, and the lost ones were
launched within about minus the least offset of it.  Prints one JSON line
per trace and writes ``$OUT_DIR/profiler_window_probe.json`` (default
``build``).  Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import torch

OUT_DIR = os.environ.get("OUT_DIR", "build")
LAUNCHES = 2000
IDLE_S = 0.05


def _trace(idle: bool) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if idle:
            time.sleep(IDLE_S)
        for _ in range(LAUNCHES):
            torch.cuda._sleep(0)
        torch.cuda.synchronize()
    res = prof.profiler.kineto_results
    start = res.trace_start_ns()
    launches, kernels = {}, {}
    for e in res.events():
        if e.device_type() == DeviceType.CUDA and "spin_kernel" in e.name():
            kernels[e.correlation_id()] = e.start_ns()
        elif e.device_type() == DeviceType.CPU and e.name().startswith(
                ("cudaLaunchKernel", "cuLaunchKernel")):
            launches[e.correlation_id()] = e.start_ns()
    order = sorted(launches, key=launches.get)
    lost = [c for c in order if c not in kernels]
    offsets = [(kernels[c] - launches[c]) / 1e6 for c in order if c in kernels]
    return dict(idle=idle, launches=len(launches), kernels=len(kernels), lost=len(lost),
                lost_are_first=lost == order[:len(lost)],
                lost_launch_ms=[round((launches[c] - start) / 1e6, 3) for c in lost[:3]]
                + ([round((launches[lost[-1]] - start) / 1e6, 3)] if len(lost) > 3 else []),
                first_launch_ms=(launches[order[0]] - start) / 1e6 if order else None,
                first_kept_kernel_ms=(min(kernels.values()) - start) / 1e6 if kernels else None,
                kept_before_start=sum(v < start for v in kernels.values()),
                offset_ms_least=min(offsets) if offsets else None,
                offset_ms_median=statistics.median(offsets) if offsets else None)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    traces = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    torch.cuda._sleep(0)
    first = _trace(False)
    print(json.dumps(dict(first=True, **first)), flush=True)
    rows = []
    for i in range(traces):
        rows.append(_trace(i % 2 == 1))
        print(json.dumps(rows[-1]), flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "profiler_window_probe.json"), "w") as f:
        json.dump({"torch": torch.__version__, "first": first, "traces": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
