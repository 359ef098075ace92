"""Which kernel records a profiled request's Chrome trace loses, and why.

    python3 tools/profiler_trace_probe_cuda.py [ROUNDS]

On the random-weight SD1.5 server (512², Euler a, 20 steps), one txt2img
request with ``profiling_enable`` in each arm, in ROUNDS rounds (default 3).
A profiler session runs in the process before the first round and three
between rounds (chip_smoke's ``phase_profile``), since a process's first
trace has lost nothing.  The arms open and close the trace in different
ways (``ARMS``), with the host's activity ("cpu") and with the card's alone
("cuda"):

    plain   torch.profiler around the request, as the profiler's docs do
    sync    the same, with the card drained before the trace opens and
            before it closes
    idle    sync, and the card left idle for IDLE_S after the trace opens
    warmup  sync, a profiler schedule whose warmup step (CUPTI on, records
            dropped) lasts IDLE_S before the recording step opens
    pad     the settle of utils/profiling before this tool: 256 tiny
            kernels and IDLE_S of idle after the trace opens

Per trace: the LayerNorm, B2 and B1 kernels it names (the request launches
986, 200 and 1), every kernel, the index of the CLIP embedding's gather
(the request's first kernel), the request's seconds, and with the host's
activity the kernel launches the trace records, the launches with no kernel
record, where they stand (ms after the first launch) and the least and
median time from a launch to its kernel's start.  Writes
``$OUT_DIR/profiler_trace_probe.json`` (default ``build``).  Needs a CUDA card.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as c  # noqa: E402
from sdwebui_tpu_torch.pipeline.sd_model import create_random_sd15  # noqa: E402
from sdwebui_tpu_torch.server.app import Engine  # noqa: E402
from sdwebui_tpu_torch.utils import profiling  # noqa: E402
from sdwebui_tpu_torch.utils.options import opts  # noqa: E402

OUT_DIR = os.environ.get("OUT_DIR", "build")
IDLE_S = 0.05
PAD_KERNELS = 256


def _arm(kind: str):
    """A stand-in for utils/profiling.profile that opens and closes the
    trace as `kind` says."""
    from torch.profiler import ProfilerActivity, schedule
    from torch.profiler import profile as torch_profile

    @contextlib.contextmanager
    def profile(trace, device):
        acts = [ProfilerActivity.CUDA]
        if "CPU" in list(trace["profiling_activities"] or []):
            acts.append(ProfilerActivity.CPU)
        kw = dict(activities=acts, record_shapes=False, profile_memory=False, with_stack=False)
        if kind != "plain":
            torch.cuda.synchronize()
        if kind == "warmup":
            kw["schedule"] = schedule(wait=0, warmup=1, active=1)
        with torch_profile(**kw) as prof:
            if kind == "warmup":
                time.sleep(IDLE_S)
                prof.step()
            elif kind == "pad":
                x = torch.zeros(1, device=device)
                for _ in range(PAD_KERNELS):
                    x.add_(1)
                torch.cuda.synchronize()
                time.sleep(IDLE_S)
            elif kind == "idle":
                time.sleep(IDLE_S)
            yield trace["profiling_filename"]
            if kind != "plain":
                torch.cuda.synchronize()
        prof.export_chrome_trace(trace["profiling_filename"])
    return profile


ARMS = [("plain", "cpu"), ("plain", "cuda"), ("sync", "cpu"), ("idle", "cpu"),
        ("idle", "cuda"), ("warmup", "cpu"), ("warmup", "cuda"), ("pad", "cpu")]


def main(rounds: int = 3) -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    opts.data["persistent_cond_cache"] = False
    os.makedirs(OUT_DIR, exist_ok=True)
    c.phase_env()
    device = torch.device("cuda")
    model = create_random_sd15(seed=0, device=device)
    engine = Engine(model=model, device=device)
    body = dict(c.SD15_BASE, seed=1234, batch_size=1)
    out = {"card": torch.cuda.get_device_name(0)}
    real = profiling.profile
    try:
        with c._server(engine) as url:
            c._post(f"{url}/txt2img", dict(body, steps=2))
            c.phase_profile(engine, dict(body, seed=7), "earlier session")
            for round_ in range(rounds):
                for kind, acts in ARMS:
                    profiling.profile = _arm(kind)
                    label = f"r{round_}-{kind}-{acts}"
                    out[label] = traced(url, body, label, ["CPU"] if acts == "cpu" else [])
                profiling.profile = real
                if round_ < rounds - 1:
                    for _ in range(3):
                        c.phase_profile(engine, dict(body, seed=7), "earlier session")
    finally:
        profiling.profile = real
    with open(os.path.join(OUT_DIR, "profiler_trace_probe.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: (v["layer_norm"], v["attn_tc_kernel"], v["all"], v["gather_at"],
                          v.get("unmatched"), v.get("launch_to_kernel_ms_min"))
                      if isinstance(v, dict) else v for k, v in out.items()}))
    return 0


def traced(url, body, label, acts) -> dict:
    path = os.path.join(OUT_DIR, f"probe_{label}.json")
    t0 = time.perf_counter()
    c._post(f"{url}/txt2img", dict(body, override_settings={
        "profiling_enable": True, "profiling_filename": path, "profiling_activities": acts,
        "profiling_with_stack": False, "profiling_record_shapes": False,
        "profiling_profile_memory": False}))
    got = c._trace_kernels(path)
    got["seconds"] = time.perf_counter() - t0
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    kernels = sorted((e for e in events if e.get("cat") == "kernel"), key=lambda e: e["ts"])
    got["gather_at"] = next((i for i, e in enumerate(kernels) if "gather" in e["name"]), None)
    launches = sorted((e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                       and "LaunchKernel" in e.get("name", "")), key=lambda e: e["ts"])
    if launches:
        start = {e["args"]["correlation"]: e["ts"] for e in kernels
                 if "correlation" in e.get("args", {})}
        lost = [e for e in launches if e["args"].get("correlation") not in start]
        lag = [start[e["args"]["correlation"]] - e["ts"] for e in launches
               if e["args"].get("correlation") in start]
        t_first = launches[0]["ts"]
        got.update(launches=len(launches), unmatched=len(lost),
                   unmatched_at_ms=[round((e["ts"] - t_first) / 1e3, 3) for e in lost[:8]],
                   unmatched_index=[launches.index(e) for e in lost[:8]],
                   launch_to_kernel_ms_min=min(lag) / 1e3 if lag else None,
                   launch_to_kernel_ms_median=statistics.median(lag) / 1e3 if lag else None,
                   first_kernel_after_first_launch_ms=(kernels[0]["ts"] - t_first) / 1e3
                   if kernels else None)
    c.log(label, json.dumps(got))
    return got


if __name__ == "__main__":
    sys.exit(main(*map(int, sys.argv[1:])))
