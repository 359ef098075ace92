"""Which kernel records a profiler trace loses, counted by correlation id.

    python3 tools/profiler_window_probe_cuda.py [TRACES]

In one process, after a first trace, four sets of traces with the card's
and the host's activity:

* ``spin``: TRACES traces of LAUNCHES zero-cycle spin kernels, every other
  one with IDLE_S of host idle after the trace opens;
* ``mix``: TRACES traces of a request's launch mix, MIX_ROUNDS rounds of:
  a caching-allocator growth (``empty_cache`` and a new block), a cuRAND
  fill, a cuBLAS GEMM, a cuDNN conv, the port's ctypes-launched B5
  (LayerNorm) and B2 (flash_attention_packed), elementwise ops and a host
  sync (``.item()``);
* ``request``: REQUESTS traces of a random SD1.5 txt2img at 512² through
  ``process_txt2img``, with the options of ``utils/profiling.profile``
  but no pad, an untraced request between two traces;
* ``late``: the same after LOAD_S seconds of untraced requests, to see
  whether the loss grows with the process's age.

Per trace, from the profiler's own results: every kernel launch (a
``*LaunchKernel*`` runtime or driver record) and every device record,
matched by correlation id; the launches with no device record, when they
were made (ms after the trace's start), and the host op each was made in
(the innermost host record around it); the earliest kept device stamp;
the least and median launch-to-stamp offset (a negative one means the
stamp precedes its own launch).  Prints one JSON line per trace and
writes ``$OUT_DIR/profiler_window_probe.json`` (default ``build``).
Needs a CUDA card.
"""

from __future__ import annotations

import bisect
import json
import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OUT_DIR = os.environ.get("OUT_DIR", "build")
LAUNCHES = 2000
IDLE_S = 0.05
MIX_ROUNDS = 40
REQUESTS = 6
LOAD_S = 90.0
T0 = time.perf_counter()


def _lost(prof, t_wall: float) -> dict:
    """The trace's launches against its device records, by correlation id."""
    from torch.autograd import DeviceType

    res = prof.profiler.kineto_results
    start = res.trace_start_ns()
    launches, device, ops = {}, {}, []
    for e in res.events():
        if e.device_type() == DeviceType.CUDA:
            device[e.correlation_id()] = (e.start_ns(), e.name())
        elif "LaunchKernel" in e.name():
            launches[e.correlation_id()] = e.start_ns()
        elif e.device_type() == DeviceType.CPU and not e.name().startswith(("cuda", "cu")):
            ops.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
    ops.sort()
    starts = [o[0] for o in ops]

    def made_in(t: int) -> str:
        """The innermost host op whose interval holds `t`."""
        best = None
        for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
            s, end, name = ops[i]
            if end >= t and (best is None or s > best[0]):
                best = (s, name)
                break
        return best[1] if best else "-"

    order = sorted(launches, key=launches.get)
    lost = [c for c in order if c not in device]
    offsets = [(device[c][0] - launches[c]) / 1e6 for c in order if c in device]
    by_op = {}
    for c in lost:
        op = made_in(launches[c])
        by_op[op] = by_op.get(op, 0) + 1
    kept_stamps = [device[c][0] for c in order if c in device]
    return dict(age_s=round(t_wall - T0, 1), launches=len(launches),
                device_records=len(device), lost=len(lost),
                lost_are_first=lost == order[:len(lost)],
                lost_launch_ms=[round((launches[c] - start) / 1e6, 3) for c in lost[:3]]
                + ([round((launches[lost[-1]] - start) / 1e6, 3)] if len(lost) > 3 else []),
                lost_by_op=dict(sorted(by_op.items(), key=lambda kv: -kv[1])[:8]),
                first_launch_ms=(launches[order[0]] - start) / 1e6 if order else None,
                first_kept_ms=(min(kept_stamps) - start) / 1e6 if kept_stamps else None,
                kept_before_start=sum(v < start for v in kept_stamps),
                offset_ms_least=min(offsets) if offsets else None,
                offset_ms_median=statistics.median(offsets) if offsets else None)


def _traced(body) -> dict:
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=False, profile_memory=False, with_stack=False) as prof:
        body()
        torch.cuda.synchronize()
    return _lost(prof, time.perf_counter())


def _spin(idle: bool):
    def body():
        if idle:
            time.sleep(IDLE_S)
        for _ in range(LAUNCHES):
            torch.cuda._sleep(0)
    return body


def _mix(device):
    import torch.nn.functional as F

    from sdwebui_tpu_torch.ops.flash_attention import flash_attention_packed
    from sdwebui_tpu_torch.ops.layer_norm import layer_norm

    g = torch.Generator(device=device).manual_seed(0)
    a = torch.randn((2048, 2048), generator=g, device=device, dtype=torch.bfloat16)
    w = torch.randn((320, 320, 3, 3), generator=g, device=device, dtype=torch.bfloat16)
    qkv = torch.randn((2, 4096, 3 * 320), generator=g, device=device, dtype=torch.bfloat16)
    ln_w = torch.ones(320, device=device)

    def body():
        for i in range(MIX_ROUNDS):
            if i % 8 == 0:                  # the allocator gives its blocks back, then grows
                torch.cuda.empty_cache()
            x = torch.randn((2, 320, 64, 64), generator=g, device=device, dtype=torch.bfloat16)
            y = F.conv2d(x, w, padding=1)
            h = (a @ a).sum(0)
            t = layer_norm(y.flatten(2).transpose(1, 2).contiguous(), ln_w, None)
            q, k, v = qkv.chunk(3, dim=-1)
            o = flash_attention_packed(q, k, v, num_heads=8)
            z = torch.nn.functional.silu(t + o) * 0.5
            if i % 4 == 3:
                float(z.float().mean() + h.float().mean())
    return body


def _request(model, seed: int):
    from sdwebui_tpu_torch.pipeline.params import GenerationParams
    from sdwebui_tpu_torch.pipeline.processing import process_txt2img

    def body():
        process_txt2img(model, GenerationParams(
            prompt="a photograph of an astronaut riding a horse", negative_prompt="blurry",
            width=512, height=512, sampler_name="Euler a", steps=20, cfg_scale=7.5, seed=seed))
    return body


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from sdwebui_tpu_torch.pipeline.sd_model import create_random_sd15

    traces = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    device = torch.device("cuda")
    out = {"torch": torch.__version__, "cuda": torch.version.cuda}

    def run(label, bodies):
        rows = []
        for body in bodies:
            rows.append(dict(set=label, **_traced(body)))
            print(json.dumps(rows[-1]), flush=True)
        out[label] = rows

    torch.cuda._sleep(0)
    run("first", [_spin(False)])
    run("spin", [_spin(i % 2 == 1) for i in range(traces)])
    mix = _mix(device)
    mix()                                    # builds B2 and B5 before any trace
    run("mix", [mix] * traces)
    model = create_random_sd15(seed=0, device=device)
    _request(model, 1)()
    rows = []
    for i in range(REQUESTS):
        rows.append(dict(set="request", **_traced(_request(model, 100 + i))))
        print(json.dumps(rows[-1]), flush=True)
        _request(model, 200 + i)()
    out["request"] = rows
    t_load = time.perf_counter()
    n = 0
    while time.perf_counter() - t_load < LOAD_S:
        _request(model, 300 + n)()
        n += 1
    print(json.dumps({"untraced_requests": n, "seconds": time.perf_counter() - t_load}),
          flush=True)
    rows = []
    for i in range(REQUESTS):
        rows.append(dict(set="late", **_traced(_request(model, 400 + i))))
        print(json.dumps(rows[-1]), flush=True)
        _request(model, 500 + i)()
    out["late"] = rows
    run("late_mix", [mix] * 4)
    summary = {k: dict(traces=len(v), lost=[r["lost"] for r in v],
                       offset_ms_least=[round(r["offset_ms_least"], 4) for r in v
                                        if r["offset_ms_least"] is not None])
               for k, v in out.items() if isinstance(v, list)}
    print(json.dumps({"summary": summary}), flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "profiler_window_probe.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
