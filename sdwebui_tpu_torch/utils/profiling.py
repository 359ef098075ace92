"""Generation profiling (reference modules/profiling.py): one generation
under ``torch.profiler``, written as a Chrome trace (viewable in Chrome's
tracing page or Perfetto).

Port of ``sdwebui_tpu/utils/profiling.py:9-46``, where the generation runs
under a ``jax.profiler`` trace.  JAX's mapping of the reference's options
carries over: the device's events are always recorded (here the CUDA
activity, when the generation runs on the card), the host's only when
``profiling_activities`` names "CPU", and ``profiling_with_stack`` adds the
Python stack.  ``profiling_record_shapes`` and ``profiling_profile_memory``,
which XLA's traces cannot turn off, are the profiler's own switches here.
The trace is written at ``profiling_filename`` when the generation ends;
on the card it opens on PAD_KERNELS spin kernels (``_pad``), and the
generation's kernels it lost are counted by correlation id.  With the
option off the generation runs with no profiler in its way.
"""

from __future__ import annotations

import contextlib
import logging
import os

import torch

from sdwebui_tpu_torch.utils.options import opts


#: zero-cycle spin kernels that open every trace on the card: about four times
#: the most first kernel records a request's trace has lost on an H100 (0 to
#: 57 in 28 traces, at least 259 in one; PERF.md §7)
PAD_KERNELS = 1024
#: how many of them the last trace on the card kept (None before one)
last_pad_kept: int | None = None
#: the generation's own kernel launches in the last trace on the card whose
#: kernel record the trace lacks, matched by correlation id (None before one)
last_lost: int | None = None

log = logging.getLogger(__name__)


def _pad(device):
    """Launch PAD_KERNELS spin kernels as the trace opens.  A trace opened
    after an earlier one in the same process lacks the records of its first
    kernels: on an H100, the first launches up to some point, never a kept
    one before a lost one, more of them the older the process (the same
    launch mix lost 3 a trace 47 s into a process and 16 at 243 s; a
    request's trace 0 to 4 at 56 to 99 s and 0 to 14 at 197 to 238 s;
    ``tools/profiler_window_probe_cuda.py``).  Draining the card before the
    trace opens, leaving it idle 50 ms after, or a warm-up step of the
    profiler's schedule ahead of the generation (``schedule(wait=0,
    warmup=1, active=1)``: 0 to 2 records lost a trace at 240 to 270 s into
    the process, as many as with no pad; the probe's ``warmup`` arm) did
    not stop the loss; traces of spin kernels alone lost nothing.  So the
    trace opens on kernels it may lose, and the loss is counted after
    (``_count_lost``)."""
    for _ in range(PAD_KERNELS):
        torch.cuda._sleep(0)


def _count_lost(prof) -> tuple:
    """(pad kernels kept, the generation's launches lost) of a finished
    trace: each kernel launch (a ``cudaLaunchKernel`` or driver launch
    record, which the trace keeps) against the kernel records, by
    correlation id; the first PAD_KERNELS launches are the pad's.  A lost
    generation kernel logs a warning."""
    from torch.autograd import DeviceType

    launches, kernels = [], set()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            kernels.add(e.correlation_id())
        elif "LaunchKernel" in e.name():
            launches.append((e.start_ns(), e.correlation_id()))
    launches.sort()
    pad, rest = launches[:PAD_KERNELS], launches[PAD_KERNELS:]
    kept = sum(c in kernels for _, c in pad)
    lost = sum(c not in kernels for _, c in rest)
    if lost:
        log.warning("the profiler lost %d of the generation's %d kernel records (and %d of "
                    "%d padding kernels)", lost, len(rest), PAD_KERNELS - kept, PAD_KERNELS)
    return kept, lost


def settings() -> dict:
    """The profiling options as they stand (a request's override_settings
    included, when read under them).  ``profiling_enable`` and
    ``profiling_filename`` are in the options' registry; the other four
    are not, and are read with defaults, as JAX reads
    ``profiling_activities`` and ``profiling_with_stack``
    (``sdwebui_tpu/utils/profiling.py:33-35``)."""
    return {"profiling_enable": opts.get("profiling_enable"),
            "profiling_filename": opts.get("profiling_filename"),
            "profiling_activities": opts.get("profiling_activities", ["CPU"]),
            "profiling_record_shapes": opts.get("profiling_record_shapes", True),
            "profiling_profile_memory": opts.get("profiling_profile_memory", True),
            "profiling_with_stack": opts.get("profiling_with_stack", True)}


@contextlib.contextmanager
def profile(trace: dict, device):
    """Run the block under torch.profiler when trace["profiling_enable"]
    (`trace`: ``settings()``), then write its Chrome trace at
    trace["profiling_filename"]; yields the trace's path, or None when
    nothing is recorded.  A trace on the card sets ``last_pad_kept`` and
    ``last_lost``."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    acts = []
    if trace["profiling_enable"]:      # the card's events always, the host's on request
        if "CPU" in list(trace["profiling_activities"] or []):
            acts.append(ProfilerActivity.CPU)
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
    if not acts:
        yield None
        return

    global last_pad_kept, last_lost
    path = trace["profiling_filename"] or opts.data_labels["profiling_filename"].default
    cuda = torch.device(device).type == "cuda"
    with torch_profile(activities=acts, record_shapes=bool(trace["profiling_record_shapes"]),
                       profile_memory=bool(trace["profiling_profile_memory"]),
                       with_stack=bool(trace["profiling_with_stack"])) as prof:
        if cuda:
            _pad(device)
        yield path
        if cuda:                       # every kernel done before the trace closes
            torch.cuda.synchronize(device)
    if cuda:
        last_pad_kept, last_lost = _count_lost(prof)
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
