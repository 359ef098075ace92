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
on the card it opens on PAD_KERNELS spin kernels (``_pad``).  With the
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

log = logging.getLogger(__name__)


def _pad(device):
    """Launch PAD_KERNELS spin kernels as the trace opens.  A trace opened
    after an earlier one in the same process lacks the records of its first
    kernels: on an H100, 0 to 57 of them in the 24 traces of
    ``tools/profiler_trace_probe_cuda.py``, each time the first ones in
    launch order, and at least 259 once in a whole run of ``chip_smoke.py``.
    Draining the card before the trace opens, leaving it idle 50 ms after,
    or a profiler schedule's warmup step did not stop the loss; traces of
    spin kernels alone lost nothing (``tools/profiler_window_probe_cuda.py``).
    So the trace opens on kernels it may lose, and the loss is counted after
    (``_count_pad``)."""
    for _ in range(PAD_KERNELS):
        torch.cuda._sleep(0)


def _count_pad(prof) -> int:
    """The pad's kernels in the finished trace; a trace that kept none of
    them may lack the generation's first kernels too, and a warning says so."""
    from torch.autograd import DeviceType

    kept = sum(e.device_type() == DeviceType.CUDA and "spin_kernel" in e.name()
               for e in prof.profiler.kineto_results.events())
    if kept == 0:
        log.warning("the profiler lost all %d padding kernels of this trace: it may "
                    "lack the generation's first kernels", PAD_KERNELS)
    return kept


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
    nothing is recorded.  A trace on the card sets ``last_pad_kept``."""
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

    global last_pad_kept
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
        last_pad_kept = _count_pad(prof)
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
