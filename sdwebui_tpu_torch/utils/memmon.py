"""A job's peak device memory, for ``/sdapi/v1/memory``.

Port of ``sdwebui_tpu/utils/memmon.py``.  JAX samples ``memory_stats()``
in a thread at opts.memmon_poll_rate Hz; PyTorch's allocator keeps the
peak itself, so the port resets it when a job begins and reads it when the
job ends, with no thread: ``peak_used`` is exact whatever the poll rate,
and ``polls`` counts the readings.  A CPU job reports 0, as JAX does when
its device gives no statistics.
"""

from __future__ import annotations

import torch


class MemMonitor:
    def __init__(self):
        self.peak_used = 0
        self.polls = 0
        self._device = None

    def start(self, device=None):
        """Begin a job on `device` (None or a CPU device: nothing to read)."""
        device = torch.device(device) if device is not None else None
        self._device = device if device is not None and device.type == "cuda" else None
        self.polls = 0
        self.peak_used = 0
        if self._device is not None:
            torch.cuda.reset_peak_memory_stats(self._device)
            self.peak_used = torch.cuda.memory_allocated(self._device)

    def stop(self):
        """The job ended: its peak is the allocator's."""
        if self._device is not None:
            self.peak_used = max(self.peak_used, torch.cuda.max_memory_allocated(self._device))
            self.polls += 1
