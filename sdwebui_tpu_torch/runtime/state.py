"""Job state machine (reference modules/shared_state.py).

Copy of the job part of ``sdwebui_tpu/runtime/state.py``: the fields the
Engine sets and reads, ``begin``/``end`` without the JAX package's memory
monitor and console, the interrupt/skip flags and the progress fraction.
"""

from __future__ import annotations

import threading
import time


class State:
    def __init__(self):
        self.skipped = False
        self.interrupted = False
        self.stopping_generation = False
        self.job = ""
        self.job_no = 0
        self.job_count = 0
        self.job_timestamp = "0"
        self.sampling_step = 0
        self.sampling_steps = 0
        self.time_start = 0.0
        self.server_start = time.time()
        self._lock = threading.Lock()

    # ---- flags --------------------------------------------------------

    def skip(self):
        self.skipped = True

    def interrupt(self):
        # immediate, like the reference State.interrupt() used by the API
        self.interrupted = True

    def stop_generating(self):
        self.stopping_generation = True

    # ---- lifecycle ----------------------------------------------------

    def begin(self, job: str = "(unknown)"):
        with self._lock:
            self.sampling_step = 0
            self.sampling_steps = 0
            self.job_count = -1
            self.job_no = 0
            self.job_timestamp = time.strftime("%Y%m%d%H%M%S")
            self.skipped = False
            self.interrupted = False
            self.stopping_generation = False
            self.job = job
            self.time_start = time.time()

    def end(self):
        with self._lock:
            self.job = ""
            self.job_count = 0

    def nextjob(self):
        self.job_no += 1
        self.sampling_step = 0

    # ---- progress -----------------------------------------------------

    @property
    def progress(self) -> float:
        p = 0.0
        if self.job_count > 0:
            p += self.job_no / self.job_count
            if self.sampling_steps > 0:
                p += (1 / self.job_count) * (self.sampling_step / self.sampling_steps)
        return min(p, 1.0)
