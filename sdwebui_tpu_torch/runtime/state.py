"""Job state machine (reference modules/shared_state.py).

Port of ``sdwebui_tpu/runtime/state.py``: the fields the Engine sets and
reads, the interrupt/skip flags (``interrupt_ui`` with
opts.interrupt_after_current), the progress fraction, the live preview
(``current_image``, ``id_live_preview``, ``textinfo``) and the job's peak
device memory (``utils/memmon``, in place of JAX's polling thread), the
server commands (``server_command``: stop, restart or kill, which
``server/__main__`` waits for) and the end of the console's progress line
(``runtime/console``) when a job ends.

Generation holds the Engine's queue lock; the progress routes do not, and
run in other threads of the threaded server.  So every write of more than
one field takes ``_lock``, and readers take :meth:`snapshot`, one
consistent copy made under the same lock.
"""

from __future__ import annotations

import threading
import time

from sdwebui_tpu_torch.runtime import console
from sdwebui_tpu_torch.utils.memmon import MemMonitor
from sdwebui_tpu_torch.utils.options import opts


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
        self.current_image = None          # uint8 (H, W, 3) or None
        self.id_live_preview = 0
        self.textinfo = None
        self.time_start = 0.0
        self.server_start = time.time()
        self.memmon = MemMonitor()
        self._lock = threading.Lock()
        self.server_command_signal = threading.Event()
        self._server_command = None

    # ---- flags --------------------------------------------------------

    def skip(self):
        self.skipped = True

    def interrupt(self):
        # immediate, like the reference State.interrupt() used by the API
        self.interrupted = True

    def interrupt_ui(self):
        """UI Interrupt button semantics (reference ui_toprow.py:106 with
        opts.interrupt_after_current): the first interrupt of a multi-image
        job finishes the in-flight image and stops before the next; a
        second click stops immediately."""
        with self._lock:
            if not self.stopping_generation and self.job_count > 1 \
                    and opts.get("interrupt_after_current", True):
                self.stopping_generation = True
            else:
                self.interrupted = True

    def stop_generating(self):
        self.stopping_generation = True

    def take_skip(self) -> bool:
        """Whether a skip is pending, clearing it: a skip stops the batch in
        flight only (JAX's step callback, app.py:446-448)."""
        with self._lock:
            skipped, self.skipped = self.skipped, False
            return skipped

    # ---- lifecycle ----------------------------------------------------

    def begin(self, job: str = "(unknown)", job_count: int = -1, device=None):
        """A new job; `device` is where its peak memory is read."""
        with self._lock:
            self.sampling_step = 0
            self.sampling_steps = 0
            self.job_count = job_count
            self.job_no = 0
            self.job_timestamp = time.strftime("%Y%m%d%H%M%S")
            self.current_image = None
            self.id_live_preview = 0
            self.skipped = False
            self.interrupted = False
            self.stopping_generation = False
            self.textinfo = None
            self.job = job
            self.time_start = time.time()
        self.memmon.start(device)

    def end(self):
        with self._lock:
            self.job = ""
            self.job_count = 0
        console.finish()
        self.memmon.stop()

    def set_sampling_step(self, step: int, steps: int):
        with self._lock:
            self.sampling_step, self.sampling_steps = step, steps

    def set_job_no(self, n: int):
        """Batch `n` of the job starts (JAX's batch callback, app.py:468);
        its step count restarts with it, so the progress never overshoots
        into the next batch's share and falls back."""
        with self._lock:
            self.job_no = n
            self.sampling_step = 0

    # ---- progress -----------------------------------------------------

    @staticmethod
    def _progress(job_no: int, job_count: int, step: int, steps: int) -> float:
        p = 0.0
        if job_count > 0:
            p += job_no / job_count
            if steps > 0:
                p += (1 / job_count) * (step / steps)
        return min(p, 1.0)

    @property
    def progress(self) -> float:
        return self.snapshot()["progress"]

    def set_current_image(self, image):
        with self._lock:
            self.current_image = image
            self.id_live_preview += 1

    def snapshot(self) -> dict:
        """Every field a progress route reads, and the progress fraction,
        from one moment of the job."""
        with self._lock:
            snap = {k: getattr(self, k) for k in (
                "skipped", "interrupted", "stopping_generation", "job", "job_no",
                "job_count", "job_timestamp", "sampling_step", "sampling_steps",
                "current_image", "id_live_preview", "textinfo", "time_start")}
        snap["progress"] = self._progress(snap["job_no"], snap["job_count"],
                                          snap["sampling_step"], snap["sampling_steps"])
        return snap

    # ---- server commands (JAX's state.py:128-145) --------------------------

    @property
    def server_command(self):
        return self._server_command

    @server_command.setter
    def server_command(self, value):
        self._server_command = value
        self.server_command_signal.set()

    def wait_for_server_command(self, timeout=None):
        """The next command ("stop", "restart" or "kill"), or None after
        `timeout` seconds without one."""
        if self.server_command_signal.wait(timeout):
            self.server_command_signal.clear()
            req = self._server_command
            self._server_command = None
            return req
        return None
