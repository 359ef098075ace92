"""Console progress line (reference per-sampling tqdm + TotalTQDM,
modules/shared_total_tqdm.py).

The reference always renders a tqdm bar for the running sampling loop and,
with opts.multiple_tqdm (default True), a second aggregate bar for the
whole job (all batches).  Here both render on one carriage-return-refreshed
stderr line: the step bar plus — when multiple_tqdm and the job has more
than one batch — a job segment.  Output only happens when stderr is a TTY:
non-TTY consumers (CI, benchmarks, log files) keep clean logs, which is also
what tqdm's non-TTY degrade aims for.

A copy of ``sdwebui_tpu/runtime/console.py`` with the port's options;
tests/test_torch_copies.py holds it equal.
"""

from __future__ import annotations

import sys
import time

_last_draw = [0.0]
_line_open = [False]

_BAR_W = 30


def update(step: int, steps: int, job_no: int = 0, job_count: int = 0) -> None:
    """Draw/refresh the progress line.  Throttled to 10 Hz except for the
    final step (which closes the line with a newline)."""
    if not sys.stderr.isatty():
        return
    done = steps > 0 and step >= steps
    now = time.monotonic()
    if not done and now - _last_draw[0] < 0.1:
        return
    _last_draw[0] = now

    fill = int(_BAR_W * step / max(steps, 1))
    line = f"\r{step:>4}/{steps} [{'#' * fill}{'-' * (_BAR_W - fill)}]"

    from sdwebui_tpu_torch.utils.options import opts

    if job_count > 1 and bool(opts.get("multiple_tqdm", True)):
        total = job_count * max(steps, 1)
        cur = job_no * max(steps, 1) + step
        jfill = int(_BAR_W * cur / max(total, 1))
        line += (f"  job {min(job_no + 1, job_count)}/{job_count} "
                 f"[{'#' * jfill}{'-' * (_BAR_W - jfill)}]")
    sys.stderr.write(line)
    _line_open[0] = True
    if done and (job_count <= 1 or job_no >= job_count - 1):
        finish()
    else:
        sys.stderr.flush()


def finish() -> None:
    """Close an open progress line (job end/interrupt)."""
    if _line_open[0] and sys.stderr.isatty():
        sys.stderr.write("\n")
        sys.stderr.flush()
    _line_open[0] = False
