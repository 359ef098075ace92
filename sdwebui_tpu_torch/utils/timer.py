"""Hierarchical startup/job timer (reference modules/timer.py:28-89 API).

A copy of ``sdwebui_tpu/utils/timer.py`` (no JAX in it; the port keeps its
own copy, held equal by tests/test_torch_copies.py)."""

from __future__ import annotations

import time


class Timer:
    def __init__(self, print_log: bool = False):
        self.start = time.time()
        self.records: dict[str, float] = {}
        self.total = 0.0
        self.print_log = print_log
        self.subcategory_level = 0

    def elapsed(self) -> float:
        end = time.time()
        res = end - self.start
        self.start = end
        return res

    def add_time_to_record(self, category: str, amount: float):
        if category not in self.records:
            self.records[category] = 0.0
        self.records[category] += amount

    def record(self, category: str, extra_time: float = 0.0, disable_log=False):
        e = self.elapsed()
        self.add_time_to_record(category, e + extra_time)
        self.total += e + extra_time
        if self.print_log and not disable_log:
            print(f"{'  ' * self.subcategory_level}{category}: "
                  f"done in {e + extra_time:.3f}s")

    def subcategory(self, name: str):
        self.elapsed()
        self.subcategory_level += 1
        timer = self

        class _Sub:
            def __enter__(self):
                return timer

            def __exit__(self, *a):
                timer.subcategory_level -= 1
                timer.record(name, disable_log=True)

        return _Sub()

    def summary(self) -> str:
        res = f"{self.total:.1f}s"
        additions = [(c, t) for c, t in self.records.items() if t >= 0.1]
        if additions:
            res += " (" + ", ".join(f"{c}: {t:.1f}s" for c, t in additions) + ")"
        return res

    def dump(self) -> dict:
        """{total, records} — the GET /internal/profile-startup payload
        (reference modules/timer.py:78 Timer.dump)."""
        return {"total": self.total, "records": dict(self.records)}

    def reset(self):
        self.__init__(self.print_log)


startup_timer = Timer()

#: set once at the end of server boot; served by /internal/profile-startup
#: and rendered by the footer "Startup profile" popup (reference
#: modules/ui.py:1221 + javascript/profilerVisualization.js showProfile).
startup_record: dict | None = None
