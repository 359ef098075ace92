"""torch's intra-op threads for a test process: under pytest-xdist each
worker gets its share of the cores (at least one).

Every worker of ``pytest -n N`` imports every test module while it collects,
so one import of this module sets the whole worker.  Left at torch's default
(one thread per core in every worker), N workers each run a full-width
OpenMP pool on the same cores and spend most of the run waiting on one
another: six workers on eight cores took five to six times as long for the
same tests as with one thread each.  A run without xdist keeps the default.
"""

import os

import torch

_workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
if _workers > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _workers))
