"""PyTorch's CPU threads for a test process: the cores divided among the
processes of a parallel run (``pytest -n N`` sets
``PYTEST_XDIST_WORKER_COUNT``), every core when the tests run in one.

Each process would otherwise take one thread per core for its ops, and
N processes' OpenMP threads would wait on one another: a CPU rehearsal of
``chip_smoke.py`` that takes 14 s alone took 930 s in a 6-process run.
Every port test module imports this, so whichever a process collects
first sets it.
"""
import os

import torch


def cap_threads() -> int:
    workers = max(1, int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
    n = max(1, (os.cpu_count() or 1) // workers)
    torch.set_num_threads(n)
    return n


cap_threads()
