"""torch's intra-op threads in a test process.

Tier-1 runs the suite under pytest-xdist, several workers on one host;
torch gives each worker one intra-op thread a core, so the port's
many small CPU ops wait on pools that together hold several times the
host's cores (and starve the other workers' sockets and subprocesses).
Every `tests/test_torch_*.py` calls `cap_threads()` when it is imported."""

import os

import torch


def cap_threads():
    """Shares the process's cores among the xdist workers: each takes
    cores // workers intra-op threads (at least one).  A run without
    workers keeps torch's default."""
    workers = int(os.environ.get('PYTEST_XDIST_WORKER_COUNT', '1'))
    if workers > 1:
        cores = len(os.sched_getaffinity(0)) if hasattr(
            os, 'sched_getaffinity') else (os.cpu_count() or 1)
        torch.set_num_threads(max(1, cores // workers))
