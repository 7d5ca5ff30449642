"""Thread-pool sizing for the extension jobs: ``host_pool_workers`` (the
port's copy of ``kaminpar_tpu/utils/platform.py``'s) and the port's
device-aware width."""

from __future__ import annotations

import os

import torch


def host_pool_workers(jobs: int) -> int:
    """Thread-pool sizing for independent host-side subproblems (the
    per-block extension jobs of ``partitioning/deep.py``): one worker per
    job, capped by the machine and a 16-thread ceiling."""
    return min(max(int(jobs), 1), max(os.cpu_count() or 1, 1), 16)


def extension_workers(jobs: int, device) -> int:
    """Worker threads of the extension job pool on ``device``:
    ``host_pool_workers`` for CPU tensors, whose plain ops do their work
    with the GIL released; one for a CUDA device.  There a job is
    thousands of small kernel launches from a Python loop, host-bound, and
    concurrent jobs contend for the GIL and run slower than one after
    another (the ``pooled_serial`` and ``pool_width`` phases of
    ``chip_smoke.py`` time both widths, PERF.md)."""
    return host_pool_workers(jobs) if torch.device(device).type == "cpu" else 1
