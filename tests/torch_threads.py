"""Torch's intra-op thread cap for the port's test processes.

Under pytest-xdist every worker is a process of its own, and torch's
intra-op pool defaults to one thread a core in each of them. The port's
CPU runs are thousands of tiny level ops, and six workers each running a
pool of eight threads on eight cores spend their time fighting for the
cores: a 254-level batch that takes seconds alone takes minutes there.
Every ``tests/test_torch_*.py`` calls :func:`cap_torch_threads` when it
is imported, so the cap holds whatever order the files are collected in.
This module imports no JAX: the card tests run without the conftest.
"""

from __future__ import annotations

import os

import torch


def cap_torch_threads() -> int:
    """Under an xdist worker, give torch ``cores // workers`` intra-op
    threads (at least 1); outside xdist leave its default. Returns the
    thread count in force."""
    if os.environ.get("PYTEST_XDIST_WORKER"):
        workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1") or 1)
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // max(1, workers)))
    return torch.get_num_threads()


def subprocess_env(**extra: str) -> dict:
    """``os.environ`` with ``OMP_NUM_THREADS`` set to this process's torch
    thread count, for the port's processes that a test spawns."""
    return dict(os.environ, OMP_NUM_THREADS=str(torch.get_num_threads()), **extra)
