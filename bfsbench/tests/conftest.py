"""Shared pieces of the benchmark's tests: tiny cells on the CPU, and the
fixture that skips a card test when there is no card."""

from __future__ import annotations

import copy

import pytest

from bfsbench import harness


def tiny_cell(name: str, *, scale: int = 9, lanes: int = 64):
    """Cell ``name`` of BENCHMARK.json cut to ``scale`` and ``lanes``."""
    cell = harness.load_cell(name)
    config = copy.deepcopy(cell.config)
    config["graph"]["scale"] = scale
    traffic = dict(cell.traffic, keys_per_batch=min(cell.traffic["keys_per_batch"], lanes))
    return harness.Cell(cell.name, cell.config_name, config, cell.traffic_name, traffic,
                        min(cell.lanes, lanes), cell.chips)


@pytest.fixture
def card():
    """The CUDA device; skips the test when there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (no CUDA device here)")
    return "cuda"


@pytest.fixture(scope="session")
def cache_root(tmp_path_factory):
    return tmp_path_factory.mktemp("bfsbench_cache")


def gxx_builds(cache_root) -> bool:
    """Whether the frozen Kronecker generator builds here (g++)."""
    from bfsbench.graphs import kronecker

    try:
        kronecker.library(cache_root / "native")
    except (OSError, RuntimeError):
        return False
    return True
