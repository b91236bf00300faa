"""The GAP Benchmark Suite's uniform random graph ("Urand"), the frozen
copy of the upstream reference's generator (``bfs.cu:892-907``, the port's
``random_graph``): both endpoints of each of EDGE_FACTOR * 2**SCALE edges
drawn uniformly by ``numpy.random.default_rng(seed).integers``."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def source_files() -> list[Path]:
    return [Path(__file__)]


def edges(params: dict, build_dir: Path) -> tuple[np.ndarray, np.ndarray]:
    n = 1 << int(params["scale"])
    m = int(params["edge_factor"]) << int(params["scale"])
    rng = np.random.default_rng(int(params["seed"]))
    u = rng.integers(0, n, size=m, dtype=np.int64)
    v = rng.integers(0, n, size=m, dtype=np.int64)
    return u, v
