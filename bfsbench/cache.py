"""The benchmark's fixed directories inside its checkout.

Everything a run builds or caches goes under ``bfsbench/cache/`` (listed
in the repository's ``.gitignore``), at paths fixed by name and content
hash, so the first run in a checkout builds and every later run reuses:

- ``kernels/``: the port's CUDA kernel library and its native host library
  (handed to the port through ``TPU_BFS_BENCH_XLA_CACHE``, the variable its
  ``utils/compile_cache`` reads), with ``TRITON_CACHE_DIR`` and
  ``TORCH_EXTENSIONS_DIR`` beside it;
- ``native/``: the benchmark's own Kronecker generator library;
- ``graphs/<config>-<hash>/``: a configuration's edge list and the
  reference's adjacency and component labels, keyed by the configuration's
  graph settings and the generator's sources.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent
CACHE_DIR = BENCH_DIR / "cache"


def use_build_dirs(root: Path = CACHE_DIR) -> None:
    """Point every build and kernel cache of the program into ``root``."""
    root = Path(root)
    os.environ["TPU_BFS_BENCH_XLA_CACHE"] = str(root / "kernels")
    os.environ["TRITON_CACHE_DIR"] = str(root / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "torch_extensions")


def graph_dir(root: Path, config_name: str, params: dict, sources: list[Path]) -> Path:
    """The cache directory of one configuration's graph."""
    h = hashlib.sha256(json.dumps(params, sort_keys=True).encode())
    for p in sources:
        h.update(p.name.encode())
        h.update(Path(p).read_bytes())
    return Path(root) / "graphs" / f"{config_name}-{h.hexdigest()[:16]}"


def load_arrays(directory: Path, names: tuple[str, ...]) -> dict | None:
    """The named arrays saved in ``directory``, or None if any is missing."""
    paths = [Path(directory) / f"{n}.npy" for n in names]
    if not all(p.is_file() for p in paths):
        return None
    return {n: np.load(p) for n, p in zip(names, paths)}


def save_arrays(directory: Path, arrays: dict) -> None:
    """Save each array whole or not at all (written aside, then renamed)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    for name, arr in arrays.items():
        tmp = directory / f".{name}.{os.getpid()}.npy"
        np.save(tmp, arr)
        os.replace(tmp, directory / f"{name}.npy")
