"""Graph500's Kronecker generator, the benchmark's frozen copy.

The edge stream is ``kronecker_rmat.cpp`` (a copy of the port's native
RMAT generator: SCALE bits a vertex drawn from the quadrant probabilities
A, B, C, with D = 1 - A - B - C), built with ``g++`` into the benchmark's
cache directory and called through ``ctypes``. Vertex ids are then
permuted by ``numpy.random.default_rng(seed).permutation(2**SCALE)``, as
the Graph500 specification asks and as the port's ``rmat_edges`` does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).with_name("kronecker_rmat.cpp")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


def source_files() -> list[Path]:
    return [Path(__file__), SOURCE]


def library(build_dir: Path) -> ctypes.CDLL:
    """The generator's shared library, built into ``build_dir`` at first
    use under a name that carries the source's hash."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    lib = Path(build_dir) / f"libbfsbench_rmat-{digest}.so"
    if not lib.is_file():
        cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
        lib.parent.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
            out = Path(tmp) / lib.name
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(out), str(SOURCE)],
                                  capture_output=True, text=True, timeout=300, check=False)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed on {SOURCE.name}: {proc.stderr[-600:]}")
            os.replace(out, lib)
    dll = ctypes.CDLL(str(lib))
    ll = ctypes.c_longlong
    dll.bfsbench_rmat_edges.restype = ll
    dll.bfsbench_rmat_edges.argtypes = [
        ll, ll, ll, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ll), ctypes.POINTER(ll)]
    return dll


def raw_edges(scale: int, m: int, seed: int, a: float, b: float, c: float,
              build_dir: Path) -> tuple[np.ndarray, np.ndarray]:
    """The stream's ``m`` edges before the vertex permutation."""
    u = np.empty(m, dtype=np.int64)
    v = np.empty(m, dtype=np.int64)
    ptr = ctypes.POINTER(ctypes.c_longlong)
    rc = library(build_dir).bfsbench_rmat_edges(
        int(scale), int(m), int(seed), float(a), float(b), float(c),
        u.ctypes.data_as(ptr), v.ctypes.data_as(ptr))
    if rc != 0:
        raise ValueError(f"Kronecker generator rejected scale={scale} m={m} (rc={rc})")
    return u, v


def edges(params: dict, build_dir: Path) -> tuple[np.ndarray, np.ndarray]:
    scale = int(params["scale"])
    m = int(params["edge_factor"]) << scale
    seed = int(params["seed"])
    u, v = raw_edges(scale, m, seed, params["a"], params["b"], params["c"], build_dir)
    perm = np.random.default_rng(seed).permutation(1 << scale)
    return perm[u], perm[v]
