"""Native (C++) host paths, loaded via ctypes: the port of
``tpu_bfs/utils/native.py``.

The sources are the port's own (``tpu_bfs_torch/native/loader.cpp``: the
edge-list and ``.mtx`` parser and an O(E) counting sort; ``rmat.cpp``:
the threaded RMAT generator). They compile with ``g++ -O3 -shared -fPIC
-pthread`` at first use into the kernel build directory
(``ops._build.kernel_dir()``: ``tpu_bfs_torch/build`` by default). The
library's file name carries the sources' hash, and it is compiled in a
temporary directory and moved in with ``os.replace``: processes that build
at once never load a half-written file, and a changed source gets a new
file, never a handle cached from before.

Every entry point returns ``None`` when the library cannot be built or
loaded, and callers fall back to the NumPy paths, as in the JAX package.
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

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
SOURCES = ("loader.cpp", "rmat.cpp")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_LIBS: dict[str, ctypes.CDLL] = {}  # loaded handles by library path
_FAILED: dict[str, str] = {}  # library path -> why its build failed


def source_hash() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((NATIVE_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    """Where the library of the current sources lives (built or not)."""
    from tpu_bfs_torch.ops._build import kernel_dir

    return kernel_dir() / f"libtpubfs_torch_native-{source_hash()}.so"


def _build(lib: Path) -> None:
    """Compile the sources into ``lib``; raises on failure."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    lib.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
        out = Path(tmp) / lib.name
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, "-o", str(out), *(str(NATIVE_DIR / s) for s in SOURCES)],
            capture_output=True, text=True, timeout=300, check=False,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"rc={proc.returncode}: {proc.stderr.strip()[-300:]}")
        os.replace(out, lib)


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    ll = ctypes.c_longlong
    pll = ctypes.POINTER(ll)
    lib.tpubfs_torch_parse_edge_list.restype = ll
    lib.tpubfs_torch_parse_edge_list.argtypes = [
        ctypes.c_char_p, pll, pll, ctypes.POINTER(pll), ctypes.POINTER(pll)]
    lib.tpubfs_torch_free.argtypes = [pll]
    lib.tpubfs_torch_lexsort_pairs.restype = ll
    lib.tpubfs_torch_lexsort_pairs.argtypes = [pll, pll, ll, ll, ll, pll]
    lib.tpubfs_torch_rmat_edges.restype = ll
    lib.tpubfs_torch_rmat_edges.argtypes = [
        ll, ll, ll, ctypes.c_double, ctypes.c_double, ctypes.c_double, pll, pll]
    return lib


def _find_lib(log=None):
    """The loaded library of the current sources, built first if missing;
    None if it cannot be built or loaded (the reason goes to ``log``)."""
    try:
        path = library_path()
    except OSError as exc:
        if log is not None:
            log(f"native library unavailable: {exc}")
        return None
    key = str(path)
    if key in _LIBS:
        return _LIBS[key]
    if key in _FAILED and log is None:
        return None
    try:
        if not path.is_file():
            _build(path)
        _LIBS[key] = _declare(ctypes.CDLL(key))
        _FAILED.pop(key, None)
        return _LIBS[key]
    except (OSError, AttributeError, RuntimeError, subprocess.SubprocessError) as exc:
        _FAILED[key] = str(exc)
        if log is not None:
            log(f"native build failed; falling back to numpy paths: {exc}")
        return None


def ensure_built(log=None) -> None:
    """Best-effort build and load of the library. ``log`` (a callable taking
    one string) receives a diagnostic when the build fails; callers then
    fall back to the NumPy paths via ``available()``/``has_rmat()``."""
    _find_lib(log=log if log is not None else (lambda msg: None))


def available() -> bool:
    return _find_lib() is not None


def has_rmat() -> bool:
    """True iff the library loads and exports the RMAT generator."""
    lib = _find_lib()
    return lib is not None and getattr(lib, "tpubfs_torch_rmat_edges", None) is not None


def load_edge_list_native(path: str, *, directed: bool = False, drop_self_loops: bool = False):
    """Parse an edge-list file with the C++ loader. Returns a Graph, or None
    if the native library is unavailable (callers fall back to NumPy)."""
    lib = _find_lib()
    if lib is None:
        return None
    n = ctypes.c_longlong()
    m = ctypes.c_longlong()
    up = ctypes.POINTER(ctypes.c_longlong)()
    vp = ctypes.POINTER(ctypes.c_longlong)()
    rc = lib.tpubfs_torch_parse_edge_list(
        path.encode(), ctypes.byref(n), ctypes.byref(m), ctypes.byref(up), ctypes.byref(vp)
    )
    if rc != 0:
        raise IOError(f"native loader failed on {path} (rc={rc})")
    try:
        u = np.ctypeslib.as_array(up, shape=(m.value,)).copy()
        v = np.ctypeslib.as_array(vp, shape=(m.value,)).copy()
    finally:
        lib.tpubfs_torch_free(up)
        lib.tpubfs_torch_free(vp)
    if drop_self_loops:
        keep = u != v
        u, v = u[keep], v[keep]
    from tpu_bfs_torch.graph.io import from_edges

    return from_edges(
        u, v, num_vertices=int(n.value), directed=directed, num_input_edges=int(m.value)
    )


def rmat_edges_native(scale: int, m: int, seed: int, a: float, b: float, c: float):
    """Threaded native RMAT endpoints (native/rmat.cpp), or None if the
    library is unbuilt. Deterministic in (scale, m, seed, a, b, c), never in
    the thread count, and a different stream from the NumPy generator's
    (same distribution, different graphs for the same seed)."""
    lib = _find_lib()
    if lib is None:
        return None
    u = np.empty(m, dtype=np.int64)
    v = np.empty(m, dtype=np.int64)
    ll = ctypes.POINTER(ctypes.c_longlong)
    rc = lib.tpubfs_torch_rmat_edges(
        int(scale), int(m), int(seed), float(a), float(b), float(c),
        u.ctypes.data_as(ll), v.ctypes.data_as(ll),
    )
    if rc != 0:
        raise ValueError(
            f"native RMAT generator rejected scale={scale}, m={m} (rc={rc})"
        )
    return u, v


def lexsort_pairs(major: np.ndarray, minor: np.ndarray, n_major: int, n_minor: int):
    """Permutation ordering by (major, minor) ascending, ``np.lexsort((minor,
    major))`` semantics, from an O(E) native counting sort. None if the
    library is unavailable or a key lies outside its bound (callers fall
    back to np.lexsort)."""
    lib = _find_lib()
    if lib is None:
        return None
    major = np.ascontiguousarray(major, dtype=np.int64)
    minor = np.ascontiguousarray(minor, dtype=np.int64)
    perm = np.empty(len(major), dtype=np.int64)
    ll = ctypes.POINTER(ctypes.c_longlong)
    rc = lib.tpubfs_torch_lexsort_pairs(
        major.ctypes.data_as(ll), minor.ctypes.data_as(ll), len(major),
        int(n_major), int(n_minor), perm.ctypes.data_as(ll),
    )
    return perm if rc == 0 else None
