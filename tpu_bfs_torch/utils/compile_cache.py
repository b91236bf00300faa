"""The kernel build cache: where ``ops/_build`` compiles the CUDA library,
the port of ``tpu_bfs/utils/compile_cache.py``.

The JAX package points XLA's persistent compilation cache at a directory
so a fresh process skips the backend compile of its programs. The port
compiles no program per shape: what a fresh process compiles is the
kernel library (``nvcc`` over ``csrc/*.cu``), keyed by the sources' hash.
So this module resolves the directory that library is built into and
reused from, with JAX's precedence:

- ``TPU_BFS_BENCH_XLA_CACHE``, when set;
- else ``<TPU_BFS_BENCH_CACHE>/xla_cache``, when that variable is set;
- else ``tpu_bfs_torch/build`` (gitignored), the package's own.

An empty ``TPU_BFS_BENCH_XLA_CACHE`` disables the cache: the process
builds into a private temporary directory of its own (``ops/_build``).

Resolution is once per process, as in JAX: every ``EngineRegistry()`` and
every kernel build calls :func:`enable_compile_cache`, and the first call's
outcome (a path, or disabled) is kept; later calls return it silently.
``force=True`` re-resolves (tests that vary the environment).
"""

from __future__ import annotations

import os
from pathlib import Path

#: The package's own build directory, the default cache.
DEFAULT_DIR = Path(__file__).resolve().parent.parent / "build"

# The first call's outcome, a 1-tuple so a resolved "disabled" (None) is
# told apart from "never resolved".
_RESOLVED: tuple | None = None


def reset_resolution() -> None:
    """Forget the resolved directory (tests that vary the env vars)."""
    global _RESOLVED
    _RESOLVED = None


def enable_compile_cache(log=None, *, force: bool = False) -> str | None:
    """The kernel build directory, created, resolved once per process (see
    the module docstring); None when the cache is disabled or its directory
    cannot be made (the build then takes a private directory)."""
    global _RESOLVED
    if _RESOLVED is not None and not force:
        return _RESOLVED[0]
    env = os.environ
    if "TPU_BFS_BENCH_XLA_CACHE" in env:
        path = env["TPU_BFS_BENCH_XLA_CACHE"]
    elif "TPU_BFS_BENCH_CACHE" in env:
        path = os.path.join(env["TPU_BFS_BENCH_CACHE"], "xla_cache")
    else:
        path = str(DEFAULT_DIR)
    if not path:
        _RESOLVED = (None,)
        return None
    try:
        os.makedirs(path, exist_ok=True)
    except OSError as exc:
        if log:
            log(f"kernel build cache unavailable ({exc!r}); continuing without")
        _RESOLVED = (None,)
        return None
    if log:
        log(f"kernel build cache: {path}")
    _RESOLVED = (path,)
    return path
