"""Build and load the port's CUDA kernels (``tpu_bfs_torch/csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` (all sources in parallel),
then one link makes ``libtpubfs_torch.so`` in the kernel build cache
(``utils/compile_cache``: ``tpu_bfs_torch/build`` unless the environment
names another, or a private temporary directory when it disables the
cache), loaded with ``ctypes``; the kernels' C entry points take raw
pointers and the CUDA stream. The library is rebuilt whenever the sources'
hash changes, at first use, and reused from the cache otherwise. There is
no fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import atexit
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"  # the package's scratch: graph caches, the default kernel cache
LIB_NAME = "libtpubfs_torch.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256()
    h.update(" ".join(ARCH_FLAGS + COMPILE_FLAGS).encode())
    for p in sources() + sorted(SRC_DIR.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError(
        "nvcc not found (looked at $CUDA_HOME/bin, $PATH, /usr/local/cuda/bin): "
        "the CUDA kernels of tpu_bfs_torch are built from source at first use"
    )


_PRIVATE_DIR: Path | None = None


def kernel_dir() -> Path:
    """The directory the library is built into: the resolved kernel build
    cache, or, with the cache disabled, one private temporary directory for
    the process, removed at exit."""
    from tpu_bfs_torch.utils.compile_cache import enable_compile_cache

    path = enable_compile_cache()
    if path is not None:
        return Path(path)
    global _PRIVATE_DIR
    if _PRIVATE_DIR is None:
        _PRIVATE_DIR = Path(tempfile.mkdtemp(prefix="tpu_bfs_torch_kernels_"))
        atexit.register(shutil.rmtree, _PRIVATE_DIR, True)
    return _PRIVATE_DIR


def build(*, force: bool = False, log=None) -> Path:
    """Compile the kernels if the sources changed; returns the library path.

    ``log`` (a callable) receives the compiler's output, which includes the
    ``-Xptxas -v`` register and shared-memory report of every kernel."""
    digest = source_hash()
    out_dir = kernel_dir()
    lib = out_dir / LIB_NAME
    stamp = out_dir / (LIB_NAME + ".sha")
    if not force and lib.is_file() and stamp.is_file() and stamp.read_text() == digest:
        return lib
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs, procs = [], []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *ARCH_FLAGS, *COMPILE_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )))
        failed = []
        for src, p in procs:
            out, _ = p.communicate()
            if log is not None and out:
                log(f"[nvcc {src.name}]\n{out.rstrip()}")
            if p.returncode:
                failed.append(f"{src.name} (rc {p.returncode}):\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib)
    stamp_tmp = out_dir / f"{LIB_NAME}.sha.{os.getpid()}"
    stamp_tmp.write_text(digest)
    os.replace(stamp_tmp, stamp)
    if log is not None:
        log(f"built {lib.name} from {len(objs)} sources in "
            f"{time.perf_counter() - t0:.1f}s")
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (pointers and
    the stream as c_void_p, so ctypes never truncates them to 32 bits)."""
    lib = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tpubfs_ell_expand.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    lib.tpubfs_ell_expand.restype = i
    lib.tpubfs_tile_spmm.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
    lib.tpubfs_tile_spmm.restype = i
    return lib


def check_launch(rc: int, kernel: str) -> None:
    """Raise if a C entry point reported a launch error."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError_t {rc}")
