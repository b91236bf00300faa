"""The port's native host library (tpu_bfs_torch/utils/native.py, built
from tpu_bfs_torch/native/*.cpp) against the JAX package's own
(tpu_bfs/utils/native.py over tpu_bfs/native/*.cpp).

Both libraries must build here (``g++``): these tests fail, never skip,
when either is missing. The RMAT stream, the counting sort's permutation,
the loader's graphs, ``write_mtx``'s bytes and every table ``build_hybrid``
makes from a native-stream graph must equal JAX's bit for bit.
"""

import pathlib

import numpy as np
import pytest

from tpu_bfs.algorithms.msbfs_hybrid import build_hybrid as jbuild_hybrid
from tpu_bfs.graph import generate as jgen
from tpu_bfs.graph import io as jio
from tpu_bfs.utils import native as jnative

from tpu_bfs_torch.algorithms.msbfs_hybrid import build_hybrid
from tpu_bfs_torch.graph import csr as tcsr
from tpu_bfs_torch.graph import generate as tgen
from tpu_bfs_torch.graph import io as tio
from tpu_bfs_torch.utils import compile_cache
from tpu_bfs_torch.utils import native

from torch_threads import cap_torch_threads

cap_torch_threads()

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _both_libraries():
    errs = []
    native.ensure_built(log=errs.append)
    assert native.has_rmat(), f"the port's native library did not build: {errs}"
    assert jnative.has_rmat(), "the JAX package's native library did not build"


def _same_graph(got, want):
    np.testing.assert_array_equal(got.row_ptr, want.row_ptr)
    np.testing.assert_array_equal(got.col_idx, want.col_idx)
    assert got.num_input_edges == want.num_input_edges
    assert got.undirected == want.undirected
    assert (got.weights is None) == (want.weights is None)
    if got.weights is not None:
        np.testing.assert_array_equal(got.weights, want.weights)


# --- the library itself -------------------------------------------------------

def test_library_is_the_ports_own():
    compile_cache.reset_resolution()
    try:
        path = native.library_path()
        lib = native._find_lib()
    finally:
        compile_cache.reset_resolution()
    assert lib is not None and pathlib.Path(lib._name) == path
    if path.resolve().is_relative_to(ROOT):
        assert path.resolve().is_relative_to(ROOT / "tpu_bfs_torch")
    assert path.is_file() and native.source_hash() in path.name
    assert "tpu_bfs/native" not in str(path) and "libtpubfs.so" not in str(path)
    assert hasattr(lib, "tpubfs_torch_rmat_edges")
    assert not hasattr(lib, "tpubfs_rmat_edges")


def test_default_library_lies_under_the_port(monkeypatch):
    for var in ("TPU_BFS_BENCH_XLA_CACHE", "TPU_BFS_BENCH_CACHE"):
        monkeypatch.delenv(var, raising=False)
    compile_cache.reset_resolution()
    try:
        path = native.library_path()
        native.ensure_built()
        assert native._find_lib() is not None
    finally:
        compile_cache.reset_resolution()
    assert path.parent == ROOT / "tpu_bfs_torch" / "build"
    assert path.is_file()


def test_changed_sources_get_a_new_library(tmp_path, monkeypatch):
    # A source edit changes the file name, so a handle loaded before never
    # masks it; the build lands whole through os.replace.
    for name in native.SOURCES:
        (tmp_path / name).write_bytes((native.NATIVE_DIR / name).read_bytes())
    monkeypatch.setattr(native, "NATIVE_DIR", tmp_path)
    before = native.library_path()
    with open(tmp_path / "rmat.cpp", "a") as f:
        f.write("\n// edited\n")
    after = native.library_path()
    assert before != after and before.parent == after.parent


def test_failed_build_logs_and_returns_none(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "NATIVE_DIR", tmp_path)
    for name in native.SOURCES:
        (tmp_path / name).write_text("this is not C++\n")
    msgs = []
    native.ensure_built(log=msgs.append)
    assert msgs and "native build failed" in msgs[0]
    assert not native.available() and not native.has_rmat()
    assert native.rmat_edges_native(6, 64, 1, 0.57, 0.19, 0.19) is None
    assert native.lexsort_pairs(np.zeros(3), np.zeros(3), 1, 1) is None
    assert native.load_edge_list_native(str(tmp_path / "x.txt")) is None
    with pytest.raises(RuntimeError, match="native library not built"):
        tgen.rmat_edges(6, 2, seed=1, impl="native")
    # 'auto' falls back to the NumPy stream, as in JAX.
    for a, b in zip(tgen.rmat_edges(6, 2, seed=1, impl="auto"),
                    jgen.rmat_edges(6, 2, seed=1, impl="numpy")):
        np.testing.assert_array_equal(a, b)


# --- RMAT ---------------------------------------------------------------------

@pytest.mark.parametrize("scale", range(8, 15))
@pytest.mark.parametrize("seed", [1, 7, 123456789])
def test_native_rmat_edges_equal_jax(scale, seed):
    m = (16 if scale < 13 else 4) << scale
    got = native.rmat_edges_native(scale, m, seed, 0.57, 0.19, 0.19)
    want = jnative.rmat_edges_native(scale, m, seed, 0.57, 0.19, 0.19)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.int64
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("quad", [(0.45, 0.15, 0.15), (0.25, 0.25, 0.25), (0.7, 0.1, 0.1),
                                  (0.57, 0.0, 0.19)])
@pytest.mark.parametrize("permute", [True, False])
def test_rmat_edges_m_native_equal_jax(quad, permute):
    a, b, c = quad
    for impl in ("native", "auto", "numpy"):
        got = tgen._rmat_edges_m(11, 70_001, seed=5, impl=impl, a=a, b=b, c=c, permute=permute)
        want = jgen._rmat_edges_m(11, 70_001, seed=5, impl=impl, a=a, b=b, c=c,
                                  permute=permute)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, y)
    got = tgen.rmat_edges(10, 8, seed=3, impl="native", a=a, b=b, c=c)
    want = jgen.rmat_edges(10, 8, seed=3, impl="native", a=a, b=b, c=c)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)


def test_native_stream_differs_from_numpy_and_ignores_threads():
    nat = tgen.rmat_edges(10, 8, seed=3, impl="native")
    assert not np.array_equal(nat[0], tgen.rmat_edges(10, 8, seed=3)[0])
    # More than one 64K-edge block: each block has its own generator, so
    # the stream cannot depend on how blocks fall to threads.
    m = 5 * (1 << 16) + 3
    a = native.rmat_edges_native(12, m, 9, 0.57, 0.19, 0.19)
    b = native.rmat_edges_native(12, m, 9, 0.57, 0.19, 0.19)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("args,rc", [
    ((0, 64, 1, 0.57, 0.19, 0.19), 2), ((41, 64, 1, 0.57, 0.19, 0.19), 2),
    ((6, -1, 1, 0.57, 0.19, 0.19), None), ((6, 64, 1, 0.6, 0.4, 0.0), 3),
    ((6, 64, 1, 0.0, 0.2, 0.2), 3), ((6, 64, 1, 0.5, -0.1, 0.2), 3),
    ((6, 64, 1, float("nan"), 0.2, 0.2), 3), ((6, 64, 1, 0.5, 0.2, float("nan")), 3),
])
def test_native_rmat_rejections_equal_jax(args, rc):
    with pytest.raises(ValueError) as got:
        native.rmat_edges_native(*args)
    with pytest.raises(ValueError) as want:
        jnative.rmat_edges_native(*args)
    assert str(got.value) == str(want.value)
    # A negative m fails in numpy's allocation first, on both sides.
    assert (f"(rc={rc})" if rc else "negative dimensions") in str(got.value)


@pytest.mark.parametrize("bad", [{"a": 0.0}, {"a": 0.6, "b": 0.4}, {"c": float("nan")}])
def test_rmat_quadrant_and_impl_errors_equal_jax(bad):
    for impl in ("native", "numpy", "auto"):
        with pytest.raises(ValueError) as got:
            tgen.rmat_edges(6, 2, seed=1, impl=impl, **bad)
        with pytest.raises(ValueError) as want:
            jgen.rmat_edges(6, 2, seed=1, impl=impl, **bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown impl 'cuda'"):
        tgen.rmat_edges(6, 2, seed=1, impl="cuda")


@pytest.mark.parametrize("kw", [{}, {"dedup": True}, {"weights": 8},
                                {"drop_self_loops": False}, {"edge_factor": 4, "weights": 3}])
def test_rmat_graph_native_equals_jax(kw):
    _same_graph(tgen.rmat_graph(11, seed=4, impl="native", **kw),
                jgen.rmat_graph(11, seed=4, impl="native", **kw))


def test_lj_standin_equals_jax(monkeypatch):
    # The LJ shape itself is 69M edges; the function at a grid-filling V
    # and a small E exercises the same rejection, shared permutation and
    # top-up draws on both sides.
    for mod in (tgen, jgen):
        monkeypatch.setattr(mod, "LJ_V", (1 << 23) - 4096)
        monkeypatch.setattr(mod, "LJ_E", 30_000)
    for impl in ("native", "numpy"):
        got = tgen.lj_standin_edges(seed=3, impl=impl)
        want = jgen.lj_standin_edges(seed=3, impl=impl)
        assert len(got[0]) == 30_000
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert (tgen.LJ_V, tgen.LJ_E) != (4_847_571, 68_993_773)


def test_lj_shape_constants_equal_jax():
    assert (tgen.LJ_V, tgen.LJ_E) == (jgen.LJ_V, jgen.LJ_E) == (4_847_571, 68_993_773)


# --- the counting sort --------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lexsort_pairs_equals_np_lexsort(seed):
    rng = np.random.default_rng(seed)
    n_major, n_minor = 50, 7
    major = rng.integers(0, n_major, size=5000)
    minor = rng.integers(0, n_minor, size=5000)  # many duplicate pairs
    perm = native.lexsort_pairs(major, minor, n_major, n_minor)
    np.testing.assert_array_equal(perm, np.lexsort((minor, major)))
    np.testing.assert_array_equal(perm, jnative.lexsort_pairs(major, minor, n_major, n_minor))
    assert native.lexsort_pairs(major[:0], minor[:0], 1, 1).shape == (0,)


@pytest.mark.parametrize("bounds", [(49, 7), (50, 6), (0, 7)])
def test_lexsort_pairs_undersized_bounds_return_none(bounds):
    rng = np.random.default_rng(4)
    major = rng.integers(0, 50, size=300)
    minor = rng.integers(0, 7, size=300)
    major[0], minor[0] = 49, 6
    assert native.lexsort_pairs(major, minor, *bounds) is None
    assert jnative.lexsort_pairs(major, minor, *bounds) is None
    neg = major.copy()
    neg[3] = -1
    assert native.lexsort_pairs(neg, minor, 50, 7) is None


def test_csr_lexsort_pairs_routes_and_falls_back():
    rng = np.random.default_rng(5)
    major = rng.integers(0, 40, size=2000)
    minor = rng.integers(0, 40, size=2000)
    want = np.lexsort((minor, major))
    np.testing.assert_array_equal(tcsr._lexsort_pairs(major, minor, 40), want)
    # Undersized bounds: the native sort rejects, np.lexsort answers.
    np.testing.assert_array_equal(tcsr._lexsort_pairs(major, minor, 10, 3), want)


def test_build_csr_weighted_equals_jax():
    rng = np.random.default_rng(6)
    src = rng.integers(0, 300, size=4000)
    dst = rng.integers(0, 300, size=4000)
    w = rng.integers(1, 9, size=4000).astype(np.int32)
    for kw in ({}, {"sort_neighbors": False}):
        _same_graph(tcsr.build_csr(src, dst, 300, weights=w, **kw),
                    jio.build_csr(src, dst, 300, weights=w, **kw))


# --- the loader ---------------------------------------------------------------

FIXTURES = [
    ("plain.txt", "4 3\n0 1\n1 2\n2 3\n"),
    ("comments.txt", "# c\n5 4\n0 1\n% x\n1 2\n\n2 3\n3 4\n"),
    ("selfloops.txt", "4 5\n0 0\n0 1\n1 1\n2 3\n3 3\n"),
    ("multi.txt", "3 4\n0 1\n0 1\n1 0\n2 2\n"),
    ("mtx.mtx", "%%MatrixMarket matrix coordinate pattern symmetric\n% c\n4 4 3\n1 2\n2 3\n3 4\n"),
    ("rect.mtx", "%%MatrixMarket matrix coordinate pattern general\n3 5 3\n1 5\n2 4\n3 3\n"),
    ("weighted.mtx", "%%MatrixMarket matrix coordinate real general\n3 3 2\n1 2 0.5\n2 3 1.5e2\n"),
    ("weighted.txt", "4 3\n0 1 7\n1 2 3\n3 3 1\n"),
    ("crlf.txt", "3 2\r\n0 1\r\n1 2\r\n"),
]


@pytest.mark.parametrize("kw", [{}, {"directed": True}, {"drop_self_loops": True},
                                {"directed": True, "drop_self_loops": True}])
@pytest.mark.parametrize("name,text", FIXTURES, ids=[f[0] for f in FIXTURES])
def test_load_edge_list_equals_jax(tmp_path, name, text, kw):
    p = tmp_path / name
    p.write_text(text)
    got = tio.load_edge_list(str(p), **kw)
    _same_graph(got, jio.load_edge_list(str(p), **kw))
    _same_graph(native.load_edge_list_native(str(p), **kw),
                jnative.load_edge_list_native(str(p), **kw))
    with open(p) as f:
        _same_graph(got, tio.read_edge_list_text(f.read(), **kw))


@pytest.mark.parametrize("name,text", [
    ("badheader.txt", "1 2 3 4\n0 1\n"), ("short.txt", "4 3\n0 1\n1 2\n"),
    ("range.txt", "3 1\n0 3\n"), ("empty.txt", ""),
])
def test_load_edge_list_errors_equal_jax(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    with pytest.raises(IOError) as got:
        native.load_edge_list_native(str(p))
    with pytest.raises(IOError) as want:
        jnative.load_edge_list_native(str(p))
    assert str(got.value) == str(want.value)
    jerr = terr = None
    try:
        jio.load_edge_list(str(p))
    except Exception as exc:  # noqa: BLE001 - the type and text are compared
        jerr = exc
    try:
        tio.load_edge_list(str(p))
    except Exception as exc:  # noqa: BLE001
        terr = exc
    assert type(terr) is type(jerr) and str(terr) == str(jerr)


def test_native_loader_missing_file(tmp_path):
    with pytest.raises(IOError, match=r"rc=1"):
        native.load_edge_list_native(str(tmp_path / "missing.txt"))


def test_write_mtx_bytes_equal_jax(tmp_path):
    u, v = tgen.rmat_edges(9, 4, seed=2, impl="native")
    tgen.write_mtx(str(tmp_path / "t.mtx"), u, v, 1 << 9, comment="stand-in")
    jgen.write_mtx(str(tmp_path / "j.mtx"), u, v, 1 << 9, comment="stand-in")
    assert (tmp_path / "t.mtx").read_bytes() == (tmp_path / "j.mtx").read_bytes()
    tgen.write_mtx(str(tmp_path / "t0.mtx"), u[:0], v[:0], 4)
    jgen.write_mtx(str(tmp_path / "j0.mtx"), u[:0], v[:0], 4)
    assert (tmp_path / "t0.mtx").read_bytes() == (tmp_path / "j0.mtx").read_bytes()
    # Read back through the native .mtx path: the same directed edges.
    g = tio.load_edge_list(str(tmp_path / "t.mtx"), directed=True)
    _same_graph(g, jio.from_edges(u, v, num_vertices=1 << 9, directed=True))


# --- the hybrid tables of a native-stream graph --------------------------------

def _same_fields(got, want, what):
    import dataclasses

    if dataclasses.is_dataclass(want):
        for f in dataclasses.fields(want):
            if hasattr(got, f.name):
                _same_fields(getattr(got, f.name), getattr(want, f.name), f"{what}.{f.name}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (a, b) in enumerate(zip(got, want)):
            _same_fields(a, b, f"{what}[{i}]")
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=what)
    elif want is None or isinstance(want, (int, float, bool, np.integer)):
        assert got == want, what


@pytest.mark.parametrize("scale,kw", [(12, {}), (11, {"kcap": 16, "tile_thr": 8}),
                                      (13, {"tile_thr": 32})])
def test_build_hybrid_on_native_graph_equals_jax(scale, kw):
    g = tgen.rmat_graph(scale, 16, seed=1, impl="native")
    jg = jgen.rmat_graph(scale, 16, seed=1, impl="native")
    _same_graph(g, jg)
    got, want = build_hybrid(g, **kw), jbuild_hybrid(jg, **kw)
    _same_fields(got, want, "hybrid")
    assert got.num_active == want.num_active and got.vt == want.vt
    assert got.num_dense_edges == want.num_dense_edges > 0
    assert len(got.res_light) == len(want.res_light) > 0


def test_port_never_loads_the_jax_library(tmp_path):
    # In a clean process: the port's native paths load its own library,
    # and JAX's libtpubfs.so is never mapped.
    import subprocess
    import sys

    from torch_threads import subprocess_env

    p = tmp_path / "g.txt"
    p.write_text("4 3\n0 1\n1 2\n2 3\n")
    code = (
        "import numpy as np\n"
        "from tpu_bfs_torch.graph import generate, io, csr\n"
        "from tpu_bfs_torch.utils import native\n"
        "generate.rmat_graph(8, 4, seed=1, impl='native')\n"
        f"io.load_edge_list({str(p)!r})\n"
        "csr._lexsort_pairs(np.arange(5), np.zeros(5, np.int64), 5)\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'libtpubfs.so' not in maps, 'JAX library mapped'\n"
        "assert str(native.library_path()) in maps, 'port library not mapped'\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, timeout=120,
                   env=subprocess_env(PYTHONPATH=str(ROOT)))
