"""Checkpoint and resume in the port, against the JAX package's.

Checkpoint files cross between the packages in both directions: a state
saved by tpu_bfs loads in tpu_bfs_torch and resumes there, and the other
way round, and every resume is bit-identical to an uninterrupted run (on
the raw packed tables and on distances, reached counts and ecc). The
files are the same bytes in layout (uint32 tables, a CRC32 over them); a
corrupted file raises CorruptCheckpointError and is quarantined. The JAX
package's relay (a gated checkpoint resumed on an ungated engine, and the
reverse) is mirrored. JAX runs on the CPU, the port with device="cpu".
"""

import numpy as np
import pytest

from tpu_bfs.algorithms.bfs import BfsEngine as JBfs
from tpu_bfs.algorithms.bfs_tiled import TiledBfsEngine as JTiled
from tpu_bfs.algorithms.msbfs_hybrid import HybridMsBfsEngine as JHybrid
from tpu_bfs.algorithms.msbfs_wide import WidePackedMsBfsEngine as JWide
from tpu_bfs.graph import generate as jgen
from tpu_bfs.graph import io as jio
from tpu_bfs.utils import checkpoint as jck

from tpu_bfs_torch.algorithms.bfs import BfsEngine
from tpu_bfs_torch.algorithms.bfs_tiled import TiledBfsEngine
from tpu_bfs_torch.algorithms.msbfs_hybrid import HybridMsBfsEngine
from tpu_bfs_torch.algorithms.msbfs_wide import WidePackedMsBfsEngine
from tpu_bfs_torch.graph import generate as tgen
from tpu_bfs_torch.graph import io as tio
from tpu_bfs_torch.utils import checkpoint as tck

LANES, PLANES, KCAP, TILE_THR = 64, 5, 8, 8


def _graphs():
    return jgen.rmat_graph(9, 8, seed=5), tgen.rmat_graph(9, 8, seed=5)


JG, TG = _graphs()
# Live, repeated and isolated sources.
SOURCES = np.r_[np.random.default_rng(3).choice(np.flatnonzero(TG.degrees > 0), size=40,
                                                 replace=False),
                np.flatnonzero(TG.degrees == 0)[:3], [0, 0]]


def make(pkg, engine, gate=False):
    g = JG if pkg == "jax" else TG
    kw = dict(lanes=LANES, kcap=KCAP, num_planes=PLANES, pull_gate=gate)
    if pkg == "jax":
        cls = JWide if engine == "wide" else JHybrid
        kw.update(interpret=True)
    else:
        cls = WidePackedMsBfsEngine if engine == "wide" else HybridMsBfsEngine
        kw.update(device="cpu")
    if engine == "hybrid":
        kw["tile_thr"] = TILE_THR
    return cls(g, **kw)


_engines = {}


def engine(pkg, kind, gate=False):
    key = (pkg, kind, gate)
    if key not in _engines:
        _engines[key] = make(pkg, kind, gate)
    return _engines[key]


def assert_same_result(res, want):
    assert res.num_levels == want.num_levels
    np.testing.assert_array_equal(res.reached, want.reached)
    np.testing.assert_array_equal(res.edges_traversed, want.edges_traversed)
    np.testing.assert_array_equal(res.ecc, want.ecc)
    for i in range(len(want.sources)):
        np.testing.assert_array_equal(res.distances_int32(i), want.distances_int32(i),
                                      err_msg=f"lane {i}")


def assert_same_packed(a, b):
    assert (a.level, a.alive) == (b.level, b.alive)
    np.testing.assert_array_equal(a.sources, b.sources)
    np.testing.assert_array_equal(a.iso, b.iso)
    for name in ("frontier", "visited", "planes"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype == np.uint32, name
        np.testing.assert_array_equal(x, y, err_msg=name)


# --- files -------------------------------------------------------------------


def test_single_source_files_cross_packages(tmp_path):
    ck = JBfs(JG).advance(JBfs(JG).start(5), 2)
    jck.save_checkpoint(str(tmp_path / "j.npz"), ck)
    mine = tck.load_checkpoint(str(tmp_path / "j.npz"))
    tck.save_checkpoint(str(tmp_path / "t.npz"), mine)
    back = jck.load_checkpoint(str(tmp_path / "t.npz"))
    for c in (mine, back):
        assert (c.source, c.level, c.nonce) == (ck.source, ck.level, ck.nonce)
        for name in ("frontier", "visited", "distance"):
            np.testing.assert_array_equal(getattr(c, name), getattr(ck, name))
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    with pytest.raises(ValueError, match="not a packed-batch checkpoint"):
        tck.load_packed_checkpoint(str(tmp_path / "j.npz"))


@pytest.mark.parametrize("kind", ["wide", "hybrid"])
def test_packed_files_cross_packages(kind, tmp_path):
    st = engine("jax", kind).advance(engine("jax", kind).start(SOURCES), 2)
    jck.save_packed_checkpoint(str(tmp_path / "j.npz"), st)
    mine = tck.load_packed_checkpoint(str(tmp_path / "j.npz"))
    assert_same_packed(mine, st)
    tck.save_packed_checkpoint(str(tmp_path / "t.npz"), mine)
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:  # the CRC too: the same bytes under it
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert_same_packed(jck.load_packed_checkpoint(str(tmp_path / "t.npz")), st)
    with pytest.raises(ValueError, match="packed-batch checkpoint"):
        tck.load_checkpoint(str(tmp_path / "t.npz"))


@pytest.mark.parametrize("damage", ["flip", "truncate"])
def test_corrupt_checkpoint_is_quarantined(damage, tmp_path):
    st = engine("torch", "wide").start(SOURCES)
    path = tmp_path / "c.npz"
    tck.save_packed_checkpoint(str(path), st)
    if damage == "flip":
        # Rewrite one table with a flipped bit under the old CRC.
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
        arrays["visited"] = arrays["visited"].copy()
        arrays["visited"][3, 0] ^= np.uint32(1 << 7)
        with open(path, "wb") as f:
            np.savez_compressed(f, **arrays)
    else:
        data = path.read_bytes()
        path.write_bytes(data[: len(data) // 2])
    with pytest.raises(tck.CorruptCheckpointError, match="quarantined"):
        tck.load_packed_checkpoint(str(path))
    assert not path.exists() and (tmp_path / "c.npz.corrupt").exists()
    # The JAX loader refuses the port's damaged files the same way.
    tck.save_packed_checkpoint(str(path), st)
    arrays = dict(np.load(path))
    arrays["planes"] = arrays["planes"] | np.uint32(1)
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)
    with pytest.raises(jck.CorruptCheckpointError):
        jck.load_packed_checkpoint(str(path))


# --- packed resume -------------------------------------------------------------

_full = {}


def jax_full(kind):
    if kind not in _full:
        eng = engine("jax", kind)
        _full[kind] = (eng.run(SOURCES), eng.advance(eng.start(SOURCES)))
    return _full[kind]


@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("kind", ["wide", "hybrid"])
def test_jax_checkpoint_resumes_in_port(kind, gate, tmp_path):
    want_res, want_end = jax_full(kind)
    jeng = engine("jax", kind, gate)
    st = jeng.advance(jeng.start(SOURCES), 2)
    jck.save_packed_checkpoint(str(tmp_path / "c.npz"), st)
    eng = engine("torch", kind, gate)
    end = eng.advance(tck.load_packed_checkpoint(str(tmp_path / "c.npz")))
    if not gate:  # gated raw planes differ off the active lanes (see the relay)
        assert_same_packed(end, want_end)
    assert_same_result(eng.finish(end), want_res)


@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("kind", ["wide", "hybrid"])
def test_port_checkpoint_resumes_in_jax(kind, gate, tmp_path):
    want_res, want_end = jax_full(kind)
    eng = engine("torch", kind, gate)
    st = eng.start(SOURCES)
    for _ in range(2):
        st = eng.advance(st, 1)
        tck.save_packed_checkpoint(str(tmp_path / "c.npz"), st)
        st = tck.load_packed_checkpoint(str(tmp_path / "c.npz"))
    jeng = engine("jax", kind, gate)
    end = jeng.advance(jck.load_packed_checkpoint(str(tmp_path / "c.npz")))
    if not gate:
        assert_same_packed(end, want_end)
    assert_same_result(jeng.finish(end), want_res)


@pytest.mark.parametrize("gate", [False, True])
@pytest.mark.parametrize("kind", ["wide", "hybrid"])
def test_port_chunks_equal_jax_chunks_and_one_run(kind, gate):
    # Chunk by chunk, the port's checkpoints equal JAX's bit for bit (gated
    # too: the same skipped blocks), and the finish equals an uninterrupted
    # run of the port.
    eng, jeng = engine("torch", kind, gate), engine("jax", kind, gate)
    st, jst = eng.start(SOURCES), jeng.start(SOURCES)
    assert_same_packed(st, jst)
    while not st.done:
        st, jst = eng.advance(st, 2), jeng.advance(jst, 2)
        assert_same_packed(st, jst)
        if gate:
            np.testing.assert_array_equal(eng.last_gate_level_counts.numpy(),
                                          np.asarray(jeng.last_gate_level_counts))
    assert_same_result(eng.finish(st), eng.run(SOURCES))
    assert eng.advance(st) is st  # a finished checkpoint stays as it is


def test_gated_checkpoint_relays_to_ungated_engine():
    """A checkpoint advanced under the gate finishes bit-identically on an
    ungated engine, and the reverse (tests/test_pull_gate.py's relay)."""
    gated, plain = engine("torch", "hybrid", True), engine("torch", "hybrid", False)
    srcs = SOURCES[:16]
    full = plain.run(srcs)
    for first, second in ((gated, plain), (plain, gated)):
        st = second.advance(first.advance(first.start(srcs), 2))
        res = second.finish(st)
        for i in range(len(srcs)):
            np.testing.assert_array_equal(res.distances_int32(i), full.distances_int32(i))
        np.testing.assert_array_equal(res.reached, full.reached)


@pytest.mark.parametrize("gate", [False, True])
def test_advance_at_the_plane_cap(gate):
    # A path of 40: from vertex 7 the eccentricity is 32, exactly the cap of
    # 5 planes, and the traversal ends cleanly; from vertex 0 it is 39, and
    # advancing raises. JAX's advance agrees on the clean end.
    n = 40
    jg = jio.from_edges(np.arange(n - 1), np.arange(1, n), num_vertices=n)
    tg = tio.from_edges(np.arange(n - 1), np.arange(1, n), num_vertices=n)
    eng = WidePackedMsBfsEngine(tg, lanes=32, kcap=4, num_planes=5, pull_gate=gate, device="cpu")
    jeng = JWide(jg, lanes=32, kcap=4, num_planes=5, pull_gate=gate, interpret=True)
    end, jend = eng.advance(eng.start([7])), jeng.advance(jeng.start([7]))
    assert (end.level, end.alive) == (jend.level, jend.alive) == (33, False)
    if not gate:
        assert_same_packed(end, jend)
    np.testing.assert_array_equal(eng.finish(end).distances_int32(0),
                                  eng.run([7]).distances_int32(0))
    with pytest.raises(RuntimeError, match="truncated"):
        eng.advance(eng.start([0]))


def test_checkpoint_rejects_mismatched_engine():
    st = engine("torch", "wide").start(SOURCES)
    other = WidePackedMsBfsEngine(TG, lanes=32, kcap=KCAP, num_planes=PLANES, device="cpu")
    with pytest.raises(ValueError, match="lane count and graph"):
        other.advance(st)
    fewer = WidePackedMsBfsEngine(TG, lanes=LANES, kcap=KCAP, num_planes=4, device="cpu")
    with pytest.raises(ValueError, match="planes"):
        fewer.advance(st)


# --- single-source resume ------------------------------------------------------

SINGLE = [("scan", False), ("dopt", False), ("segment", False), ("tiled", False),
          ("tiled", True)]


def single(pkg, backend, gate):
    g = JG if pkg == "jax" else TG
    if backend == "tiled":
        kw = {} if pkg == "jax" else {"device": "cpu"}
        return (JTiled if pkg == "jax" else TiledBfsEngine)(g, tile_thr=4, pull_gate=gate, **kw)
    if pkg == "jax":
        return JBfs(g, backend=backend)
    return BfsEngine(g, backend=backend, device="cpu")


def assert_same_single(a, b):
    assert (a.source, a.level) == (b.source, b.level)
    for name in ("frontier", "visited", "distance"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)


@pytest.mark.parametrize("backend,gate", SINGLE)
def test_single_source_checkpoints_cross_and_resume(backend, gate, tmp_path):
    src = int(SOURCES[0])
    eng, jeng = single("torch", backend, gate), single("jax", backend, gate)
    want = jeng.run(src)
    path = str(tmp_path / "c.npz")
    # JAX -> port.
    jck.save_checkpoint(path, jeng.advance(jeng.start(src), 2))
    st = eng.advance(tck.load_checkpoint(path))
    assert st.done
    res = eng.finish(st)
    np.testing.assert_array_equal(res.distance, want.distance)
    np.testing.assert_array_equal(res.parent, want.parent)
    assert (res.reached, res.num_levels) == (want.reached, want.num_levels)
    # Port -> JAX, one level a chunk, each chunk equal to JAX's.
    st, jst = eng.start(src), jeng.start(src)
    while not st.done:
        st, jst = eng.advance(st, 1), jeng.advance(jst, 1)
        assert_same_single(st, jst)
        tck.save_checkpoint(path, st)
        st = tck.load_checkpoint(path)
    np.testing.assert_array_equal(jeng.finish(jck.load_checkpoint(path)).distance, want.distance)
    np.testing.assert_array_equal(eng.finish(st).distance, eng.run(src).distance)


def test_single_source_checkpoint_moves_between_engines():
    # A checkpoint is in real vertex ids: scan starts, tiled advances,
    # dopt finishes; an isolated source ends at level 0 on the tiled engine.
    scan, tiled = single("torch", "scan", False), single("torch", "tiled", True)
    src = int(SOURCES[1])
    st = tiled.advance(scan.advance(scan.start(src), 1), 1)
    res = single("torch", "dopt", False).finish(scan.advance(st))
    np.testing.assert_array_equal(res.distance, scan.run(src).distance)
    iso = int(np.flatnonzero(TG.degrees == 0)[0])
    st = tiled.advance(tiled.start(iso))
    jst = single("jax", "tiled", True).advance(single("jax", "tiled", True).start(iso))
    assert_same_single(st, jst)
    assert st.done and tiled.finish(st).reached == 1
