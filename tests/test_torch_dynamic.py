"""The port's dynamic-graph layer (``tpu_bfs_torch/graph/dynamic.py`` and the
overlay engines) against the JAX package's (``tpu_bfs/graph/dynamic.py``).

The same numpy-seeded mutation batches go through both ``DynamicGraph``s:
stats, staged tables, their CRC, capacity errors and the materialized CSR
must be equal, and the generation files either package writes must load
in the other. The overlay fold runs on random tables in both packages; the
overlay wide, SSSP, CC and k-hop engines run with the same tables as JAX's
(its ``xla`` expansion, as its own tests run it) and as a fresh port engine
built over ``materialize()``. Every comparison is exact (tolerance 0). The
port runs on device="cpu", K1's plain twin.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bfs import faults as jfaults
from tpu_bfs.algorithms.msbfs_wide import WidePackedMsBfsEngine as JWide
from tpu_bfs.graph import dynamic as jdyn
from tpu_bfs.graph.generate import random_graph as jrandom
from tpu_bfs.integrity.staleness import StalenessAuditor as JAuditor
from tpu_bfs.workloads.cc import CcServeEngine as JCc
from tpu_bfs.workloads.khop import KhopServeEngine as JKhop
from tpu_bfs.workloads.sssp import SsspEngine as JSssp

from tpu_bfs_torch import faults as tfaults
from tpu_bfs_torch.algorithms.msbfs_wide import WidePackedMsBfsEngine
from tpu_bfs_torch.graph import dynamic as tdyn
from tpu_bfs_torch.graph.generate import random_graph as trandom
from tpu_bfs_torch.integrity.staleness import StalenessAuditor as TAuditor
from tpu_bfs_torch.integrity.staleness import oracle_bfs, oracle_sssp
from tpu_bfs_torch.utils.checkpoint import CorruptCheckpointError
from tpu_bfs_torch.workloads.cc import CcServeEngine
from tpu_bfs_torch.workloads.khop import KhopServeEngine
from tpu_bfs_torch.workloads.sssp import INF_W, SsspEngine

from torch_threads import cap_torch_threads

cap_torch_threads()

# The graph of tests/test_dynamic.py, and its overlay capacity (the override
# row carries a vertex's full adjacency, so kcap clears the max degree).
GRAPH = dict(num_vertices=96, num_edges=480, seed=3, weights=5)
CAP = (64, 32)
# A sparse graph with base-inactive (isolated) vertices.
SPARSE = dict(num_vertices=64, num_edges=40, seed=5, weights=3)


@pytest.fixture(autouse=True)
def _disarm_faults():
    yield
    jfaults.disarm()
    tfaults.disarm()


def graphs(spec):
    if spec.get("unsorted"):
        # Rows in a shuffled slot order (sort_neighbors=False): materialize
        # splices from a row-sorted copy of the base.
        from tpu_bfs.graph.io import build_csr as jbuild

        from tpu_bfs_torch.graph.csr import build_csr as tbuild

        g = trandom(**{k: v for k, v in spec.items() if k != "unsorted"})
        src, dst = g.coo
        perm = np.random.default_rng(9).permutation(len(src))
        kw = dict(num_input_edges=g.num_input_edges, sort_neighbors=False, undirected=True,
                  weights=g.weights[perm])
        return (jbuild(src[perm], dst[perm], g.num_vertices, **kw),
                tbuild(src[perm], dst[perm], g.num_vertices, **kw))
    return jrandom(**spec), trandom(**spec)


def same_graph(a, b) -> None:
    np.testing.assert_array_equal(np.asarray(a.row_ptr), np.asarray(b.row_ptr))
    np.testing.assert_array_equal(np.asarray(a.col_idx), np.asarray(b.col_idx))
    assert np.asarray(a.col_idx).dtype == np.asarray(b.col_idx).dtype
    assert (a.weights is None) == (b.weights is None)
    if a.weights is not None:
        np.testing.assert_array_equal(np.asarray(a.weights), np.asarray(b.weights))
    assert a.num_input_edges == b.num_input_edges
    assert a.undirected == b.undirected


def same_tables(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def both(fn_j, fn_t):
    """Run both sides; their results, or their exceptions' types and texts."""
    out = []
    for fn in (fn_j, fn_t):
        try:
            out.append(("ok", fn()))
        except Exception as exc:  # noqa: BLE001 — compared below
            out.append((type(exc).__name__, str(exc)))
    return out


# A stream of batches: adds (weighted and not), re-weights, removals, a
# revert to base, a capacity overflow, an out-of-range vertex, a bad weight.
STREAM = [
    dict(add=[(5, 90), (10, 11, 2)], remove=[(0, 1)]),
    dict(add=[(0, 95)], remove=[(5, 90)]),
    dict(add=[(7, 8, 1), (10, 11, 4)]),
    dict(add=[(0, 1, 3)]),
    dict(add=[(96, 1)]),
    dict(add=[(3, 4, 0)]),
    dict(add=[(i, i + 40) for i in range(12, 52)]),  # 80 more rows: overflow
    dict(remove=[(7, 8), (0, 95)]),
]


@pytest.mark.parametrize("spec,cap", [(GRAPH, CAP), (SPARSE, (8, 4)),
                                      ({**GRAPH, "weights": None}, (16, 32)),
                                      ({**GRAPH, "unsorted": True}, CAP)],
                         ids=["weighted", "sparse", "unweighted", "unsorted"])
def test_apply_stream_equals_jax(spec, cap):
    jg, tg = graphs(spec)
    jd, td = jdyn.DynamicGraph(jg, capacity=cap), tdyn.DynamicGraph(tg, capacity=cap)
    assert jd._act == td._act
    np.testing.assert_array_equal(jd._rank, td._rank)
    assert (td._sorted_base is tg) == (not spec.get("unsorted"))
    stream = list(STREAM)
    if spec is SPARSE:
        iso = int(np.flatnonzero(tg.degrees == 0)[0])
        live = int(np.flatnonzero(tg.degrees > 0)[0])
        stream.insert(1, dict(add=[(live, iso)]))  # a base-inactive vertex
    raised = 0
    for batch in stream:
        rj, rt = both(lambda: jd.apply(**batch), lambda: td.apply(**batch))
        assert rj[0] == rt[0], (batch, rj, rt)
        if rj[0] == "ok":
            same_tables(rj[1][0], rt[1][0])
            assert tdyn.overlay_crc32(rt[1][0]) == jdyn.overlay_crc32(rj[1][0])
            assert rj[1][1] == rt[1][1]
        else:
            assert rj[1] == rt[1]
            raised += 1
        # A refused batch mutates nothing, on both sides alike.
        assert td.generation == jd.generation
        assert td.overlay_rows_used() == jd.overlay_rows_used()
        same_tables(jd.overlay_tables(), td.overlay_tables())
        same_graph(jd.materialize(), td.materialize())
    assert raised >= 3


def test_materialize_equals_host_edit_and_rank_is_the_engines():
    _, tg = graphs(GRAPH)
    td = tdyn.DynamicGraph(tg, capacity=CAP)
    # The overlay ids are ranks: DynamicGraph's ranking is the engine ELL's.
    ell = WidePackedMsBfsEngine(tg, lanes=32, device="cpu").ell
    np.testing.assert_array_equal(td._rank, ell.rank)
    assert td._act == ell.num_active
    td.apply(add=[(5, 90), (10, 11, 2)], remove=[(0, 1)])
    mat = td.materialize()
    assert mat.has_edge(5, 90) and mat.has_edge(90, 5) and mat.has_edge(11, 10)
    assert not mat.has_edge(0, 1) and not mat.has_edge(1, 0)
    lo = mat.row_ptr[10]
    assert mat.weights[lo + list(mat.col_idx[lo:mat.row_ptr[11]]).index(11)] == 2


def test_overlay_crc_and_empty_tables_equal_jax():
    for weighted in (False, True):
        jt = jdyn.empty_overlay_tables((8, 4), 96, weighted=weighted)
        tt = tdyn.empty_overlay_tables((8, 4), 96, weighted=weighted)
        same_tables(jt, tt)
        c0 = tdyn.overlay_crc32(tt)
        assert c0 == jdyn.overlay_crc32(jt)
        for key in tt:
            t2 = {k: np.array(v, copy=True) for k, v in tt.items()}
            t2[key].flat[3] ^= 1
            assert tdyn.overlay_crc32(t2) != c0
            assert tdyn.overlay_crc32(t2) == jdyn.overlay_crc32(t2)
    assert tdyn.OVERLAY_KEYS == jdyn.OVERLAY_KEYS
    assert tdyn.WEIGHTED_OVERLAY_KEYS == jdyn.WEIGHTED_OVERLAY_KEYS
    assert tdyn.DEFAULT_CAPACITY == jdyn.DEFAULT_CAPACITY


def test_generation_files_load_across_packages(tmp_path):
    jg, tg = graphs(GRAPH)
    jstore = jdyn.GenerationStore(str(tmp_path / "j"))
    tstore = tdyn.GenerationStore(str(tmp_path / "t"))
    assert tstore.current() is None and tstore.next_generation_id() == 1
    # The port writes, JAX reads; and the reverse.
    tstore.save(1, tg)
    tstore.set_current(1)
    jstore.save(1, jg)
    jstore.set_current(1)
    same_graph(jdyn.GenerationStore(tstore.root).load(1), tg)
    same_graph(tdyn.GenerationStore(jstore.root).load(1), jg)
    assert jdyn.GenerationStore(tstore.root).current() == 1
    assert open(tstore._path(1), "rb").read() == open(jstore._path(1), "rb").read()
    # An uncommitted generation (a dead compactor's) is quarantined.
    tstore.save(2, tg)
    out = tstore.quarantine_orphans()
    assert len(out) == 1 and out[0].endswith("gen_0002.npz.corrupt")
    assert tstore.current() == 1 and tstore.load(1) is not None
    # A corrupt artifact is quarantined at load.
    path = tstore.save(3, tg)
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(path, "wb").write(bytes(blob))
    with pytest.raises(CorruptCheckpointError):
        tstore.load(3)
    assert os.path.exists(path + ".corrupt") and not os.path.exists(path)


def test_compaction_equals_jax(tmp_path):
    jg, tg = graphs(GRAPH)
    jd, td = jdyn.DynamicGraph(jg, capacity=CAP), tdyn.DynamicGraph(tg, capacity=CAP)
    for d in (jd, td):
        d.apply(add=[(5, 90, 2)], remove=[(0, 1)])
    want = td.materialize()
    jnew = jd.compact(jdyn.GenerationStore(str(tmp_path / "j")))
    tstore = tdyn.GenerationStore(str(tmp_path / "t"))
    tnew = td.compact(tstore)
    same_graph(jnew, tnew)
    same_graph(tnew, want)
    assert td.overlay_rows_used() == 0 and td.generation == 1 and td.compactions == 1
    assert tstore.current() == 1
    # Post-compaction batches stack on the new base (new ranks, new tables).
    rj, rt = jd.apply(add=[(7, 8)]), td.apply(add=[(7, 8)])
    same_tables(rj[0], rt[0])
    assert rj[1] == rt[1]
    same_graph(jd.materialize(), td.materialize())


# --- the fold -------------------------------------------------------------------


@pytest.mark.parametrize("op", ["or", "minplus"])
def test_overlay_fold_equals_jax(op):
    rng = np.random.default_rng(41)
    rows, w, d, ko = 200, 8, 16, 6
    act = rows - 1
    if op == "or":
        fw = rng.integers(-(1 << 31), 1 << 31, (rows, w), dtype=np.int64).astype(np.int32)
        base = rng.integers(-(1 << 31), 1 << 31, (rows, w), dtype=np.int64).astype(np.int32)
        fw[act] = 0
        base[act] = 0
        jfw, jbase = fw.view(np.uint32), base.view(np.uint32)
    else:
        fw = np.where(rng.random((rows, w)) < 0.3, int(INF_W),
                      rng.integers(0, 50, (rows, w))).astype(np.int32)
        base = np.where(rng.random((rows, w)) < 0.3, int(INF_W),
                        rng.integers(0, 90, (rows, w))).astype(np.int32)
        fw[act] = INF_W
        base[act] = INF_W
        jfw, jbase = fw, base
    tables = tdyn.empty_overlay_tables((d, ko), act, weighted=op == "minplus")
    used = 11  # the rest stay pad rows
    tables["ov_rows"][:used] = rng.choice(act, used, replace=False)
    tables["ov_override"][:used] = rng.integers(0, 2, used)
    n_slots = rng.integers(0, ko + 1, used)
    for r in range(used):
        tables["ov_idx"][r, :n_slots[r]] = rng.integers(0, act, n_slots[r])
        if op == "minplus":
            tables["ov_w"][r, :n_slots[r]] = rng.integers(1, 9, n_slots[r])
    wkey = "ov_w" if op == "minplus" else None
    jarrs = {k: jnp.asarray(v) for k, v in tables.items()}
    want = jdyn.make_overlay_fold(lambda a, f: jnp.asarray(jbase), op=op,
                                  weights_key=wkey)(jarrs, jnp.asarray(jfw))
    tarrs = tdyn.device_overlay_tables(tables, (d, ko), "cpu", weighted=op == "minplus")
    got = tdyn.make_overlay_fold(lambda a, f: torch.from_numpy(base.copy()), op=op,
                                 weights_key=wkey)(tarrs, torch.from_numpy(fw))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).view(np.int32))
    assert not np.array_equal(got.numpy(), base)  # the fold did something
    with pytest.raises(ValueError, match="op must be"):
        tdyn.make_overlay_fold(None, op="min")
    with pytest.raises(ValueError, match="weights_key"):
        tdyn.make_overlay_fold(None, op="minplus")


# --- the overlay engines ------------------------------------------------------------


def _generations(dyn_j, dyn_t, batches):
    """Apply each batch on both sides and yield the staged tables."""
    for batch in batches:
        tj, _ = dyn_j.apply(**batch)
        tt, _ = dyn_t.apply(**batch)
        same_tables(tj, tt)
        yield tj, tt


BATCHES = [dict(add=[(5, 90), (1, 2, 3)], remove=[(0, 1)]),
           dict(add=[(17, 60, 1)], remove=[(5, 90), (2, 1)])]
SOURCES = np.asarray([5, 17, 42, 0, 90], dtype=np.int64)


def test_overlay_wide_engine_equals_jax_and_rebuild():
    jg, tg = graphs(GRAPH)
    jeng = JWide(jg, lanes=32, overlay=CAP)
    teng = WidePackedMsBfsEngine(tg, lanes=32, overlay=CAP, device="cpu")
    plain = WidePackedMsBfsEngine(tg, lanes=32, device="cpu").run(SOURCES)
    empty = teng.run(SOURCES)  # the armed empty overlay changes nothing
    for i in range(len(SOURCES)):
        np.testing.assert_array_equal(empty.distances_int32(i), plain.distances_int32(i))
    jd, td = jdyn.DynamicGraph(jg, capacity=CAP), tdyn.DynamicGraph(tg, capacity=CAP)
    for tj, tt in _generations(jd, td, BATCHES):
        jeng.set_overlay(tj)
        teng.set_overlay(tt)
        want, got = jeng.run(SOURCES), teng.run(SOURCES)
        fresh = WidePackedMsBfsEngine(td.materialize(), lanes=32, device="cpu").run(SOURCES)
        assert got.num_levels == want.num_levels
        np.testing.assert_array_equal(got.reached, want.reached)
        for i in range(len(SOURCES)):
            np.testing.assert_array_equal(got.distances_int32(i), want.distances_int32(i))
            np.testing.assert_array_equal(got.distances_int32(i), fresh.distances_int32(i))
            np.testing.assert_array_equal(got.distances_int32(i),
                                          oracle_bfs(td.materialize(), int(SOURCES[i])))


def test_overlay_sssp_engine_equals_jax_and_rebuild():
    jg, tg = graphs(GRAPH)
    jeng = JSssp(jg, lanes=8, overlay=CAP)
    teng = SsspEngine(tg, lanes=8, overlay=CAP, device="cpu")
    assert teng.delta == jeng.delta
    jd, td = jdyn.DynamicGraph(jg, capacity=CAP), tdyn.DynamicGraph(tg, capacity=CAP)
    # A re-weight (10, 11) forces an override row in the weighted overlay.
    batches = BATCHES + [dict(add=[(10, 11, 5), (3, 70, 1)])]
    for tj, tt in _generations(jd, td, batches):
        jeng.set_overlay(tj)
        teng.set_overlay(tt)
        np.testing.assert_array_equal(teng.arrs["ov_wl"].numpy(), np.asarray(jeng.arrs["ov_wl"]))
        want, got = jeng.run(SOURCES), teng.run(SOURCES)
        mat = td.materialize()
        fresh = SsspEngine(mat, lanes=8, delta=teng.delta, device="cpu").run(SOURCES)
        assert got.rounds == want.rounds
        np.testing.assert_array_equal(got.reached, want.reached)
        np.testing.assert_array_equal(got.ecc, want.ecc)
        for i in range(len(SOURCES)):
            np.testing.assert_array_equal(got.distances_int32(i), want.distances_int32(i))
            np.testing.assert_array_equal(got.distances_int32(i), fresh.distances_int32(i))
            np.testing.assert_array_equal(got.distances_int32(i),
                                          oracle_sssp(mat, int(SOURCES[i])))


def test_overlay_cc_and_khop_equal_jax():
    jg, tg = graphs(GRAPH)
    jbase, tbase = JWide(jg, lanes=32, overlay=CAP), WidePackedMsBfsEngine(
        tg, lanes=32, overlay=CAP, device="cpu")
    jcc, tcc = JCc(jbase), CcServeEngine(tbase)
    jk, tk = JKhop(jbase), KhopServeEngine(tbase)
    jd, td = jdyn.DynamicGraph(jg, capacity=CAP), tdyn.DynamicGraph(tg, capacity=CAP)
    # Cut vertex 3 off entirely, then bridge it back with one edge.
    cut = dict(remove=[(3, int(v)) for v in tg.col_idx[tg.row_ptr[3]:tg.row_ptr[4]]])
    for tj, tt in _generations(jd, td, BATCHES + [cut, dict(add=[(3, 95)])]):
        jcc.set_overlay(tj)
        tcc.set_overlay(tt)
        jk.set_overlay(tj)
        tk.set_overlay(tt)
        want, got = jcc.run(SOURCES), tcc.run(SOURCES)
        np.testing.assert_array_equal(got.reached, want.reached)
        assert [got.extras(i) for i in range(len(SOURCES))] == \
            [want.extras(i) for i in range(len(SOURCES))]
        for k in (1, 2):
            wk, gk = jk.run(SOURCES, k=k), tk.run(SOURCES, k=k)
            np.testing.assert_array_equal(gk.reached, wk.reached)
    labels = tcc._ensure_index().labels
    assert labels[3] == labels[95]


def test_overlay_refusals_equal_jax():
    jg, tg = graphs(GRAPH)
    rj, rt = both(lambda: JWide(jg, lanes=32, overlay=CAP, pull_gate=True),
                  lambda: WidePackedMsBfsEngine(tg, lanes=32, overlay=CAP,
                                                pull_gate=True, device="cpu"))
    assert rj == rt and rj[0] == "ValueError"
    tables = tdyn.empty_overlay_tables(CAP, 3)
    rj, rt = both(lambda: JWide(jg, lanes=32).set_overlay(tables),
                  lambda: WidePackedMsBfsEngine(tg, lanes=32, device="cpu").set_overlay(tables))
    assert rj == rt and rj[0] == "ValueError"
    bad = tdyn.empty_overlay_tables((8, 32), 3)
    rj, rt = both(lambda: JWide(jg, lanes=32, overlay=CAP).set_overlay(bad),
                  lambda: WidePackedMsBfsEngine(tg, lanes=32, overlay=CAP,
                                                device="cpu").set_overlay(bad))
    assert rj == rt and rj[0] == "ValueError"
    rj, rt = both(lambda: jdyn.DynamicGraph(jrandom(20, 30, seed=1, directed=True)),
                  lambda: tdyn.DynamicGraph(trandom(20, 30, seed=1, directed=True)))
    assert rj == rt and rj[0] == "ValueError"


# --- the fault hook and the staleness auditor ---------------------------------------


def test_fault_kinds_and_corrupt_overlay_equal_jax():
    spec = ("torn_flip@generation_flip:n=1,corrupt_overlay@generation_flip:n=1,"
            "compaction_crash@compact:n=1")
    assert tfaults.FaultSchedule.from_spec(spec).to_spec() == \
        jfaults.FaultSchedule.from_spec(spec).to_spec()
    tfaults.arm_from_spec("compaction_crash@compact:n=1")
    with pytest.raises(RuntimeError):
        tfaults.ACTIVE.hit("compact", generation=1)
    tfaults.arm_from_spec("torn_flip@generation_flip:n=1")
    assert tfaults.ACTIVE.take("generation_flip", "torn_flip") is True
    assert tfaults.ACTIVE.take("generation_flip", "torn_flip") is False
    t = tdyn.empty_overlay_tables((8, 4), 96, weighted=True)
    before = {k: np.array(v, copy=True) for k, v in t.items()}
    tfaults.arm_from_spec("corrupt_overlay@generation_flip:n=1")
    jfaults.arm_from_spec("corrupt_overlay@generation_flip:n=1")
    out, fired = tfaults.maybe_corrupt_overlay(t, generation=1)
    jout, jfired = jfaults.maybe_corrupt_overlay(t, generation=1)
    assert fired and jfired
    same_tables(out, jout)
    assert tdyn.overlay_crc32(out) != tdyn.overlay_crc32(before)
    same_tables(t, before)  # the input is never mutated
    assert tfaults.maybe_corrupt_overlay(t, generation=2) == (t, False)


class _Q:
    def __init__(self, r):
        self.id, self._r = "q", r

    def result(self, _t):
        return self._r


class _R:
    def __init__(self, kind, source, distances, ok=True):
        self.ok, self.kind, self.source = ok, kind, source
        self.distances = distances


class _P:
    def __init__(self, queries, generation):
        self.queries, self.generation = queries, generation


@pytest.mark.parametrize("bound", [0, 1])
def test_staleness_auditor_measures_against_the_stamp_as_jax(bound):
    """A correct service measures 0 (an in-flight answer pinned to an older
    generation is not stale); an answer reproducing an older generation
    than its stamp is, and over ``bound`` it fires the callback."""
    _, g = graphs(GRAPH)
    fired = {"j": [], "t": []}
    auds = {"j": JAuditor(rate=1.0, bound=bound, on_over_bound=lambda **kw: fired["j"].append(kw)),
            "t": TAuditor(rate=1.0, bound=bound, on_over_bound=lambda **kw: fired["t"].append(kw))}
    dyn = tdyn.DynamicGraph(g, capacity=CAP)
    dyn.apply(add=[(5, 90)], remove=[(0, 1)])
    g1 = dyn.materialize()
    junk = np.arange(g.num_vertices, dtype=np.int32)
    batches = [
        _P([_Q(_R("bfs", 5, oracle_bfs(g, 5)))], 0),  # pinned in flight
        _P([_Q(_R("bfs", 5, oracle_bfs(g1, 5)))], 1),  # correct after the flip
        _P([_Q(_R("bfs", 5, oracle_bfs(g, 5)))], 1),  # the torn shape
        _P([_Q(_R("sssp", 5, oracle_sssp(g, 5)))], 1),
        _P([_Q(_R("bfs", 5, junk))], 1),  # corruption, not staleness
        _P([_Q(_R("cc", 5, junk))], 1),  # no oracle for cc
    ]
    stats = {"j": [], "t": []}
    for side, aud in auds.items():
        aud.push_generation(0, g)
        aud.push_generation(1, g1)
        for p in batches:
            aud.observe_batch(p)
            stats[side].append(aud.stats())
    assert stats["t"] == stats["j"]
    assert fired["t"] == fired["j"]
    st = stats["t"][-1]
    assert st["stale"] == 2 and st["unmatched"] == 1 and st["errors"] == 0
    assert st["over_bound"] == (2 if bound == 0 else 0)
    if bound == 0:
        assert fired["t"][0]["staleness"] == 1
        assert fired["t"][0]["matched_generation"] == 0
        assert fired["t"][0]["served_generation"] == 1


def test_refused_batch_moves_the_edge_count_as_in_jax():
    """A fault of the reference kept by the port (ROADMAP Queue 3): a batch
    refused with OverlayCapacityError mutates no edge, yet the edge count
    it staged stays in ``num_input_edges`` of every later ``materialize``
    (and of a compaction, which then re-applies the batch and counts it
    twice). Both packages count alike."""
    jg, tg = graphs(GRAPH)
    cap = (4, 32)
    jd, td = jdyn.DynamicGraph(jg, capacity=cap), tdyn.DynamicGraph(tg, capacity=cap)
    clean = tdyn.DynamicGraph(tg, capacity=cap)
    refused = dict(add=[(20, 21), (22, 23), (24, 25)])  # 6 rows > 4
    later = dict(add=[(30, 31)])
    for d, err in ((jd, jdyn.OverlayCapacityError), (td, tdyn.OverlayCapacityError)):
        with pytest.raises(err):
            d.apply(**refused)
        assert d.generation == 0 and d.overlay_rows_used() == 0
        d.apply(**later)
    clean.apply(**later)
    same_graph(jd.materialize(), td.materialize())
    mat, want = td.materialize(), clean.materialize()
    np.testing.assert_array_equal(mat.col_idx, want.col_idx)  # no edge moved
    assert mat.num_input_edges == want.num_input_edges + 3  # the count did
