"""The port's workload kinds (SSSP, CC, k-hop, p2p) against the JAX package.

Both sides run the same seeded graphs (those of tests/test_workloads.py):
the JAX engines as its own tests run them on the CPU (SSSP through its
XLA fori route and through the Pallas kernel in interpret mode), the port
on device="cpu" (K1's plain twin). Every comparison is exact equality:
weight planes and tables, distances, rounds, reached, ecc, labels, sweeps,
paths and levels. SciPy's dijkstra is the independent oracle of SSSP.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bfs.algorithms.msbfs_wide import WidePackedMsBfsEngine as JWide
from tpu_bfs.graph import ell as jell
from tpu_bfs.graph import generate as jgen
from tpu_bfs.graph import io as jio
from tpu_bfs.workloads import cc as jcc
from tpu_bfs.workloads import khop as jkhop
from tpu_bfs.workloads import p2p as jp2p
from tpu_bfs.workloads import sssp as jsssp

from tpu_bfs_torch import workloads as tw
from tpu_bfs_torch.algorithms import _packed_common as tpc
from tpu_bfs_torch.algorithms.msbfs_hybrid import HybridMsBfsEngine
from tpu_bfs_torch.algorithms.msbfs_packed import PackedMsBfsEngine
from tpu_bfs_torch.algorithms.msbfs_wide import WidePackedMsBfsEngine, expand_spec
from tpu_bfs_torch.graph import ell as tell
from tpu_bfs_torch.graph import generate as tgen
from tpu_bfs_torch.graph import io as tio
from tpu_bfs_torch.graph.csr import INF_DIST
from tpu_bfs_torch.reference import bfs_scipy
from tpu_bfs_torch.workloads.cc import CcServeEngine, connected_components, min_lane
from tpu_bfs_torch.workloads.khop import KhopServeEngine
from tpu_bfs_torch.workloads.p2p import P2pServeEngine
from tpu_bfs_torch.workloads.sssp import INF_W, SsspEngine

# The weighted graphs of tests/test_workloads.py, built by both packages.
WEIGHTED = {
    "random": (lambda m: m.random_graph(200, 900, seed=11, weights=7)),
    "rmat": (lambda m: m.rmat_graph(8, 8, seed=12, weights=5)),
    "directed": (lambda m: m.random_graph(200, 800, seed=13, directed=True, weights=9)),
}
_graphs = {}


def weighted(name):
    if name not in _graphs:
        _graphs[name] = (WEIGHTED[name](jgen), WEIGHTED[name](tgen))
    return _graphs[name]


def _dijkstra_oracle(g, sources):
    """SciPy dijkstra over the weighted graph, duplicate slots min-folded."""
    import scipy.sparse as sp
    from scipy.sparse import csgraph

    m = g.to_scipy(weighted=True).tocoo()
    key = m.row.astype(np.int64) * g.num_vertices + m.col
    order = np.lexsort((m.data, key))
    k2, d2 = key[order], m.data[order]
    first = np.ones(len(k2), bool)
    first[1:] = k2[1:] != k2[:-1]
    mm = sp.csr_matrix(
        (d2[first], (k2[first] // g.num_vertices, k2[first] % g.num_vertices)),
        shape=(g.num_vertices, g.num_vertices),
    )
    return csgraph.dijkstra(mm, directed=True, indices=sources)


# --- the weighted host layer ---------------------------------------------------


def test_edge_weights_equal_jax_on_uint64_range_pairs():
    rng = np.random.default_rng(0)
    u = rng.integers(0, 2**63, size=5000, dtype=np.uint64) * np.uint64(2)
    v = rng.integers(0, 2**63, size=5000, dtype=np.uint64) | np.uint64(1)
    for seed, wmax, wmin in ((1, 8, 1), (2**40 + 3, 100, 7), (-5, 1, 1)):
        got = tgen.edge_weights(u, v, seed=seed, wmax=wmax, wmin=wmin)
        np.testing.assert_array_equal(got, jgen.edge_weights(u, v, seed=seed, wmax=wmax,
                                                             wmin=wmin))
        assert got.dtype == np.int32 and got.min() >= wmin and got.max() <= wmax
        np.testing.assert_array_equal(got, tgen.edge_weights(v, u, seed=seed, wmax=wmax,
                                                             wmin=wmin))
    with pytest.raises(ValueError, match="wmin"):
        tgen.edge_weights(u, v, seed=1, wmax=0)


@pytest.mark.parametrize("dedup", [False, True])
def test_from_edges_weights_equal_jax(dedup):
    rng = np.random.default_rng(1)
    u = rng.integers(0, 60, size=400)
    v = rng.integers(0, 60, size=400)
    w = rng.integers(1, 9, size=400)  # parallel edges with different weights
    for directed in (False, True):
        kw = dict(num_vertices=60, directed=directed, dedup=dedup, weights=w)
        jg, tg = jio.from_edges(u, v, **kw), tio.from_edges(u, v, **kw)
        for f in ("row_ptr", "col_idx", "weights"):
            np.testing.assert_array_equal(getattr(tg, f), getattr(jg, f), err_msg=f)


@pytest.mark.parametrize("name", sorted(WEIGHTED))
def test_weighted_generators_and_ell_weights_equal_jax(name):
    jg, tg = weighted(name)
    for f in ("row_ptr", "col_idx", "weights"):
        np.testing.assert_array_equal(getattr(tg, f), getattr(jg, f), err_msg=f)
    for kcap in (64, 4):  # kcap 4 makes heavy rows and a fold pyramid
        je, te = jell.build_ell(jg, kcap=kcap), tell.build_ell(tg, kcap=kcap)
        jv, jl = jell.build_ell_weights(jg, je)
        tv, tl = tell.build_ell_weights(tg, te)
        assert (jv is None) == (tv is None) == (te.virtual is None)
        if tv is not None:
            np.testing.assert_array_equal(tv, jv)
        assert len(tl) == len(jl) == len(te.light)
        for a, b in zip(tl, jl):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tg.to_scipy(weighted=True).toarray(),
                                  jg.to_scipy(weighted=True).toarray())
    src, dst = tg.coo
    for a, b in list(zip(src, dst))[::37]:
        assert tg.has_edge(int(a), int(b)) and jg.has_edge(int(a), int(b))
    missing = np.flatnonzero(np.asarray(tg.to_scipy().toarray()[0]) == 0)[:5]
    assert not any(tg.has_edge(0, int(b)) for b in missing)


def test_attached_weights_equal_generated():
    """The flagship's SSSP graph attaches the plane to a built graph; the
    hash of the unordered pair makes that equal to generating it weighted."""
    g = tgen.rmat_graph(9, 8, seed=1)
    attached = dataclasses.replace(g, weights=tgen.edge_weights(*g.coo, seed=1, wmax=8))
    want = tgen.rmat_graph(9, 8, seed=1, weights=8)
    for f in ("row_ptr", "col_idx", "weights"):
        np.testing.assert_array_equal(getattr(attached, f), getattr(want, f), err_msg=f)
    with pytest.raises(ValueError, match="no weights"):
        g.to_scipy(weighted=True)
    with pytest.raises(ValueError, match="no weights"):
        tell.build_ell_weights(g, tell.build_ell(g))


def test_ell_weights_shape_pin():
    """A weight plane out of line with the ELL's buckets raises."""
    _, tg = weighted("random")
    ell = tell.build_ell(tg, kcap=8)
    assert ell.virtual is not None and len(ell.light) > 1
    with pytest.raises(AssertionError, match="light buckets"):
        tell.build_ell_weights(tg, dataclasses.replace(ell, light=ell.light[:-1]))
    short = dataclasses.replace(ell.virtual, idx=ell.virtual.idx[:-1])
    with pytest.raises(AssertionError, match="heavy bucket"):
        tell.build_ell_weights(tg, dataclasses.replace(ell, virtual=short))


# --- SSSP ------------------------------------------------------------------------

_jax_sssp = {}


def jax_sssp(name, impl, delta, lanes, sources):
    key = (name, impl, delta, lanes, tuple(sources))
    if key not in _jax_sssp:
        eng = jsssp.SsspEngine(weighted(name)[0], lanes=lanes, delta=delta, expand_impl=impl)
        _jax_sssp[key] = (eng, eng.run(sources))
    return _jax_sssp[key]


def sssp_sources(g, n=8):
    return np.flatnonzero(g.degrees > 0)[:n]


@pytest.mark.parametrize("name,delta,impl", [
    ("random", 0, "xla"), ("random", 0, "pallas"), ("random", 1, "xla"),
    ("random", 3, "xla"), ("random", 16, "xla"),
    ("rmat", 0, "xla"), ("rmat", 2, "xla"),
    ("directed", 0, "xla"), ("directed", 0, "pallas"), ("directed", 5, "xla"),
])
def test_sssp_equals_jax_and_dijkstra(name, delta, impl):
    jg, tg = weighted(name)
    sources = sssp_sources(tg)
    jeng, want = jax_sssp(name, impl, delta, 8, sources)
    eng = SsspEngine(tg, lanes=8, delta=delta, device="cpu")
    assert eng.delta == jeng.delta
    res = eng.run(sources)
    assert res.rounds == want.rounds
    assert eng.last_closes <= res.rounds
    assert eng.last_host_reads == res.rounds + eng.last_closes
    np.testing.assert_array_equal(res.reached, want.reached)
    np.testing.assert_array_equal(res.ecc, want.ecc)
    assert res.num_levels == want.num_levels
    oracle = _dijkstra_oracle(tg, sources)
    for i in range(len(sources)):
        got = res.distances_int32(i)
        np.testing.assert_array_equal(got, want.distances_int32(i), err_msg=f"lane {i}")
        d = got.astype(float)
        d[got == INF_DIST] = np.inf
        np.testing.assert_array_equal(d, oracle[i])
    assert res.extras(0) == {"weighted": True, "sssp_rounds": want.rounds}


def test_sssp_weight_planes_equal_jax_kernel_tables():
    """The padded weight planes K1 reads are the JAX Pallas route's."""
    jg, tg = weighted("rmat")
    jeng = jsssp.SsspEngine(jg, lanes=4, kcap=8, expand_impl="pallas")
    eng = SsspEngine(tg, lanes=4, kcap=8, device="cpu")
    names = [k for k in eng.arrs if k.endswith("_gt")]  # index and weight slabs
    assert any(k.startswith("virtual") for k in names) and len(names) > 6
    for k in names:
        np.testing.assert_array_equal(eng.arrs[k].numpy(), np.asarray(jeng.arrs[k]), err_msg=k)


@pytest.mark.parametrize("wsuf", ["w", "wl"])
def test_make_expand_minplus_equals_jax_fori(wsuf):
    """make_expand(op="minplus", wsuf=...) against the JAX
    _make_min_plus_expand on one ELL (kcap 8: heavy rows and their fold)."""
    jg, tg = weighted("random")
    jeng = jsssp.SsspEngine(jg, lanes=8, kcap=8, delta=3)
    eng = SsspEngine(tg, lanes=8, kcap=8, delta=3, device="cpu")
    assert eng.ell.num_heavy > 0
    rows = eng._table_rows
    rng = np.random.default_rng(4)
    dist = rng.integers(0, 60, size=(rows, 8)).astype(np.int32)
    dist[rng.random(dist.shape) < 0.4] = INF_W
    dist[-1] = INF_W  # the sentinel row
    want = jsssp._make_min_plus_expand(jsssp._Spec(jeng.ell), 8, wsuf)(
        jeng.arrs, jnp.asarray(dist))
    got = tpc.make_expand(expand_spec(eng.ell), 8, op="minplus", wsuf=wsuf)(
        eng.arrs, torch.from_numpy(dist))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="wsuf"):
        tpc.make_expand(expand_spec(eng.ell), 8, op="minplus")


def test_sssp_isolated_source_duplicates_and_errors():
    jg = jgen.random_graph(64, 60, seed=15, weights=3)
    tg = tgen.random_graph(64, 60, seed=15, weights=3)
    iso = int(np.flatnonzero(tg.degrees == 0)[0])
    live = int(np.flatnonzero(tg.degrees > 0)[0])
    sources = np.array([iso, live, live, iso])  # isolated and repeated
    want = jsssp.SsspEngine(jg, lanes=4).run(sources)
    res = SsspEngine(tg, lanes=4, device="cpu").run(sources)
    assert res.rounds == want.rounds
    np.testing.assert_array_equal(res.reached, want.reached)
    np.testing.assert_array_equal(res.ecc, want.ecc)
    for i in range(4):
        np.testing.assert_array_equal(res.distances_int32(i), want.distances_int32(i))
    d = res.distances_int32(0)
    assert d[iso] == 0 and res.reached[0] == 1 and res.ecc[0] == 0
    assert (np.delete(d, iso) == INF_DIST).all()
    with pytest.raises(ValueError, match="weight"):
        SsspEngine(tgen.random_graph(16, 32, seed=1), lanes=2, device="cpu")
    eng = SsspEngine(tg, lanes=2, device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        eng.run(np.array([64]))
    with pytest.raises(ValueError, match="sources"):
        eng.run(np.array([0, 1, 2]))
    with pytest.raises(RuntimeError, match="still relaxing"):
        SsspEngine(tg, lanes=2, max_rounds=1, device="cpu").run(np.array([live]))
    with pytest.raises(NotImplementedError, match="overlay"):
        SsspEngine(tg, lanes=2, overlay=(8, 4), device="cpu")


# --- CC --------------------------------------------------------------------------


@pytest.mark.parametrize("n,m,seed,lanes", [(400, 260, 21, 32), (300, 900, 22, 64),
                                            (96, 400, 8, 32)])
def test_cc_equals_jax(n, m, seed, lanes):
    directed = seed == 8  # reachability classes of the seed order
    jg = jgen.random_graph(n, m, seed=seed, directed=directed)
    tg = tgen.random_graph(n, m, seed=seed, directed=directed)
    want = jcc.connected_components(JWide(jg, lanes=lanes))
    got = connected_components(WidePackedMsBfsEngine(tg, lanes=lanes, device="cpu"))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    if not directed:
        from scipy.sparse import csgraph

        nc, lbl = csgraph.connected_components(tg.to_scipy(), directed=False)
        assert got[1] == nc
        # Each label is the smallest vertex id of its component.
        smallest = np.full(nc, tg.num_vertices)
        np.minimum.at(smallest, lbl, np.arange(tg.num_vertices))
        np.testing.assert_array_equal(got[0], smallest[lbl])


def test_min_lane_equals_jax_fold():
    rng = np.random.default_rng(6)
    for w in (1, 3, 8):
        vis = rng.integers(0, 2**32, size=(50, w), dtype=np.uint32)
        vis[rng.random((50, w)) < 0.6] = 0
        vis[5] = 0
        vis[7, 0] = 1 << 31
        want = jcc._make_min_lane(50, 45, w)(vis)
        got = min_lane(torch.from_numpy(vis.view(np.int32)), 45)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cc_serve_adapter_caches_index():
    g = tgen.random_graph(120, 200, seed=22)
    cs = CcServeEngine(WidePackedMsBfsEngine(g, lanes=32, device="cpu"))
    r1 = cs.run(np.array([0, 5, 9]))
    idx1 = cs._index
    r2 = cs.run(np.array([3]))
    assert cs._index is idx1
    ex = r1.extras(0)
    assert ex["components"] == r2.extras(0)["components"]
    assert int(r1.reached[0]) == ex["component_size"]
    with pytest.raises(ValueError, match="summaries"):
        r1.distances_int32(0)


# --- k-hop -----------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["wide", "hybrid", "packed"])
def test_khop_equals_jax(engine):
    jg, tg = jgen.rmat_graph(8, 6, seed=23), tgen.rmat_graph(8, 6, seed=23)
    srcs = np.flatnonzero(tg.degrees > 0)[:6]
    jk = jkhop.KhopServeEngine(JWide(jg, lanes=32))
    base = {"wide": lambda: WidePackedMsBfsEngine(tg, lanes=32, device="cpu"),
            "hybrid": lambda: HybridMsBfsEngine(tg, lanes=32, tile_thr=2, device="cpu"),
            "packed": lambda: PackedMsBfsEngine(tg, lanes=32, device="cpu")}[engine]()
    tk = KhopServeEngine(base)
    for k in (0, 1, 3):
        want, got = jk.run(srcs, k=k), tk.run(srcs, k=k)
        np.testing.assert_array_equal(got.reached, want.reached)
        assert [got.extras(i) for i in range(6)] == [{"k": k}] * 6
        for i, s in enumerate(srcs):
            d = bfs_scipy(tg, int(s))
            assert got.reached[i] == int(((d != INF_DIST) & (d <= k)).sum())
    with pytest.raises(ValueError, match="k must be"):
        tk.run(srcs, k=-1)


def test_khop_truncation_at_cap_raises():
    n = 40  # a path graph: depth 39 beyond the 2-plane cap of 4
    g = tio.from_edges(np.arange(n - 1), np.arange(1, n), num_vertices=n)
    kh = KhopServeEngine(WidePackedMsBfsEngine(g, lanes=32, num_planes=2, device="cpu"))
    assert int(kh.run(np.array([0]), k=3).reached[0]) == 4
    with pytest.raises(RuntimeError, match="truncated"):
        kh.run(np.array([0]), k=100)


# --- p2p -------------------------------------------------------------------------


@pytest.mark.parametrize("make,pairs,lanes", [
    (lambda m: m.rmat_graph(8, 6, seed=25), 20, 64),
    (lambda m: m.random_graph(150, 600, seed=26), 32, 64),
    (lambda m: m.random_graph(400, 260, seed=21), 16, 32),  # many unmet pairs
], ids=["rmat", "random", "sparse"])
def test_p2p_equals_jax(make, pairs, lanes):
    jg, tg = make(jgen), make(tgen)
    rng = np.random.default_rng(3)
    s = rng.integers(0, tg.num_vertices, size=pairs)
    t = rng.integers(0, tg.num_vertices, size=pairs)
    s[0] = t[0]  # a trivial pair
    want = jp2p.P2pServeEngine(JWide(jg, lanes=lanes)).run(s, targets=t)
    eng = P2pServeEngine(WidePackedMsBfsEngine(tg, lanes=lanes, device="cpu"))
    assert eng.lanes == lanes // 2 and eng.ladder_lanes == lanes
    got = eng.run(s, targets=t)
    np.testing.assert_array_equal(got.ecc, want.ecc)
    np.testing.assert_array_equal(got.reached, want.reached)
    assert eng.last_host_reads == 1 + 2 * int(got.ecc[0])
    assert eng.last_paths_s >= 0.0
    for i in range(pairs):
        ex = got.extras(i)
        assert ex == want.extras(i), i
        d = bfs_scipy(tg, int(s[i]))
        assert ex["distance"] == (int(d[t[i]]) if d[t[i]] != INF_DIST else None)
        if ex["path"] is not None:
            path = ex["path"]
            assert path[0] == s[i] and path[-1] == t[i] and len(path) == ex["distance"] + 1
            assert all(tg.has_edge(a, b) for a, b in zip(path, path[1:]))


def test_p2p_host_paths_equal_scan_paths():
    """Without a scanner the CPU walks the host scatter-min trees: the same
    paths as the scan's."""
    g = tgen.rmat_graph(8, 6, seed=25)
    s, t = np.array([1, 5, 9, 30]), np.array([200, 17, 9, 90])
    eng = P2pServeEngine(WidePackedMsBfsEngine(g, lanes=32, device="cpu"))
    scanned = eng.run(s, targets=t)
    assert eng.base._parent_scanner_cache  # the scan ran
    eng.base._parent_scanner_cache = False  # marks the engine as scanner-less
    host = eng.run(s, targets=t)
    assert [host.extras(i) for i in range(4)] == [scanned.extras(i) for i in range(4)]


def test_p2p_rejections():
    g = tgen.random_graph(96, 400, seed=8, directed=True)
    assert "p2p" not in tw.supported_kinds("wide", 1, g)
    with pytest.raises(ValueError, match="undirected"):
        P2pServeEngine(WidePackedMsBfsEngine(g, lanes=32, device="cpu"))
    ug = tgen.random_graph(96, 400, seed=8)
    with pytest.raises(ValueError, match="ungated"):
        P2pServeEngine(WidePackedMsBfsEngine(ug, lanes=32, pull_gate=True, device="cpu"))
    eng = P2pServeEngine(WidePackedMsBfsEngine(ug, lanes=32, device="cpu"))
    with pytest.raises(ValueError, match="pairs"):
        eng.run(np.arange(17), targets=np.arange(17))
    with pytest.raises(ValueError, match="target out of range"):
        eng.run(np.array([0]), targets=np.array([96]))
    with pytest.raises(ValueError, match="p2p answers carry the path"):
        eng.run(np.array([0])).distances_int32(0)


# --- the kind table ----------------------------------------------------------------


def test_kind_table_equals_jax():
    from tpu_bfs import workloads as jw

    assert tw.KINDS == jw.KINDS and tw.KIND_ENGINES == jw.KIND_ENGINES
    assert tw.METADATA_ONLY_KINDS == jw.METADATA_ONLY_KINDS
    graphs = [weighted("random")[1], weighted("directed")[1], tgen.random_graph(20, 30)]
    for g in graphs:
        for kind in tw.KINDS + ("nope",):
            for engine in ("wide", "hybrid", "packed", "dist2d"):
                for devices in (1, 4):
                    assert tw.kind_unsupported_reason(kind, engine, devices, g) == \
                        jw.kind_unsupported_reason(kind, engine, devices, g)
        assert tw.supported_kinds("wide", 1, g) == jw.supported_kinds("wide", 1, g)

    class Q:
        def __init__(self, kind, k=0, target=0):
            self.kind, self.k, self.target = kind, k, target

    for qs in ([Q("khop", k=3)], [Q("p2p", target=4), Q("p2p", target=9)], [Q("bfs")]):
        a, b = tw.batch_params(qs), jw.batch_params(qs)
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)


def test_build_workload_engine():
    g = weighted("random")[1]
    base = WidePackedMsBfsEngine(g, lanes=32, device="cpu")
    np.testing.assert_array_equal(tw.id_of_row_map(base), base.ell.old_of_new[: base._act])

    @dataclasses.dataclass
    class Spec:
        lanes: int = 4
        devices: int = 1
        device: str = "cpu"

    eng = tw.build_workload_engine("sssp", None, g, Spec())
    assert isinstance(eng, SsspEngine) and eng.lanes == 4
    for kind, cls in (("khop", KhopServeEngine), ("cc", CcServeEngine),
                      ("p2p", P2pServeEngine)):
        adapter = tw.build_workload_engine(kind, base, g, Spec())
        assert isinstance(adapter, cls) and adapter.completed_exchange_record() == (None, None)
        assert adapter.wire_bytes_per_level() is None
    # The mesh forms on a one-rank gloo mesh: devices > 1 needs a group of
    # that size, and the wide mesh engine's rows are chip-major (at one
    # rank, the rank order itself).
    from tpu_bfs_torch.parallel.dist_msbfs_wide import DistWideMsBfsEngine
    from tpu_bfs_torch.parallel.mesh import close_mesh, make_mesh

    mesh = make_mesh(device="cpu")
    try:
        with pytest.raises(ValueError, match="the process group has 1 ranks, not 4"):
            tw.build_workload_engine("sssp", None, g, Spec(devices=4))
        dbase = DistWideMsBfsEngine(g, mesh, lanes=32)
        want = np.full(dbase.sell.v_pad, -1, np.int64)
        want[dbase.sell.rank] = np.arange(g.num_vertices)
        np.testing.assert_array_equal(tw.id_of_row_map(dbase), want)
    finally:
        close_mesh()
    with pytest.raises(ValueError, match="unknown workload kind"):
        tw.build_workload_engine("bfs", base, g, Spec())
