"""BFS-tree output of the PyTorch port against the JAX package, bit for bit.

The port's validate functions, ParentScanner, and the packed results'
parents_int32 / parents_into (device scan and host path) run on the same
seeded graphs and sources as their tpu_bfs counterparts, the port on
device="cpu" (the kernel's plain twin, op="min"). Trees must be equal
exactly; the validators must raise the same error on the same corrupted
tree, or pass on both sides. The card's path policy (the scan, never a
host fallback; errors, out of memory included, propagate), the scanner
cache policy and the row-space map are pinned on the port alone.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_bfs import validate as jval
from tpu_bfs.algorithms.msbfs_hybrid import HybridMsBfsEngine as JHybrid
from tpu_bfs.algorithms.msbfs_wide import WidePackedMsBfsEngine as JWide
from tpu_bfs.algorithms.parent_scan import ParentScanner as JScanner
from tpu_bfs.algorithms.parent_scan import ParentScanUnavailable as JUnavailable
from tpu_bfs.graph import ell as jell
from tpu_bfs.graph import generate as jgen
from tpu_bfs.graph import io as jio

from tpu_bfs_torch import convert
from tpu_bfs_torch import validate as tval
from tpu_bfs_torch.algorithms import _packed_common as tpc
from tpu_bfs_torch.algorithms.msbfs_hybrid import HybridMsBfsEngine, build_hybrid
from tpu_bfs_torch.algorithms.msbfs_packed import UNREACHED
from tpu_bfs_torch.algorithms.msbfs_wide import WidePackedMsBfsEngine
from tpu_bfs_torch.algorithms.parent_scan import ParentScanner, ParentScanUnavailable
from tpu_bfs_torch.graph import ell as tell
from tpu_bfs_torch.graph.csr import INF_DIST
from tpu_bfs_torch.graph.ell import build_ell
from tpu_bfs_torch.ops import ell_expand as k1
from tpu_bfs_torch.reference import bfs_scipy

KCAP = 8  # heavy rows at these sizes: the fold pyramid runs under umin

# name -> JAX graph builder; the port gets the same arrays through convert.
GRAPHS = {
    "random_small": lambda: jgen.random_graph(500, 2000, seed=12345),
    "random_disconnected": lambda: jgen.random_graph(300, 150, seed=7),
    "rmat_small": lambda: jgen.rmat_graph(10, 8, seed=3),
    "directed": lambda: jgen.random_graph(400, 1500, seed=11, directed=True),
    # Distances up to 199: with 24 id bits, keys of real distances >= 128
    # set bit 31 too, so the decode must shift the unsigned key.
    "line": lambda: jio.from_edges(np.arange(199), np.arange(1, 200), num_vertices=200),
}
_graphs, _jax_runs = {}, {}


def graphs(name):
    """(JAX graph, the port's copy of it)."""
    if name not in _graphs:
        jg = GRAPHS[name]()
        _graphs[name] = (jg, convert.graph_from_numpy(dataclasses.asdict(jg)))
    return _graphs[name]


# ---------------------------------------------------------------- validate


def _corrupt(g, source, dist, parent, kind, rng):
    """A (dist, parent) pair broken in one way (``none``: the good tree)."""
    dist, parent = dist.copy(), parent.copy()
    reached = np.flatnonzero((dist != INF_DIST) & (np.arange(len(dist)) != source))
    deep = reached[dist[reached] >= 2]
    if kind == "source":
        parent[source] = (source + 1) % g.num_vertices
    elif kind == "unreached_parent":
        dist[reached[-1]] = INF_DIST
    elif kind == "bad_level":
        parent[deep[0]] = source
    elif kind == "out_of_range":
        parent[reached[0]] = g.num_vertices
    elif kind == "level_skip":
        dist[deep[-1]] += 1
    elif kind == "missing_edge":
        # A vertex one level up that is not an in-neighbor.
        src, dst = g.coo
        for v in rng.permutation(deep):
            ins = set(src[dst == v].tolist())
            cands = [u for u in np.flatnonzero(dist == dist[v] - 1) if u not in ins]
            if cands:
                parent[v] = cands[0]
                break
        else:
            raise AssertionError("no vertex to give a non-neighbor parent")
    return dist, parent


def _outcome(fn, *args):
    try:
        fn(*args)
    except AssertionError as exc:
        return type(exc).__name__, str(exc)
    return None


CORRUPTIONS = ["none", "source", "unreached_parent", "bad_level", "out_of_range",
               "level_skip", "missing_edge"]


@pytest.mark.parametrize("kind", CORRUPTIONS)
@pytest.mark.parametrize("name", ["random_small", "directed"])
def test_tree_checks_match_jax(name, kind):
    jg, tg = graphs(name)
    rng = np.random.default_rng(3)
    source = 1
    dist = bfs_scipy(tg, source)
    parent = tval.min_parent_from_dist(tg, source, dist)
    dist, parent = _corrupt(tg, source, dist, parent, kind, rng)
    fns = ["check_parents", "check_edge_levels", "certify_bfs"]
    got = [_outcome(getattr(tval, f), *((tg, dist) if f == "check_edge_levels"
                                        else (tg, source, dist, parent))) for f in fns]
    want = [_outcome(getattr(jval, f), *((jg, dist) if f == "check_edge_levels"
                                         else (jg, source, dist, parent))) for f in fns]
    assert got == want
    assert (got[2] is None) == (kind == "none")  # each corruption is caught


@pytest.mark.parametrize("name", list(GRAPHS))
def test_min_parent_from_dist_matches_jax(name):
    jg, tg = graphs(name)
    for s in (0, 7, tg.num_vertices - 1):
        dist = bfs_scipy(tg, s)
        np.testing.assert_array_equal(tval.min_parent_from_dist(tg, s, dist),
                                      jval.min_parent_from_dist(jg, s, dist))


def test_validation_error_is_the_same_kind():
    jg, tg = graphs("random_small")
    with pytest.raises(tval.ValidationError, match="shape mismatch"):
        tval.check_parents(tg, 0, np.zeros(3, np.int32), np.zeros(3, np.int32))
    assert issubclass(tval.ValidationError, AssertionError)


# ----------------------------------------------------------- ParentScanner


def _dist_cols(g, ell, sources):
    """[act, 128] uint8 distances of ``sources`` in ``ell``'s row order."""
    act = ell.num_active
    cols = np.full((act, 128), UNREACHED, np.uint8)
    for j, s in enumerate(sources):
        d = bfs_scipy(g, int(s))
        cols[:, j] = np.where(d == INF_DIST, UNREACHED, d)[ell.old_of_new[:act]]
    return cols


def _high_id_ell(ell, idbits):
    """``ell`` with original ids spread monotonically over [0, 2**idbits):
    keys of UNREACHED rows then set bit 31, where a signed compare fails."""
    v = 1 << idbits
    idmap = np.sort(np.random.default_rng(1).choice(v, size=ell.num_vertices,
                                                   replace=False)).astype(np.int32)
    return dataclasses.replace(ell, num_vertices=v, old_of_new=idmap[ell.old_of_new]), idmap


@pytest.mark.parametrize("high_ids", [False, True])
@pytest.mark.parametrize("name", ["rmat_small", "directed", "line"])
def test_scanner_matches_jax(name, high_ids):
    jg, tg = graphs(name)
    jax_ell = jell.build_ell(jg, kcap=KCAP)
    ell = convert.ell_from_numpy(dataclasses.asdict(jax_ell))
    sources = np.random.default_rng(4).choice(tg.num_vertices, size=100, replace=False)
    cols = _dist_cols(tg, ell, sources)
    want = np.full((ell.num_active, 128), -1, np.int32)
    for j, s in enumerate(sources):
        tree = tval.min_parent_from_dist(tg, int(s), bfs_scipy(tg, int(s)))
        want[:, j] = tree[ell.old_of_new[: ell.num_active]]
    if high_ids:
        ell, idmap = _high_id_ell(ell, 24)
        jax_ell = dataclasses.replace(jax_ell, num_vertices=ell.num_vertices,
                                      old_of_new=ell.old_of_new)
        want = np.where(want >= 0, idmap[np.maximum(want, 0)], -1)
        assert (int(UNREACHED) << 24) >= 1 << 31
    scanner = ParentScanner(ell, device="cpu")
    assert scanner.idbits == (24 if high_ids else (tg.num_vertices - 1).bit_length())
    got = scanner.scan(torch.from_numpy(cols))
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    jgot = np.asarray(JScanner(jax_ell).scan(jnp.asarray(cols)))
    np.testing.assert_array_equal(got.numpy(), jgot)
    np.testing.assert_array_equal(got.numpy(), want)


def test_scanner_rejects_unrepresentable_key_like_jax():
    jg, tg = graphs("random_small")
    with pytest.raises(ParentScanUnavailable, match="distance field"):
        ParentScanner(build_ell(tg, kcap=64), max_dist=2**28, device="cpu")
    with pytest.raises(JUnavailable, match="distance field"):
        JScanner(jell.build_ell(jg, kcap=64), max_dist=2**28)
    assert issubclass(ParentScanUnavailable, ValueError)


def test_scanner_checks_its_inputs():
    _, tg = graphs("random_small")
    ell = build_ell(tg, kcap=KCAP)
    scanner = ParentScanner(ell, device="cpu")
    with pytest.raises(ValueError, match="dist_cols must be"):
        scanner.scan(torch.zeros((ell.num_active, 64), dtype=torch.uint8))
    # Lent tables whose pads name another row than num_active (the hybrid's
    # residual sentinel is vt * 128 - 1) would gather past the key table.
    arrs = tpc.expand_arrays(ell, ell.num_active + 5, torch.device("cpu"))
    with pytest.raises(ValueError, match="sentinel"):
        ParentScanner(ell, arrs=arrs)


def test_wide_engine_lends_its_tables_with_the_scan_sentinel():
    _, tg = graphs("rmat_small")
    eng = WidePackedMsBfsEngine(tg, lanes=64, kcap=KCAP, device="cpu")
    ell, arrs = eng._full_parent_ell()
    assert ell is eng.ell and arrs is eng.arrs
    top = max(int(t.max()) for k, t in arrs.items() if k.endswith("_gt"))
    assert top == eng._act  # pads gather row act: all-zero in BFS, all-ones in the scan
    scanner = tpc.parent_scanner_of(eng)
    assert scanner.arrs is eng.arrs and tpc.parent_scanner_of(eng) is scanner


# ------------------------------------------------ parents_into vs tpu_bfs


def _jax_parents(name, engine, sources):
    key = (name, engine, tuple(int(s) for s in sources))
    if key not in _jax_runs:
        jg, _ = graphs(name)
        eng = JWide(jg, lanes=64, kcap=KCAP) if engine == "wide" else JHybrid(jg, lanes=256, kcap=KCAP,
                                                                   tile_thr=4)
        res = eng.run(np.asarray(sources))
        out = np.empty((len(sources), jg.num_vertices), np.int32)
        res.parents_into(out, device="device")
        _jax_runs[key] = out
    return _jax_runs[key]


def _port_engine(tg, engine, lanes=64):
    if engine == "wide":
        return WidePackedMsBfsEngine(tg, lanes=lanes, kcap=KCAP, device="cpu")
    return HybridMsBfsEngine(tg, lanes=lanes, kcap=KCAP, tile_thr=4, device="cpu")


def _sources(name):
    jg, _ = graphs(name)
    if name == "random_disconnected":
        iso = np.flatnonzero(jg.degrees == 0)
        return np.asarray([int(iso[0]), 0, 5, int(iso[1])])
    rng = np.random.default_rng(5)
    return rng.choice(np.flatnonzero(jg.degrees > 0), size=40, replace=False)


TREE_CASES = [(n, e) for n in ("random_small", "random_disconnected", "rmat_small", "directed")
              for e in ("wide", "hybrid")]


@pytest.mark.parametrize("name,engine", TREE_CASES)
def test_parents_bit_identical_to_jax(name, engine):
    _, tg = graphs(name)
    sources = _sources(name)
    want = _jax_parents(name, engine, sources)
    eng = _port_engine(tg, engine)
    if engine == "hybrid" and name != "random_disconnected":
        assert eng.hg.num_tiles > 0  # the scan must see the dense-tile edges
    res = eng.run(sources)
    for dev in ("device", "host"):
        out = np.full((len(sources), tg.num_vertices), 7, np.int32)
        assert res.parents_into(out, device=dev) is out
        np.testing.assert_array_equal(out, want, err_msg=dev)
    fresh = eng.run(sources)
    for i in range(len(sources)):
        np.testing.assert_array_equal(fresh.parents_int32(i), want[i], err_msg=f"lane {i}")
    assert fresh.parents_int32(1) is fresh.parents_int32(1)


def _rank_vertices_reversed_ties(src, dst, v):
    """rank_vertices with ties broken by descending id: another valid
    active-first, in-degree-sorted row order."""
    in_deg = np.bincount(dst, minlength=v).astype(np.int64)
    inactive = (in_deg == 0) & (np.bincount(src, minlength=v) == 0)
    order = np.lexsort((-np.arange(v), -in_deg, inactive)).astype(np.int32)
    rank = np.empty(v, np.int32)
    rank[order] = np.arange(v, dtype=np.int32)
    return in_deg, v - int(inactive.sum()), order, rank


@pytest.mark.parametrize("name", ["rmat_small", "random_disconnected"])
def test_hybrid_scan_through_permuted_row_map(name, monkeypatch):
    # The scanner's full ELL orders its rows differently from the engine:
    # the row map carries the engine's distance rows across by original id.
    _, tg = graphs(name)
    sources = _sources(name)
    want = _jax_parents(name, "hybrid", sources)
    eng = _port_engine(tg, "hybrid")
    res = eng.run(sources)
    monkeypatch.setattr(tell, "rank_vertices", _rank_vertices_reversed_ties)
    scanner = tpc.parent_scanner_of(eng)
    assert not np.array_equal(scanner.ell.rank, eng._rank)
    perm = res._scan_row_map(scanner)
    np.testing.assert_array_equal(perm.numpy(), eng._rank[scanner.ell.old_of_new[:eng._act]])
    out = np.empty((len(sources), tg.num_vertices), np.int32)
    res.parents_into(out, device="device")
    np.testing.assert_array_equal(out, want)
    monkeypatch.undo()
    assert res._scan_row_map(tpc.parent_scanner_of(eng)) is None  # the same rank order


def test_wide_rows_and_partial_last_pass():
    # 8192 lanes (w = 256, 64 passes' worth of words) with 200 sources: two
    # passes, the second UNREACHED-padded past its two real words.
    jg, tg = graphs("random_small")
    sources = np.arange(200) * 2
    res = WidePackedMsBfsEngine(tg, lanes=8192, kcap=KCAP, device="cpu").run(sources)
    out = np.empty((200, tg.num_vertices), np.int32)
    res.parents_into(out, device="device")
    for i in (0, 127, 128, 199):
        np.testing.assert_array_equal(
            out[i], jval.min_parent_from_dist(jg, int(sources[i]), res.distances_int32(i)))


# ------------------------------------------- availability and OOM contract


def _oracle(g, sources, res):
    return np.stack([tval.min_parent_from_dist(g, int(s), res.distances_int32(i))
                     for i, s in enumerate(sources)])


def _oom(*args, **kwargs):
    raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")


def test_scan_serves_prebuilt_ell_where_the_host_cannot():
    _, tg = graphs("random_small")
    res = WidePackedMsBfsEngine(build_ell(tg, kcap=KCAP), lanes=32, device="cpu").run([0, 3])
    with pytest.raises(ValueError, match="edge list"):
        res.parents_into(np.empty((2, tg.num_vertices), np.int32), device="host")
    with pytest.raises(ValueError, match="edge list"):
        res.parents_int32(0)
    out = np.empty((2, tg.num_vertices), np.int32)
    res.parents_into(out, device="device")
    np.testing.assert_array_equal(out, _oracle(tg, [0, 3], res))


def test_scan_unavailable_for_prebuilt_hybrid():
    _, tg = graphs("rmat_small")
    res = HybridMsBfsEngine(build_hybrid(tg, tile_thr=4), lanes=32, device="cpu").run([1])
    out = np.empty((1, tg.num_vertices), np.int32)
    with pytest.raises(ValueError, match="unavailable"):
        res.parents_into(out, device="device")
    with pytest.raises(ValueError, match="edge list"):
        res.parents_into(out, device="auto")


def test_scanner_cache_policy():
    _, tg = graphs("rmat_small")
    wide = _port_engine(tg, "wide")
    s1 = tpc.parent_scanner_of(wide)
    assert s1 is not None and tpc.parent_scanner_of(wide) is s1  # borrowed: cached
    hyb = _port_engine(tg, "hybrid")
    hyb.run([1]).parents_into(np.empty((1, tg.num_vertices), np.int32), device="device")
    assert getattr(hyb, "_parent_scanner_cache", None) is None  # owned: not cached
    # Unavailable is cached too.
    eng = _port_engine(tg, "wide")
    eng.max_levels_cap = 2**28
    assert tpc.parent_scanner_of(eng) is None and eng._parent_scanner_cache is False


def test_single_lane_rides_the_cached_scanner(monkeypatch):
    _, tg = graphs("random_small")
    sources = np.asarray([0, 17, 255, 499])
    res = _port_engine(tg, "wide").run(sources)
    res.parents_into(np.empty((4, tg.num_vertices), np.int32), device="device")
    assert res._engine._parent_scanner_cache  # the borrowed scanner is cached
    monkeypatch.setattr(tpc, "min_parents_lane", _oom)  # the host path is not taken
    for i in range(4):
        np.testing.assert_array_equal(res.parents_int32(i), _oracle(tg, sources, res)[i])
    assert list(res._pword_cache) == [0]


def _on_card(monkeypatch):
    """Give CPU results the card's policy (the engine's device is CUDA)."""
    monkeypatch.setattr(tpc.PackedBatchResult, "_on_card", lambda self: True)


@pytest.mark.parametrize("engine", ["wide", "hybrid"])
def test_card_trees_always_take_the_scan(engine, monkeypatch):
    # On the card, parents_int32 and parents_into('auto') run the device scan
    # and never the host scatter-min. A result's lanes share one scanner; the
    # hybrid's builds its own full ELL, here in another row order than the
    # engine's, so the single-lane pass goes through the row map too.
    _, tg = graphs("rmat_small")
    sources = _sources("rmat_small")
    want = _jax_parents("rmat_small", engine, sources)
    res = _port_engine(tg, engine).run(sources)
    _on_card(monkeypatch)
    monkeypatch.setattr(tpc, "min_parents_lane", _oom)
    monkeypatch.setattr(tell, "rank_vertices", _rank_vertices_reversed_ties)
    builds, init = [], ParentScanner.__init__

    def counted(self, *args, **kwargs):
        builds.append(1)
        init(self, *args, **kwargs)

    monkeypatch.setattr(ParentScanner, "__init__", counted)
    for i in (0, 1, 33, 39):
        np.testing.assert_array_equal(res.parents_int32(i), want[i], err_msg=f"lane {i}")
    if engine == "hybrid":
        assert not np.array_equal(res._scanner.ell.rank, res._engine._rank)
    out = np.empty_like(want)
    res.parents_into(out)
    np.testing.assert_array_equal(out, want)
    assert len(builds) == 1


def test_card_auto_raises_where_the_scan_is_unavailable(monkeypatch):
    # The key encoding cannot hold this level cap: on the CPU 'auto' serves
    # the trees from the host; on the card only an explicit 'host' does.
    _, tg = graphs("random_small")
    sources = np.asarray([0, 17])
    res = _port_engine(tg, "wide").run(sources)
    res._engine.max_levels_cap = 2**28
    want = _oracle(tg, sources, res)
    out = np.empty_like(want)
    np.testing.assert_array_equal(res.parents_into(out), want)
    _on_card(monkeypatch)
    for call in (lambda: res.parents_into(out), lambda: res.parents_int32(1)):
        with pytest.raises(ValueError, match="unavailable.*device='host'"):
            call()
    np.testing.assert_array_equal(res.parents_into(out, device="host"), want)


@pytest.mark.parametrize("device", ["auto", "device"])
def test_scan_oom_propagates(device, monkeypatch):
    # Out of memory is an error like any other: no mode moves the work to
    # the host behind the caller's back.
    _, tg = graphs("random_small")
    sources = np.asarray([0, 17, 499])
    res = _port_engine(tg, "wide").run(sources)
    monkeypatch.setattr(ParentScanner, "scan", _oom)
    monkeypatch.setattr(tpc, "min_parents_lane", _oom)
    with pytest.raises(torch.cuda.OutOfMemoryError, match="Tried to allocate"):
        res.parents_into(np.empty((3, tg.num_vertices), np.int32), device=device)
    _on_card(monkeypatch)
    with pytest.raises(torch.cuda.OutOfMemoryError, match="Tried to allocate"):
        res.parents_int32(1)


def test_scanner_build_oom(monkeypatch):
    _, tg = graphs("rmat_small")
    res = _port_engine(tg, "hybrid", lanes=128).run(np.arange(128))
    monkeypatch.setattr(ParentScanner, "__init__", _oom)
    out = np.empty((128, tg.num_vertices), np.int32)
    for device in ("auto", "device"):
        with pytest.raises(torch.cuda.OutOfMemoryError):
            res.parents_into(out, device=device)
    np.testing.assert_array_equal(res.parents_into(out, device="host"),
                                  _oracle(tg, np.arange(128), res))


def test_oom_propagates_when_the_host_cannot_serve(monkeypatch):
    _, tg = graphs("random_small")
    res = WidePackedMsBfsEngine(build_ell(tg, kcap=KCAP), lanes=32, device="cpu").run([0])
    monkeypatch.setattr(ParentScanner, "scan", _oom)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        res.parents_into(np.empty((1, tg.num_vertices), np.int32), device="auto")


def test_other_scan_errors_propagate(monkeypatch):
    _, tg = graphs("random_small")
    res = _port_engine(tg, "wide").run([0])

    def boom(self, dist_cols):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(ParentScanner, "scan", boom)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        res.parents_into(np.empty((1, tg.num_vertices), np.int32), device="auto")


def test_parents_into_validates_args():
    _, tg = graphs("random_small")
    res = _port_engine(tg, "wide").run([0, 1])
    with pytest.raises(ValueError, match="out is"):
        res.parents_into(np.empty((3, tg.num_vertices), np.int32))
    with pytest.raises(ValueError, match="auto|host|device"):
        res.parents_into(np.empty((2, tg.num_vertices), np.int32), device="gpu")
    with pytest.raises(IndexError):
        res.parents_int32(2)


def test_cpu_scan_launches_no_kernel():
    _, tg = graphs("rmat_small")
    res = _port_engine(tg, "hybrid").run(np.arange(8))
    before = k1.ell_expand.launches
    res.parents_into(np.empty((8, tg.num_vertices), np.int32), device="device")
    assert k1.ell_expand.launches == before  # CPU tensors take the plain twin
