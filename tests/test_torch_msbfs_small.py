"""The port's small-batch engines against tpu_bfs's, exactly: MsBfsEngine
(boolean [vp, K] state) per backend, and the 512-lane PackedMsBfsEngine at
32 lanes (w = 1) and 256 lanes (w = 8).

Same seeded graphs and sources on both sides, the port on device="cpu"
(K1's plain twin): distances, parents, reached, edges_traversed, ecc and
num_levels equal. The packed engine expands through ``make_expand`` (K1 per
bucket), which the test watches on the twin.
"""

import dataclasses

import numpy as np
import pytest

from tpu_bfs.algorithms.msbfs import MsBfsEngine as JMsBfs
from tpu_bfs.algorithms.msbfs_packed import PackedMsBfsEngine as JPacked
from tpu_bfs.graph import ell as jell

from tpu_bfs_torch import convert
from tpu_bfs_torch.algorithms.msbfs import MsBfsEngine
from tpu_bfs_torch.algorithms.msbfs_packed import (
    MAX_LEVELS,
    UNREACHED,
    PackedBfsResult,
    PackedMsBfsEngine,
)
from tpu_bfs_torch.graph.csr import INF_DIST
from tpu_bfs_torch.graph.ell import build_ell
from tpu_bfs_torch.ops import ell_expand as k1
from torch_bfs_cases import NAMES, graphs, sources

from torch_threads import cap_torch_threads

cap_torch_threads()


def batch_sources(g, n=6):
    # The shared picks (isolated source included) plus seeded repeats.
    extra = np.random.default_rng(8).integers(0, g.num_vertices, size=n)
    return np.concatenate([sources(g), extra, extra[:1]])


@pytest.mark.parametrize("backend", ["scan", "segment", "scatter", "delta"])
@pytest.mark.parametrize("name", ["rmat10", "directed", "path200", "isolated"])
def test_msbfs_equals_jax(name, backend):
    jg, tg = graphs(name)
    srcs = batch_sources(tg)
    want = JMsBfs(jg, backend=backend).run(srcs, with_parents=True)
    got = MsBfsEngine(tg, backend=backend, device="cpu").run(srcs, with_parents=True)
    np.testing.assert_array_equal(got.sources, want.sources)
    np.testing.assert_array_equal(got.distance, want.distance)
    np.testing.assert_array_equal(got.parent, want.parent)
    assert got.distance.shape == (len(srcs), tg.num_vertices)


def test_msbfs_max_levels_time_it_and_errors():
    jg, tg = graphs("path200")
    eng = MsBfsEngine(tg, device="cpu")
    got = eng.run([0, 199, 100], max_levels=30, time_it=True)
    want = JMsBfs(jg).run([0, 199, 100], max_levels=30)
    np.testing.assert_array_equal(got.distance, want.distance)
    assert got.parent is None and got.elapsed_s > 0 and eng.last_host_syncs == 30
    with pytest.raises(KeyError, match="unknown batched backend"):
        MsBfsEngine(tg, backend="dopt", device="cpu")
    for bad in ([], [[0, 1]], [200]):
        with pytest.raises(ValueError):
            eng.run(bad)


_packed = {}


def packed_pair(name, lanes):
    key = (name, lanes)
    if key not in _packed:
        jg, tg = graphs(name)
        srcs = batch_sources(tg)
        _packed[key] = (srcs, JPacked(jg, lanes=lanes).run(srcs),
                        PackedMsBfsEngine(tg, lanes=lanes, device="cpu"))
    return _packed[key]


@pytest.mark.parametrize("lanes", [32, 256])
@pytest.mark.parametrize("name", NAMES)
def test_packed_engine_equals_jax(name, lanes):
    srcs, want, eng = packed_pair(name, lanes)
    assert eng.w == lanes // 32 and eng.num_planes == 8 and eng.max_levels_cap == MAX_LEVELS
    got = eng.run(srcs)
    assert isinstance(got, PackedBfsResult)
    np.testing.assert_array_equal(got.distance_u8, want.distance_u8)
    np.testing.assert_array_equal(got.reached, want.reached)
    np.testing.assert_array_equal(got.edges_traversed, want.edges_traversed)
    np.testing.assert_array_equal(got.ecc, want.ecc)
    assert got.num_levels == want.num_levels
    for i in (0, 1, len(srcs) - 1):
        np.testing.assert_array_equal(got.distances_int32(i), want.distances_int32(i))
        np.testing.assert_array_equal(got.parents_int32(i), want.parents_int32(i))


@pytest.mark.parametrize("device", ["auto", "host"])
@pytest.mark.parametrize("name", ["rmat12", "isolated"])
def test_packed_parents_into_equals_jax(name, device):
    srcs, want, eng = packed_pair(name, 32)
    v = eng.num_vertices
    out, ref = np.empty((len(srcs), v), np.int32), np.empty((len(srcs), v), np.int32)
    np.testing.assert_array_equal(eng.run(srcs).parents_into(out, device=device),
                                  want.parents_into(ref))


def test_packed_expands_through_k1_per_bucket(monkeypatch):
    # Every level runs one ell_expand per ELL bucket (the twin on the CPU).
    _, tg = graphs("rmat12")
    eng = PackedMsBfsEngine(tg, lanes=64, kcap=8, device="cpu")
    buckets = (eng.ell.num_heavy > 0) + len(eng.ell.light)
    calls = []
    real = k1.ell_expand_plain
    monkeypatch.setattr(k1, "ell_expand_plain", lambda *a, **kw: calls.append(a[2].shape)
                        or real(*a, **kw))
    res = eng.run(batch_sources(tg))
    assert len(calls) == buckets * (res.num_levels + 1)
    assert all(s == (eng.ell.num_active + 1, 2) for s in calls)


def test_packed_prebuilt_ell_shared_and_jax_ell():
    jg, tg = graphs("rmat10")
    srcs = batch_sources(tg)
    want = JPacked(jg, lanes=32).run(srcs)
    ell = build_ell(tg)
    for lanes in (32, 256):  # one ELL, two engines (chip_smoke's packed phase)
        got = PackedMsBfsEngine(ell, lanes=lanes, device="cpu").run(srcs)
        np.testing.assert_array_equal(got.distance_u8, want.distance_u8)
        # A prebuilt ELL keeps no edge list: the trees come from the scan.
        v = tg.num_vertices
        out, ref = np.empty((len(srcs), v), np.int32), np.empty((len(srcs), v), np.int32)
        np.testing.assert_array_equal(got.parents_into(out, device="device"),
                                      want.parents_into(ref))
    ell = convert.ell_from_numpy(dataclasses.asdict(jell.build_ell(jg)))
    got = PackedMsBfsEngine(ell, lanes=32, device="cpu", undirected=False).run(srcs)
    np.testing.assert_array_equal(got.distance_u8, want.distance_u8)
    np.testing.assert_array_equal(got.edges_traversed, 2 * want.edges_traversed)


def test_packed_time_it_max_levels_and_errors():
    jg, tg = graphs("path200")
    eng = PackedMsBfsEngine(tg, lanes=32, device="cpu")
    got = eng.run([0, 150], max_levels=40, time_it=True)
    want = JPacked(jg, lanes=32).run([0, 150], max_levels=40)
    np.testing.assert_array_equal(got.distance_u8, want.distance_u8)
    assert got.num_levels == want.num_levels == 40 and got.elapsed_s > 0 and got.teps > 0
    assert got.distance_u8[0, 41] == UNREACHED and got.distances_int32(0)[41] == INF_DIST
    for bad in ({"lanes": 48}, {"lanes": 0}):
        with pytest.raises(ValueError, match="multiple of 32"):
            PackedMsBfsEngine(tg, device="cpu", **bad)
    with pytest.raises(ValueError, match="sources"):
        eng.run(np.arange(33))


def test_packed_raises_past_its_depth_cap():
    # 299 levels outlive the 8 planes: the port raises where the JAX engine
    # returns the first 254 levels; a smaller max_levels is a cut, no error.
    from tpu_bfs_torch.graph.io import from_edges

    u = np.arange(299)
    eng = PackedMsBfsEngine(from_edges(u, u + 1, num_vertices=300), lanes=32, device="cpu")
    with pytest.raises(RuntimeError, match="truncated at 254 levels"):
        eng.run([0])
    assert eng.run([0], max_levels=253).num_levels == 253
