"""The port's single-source BfsEngine against tpu_bfs's, exactly.

Every backend (scan, segment, scatter, delta, dopt) on every shared graph
(RMAT 10 and 12, a directed multigraph, the 200-vertex path, a sparse graph
with isolated vertices and an isolated source): distances, parents,
reached, num_levels, edges_traversed and level_sizes equal the JAX engine's
on the same seeded graph and sources, the port on device="cpu". The host
loop syncs once per level, checked on the path's 199 levels.
"""

import numpy as np
import pytest
import torch

from tpu_bfs.algorithms.bfs import BfsEngine as JBfsEngine

from tpu_bfs_torch.algorithms import bfs as tbfs
from tpu_bfs_torch.algorithms.bfs import BfsEngine, bfs
from tpu_bfs_torch.graph.csr import INF_DIST
from tpu_bfs_torch.reference import bfs_python
from torch_bfs_cases import NAMES, assert_same_result, graphs, sources

from torch_threads import cap_torch_threads

cap_torch_threads()

BACKENDS = ["scan", "segment", "scatter", "delta", "dopt"]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", NAMES)
def test_bfs_engine_equals_jax(name, backend):
    jg, tg = graphs(name)
    jeng = JBfsEngine(jg, backend=backend)
    teng = BfsEngine(tg, backend=backend, device="cpu")
    for s in sources(tg):
        want = jeng.run(int(s))
        got = teng.run(int(s))
        assert_same_result(got, want)
        np.testing.assert_array_equal(got.distance, bfs_python(tg, int(s))[0])


@pytest.mark.parametrize("backend", ["scan", "dopt"])
def test_max_levels_and_no_parents_equal_jax(backend):
    jg, tg = graphs("path200")
    want = JBfsEngine(jg, backend=backend).run(3, max_levels=17, with_parents=False)
    got = BfsEngine(tg, backend=backend, device="cpu").run(3, max_levels=17,
                                                         with_parents=False)
    assert_same_result(got, want)
    assert got.num_levels == 17 and got.parent is None


@pytest.mark.parametrize("backend", ["scan", "dopt"])
def test_one_host_sync_per_level(backend):
    _, tg = graphs("path200")
    eng = BfsEngine(tg, backend=backend, device="cpu")
    dist, level = eng.distances(0)
    # 199 levels that claim and the one that finds the frontier empty.
    assert level == 200 and eng.last_host_syncs == 200
    assert int(dist[199]) == 199


def test_distances_stay_on_the_device_tensor():
    _, tg = graphs("rmat10")
    eng = BfsEngine(tg, device="cpu")
    dist, level = eng.distances(5)
    assert isinstance(dist, torch.Tensor) and dist.dtype == torch.int32
    assert dist.shape == (eng.vp,) and level >= 1
    assert int(dist[eng.dg.num_vertices:].min()) == tbfs.INT32_MAX  # phantoms stay unreached


def test_time_it_and_teps():
    _, tg = graphs("rmat10")
    eng = BfsEngine(tg, backend="dopt", device="cpu")
    r = eng.run(5, time_it=True)
    assert r.elapsed_s > 0 and r.teps == r.edges_traversed / r.elapsed_s and eng._warmed
    assert BfsEngine(tg, device="cpu").run(5).teps is None


def test_bfs_convenience_and_caps():
    _, tg = graphs("rmat12")
    want = BfsEngine(tg, device="cpu").run(7)
    assert_same_result(bfs(tg, 7, backend="dopt", device="cpu"), want)
    # A one-rung ladder takes the sparse step wherever it fits.
    assert_same_result(BfsEngine(tg, backend="dopt", caps=(1024,), device="cpu").run(7), want)
    assert BfsEngine(tg, backend="dopt", caps=(4096, 1024, 4096), device="cpu").caps == (
        1024, 4096)


def test_isolated_source_reaches_itself():
    _, tg = graphs("isolated")
    s = int(sources(tg)[-1])
    r = BfsEngine(tg, device="cpu").run(s)
    assert (r.reached, r.num_levels, r.edges_traversed) == (1, 0, 0)
    assert r.parent[s] == s and (r.distance == INF_DIST).sum() == tg.num_vertices - 1


def test_errors():
    _, tg = graphs("rmat10")
    with pytest.raises(KeyError, match="unknown expansion backend"):
        BfsEngine(tg, backend="tiled", device="cpu")
    eng = BfsEngine(tg, device="cpu")
    for s in (-1, tg.num_vertices):
        with pytest.raises(ValueError, match="out of range"):
            eng.run(s)
    # The checkpoint entry points check their input as JAX's do.
    for s in (-1, tg.num_vertices):
        with pytest.raises(ValueError, match="out of range"):
            eng.start(s)
    st = eng.start(0)
    st.frontier, st.visited = st.frontier[:-1], st.visited[:-1]
    with pytest.raises(ValueError, match="vertices, graph has"):
        eng.advance(st)


def test_device_none_raises_without_cuda(monkeypatch):
    _, tg = graphs("rmat10")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BfsEngine(tg)
