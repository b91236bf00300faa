"""The plain reference against SciPy and against the port's Graph500
arithmetic, on small graphs of both families."""

from __future__ import annotations

import numpy as np
import pytest
import scipy.sparse as sp
from scipy.sparse.csgraph import connected_components, shortest_path

from bfsbench.graphs import urand
from bfsbench.reference import bfs, components, graph
from bfsbench.tests.conftest import gxx_builds


def family_edges(family: str, scale: int, cache_root):
    params = {"scale": scale, "edge_factor": 8, "seed": 5, "a": 0.57, "b": 0.19, "c": 0.19}
    if family == "kronecker":
        if not gxx_builds(cache_root):
            pytest.skip("g++ cannot build the frozen Kronecker generator here")
        from bfsbench.graphs import kronecker

        u, v = kronecker.edges(params, cache_root / "native")
    else:
        u, v = urand.edges(params, cache_root / "native")
    keep = u != v
    return u[keep].astype(np.int32), v[keep].astype(np.int32), 1 << scale


def scipy_dist(u, v, nv, sources):
    a = sp.coo_matrix((np.ones(len(u)), (u, v)), shape=(nv, nv)).tocsr()
    d = shortest_path(a, directed=False, unweighted=True, indices=sources)
    return np.where(np.isinf(d), bfs.UNREACHED, d).astype(np.int32)


@pytest.mark.parametrize("family", ["kronecker", "urand"])
@pytest.mark.parametrize("k", [1, 32, 40])
def test_bfs_matches_scipy(family, k, cache_root):
    u, v, nv = family_edges(family, 9, cache_root)
    row_ptr, col = graph.undirected_csr(u, v, nv)
    deg = graph.degrees(u, v, nv)
    rng = np.random.default_rng(k)
    sources = rng.choice(np.flatnonzero(deg > 0), size=k, replace=False)
    if k > 1:
        sources[-1] = int(np.flatnonzero(deg == 0)[0]) if (deg == 0).any() else sources[-1]
    got = bfs.distances(row_ptr, col, sources)
    np.testing.assert_array_equal(got, scipy_dist(u, v, nv, sources))
    np.testing.assert_array_equal(bfs.eccentricity(got), got.max(axis=1))


@pytest.mark.parametrize("family", ["kronecker", "urand"])
def test_components_match_scipy_and_graph500_counts(family, cache_root):
    from tpu_bfs_torch.graph.io import from_edges
    from tpu_bfs_torch.graph500 import traversed_edges
    from tpu_bfs_torch.graph.csr import INF_DIST

    u, v, nv = family_edges(family, 9, cache_root)
    row_ptr, col = graph.undirected_csr(u, v, nv)
    lab = components.labels(row_ptr, col)
    a = sp.coo_matrix((np.ones(len(u)), (u, v)), shape=(nv, nv)).tocsr()
    n, theirs = connected_components(a, directed=False)
    # the same partition: a label per scipy component and back
    assert len(np.unique(lab)) == n
    pairs = np.unique(np.stack([lab, theirs]), axis=1)
    assert pairs.shape[1] == n
    assert (lab <= np.arange(nv)).all() and (lab[lab] == lab).all()
    tab = components.table(lab, u)
    g = from_edges(u, v, num_vertices=nv, directed=False)
    keys = np.random.default_rng(3).choice(np.flatnonzero(graph.degrees(u, v, nv) > 0), 24,
                                           replace=False)
    d = scipy_dist(u, v, nv, keys)
    for key, row in zip(keys, d):
        dist = np.where(row == bfs.UNREACHED, INF_DIST, row).astype(np.int32)
        assert tab.traversed(np.array([key]))[0] == traversed_edges(g, dist)
        assert tab.reached(np.array([key]))[0] == np.count_nonzero(row != bfs.UNREACHED)


def test_bfs_takes_at_most_64_sources():
    row_ptr, col = graph.undirected_csr(np.array([0]), np.array([1]), 2)
    with pytest.raises(ValueError):
        bfs.distances(row_ptr, col, np.zeros(65, dtype=np.int64))
