"""Graphs and sources shared by the single-source and small-batch parity
tests of the PyTorch port (tests/test_torch_frontier.py, test_torch_bfs.py,
test_torch_bfs_tiled.py, test_torch_msbfs_small.py).

Each case builds the same graph twice from the same seed, once with
tpu_bfs and once with tpu_bfs_torch. The set covers RMAT scales 10 and 12,
a directed multigraph, the 200-vertex path (199 levels, one-vertex
frontiers), and a sparse multigraph with isolated vertices, whose sources
include an isolated one.
"""

import numpy as np

from tpu_bfs.graph import generate as jgen
from tpu_bfs.graph import io as jio

from tpu_bfs_torch.graph import generate as tgen
from tpu_bfs_torch.graph import io as tio


def _path(io, n=200):
    u = np.arange(n - 1)
    return io.from_edges(u, u + 1, num_vertices=n)


CASES = {
    "rmat10": (lambda: jgen.rmat_graph(10, 16, seed=11), lambda: tgen.rmat_graph(10, 16, seed=11)),
    "rmat12": (lambda: jgen.rmat_graph(12, 8, seed=2), lambda: tgen.rmat_graph(12, 8, seed=2)),
    "directed": (lambda: jgen.random_graph(400, 1500, seed=11, directed=True),
                 lambda: tgen.random_graph(400, 1500, seed=11, directed=True)),
    "path200": (lambda: _path(jio), lambda: _path(tio)),
    "isolated": (lambda: jgen.random_graph(300, 150, seed=7),
                 lambda: tgen.random_graph(300, 150, seed=7)),
}
NAMES = list(CASES)

_built = {}


def graphs(name):
    """(JAX graph, port graph), built once per process."""
    if name not in _built:
        jb, tb = CASES[name]
        _built[name] = (jb(), tb())
    return _built[name]


def sources(g, n: int = 3) -> np.ndarray:
    """The highest-degree vertex, vertex 0 and seeded picks, then an
    isolated vertex where the graph has one."""
    deg = g.degrees + np.bincount(g.col_idx, minlength=g.num_vertices)
    picks = [int(np.argmax(deg)), 0]
    picks += np.random.default_rng(3).integers(0, g.num_vertices, size=n - 2).tolist()
    iso = np.flatnonzero(deg == 0)
    if len(iso):
        picks.append(int(iso[0]))
    return np.asarray(picks, dtype=np.int64)


def assert_same_result(got, want):
    """Two single-source BfsResults agree exactly."""
    assert got.source == want.source
    np.testing.assert_array_equal(got.distance, want.distance)
    if want.parent is None:
        assert got.parent is None
    else:
        np.testing.assert_array_equal(got.parent, want.parent)
    assert (got.num_levels, got.reached, got.edges_traversed) == (
        want.num_levels, want.reached, want.edges_traversed)
    np.testing.assert_array_equal(got.level_sizes(), want.level_sizes())
    assert got.distance.dtype == np.int32
