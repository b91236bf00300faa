"""Seeded graph generators, the port's NumPy copy of ``tpu_bfs/graph/generate.py``.

- ``random_graph``: the reference's seeded generator (readGraph,
  bfs.cu:892-907): m uniform edges, undirected double-insert.
- ``rmat_graph``: the Graph500 RMAT generator. Only the NumPy stream is
  ported; the JAX package's native C++ generator draws a different stream.
  The SSSP weight plane (``edge_weights``) is not ported yet.
"""

from __future__ import annotations

import numpy as np

from tpu_bfs_torch.graph.csr import Graph
from tpu_bfs_torch.graph.io import from_edges


def random_graph(
    num_vertices: int,
    num_edges: int,
    *,
    seed: int = 12345,
    directed: bool = False,
    drop_self_loops: bool = False,
) -> Graph:
    """Uniform random multigraph, seeded (bfs.cu:892-907)."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, num_vertices, size=num_edges, dtype=np.int64)
    v = rng.integers(0, num_vertices, size=num_edges, dtype=np.int64)
    if drop_self_loops:
        keep = u != v
        u, v = u[keep], v[keep]
    return from_edges(
        u, v, num_vertices=num_vertices, directed=directed, num_input_edges=num_edges,
    )


def rmat_edges(
    scale: int,
    edge_factor: int = 16,
    *,
    seed: int = 1,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
) -> tuple[np.ndarray, np.ndarray]:
    """Graph500 RMAT edge list: 2**scale vertices, edge_factor * 2**scale
    edges, vertex ids permuted as the Graph500 spec requires. The same
    stream as ``tpu_bfs.graph.generate.rmat_edges(impl="numpy")``."""
    if not (a > 0 and b >= 0 and c >= 0 and a + b + c < 1):
        raise ValueError(f"invalid RMAT quadrants a={a} b={b} c={c}")
    m = edge_factor << scale
    rng = np.random.default_rng(seed)
    u = np.zeros(m, dtype=np.int64)
    v = np.zeros(m, dtype=np.int64)
    ab = a + b
    a_norm = a / ab
    c_norm = c / (1.0 - ab)
    for _ in range(scale):
        u <<= 1
        v <<= 1
        r_u = rng.random(m)
        r_v = rng.random(m)
        u_bit = r_u > ab
        v_bit = np.where(u_bit, r_v > c_norm, r_v > a_norm)
        u |= u_bit
        v |= v_bit
    perm = rng.permutation(1 << scale)
    return perm[u], perm[v]


def rmat_graph(
    scale: int,
    edge_factor: int = 16,
    *,
    seed: int = 1,
    drop_self_loops: bool = True,
    dedup: bool = False,
    **quadrants,
) -> Graph:
    """RMAT graph, undirected (the Graph500 topology)."""
    u, v = rmat_edges(scale, edge_factor, seed=seed, **quadrants)
    m = len(u)
    if drop_self_loops:
        keep = u != v
        u, v = u[keep], v[keep]
    return from_edges(
        u, v, num_vertices=1 << scale, directed=False, num_input_edges=m, dedup=dedup,
    )
