"""Seeded graph generators, the port's NumPy copy of ``tpu_bfs/graph/generate.py``.

- ``random_graph``: the reference's seeded generator (readGraph,
  bfs.cu:892-907): m uniform edges, undirected double-insert.
- ``rmat_graph``: the Graph500 RMAT generator. Only the NumPy stream is
  ported; the JAX package's native C++ generator draws a different stream.
- ``edge_weights``: the SSSP weight plane, a hash of each edge's unordered
  endpoint pair and the seed; ``weights=W`` attaches it in both generators.
"""

from __future__ import annotations

import numpy as np

from tpu_bfs_torch.graph.csr import Graph
from tpu_bfs_torch.graph.io import from_edges


def edge_weights(
    u: np.ndarray, v: np.ndarray, *, seed: int, wmax: int = 8, wmin: int = 1
) -> np.ndarray:
    """Deterministic per-edge int32 weights in [wmin, wmax].

    A splitmix-style hash of the UNORDERED endpoint pair and the seed,
    computed in uint64 with wraparound: (u, v) and (v, u) agree (the
    undirected double-insert needs it), parallel edges draw one weight, and
    attaching the plane to a built graph (``edge_weights(*g.coo, ...)``)
    equals generating the graph with ``weights=``."""
    if not (1 <= wmin <= wmax):
        raise ValueError(f"need 1 <= wmin <= wmax, got [{wmin}, {wmax}]")
    u = np.asarray(u, dtype=np.uint64)
    v = np.asarray(v, dtype=np.uint64)
    a, b = np.minimum(u, v), np.maximum(u, v)
    with np.errstate(over="ignore"):  # uint64 wraparound is the mixer
        h = (
            a * np.uint64(0x9E3779B97F4A7C15)
            + b * np.uint64(0xC2B2AE3D27D4EB4F)
            + np.uint64(seed & 0xFFFFFFFFFFFFFFFF) * np.uint64(0xD6E8FEB86659FD93)
        )
        h ^= h >> np.uint64(33)
        h *= np.uint64(0xFF51AFD7ED558CCD)
        h ^= h >> np.uint64(33)
    span = np.uint64(wmax - wmin + 1)
    return (np.uint64(wmin) + h % span).astype(np.int32)


def random_graph(
    num_vertices: int,
    num_edges: int,
    *,
    seed: int = 12345,
    directed: bool = False,
    drop_self_loops: bool = False,
    weights: int | None = None,
) -> Graph:
    """Uniform random multigraph, seeded (bfs.cu:892-907). ``weights=W``
    attaches the :func:`edge_weights` plane, values in [1, W]."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, num_vertices, size=num_edges, dtype=np.int64)
    v = rng.integers(0, num_vertices, size=num_edges, dtype=np.int64)
    if drop_self_loops:
        keep = u != v
        u, v = u[keep], v[keep]
    w = None if weights is None else edge_weights(u, v, seed=seed, wmax=int(weights))
    return from_edges(
        u, v, num_vertices=num_vertices, directed=directed, num_input_edges=num_edges,
        weights=w,
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
    weights: int | None = None,
    **quadrants,
) -> Graph:
    """RMAT graph, undirected (the Graph500 topology). ``weights=W``
    attaches the :func:`edge_weights` plane, values in [1, W]; dedup keeps
    shortest paths, since parallel edges hash to one weight."""
    u, v = rmat_edges(scale, edge_factor, seed=seed, **quadrants)
    m = len(u)
    if drop_self_loops:
        keep = u != v
        u, v = u[keep], v[keep]
    w = None if weights is None else edge_weights(u, v, seed=seed, wmax=int(weights))
    return from_edges(
        u, v, num_vertices=1 << scale, directed=False, num_input_edges=m, dedup=dedup,
        weights=w,
    )
