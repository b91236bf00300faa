"""Seeded graph generators, the port's NumPy copy of ``tpu_bfs/graph/generate.py``.

- ``random_graph``: the reference's seeded generator (readGraph,
  bfs.cu:892-907): m uniform edges, undirected double-insert.
- ``rmat_graph``: the Graph500 RMAT generator, with ``impl=``: the NumPy
  stream (the default) or the port's native C++ generator
  (``utils/native.py``), which draws a different stream, the one JAX's
  bench graphs come from.
- ``lj_standin_edges``: a directed stand-in with soc-LiveJournal1's exact
  vertex and edge counts; ``write_mtx`` writes it as MatrixMarket.
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
    impl: str = "numpy",
) -> tuple[np.ndarray, np.ndarray]:
    """Graph500 RMAT edge list: 2^scale vertices, edge_factor * 2^scale edges.

    Each of the `scale` bits of (u, v) is drawn from the quadrant
    distribution (a, b, c, d); vertex ids are then permuted, as the Graph500
    spec requires, to destroy the locality the recursion creates.

    ``impl``: 'numpy' (default — reproducible everywhere), 'native' (the
    threaded generator in native/rmat.cpp; raises if the library cannot be
    built), or 'auto' (native when built, else numpy). The
    two implementations are deterministic in the seed but are DIFFERENT
    streams: the same seed yields a different (equally distributed) graph per
    impl — callers that persist or compare results should pin one.
    """
    return _rmat_edges_m(
        scale, edge_factor << scale, seed=seed, impl=impl, a=a, b=b, c=c
    )


# Published soc-LiveJournal1 shape (SNAP): the reference's one named
# real-world workload (README.md:22). The real file is not fetched (see
# NONETWORK.md), so lj_standin_edges generates a clearly-labeled synthetic
# stand-in with the exact V/E counts.
LJ_V = 4_847_571
LJ_E = 68_993_773


def lj_standin_edges(
    *, seed: int = 1, impl: str = "auto"
) -> tuple[np.ndarray, np.ndarray]:
    """Directed power-law edge list with soc-LiveJournal1's exact shape.

    NOT the real graph — a deterministic stand-in: Graph500-parameter RMAT
    drawn on the enclosing 2^23 grid, restricted to ids < LJ_V by rejection
    (keeps the RMAT degree structure intact — no modulo folding artifacts),
    trimmed/topped-up to exactly LJ_E directed edges. Self-loops stay, as in
    the real SNAP file's reference treatment (bfs.cu:860-861 inserts
    whatever it reads).
    """
    scale = 23  # smallest power of two covering LJ_V
    p_keep = (LJ_V / (1 << scale)) ** 2
    # ONE vertex permutation shared by every top-up batch: raw recursion ids
    # from all batches refer to the same underlying RMAT node, so hubs keep
    # one identity across draws and the degree structure stays intact. The
    # permutation comes from a DISTINCT rng stream (seed sequence spawn key)
    # so the relabeling is independent of batch 1's quadrant draws — both
    # would otherwise replay the same PCG64 stream.
    perm = np.random.default_rng((seed, 0x4C4A)).permutation(1 << scale)
    u_parts, v_parts, total = [], [], 0
    s = seed
    while total < LJ_E:
        want = LJ_E - total
        draw = int(want / p_keep * 1.02) + 1024
        u, v = _rmat_edges_m(scale, draw, seed=s, impl=impl, permute=False)
        u, v = perm[u], perm[v]
        keep = (u < LJ_V) & (v < LJ_V)
        u, v = u[keep], v[keep]
        u_parts.append(u)
        v_parts.append(v)
        total += len(u)
        s += 1
    u = np.concatenate(u_parts)[:LJ_E]
    v = np.concatenate(v_parts)[:LJ_E]
    return u, v


def _rmat_edges_m(
    scale: int, m: int, *, seed: int, impl: str,
    a: float = 0.57, b: float = 0.19, c: float = 0.19,
    permute: bool = True,
):
    """RMAT draw of exactly ``m`` edges — the core behind ``rmat_edges``
    (which sizes by edge_factor). ``permute=False`` returns raw recursion
    ids so callers drawing multiple batches can apply ONE shared vertex
    permutation over all of them (lj_standin_edges)."""
    if impl not in ("auto", "numpy", "native"):
        raise ValueError(f"unknown impl {impl!r}")
    if not (a > 0 and b >= 0 and c >= 0 and a + b + c < 1):
        # d = 1-a-b-c must stay positive; a+b >= 1 makes c_norm a division
        # by zero. Phrased positively so NaN quadrants fail too (NaN makes
        # every comparison False). Same guard as native/rmat.cpp rc=3.
        raise ValueError(f"invalid RMAT quadrants a={a} b={b} c={c}")
    rng = np.random.default_rng(seed)
    uv = None
    if impl in ("auto", "native"):
        from tpu_bfs_torch.utils.native import rmat_edges_native

        uv = rmat_edges_native(scale, m, seed, a, b, c)
        if uv is None and impl == "native":
            raise RuntimeError(
                "native library not built (g++ at first use: tpu_bfs_torch/utils/native.py)")
    if uv is None:
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
        uv = u, v
    if not permute:
        return uv
    perm = rng.permutation(1 << scale)
    return perm[uv[0]], perm[uv[1]]


def write_mtx(path: str, u: np.ndarray, v: np.ndarray, n: int,
              comment: str = "") -> None:
    """Write a 1-indexed MatrixMarket coordinate-pattern file — the format
    of the reference's named workload (soc-LiveJournal1.mtx, README.md:22),
    consumed here by the native loader's .mtx path."""
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate pattern general\n")
        if comment:
            f.write(f"% {comment}\n")
        f.write(f"{n} {n} {len(u)}\n")
        # Chunked vectorized int->text: ~50x faster than np.savetxt.
        chunk = 4_000_000
        for i in range(0, len(u), chunk):
            a = (u[i : i + chunk] + 1).astype(np.int64)
            b = (v[i : i + chunk] + 1).astype(np.int64)
            pairs = np.char.add(
                np.char.add(a.astype("U10"), " "), b.astype("U10")
            )
            f.write("\n".join(pairs))
            f.write("\n")


def rmat_graph(
    scale: int,
    edge_factor: int = 16,
    *,
    seed: int = 1,
    drop_self_loops: bool = True,
    dedup: bool = False,
    impl: str = "numpy",
    weights: int | None = None,
    **quadrants,
) -> Graph:
    """RMAT graph, undirected (the Graph500 topology), from the ``impl``
    stream (:func:`rmat_edges`). ``weights=W`` attaches the
    :func:`edge_weights` plane, values in [1, W]; dedup keeps shortest
    paths, since parallel edges hash to one weight."""
    u, v = rmat_edges(scale, edge_factor, seed=seed, impl=impl, **quadrants)
    m = len(u)
    if drop_self_loops:
        keep = u != v
        u, v = u[keep], v[keep]
    w = None if weights is None else edge_weights(u, v, seed=seed, wmax=int(weights))
    return from_edges(
        u, v, num_vertices=1 << scale, directed=False, num_input_edges=m, dedup=dedup,
        weights=w,
    )
