"""Result validation (the port's copy of ``tpu_bfs/validate.py``).

- ``check_distances``: the reference's elementwise oracle compare
  (checkOutput, bfs.cu:374-384), returning the mismatches instead of exiting.
- ``check_parents``: property-based BFS-tree validation in the Graph500
  style: parent edges exist and satisfy dist[parent[v]] == dist[v] - 1;
  exactly the reached set has parents. The reference never validates its
  parents: they are atomic-race winners (bfs.cu:146-147, 940).
- ``check_edge_levels`` and ``certify_bfs``: the oracle-free certificate.
- ``min_parent_from_dist``: the deterministic min-parent tree implied by a
  distance array, the tree the device parent scan emits.
"""

from __future__ import annotations

import numpy as np

from tpu_bfs_torch.graph.csr import INF_DIST, NO_PARENT, Graph


class ValidationError(AssertionError):
    pass


def check_distances(dist: np.ndarray, expected: np.ndarray, *, max_report: int = 10) -> None:
    """Raise ValidationError naming the first mismatches, if any."""
    dist = np.asarray(dist)
    expected = np.asarray(expected)
    if dist.shape != expected.shape:
        raise ValidationError(f"shape mismatch: {dist.shape} vs {expected.shape}")
    bad = np.flatnonzero(dist != expected)
    if len(bad):
        lines = [f"  v={v}: got {dist[v]}, expected {expected[v]}" for v in bad[:max_report]]
        raise ValidationError(f"{len(bad)} distance mismatches:\n" + "\n".join(lines))


def check_parents(g: Graph, source: int, dist: np.ndarray, parent: np.ndarray) -> None:
    """Property-based parent (BFS tree) validation, vectorized:

    1. parent[source] == source and dist[source] == 0;
    2. v reached and v != source  =>  parent[v] is in range,
       dist[parent[v]] == dist[v] - 1, and edge (parent[v], v) exists;
    3. v unreached  =>  parent[v] == NO_PARENT.
    """
    dist = np.asarray(dist)
    parent = np.asarray(parent)
    v_count = g.num_vertices
    if dist.shape != (v_count,) or parent.shape != (v_count,):
        raise ValidationError("dist/parent shape mismatch")
    if dist[source] != 0 or parent[source] != source:
        raise ValidationError(f"source: dist={dist[source]}, parent={parent[source]}")
    reached = dist != INF_DIST
    if not np.all(parent[~reached] == NO_PARENT):
        raise ValidationError("unreached vertex with a parent")
    vs = np.flatnonzero(reached)
    vs = vs[vs != source]
    ps = parent[vs]
    if np.any(ps < 0) or np.any(ps >= v_count):
        raise ValidationError("reached vertex with out-of-range parent")
    bad_level = dist[ps] != dist[vs] - 1
    if np.any(bad_level):
        v = vs[np.argmax(bad_level)]
        raise ValidationError(f"v={v}: dist[parent]={dist[parent[v]]} but dist[v]={dist[v]}")
    # Edge existence: binary-search (parent, v) keys in the sorted edge keys.
    src_all, dst_all = g.coo
    n = np.int64(g.num_vertices)
    edge_keys = np.sort(src_all.astype(np.int64) * n + dst_all)
    query = ps.astype(np.int64) * n + vs
    pos = np.searchsorted(edge_keys, query)
    pos = np.minimum(pos, len(edge_keys) - 1)
    found = edge_keys[pos] == query if len(edge_keys) else np.zeros(len(vs), bool)
    if not np.all(found):
        v = vs[np.argmin(found)]
        raise ValidationError(f"edge (parent[v]={parent[v]}, v={v}) not in graph")


def check_edge_levels(g: Graph, dist: np.ndarray) -> None:
    """Graph500-style edge-level property: for every directed edge slot
    (u, v) with u reached, ``dist[v] <= dist[u] + 1`` (an unreached v
    violates it too). An undirected CSR holds both orientations, so this
    one sweep implies |dist[u] - dist[v]| <= 1 across every edge."""
    dist = np.asarray(dist).astype(np.int64)
    src, dst = g.coo
    du = dist[src]
    dv = dist[dst]
    bad = (du != INF_DIST) & (dv > du + 1)
    if np.any(bad):
        i = int(np.argmax(bad))
        raise ValidationError(f"edge ({src[i]}, {dst[i]}): dist {du[i]} -> {dv[i]} skips a level")


def certify_bfs(g: Graph, source: int, dist: np.ndarray, parent: np.ndarray) -> None:
    """Oracle-free certificate that (dist, parent) is a correct BFS of ``g``
    from ``source``. :func:`check_parents` gives every reached v a parent
    chain of strictly decreasing labels ending at the source, so dist[v] is
    a real path's length (>= the true distance); :func:`check_edge_levels`
    gives dist[v] <= dist[u] + 1 across every edge, so by induction along a
    shortest path dist[v] <= the true distance. Two vectorized O(E) host
    passes, feasible where a CPU rerun (bfs.cu:798-815) is not."""
    check_parents(g, source, dist, parent)
    check_edge_levels(g, dist)


def min_parent_from_dist(g: Graph, source: int, dist: np.ndarray) -> np.ndarray:
    """Deterministic min-parent tree implied by a distance array:
    parent[v] = min{u : (u, v) in E, dist[u] == dist[v] - 1} for reached
    v != source; the source maps to itself, unreached vertices to NO_PARENT."""
    dist = np.asarray(dist).astype(np.int64)
    src, dst = g.coo
    du = dist[src]
    dv = dist[dst]
    ok = (du != INF_DIST) & (du + 1 == dv)
    parent = np.full(g.num_vertices, np.iinfo(np.int64).max, dtype=np.int64)
    np.minimum.at(parent, dst[ok], src[ok])
    out = np.where(parent == np.iinfo(np.int64).max, NO_PARENT, parent).astype(np.int32)
    out[dist == INF_DIST] = NO_PARENT
    out[source] = source
    return out
