"""CPU golden BFS oracles (the port's copy of ``tpu_bfs/reference/cpu_bfs.py``).

- ``bfs_python``: a dependency-free queue BFS, the analog of bfsCPU
  (bfs.cu:923-945). Parents are predecessor vertex ids.
- ``bfs_scipy``: scipy.sparse.csgraph at C speed, for large graphs.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from tpu_bfs_torch.graph.csr import INF_DIST, NO_PARENT, Graph


def bfs_python(g: Graph, source: int) -> tuple[np.ndarray, np.ndarray]:
    """Sequential queue BFS: (distance, parent), INF_DIST / -1 where unreached."""
    dist = np.full(g.num_vertices, INF_DIST, dtype=np.int32)
    parent = np.full(g.num_vertices, NO_PARENT, dtype=np.int32)
    dist[source] = 0
    parent[source] = source
    q = deque([source])
    row_ptr, col_idx = g.row_ptr, g.col_idx
    while q:
        u = q.popleft()
        du = dist[u]
        for v in col_idx[row_ptr[u] : row_ptr[u + 1]]:
            if dist[v] == INF_DIST:
                dist[v] = du + 1
                parent[v] = u
                q.append(v)
    return dist, parent


def bfs_scipy(g: Graph, source: int, *, csr=None) -> np.ndarray:
    """Distances only, via scipy.sparse.csgraph. ``csr`` reuses a prebuilt
    ``g.to_scipy()`` across sources."""
    import scipy.sparse.csgraph as csgraph

    d = csgraph.dijkstra(
        g.to_scipy() if csr is None else csr,
        unweighted=True, indices=source, min_only=False,
    )
    dist = np.full(g.num_vertices, INF_DIST, dtype=np.int32)
    reached = np.isfinite(d)
    dist[reached] = d[reached].astype(np.int32)
    return dist


def bfs_golden(g: Graph, source: int, *, python_threshold: int = 200_000):
    """The pure-Python oracle for small graphs, scipy for large ones."""
    if g.num_edges <= python_threshold:
        return bfs_python(g, source)[0]
    return bfs_scipy(g, source)
