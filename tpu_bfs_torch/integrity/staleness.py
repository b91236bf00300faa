"""CPU oracles of the served kinds, the oracle half of
``tpu_bfs/integrity/staleness.py``: a queue BFS and a binary-heap Dijkstra,
independent of every device code path (the reference's bfsCPU and
checkOutput discipline, bfs.cu:374-384).

The staleness auditor of the JAX module replays sampled answers of a
dynamic-graph service against a ring of generation snapshots; it waits
for its only reader, the dynamic serving branch (ROADMAP Queue 1
entry 4).
"""

from __future__ import annotations

import heapq
from collections import deque

import numpy as np

from tpu_bfs_torch.graph.csr import INF_DIST


def oracle_bfs(graph, source: int) -> np.ndarray:
    """Queue BFS distances (int32, INF_DIST unreached)."""
    n = graph.num_vertices
    dist = np.full(n, INF_DIST, np.int32)
    dist[source] = 0
    q = deque([int(source)])
    row_ptr, col_idx = graph.row_ptr, graph.col_idx
    while q:
        u = q.popleft()
        du = dist[u] + 1
        for v in col_idx[row_ptr[u]:row_ptr[u + 1]]:
            if dist[v] == INF_DIST:
                dist[v] = du
                q.append(int(v))
    return dist


def oracle_sssp(graph, source: int) -> np.ndarray:
    """Binary-heap Dijkstra over the int32 weights plane (int32, INF_DIST
    unreached). Parallel edge slots relax one by one, so the lightest
    wins."""
    n = graph.num_vertices
    dist = np.full(n, INF_DIST, np.int32)
    done = np.zeros(n, bool)
    dist[source] = 0
    heap = [(0, int(source))]
    row_ptr, col_idx, wts = graph.row_ptr, graph.col_idx, graph.weights
    while heap:
        d, u = heapq.heappop(heap)
        if done[u]:
            continue
        done[u] = True
        for j in range(int(row_ptr[u]), int(row_ptr[u + 1])):
            v = int(col_idx[j])
            nd = d + int(wts[j])
            if not done[v] and nd < dist[v]:
                dist[v] = nd
                heapq.heappush(heap, (nd, v))
    return dist


#: Kind -> oracle, for the kinds that answer a full distance row.
ORACLES = {"bfs": oracle_bfs, "sssp": oracle_sssp}
