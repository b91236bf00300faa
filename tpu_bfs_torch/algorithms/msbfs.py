"""Batched multi-source BFS over boolean state, the port of
``tpu_bfs/algorithms/msbfs.py``.

The reference runs one source per process (bfs.cu:786). Here K traversals
share one level loop: the frontier is a [vp, K] bool plane, each edge gather
fetches a K-wide row, and the level step is ``frontier.level_step`` over the
leading edge axis. Graph500's 64-search run maps to one call
(``graph500.run_graph500(mode='batched')``). The loop syncs with the host
once per level. Per source the semantics are exactly ``algorithms/bfs.py``;
parents come from one scatter-min over the [vp, K] distances.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_bfs_torch.algorithms._packed_common import resolve_device
from tpu_bfs_torch.algorithms.bfs import run_level_loop
from tpu_bfs_torch.algorithms.frontier import INT32_MAX, EdgeData, level_step, min_parent_candidates
from tpu_bfs_torch.graph.csr import DeviceGraph, Graph
from tpu_bfs_torch.utils.timing import run_timed

#: The batched engine's backends ('dopt' picks its rung from one frontier's
#: size, so it is single-source only, as in the JAX package).
BACKENDS = ("scan", "segment", "scatter", "delta")


@dataclasses.dataclass
class MsBfsResult:
    sources: np.ndarray  # [K]
    distance: np.ndarray  # [K, V]
    parent: np.ndarray | None  # [K, V]
    elapsed_s: float | None = None


class MsBfsEngine:
    """Batched-source BFS over a device-resident graph; ``device`` is CUDA
    unless named."""

    def __init__(self, graph: Graph | DeviceGraph, *, backend: str = "scan", device=None):
        if backend not in BACKENDS:
            raise KeyError(f"unknown batched backend {backend!r}; have {sorted(BACKENDS)}")
        dg = DeviceGraph.from_graph(graph) if isinstance(graph, Graph) else graph
        if dg.ep >= 2**31 - 1:
            raise ValueError("edge slots overflow int32 row pointers")
        self.dg = dg
        self.backend = backend
        self.device = resolve_device(device)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(self.device)

        self.src = put(dg.src)
        self.dst = put(dg.dst)
        need_delta = backend == "delta"
        self.edges = EdgeData(
            src=self.src, dst=self.dst, in_rp=put(dg.in_row_ptr),
            out_rp=put(dg.out_row_ptr) if need_delta else None,
            perm_ds=put(dg.perm_ds) if need_delta else None,
        )
        self.last_host_syncs = 0
        self._warmed_k = set()

    def _init_state(self, sources: np.ndarray):
        vp, k = self.dg.vp, len(sources)
        rows = torch.from_numpy(sources.astype(np.int64)).to(self.device)
        lanes = torch.arange(k, device=self.device)
        frontier0 = torch.zeros((vp, k), dtype=torch.bool, device=self.device)
        frontier0[rows, lanes] = True
        dist0 = torch.full((vp, k), INT32_MAX, dtype=torch.int32, device=self.device)
        dist0[rows, lanes] = 0
        return frontier0, frontier0.clone(), dist0

    def distances(self, sources, *, max_levels: int | None = None):
        """[vp, K] int32 device distances and the loop's level count."""
        frontier0, visited, dist = self._init_state(np.asarray(sources, dtype=np.int64))
        ml = max_levels if max_levels is not None else self.dg.vp
        edges, backend = self.edges, self.backend

        def step(frontier, visited, _nfront, _fsum):
            return level_step(edges, frontier, visited, backend=backend)

        _, level, self.last_host_syncs = run_level_loop(step, frontier0, visited, dist, 0, ml)
        return dist, level

    def run(self, sources, *, with_parents: bool = False, time_it: bool = False,
            max_levels: int | None = None) -> MsBfsResult:
        sources = np.asarray(sources, dtype=np.int32)
        if sources.ndim != 1 or len(sources) == 0:
            raise ValueError("sources must be a non-empty 1D array")
        if sources.min() < 0 or sources.max() >= self.dg.num_vertices:
            raise ValueError("source out of range")
        elapsed = None
        if time_it:
            k = len(sources)
            (dist_dev, _), elapsed = run_timed(
                lambda: self.distances(sources, max_levels=max_levels),
                warm=k not in self._warmed_k, device=self.device,
            )
            self._warmed_k.add(k)
        else:
            dist_dev, _ = self.distances(sources, max_levels=max_levels)
        v = self.dg.num_vertices
        parent = None
        if with_parents:
            p = min_parent_candidates(self.src, self.dst, dist_dev)
            rows = torch.from_numpy(sources.astype(np.int64)).to(self.device)
            p[rows, torch.arange(len(sources), device=self.device)] = rows.to(torch.int32)
            parent = p.cpu().numpy()[:v].T
        dist = dist_dev.cpu().numpy()[:v].T
        return MsBfsResult(sources=sources, distance=dist, parent=parent, elapsed_s=elapsed)
