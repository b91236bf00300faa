"""Connected components by repeated MS-BFS sweeps with lane recycling, the
port of ``tpu_bfs/workloads/cc.py``.

One sweep of the wide engine floods up to ``lanes`` components at once.
Each next sweep re-seeds every lane from the still-unvisited vertices in
ascending id order, so a component's label is the smallest seed that
flooded it, until every vertex is labelled. Per sweep the label fold runs
on the device: each row's smallest visiting lane, one [act] int32 copy to
the host a sweep instead of decoding lane bits there.

On directed graphs a sweep computes reachability classes of the seed
order (what repeated BFS gives); the classic notion is the undirected one.

Over a mesh base (``DistWideMsBfsEngine``) each rank folds its own rows
and the per-row lanes are all-gathered into the chip-major table the row
map reads; every rank runs every sweep, so the sweeps' collectives pair up.

The serve adapter caches the index per engine: the first query pays the
sweeps, every later one answers label, size and count from host arrays.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from tpu_bfs_torch.algorithms._packed_common import check_not_truncated
from tpu_bfs_torch.workloads import (
    ExchangeRecordDelegate,
    WorkloadResult,
    id_of_row_map,
)

_NO_LANE = np.int32(1 << 30)


def min_lane(vis: torch.Tensor, act: int) -> torch.Tensor:
    """[rows, w] word-major visited table -> [act] int32 smallest visiting
    lane of each real row, ``_NO_LANE`` where no lane visited: the lowest
    set bit of the row's first nonzero word. A fixed handful of passes over
    the table, whatever its width."""
    if act == 0:
        return torch.zeros(0, dtype=torch.int32, device=vis.device)
    v = vis[:act]
    nz = v != 0
    first = nz.to(torch.uint8).argmax(dim=1)  # the first nonzero word (0 if none)
    word = v.gather(1, first[:, None]).squeeze(1).long() & 0xFFFFFFFF
    low = word & -word  # its lowest set bit, exactly a power of two (or 0)
    _, exp = torch.frexp(low.double())  # low == 2**(exp - 1)
    lane = first * 32 + exp.long() - 1
    return torch.where(nz.any(dim=1), lane, int(_NO_LANE)).to(torch.int32)


def _row_min_lanes(engine, vis: torch.Tensor) -> np.ndarray:
    """[rows] smallest visiting lane of every table row, on the host; a mesh
    engine's rank folds its own rows and the fold is all-gathered."""
    gather = getattr(engine, "_gather_rows", None)
    if gather is None:
        return min_lane(vis, engine._act).cpu().numpy()
    return gather(min_lane(vis, vis.shape[0])).cpu().numpy()


def connected_components(engine):
    """Full component labelling over a wide packed engine's graph (one
    device or a mesh). Returns ``(labels [V] int64, num_components,
    sweeps)``: ``labels[v]`` is the smallest vertex id that seeded v's
    component's flood. Every sweep labels at least its seeds, so the loop
    ends within V sweeps."""
    id_of_row = id_of_row_map(engine)
    labels = np.full(engine.num_vertices, -1, np.int64)
    unseen = np.ones(engine.num_vertices, dtype=bool)
    sweeps = 0
    while unseen.any():
        seeds = np.flatnonzero(unseen)[: engine.lanes]
        # The visited table is all a sweep needs: dispatch, with fetch's
        # truncation check, and no per-lane summaries.
        pend = engine.dispatch(seeds)
        check_not_truncated(engine, pend)
        ml = _row_min_lanes(engine, pend.vis)
        del pend
        hit = (ml < _NO_LANE) & (id_of_row >= 0)
        vids = id_of_row[hit]
        labels[vids] = seeds[ml[hit]]
        unseen[vids] = False
        # Lane recycling: isolated seeds (no table row: their component is
        # themselves) label themselves; every seed lane is free again.
        self_label = labels[seeds] < 0
        labels[seeds[self_label]] = seeds[self_label]
        unseen[seeds] = False
        sweeps += 1
    num_components = len(np.unique(labels))
    return labels, num_components, sweeps


class CcIndex:
    """The cached component index one labelling produces."""

    def __init__(self, labels: np.ndarray, num_components: int, sweeps: int):
        self.labels = labels
        self.num_components = num_components
        self.sweeps = sweeps
        _, inv, counts = np.unique(labels, return_inverse=True, return_counts=True)
        self.size_of = counts[inv]  # [V] component size per vertex


class CcServeEngine(ExchangeRecordDelegate):
    """kind="cc": component label, size and count from the cached index,
    built on first use."""

    kind = "cc"

    def __init__(self, base):
        self.base = base
        self.lanes = base.lanes
        self.num_vertices = base.num_vertices
        self._lock = threading.Lock()
        self._index: CcIndex | None = None  # guarded-by: _lock

    def _ensure_index(self) -> CcIndex:
        with self._lock:
            if self._index is None:
                labels, n, sweeps = connected_components(self.base)
                self._index = CcIndex(labels, n, sweeps)
            return self._index

    def dispatch(self, sources, **_ignored) -> np.ndarray:
        return np.asarray(sources, dtype=np.int64)

    def fetch(self, sources: np.ndarray, **_ignored) -> WorkloadResult:
        idx = self._ensure_index()
        labels = idx.labels[sources]
        sizes = idx.size_of[sources]
        extras = [
            {
                "component": int(lbl),
                "component_size": int(sz),
                "components": idx.num_components,
            }
            for lbl, sz in zip(labels, sizes)
        ]
        return WorkloadResult(
            reached=sizes.astype(np.int64),
            ecc=np.zeros(len(sources), np.int32),
            extras_list=extras,
        )

    def run(self, sources, *, time_it: bool = False, **_ignored):
        return self.fetch(self.dispatch(sources))
