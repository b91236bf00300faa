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

from tpu_bfs_torch.algorithms._packed_common import NO_LANE, check_not_truncated, min_lane
from tpu_bfs_torch.workloads import (
    ExchangeRecordDelegate,
    WorkloadResult,
    id_of_row_map,
)

def _row_min_lanes(engine, pend) -> np.ndarray:
    """[rows] smallest visiting lane of every table row of a dispatched
    sweep, on the host; a mesh engine folds each rank's own rows and
    all-gathers the folds (``row_min_lanes``)."""
    fold = getattr(engine, "row_min_lanes", None)
    if fold is not None:
        return fold(pend)
    return min_lane(pend.vis, engine._act).cpu().numpy()


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
        ml = _row_min_lanes(engine, pend)
        del pend
        hit = (ml < NO_LANE) & (id_of_row >= 0)
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

    def analysis_programs(self):
        """The label fold for ``analysis/`` (JAX's ``cc_min_lane``): the
        smallest visiting lane of every row of a visited table."""
        from tpu_bfs_torch.utils.aot import ArgSpec

        base = self.base
        rows = int(getattr(base, "_table_rows", base._act + 1))
        act = base._act
        return [("cc_min_lane", lambda vis: min_lane(vis, act),
                 (ArgSpec((rows, base.w), torch.int32, base.device),))]

    def set_overlay(self, tables) -> None:
        """A dynamic-graph flip: swap the overlay on the base sweep engine
        AND drop the cached component index (an added edge can merge
        components, a removed one split them); the next cc query pays the
        re-label sweeps over the folded graph."""
        self.base.set_overlay(tables)
        with self._lock:
            self._index = None

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
