"""Per-level BFS statistics, the port of ``tpu_bfs/utils/stats.py``.

The level structure is recovered exactly from the final distance array:
frontier size by level is its histogram, and edges scanned by level the
degree-weighted histogram. So the stats cost nothing in the level loop and
hold for every engine. (The reference's only observability is printf,
bfs.cu:53-96, 624-626.) A pull-gated batch adds its skipped blocks per
level (``gated_tiles``). :func:`recovery_stats_line` is the ``--stats``
trailer of the process's recovery counters.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from tpu_bfs_torch.graph.csr import INF_DIST


@dataclasses.dataclass(frozen=True)
class LevelStats:
    """Per-level traversal statistics of one BFS run."""

    frontier_size: np.ndarray  # [L+1] vertices discovered at each level
    edges_scanned: np.ndarray  # [L+1] sum of out-degrees of each level's frontier
    reached: int
    unreached: int
    # Pull gate: the blocks it skipped each level (a gated engine's
    # last_gate_level_counts, cut to the batch's levels); None ungated, and
    # then the key is absent from json_lines.
    gated_tiles: np.ndarray | None = None

    @property
    def num_levels(self) -> int:
        return len(self.frontier_size) - 1

    def json_lines(self) -> list[str]:
        """One JSON object per level (the ``--stats`` output format)."""
        lines = []
        for lvl in range(len(self.frontier_size)):
            entry = {"level": lvl, "frontier": int(self.frontier_size[lvl]),
                     "edges_scanned": int(self.edges_scanned[lvl])}
            if self.gated_tiles is not None:
                entry["gated_tiles"] = int(self.gated_tiles[lvl])
            lines.append(json.dumps(entry))
        return lines


def level_stats(distance: np.ndarray, degrees: np.ndarray,
                gated_tiles: np.ndarray | None = None) -> LevelStats:
    """LevelStats of a distance array (int32, INF_DIST where unreached).
    ``edges_scanned[l]`` is the work a level-synchronous sweep does to
    expand level l: the degree sum of that level's frontier.
    ``gated_tiles`` (cut by the caller to the batch's level count) indexes
    the level being expanded; when the batch ran deeper than this
    distance array's eccentricity (other lanes kept claiming), the output
    extends to its length with zero frontier and edge rows."""
    distance = np.asarray(distance)
    reached_mask = distance != INF_DIST
    reached = distance[reached_mask]
    if reached.size == 0:
        return LevelStats(frontier_size=np.zeros(1, np.int64),
                          edges_scanned=np.zeros(1, np.int64), reached=0,
                          unreached=int((~reached_mask).sum()),
                          gated_tiles=None if gated_tiles is None else np.zeros(1, np.int64))
    n_out = int(reached.max()) + 1
    gt = None
    if gated_tiles is not None:
        src = np.asarray(gated_tiles, np.int64)
        n_out = max(n_out, len(src))
        gt = np.zeros(n_out, np.int64)
        gt[: len(src)] = src
    frontier = np.bincount(reached, minlength=n_out).astype(np.int64)
    edges = np.bincount(
        reached, weights=np.asarray(degrees, np.float64)[reached_mask], minlength=n_out,
    ).astype(np.int64)
    return LevelStats(frontier_size=frontier, edges_scanned=edges,
                      reached=int(reached_mask.sum()),
                      unreached=int((~reached_mask).sum()), gated_tiles=gt)


def recovery_stats_line() -> str | None:
    """The ``--stats`` trailer of the process's recovery counters
    (``utils/recovery.COUNTERS``): one ``{"recovery": {...}}`` JSON line
    when any retry, rebuild or degrade fired in this process, else None."""
    from tpu_bfs_torch.utils.recovery import COUNTERS

    if not COUNTERS.any():
        return None
    return json.dumps({"recovery": COUNTERS.as_dict()})
