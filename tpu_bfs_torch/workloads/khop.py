"""k-hop neighbourhood counts from the on-device lane summaries, the port
of ``tpu_bfs/workloads/khop.py``.

A k-hop query is the packed MS-BFS loop capped at ``max_levels=k``: after
k level bodies the visited table holds exactly the vertices within k hops,
and the engines' on-device ``lane_stats`` already count them per lane. So
the answer is the ``reached`` summary, and no distance word moves to the
host. The adapter is dispatch/fetch protocol only, so it rides any packed
engine (wide, hybrid, packed). Batches share one k.
"""

from __future__ import annotations

from tpu_bfs_torch.workloads import ExchangeRecordDelegate, ExtrasResult


class KhopServeEngine(ExchangeRecordDelegate):
    """kind="khop" over a base packed MS-BFS engine."""

    kind = "khop"

    def __init__(self, base):
        self.base = base
        self.lanes = base.lanes
        self.num_vertices = base.num_vertices

    def analysis_programs(self):
        """The base engine's programs (JAX's: the hop bound is the level
        cap of the same level step, so the kind adds no program)."""
        if getattr(self.base, "pull_gate", False):
            return []
        return [(name, fn, args) for name, _attr, fn, args in self.base.export_programs()]

    def set_overlay(self, tables) -> None:
        """A dynamic-graph flip: pure delegation (the adapter caches nothing
        derived from the edge set)."""
        self.base.set_overlay(tables)

    def dispatch(self, sources, *, k: int = 1, **_ignored):
        k = int(k)
        if k < 0:
            raise ValueError(f"k must be >= 0, got {k}")
        # A k at or above the plane cap clamps to it; fetch's cap check
        # then raises if the traversal was cut off, so the clamp never
        # undercounts.
        kk = min(k, self.base.max_levels_cap)
        return self.base.dispatch(sources, max_levels=kk), k

    def fetch(self, handle, **_ignored) -> ExtrasResult:
        pend, k = handle
        # For k below the cap, stopping at the bound is the query's point
        # and check_cap is a no-op (the base flags truncation only when the
        # bound IS the cap); a clamped k on a deeper graph raises.
        res = self.base.fetch(pend, check_cap=True)
        return ExtrasResult(res, [{"k": k} for _ in range(len(res.sources))])

    def run(self, sources, *, k: int = 1, time_it: bool = False,
            **_ignored) -> ExtrasResult:
        return self.fetch(self.dispatch(sources, k=k))
