"""Per-level engine traces: ``last_run_trace`` assembly and summaries, the
port of ``tpu_bfs/obs/engine_trace.py``.

Two sources, each what an engine family observes without adding device
work to its level loop:

- the DISTRIBUTED SINGLE-SOURCE loops (1D ``DistBfsEngine``, 2D
  ``Dist2DBfsEngine``) read the new-frontier count on the host once a
  level (their termination sum) and know each level's exchange branch;
  both land in a :class:`LevelRecord` of :data:`TRACE_LEVELS` slots that
  :func:`assemble_dist_trace` prices with ``wire_bytes_per_level()``, so
  every row carries frontier count, direction, exchange choice and
  modeled wire bytes;

- the PACKED MS engines record per-level gate skips
  (``last_gate_level_counts``) and per-branch exchange level counts
  (``last_exchange_level_counts``); :func:`assemble_packed_trace` folds
  those into per-level rows. Their loops read no per-level frontier count
  (only an ``any``), so packed rows carry ``frontier=None`` and, when a
  sparse run mixed branches, the exchange choice ``"mixed"``, with the
  per-branch counts in the trace summary.

Every row is one plain dict::

    {"level": int,            # the level being EXPANDED
     "frontier": int|None,    # vertices claimed by this expansion
     "direction": str,        # "push" | "pull" | "pull-gated" | "dopt"
     "gated_tiles": int|None, # blocks the pull gate skipped
     "exchange": str|None,    # "sparse[cap]" | "dense" | "mixed" | None
     "wire_bytes": float|None}# modeled off-device bytes, this level

``engine.last_run_trace`` holds the rows of the engine's most recent
core invocation (a checkpoint-resumed chunk covers that chunk's levels).
"""

from __future__ import annotations

import numpy as np

# Per-level recording depth of the distributed single-source loops. Deeper
# traversals clamp into the last slot: its frontier is the exact SUM over
# the clamped levels (so frontier_total never undercounts), its branch and
# wire columns are the LAST clamped level's, and the row marks itself
# truncated.
TRACE_LEVELS = 64


def _host(a) -> np.ndarray:
    """A numpy view of ``a`` (a host array, or a tensor on any device)."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class LevelRecord:
    """The distributed loops' per-level trace slots: the frontier count
    each level claimed (added, so the clamp slot sums the tail) and its
    exchange branch (last write wins; -1 = never written)."""

    def __init__(self, level0: int):
        self.level0 = int(level0)
        self.front = np.zeros(TRACE_LEVELS, np.int64)
        self.branch = np.full(TRACE_LEVELS, -1, np.int64)

    def add(self, level: int, count: int, branch: int) -> None:
        """The level ``level`` (absolute, before its expansion) claimed
        ``count`` vertices over exchange branch ``branch``."""
        slot = min(int(level) - self.level0, TRACE_LEVELS - 1)
        self.front[slot] += int(count)
        self.branch[slot] = int(branch)


class DistTraceHost:
    """``last_run_trace`` of the distributed single-source engines: hosts
    call :meth:`_record_trace` with the :class:`LevelRecord` of each loop
    and the levels it ran; the rows assemble on first read, outside any
    timed region. Hosts set ``_exchange``, ``sparse_caps``, ``backend``
    and ``wire_bytes_per_level``."""

    _trace_pending = None
    _trace_cache = None

    def _record_trace(self, rec: LevelRecord, levels_run: int) -> None:
        self._trace_pending = (rec, int(levels_run))
        self._trace_cache = None

    @property
    def last_run_trace(self) -> list[dict] | None:
        pend = self._trace_pending
        if pend is not None:
            rec, levels = pend
            self._trace_pending = None
            self._trace_cache = assemble_dist_trace(
                self, levels, rec.front, rec.branch,
                direction="dopt" if self.backend == "dopt" else "push",
                level0=rec.level0)
        return self._trace_cache

    @last_run_trace.setter
    def last_run_trace(self, rows: list[dict] | None) -> None:
        self._trace_pending = None
        self._trace_cache = rows


def branch_label(branch: int, caps) -> str:
    """Human form of a cap-ladder branch index (ascending caps, then the
    dense fallback)."""
    caps = sorted(caps or ())
    if 0 <= branch < len(caps):
        return f"sparse[{caps[branch]}]"
    return "dense"


def assemble_dist_trace(engine, levels: int, front_seq, branch_seq, *, direction: str,
                        level0: int = 0) -> list[dict]:
    """Per-level rows for the distributed single-source engines from their
    [TRACE_LEVELS] recordings (branch -1 = slot never written); pricing
    comes from ``engine.wire_bytes_per_level()``, so the trace cannot
    disagree with the exchange accounting. ``levels`` counts the levels
    this invocation ran; ``level0`` re-offsets a resumed chunk's rows to
    absolute levels. Past ``TRACE_LEVELS`` the last row aggregates: the
    frontier sum of the clamped tail, the last-written branch and wire
    bytes, and a ``truncated_levels`` marker."""
    front = _host(front_seq)
    branch = _host(branch_seq)
    per_level = [float(x) for x in engine.wire_bytes_per_level()]
    # Engines with a richer branch space (the exchange planner) publish
    # index-aligned labels; otherwise the cap-ladder labels apply to the
    # sparse exchange and ring/allreduce runs are labeled by the impl.
    hook = getattr(engine, "exchange_branch_labels", None)
    labels = hook() if callable(hook) else None
    mode = getattr(engine, "_exchange", None)
    caps = tuple(getattr(engine, "sparse_caps", ()) or ())
    if mode != "sparse":
        caps = ()
    n = min(int(levels), TRACE_LEVELS)
    rows = []
    for lvl in range(n):
        b = int(branch[lvl])
        known = 0 <= b < len(per_level)
        if labels is not None:
            label = labels[b] if known and b < len(labels) else None
        else:
            label = branch_label(b, caps) if known else None
        if label == "dense" and mode not in (None, "sparse"):
            label = mode
        rows.append({
            "level": int(level0) + lvl,
            "frontier": int(front[lvl]),
            "direction": direction,
            "gated_tiles": None,
            "exchange": label,
            "wire_bytes": per_level[b] if known else None,
        })
    if int(levels) > TRACE_LEVELS:
        rows[-1]["truncated_levels"] = int(levels) - TRACE_LEVELS + 1
    return rows


def assemble_packed_trace(engine, levels: int) -> list[dict]:
    """Per-level rows for a packed MS engine's last run, from its gate
    counters and per-branch exchange counts. The exchange choice is exact
    when the whole run used one branch (always, for dense exchanges); a
    mixed sparse run labels rows "mixed" and the split lives in
    :func:`trace_summary`."""
    n = int(levels)
    gc = getattr(engine, "last_gate_level_counts", None)
    if gc is not None:
        gc = _host(gc)
    direction = "pull-gated" if getattr(engine, "pull_gate", False) else "pull"
    if getattr(engine, "adaptive_push", None):
        # JAX's rule: the hybrid's public attribute (the wide engine keeps
        # its configuration private in both packages, and says "pull").
        direction = "pull+adaptive-push"
    counts = getattr(engine, "last_exchange_level_counts", None)
    caps = tuple(getattr(engine, "sparse_caps", ()) or ())
    hook = getattr(engine, "exchange_branch_labels", None)
    labels = hook() if callable(hook) else None
    exchange = None
    wire_each = None
    if counts is not None:
        counts = _host(counts)
        wb = getattr(engine, "wire_bytes_per_level", None)
        per_level = [float(x) for x in wb()] if wb is not None else None
        used = np.flatnonzero(counts)
        if len(used) == 1:
            b = int(used[0])
            if labels is not None and b < len(labels):
                exchange = labels[b]
            else:
                exchange = branch_label(b, caps) if len(counts) > 1 else "dense"
            if per_level is not None:
                wire_each = per_level[b]
        elif len(used) > 1:
            exchange = "mixed"
    return [{
        "level": lvl,
        "frontier": None,
        "direction": direction,
        "gated_tiles": int(gc[lvl]) if gc is not None and lvl < len(gc) else None,
        "exchange": exchange,
        "wire_bytes": wire_each,
    } for lvl in range(n)]


def trace_summary(trace, engine=None) -> dict:
    """Compact form of one ``last_run_trace``: the CLI's ``trace`` line."""
    trace = trace or []
    out: dict = {"levels": len(trace)}
    fronts = [r["frontier"] for r in trace if r.get("frontier") is not None]
    if fronts:
        out["frontier_total"] = int(sum(fronts))
        out["frontier_peak"] = int(max(fronts))
    directions = sorted({r["direction"] for r in trace if r.get("direction")})
    if directions:
        out["directions"] = directions
    gates = [r["gated_tiles"] for r in trace if r.get("gated_tiles") is not None]
    if gates:
        out["gated_tiles_total"] = int(sum(gates))
    exchanges: dict = {}
    for r in trace:
        ex = r.get("exchange")
        if ex is not None:
            exchanges[ex] = exchanges.get(ex, 0) + 1
    if exchanges:
        out["exchange_levels"] = exchanges
    wires = [r["wire_bytes"] for r in trace if r.get("wire_bytes") is not None]
    if wires:
        out["wire_bytes_total"] = float(sum(wires))
    if engine is not None:
        counts = getattr(engine, "last_exchange_level_counts", None)
        if counts is not None:
            out["exchange_branch_counts"] = [int(x) for x in _host(counts)]
        wbytes = getattr(engine, "last_exchange_bytes", None)
        if wbytes is not None:
            # The accounting's figure wins (levels past the clamp, and
            # mixed-branch packed runs).
            out["wire_bytes_total"] = float(wbytes)
    return out


def record_packed_run(engine, levels: int, *, recorder=None,
                      label: str | None = None) -> list[dict]:
    """Assemble and store ``engine.last_run_trace`` for a finished packed
    batch, emitting one obs event when a recorder is given. Called only
    under the obs ACTIVE guard: the assembly copies
    ``last_gate_level_counts`` off the device."""
    trace = assemble_packed_trace(engine, levels)
    engine.last_run_trace = trace
    if recorder is not None:
        recorder.event("engine.run_trace", cat="engine",
                       engine=label or type(engine).__name__,
                       summary=trace_summary(trace, engine))
    return trace
