"""Telemetry exporters: Chrome/Perfetto trace JSON and Prometheus text.

Both consume the plain record dicts :class:`tpu_bfs_torch.obs.recorder.
Recorder` emits — no recorder import needed, so these also format
records replayed from a flight-recorder dump. Stdlib-only.
"""

from __future__ import annotations

import json

# ---------------------------------------------------------------------------
# Chrome trace-event JSON (Perfetto / chrome://tracing loadable).
#
# Instant records map to ph="i" (thread-scoped), span begin/end to the
# ASYNC event pair ph="b"/"e" (matched on cat+id+name, which is exactly
# the recorder's span contract — async events are the right encoding
# because one logical span crosses threads: a query is admitted on a
# client thread and resolved on the extraction worker). Timestamps are
# microseconds relative to the recorder epoch.


def trace_events(events, *, t0: float = 0.0, pid: int = 0) -> list[dict]:
    """Recorder records -> Chrome trace-event dicts."""
    out = []
    tids: dict = {}
    for ev in events:
        tname = ev.get("tid", "main")
        tid = tids.get(tname)
        if tid is None:
            tid = tids[tname] = len(tids) + 1
            out.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": tname},
            })
        ts = max(ev["t"] - t0, 0.0) * 1e6
        rec = {
            "name": ev["name"],
            "cat": ev.get("cat", "event"),
            "ph": ev["ph"],
            "ts": round(ts, 3),
            "pid": pid,
            "tid": tid,
            "args": dict(ev.get("args") or {}),
        }
        if ev["ph"] in ("b", "e"):
            rec["id"] = str(ev.get("id"))
        elif ev["ph"] == "i":
            rec["s"] = "t"  # thread-scoped instant
        out.append(rec)
    return out


def level_trace_events(trace, *, t0_us: float = 0.0, label: str = "engine",
                       pid: int = 0, tid: int = 0) -> list[dict]:
    """Per-level engine-trace rows (``engine.last_run_trace``) as one
    synthetic track: one instant event a level, its row in ``args``.
    Levels have no host timestamps of their own, so rows sit 1 us apart
    from ``t0_us``: a logical axis."""
    out = [{
        "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
        "args": {"name": f"{label} levels"},
    }]
    for row in trace or ():
        out.append({
            "name": f"level {row.get('level')}",
            "cat": "engine.level",
            "ph": "i",
            "ts": round(t0_us + float(row.get("level", 0)), 3),
            "pid": pid,
            "tid": tid,
            "s": "t",
            "args": dict(row),
        })
    return out


def write_perfetto(events, path: str, *, t0: float = 0.0, level_traces=(),
                   meta: dict | None = None) -> str:
    """Write one Perfetto-loadable JSON file: the recorder's events plus a
    level track for each ``(label, last_run_trace)`` pair. Returns
    ``path``."""
    evs = trace_events(events, t0=t0)
    tid = 1000  # level tracks sit far from real thread ids
    t_end = max((e["ts"] for e in evs if "ts" in e), default=0.0)
    for label, trace in level_traces:
        evs.extend(level_trace_events(trace, t0_us=t_end, label=label, tid=tid))
        tid += 1
    doc = {"traceEvents": evs, "displayTimeUnit": "ms"}
    if meta:
        doc["metadata"] = meta
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


# ---------------------------------------------------------------------------
# Prometheus-style text exposition.


def _metric_name(prefix: str, key: str) -> str:
    return f"{prefix}_{key}".replace(".", "_").replace("-", "_")


# Snapshot keys that are monotonic counters (TYPE counter); everything
# else numeric exports as a gauge. Keys whose value is None are skipped
# (e.g. p50_ms before the first completion).
_COUNTER_KEYS = frozenset((
    "completed", "batches", "rejected", "expired", "errors", "shutdown",
    "retries", "oom_degrades", "requeued", "watchdog_trips",
    "requeue_shed", "padded_lanes_total", "breaker_opens",
    "lanes_used", "lanes_offered",
    "mesh_faults", "mesh_degrades", "query_resumes", "resume_snapshots",
    "audits_run", "audit_failures", "audit_errors", "audit_dropped",
    "quarantines",
    # Answer cache + landmark tier. cache_bytes is the
    # resident-payload gauge and deliberately absent here.
    "cache_hits", "cache_misses", "cache_evictions", "cache_quarantines",
    "single_flight_collapses", "landmark_exact", "landmark_bounded",
    "landmark_fallback",
))


def prometheus_text(snapshot: dict, *, histograms: dict | None = None,
                    prefix: str = "tpu_bfs_serve") -> str:
    """Render one ServeMetrics snapshot (plus optional
    ``{name: Log2Histogram}``) as Prometheus exposition text — the
    /metricz payload, replacing ad-hoc statsz string munging as the
    machine-readable form (the stderr statsz line renders the same
    snapshot, so the two always agree).

    Dict-valued snapshot keys become labeled series (e.g. the routing
    histogram -> ``..._routing_batches{width="128"}``); list-valued keys
    export their length; None values are skipped."""
    lines: list[str] = []

    def emit(key: str, value, mtype: str) -> None:
        name = _metric_name(prefix, key)
        lines.append(f"# TYPE {name} {mtype}")
        lines.append(f"{name} {value:g}" if isinstance(value, float)
                     else f"{name} {value}")

    for key in sorted(snapshot):
        value = snapshot[key]
        if value is None:
            continue
        if isinstance(value, bool):
            emit(key, int(value), "gauge")
        elif isinstance(value, (int, float)):
            emit(key, value, "counter" if key in _COUNTER_KEYS else "gauge")
        elif isinstance(value, dict):
            name = _metric_name(prefix, key)
            num = {k: v for k, v in value.items()
                   if isinstance(v, (int, float)) and not isinstance(v, bool)}
            if not num:
                continue
            label = "width" if key == "routing" else "key"
            lines.append(f"# TYPE {name} gauge")
            for k in sorted(num):
                lines.append(f'{name}{{{label}="{k}"}} {num[k]}')
        elif isinstance(value, (list, tuple)):
            emit(f"{key}_count", len(value), "gauge")
    for hname in sorted(histograms or {}):
        hist = histograms[hname]
        name = _metric_name(prefix, hname)
        lines.append(f"# TYPE {name} histogram")
        for le, cum in hist.cumulative_buckets():
            bound = "+Inf" if le is None else f"{le:g}"
            lines.append(f'{name}_bucket{{le="{bound}"}} {cum}')
        lines.append(f"{name}_sum {hist.total:g}")
        lines.append(f"{name}_count {hist.count}")
    return "\n".join(lines) + "\n"


def write_metricz(text: str, path: str) -> None:
    """Atomic-replace write of the periodic /metricz text file, so a
    scraper mid-read never sees a torn exposition."""
    import os

    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)
