"""Serve-mode observability: the /statsz counters and /metricz export,
the port of ``tpu_bfs/serve/metrics.py`` (host-only, copied).

A server needs per-process counters that survive across batches: QPS,
latency percentiles, batch fill ratio against the DISPATCHED width, the
width ladder's routing histogram, pad waste, extraction time, queue depth,
retries and sheds. One lock guards everything: writers are the scheduler
thread, the extraction worker and client threads shedding at admission.

Latency distributions are mergeable log2-bucket histograms: exact counts
over fixed bucket boundaries, so replicas' histograms sum, and the same
buckets drive the Prometheus exporter
(``tpu_bfs_torch/obs/exporters.prometheus_text``). The ``p50_ms`` and
``p99_ms`` snapshot keys are estimates with bounded relative error over a
two-window recent span (``RECENT_WINDOW_S``), so a slow cold batch ages
out of p99.

The snapshot carries the JAX package's keys, so the two statsz lines and
Prometheus texts compare key for key.
"""

from __future__ import annotations

import json
import math
import threading
import time
from collections import Counter


class Log2Histogram:
    """Exact-count histogram over log2 buckets with linear sub-buckets.

    Bucket boundaries are fixed process-independent constants (octaves
    ``2**EMIN .. 2**EMAX``, each split into ``SUB`` equal-width
    sub-buckets — the HDR-histogram shape), so histograms from different
    replicas :meth:`merge` by elementwise count addition. Quantile
    estimates interpolate inside one bucket (relative error <= 1/SUB per
    octave) and clamp to the exact observed min/max, so a single-sample
    histogram reports that sample exactly. Values at or below 0 land in
    the underflow bucket ``[0, 2**EMIN)``."""

    __slots__ = ("counts", "count", "total", "vmin", "vmax")

    SUB = 16  # sub-buckets per octave: <= 6.25% relative estimate error
    EMIN = -10  # 2**-10 ms ~ 1 us
    EMAX = 22  # 2**22 ms ~ 70 min
    NBUCKETS = (EMAX - EMIN) * SUB + 2  # + underflow and overflow

    def __init__(self):
        self.counts = [0] * self.NBUCKETS
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def _index(self, v: float) -> int:
        if v < 2.0 ** self.EMIN:
            return 0
        if v >= 2.0 ** self.EMAX:
            return self.NBUCKETS - 1
        m, e = math.frexp(v)  # v = m * 2**e, m in [0.5, 1)
        octave = e - 1
        sub = int((v / 2.0 ** octave - 1.0) * self.SUB)
        return 1 + (octave - self.EMIN) * self.SUB + min(sub, self.SUB - 1)

    def bounds(self, i: int) -> tuple[float, float]:
        """[lo, hi) of bucket ``i``."""
        if i <= 0:
            return 0.0, 2.0 ** self.EMIN
        if i >= self.NBUCKETS - 1:
            return 2.0 ** self.EMAX, math.inf
        j = i - 1
        octave = self.EMIN + j // self.SUB
        sub = j % self.SUB
        width = 2.0 ** octave / self.SUB
        lo = 2.0 ** octave + sub * width
        return lo, lo + width

    def add(self, v: float) -> None:
        v = float(v)
        self.counts[self._index(v)] += 1
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def add_many(self, values) -> None:
        for v in values:
            self.add(v)

    def merge(self, other: "Log2Histogram") -> "Log2Histogram":
        """Fold ``other``'s counts in (the multi-replica aggregation)."""
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        return self

    def percentile(self, q: float) -> float | None:
        """Estimated q-th percentile (linear interpolation inside the
        covering bucket, clamped to the observed extremes); None when
        empty."""
        if not self.count:
            return None
        target = (q / 100.0) * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if not c:
                continue
            if cum + c >= target:
                lo, hi = self.bounds(i)
                if not math.isfinite(hi):
                    hi = max(self.vmax, lo)
                frac = (target - cum) / c
                est = lo + (hi - lo) * min(max(frac, 0.0), 1.0)
                return float(min(max(est, self.vmin), self.vmax))
            cum += c
        return float(self.vmax)

    def cumulative_buckets(self):
        """Prometheus exposition form: ``(upper_bound, cumulative_count)``
        at octave boundaries (+Inf last, bound None) — octave granularity
        keeps the text small while the sub-buckets keep estimates tight."""
        out = []
        cum = 0
        next_octave_end = self.SUB  # sub-bucket index (0-based past underflow)
        pending = self.counts[0]
        for j in range((self.EMAX - self.EMIN) * self.SUB):
            pending += self.counts[1 + j]
            if j + 1 == next_octave_end:
                cum += pending
                pending = 0
                octave = self.EMIN + (j + 1) // self.SUB
                if cum or out:
                    out.append((2.0 ** octave, cum))
                next_octave_end += self.SUB
        cum += pending + self.counts[-1]
        out.append((None, cum))
        return out


# How far back the p50/p99 SNAPSHOT keys look. The all-time histograms
# (histograms(), the Prometheus export) are monotone by design — scrapers
# difference them; the human-facing statsz percentiles instead read a
# two-generation window pair so a slow cold batch an hour ago cannot
# inflate p99 forever (the invariant the old 4096-sample deque kept by
# count, now kept by time: estimates cover the last 1-2 windows).
RECENT_WINDOW_S = 60.0


class ServeMetrics:
    """Thread-safe serve counters + mergeable latency histograms."""

    def __init__(self, *, now=time.monotonic):
        self._now = now
        self._lock = threading.Lock()
        self._t0 = now()
        self._latency_hist = Log2Histogram()  # guarded-by: _lock
        self._extract_hist = Log2Histogram()  # guarded-by: _lock
        # [current, previous] window pair behind the percentile snapshot
        # keys; rotated in place at RECENT_WINDOW_S boundaries.
        self._recent_t0 = self._t0  # guarded-by: _lock
        self._lat_recent = [Log2Histogram(), Log2Histogram()]  # guarded-by: _lock
        self._ext_recent = [Log2Histogram(), Log2Histogram()]  # guarded-by: _lock
        self.completed = 0  # guarded-by: _lock
        self.rejected = 0  # guarded-by: _lock — shed at admission
        self.expired = 0  # guarded-by: _lock — deadline passed while queued
        self.errors = 0  # guarded-by: _lock
        self.shutdown = 0  # guarded-by: _lock — resolved unserved at close
        self.retries = 0  # guarded-by: _lock — transient re-dispatches
        self.oom_degrades = 0  # guarded-by: _lock — lane halvings after OOM
        self.requeued = 0  # guarded-by: _lock — re-admitted after OOM'd batch
        self.watchdog_trips = 0  # guarded-by: _lock — watchdog firings
        self.requeue_shed = 0  # guarded-by: _lock — shed at requeue budget
        self.mesh_faults = 0  # guarded-by: _lock — mesh-death classifications
        self.mesh_degrades = 0  # guarded-by: _lock — mesh failover rebuilds
        # Integrity tier: audits run and failed, audit errors, audits
        # shed, and rung quarantines. The lag histogram prices how far
        # behind the served answer its verdict lands (audit_p50_lag_ms).
        self.audits_run = 0  # guarded-by: _lock
        self.audit_failures = 0  # guarded-by: _lock
        self.audit_errors = 0  # guarded-by: _lock
        self.audit_dropped = 0  # guarded-by: _lock
        self.quarantines = 0  # guarded-by: _lock
        self._audit_lag_hist = Log2Histogram()  # guarded-by: _lock
        # Answer cache + landmark tier. cache_bytes is a GAUGE (resident
        # payload bytes, set by the cache after every mutation); everything
        # else is monotonic. The hit histogram prices the bypass path
        # separately from the traversal latencies above.
        self.cache_hits = 0  # guarded-by: _lock
        self.cache_misses = 0  # guarded-by: _lock
        self.cache_evictions = 0  # guarded-by: _lock
        self.cache_bytes = 0  # guarded-by: _lock — gauge
        self.cache_quarantines = 0  # guarded-by: _lock
        self.single_flight_collapses = 0  # guarded-by: _lock
        self.landmark_exact = 0  # guarded-by: _lock
        self.landmark_bounded = 0  # guarded-by: _lock
        self.landmark_fallback = 0  # guarded-by: _lock
        self._hit_hist = Log2Histogram()  # guarded-by: _lock
        self.batches = 0  # guarded-by: _lock
        self.lanes_used = 0  # guarded-by: _lock — real queries, all batches
        # Sum of DISPATCHED batch capacity: with the width ladder this is
        # the routed width per batch, so fill_ratio reports waste against
        # the width actually paid for, not the configured maximum.
        self.lanes_offered = 0  # guarded-by: _lock
        self.padded_lanes_total = 0  # guarded-by: _lock — residual pad waste
        self.batches_by_width = Counter()  # guarded-by: _lock — width -> batches
        self.extract_ms_total = 0.0  # guarded-by: _lock
        # Interval bookkeeping for the statsz line's recent-QPS figure.
        self._last_snap_t = self._t0  # guarded-by: _lock
        self._last_snap_completed = 0  # guarded-by: _lock

    def record_batch(self, used: int, capacity: int, latencies_ms, *,
                     extract_ms: float | None = None) -> None:
        with self._lock:
            self.batches += 1
            self.lanes_used += used
            self.lanes_offered += capacity
            self.padded_lanes_total += max(capacity - used, 0)
            self.batches_by_width[int(capacity)] += 1
            self.completed += len(latencies_ms)
            self._rotate_recent()
            self._latency_hist.add_many(latencies_ms)
            self._lat_recent[0].add_many(latencies_ms)
            if extract_ms is not None:
                self._extract_hist.add(extract_ms)
                self._ext_recent[0].add(extract_ms)
                self.extract_ms_total += extract_ms

    def _rotate_recent(self) -> None:  # requires-lock: _lock
        """Age the percentile window pair (caller holds the lock): one
        elapsed window shifts current -> previous; two or more mean
        everything recorded is stale and both drop."""
        elapsed = self._now() - self._recent_t0
        if elapsed < RECENT_WINDOW_S:
            return
        if elapsed >= 2 * RECENT_WINDOW_S:
            self._lat_recent = [Log2Histogram(), Log2Histogram()]
            self._ext_recent = [Log2Histogram(), Log2Histogram()]
        else:
            self._lat_recent = [Log2Histogram(), self._lat_recent[0]]
            self._ext_recent = [Log2Histogram(), self._ext_recent[0]]
        self._recent_t0 = self._now()

    def record_rejected(self) -> None:
        with self._lock:
            self.rejected += 1

    def record_expired(self, n: int = 1) -> None:
        with self._lock:
            self.expired += n

    def record_errors(self, n: int = 1) -> None:
        with self._lock:
            self.errors += n

    def record_shutdown(self, n: int = 1) -> None:
        with self._lock:
            self.shutdown += n

    def record_retry(self) -> None:
        with self._lock:
            self.retries += 1

    def record_mesh_fault(self) -> None:
        with self._lock:
            self.mesh_faults += 1

    def record_mesh_degrade(self, requeued: int = 0) -> None:
        with self._lock:
            self.mesh_degrades += 1
            self.requeued += requeued

    def record_oom_degrade(self, requeued: int) -> None:
        with self._lock:
            self.oom_degrades += 1
            self.requeued += requeued

    def record_watchdog_trip(self) -> None:
        with self._lock:
            self.watchdog_trips += 1

    def record_requeue_shed(self, n: int = 1) -> None:
        with self._lock:
            self.requeue_shed += n

    def record_audit(self, lag_ms: float, *, failed: bool = False) -> None:
        with self._lock:
            self.audits_run += 1
            if failed:
                self.audit_failures += 1
            self._audit_lag_hist.add(lag_ms)

    def record_audit_error(self) -> None:
        with self._lock:
            self.audit_errors += 1

    def record_audit_dropped(self) -> None:
        with self._lock:
            self.audit_dropped += 1

    def record_quarantine(self) -> None:
        with self._lock:
            self.quarantines += 1

    def record_cache_hit(self, latency_ms: float, *,
                         landmark: bool = False) -> None:
        """One query resolved WITHOUT a traversal. Counts toward
        ``completed`` (it is a served query) but its latency lands in
        the hit histogram, not the batch-latency one, so ``p50_ms``
        keeps meaning the traversal path. Landmark hits are already
        counted by ``record_landmark`` — only plain cache hits bump
        ``cache_hits`` here."""
        with self._lock:
            self.completed += 1
            if not landmark:
                self.cache_hits += 1
            self._hit_hist.add(latency_ms)

    def record_follower_completed(self) -> None:
        """A single-flight follower resolved ok off its leader's result
        — a served query that never occupied a lane, so no batch counter
        (or latency histogram) ever sees it."""
        with self._lock:
            self.completed += 1

    def record_cache_miss(self) -> None:
        with self._lock:
            self.cache_misses += 1

    def record_cache_eviction(self, n: int = 1) -> None:
        with self._lock:
            self.cache_evictions += n

    def record_cache_quarantine(self) -> None:
        with self._lock:
            self.cache_quarantines += 1

    def set_cache_bytes(self, nbytes: int) -> None:
        with self._lock:
            self.cache_bytes = int(nbytes)

    def record_single_flight(self, n: int = 1) -> None:
        with self._lock:
            self.single_flight_collapses += n

    def record_landmark(self, *, exact: bool,
                        informative: bool = True) -> None:
        """One landmark consult: ``exact`` answered the query;
        otherwise the bracket existed but did not meet (``bounded``) or
        no landmark was informative at all (``fallback``) — both fall
        back to traversal."""
        with self._lock:
            if exact:
                self.landmark_exact += 1
            elif informative:
                self.landmark_bounded += 1
            else:
                self.landmark_fallback += 1

    def _round(self, v: float | None) -> float | None:
        return None if v is None else round(v, 3)

    def snapshot(self, *, queue_depth: int | None = None,
                 lanes: int | None = None, mark_interval: bool = False,
                 extra: dict | None = None) -> dict:
        """One /statsz observation. ``interval_qps`` covers the window
        since the last ``mark_interval=True`` snapshot; only the ONE
        periodic emitter (statsz_line) passes that flag — ad-hoc
        observers (BfsService.statsz, the bench) must not reset the
        periodic line's window. ``qps`` is lifetime."""
        with self._lock:
            now = self._now()
            uptime = max(now - self._t0, 1e-9)
            interval = max(now - self._last_snap_t, 1e-9)
            interval_done = self.completed - self._last_snap_completed
            if mark_interval:
                self._last_snap_t = now
                self._last_snap_completed = self.completed
            # Percentile keys read the recent window pair (a long-idle
            # server's percentiles age back to None rather than echoing
            # an hour-old cold batch); the all-time histograms stay the
            # exported/mergeable record.
            self._rotate_recent()
            lat = Log2Histogram().merge(
                self._lat_recent[0]).merge(self._lat_recent[1])
            ext = Log2Histogram().merge(
                self._ext_recent[0]).merge(self._ext_recent[1])
            out = {
                "uptime_s": round(uptime, 3),
                "completed": self.completed,
                "qps": round(self.completed / uptime, 2),
                "interval_qps": round(interval_done / interval, 2),
                "p50_ms": self._round(lat.percentile(50)),
                "p99_ms": self._round(lat.percentile(99)),
                "fill_ratio": round(
                    self.lanes_used / self.lanes_offered, 4
                ) if self.lanes_offered else 0.0,
                "padded_lanes_total": self.padded_lanes_total,
                # Routing histogram (width ladder): how many batches each
                # dispatched width served. JSON keys must be strings.
                "routing": {
                    str(wd): n
                    for wd, n in sorted(self.batches_by_width.items())
                },
                "extract_p50_ms": self._round(ext.percentile(50)),
                "extract_ms_total": round(self.extract_ms_total, 3),
                "batches": self.batches,
                "rejected": self.rejected,
                "expired": self.expired,
                "errors": self.errors,
                "shutdown": self.shutdown,
                "retries": self.retries,
                "oom_degrades": self.oom_degrades,
                "requeued": self.requeued,
                "watchdog_trips": self.watchdog_trips,
                "requeue_shed": self.requeue_shed,
                "mesh_faults": self.mesh_faults,
                "mesh_degrades": self.mesh_degrades,
                "audits_run": self.audits_run,
                "audit_failures": self.audit_failures,
                "audit_errors": self.audit_errors,
                "audit_dropped": self.audit_dropped,
                "audit_p50_lag_ms": self._round(self._audit_lag_hist.percentile(50)),
                "quarantines": self.quarantines,
                "cache_hits": self.cache_hits,
                "cache_misses": self.cache_misses,
                "cache_evictions": self.cache_evictions,
                "cache_bytes": self.cache_bytes,
                "cache_quarantines": self.cache_quarantines,
                "single_flight_collapses": self.single_flight_collapses,
                "landmark_exact": self.landmark_exact,
                "landmark_bounded": self.landmark_bounded,
                "landmark_fallback": self.landmark_fallback,
                # Hit-path latency is all-time (hits are microsecond
                # NumPy work — there is no cold-batch-haunts-p99 problem
                # to age out), keeping the split p50 pair comparable.
                "hit_p50_ms": self._round(self._hit_hist.percentile(50)),
            }
        if queue_depth is not None:
            out["queue_depth"] = queue_depth
        if lanes is not None:
            out["lanes"] = lanes
        if extra:
            # Service-level observations riding the line (breaker state,
            # drain flag, injected-fault audit — BfsService.statsz_extras).
            out.update(extra)
        return out

    def histograms(self) -> dict:
        """CONSISTENT COPIES of the mergeable all-time distributions,
        taken under the lock — a batch completing mid-render must not
        yield an exposition whose +Inf bucket disagrees with its _count
        (the Prometheus histogram invariant scrapers difference on).
        Copies are also safe to hand to a merging aggregator."""
        with self._lock:
            return {
                "latency_ms": Log2Histogram().merge(self._latency_hist),
                "extract_ms": Log2Histogram().merge(self._extract_hist),
                "hit_ms": Log2Histogram().merge(self._hit_hist),
            }

    def prometheus_text(self, snapshot: dict | None = None, **kw) -> str:
        """THE ONE /metricz renderer (BfsService.metricz and the
        periodic ``--metricz-out`` writer both delegate here): pass the
        exact snapshot dict another rendering just printed (the statsz
        line) so the two outputs come from one observation and can
        never disagree; with no snapshot given, one is taken now."""
        from tpu_bfs_torch.obs.exporters import prometheus_text

        snap = snapshot if snapshot is not None else self.snapshot(**kw)
        return prometheus_text(snap, histograms=self.histograms())

    def statsz_line(self, snapshot: dict | None = None, **kw) -> str:
        """The periodic stderr line: a stable prefix + one JSON object, so
        log scrapers can grep ``statsz`` and parse the rest. The only
        path that advances the interval-QPS window — either directly or
        via the prebuilt ``snapshot`` the periodic emitter shares with
        the /metricz rendering."""
        if snapshot is None:
            snapshot = self.snapshot(mark_interval=True, **kw)
        return "statsz " + json.dumps(snapshot)
