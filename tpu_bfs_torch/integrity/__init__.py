"""The online result-integrity tier, the port of ``tpu_bfs/integrity``.

The reference validates every run against a CPU golden (checkOutput,
bfs.cu:374-384); the Graph500 discipline validates by tree properties at
scales where no oracle fits. The serve tier audits continuously, in the
serve path, without touching serving latency:

- **structural audits** (``structural.py``): the tree predicates on
  sampled lanes of every served batch, in plain PyTorch on the device:
  parent-edge and level properties for bfs, weighted relaxation for sssp,
  path validity for p2p, consistency for cc and khop;
- **shadow re-execution** (``shadow.py``): a deterministic sample of
  resolved queries replayed on a DISJOINT engine (another width rung)
  and bit-compared;
- **wire checksums** (``wire.py``): an order-sensitive 32-bit fold of
  the audited distance row on both sides of its host-to-device copy,
  behind the ``audit_checksum`` flag;
- **staleness audits** (``staleness.py``): on a dynamic-graph service,
  sampled answers replay against CPU oracles of a bounded ring of recent
  generation snapshots, measuring how many flips behind the served answer
  sits: the only detector that catches a torn generation flip (a stale
  answer passes every structural predicate, and a shadow replay on the
  same torn service reproduces it);
- **quarantine** (this module): a confirmed finding evicts the suspect
  rung from the registry, force-opens its (width, devices, kind) circuit
  breaker so routing stops offering it, and dumps the flight recorder
  naming the corrupted query.

Everything here runs on the extraction worker or the audit thread. Audit
failures are CONFIRMED corruption (exact property violations, exact
replays disagreeing); errors of the audit itself count apart and never
quarantine. The fault kinds ``corrupt_result`` and ``corrupt_wire``
drive every detector red before green.

On a dynamic service the structural and shadow audits of a batch or
answer that a graph flip superseded are shed, not judged: the audit's
tables and engines follow the live generation. Repeated findings on a
mesh escalate to the service's mesh degrade ladder, as in JAX.
"""

from __future__ import annotations

import threading
import time

from tpu_bfs_torch import obs as _obs
from tpu_bfs_torch.integrity.shadow import (  # noqa: F401 — package API
    AuditSampler,
    ShadowAuditor,
    ShadowJob,
    compare_payloads,
)
from tpu_bfs_torch.integrity.staleness import (  # noqa: F401 — package API
    StalenessAuditor,
)
from tpu_bfs_torch.integrity.structural import (  # noqa: F401 — package API
    StructuralAuditor,
    StructuralFinding,
)

#: Ok-lanes of each served batch that get the structural audit.
STRUCTURAL_LANES = 1


class QuarantineManager:
    """Corruption findings -> rung eviction + breaker + escalation.

    The service binds the three actions (``quarantine_rung``,
    ``escalate_mesh`` and its metrics); this class owns only the
    policy: every confirmed finding quarantines its rung, and
    ``escalate_after`` device-attributed findings on the same mesh span
    (devices > 1) escalate to the mesh-degrade ladder — a whole mesh
    corrupting repeatedly is a hardware incident, not a bad compile."""

    def __init__(self, *, quarantine_rung, escalate_mesh, metrics, log=None,
                 escalate_after: int = 3):
        self._quarantine_rung = quarantine_rung  # (width, kind) -> None
        self._escalate_mesh = escalate_mesh  # (devices, cause) -> None
        self._metrics = metrics
        self._log = log or (lambda msg: None)
        self._escalate_after = max(int(escalate_after), 1)
        self._lock = threading.Lock()
        self._mesh_findings: dict = {}  # guarded-by: _lock — devices -> count

    def report(self, *, width: int, devices: int, kind: str, query_id,
               detail: str, source: str) -> None:
        """One CONFIRMED corruption finding from ``source`` (structural |
        shadow | checksum) against the rung that served ``query_id``."""
        from tpu_bfs_torch.utils.recovery import COUNTERS

        self._metrics.record_quarantine()
        COUNTERS.bump("quarantines")
        self._log(
            f"CORRUPTION ({source}) on query {query_id!r}: {detail[:300]} "
            f"— quarantining the {width}-lane {kind} rung "
            f"(devices={devices})"
        )
        rec = _obs.ACTIVE
        if rec is not None:
            # Flight-recorder trigger: a corruption finding is exactly
            # the incident whose run-up (the serving batch's span chain,
            # the fault injection if chaos is armed) the ring buffer
            # holds; the dump names the corrupted query, and its label
            # names the DETECTOR that fired — a real-hardware corruption
            # must not masquerade as a chaos fault kind.
            rec.event("corruption", cat="serve.integrity", query=query_id,
                      kind=kind, width=width, devices=devices,
                      source=source, detail=detail[:300])
            rec.flight_dump(f"corruption_{source}")
        self._quarantine_rung(width, kind)
        if devices > 1:
            with self._lock:
                n = self._mesh_findings.get(devices, 0) + 1
                self._mesh_findings[devices] = n
            if n >= self._escalate_after:
                with self._lock:
                    self._mesh_findings[devices] = 0
                self._log(
                    f"ESCALATING: {n} corruption findings attributed to "
                    f"the {devices}-device mesh — running the mesh "
                    f"degrade ladder"
                )
                self._escalate_mesh(devices, RuntimeError(
                    f"repeated result corruption on the {devices}-device "
                    f"mesh ({source}: {detail[:200]})"
                ))


class IntegrityTier:
    """The serve-side composition: sampling, structural checks, shadow
    replays, and quarantine, bound to one :class:`BfsService`.

    Constructed (and started) only when armed — ``audit_rate > 0`` or a
    structural/checksum flag — so un-audited services pay nothing."""

    def __init__(self, service, *, rate: float = 0.0,
                 structural: bool = False, checksum: bool = False,
                 seed: int = 0):
        self._service = service
        self.rate = float(rate)
        self.checksum = bool(checksum)
        self._sampler = AuditSampler(rate, seed)
        self._structural = (
            StructuralAuditor(service._graph, checksum=checksum,
                              device=service._registry.device)
            if structural or checksum else None
        )
        self.quarantine = QuarantineManager(
            quarantine_rung=service._quarantine_rung,
            escalate_mesh=service._escalate_mesh,
            metrics=service.metrics,
            log=service._log,
        )
        self._shadow = (
            ShadowAuditor(
                acquire_engine=service._acquire_shadow_engine,
                on_mismatch=self._on_shadow_mismatch,
                metrics=service.metrics,
                log=service._log,
                current_state=lambda: (
                    getattr(service, "graph_generation", 0),
                    getattr(service, "_overlay_epoch", 0),
                ),
            )
            if self.rate > 0 else None
        )

    # --- lifecycle --------------------------------------------------------

    def start(self) -> "IntegrityTier":
        """Start the audit worker AND pay the tier's one-time costs here,
        on the cold-start path, instead of lazily at the first audit:

        - the structural auditor's device edge tables (a host-to-device
          copy of the edge list that would otherwise stall the
          extraction worker mid-traffic);
        - the shadow rung, when it is not already a warm serving rung
          (a single-rung ladder):
          ``registry.get`` holds the global registry lock for the whole
          build, and a mid-traffic build there would freeze dispatch —
          exactly the hot path the tier promises never to touch. With a
          multi-rung ladder the disjoint rung IS a serving rung and
          this is a cache hit; non-primary kinds' shadow engines still
          build lazily on their first sampled audit (documented)."""
        svc = self._service
        if self._structural is not None:
            try:
                self._structural.prepare()
            except Exception as exc:  # noqa: BLE001 — degrade, don't block serving
                svc._log(f"structural-audit prepare failed "
                         f"({type(exc).__name__}: {str(exc)[:200]}); "
                         f"the tables will build on first audit")
        if self._shadow is not None:
            if len(svc.width_ladder) == 1:
                try:
                    svc._acquire_shadow_engine(
                        svc.width_ladder[0], svc._primary_kind
                    )
                except Exception as exc:  # noqa: BLE001 — lazy fallback
                    svc._log(f"shadow-rung prewarm failed "
                             f"({type(exc).__name__}: {str(exc)[:200]}); "
                             f"building on first audit")
            self._shadow.start()
        return self

    def close(self) -> None:
        if self._shadow is not None:
            self._shadow.close()

    def flush(self, timeout: float = 60.0) -> bool:
        """Barrier: every batch already handed to the extraction path
        has finished its finish+observe window, the pipeline handoff is
        empty, and every enqueued shadow audit has been processed — the
        point after which the audit counters are complete for all
        RESOLVED queries (the bench and the smokes read them here)."""
        svc = self._service
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            pipe = svc._pipe_q
            with svc._audit_quiesce:
                busy = svc._finishing
            if busy == 0 and (pipe is None or pipe.empty()):
                break
            time.sleep(0.005)
        else:
            return False
        if self._shadow is None:
            return True
        return self._shadow.flush(max(deadline - time.monotonic(), 0.01))

    def config_summary(self) -> dict:
        return {
            "rate": self.rate,
            "structural": self._structural is not None,
            "checksum": self.checksum,
        }

    # --- the per-batch hook (extraction worker) ---------------------------

    def observe_batch(self, pending) -> None:
        """Audit one successfully-finished batch: structural checks on up
        to ``STRUCTURAL_LANES`` ok-lanes, shadow enqueue for the
        sampled fraction of resolutions. Runs AFTER every query resolved
        — audits never add client-visible latency — and must never let
        an exception reach the serving path (the caller treats any
        escape as a bug; everything is caught and counted here)."""
        now = time.monotonic()
        structural_left = STRUCTURAL_LANES
        for q in pending.queries:
            try:
                r = q.result(0)
                if not r.ok:
                    continue
                if self._structural is not None and structural_left > 0:
                    structural_left -= 1
                    self._audit_structural(pending, q, r)
                if self._shadow is not None and self._sampler.should_sample():
                    job = ShadowJob(
                        query_id=q.id, kind=r.kind, source=q.source,
                        k=getattr(q, "k", None),
                        target=getattr(q, "target", None),
                        width=pending.lanes, devices=pending.devices,
                        distances=r.distances, levels=r.levels,
                        reached=r.reached,
                        extras=dict(r.extras) if r.extras else None,
                        t_resolved=now,
                        generation=int(getattr(pending, "generation", 0)),
                        epoch=int(getattr(pending, "overlay_epoch", 0)),
                    )
                    self._shadow.offer(job)
            except Exception as exc:  # noqa: BLE001 — the seal: audits never
                # become serving incidents. This catches what the inner
                # handlers can't — a quarantine action itself failing
                # (flight dump on a full disk, a mesh escalation's
                # rebuild erroring) — and files it as an audit error
                # instead of letting _finish's executor-error path
                # misattribute a SERVED batch as failed.
                self._service.metrics.record_audit_error()
                self._service._log(
                    f"audit pipeline errored (query "
                    f"{getattr(q, 'id', None)!r}): "
                    f"{type(exc).__name__}: {str(exc)[:200]}"
                )

    def _audit_structural(self, pending, q, r) -> None:
        svc = self._service
        # The generation gate: the auditor's edge tables track the LIVE
        # generation (the flip rebinds them), so a batch stamped with a
        # superseded generation cannot be judged (its removed edges would
        # read as violations); the staleness auditor owns it.
        gen = int(getattr(pending, "generation", 0))
        if gen != int(getattr(svc, "graph_generation", 0)):
            return
        t0 = time.monotonic()
        try:
            self._structural.audit(r.kind, r)
        except StructuralFinding as exc:
            if gen != int(getattr(svc, "graph_generation", 0)):
                # The flip landed DURING the audit (the tables may have
                # been rebound mid-check): the graph changed, the rung
                # did not fail. Shed it.
                svc.metrics.record_audit_dropped()
                return
            svc.metrics.record_audit(
                (time.monotonic() - t0) * 1e3, failed=True
            )
            self.quarantine.report(
                width=pending.lanes, devices=pending.devices, kind=r.kind,
                query_id=q.id, detail=str(exc), source="structural",
            )
            return
        except Exception as exc:  # noqa: BLE001 — audit infra, not corruption
            svc.metrics.record_audit_error()
            svc._log(
                f"structural audit errored (query {q.id!r}): "
                f"{type(exc).__name__}: {str(exc)[:200]}"
            )
            return
        svc.metrics.record_audit((time.monotonic() - t0) * 1e3)

    # --- the answer-tier hook (client thread) ----------------------------

    def observe_answer(self, q, *, origin: str) -> None:
        """Audit one answer served WITHOUT a traversal (cache hit or
        exact landmark bound): the same deterministic shadow sample as
        batch resolutions, replayed on the disjoint rung. The ShadowJob
        carries ``origin`` so a confirmed mismatch quarantines the cache
        generation / landmark index — the replay rung told the truth."""
        if self._shadow is None:
            return
        svc = self._service
        try:
            if not self._sampler.should_sample():
                return
            r = q.result(0)
            if not r.ok:
                return
            job = ShadowJob(
                query_id=q.id, kind=r.kind, source=q.source,
                k=getattr(q, "k", None),
                target=getattr(q, "target", None),
                width=svc.width_ladder[0],
                devices=svc._mesh_cfg.devices,
                distances=r.distances, levels=r.levels,
                reached=r.reached,
                extras=dict(r.extras) if r.extras else None,
                t_resolved=time.monotonic(),
                origin=origin,
                generation=int(getattr(svc, "graph_generation", 0)),
                epoch=int(getattr(svc, "_overlay_epoch", 0)),
            )
            self._shadow.offer(job)
        except Exception as exc:  # noqa: BLE001 — audits never become
            # serving incidents (same seal as observe_batch).
            svc.metrics.record_audit_error()
            svc._log(
                f"answer-tier audit errored (query "
                f"{getattr(q, 'id', None)!r}): "
                f"{type(exc).__name__}: {str(exc)[:200]}"
            )

    def _on_shadow_mismatch(self, job: ShadowJob, detail: str) -> None:
        origin = getattr(job, "origin", "serve")
        if origin in ("cache", "landmark"):
            # The replay ran on a healthy rung and disagreed with a
            # bypass answer: the stale/corrupt thing is the CACHED
            # payload (or the landmark columns), not the rung — indict
            # the answer tier's generation, never the replay rung (the
            # ``quarantines`` counter stays rung-only; the cache tier
            # counts its own ``cache_quarantines``).
            self._service._log(
                f"CORRUPTION (shadow/{origin}) on query {job.query_id!r}: "
                f"{detail[:300]} — quarantining the {origin} tier"
            )
            self._service.quarantine_answer_tier(origin, detail=detail)
            return
        self.quarantine.report(
            width=job.width, devices=job.devices, kind=job.kind,
            query_id=job.query_id, detail=detail, source="shadow",
        )
