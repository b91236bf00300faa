"""The port's integrity tier (``tpu_bfs_torch/integrity``) against the JAX
package's (``tpu_bfs/integrity``).

The same inputs go through both: the checksum folds and their multiplier
table, the sampler, the CPU oracles, every structural detector (its
finding text too), the shadow compare and spec choice, the breaker trip
and the quarantine policy; then a live service of each package with the
same audit knobs and fault spec, whose answers and audit counters must be
equal.

SSSP is held to ``oracle_sssp`` (a heap Dijkstra over the CSR, which takes
the lightest of parallel edge slots), never to SciPy's ``dijkstra`` over
``to_scipy(weighted=True)``: on an R-MAT graph with parallel slots SciPy
keeps one of them, not the lightest, so its row breaks the relaxation
property and both auditors rightly report it
(``tests/test_integrity.py::test_structural_sssp_relaxation_property``
fails for that reason).
"""

import numpy as np
import pytest
from scipy.sparse import csgraph

from tpu_bfs import faults as jfaults
from tpu_bfs.graph.generate import random_graph as jrandom
from tpu_bfs.graph.generate import rmat_graph as jrmat
from tpu_bfs.integrity import QuarantineManager as JQuarantine
from tpu_bfs.integrity.shadow import AuditSampler as JSampler
from tpu_bfs.integrity.shadow import ShadowJob as JJob
from tpu_bfs.integrity.shadow import compare_payloads as jcompare
from tpu_bfs.integrity.shadow import splitmix32 as jsplitmix
from tpu_bfs.integrity.staleness import oracle_bfs as joracle_bfs
from tpu_bfs.integrity.staleness import oracle_sssp as joracle_sssp
from tpu_bfs.integrity.structural import StructuralAuditor as JAuditor
from tpu_bfs.integrity.wire import _mults_np as jmults
from tpu_bfs.integrity.wire import make_i32_checksum as jmake_i32
from tpu_bfs.integrity.wire import words_checksum_np as jwords
from tpu_bfs.serve import BfsService as JService
from tpu_bfs.serve.executor import CircuitBreaker as JBreaker
from tpu_bfs.serve.scheduler import QueryResult as JResult
from tpu_bfs.utils.recovery import COUNTERS as JCOUNTERS

from tpu_bfs_torch import faults as tfaults
from tpu_bfs_torch.graph.csr import INF_DIST
from tpu_bfs_torch.graph.generate import random_graph as trandom
from tpu_bfs_torch.graph.generate import rmat_graph as trmat
from tpu_bfs_torch.integrity import QuarantineManager as TQuarantine
from tpu_bfs_torch.integrity.shadow import AuditSampler as TSampler
from tpu_bfs_torch.integrity.shadow import ShadowJob as TJob
from tpu_bfs_torch.integrity.shadow import compare_payloads as tcompare
from tpu_bfs_torch.integrity.shadow import splitmix32 as tsplitmix
from tpu_bfs_torch.integrity.staleness import ORACLES
from tpu_bfs_torch.integrity.staleness import oracle_bfs as toracle_bfs
from tpu_bfs_torch.integrity.staleness import oracle_sssp as toracle_sssp
from tpu_bfs_torch.integrity.structural import StructuralAuditor as TAuditor
from tpu_bfs_torch.integrity.wire import _mults_np as tmults
from tpu_bfs_torch.integrity.wire import make_i32_checksum as tmake_i32
from tpu_bfs_torch.integrity.wire import words_checksum_np as twords
from tpu_bfs_torch.serve import BfsService as TService
from tpu_bfs_torch.serve.executor import CircuitBreaker as TBreaker
from tpu_bfs_torch.serve.executor import breaker_key
from tpu_bfs_torch.serve.scheduler import QueryResult as TResult
from tpu_bfs_torch.utils.recovery import COUNTERS as TCOUNTERS

from torch_threads import cap_torch_threads

cap_torch_threads()


@pytest.fixture(autouse=True)
def _disarmed():
    for f, c in ((jfaults, JCOUNTERS), (tfaults, TCOUNTERS)):
        f.disarm()
        c.reset()
    yield
    jfaults.disarm()
    tfaults.disarm()


# --- the checksum fold ---------------------------------------------------------


@pytest.mark.parametrize("n", [1, 7, 129, 4099])
def test_mults_and_host_fold_equal_jax(n):
    np.testing.assert_array_equal(tmults(n), jmults(n))
    rng = np.random.default_rng(n)
    for arr in (rng.integers(0, 2**32, n, dtype=np.uint32),
                rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32),
                rng.integers(0, 256, n + 3, dtype=np.uint8)):
        assert twords(arr) == jwords(arr)


@pytest.mark.parametrize("n", [6, 1000, 1 << 16])
def test_device_fold_equals_host_fold_and_jax(n):
    rng = np.random.default_rng(7 + n)
    row = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    row[::5] = INF_DIST
    row[1::7] = -1  # all 32 bits set: the masked int64 terms' widest case
    import torch

    got = tmake_i32(n, "cpu")(torch.from_numpy(row))
    assert got == twords(row) == int(jmake_i32(n)(row))


def test_every_single_bit_flip_changes_the_device_fold():
    import torch

    rng = np.random.default_rng(11)
    row = rng.integers(-2**31, 2**31, 6, dtype=np.int64).astype(np.int32)
    fold = tmake_i32(6, "cpu")
    base = fold(torch.from_numpy(row))
    for i in range(len(row)):
        for b in range(32):
            flipped = row.view(np.uint32).copy()
            flipped[i] ^= np.uint32(1 << b)
            assert fold(torch.from_numpy(flipped.view(np.int32))) != base, (i, b)


# --- sampler and oracles ------------------------------------------------------


@pytest.mark.parametrize("rate,seed", [(0.1, 0), (0.5, 9), (0.0, 3), (1.0, 3)])
def test_sampler_equals_jax(rate, seed):
    assert [tsplitmix(x) for x in range(64)] == [jsplitmix(x) for x in range(64)]
    t, j = TSampler(rate, seed), JSampler(rate, seed)
    assert t.picks(500) == j.picks(500)
    assert [t.should_sample() for _ in range(300)] == [j.should_sample() for _ in range(300)]
    with pytest.raises(ValueError):
        TSampler(1.5)


def test_oracles_equal_jax_and_scipy_keeps_parallel_slots():
    tg, jg = trmat(7, 8, seed=31, weights=5), jrmat(7, 8, seed=31, weights=5)
    assert set(ORACLES) == {"bfs", "sssp"}
    for s in (0, 5, 17):
        np.testing.assert_array_equal(toracle_bfs(tg, s), joracle_bfs(jg, s))
        np.testing.assert_array_equal(toracle_sssp(tg, s), joracle_sssp(jg, s))
    # The known red's root cause: SciPy's row over the parallel slots is
    # not the min-folded one, and breaks the relaxation property.
    d = csgraph.dijkstra(tg.to_scipy(weighted=True), indices=0)
    scipy_row = np.where(np.isinf(d), INF_DIST, d).astype(np.int32)
    assert (scipy_row != toracle_sssp(tg, 0)).sum() > 0
    aud = TAuditor(tg, device="cpu")
    import torch

    assert aud.violations("sssp", torch.from_numpy(toracle_sssp(tg, 0))) == 0
    assert aud.violations("sssp", torch.from_numpy(scipy_row)) == \
        int(JAuditor(jg)._kernel("sssp")(scipy_row))
    assert aud.violations("sssp", torch.from_numpy(scipy_row)) > 0


# --- structural detectors -----------------------------------------------------


def _both(pkg_graph, **kw):
    """(port finding text or None, JAX finding text or None) of one audit."""
    out = []
    for aud, res_cls in ((TAuditor(pkg_graph[0], device="cpu", **kw), TResult),
                         (JAuditor(pkg_graph[1], **kw), JResult)):
        def audit(kind_, _aud=aud, _cls=res_cls, **fields):
            r = _cls(id=1, source=fields.pop("source", 0), status="ok", kind=kind_, **fields)
            try:
                _aud.audit(kind_, r)
            except Exception as exc:  # noqa: BLE001 — compared by type name and text
                return f"{type(exc).__name__}: {exc}"
            return None
        out.append(audit)
    return out


def _scenarios(dist, wdist, path_graph):
    fin = np.flatnonzero(dist != INF_DIST)
    flipped = dist.copy()
    flipped[fin[len(fin) // 2]] ^= 1
    off = dist.copy()
    off[0] += 1
    reached = int((dist != INF_DIST).sum())
    wbad = wdist.copy()
    wbad[np.flatnonzero((wdist != INF_DIST) & (wdist > 0))[0]] += 64
    wreached = int((wdist != INF_DIST).sum())
    t, mid = path_graph
    ok = {"target": t, "met": True, "distance": 2, "path": [0, mid, t]}
    return [
        ("bfs", dict(distances=dist, reached=reached)),
        ("bfs", dict(distances=flipped, reached=reached)),
        ("bfs", dict(distances=dist, reached=reached + 1)),
        ("bfs", dict(distances=off, reached=reached)),
        ("bfs", dict(distances=dist[:-1], reached=reached)),
        ("bfs", dict(reached=reached, levels=3)),  # metadata only
        ("sssp", dict(distances=wdist, reached=wreached)),
        ("sssp", dict(distances=wbad, reached=wreached)),
        ("p2p", dict(extras=ok)),
        ("p2p", dict(extras={**ok, "distance": 3})),
        ("p2p", dict(extras={**ok, "path": None})),
        ("p2p", dict(extras={**ok, "path": [0, t, t]})),
        ("p2p", dict(extras={**ok, "path": [1, mid, t]})),
        ("p2p", dict(extras={"target": t, "met": False, "distance": None, "path": None})),
        ("p2p", dict(extras={"target": t, "met": False, "distance": 2, "path": [0, t]})),
        ("cc", dict(reached=10, extras={"component": 3, "component_size": 10,
                                        "components": 4})),
        ("cc", dict(reached=10, extras={"component": 3, "component_size": 11,
                                        "components": 4})),
        ("cc", dict(reached=10, extras={"component": 10**6, "component_size": 10,
                                        "components": 4})),
        ("cc", dict(reached=10, extras={"component": 3, "component_size": 10,
                                        "components": 0})),
        ("khop", dict(reached=5, levels=2, extras={"k": 2})),
        ("khop", dict(reached=0, levels=2, extras={"k": 2})),
        ("khop", dict(reached=5, levels=-1, extras={"k": 2})),
        ("khop", dict(reached=5, levels=2, extras={"k": -1})),
    ]


def test_structural_findings_equal_jax():
    tg, jg = trandom(60, 600, seed=13, weights=5), jrandom(60, 600, seed=13, weights=5)
    dist = toracle_bfs(tg, 0)
    wdist = toracle_sssp(tg, 0)
    t = int(np.flatnonzero(dist == 2)[0])
    mid = next(int(v) for v in range(tg.num_vertices)
               if dist[v] == 1 and tg.has_edge(0, v) and tg.has_edge(v, t))
    taudit, jaudit = _both((tg, jg))
    verdicts = []
    for kind, fields in _scenarios(dist, wdist, (t, mid)):
        got, want = taudit(kind, **dict(fields)), jaudit(kind, **dict(fields))
        assert got == want, (kind, fields)
        verdicts.append(got is None)
    # The seven clean answers pass; every mutation is a finding.
    assert [i for i, ok in enumerate(verdicts) if ok] == [0, 5, 6, 8, 13, 15, 19]


def test_checksum_mismatch_equal_jax():
    tg, jg = trandom(60, 300, seed=23), jrandom(60, 300, seed=23)
    dist = toracle_bfs(tg, 0)
    reached = int((dist != INF_DIST).sum())
    taudit, jaudit = _both((tg, jg), checksum=True)
    assert taudit("bfs", distances=dist, reached=reached) is None
    for faults, audit in ((tfaults, taudit), (jfaults, jaudit)):
        faults.arm_from_spec("seed=2:corrupt_wire:n=1")
        msg = audit("bfs", distances=dist, reached=reached)
        assert msg.startswith("StructuralFinding: wire checksum mismatch")
        assert faults.ACTIVE.counts()["corrupt_wire"] == 1
        assert audit("bfs", distances=dist, reached=reached) is None  # budget spent
    assert taudit("bfs", distances=dist, reached=reached) == \
        jaudit("bfs", distances=dist, reached=reached)


def test_audit_structural_site_fires_in_both():
    tg, jg = trandom(40, 160, seed=2), jrandom(40, 160, seed=2)
    taudit, jaudit = _both((tg, jg))
    dist = toracle_bfs(tg, 0)
    for faults, audit in ((tfaults, taudit), (jfaults, jaudit)):
        faults.arm_from_spec("seed=4:transient@audit_structural:n=1")
        assert "INTERNAL" in audit("bfs", distances=dist, reached=int((dist != INF_DIST).sum()))
        assert faults.ACTIVE.counts() == {"transient": 1}


# --- shadow compare, spec choice, breaker, quarantine -----------------------------


class _FakeRes:
    def __init__(self, dist=None, reached=0, ecc=0, extras=None):
        self._d, self._e = dist, extras
        self.reached, self.ecc = np.asarray([reached]), np.asarray([ecc])

    def distances_int32(self, i):
        return self._d

    def extras(self, i):
        return self._e


def test_compare_payloads_equal_jax():
    d = np.asarray([0, 1, 2, INF_DIST], np.int32)
    bad = d.copy()
    bad[1] ^= 1
    p2p = {"target": 5, "met": True, "distance": 2, "path": [0, 3, 5]}
    cases = [
        (dict(distances=d, reached=3), dict(dist=d.copy(), reached=3)),
        (dict(distances=d, reached=3), dict(dist=bad, reached=3)),
        (dict(reached=3), dict(reached=4)),
        (dict(kind="sssp", extras={"weighted": True, "sssp_rounds": 9}),
         dict(extras={"weighted": True, "sssp_rounds": 4})),
        (dict(kind="bfs", extras={"cache_hit": True, "x": 1}), dict(extras={"x": 2})),
        (dict(kind="p2p", extras=p2p), dict(extras={**p2p, "path": [0, 4, 5]})),
        (dict(kind="p2p", extras=p2p), dict(extras={**p2p, "distance": 3})),
        (dict(kind="bfs", levels=4), dict(ecc=5)),
    ]
    for job_kw, res_kw in cases:
        base = dict(query_id=1, kind="bfs", source=0, k=None, target=None, width=32, devices=1,
                    distances=None, levels=None, reached=None, extras=None, t_resolved=0.0)
        base.update(job_kw)
        assert tcompare(TJob(**base), _FakeRes(**res_kw)) == \
            jcompare(JJob(**base), _FakeRes(**res_kw)), job_kw


@pytest.mark.parametrize("ladder,width", [("32,64", 64), ("32,64", 32), ("off", 64),
                                          ("off", 32)])
def test_shadow_spec_equals_jax(ladder, width):
    lanes = 64 if ladder != "off" else width
    specs = []
    for svc_cls, gen, kw in ((TService, trandom, {"device": "cpu"}), (JService, jrandom, {})):
        svc = svc_cls(gen(96, 480, seed=3), lanes=lanes, width_ladder=ladder,
                      autostart=False, **kw)
        try:
            spec = svc._shadow_spec(width, "cc")
            specs.append((spec.lanes, spec.kind))
        finally:
            svc.close()
    assert specs[0] == specs[1] and specs[0][0] != width


def test_breaker_trip_equals_jax():
    seen = []
    for cls in (TBreaker, JBreaker):
        t = [0.0]
        br = cls(threshold=3, cooldown_s=10.0, now=lambda: t[0])
        key = breaker_key(64, 1, "bfs")
        steps = [br.allow(key)]
        br.trip(key)
        steps += [br.allow(key), key in br.open_keys(), br.opens]
        t[0] = 11.0
        steps.append(br.allow(key))
        br.record_success(key)
        steps += [br.allow(key), br.open_keys()]
        seen.append(steps)
    assert seen[0] == seen[1] == [True, False, True, 1, True, True, []]
    assert TCOUNTERS.breaker_opens == JCOUNTERS.breaker_opens == 1


def test_quarantine_manager_equals_jax():
    runs = []
    for cls, counters in ((TQuarantine, TCOUNTERS), (JQuarantine, JCOUNTERS)):
        quarantined, escalated = [], []

        class _M:
            n = 0

            def record_quarantine(self):
                _M.n += 1

        qm = cls(quarantine_rung=lambda w, k: quarantined.append((w, k)),
                 escalate_mesh=lambda d, c: escalated.append(d), metrics=_M(),
                 escalate_after=3)
        for i in range(3):
            qm.report(width=64, devices=8, kind="bfs", query_id=i, detail="x", source="shadow")
        for i in range(5):
            qm.report(width=32, devices=1, kind="cc", query_id=i, detail="x",
                      source="structural")
        runs.append((quarantined, escalated, _M.n, counters.quarantines))
    assert runs[0] == runs[1]
    assert runs[0][1] == [8] and runs[0][2] == 8


# --- a live service of each package ---------------------------------------------


AUDIT_KEYS = ("audits_run", "audit_failures", "audit_errors", "audit_dropped",
              "quarantines", "completed", "batches", "breaker_opens", "routing")


def _live(pkg, spec, sources, *, sequential=False, **kw):
    """Answers and statsz of a fresh service of one package; with
    ``sequential`` each query waits for the previous one and its audits."""
    svc_cls, gen, faults = ((TService, trandom, tfaults) if pkg == "torch"
                            else (JService, jrandom, jfaults))
    if pkg == "torch":
        kw["device"] = "cpu"
    svc = svc_cls(gen(96, 480, seed=3), lanes=64, width_ladder="32,64", linger_ms=1.0,
                  autostart=False, **kw)
    try:
        if spec:
            faults.arm_from_spec(spec)
        if sequential:
            svc.start()
            answers = []
            for s in sources:
                answers.append(svc.query(s, timeout=120))
                assert svc.flush_audits(120)
                faults.disarm()
        else:
            pend = [svc.submit(s) for s in sources]
            svc.start()
            answers = [p.result(120) for p in pend]
        assert svc.flush_audits(120)
        snap = svc.statsz()
    finally:
        svc.close()
        faults.disarm()
    return answers, snap


@pytest.mark.serve
@pytest.mark.chaos
def test_corrupt_result_quarantine_equals_jax():
    """corrupt_result: the first answer is wrong; the structural and shadow
    audits find it, the rung is quarantined (evicted, breaker forced open),
    and every later answer equals the oracle. Counters equal JAX's."""
    g = trandom(96, 480, seed=3)
    runs = {pkg: _live(pkg, "seed=5:corrupt_result:n=1", [0, 3, 5, 7], sequential=True,
                       audit_rate=1.0, audit_structural=True)
            for pkg in ("torch", "jax")}
    (tans, tsnap), (jans, jsnap) = runs["torch"], runs["jax"]
    for k in AUDIT_KEYS:
        assert tsnap[k] == jsnap[k], k
    assert tsnap["audit_failures"] >= 1 and tsnap["quarantines"] >= 1
    assert tsnap["breaker_open"] == jsnap["breaker_open"] and tsnap["breaker_open"]
    assert TCOUNTERS.quarantines == JCOUNTERS.quarantines >= 1
    assert not np.array_equal(tans[0].distances, toracle_bfs(g, 0))
    for r, jr, s in zip(tans[1:], jans[1:], (3, 5, 7)):
        np.testing.assert_array_equal(r.distances, toracle_bfs(g, s))
        np.testing.assert_array_equal(r.distances, jr.distances)


@pytest.mark.serve
def test_batch_audit_runs_in_the_extraction_stream_context(monkeypatch):
    # The per-batch audit runs inside the extraction worker's stream context
    # (on the card its side stream), never on the dispatching stream.
    import contextlib
    from types import SimpleNamespace

    from tpu_bfs_torch.serve import frontend

    inside, seen = [], []

    @contextlib.contextmanager
    def ctx(stream):
        inside.append(stream)
        try:
            yield
        finally:
            inside.pop()

    monkeypatch.setattr(frontend, "_stream_ctx", ctx)
    svc = TService(trandom(96, 480, seed=3), lanes=64, device="cpu", autostart=False,
                   audit_structural=True)
    try:
        monkeypatch.setattr(svc._executor, "finish_batch", lambda pending, stream=None: None)
        monkeypatch.setattr(svc._integrity, "observe_batch",
                            lambda pending: seen.append(list(inside)))
        svc._finish(SimpleNamespace(queries=[]), stream="side")
    finally:
        svc.close()
    assert seen == [["side"]]


@pytest.mark.serve
def test_clean_audited_service_equals_jax():
    runs = {pkg: _live(pkg, None, [0, 3, 5, 7, 11], audit_rate=1.0, audit_structural=True,
                       audit_checksum=True) for pkg in ("torch", "jax")}
    (tans, tsnap), (jans, jsnap) = runs["torch"], runs["jax"]
    for k in AUDIT_KEYS:
        assert tsnap[k] == jsnap[k], k
    assert tsnap["audits_run"] >= 5 and tsnap["audit_failures"] == tsnap["quarantines"] == 0
    assert tsnap["audit_p50_lag_ms"] is not None
    assert tsnap["audit"] == jsnap["audit"] == {"rate": 1.0, "structural": True,
                                                "checksum": True}
    for r, jr in zip(tans, jans):
        np.testing.assert_array_equal(r.distances, jr.distances)


@pytest.mark.serve
@pytest.mark.chaos
def test_faults_in_the_audit_tier_equal_jax():
    """A transient at audit_shadow is retried; one at audit_structural is
    an audit error; neither is a finding or a serving failure."""
    spec = "seed=4:transient@audit_shadow:n=1,transient@audit_structural:n=1"
    runs = {pkg: _live(pkg, spec, [0], audit_rate=1.0, audit_structural=True)
            for pkg in ("torch", "jax")}
    (tans, tsnap), (jans, jsnap) = runs["torch"], runs["jax"]
    for k in AUDIT_KEYS:
        assert tsnap[k] == jsnap[k], k
    assert tsnap["audit_errors"] == 1 and tsnap["audit_failures"] == tsnap["quarantines"] == 0
    np.testing.assert_array_equal(tans[0].distances, jans[0].distances)
