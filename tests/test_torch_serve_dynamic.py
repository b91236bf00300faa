"""Dynamic-graph serving in the port (``BfsService(dynamic=...)``) against
the JAX package's, on the CPU.

The same mutation stream and queries go through a JAX service and a port
service (device="cpu"): the mutation stats other than ``flip_ms``, every
answer (distances, levels, reached, extras, lanes), the statsz ``dynamic``
echo and the audit counters must be equal, and every answer must equal the
CPU oracle of its generation's materialized graph. The chaos arms
(``torn_flip``, ``corrupt_overlay``, ``compaction_crash``) and a compaction
on overflow run as one scripted sequence per package, built once per
module; each test reads its steps. The cases of ``tests/test_dynamic.py``
that need no JAX side (the straggler guard, the landmark re-warm, the
concurrent flips) hold the port to the same assertions.
"""

import glob
import os
import sys
import threading

import numpy as np
import pytest

from tpu_bfs import faults as jfaults
from tpu_bfs.graph.generate import random_graph as jrandom
from tpu_bfs.serve import BfsService as JService
from tpu_bfs.serve.registry import EngineSpec as JSpec

from tpu_bfs_torch import faults as tfaults
from tpu_bfs_torch.graph.generate import random_graph as trandom
from tpu_bfs_torch.integrity.staleness import oracle_bfs, oracle_sssp
from tpu_bfs_torch.serve import BfsService as TService
from tpu_bfs_torch.serve.registry import EngineSpec as TSpec

pytestmark = pytest.mark.serve

GRAPH = dict(num_vertices=96, num_edges=480, seed=3, weights=5)
CAP = (64, 32)
AUDITS = ("audits_run", "audit_failures", "audit_errors", "audit_dropped",
          "quarantines", "cache_quarantines", "completed", "errors")


@pytest.fixture(autouse=True)
def _disarm_faults():
    yield
    jfaults.disarm()
    tfaults.disarm()


def _canon(r) -> dict:
    d = None if r.distances is None else np.asarray(r.distances, np.int32).tolist()
    return {"status": r.status, "kind": r.kind, "levels": r.levels, "reached": r.reached,
            "extras": r.extras, "batch_lanes": r.batch_lanes,
            "dispatched_lanes": r.dispatched_lanes, "error": r.error, "distances": d}


def _flip(out: dict) -> dict:
    out = dict(out)
    assert out.pop("flip_ms") >= 0
    return out


def _cc_truth(mat, s):
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    m = sp.csr_matrix((np.ones(len(mat.col_idx)), mat.col_idx, mat.row_ptr),
                      shape=(mat.num_vertices, mat.num_vertices))
    n, labels = connected_components(m, directed=False)
    comp = labels == labels[s]
    return n, int(comp.sum()), int(np.flatnonzero(comp)[0])


def _service(cls, graph, **kw):
    kw.setdefault("lanes", 64)
    kw.setdefault("width_ladder", "off")
    kw.setdefault("linger_ms", 0.0)
    kw.setdefault("dynamic", CAP)
    if cls is TService:
        kw["device"] = "cpu"
    return cls(graph, **kw)


# --- the fuzz stream of tests/test_fuzz_cross_engine.py ------------------------------


def _fuzz(cls, rand) -> list:
    """JAX's interleaved mutate/query stream: three generations, each with
    bfs and sssp queries from two sources and a cc query."""
    g = rand(128, 640, seed=211, weights=5)
    svc = _service(cls, g, kinds=("bfs", "sssp", "cc"))
    rng = np.random.default_rng(503)
    out = []
    try:
        for gen in range(1, 4):
            add = [(int(rng.integers(0, 128)), int(rng.integers(0, 128)),
                    int(rng.integers(1, 6))) for _ in range(int(rng.integers(1, 4)))]
            cur = svc._dynamic.materialize()
            remove = []
            if rng.integers(2):
                u = int(rng.choice(np.flatnonzero(np.diff(cur.row_ptr))))
                remove = [(u, int(cur.col_idx[cur.row_ptr[u]]))]
            step = {"flip": _flip(svc.apply_edge_updates(add=add, remove=remove))}
            mat = svc._dynamic.materialize()
            step["mat"] = mat
            for s in (int(rng.integers(0, 128)), 0):
                step[("bfs", s)] = _canon(svc.query(s, timeout=120))
                step[("sssp", s)] = _canon(svc.query(s, kind="sssp", timeout=120))
            s = int(rng.integers(0, 128))
            step[("cc", s)] = _canon(svc.query(s, kind="cc", timeout=120))
            out.append(step)
        out.append({"statsz": svc.statsz()["dynamic"]})
    finally:
        svc.close()
    return out


def test_fuzz_mutation_stream_equals_jax():
    want, got = _fuzz(JService, jrandom), _fuzz(TService, trandom)
    assert len(got) == len(want) == 4
    for gen, (ws, gs) in enumerate(zip(want[:3], got[:3]), start=1):
        assert gs["flip"] == ws["flip"] and gs["flip"]["generation"] == gen
        mat = gs.pop("mat")
        ws.pop("mat")
        assert gs == ws, f"generation {gen}"
        for key, r in gs.items():
            if not isinstance(key, tuple):
                continue
            kind, s = key
            assert r["status"] == "ok"
            if kind == "bfs":
                assert r["distances"] == oracle_bfs(mat, s).tolist()
            elif kind == "sssp":
                assert r["distances"] == oracle_sssp(mat, s).tolist()
            else:
                ex = r["extras"]
                assert (ex["components"], ex["component_size"], ex["component"]) == \
                    _cc_truth(mat, s)
    assert got[3] == want[3]
    assert got[3]["statsz"]["flips"] == 3 and got[3]["statsz"]["generation"] == 3


# --- the chaos script ------------------------------------------------------------------


def _script(cls, faults, rand, gen_dir) -> dict:
    """One service through: a torn flip (caught by the staleness auditor,
    healed), a corrupt overlay (restaged by the CRC re-check), a compaction
    crash (rolled back, the orphan quarantined) and its retry, then a batch
    that overflows the overlay (compaction, then re-apply)."""
    logs = []
    svc = _service(cls, rand(**GRAPH), dynamic=(6, 32), audit_rate=1.0,
                   cache_bytes=1 << 20, kinds=("bfs", "sssp"),
                   generation_dir=gen_dir, log=logs.append)
    rec = {}

    def query(**kw):
        # The audits of an answer (a staleness finding restages the overlay)
        # land before the next query dispatches, whatever the timing.
        r = _canon(svc.query(5, timeout=120, **kw))
        svc.flush_audits()
        return r

    def answers(tag):
        mat = svc._dynamic.materialize()
        rec[tag] = {"bfs": query(), "sssp": query(kind="sssp"),
                    "truth_bfs": oracle_bfs(mat, 5).tolist(),
                    "truth_sssp": oracle_sssp(mat, 5).tolist()}

    def audits(tag):
        svc.flush_audits()
        snap = svc.statsz()
        rec[tag] = {"dynamic": snap["dynamic"], **{k: snap[k] for k in AUDITS}}

    try:
        answers("start")
        faults.arm_from_spec("torn_flip@generation_flip:n=1")
        rec["torn_flip"] = _flip(svc.apply_edge_updates(add=[(5, 90)], remove=[(0, 1)]))
        faults.disarm()
        answers("torn")  # one flip stale, still claiming the new generation
        audits("torn_audits")
        answers("healed")
        audits("healed_audits")
        faults.arm_from_spec("corrupt_overlay@generation_flip:n=1")
        rec["corrupt_flip"] = _flip(svc.apply_edge_updates(add=[(2, 93, 4)]))
        faults.disarm()
        rec["crc_logged"] = any("CRC re-check" in m for m in logs)
        answers("restaged")
        faults.arm_from_spec("compaction_crash@compact:n=1")
        with svc._flip_lock:
            try:
                svc._compact_locked()
                rec["crash"] = None
            except RuntimeError as exc:
                rec["crash"] = str(exc)
        faults.disarm()
        rec["corrupts"] = sorted(os.path.basename(p) for p in glob.glob(
            os.path.join(gen_dir, "*.corrupt")))
        rec["current_after_crash"] = svc._gen_store.current()
        answers("rolled_back")
        audits("crash_audits")
        with svc._flip_lock:
            svc._compact_locked()
        rec["current_after_retry"] = svc._gen_store.current()
        answers("compacted")
        rec["fill"] = _flip(svc.apply_edge_updates(add=[(20, 21), (22, 23)]))
        rec["overflow"] = _flip(svc.apply_edge_updates(add=[(24, 25), (26, 27, 2)]))
        answers("overflowed")
        audits("final")
    finally:
        svc.close()
    return rec


@pytest.fixture(scope="module")
def chaos(tmp_path_factory):
    want = _script(JService, jfaults, jrandom, str(tmp_path_factory.mktemp("jgen")))
    got = _script(TService, tfaults, trandom, str(tmp_path_factory.mktemp("tgen")))
    return want, got


def _exact(rec, tag) -> None:
    assert rec[tag]["bfs"]["distances"] == rec[tag]["truth_bfs"], tag
    assert rec[tag]["sssp"]["distances"] == rec[tag]["truth_sssp"], tag


def test_chaos_start_equals_jax(chaos):
    want, got = chaos
    assert got["start"] == want["start"]
    _exact(got, "start")


def test_torn_flip_caught_by_the_staleness_auditor_and_healed_as_in_jax(chaos):
    want, got = chaos
    for tag in ("torn_flip", "torn", "torn_audits", "healed", "healed_audits"):
        assert got[tag] == want[tag], tag
    assert got["torn_flip"]["generation"] == 1  # the metadata did advance
    # Red: the answer is one flip stale; only the staleness auditor sees it.
    assert got["torn"]["bfs"]["distances"] != got["torn"]["truth_bfs"]
    st = got["torn_audits"]["dynamic"]["staleness"]
    assert st["stale"] >= 1 and st["over_bound"] >= 1
    assert got["torn_audits"]["quarantines"] == 0 and got["torn_audits"]["audit_failures"] == 0
    # Green: the restage healed every engine.
    _exact(got, "healed")
    assert got["healed_audits"]["quarantines"] == 0


def test_corrupt_overlay_restaged_by_the_crc_recheck_as_in_jax(chaos):
    want, got = chaos
    assert got["corrupt_flip"] == want["corrupt_flip"]
    assert got["crc_logged"] and want["crc_logged"]
    assert got["restaged"] == want["restaged"]
    _exact(got, "restaged")


def test_compaction_crash_rolls_back_as_in_jax(chaos):
    want, got = chaos
    # The message names the raising package's fault module.
    assert got["crash"].replace("tpu_bfs_torch.", "tpu_bfs.") == want["crash"]
    assert got["corrupts"] == want["corrupts"] == ["gen_0001.npz.corrupt"]
    assert got["current_after_crash"] is None is want["current_after_crash"]
    assert got["rolled_back"] == want["rolled_back"]
    _exact(got, "rolled_back")
    assert got["crash_audits"] == want["crash_audits"]
    assert got["crash_audits"]["dynamic"]["compactions"] == 0
    # The retry folds cleanly; compaction is answer-neutral.
    assert got["current_after_retry"] == want["current_after_retry"] == 1
    assert got["compacted"] == want["compacted"] == {**want["rolled_back"]}


def test_overflow_compacts_and_reapplies_as_in_jax(chaos):
    want, got = chaos
    assert got["fill"] == want["fill"] and got["fill"]["compacted"] is False
    assert got["overflow"] == want["overflow"] and got["overflow"]["compacted"] is True
    assert got["overflowed"] == want["overflowed"]
    _exact(got, "overflowed")
    assert got["final"] == want["final"]
    assert got["final"]["dynamic"]["compactions"] == 2
    st = got["final"]["dynamic"]["staleness"]
    assert st["unmatched"] == 0 and st["errors"] == 0
    assert got["final"]["errors"] == 0 and got["final"]["audit_failures"] == 0


# --- the cases without a JAX side --------------------------------------------------------


def test_cross_flip_straggler_does_not_cache():
    """A batch resolved under generation G-1 after a flip to G must not file
    its payloads under the new generation's keys (the guard returns before
    the put loop touches a query)."""

    class _Boom:
        def result(self, _t):  # pragma: no cover - the guard must not reach it
            raise AssertionError("straggler reached the cache put loop")

    class _P:
        queries, generation = [_Boom()], 0

    for cls, rand in ((JService, jrandom), (TService, trandom)):
        svc = _service(cls, rand(**GRAPH), cache_bytes=1 << 20, autostart=False)
        try:
            assert svc.apply_edge_updates(add=[(5, 90)])["generation"] == 1
            svc._populate_cache(_P())
            assert svc._cache.stats()["entries"] == 0
            assert svc._cache.config_summary()["graph_generation"] == 1
        finally:
            svc.close()


def test_p2p_and_generation_dir_refusals_equal_jax(tmp_path):
    outs = []
    for cls, spec, rand in ((JService, JSpec, jrandom), (TService, TSpec, trandom)):
        got = []
        svc = _service(cls, rand(**GRAPH), autostart=False)
        got.append(svc.kinds)
        svc.close()
        for make in (lambda: spec(graph_key="g", kind="p2p", overlay=CAP).validate(),
                     lambda: spec(graph_key="g", overlay=CAP, pull_gate=True).validate(),
                     lambda: spec(graph_key="g", overlay=(0, 4)).validate(),
                     lambda: _service(cls, rand(**GRAPH), kinds=("p2p",), autostart=False),
                     lambda: _service(cls, rand(**GRAPH), dynamic=(), autostart=False,
                                      generation_dir=str(tmp_path)),
                     lambda: _service(cls, rand(**GRAPH), autostart=False,
                                      pull_gate=True)):
            with pytest.raises(ValueError) as exc:
                make()
            got.append(str(exc.value))
        static = _service(cls, rand(**GRAPH), dynamic=(), autostart=False)
        with pytest.raises(RuntimeError) as exc:
            static.apply_edge_updates(add=[(1, 2)])
        static.close()
        got.append(str(exc.value))
        outs.append(got)
    assert "p2p" not in outs[1][0]
    assert outs[1] == outs[0]


def test_landmark_tier_invalidated_and_rewarmed_on_flip():
    """The flip must invalidate the landmark columns BEFORE the new
    generation serves and re-warm them over an overlay-synced engine."""
    events = []

    class _SpyIndex:
        k = 4

        def invalidate(self):
            events.append("invalidate")

        def warm(self, run_batch):
            res = run_batch([5])
            events.append(("warm", np.asarray(res.distances_int32(0))))

    svc = _service(TService, trandom(**GRAPH))
    try:
        svc._landmarks = _SpyIndex()
        svc.apply_edge_updates(add=[(5, 90)], remove=[(0, 1)])
        mat = svc._dynamic.materialize()
        assert events and events[0] == "invalidate"
        tag, dist = events[1]
        assert tag == "warm"
        np.testing.assert_array_equal(dist, oracle_bfs(mat, 5))
    finally:
        svc.close()


def test_no_dropped_queries_across_concurrent_flips():
    """Live query threads (more than the cores, with a short switch
    interval) across generation flips: zero errors, final answers exact,
    no over-bound staleness."""
    svc = _service(TService, trandom(**GRAPH), linger_ms=2.0, audit_rate=0.25,
                   cache_bytes=1 << 20)
    switch = sys.getswitchinterval()
    try:
        sys.setswitchinterval(1e-5)
        stop = threading.Event()
        errs: list = []
        served = [0] * 12

        def traffic(i):
            rng = np.random.default_rng(7 + i)
            while not stop.is_set():
                try:
                    r = svc.query(int(rng.integers(0, 96)), timeout=180)
                    if not r.ok:
                        errs.append((r.status, r.error))
                    served[i] += 1
                except Exception as exc:  # noqa: BLE001 — recorded, asserted
                    errs.append(("exc", repr(exc)))

        threads = [threading.Thread(target=traffic, args=(i,)) for i in range(len(served))]
        for t in threads:
            t.start()
        mut = np.random.default_rng(11)
        for _ in range(4):
            add = [(int(mut.integers(0, 96)), int(mut.integers(0, 96)),
                    int(mut.integers(1, 6))) for _ in range(2)]
            svc.apply_edge_updates(add=add)
        stop.set()
        for t in threads:
            t.join(timeout=180)
        assert not any(t.is_alive() for t in threads)
        assert not errs, errs[:3]
        assert sum(served) > 0
        mat = svc._dynamic.materialize()
        for src in (0, 5, 42):
            np.testing.assert_array_equal(svc.query(src, timeout=180).distances,
                                          oracle_bfs(mat, src))
        svc.flush_audits()
        snap = svc.statsz()
        st = snap["dynamic"]["staleness"]
        assert st["over_bound"] == 0 and st["errors"] == 0
        assert snap["dynamic"]["flips"] == 4 and snap["audit_failures"] == 0
    finally:
        sys.setswitchinterval(switch)
        svc.close()
