"""The port's BfsService on a mesh against the JAX package's, the cases of
tests/test_serve_dist.py and tests/test_mesh_chaos.py.

JAX serves ``devices=4`` on its virtual CPU mesh; the port on one
module-scoped serving mesh of 4 gloo CPU ranks (``parallel/mesh.serve_mesh``:
this test process is rank 0, three followers replay its command stream),
started once. Both run on ``random_graph(96, 480, seed=3)``. Compared
between the packages: the served answers (wide 1D and dist2d 2x2), the
per-query traversal record, the padded-lane dedupe, the device count after
a ``device_lost`` (4 -> 2), the mesh counters, the resume's bounded
recompute, the probe-gated restore, the mesh OOM grid and the drain. The
ladder, spec-validation, breaker-key and ``MeshFaultRequeue`` cases use
fakes and no ranks. JAX's 2D engine is run only with the ring exchange
here (its sparse exchange deadlocks on the virtual devices when mesh rows
pick different rungs, ROADMAP Queue 3).
"""

import threading
import time
import types

import numpy as np
import pytest

from tpu_bfs import faults as jfaults
from tpu_bfs.graph import generate as jgen
from tpu_bfs.resilience import resume as jres
from tpu_bfs.serve import BfsService as JService
from tpu_bfs.serve import executor as jexec
from tpu_bfs.serve import frontend as jfront
from tpu_bfs.serve import registry as jreg
from tpu_bfs.serve.metrics import ServeMetrics as JMetrics
from tpu_bfs.serve.scheduler import PendingQuery as JQuery
from tpu_bfs.utils import checkpoint as jckpt
from tpu_bfs.utils.recovery import COUNTERS as JCOUNTERS

from tpu_bfs_torch import faults as tfaults
from tpu_bfs_torch.graph import generate as tgen
from tpu_bfs_torch.parallel.mesh import serve_mesh
from tpu_bfs_torch.reference.cpu_bfs import bfs_python
from tpu_bfs_torch.resilience import resume as tres
from tpu_bfs_torch.serve import BfsService as TService
from tpu_bfs_torch.serve import executor as texec
from tpu_bfs_torch.serve import frontend as tfront
from tpu_bfs_torch.serve import registry as treg
from tpu_bfs_torch.serve.metrics import ServeMetrics as TMetrics
from tpu_bfs_torch.serve.scheduler import PendingQuery as TQuery
from tpu_bfs_torch.utils import checkpoint as tckpt
from tpu_bfs_torch.utils.recovery import COUNTERS as TCOUNTERS

from torch_threads import cap_torch_threads

cap_torch_threads()

pytestmark = pytest.mark.serve

P = 4

J = types.SimpleNamespace(name="jax", Service=JService, faults=jfaults, res=jres,
                          ckpt=jckpt, COUNTERS=JCOUNTERS, kw={})
T = types.SimpleNamespace(name="torch", Service=TService, faults=tfaults, res=tres,
                          ckpt=tckpt, COUNTERS=TCOUNTERS, kw={"device": "cpu"})


@pytest.fixture(autouse=True)
def _disarmed():
    for mod in (jfaults, tfaults):
        mod.disarm()
    yield
    for mod in (jfaults, tfaults):
        mod.disarm()


@pytest.fixture(scope="module")
def mesh4():
    ctl = serve_mesh(P, device="cpu")
    yield ctl
    ctl.close()


@pytest.fixture(scope="module")
def graphs(mesh4):
    J.g = jgen.random_graph(96, 480, seed=3)
    T.g = tgen.random_graph(96, 480, seed=3)
    cand = np.flatnonzero(T.g.degrees > 0)[:8]
    return {int(s): bfs_python(T.g, int(s))[0] for s in cand}


def _svc(pkg, **kw):
    return pkg.Service(pkg.g, linger_ms=kw.pop("linger_ms", 5.0), **pkg.kw, **kw)


def _rec(r) -> dict:
    """A result's compared fields (timings and GTEPS are each package's)."""
    return {
        "source": r.source, "status": r.status, "error": r.error, "levels": r.levels,
        "reached": r.reached, "devices": r.devices, "edges": r.edges,
        "wire_bytes": r.wire_bytes, "batch_lanes": r.batch_lanes,
        "dispatched_lanes": r.dispatched_lanes,
        "distances": None if r.distances is None else r.distances.tobytes(),
    }


MESH_KEYS = ("devices", "mesh_degraded", "mesh_faults", "mesh_degrades", "oom_degrades",
             "requeued", "errors", "completed")


def _snap(svc) -> dict:
    s = svc.statsz()
    return {k: s.get(k) for k in MESH_KEYS} | {"ladder": s["ladder"], "lanes": s["lanes"]}


# --- host halves: ladder, specs, breaker, classifier (no ranks) ------------


@pytest.mark.parametrize("args", [
    (512, "auto", 1, "wide"), (512, "auto", 4, "wide"), (512, "auto", 8, "wide"),
    (64, "auto", 8, "wide"), (64, "auto", 4, "dist2d"), (8192, "auto", 4, "hybrid"),
    (512, "32,512", 4, "wide"), (512, "128,512", 4, "wide"), (8192, "512,8192", 4, "hybrid"),
    (256, "off", 4, "wide"),
])
def test_ladder_bounds_and_width_ladder_equal_jax(args):
    lanes, ladder, devices, engine = args
    outs = []
    for front in (tfront, jfront):
        b = front.ladder_bounds(lanes, devices=devices, engine=engine)
        try:
            outs.append((b, front.build_width_ladder(lanes, ladder, devices=devices,
                                                     engine=engine)))
        except ValueError as exc:
            outs.append((b, str(exc)))
    assert outs[0] == outs[1]


SPECS = [
    dict(engine="dist2d", devices=8, lanes=32, exchange="sparse", delta_bits=[8, 16],
         sieve=True, predict=True, mesh_shape=[2, 4]),
    dict(engine="dist2d", devices=1), dict(engine="wide", wire_pack=True),
    dict(engine="wide", devices=8, exchange="ring"),
    dict(engine="wide", devices=8, delta_bits=(8,)),
    dict(engine="wide", devices=8, exchange="sparse", sieve=True),
    dict(engine="hybrid", devices=8, lanes=512),
    dict(engine="dist2d", devices=8, mesh_shape=(3, 3)),
    dict(engine="wide", devices=8, mesh_shape=(2, 4)),
    dict(engine="packed", devices=2), dict(engine="wide", devices=4, pull_gate=True),
    dict(engine="dist2d", devices=4, pull_gate=True),
    dict(engine="dist2d", devices=4, lanes=32, resume_levels=4),
    dict(engine="wide", devices=4, lanes=32, resume_levels=4),
    dict(engine="wide", devices=4, resume_levels=-1),
    dict(engine="wide", devices=4, kind="sssp", exchange="sparse", predict=True),
    dict(engine="wide", devices=4, kind="sssp", exchange="sparse", sieve=True),
    dict(engine="wide", devices=4, kind="sssp", mesh_shape=(2, 2), exchange="ring"),
    dict(engine="wide", devices=4, kind="sssp", wire_pack=True),
    dict(engine="dist2d", devices=4, kind="khop"), dict(engine="dist2d", devices=4, kind="cc"),
]


@pytest.mark.parametrize("kw", SPECS, ids=[str(i) for i in range(len(SPECS))])
def test_engine_spec_mesh_validation_equals_jax(kw):
    outs = []
    for reg in (treg, jreg):
        spec = reg.EngineSpec(graph_key="g", **kw)
        try:
            spec.validate()
            outs.append(("ok", spec.delta_bits, spec.mesh_shape, hash(spec) is not None))
        except ValueError as exc:
            outs.append(("ValueError", str(exc)))
    assert outs[0] == outs[1]


class _Q:
    def __init__(self, s):
        self.id = self.source = s
        self.want_distances = True

    def expired(self, now):
        return False

    def resolve_status(self, *a, **k):
        return True


def _fake_mesh(pkg_name, devices):
    # JAX reads the mesh's device array, the port its rank count.
    if pkg_name == "jax":
        return types.SimpleNamespace(devices=np.empty(devices))
    return types.SimpleNamespace(num_shards=devices)


def test_breaker_keys_are_partition_aware_as_in_jax():
    """A mesh rung that trips opens (width, devices) only: the same width
    on one device or another mesh span stays routable."""
    outs = []
    for name, ex in (("torch", texec), ("jax", jexec)):
        class Dies:
            lanes = 32
            mesh = _fake_mesh(name, 8)

            def run(self, padded, time_it=False):
                raise RuntimeError("deterministic: boom")

        eng = Dies()
        br = ex.CircuitBreaker(threshold=1, cooldown_s=3600.0)
        metrics = TMetrics() if name == "torch" else JMetrics()
        ex.BatchExecutor(metrics, max_retries=0, breaker=br).run_batch(eng, [_Q(1)])
        outs.append((ex.engine_devices(eng), ex.engine_devices(types.SimpleNamespace(lanes=32)),
                     br.open_keys(), br.allow((32, 8)), br.allow((32, 1)), br.allow((32, 4))))
    assert outs[0] == outs[1] == (8, 1, [(32, 8)], False, True, True)


@pytest.mark.parametrize("devices", [8, 1])
def test_executor_mesh_fault_requeue_equals_jax(devices):
    """A DATA_LOSS on a mesh batch rides up as MeshFaultRequeue with the
    queries unresolved; on one device the same marker is a transient that
    retries in place."""
    outs = []
    for name, ex, query, metrics in (("torch", texec, TQuery, TMetrics()),
                                     ("jax", jexec, JQuery, JMetrics())):
        class MeshDies:
            lanes = 32
            mesh = _fake_mesh(name, devices)
            calls = 0

            def run(self, padded, time_it=False):
                MeshDies.calls += 1
                if MeshDies.calls == 1:
                    raise RuntimeError("DATA_LOSS: slice went away")

                class R:
                    reached = np.ones(32, dtype=np.int64)

                    @staticmethod
                    def distances_int32(i):
                        return np.zeros(4, np.int32)

                return R()

        q = query(3)
        executor = ex.BatchExecutor(metrics, backoff_s=0.0)
        try:
            executor.run_batch(MeshDies(), [q])
            got = ("resolved", q.result(5.0).ok)
        except ex.MeshFaultRequeue as exc:
            got = ("requeue", exc.devices, exc.queries == [q], q.done())
            q.resolve_status("error")
        with metrics._lock:
            outs.append((got, metrics.mesh_faults, metrics.retries))
    assert outs[0] == outs[1]


# --- served answers on the mesh ---------------------------------------------


@pytest.mark.parametrize("engine,lanes", [("wide", 64), ("dist2d", 32)])
def test_served_mesh_answers_equal_jax(graphs, engine, lanes):
    """Four queued queries, one batch: every answer, its traversal record
    (devices, edges, wire-bytes share) and the batch shape equal JAX's and
    the oracle's; a metadata-only query pulls no row."""
    outs = []
    for pkg in (T, J):
        svc = _svc(pkg, engine=engine, devices=P, lanes=lanes, width_ladder="off",
                   autostart=False)
        try:
            pend = [svc.submit(s) for s in sorted(graphs)[:4]]
            svc.start()
            rs = [p.result(300) for p in pend]
            meta = svc.query(5, want_distances=False, timeout=300)
            assert all(r.gteps and r.gteps > 0 for r in rs)
            outs.append(([_rec(r) for r in rs], _rec(meta), _snap(svc)))
        finally:
            svc.close()
    assert outs[0] == outs[1]
    for rec in outs[0][0]:
        assert rec["status"] == "ok" and rec["devices"] == P
        assert rec["distances"] == graphs[rec["source"]].tobytes()
    assert outs[0][1]["distances"] is None and outs[0][1]["reached"] == 96


def test_dist2d_planner_exchange_serves_jax_ring_answers(graphs):
    """The 2D service with the whole planner on its row exchange (sparse,
    wire_pack, delta ids, sieve, prediction, mesh 2x2) answers as JAX's
    ring service does; JAX's own sparse 2D engine is not run here (it
    deadlocks on its virtual devices when mesh rows pick different rungs)."""
    sources = sorted(graphs)[:3]
    outs = []
    for pkg, kw in ((T, dict(exchange="sparse", wire_pack=True, delta_bits=(8, 16),
                             sieve=True, predict=True, mesh_shape=(2, 2))),
                    (J, {})):
        svc = _svc(pkg, engine="dist2d", devices=P, lanes=32, width_ladder="off",
                   autostart=False, **kw)
        try:
            pend = [svc.submit(s) for s in sources]
            svc.start()
            recs = [_rec(p.result(300)) for p in pend]
        finally:
            svc.close()
        for rec in recs:
            rec.pop("wire_bytes")  # the exchanges differ, and so do their bytes
        outs.append(recs)
    assert outs[0] == outs[1]
    assert [r["distances"] for r in outs[0]] == [graphs[s].tobytes() for s in sources]


def test_dist2d_adapter_dedupes_padded_lanes(mesh4, graphs):
    """A batch padded by repeating a real source runs one loop per UNIQUE
    source (3 of 32 lanes), in both packages; lane 1's row is the oracle's."""
    from tpu_bfs.parallel.dist_bfs2d import Dist2DServeEngine as JServe
    from tpu_bfs.parallel.dist_bfs2d import make_mesh_2d

    from tpu_bfs_torch.parallel.dist_bfs2d import Dist2DServeEngine as TServe

    padded = np.full(32, 5, dtype=np.int64)
    padded[:3] = [0, 3, 5]
    jeng = JServe(J.g, make_mesh_2d(2, 2), lanes=32)
    spec = treg.EngineSpec(graph_key="g", engine="dist2d", devices=P, lanes=32)
    inner = mesh4.build(P, treg.build_mesh_engine, mesh4.share(T.g), spec)
    teng = TServe(T.g, lanes=32, engine=inner)
    counts = []
    for eng, local in ((jeng, jeng.engine), (teng, inner._local)):
        calls = []
        orig = local._loop

        def counting(*a, orig=orig, calls=calls, **k):
            calls.append(1)
            return orig(*a, **k)

        local._loop = counting
        res = eng.run(padded)
        counts.append((len(calls), res.distances_int32(1).tobytes(), int(res.ecc[1]),
                       res.reached.tolist(), res.edges_traversed.tolist()))
    assert counts[0] == counts[1]
    assert counts[0][0] == 3 and counts[0][1] == graphs[3].tobytes()


# --- the failover ladder ----------------------------------------------------


def _chaos(pkg, spec, sources, **kw):
    """Start a service, then arm ``spec`` and serve ``sources`` queued at
    once; the answers, the mesh counters and the process counters."""
    pkg.COUNTERS.reset()
    svc = _svc(pkg, autostart=False, **kw)
    svc.start()
    pkg.faults.arm_from_spec(spec)
    try:
        pend = [svc.submit(s) for s in sources]
        rs = [p.result(300) for p in pend]
        snap = _snap(svc)
    finally:
        pkg.faults.disarm()
        svc.close()
    c = pkg.COUNTERS.as_dict()
    return ([_rec(r) for r in rs], snap,
            {k: c[k] for k in ("mesh_faults", "mesh_degrades", "faults_injected")})


@pytest.mark.parametrize("case", [
    # A device loss on the serving fetch: 4 -> 2, every answer ok.
    ("seed=5:device_lost@fetch:n=1", dict(engine="wide", lanes=64), 4),
    # rank=3 follows the chip: it fires on the 4-rank mesh, not the 2-rank one.
    ("seed=7:device_lost@fetch@rank=3:n=8", dict(engine="wide", lanes=32), 1),
    # rank=1 is on every mesh: the 2D service walks 4 -> 2 -> 1 (wide).
    ("seed=9:device_lost@fetch@rank=1:n=8", dict(engine="dist2d", lanes=32), 1),
], ids=["device_lost", "rank_qualified", "to_floor"])
def test_mesh_fault_degrades_and_answers_as_in_jax(graphs, case):
    spec, kw, n = case
    sources = sorted(graphs)[:n]
    got = _chaos(T, spec, sources, devices=P, width_ladder="off", max_requeues=8, **kw)
    want = _chaos(J, spec, sources, devices=P, width_ladder="off", max_requeues=8, **kw)
    assert got == want
    recs, snap, counts = got
    for rec in recs:
        assert rec["status"] == "ok" and rec["distances"] == graphs[rec["source"]].tobytes()
    assert snap["devices"] == (1 if "rank=1" in spec else 2) and snap["mesh_degraded"]
    assert snap["mesh_faults"] == snap["mesh_degrades"] == counts["mesh_degrades"] >= 1


def test_resume_recompute_bounded_across_degraded_mesh(mesh4, graphs):
    """A device loss at chunk level 2 (cadence K=1) on the 2x2 engine leaves
    a level-2 snapshot; the 1x2 engine over the same graph resumes there:
    its first chunk starts at level 2, the chunks advance, the answer is the
    oracle's, one resume is counted and the snapshot is dropped. JAX's
    engines on its virtual devices walk the same levels."""
    from tpu_bfs.parallel.dist_bfs2d import Dist2DServeEngine as JServe
    from tpu_bfs.parallel.dist_bfs2d import make_mesh_2d

    from tpu_bfs_torch.parallel.dist_bfs2d import Dist2DServeEngine as TServe

    s = sorted(graphs)[2]
    exp = graphs[s]
    assert int(exp[exp != np.iinfo(np.int32).max].max()) >= 3

    def tbuild(devices, shape):
        spec = treg.EngineSpec(graph_key="g", engine="dist2d", devices=devices, lanes=32,
                               mesh_shape=shape)
        mesh4.ensure_2d(*shape)
        return mesh4.build(devices, treg.build_mesh_engine, mesh4.share(T.g), spec)

    outs = []
    for pkg in (T, J):
        if pkg is J:
            eng4 = JServe(J.g, make_mesh_2d(2, 2), lanes=4, resume_levels=1)
        else:
            eng4 = TServe(T.g, lanes=4, resume_levels=1, engine=tbuild(4, (2, 2)))
        pkg.faults.arm_from_spec("device_lost@fetch@level=2:n=1")
        with pytest.raises(RuntimeError, match="DATA_LOSS"):
            eng4.run(np.array([s], dtype=np.int64))
        pkg.faults.disarm()
        cache = pkg.res.cache_for_graph(pkg.g)
        snap_level = cache.get(s).level
        pkg.COUNTERS.reset()
        starts = []
        if pkg is J:
            eng2 = JServe(J.g, make_mesh_2d(1, 2), lanes=4, resume_levels=1)
            orig = eng2.engine._loop

            def spy(*args, orig=orig):
                starts.append(int(np.asarray(args[7])))
                return orig(*args)

            eng2.engine._loop = spy
        else:
            inner = tbuild(2, (1, 2))
            eng2 = TServe(T.g, lanes=4, resume_levels=1, engine=inner)
            orig = inner._local._advance_loop

            def spy(f0, vis0, d0, level0, cap, orig=orig, **kw):
                starts.append(int(level0))
                return orig(f0, vis0, d0, level0, cap, **kw)

            inner._local._advance_loop = spy
        res = eng2.run(np.array([s], dtype=np.int64))
        outs.append((snap_level, starts, res.distances_int32(0).tobytes(),
                     pkg.COUNTERS.as_dict()["query_resumes"], cache.get(s)))
    assert outs[0] == outs[1]
    snap_level, starts, row, resumes, left = outs[0]
    assert snap_level == 2 and starts[0] == 2 and starts == sorted(starts)
    assert row == exp.tobytes() and resumes == 1 and left is None


def test_resume_snapshot_deeper_than_cap_is_not_adopted(mesh4, graphs):
    """A snapshot past the call's max_levels cap starts over, in both."""
    from tpu_bfs.parallel.dist_bfs2d import Dist2DServeEngine as JServe
    from tpu_bfs.parallel.dist_bfs2d import make_mesh_2d

    from tpu_bfs_torch.parallel.dist_bfs2d import Dist2DServeEngine as TServe

    spec = treg.EngineSpec(graph_key="g", engine="dist2d", devices=P, lanes=32)
    tinner = mesh4.build(P, treg.build_mesh_engine, mesh4.share(T.g), spec)
    rows = []
    for pkg, eng in ((T, TServe(T.g, lanes=4, resume_levels=1, engine=tinner)),
                     (J, JServe(J.g, make_mesh_2d(2, 2), lanes=4, resume_levels=1))):
        cache = pkg.res.cache_for_graph(pkg.g)
        deep = pkg.ckpt.initial_checkpoint(pkg.g.num_vertices, 3)
        deep.level = 6
        cache.put(3, deep)
        try:
            rows.append(eng.run(np.array([3], dtype=np.int64), max_levels=2)
                        .distances_int32(0).tobytes())
        finally:
            cache.drop(3)
    assert rows[0] == rows[1]
    d = np.frombuffer(rows[0], np.int32)
    assert int(d[d != np.iinfo(np.int32).max].max()) <= 2


def test_shed_path_drops_resume_snapshots(graphs):
    """A query shed at the requeue budget takes its snapshot with it."""
    outs = []
    for pkg, query in ((T, TQuery), (J, JQuery)):
        svc = _svc(pkg, engine="dist2d", devices=P, lanes=32, width_ladder="off",
                   autostart=False, resume_levels=2, max_requeues=0)
        cache = pkg.res.cache_for_graph(pkg.g)
        try:
            q = query(5)
            cache.put(5, pkg.ckpt.initial_checkpoint(pkg.g.num_vertices, 5))
            live = svc._shed_over_budget([q], 32, "mesh-fault")
            outs.append((live, q.done(), q.result(0).error, cache.get(5)))
        finally:
            svc.close()
    assert outs[0] == outs[1] and outs[0][1] and outs[0][3] is None


def test_probe_gated_restore_equals_jax(graphs):
    """Degraded by a device loss, the service refuses to restore while the
    probe reports the full mesh dead, then climbs back once it answers; the
    background prober's pass promotes as ``mesh_restore`` does."""
    from tpu_bfs.resilience.probe import MeshHealthProbe as JProbe

    from tpu_bfs_torch.resilience.probe import MeshHealthProbe as TProbe

    s = sorted(graphs)[0]
    outs = []
    for pkg, probe_cls in ((T, TProbe), (J, JProbe)):
        svc = _svc(pkg, engine="wide", devices=P, lanes=32, width_ladder="off",
                   autostart=False)
        svc.start()
        try:
            pkg.faults.arm_from_spec("seed=5:device_lost@fetch:n=1")
            steps = [svc.query(s, timeout=300).devices, svc.statsz()["devices"]]
            pkg.faults.arm_from_spec("device_lost@probe:n=8")
            steps += [svc.mesh_restore(), svc.statsz()["devices"]]
            pkg.faults.disarm()
            steps += [svc.mesh_restore(), _rec(svc.query(s, timeout=300)),
                      svc.statsz()["mesh_degraded"]]
            # Degrade again, then let the background prober's pass promote.
            pkg.faults.arm_from_spec("seed=5:device_lost@fetch:n=1")
            steps.append(svc.query(s, timeout=300).devices)
            pkg.faults.disarm()
            probe = probe_cls(P, interval_s=3600.0,
                              current=lambda svc=svc: svc.statsz()["devices"],
                              on_healthy=svc._on_mesh_healthy)
            steps += [probe.probe_once(), svc.statsz()["devices"], probe.probe_once()]
        finally:
            pkg.faults.disarm()
            svc.close()
        outs.append(steps)
    assert outs[0] == outs[1]
    assert outs[0][:5] == [2, 2, False, 2, True] and outs[0][5]["devices"] == P
    assert outs[0][7:] == [2, P, P, None]


@pytest.mark.parametrize("case", [
    # An OOM at the 512 mesh rung (skip=1 spares the warm-up) halves onto
    # the mesh grid (floor 32 * 4 = 128): 256 answers.
    (512, "seed=7:oom@rung=512:n=1:skip=1"),
    # At the mesh floor there is no narrower width: an explicit error.
    (128, "seed=7:oom@rung=128:n=2:skip=1"),
], ids=["halves", "floor"])
def test_mesh_oom_grid_equals_jax(graphs, case):
    lanes, spec = case
    outs = []
    for pkg in (T, J):
        pkg.faults.arm_from_spec(spec)
        try:
            svc = _svc(pkg, engine="wide", devices=P, lanes=lanes, width_ladder="off")
            try:
                r = svc.query(sorted(graphs)[0], timeout=300)
                rec = _rec(r)
                rec["error"] = None if r.error is None else r.error.split(":")[0]
                outs.append((rec, _snap(svc), svc.width_ladder))
            finally:
                svc.close()
        finally:
            pkg.faults.disarm()
    assert outs[0] == outs[1]
    rec, snap, ladder = outs[0]
    if lanes == 512:
        assert rec["dispatched_lanes"] == 256 and ladder == [256] and snap["oom_degrades"] == 1
    else:
        assert rec["status"] == "error" and ladder == [128]


def test_mesh_drain_shutdown_and_heartbeat(graphs):
    """A drained mesh service sheds new queries, a closed one too; the
    heartbeat answers over every rung and a probe fault fails it once."""
    from tpu_bfs.resilience.probe import mesh_heartbeat as jbeat

    from tpu_bfs_torch.resilience.probe import mesh_heartbeat as tbeat

    outs = []
    for pkg, beat in ((T, tbeat), (J, jbeat)):
        svc = _svc(pkg, engine="wide", devices=P, lanes=64, width_ladder="off")
        steps = [svc.query(5, timeout=300).ok]
        svc.drain()
        steps.append(svc.submit(3).result(10.0).status)
        svc.close()
        steps.append(svc.submit(3).result(10.0).status)
        steps += [beat(d) > 0 for d in (P, 2, 1)]
        pkg.faults.arm_from_spec("device_lost@probe:n=1")
        with pytest.raises(RuntimeError, match="DATA_LOSS"):
            beat(P)
        pkg.faults.disarm()
        steps.append(beat(P) > 0)
        outs.append(steps)
    assert outs[0] == outs[1] == [True, "rejected", "rejected", True, True, True, True]


def test_concurrent_mesh_faults_degrade_at_most_once_a_shape(graphs):
    """Two in-flight batches meeting the same dead mesh degrade it one rung
    each at most, never twice for one observed shape; every answer is
    right. (Batch composition depends on timing, so only the bounds are
    compared with JAX's.) Whether the second fault meets the mesh before
    or after the first degrade is timing too: before, it is counted and
    absorbed (degrades < faults), so the check is that every degrade moved
    one rung from the shape it saw (devices = P >> degrades), which a
    second degrade of one observed shape breaks. JAX's test asserts
    degrades == faults and fails when the faults meet one shape (ROADMAP
    Queue 3)."""
    svc = _svc(T, engine="wide", devices=P, lanes=32, width_ladder="off",
               autostart=False, linger_ms=1.0)
    svc.start()
    tfaults.arm_from_spec("seed=5:device_lost@fetch:n=2")
    done = []
    try:
        threads = [threading.Thread(target=lambda s=s: done.append(svc.query(s, timeout=300)))
                   for s in sorted(graphs)[:6]]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        snap = _snap(svc)
        # A fault seen on the full mesh after it moved is absorbed.
        stale = svc._degrade_mesh(P, RuntimeError("DATA_LOSS: a late batch"))
        late = _snap(svc)
    finally:
        tfaults.disarm()
        svc.close()
    assert len(done) == 6 and all(r.ok for r in done)
    for r in done:
        assert r.distances.tobytes() == graphs[r.source].tobytes()
    assert 1 <= snap["mesh_degrades"] <= snap["mesh_faults"] <= 2
    assert snap["devices"] == P >> snap["mesh_degrades"]
    assert stale and late == snap


@pytest.mark.parametrize("engine,lanes", [("wide", 64), ("dist2d", 32)])
def test_every_kind_on_the_mesh_equals_jax(mesh4, engine, lanes):
    """Each kind a mesh service serves (sssp, cc, k-hop and p2p over the
    wide engine; k-hop over the 2D adapter) answers as JAX's does."""
    jg = jgen.rmat_graph(8, 8, seed=12, weights=5)
    tg = tgen.rmat_graph(8, 8, seed=12, weights=5)
    src = int(np.flatnonzero(tg.degrees > 0)[1])
    asks = [("bfs", {}), ("sssp", {}), ("cc", {}), ("khop", {"k": 2}),
            ("p2p", {"target": int(np.flatnonzero(tg.degrees > 0)[7])})]
    outs = []
    for pkg, g in ((T, tg), (J, jg)):
        svc = pkg.Service(g, engine=engine, devices=P, lanes=lanes, width_ladder="off",
                          linger_ms=1.0, **pkg.kw)
        try:
            got = [svc.kinds]
            for kind, kw in asks:
                if kind in svc.kinds:
                    r = svc.query(src, kind=kind, timeout=300, **kw)
                    got.append((kind, _rec(r), r.extras))
            outs.append(got)
        finally:
            svc.close()
    assert outs[0] == outs[1]
    assert all(rec["status"] == "ok" for _, rec, _ in outs[0][1:])


def test_adapter_devices_and_fault_sites_on_a_mesh_equal_jax(mesh4):
    """The reference's kind adapters carry no ``mesh``, so a k-hop or cc
    batch on a mesh reports devices 1 in both packages (ROADMAP Queue 3).
    The cc adapter runs on rank 0 over the replicated base, as in JAX: a
    ``device_lost`` at ``dispatch`` fires in its first sweep, inside the
    engine's build and warm-up, and degrades the mesh 4 -> 2 in both."""
    jg = jgen.rmat_graph(8, 8, seed=12)
    tg = tgen.rmat_graph(8, 8, seed=12)
    src = int(np.flatnonzero(tg.degrees > 0)[1])
    outs = []
    for pkg, g in ((T, tg), (J, jg)):
        svc = pkg.Service(g, engine="wide", devices=P, lanes=64, width_ladder="off",
                          linger_ms=1.0, kinds=("bfs", "cc", "khop"), **pkg.kw)
        try:
            devices = [svc.query(src, kind=k, timeout=300, **kw).devices
                       for k, kw in (("bfs", {}), ("khop", {"k": 2}))]
            pkg.faults.arm_from_spec("device_lost@dispatch:n=1")
            r = svc.query(src, kind="cc", timeout=300)
            fired = pkg.faults.ACTIVE.counts().get("device_lost", 0)
            pkg.faults.disarm()
            snap = svc.statsz()
            outs.append((devices, _rec(r), r.extras, fired,
                         {k: snap[k] for k in ("retries", "mesh_faults", "mesh_degrades",
                                               "devices")}))
        finally:
            svc.close()
    assert outs[0] == outs[1]
    devices, rec, _, fired, snap = outs[0]
    assert devices == [P, 1] and rec["status"] == "ok" and rec["devices"] == 1
    assert fired == 1 and snap == {"retries": 0, "mesh_faults": 1, "mesh_degrades": 1,
                                   "devices": 2}


def test_command_stream_orders_concurrent_callers(mesh4, graphs):
    """More threads than cores issuing mesh commands at once (heartbeats on
    two rungs and served queries), with a short switch interval: every
    heartbeat sums its rung's ranks and every answer is the oracle's, so no
    two callers' collectives interleaved on the ranks."""
    import sys

    svc = _svc(T, engine="wide", devices=P, lanes=32, width_ladder="off", linger_ms=0.5)
    sums, answers, errs = [], [], []

    def beats(d):
        try:
            sums.extend((d, mesh4.heartbeat(d)) for _ in range(10))
        except Exception as exc:  # noqa: BLE001 — asserted below
            errs.append(exc)

    def queries(s):
        try:
            answers.append(svc.query(s, timeout=120))
        except Exception as exc:  # noqa: BLE001 — asserted below
            errs.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = ([threading.Thread(target=beats, args=(d,)) for d in (P, 2) * 6]
                   + [threading.Thread(target=queries, args=(s,)) for s in sorted(graphs)])
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        svc.close()
    assert not errs
    assert len(sums) == 120 and all(d == got for d, got in sums)
    assert len(answers) == len(graphs)
    for r in answers:
        assert r.ok and r.distances.tobytes() == graphs[r.source].tobytes()


def test_failed_follower_degrades_the_service_instead_of_hanging(mesh4, graphs):
    """A command that fails on one follower alone ends that rank; its peers'
    collectives fail at once, rank 0 stops the rung and raises DATA_LOSS,
    and the service degrades onto the single-device floor and answers every
    query right, long before the group's timeout. It ends the module's
    mesh, so it stays the file's last test."""
    import torch_mesh_cases as cases

    srcs = sorted(graphs)[:3]
    svc = _svc(T, engine="wide", devices=P, lanes=32, width_ladder="off", linger_ms=1.0)
    try:
        first = svc.query(srcs[0], timeout=120)
        mesh4.build(P, cases.fail_dispatch_on_rank, P - 1)
        t0 = time.monotonic()
        answers = [svc.query(s, timeout=120) for s in srcs]
        took = time.monotonic() - t0
        snap = _snap(svc)
    finally:
        svc.close()
    assert first.ok and first.devices == P
    for r in answers:
        assert r.ok and r.devices == 1
        assert r.distances.tobytes() == graphs[r.source].tobytes()
    assert snap["devices"] == 1 and snap["mesh_faults"] >= 1 and snap["errors"] == 0
    assert took < 60
    assert not any(p.is_alive() for p in mesh4._procs)
    with pytest.raises(RuntimeError, match="DATA_LOSS"):
        mesh4.heartbeat(2)
