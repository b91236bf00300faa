"""The port's serve tier under an armed fault schedule, against the JAX
package's.

One spec string arms both packages (``tpu_bfs.faults`` and
``tpu_bfs_torch.faults``); both services then serve the same queries, and
every query's status and error text (the package tag aside), the recovery
``COUNTERS`` of both packages, the fired-fault counts and the serve
counters must be equal: transient retry, engine-build retry, OOM degrade
down to the floor, the requeue budget, the circuit breaker opening and
half-opening, deadlines, shedding, draining and shutdown.
"""

import time

import numpy as np
import pytest

from tpu_bfs import faults as jfaults
from tpu_bfs.graph.generate import random_graph as jrandom
from tpu_bfs.serve import BfsService as JService
from tpu_bfs.serve import EngineRegistry as JRegistry
from tpu_bfs.utils.recovery import COUNTERS as JCOUNTERS

from tpu_bfs_torch import faults as tfaults
from tpu_bfs_torch.graph.generate import random_graph as trandom
from tpu_bfs_torch.serve import BfsService as TService
from tpu_bfs_torch.serve import EngineRegistry as TRegistry
from tpu_bfs_torch.utils.recovery import COUNTERS as TCOUNTERS

pytestmark = [pytest.mark.serve, pytest.mark.chaos]

KEY = "serve-faults-random96"
PKGS = {
    "torch": (TService, TRegistry, tfaults, TCOUNTERS, trandom),
    "jax": (JService, JRegistry, jfaults, JCOUNTERS, jrandom),
}
SNAP = ("completed", "batches", "rejected", "expired", "errors", "shutdown",
        "retries", "oom_degrades", "requeued", "requeue_shed", "routing",
        "breaker_opens", "lanes", "ladder", "faults")


@pytest.fixture(autouse=True)
def _disarmed():
    for _, _, faults, counters, _ in PKGS.values():
        faults.disarm()
        counters.reset()
    yield
    for _, _, faults, _, _ in PKGS.values():
        faults.disarm()


def _registry(pkg):
    _, reg_cls, _, _, gen = PKGS[pkg]
    reg = reg_cls(capacity=8, **({"device": "cpu"} if pkg == "torch" else {}))
    reg.add_graph(KEY, gen(96, 480, seed=3))
    return reg


def _canon(r) -> tuple:
    err = None if r.error is None else r.error.replace("tpu_bfs_torch.", "tpu_bfs.")
    d = None if r.distances is None else np.asarray(r.distances, np.int32).tobytes()
    return (r.id, r.source, r.status, err, r.levels, r.reached, r.batch_lanes,
            r.dispatched_lanes, d)


def _scenario(pkg, spec, drive, *, reg=None, **kw):
    svc_cls, _, faults, counters, _ = PKGS[pkg]
    if pkg == "torch":
        kw["device"] = "cpu"
    if spec:
        faults.arm_from_spec(spec)
    try:
        svc = svc_cls(KEY, registry=reg or _registry(pkg), autostart=False,
                      log=None, **kw)
        try:
            results, marks = drive(svc)
            snap = svc.statsz()
        finally:
            svc.close()
    finally:
        faults.disarm()
    return ([_canon(r) for r in results], marks,
            {k: snap.get(k) for k in SNAP}, counters.as_dict())


def _both(spec, drive, **kw):
    got = _scenario("torch", spec, drive, **kw)
    for _, _, _, counters, _ in PKGS.values():
        counters.reset()
    want = _scenario("jax", spec, drive, **kw)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert got[3] == want[3]
    return got


def _queued(sources, **qkw):
    def drive(svc):
        pend = [svc.submit(int(s), id=f"q{i}", **qkw) for i, s in enumerate(sources)]
        svc.start()
        return [p.result(120) for p in pend], None
    return drive


def test_transient_retry_and_slow_extract_equal_jax():
    res, _, snap, counters = _both(
        "seed=7:transient@serve_batch:n=2,slow_extract:ms=5:n=4,"
        "transient@engine_build:n=1",
        _queued(range(20)), lanes=32, width_ladder="off")
    assert all(r[2] == "ok" for r in res)
    # slow_extract fires at each fetch: the warm-up batch's and the one batch.
    assert counters["transient_retries"] == 3 and counters["faults_injected"] == 5
    assert snap["faults"] == {"transient": 3, "slow_extract": 2}


def test_oom_degrades_to_the_floor_equal_jax():
    res, _, snap, counters = _both(
        "oom@serve_batch:n=3", _queued(range(40)), lanes=128,
        width_ladder="auto")
    statuses = [r[2] for r in res]
    assert statuses.count("error") == 32 and statuses.count("ok") == 8
    assert "out of memory at the minimum lane count (32)" in res[0][3]
    assert snap["oom_degrades"] == 2 and snap["ladder"] == [32]
    assert counters["oom_degrades"] == 2 and counters["faults_injected"] == 3


def test_requeue_budget_sheds_equal_jax():
    res, _, snap, counters = _both(
        "oom@serve_batch:n=1", _queued(range(10)), lanes=64,
        width_ladder="auto", max_requeues=0)
    assert all(r[2] == "error" and "requeue budget exhausted" in r[3] for r in res)
    assert counters["requeue_sheds"] == 10 and snap["requeue_shed"] == 10


def test_breaker_opens_and_half_opens_equal_jax():
    def drive(svc):
        svc.start()
        marks, out = [], []
        out.append(svc.submit(1, id="a").result(120))  # 3 transients: 32 opens
        marks.append(svc.statsz()["breaker_open"])
        out.append(svc.submit(2, id="b").result(120))  # routed around it, to 128
        time.sleep(1.3)  # past the cooldown: one half-open probe at 32
        out.append(svc.submit(3, id="c").result(120))
        marks.append(svc.statsz()["breaker_open"])
        return out, [[list(k) for k in m] for m in marks]

    res, marks, snap, counters = _both(
        "transient@serve_batch:n=3", drive, lanes=128, width_ladder="auto",
        max_retries=2, breaker_threshold=1, breaker_cooldown_ms=1000)
    assert [r[2] for r in res] == ["error", "ok", "ok"]
    assert [r[7] for r in res] == [None, 128, 32]
    assert marks == [[[32, 1]], []]
    assert snap["breaker_opens"] == 1 and counters["breaker_opens"] == 1


def test_deadline_shed_drain_and_shutdown_equal_jax():
    def drive(svc):
        a = svc.submit(1, id="late", deadline_ms=1)
        b = svc.submit(2, id="fine")
        c = svc.submit(3, id="full")  # over queue_cap: shed now
        time.sleep(0.05)
        svc.start()
        first = [a.result(60), b.result(60), c.result(60)]
        svc.drain()
        d = svc.submit(4, id="drained")
        return first + [d.result(60)], None

    res, _, snap, _ = _both(None, drive, lanes=32, width_ladder="off", queue_cap=2)
    assert [r[2] for r in res] == ["deadline_exceeded", "ok", "rejected", "rejected"]
    assert res[3][3] == "service draining" and res[2][3] == "queue full"

    def never_started(svc):
        pend = [svc.submit(s, id=f"s{s}") for s in range(3)]
        svc.close()
        return [p.result(1) for p in pend], None

    res, _, snap, _ = _both(None, never_started, lanes=32, width_ladder="off")
    assert [r[2] for r in res] == ["shutdown"] * 3 and snap["shutdown"] == 3
