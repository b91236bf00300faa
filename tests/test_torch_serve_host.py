"""The port's host-only serve pieces against the JAX package's.

The width ladder and its bounds, the 2D mesh factorization, the admission
queue, pending queries, single-flight and the serve metrics (snapshot,
histograms, Prometheus text), the fault spec grammar and schedule, and the
failure classifier: the same inputs and operation sequences go through
``tpu_bfs.serve`` / ``tpu_bfs.faults`` / ``tpu_bfs.utils.recovery`` and
their ``tpu_bfs_torch`` ports, and every result is compared exactly. The
classifier is also pinned on what PyTorch and the port's kernels raise.
No engines, no wall-clock assertions.
"""

import itertools
import random

import pytest
import torch

from tpu_bfs import faults as jfaults
from tpu_bfs.serve import frontend as jfront
from tpu_bfs.serve import metrics as jmetrics
from tpu_bfs.serve import registry as jregistry
from tpu_bfs.serve import scheduler as jsched
from tpu_bfs.utils import recovery as jrec

from tpu_bfs_torch import faults as tfaults
from tpu_bfs_torch.serve import frontend as tfront
from tpu_bfs_torch.serve import metrics as tmetrics
from tpu_bfs_torch.serve import registry as tregistry
from tpu_bfs_torch.serve import scheduler as tsched
from tpu_bfs_torch.utils import recovery as trec

from torch_threads import cap_torch_threads

cap_torch_threads()

pytestmark = pytest.mark.serve


def _outcome(fn, *args, **kw):
    """A call's value, or its exception's type and text."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as exc:  # noqa: BLE001 — compared across packages
        return ("raise", type(exc).__name__, str(exc))


# --- (a) the width ladder ---------------------------------------------------

LADDER_LANES = [32, 64, 96, 128, 512, 1024, 4096, 8192, 12288]
LADDERS = ["auto", "off", None, "32,128", "64 512", [32], [4096, 8192], "33",
           [8192, 4096, 12288], "0"]


@pytest.mark.parametrize("engine", ["wide", "hybrid", "packed"])
def test_width_ladder_and_bounds_equal_jax(engine):
    for lanes in LADDER_LANES:
        assert tfront.ladder_bounds(lanes, engine=engine) == \
            jfront.ladder_bounds(lanes, devices=1, engine=engine)
        for ladder in LADDERS:
            want = _outcome(jfront.build_width_ladder, lanes, ladder, engine=engine)
            got = _outcome(tfront.build_width_ladder, lanes, ladder, engine=engine)
            assert got == want, (lanes, ladder, engine)


def test_mesh_shape_2d_and_hybrid_quantum_equal_jax():
    assert tregistry.HYBRID_LANE_QUANTUM == jregistry.HYBRID_LANE_QUANTUM
    assert tregistry.DEFAULT_PLANES == jregistry.DEFAULT_PLANES
    for devices in range(1, 17):
        for shape in [(), (1, devices), (devices, 1), (2, devices // 2), (3, 3)]:
            assert _outcome(tregistry.mesh_shape_2d, devices, shape) == \
                _outcome(jregistry.mesh_shape_2d, devices, shape)


# --- (b) scheduler and metrics ----------------------------------------------


def _queue_trace(sched):
    """One fixed operation sequence on the admission queue, pending queries
    and single-flight; the observable trace."""
    out = []
    aq = sched.AdmissionQueue(cap=5)
    qs = [sched.PendingQuery(s, id=f"q{i}", now=100.0 + i, kind=kind, k=k,
                             target=t, deadline=d)
          for i, (s, kind, k, t, d) in enumerate([
              (3, "bfs", None, None, None), (4, "khop", 2, None, 101.5),
              (5, "bfs", None, None, None), (6, "khop", 3, None, None),
              (7, "p2p", None, 9, None), (8, "bfs", None, None, 99.0),
              (9, "khop", 2, None, None)])]
    out.append([aq.offer(q) for q in qs])
    out.append(aq.depth())
    out.append([(q.id, q.batch_key, q.expired(101.0), q.expired(102.0)) for q in qs])
    b1 = aq.next_batch(2, 0.0)
    out.append([q.id for q in b1])
    b2 = aq.next_batch(4, 0.0)
    out.append([q.id for q in b2])
    aq.requeue(b1)
    out.append(aq.depth())
    out.append([q.id for q in aq.next_batch(8, 0.0)])
    aq.stop()
    out.append((aq.stopped, [q.id for q in aq.next_batch(8, 0.0)], aq.offer(qs[0])))
    # Exactly-once resolution, callbacks, single-flight fan-out.
    idx = sched.InflightIndex()
    lead = sched.PendingQuery(1, id="L", now=0.0, want_distances=False)
    foll = sched.PendingQuery(1, id="F", now=0.0, want_distances=False)
    other = sched.PendingQuery(1, id="O", now=0.0)
    seen = []
    out.append((idx.attach(lead), idx.attach(foll) is lead, idx.attach(other),
                idx.depth()))
    foll.add_done_callback(lambda q: seen.append(q.id))
    r = sched.QueryResult(id="L", source=1, status=sched.STATUS_OK, levels=4,
                          reached=7, batch_lanes=3, dispatched_lanes=32)
    out.append((lead.resolve(r), lead.resolve(r), idx.depth()))
    fr = foll.result(0)
    out.append((seen, fr.id, fr.status, fr.levels, fr.reached, fr.batch_lanes,
                fr.dispatched_lanes, sched.dedupe_key(foll)))
    other.resolve_status(sched.STATUS_REJECTED, error="queue full")
    ro = other.result(0)
    out.append((ro.status, ro.error, ro.ok, idx.depth()))
    out.append((sched.STATUS_OK, sched.STATUS_REJECTED, sched.STATUS_EXPIRED,
                sched.STATUS_ERROR, sched.STATUS_SHUTDOWN))
    return out


def test_scheduler_operation_trace_equals_jax():
    assert _queue_trace(tsched) == _queue_trace(jsched)


def _metrics_trace(mod):
    t = [0.0]
    m = mod.ServeMetrics(now=lambda: t[0])
    rng = random.Random(5)
    snaps = []
    for step in range(40):
        t[0] += rng.choice([0.25, 1.0, 7.5, 31.0])
        op = rng.randrange(12)
        if op < 5:
            n = rng.randrange(1, 33)
            width = rng.choice([32, 128, 512])
            m.record_batch(n, width, [rng.uniform(0.001, 5000.0) for _ in range(n)],
                           extract_ms=rng.choice([None, rng.uniform(0.01, 90.0)]))
        elif op == 5:
            m.record_rejected()
            m.record_expired(rng.randrange(1, 3))
        elif op == 6:
            m.record_errors(2)
            m.record_shutdown()
            m.record_retry()
        elif op == 7:
            m.record_oom_degrade(requeued=rng.randrange(9))
            m.record_watchdog_trip()
            m.record_requeue_shed(1)
        elif op == 8:
            m.record_cache_hit(rng.uniform(0.01, 1.0), landmark=rng.random() < 0.5)
            m.record_cache_miss()
            m.record_cache_eviction(2)
            m.set_cache_bytes(rng.randrange(1 << 20))
        elif op == 9:
            m.record_single_flight()
            m.record_follower_completed()
            m.record_landmark(exact=rng.random() < 0.5, informative=rng.random() < 0.5)
        elif op == 10:
            snaps.append(m.statsz_line(queue_depth=step, lanes=512,
                                       extra={"devices": 1}))
        snap = m.snapshot(queue_depth=step, lanes=128)
        snaps.append(snap)
        if step % 9 == 0:
            snaps.append(m.prometheus_text(snapshot=snap))
            snaps.append({k: (h.counts, h.count, h.total, h.cumulative_buckets())
                          for k, h in m.histograms().items()})
    return snaps


def test_metrics_snapshots_and_prometheus_text_equal_jax():
    got, want = _metrics_trace(tmetrics), _metrics_trace(jmetrics)
    assert len(got) == len(want) > 40
    for a, b in zip(got, want):
        assert a == b


def test_log2_histogram_equals_jax():
    rng = random.Random(1)
    vals = [rng.lognormvariate(0, 4) for _ in range(3000)] + [0.0, -1.0, 2.0 ** 30]
    th, jh = tmetrics.Log2Histogram(), jmetrics.Log2Histogram()
    th.add_many(vals)
    jh.add_many(vals)
    for q in (0, 1, 25, 50, 90, 99, 99.9, 100):
        assert th.percentile(q) == jh.percentile(q)
    assert th.cumulative_buckets() == jh.cumulative_buckets()
    assert (th.counts, th.count, th.total, th.vmin, th.vmax) == \
        (jh.counts, jh.count, jh.total, jh.vmin, jh.vmax)
    assert [th.bounds(i) for i in range(th.NBUCKETS)] == \
        [jh.bounds(i) for i in range(jh.NBUCKETS)]


# --- (e, the grammar) fault specs ------------------------------------------

SPEC_CORPUS = [
    "seed=7:transient@serve_batch:n=2,slow_extract:ms=50:n=4",
    "seed=7:transient@dispatch:p=0.05,oom@rung=512:n=2,slow_extract:ms=200,corrupt_ckpt:n=1",
    "seed=3:device_lost@rank=3:n=1,backend_restart@probe:n=1",
    "oom@fetch@rung=64:n=3:skip=2",
    "corrupt_result:n=2,stale_cache:p=0.5,corrupt_cache_entry",
    "transient@engine_build:n=1,collective_hang:n=1,slow:ms=1.5:p=0.25",
    "torn_flip,corrupt_overlay:n=2,compaction_crash@compact",
    "seed=11:transient@sssp_fetch:n=2,oom@sssp_dispatch",
    "",
    "mystery@dispatch",
    "transient@nowhere",
    "transient:q=3",
    "transient:p=2.0",
    "slow",
    "oom@rung=wat",
    "seed=x:transient",
    "transient@fetch@dispatch",
    "transient:n",
    ",,",
]


def _spec_view(mod, spec):
    out = _outcome(mod.FaultSchedule.from_spec, spec)
    if out[0] != "ok":
        return out
    s = out[1]
    return ("ok", s.seed, s.to_spec(), [
        (r.kind, r.site, r.qual, r.p, r.n, r.ms, r.skip, r.remaining)
        for r in s.rules])


@pytest.mark.parametrize("spec", SPEC_CORPUS)
def test_fault_spec_parses_equal_to_jax(spec):
    assert _spec_view(tfaults, spec) == _spec_view(jfaults, spec)


def test_fault_tables_equal_jax():
    assert tfaults.SITES == jfaults.SITES
    assert tfaults.DEFAULT_SITE == jfaults.DEFAULT_SITE
    assert tfaults.KINDS == jfaults.KINDS
    assert tfaults.MESH_KINDS == jfaults.MESH_KINDS


def _firing_trace(mod, spec):
    """The schedule's firings over one fixed visit sequence: raised kinds
    (their message heads), take() results, counts and exhaustion."""
    s = mod.FaultSchedule.from_spec(spec)
    out = []
    visits = list(itertools.product(
        ["dispatch", "fetch", "serve_batch", "engine_build", "cache_lookup"],
        [32, 64, 512])) * 3
    for site, lanes in visits:
        try:
            s.hit(site, lanes=lanes, devices=1)
            out.append(None)
        except RuntimeError as exc:
            out.append(str(exc).split(" (site=")[0])
        out.append(s.take(site, "corrupt_result", lanes=lanes))
    out.append((s.counts(), s.exhausted(), [(e["site"], e["kind"], e["clause"])
                                            for e in s.events]))
    return out


@pytest.mark.parametrize("spec", [
    "seed=7:transient@serve_batch:n=2,oom@rung=64:n=2,corrupt_result@serve_batch:n=1",
    "seed=1:transient@fetch:p=0.4,oom@dispatch:p=0.3:skip=2",
    "seed=9:device_lost@rank=0:n=1,collective_hang@serve_batch:p=0.5,backend_restart:n=1",
])
def test_fault_schedule_fires_equal_to_jax(spec):
    trec.COUNTERS.reset()
    jrec.COUNTERS.reset()
    assert _firing_trace(tfaults, spec) == _firing_trace(jfaults, spec)
    assert trec.COUNTERS.as_dict() == jrec.COUNTERS.as_dict()
    assert trec.COUNTERS.faults_injected > 0


# --- (f) the recovery classifier --------------------------------------------


class JaxRuntimeError(RuntimeError):
    pass


def _classifier_corpus():
    oom = torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB. GPU 0 has a total "
        "capacity of 79.19 GiB of which 1.06 GiB is free.")
    return [
        oom,
        RuntimeError("CUDA error: an illegal memory access was encountered\n"
                     "CUDA kernel errors might be asynchronously reported"),
        RuntimeError("CUDA error: unspecified launch failure"),
        RuntimeError("CUDA error: device-side assert triggered"),
        RuntimeError("ell_expand: CUDA launch failed with cudaError_t 700"),
        RuntimeError("tile_spmm: CUDA launch failed with cudaError_t 719"),
        RuntimeError("INTERNAL: injected transient fault (site=dispatch)"),
        RuntimeError("RESOURCE_EXHAUSTED: injected out-of-memory fault"),
        RuntimeError("DEADLINE_EXCEEDED: dispatch watchdog"),
        RuntimeError("DATA_LOSS: a mesh participant disappeared"),
        RuntimeError("INTERNAL: Program hung (awaiting all-reduce)"),
        RuntimeError("UNAVAILABLE: slice health check failed"),
        JaxRuntimeError("INTERNAL: remote_compile: read body closed"),
        JaxRuntimeError("INTERNAL: Mosaic failed to compile TPU kernel"),
        RuntimeError("Connection reset by peer"),
        RuntimeError("traversal truncated at 31 levels; num_planes=5"),
        AssertionError("INTERNAL: remote_compile"),
        ValueError("UNAVAILABLE: source out of range"),
        RuntimeError("Invalid argument: INTERNAL: shape mismatch"),
        TimeoutError("UNAVAILABLE:"),
    ]


def test_classifier_equals_jax_on_one_corpus():
    for exc in _classifier_corpus():
        assert trec.is_oom_failure(exc) == jrec.is_oom_failure(exc), exc
        assert trec.is_transient_failure(exc) == jrec.is_transient_failure(exc), exc
        assert trec.is_mesh_fault(exc) == jrec.is_mesh_fault(exc), exc
    assert set(trec.COUNTERS.as_dict()) == set(jrec.COUNTERS.as_dict())


def test_torch_out_of_memory_classifies_as_oom_never_transient():
    exc = torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 20.00 MiB")
    assert isinstance(exc, RuntimeError)
    assert trec.is_oom_failure(exc)
    assert not trec.is_transient_failure(exc)


@pytest.mark.parametrize("msg", [
    "CUDA error: an illegal memory access was encountered",
    "CUDA error: unspecified launch failure",
    "CUDA error: device-side assert triggered",
    "CUDA error: an illegal instruction was encountered",
    "CUDA error: misaligned address",
    "INTERNAL: CUDA error: an illegal memory access was encountered",
])
def test_sticky_cuda_errors_are_neither_transient_nor_oom(msg):
    for exc in (RuntimeError(msg), torch.AcceleratorError(msg)
                if hasattr(torch, "AcceleratorError") else RuntimeError(msg)):
        assert not trec.is_transient_failure(exc)
        assert not trec.is_oom_failure(exc)


def test_kernel_launch_errors_are_deterministic():
    from tpu_bfs_torch.ops._build import check_launch

    with pytest.raises(RuntimeError) as info:
        check_launch(700, "ell_expand")
    assert not trec.is_transient_failure(info.value)
    assert not trec.is_oom_failure(info.value)
    check_launch(0, "ell_expand")  # launched: no raise


def test_injected_faults_classify_as_in_jax():
    s = tfaults.FaultSchedule.from_spec(
        "transient@serve_batch:n=1,oom@fetch:n=1,device_lost@dispatch:n=1")
    got = []
    for site in ("serve_batch", "fetch", "dispatch"):
        with pytest.raises(RuntimeError) as info:
            s.hit(site, lanes=32, devices=1)
        exc = info.value
        got.append((trec.is_transient_failure(exc), trec.is_oom_failure(exc),
                    trec.is_mesh_fault(exc)))
        assert "[tpu_bfs_torch.faults]" in str(exc)
    assert got == [(True, False, False), (False, True, False), (True, False, True)]
