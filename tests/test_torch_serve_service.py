"""The port's BfsService against the JAX package's, query for query.

Both services run on the same seeded graph with ``autostart=False``: the
queries are queued before ``start()``, so the batches they form are fixed,
and later queries go one at a time. Per query the status, distances,
reached, levels, kind extras, batch and dispatched lanes, edges and error
texts must be equal (latencies and device times are not compared). The
JAX services build their engines once per module (one shared registry a
package); the port runs on device="cpu", its kernels' plain twins.
"""

import time

import numpy as np
import pytest

from tpu_bfs.graph import generate as jgen
from tpu_bfs.serve import BfsService as JService
from tpu_bfs.serve import EngineRegistry as JRegistry

from tpu_bfs_torch.graph import generate as tgen
from tpu_bfs_torch.serve import BfsService as TService
from tpu_bfs_torch.serve import EngineRegistry as TRegistry

pytestmark = pytest.mark.serve

KEY = "serve-parity-rmat9"


@pytest.fixture(scope="module")
def regs():
    """One registry a package over the same weighted, undirected RMAT 9."""
    jreg, treg = JRegistry(capacity=16), TRegistry(capacity=16, device="cpu")
    jg = jgen.rmat_graph(9, 8, seed=12, weights=5)
    tg = tgen.rmat_graph(9, 8, seed=12, weights=5)
    jreg.add_graph(KEY, jg)
    treg.add_graph(KEY, tg)
    return jreg, treg, tg


def _canon(r) -> dict:
    d = None if r.distances is None else np.asarray(r.distances, np.int32).tobytes()
    return {
        "id": r.id, "source": r.source, "status": r.status, "kind": r.kind,
        "levels": r.levels, "reached": r.reached, "extras": r.extras,
        "batch_lanes": r.batch_lanes, "dispatched_lanes": r.dispatched_lanes,
        "devices": r.devices, "error": r.error, "distances": d,
    }


COUNTS = ("completed", "batches", "rejected", "expired", "errors", "shutdown",
          "retries", "padded_lanes_total", "routing", "fill_ratio", "cache_hits",
          "cache_misses", "single_flight_collapses", "landmark_exact",
          "landmark_bounded", "landmark_fallback", "lanes")


def _serve(cls, reg, before, after=(), **kw):
    """Queue ``before`` (submit kwargs) on a stopped service, start it,
    collect their results, then query ``after`` one at a time. Returns the
    canonical results and the statsz counters."""
    if cls is TService:
        kw["device"] = "cpu"
    svc = cls(KEY, registry=reg, autostart=False, **kw)
    try:
        # Explicit ids: auto ids count every query a package made in the process.
        pend = [svc.submit(**{"id": f"b{i}", **q}) for i, q in enumerate(before)]
        svc.start()
        out = [_canon(p.result(300)) for p in pend]
        _await_cache(svc, before)
        out += [_canon(svc.submit(**{"id": f"a{i}", **q}).result(300))
                for i, q in enumerate(after)]
        snap = svc.statsz()
    finally:
        svc.close()
    return out, {k: snap[k] for k in COUNTS} | {"ladder": snap["ladder"],
                                                "kinds": snap["kinds"]}


def _await_cache(svc, queries):
    """Wait until the answer cache holds every answer of ``queries``: the
    extraction worker fills it just after it resolves their batch."""
    if svc._cache is None:
        return
    keys = {(q.get("kind", "bfs"), q["source"], q.get("k"), q.get("target"),
             q.get("kind", "bfs") not in ("cc", "khop", "p2p")
             and q.get("want_distances", True) is not False) for q in queries}
    deadline = time.monotonic() + 60
    while len(svc._cache) < len(keys) and time.monotonic() < deadline:
        time.sleep(0.01)


def _both(regs, before, after=(), **kw):
    jreg, treg, _ = regs
    got = _serve(TService, treg, before, after, **kw)
    want = _serve(JService, jreg, before, after, **kw)
    assert len(got[0]) == len(want[0])
    for a, b in zip(got[0], want[0]):
        assert a == b
    assert got[1] == want[1]
    return got


def _sources(g, n, seed):
    return [int(s) for s in np.random.default_rng(seed).choice(g.num_vertices, n)]


def test_wide_ladder_distance_free_and_single_flight_equal_jax(regs):
    g = regs[2]
    src = _sources(g, 36, 1)
    before = [{"source": s, "id": f"a{i}", "want_distances": i % 3 != 0}
              for i, s in enumerate(src)]
    # Duplicates of in-flight queries collapse onto their leader.
    before += [{"source": src[0], "id": "dup0", "want_distances": False},
               {"source": src[1], "id": "dup1"}]
    after = [{"source": s, "want_distances": bool(i % 2)}
             for i, s in enumerate(src[:4])]
    res, snap = _both(regs, before, after, lanes=128, width_ladder="auto")
    assert snap["ladder"] == [32, 128] and snap["routing"] == {"32": 4, "128": 1}
    assert snap["single_flight_collapses"] == 2
    assert all(r["status"] == "ok" for r in res)
    assert sum(r["distances"] is None for r in res) > 10


def test_distances_off_by_default_with_overrides_equal_jax(regs):
    g = regs[2]
    before = [{"source": s, "want_distances": (True if i % 4 == 0 else None)}
              for i, s in enumerate(_sources(g, 20, 2))]
    res, _ = _both(regs, before, lanes=32, width_ladder="off", distances=False)
    assert [r["distances"] is not None for r in res] == [i % 4 == 0 for i in range(20)]


@pytest.mark.parametrize("engine,lanes,ladder", [("hybrid", 4096, "off"),
                                                 ("packed", 64, "auto")])
def test_hybrid_and_packed_engines_equal_jax(regs, engine, lanes, ladder):
    g = regs[2]
    src = _sources(g, 40, 3)
    before = [{"source": s, "want_distances": i % 5 != 1} for i, s in enumerate(src)]
    after = [{"source": s} for s in src[:2]]
    res, snap = _both(regs, before, after, engine=engine, lanes=lanes,
                      width_ladder=ladder, kinds=("bfs",))
    assert all(r["status"] == "ok" for r in res)
    assert snap["batches"] == 3  # 40 queued (one batch), then 2 alone


def test_every_kind_equal_jax(regs):
    g = regs[2]
    src = _sources(g, 40, 4)
    tgt = _sources(g, 40, 5)
    before = (
        [{"source": s, "kind": "bfs"} for s in src[:5]]
        + [{"source": s, "kind": "sssp"} for s in src[5:11]]
        + [{"source": s, "kind": "cc"} for s in src[11:15]]
        + [{"source": s, "kind": "khop", "k": 2} for s in src[15:19]]
        + [{"source": s, "kind": "khop", "k": 0} for s in src[19:21]]
        + [{"source": s, "kind": "p2p", "target": t}
           for s, t in zip(src[21:29], tgt[21:29])]
        + [{"source": src[29], "kind": "p2p", "target": src[29]},
           {"source": src[30], "kind": "sssp", "want_distances": False},
           {"source": 1, "kind": "mystery"},
           {"source": 1, "kind": "khop"},
           {"source": 1, "kind": "p2p"},
           {"source": 1, "kind": "p2p", "target": g.num_vertices},
           {"source": -1, "kind": "cc"},
           {"source": g.num_vertices + 3}]
    )
    after = [{"source": src[0], "kind": "khop", "k": 3},
             {"source": src[1], "kind": "p2p", "target": tgt[1]}]
    res, snap = _both(regs, before, after, lanes=32, width_ladder="off")
    assert snap["kinds"] == ["bfs", "sssp", "cc", "khop", "p2p"]
    kinds = {r["kind"] for r in res if r["status"] == "ok"}
    assert kinds == {"bfs", "sssp", "cc", "khop", "p2p"}
    assert sum(r["status"] == "error" for r in res) == 6


def test_answer_tier_equal_jax(regs):
    g = regs[2]
    src = _sources(g, 12, 6)
    tgt = _sources(g, 12, 7)
    before = ([{"source": s} for s in src[:6]]
              + [{"source": s, "kind": "p2p", "target": t}
                 for s, t in zip(src[6:], tgt[6:])])
    # Repeats hit the cache; fresh pairs go to the landmark columns (exact
    # answers resolve without a dispatch) or fall back to traversal.
    after = ([{"source": s} for s in src[:3]]
             + [{"source": s, "want_distances": False} for s in src[:2]]
             + [{"source": s, "kind": "p2p", "target": t}
                for s, t in zip(src[6:8], tgt[6:8])]
             + [{"source": s, "kind": "p2p", "target": t}
                for s, t in zip(_sources(g, 10, 8), _sources(g, 10, 9))])
    res, snap = _both(regs, before, after, lanes=32, width_ladder="off",
                      cache_bytes=1 << 20, landmarks=8, kinds=("bfs", "p2p"))
    hits = [r for r in res if (r["extras"] or {}).get("cache_hit")]
    assert len(hits) == 5 and all(r["batch_lanes"] == 0 for r in hits)
    assert snap["cache_hits"] == 5 and snap["cache_misses"] > 0
    assert snap["landmark_exact"] > 0
    assert any((r["extras"] or {}).get("landmark") for r in res)


# --- port-only behaviour ------------------------------------------------------


@pytest.mark.parametrize("kw", [
    {"devices": 2}, {"mesh_shape": (1, 2)}, {"exchange": "sparse"},
    {"wire_pack": True}, {"delta_bits": (8,)}, {"sieve": True},
    {"predict": True}, {"resume_levels": 2}, {"mesh_probe_interval_s": 1.0},
    {"audit_rate": 0.1}, {"audit_structural": True}, {"audit_checksum": True},
    {"audit_seed": 3}, {"dynamic": (8, 4)}, {"generation_dir": "g"},
    {"staleness_bound": 1}, {"aot_dir": "a"}, {"engine": "dist2d"},
])
def test_unported_arguments_raise_naming_their_roadmap_item(regs, kw):
    with pytest.raises(NotImplementedError, match=r"ROADMAP Queue 1 item [45]"):
        TService(KEY, registry=regs[1], autostart=False, device="cpu", **kw)


def test_pipeline_dispatches_the_next_batch_while_extracting(regs):
    """With a slow fetch, batch 2's dispatch starts before batch 1's fetch
    and extraction end (the obs spans), and every answer equals the wide
    engine's own batch."""
    from tpu_bfs_torch import faults, obs
    from tpu_bfs_torch.algorithms.msbfs_wide import WidePackedMsBfsEngine

    g = regs[2]
    src = _sources(g, 64, 10)
    svc = TService(KEY, registry=regs[1], lanes=32, width_ladder="off",
                   device="cpu", single_flight=False)
    rec = obs.arm()
    faults.arm_from_spec("slow@fetch:ms=400:n=1")
    try:
        pend = [svc.submit(s) for s in src]
        res = [p.result(120) for p in pend]
    finally:
        faults.disarm()
        obs.disarm()
        svc.close()
    ev = rec.snapshot()
    t = {(e["name"], e["ph"], e["args"].get("batch")): e["t"] for e in ev
         if e["cat"] == "serve.batch" and e["name"] in ("dispatch", "fetch")}
    b1, b2 = sorted({b for (_, _, b) in t if b is not None})[:2]
    assert t[("dispatch", "b", b2)] < t[("fetch", "e", b1)]
    eng = WidePackedMsBfsEngine(g, lanes=32, num_planes=8, device="cpu")
    for lo in (0, 32):
        direct = eng.run(np.asarray(src[lo:lo + 32]))
        for i in range(32):
            r = res[lo + i]
            assert r.ok and r.batch_lanes == 32
            np.testing.assert_array_equal(r.distances, direct.distances_int32(i))
            assert r.reached == int(direct.reached[i])


def test_watchdog_classifies_a_slow_dispatch_as_transient(regs):
    """The port's level loop runs in dispatch, so the watchdog guards it: a
    dispatch that outlives watchdog_ms trips, retries and still answers."""
    from tpu_bfs_torch import faults
    from tpu_bfs_torch.utils.recovery import COUNTERS

    COUNTERS.reset()
    svc = TService(KEY, registry=regs[1], lanes=32, width_ladder="off",
                   device="cpu", watchdog_ms=150)
    faults.arm_from_spec("slow@dispatch:ms=600:n=1")
    try:
        r = svc.query(5, timeout=120)
        snap = svc.statsz()
        # The abandoned dispatch runs on to its end; let it finish here.
        deadline = time.monotonic() + 60
        while svc._executor._abandoned and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        faults.disarm()
        svc.close()
    assert r.ok
    assert snap["watchdog_trips"] == 1 and snap["retries"] == 1
    assert COUNTERS.watchdog_trips == 1 and COUNTERS.transient_retries == 1
