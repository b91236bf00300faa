"""The port's per-level engine traces (``tpu_bfs_torch/obs/engine_trace.py``)
against the JAX package's (``tpu_bfs/obs/engine_trace.py``).

- The assemblers and ``trace_summary`` on the same recordings.
- ``last_run_trace`` and its summary of the packed engines (hybrid and
  wide, gated and not) after an armed run; the 512-lane packed engine
  records none in either package.
- ``DistBfsEngine`` and ``Dist2DBfsEngine`` on gloo groups against JAX's
  engines on its virtual devices: every exchange kind, the planner, a
  resumed chunk (``level0``) and a 100-level path (the 64-slot clamp);
  with ``DistWideMsBfsEngine`` armed on the same ranks.
- The disarmed guard: a disarmed fetch never enters the trace code, so it
  copies nothing off the device.
"""

import numpy as np
import pytest

from tpu_bfs import obs as jobs
from tpu_bfs.algorithms.msbfs_hybrid import HybridMsBfsEngine as JHybrid
from tpu_bfs.algorithms.msbfs_packed import PackedMsBfsEngine as JPacked
from tpu_bfs.algorithms.msbfs_wide import WidePackedMsBfsEngine as JWide
from tpu_bfs.graph import generate as jgen
from tpu_bfs.graph import io as jio
from tpu_bfs.obs import engine_trace as jet
from tpu_bfs.parallel.dist_bfs import DistBfsEngine as JDist
from tpu_bfs.parallel.dist_bfs import make_mesh
from tpu_bfs.parallel.dist_bfs2d import Dist2DBfsEngine as JDist2D
from tpu_bfs.parallel.dist_bfs2d import make_mesh_2d
from tpu_bfs.parallel.dist_msbfs_wide import DistWideMsBfsEngine as JDistWide

import torch_mesh_cases as cases
from tpu_bfs_torch import obs as tobs
from tpu_bfs_torch.algorithms import _packed_common
from tpu_bfs_torch.algorithms.msbfs_hybrid import HybridMsBfsEngine as THybrid
from tpu_bfs_torch.algorithms.msbfs_packed import PackedMsBfsEngine as TPacked
from tpu_bfs_torch.algorithms.msbfs_wide import WidePackedMsBfsEngine as TWide
from tpu_bfs_torch.graph import generate as tgen
from tpu_bfs_torch.obs import engine_trace as tet
from tpu_bfs_torch.parallel.mesh import start

from torch_threads import cap_torch_threads

cap_torch_threads()


@pytest.fixture(autouse=True)
def _disarmed():
    jobs.disarm()
    tobs.disarm()
    yield
    jobs.disarm()
    tobs.disarm()


# --- the assemblers -------------------------------------------------------------


class _FakeDist:
    def __init__(self, per_level, mode="sparse", caps=(4, 8), labels=None):
        self._per_level, self._exchange, self.sparse_caps = per_level, mode, caps
        if labels is not None:
            self.exchange_branch_labels = lambda: labels

    def wire_bytes_per_level(self):
        return self._per_level


class _FakePacked:
    pull_gate = True
    sparse_caps = (16, 64)

    def __init__(self, counts, gates=(0, 3, 7)):
        self.last_gate_level_counts = np.asarray(gates)
        self.last_exchange_level_counts = np.asarray(counts)
        self.last_exchange_bytes = 123.0

    def wire_bytes_per_level(self):
        return [10.0, 20.0, 30.0]


@pytest.mark.parametrize("levels,level0", [(3, 10), (0, 0), (tet.TRACE_LEVELS + 9, 2)])
@pytest.mark.parametrize("fake", [
    dict(per_level=[100.0, 200.0, 300.0]),
    dict(per_level=[512.0], mode="ring"),
    dict(per_level=[1.0, 2.0], labels=["sparse-delta8[4]", "dense"]),
])
def test_assemble_dist_trace_equals_jax(fake, levels, level0):
    rng = np.random.default_rng(levels)
    nb = len(fake["per_level"])
    front = rng.integers(0, 50, tet.TRACE_LEVELS).astype(np.int32)
    branch = rng.integers(-1, nb, tet.TRACE_LEVELS).astype(np.int32)
    for direction in ("push", "dopt"):
        got = tet.assemble_dist_trace(_FakeDist(**fake), levels, front, branch,
                                      direction=direction, level0=level0)
        want = jet.assemble_dist_trace(_FakeDist(**fake), levels, front, branch,
                                       direction=direction, level0=level0)
        assert got == want
        assert tet.trace_summary(got, _FakeDist(**fake)) == jet.trace_summary(want)


@pytest.mark.parametrize("counts", [[0, 2, 0], [1, 2, 0], [3], None])
def test_assemble_packed_trace_and_summary_equal_jax(counts):
    eng = _FakePacked(counts if counts is not None else [0])
    if counts is None:
        eng.last_exchange_level_counts = None
    got, want = tet.assemble_packed_trace(eng, 3), jet.assemble_packed_trace(eng, 3)
    assert got == want
    assert tet.trace_summary(got, eng) == jet.trace_summary(want, eng)
    assert tet.trace_summary([]) == jet.trace_summary([]) == {"levels": 0}


def test_level_record_clamps_like_the_jax_carry():
    rec = tet.LevelRecord(level0=5)
    for lvl in range(5, 5 + tet.TRACE_LEVELS + 9):
        rec.add(lvl, 2, lvl % 3)
    assert rec.front[:-1].tolist() == [2] * (tet.TRACE_LEVELS - 1)
    assert int(rec.front[-1]) == 2 * 10  # the clamped tail's sum
    assert int(rec.branch[-1]) == (5 + tet.TRACE_LEVELS + 8) % 3  # the last write


# --- packed engines ---------------------------------------------------------------


def _packed_pair(kind, gated):
    g_t, g_j = tgen.rmat_graph(9, 8, seed=2), jgen.rmat_graph(9, 8, seed=2)
    if kind == "hybrid":
        return (THybrid(g_t, lanes=64, num_planes=5, pull_gate=gated, device="cpu"),
                JHybrid(g_j, lanes=64, num_planes=5, pull_gate=gated))
    return (TWide(g_t, lanes=64, num_planes=5, pull_gate=gated, device="cpu"),
            JWide(g_j, lanes=64, num_planes=5, pull_gate=gated))


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("kind", ["hybrid", "wide"])
def test_packed_engine_traces_equal_jax(kind, gated):
    teng, jeng = _packed_pair(kind, gated)
    sources = np.arange(0, 120, 3)
    teng.run(sources)
    assert getattr(teng, "last_run_trace", None) is None  # disarmed: nothing recorded
    tobs.arm()
    jobs.arm()
    tres, jres = teng.run(sources), jeng.run(sources)
    assert tres.num_levels == jres.num_levels
    assert teng.last_run_trace == jeng.last_run_trace
    assert len(teng.last_run_trace) == tres.num_levels + 1  # the last level claims none
    assert tet.trace_summary(teng.last_run_trace, teng) == \
        jet.trace_summary(jeng.last_run_trace, jeng)
    assert (tet.trace_summary(teng.last_run_trace).get("gated_tiles_total", 0) > 0) == gated
    ev = [e for e in tobs.ACTIVE.snapshot() if e["name"] == "engine.run_trace"]
    jev = [e for e in jobs.ACTIVE.snapshot() if e["name"] == "engine.run_trace"]
    assert [e["args"] for e in ev] == [e["args"] for e in jev] and len(ev) == 1


def test_packed_512_engine_records_no_trace_in_either_package():
    g_t, g_j = tgen.rmat_graph(8, 8, seed=2), jgen.rmat_graph(8, 8, seed=2)
    tobs.arm()
    jobs.arm()
    teng, jeng = TPacked(g_t, lanes=32, device="cpu"), JPacked(g_j, lanes=32)
    teng.run(np.arange(5))
    jeng.run(np.arange(5))
    assert getattr(teng, "last_run_trace", None) is None
    assert getattr(jeng, "last_run_trace", None) is None


def test_disarmed_fetch_never_reads_the_gate_counters(monkeypatch):
    """The guard: a disarmed fetch never enters the trace code, so the
    device gate counters stay on the device (JAX's obs spy, ported)."""
    calls = []
    monkeypatch.setattr(tet, "record_packed_run", lambda *a, **kw: calls.append("run"))
    real_host = tet._host
    monkeypatch.setattr(tet, "_host", lambda a: calls.append("host") or real_host(a))
    teng, _ = _packed_pair("wide", True)
    pend = teng.dispatch(np.arange(40))
    res = _packed_common.fetch_packed_batch(teng, pend)
    assert int(res.reached[0]) > 0 and calls == []
    tobs.arm()
    teng.run(np.arange(40))
    assert calls == ["run"]


# --- the mesh engines on gloo ----------------------------------------------------


def _jax_records(shape, case_list, packed=()):
    if isinstance(shape, tuple):
        mesh = make_mesh_2d(*shape)
        make = lambda g, **kw: JDist2D(g, mesh, **kw)  # noqa: E731
    else:
        mesh = make_mesh(shape)
        make = lambda g, **kw: JDist(g, mesh, **kw)  # noqa: E731
    out = {}
    for case in case_list:
        eng = make(cases.graph_of(case[1], jgen, jio), **case[2])
        if case[4] is None:
            eng.run(case[3])
        else:
            eng.advance(eng.advance(eng.start(case[3]), levels=case[4]))
        out[case[0]] = {"trace": eng.last_run_trace,
                        "summary": jet.trace_summary(eng.last_run_trace, eng)}
    jobs.arm()
    for name, gname, kw, sources in packed:
        eng = JDistWide(cases.graph_of(gname, jgen, jio), make_mesh(shape), **kw)
        eng.run(np.asarray(sources))
        out[name] = {"trace": eng.last_run_trace,
                     "summary": jet.trace_summary(eng.last_run_trace, eng)}
    jobs.disarm()
    return out


PACKED_MESH = [("wide_sparse", "rmat_small", dict(lanes=64, exchange="sparse"),
                list(range(0, 120, 3))),
               ("wide_dense", "rmat_small", dict(lanes=32, exchange="dense"),
                list(range(0, 60, 2)))]


@pytest.mark.parametrize("shape,case_list,packed", [
    (2, cases.TRACE_CASES_1D, PACKED_MESH),
    ((1, 2), cases.TRACE_CASES_2D + cases.TRACE_CASES_2D_ONE_ROW, ()),
    ((2, 2), cases.TRACE_CASES_2D, ()),
], ids=["1d-P2", "2d-1x2", "2d-2x2"])
def test_mesh_traces_equal_jax(shape, case_list, packed):
    ranks = shape if isinstance(shape, int) else shape[0] * shape[1]
    group = start(ranks, cases.run_trace_cases, shape, case_list, packed, device="cpu")
    want = _jax_records(shape, case_list, packed)
    got = group.result()
    for name in want:
        assert got[name]["trace"] == want[name]["trace"], name
        assert got[name]["summary"] == want[name]["summary"], name
    if shape == 2:
        deep = got["path100"]
        assert len(deep["trace"]) == tet.TRACE_LEVELS
        assert deep["trace"][-1]["truncated_levels"] == 100 - tet.TRACE_LEVELS + 1
        assert deep["summary"]["frontier_total"] == 99
        assert got["resumed"]["trace"][0]["level"] == 2
        assert len(got["sparse"]["summary"]["exchange_levels"]) > 1
