"""The port's roofline attribution (``tpu_bfs_torch/utils/roofline.py``)
against the JAX package's (``tpu_bfs/utils/roofline.py``).

Times mean nothing on the CPU; what is held here is the instrument:

- the report's keys and each level's fields are JAX's (plus the two keys
  JAX adds for its kernel tier, which the port always runs), and so are
  the walk's level count, each level's frontier rows and direction, and
  the engine trace it leaves; the level count equals a plain run's;
- the byte model equals JAX's ``expand_impl="pallas"`` engine's on every
  entry priced from the same layout (residual, push, state, and the
  per-launch K1 bytes); the dense entry is the port's own K2 model
  (``tile_spmm_hbm_bytes``), which happens to price the row masks at the
  bytes of JAX's tiles; the exchange entry is ``dense_rows_wire_bytes``;
- the slices compose to the loop's level and leave the engine reusable,
  and an adaptive engine attributes 'push' exactly on its light levels.
"""

import types

import numpy as np
import pytest

from tpu_bfs.algorithms.msbfs_hybrid import HybridMsBfsEngine as JHybrid
from tpu_bfs.graph.generate import rmat_graph as jrmat
from tpu_bfs.utils import roofline as jroof

from tpu_bfs_torch.algorithms.msbfs_hybrid import HybridMsBfsEngine
from tpu_bfs_torch.graph.generate import rmat_graph
from tpu_bfs_torch.ops.tile_spmm import tile_spmm_hbm_bytes
from tpu_bfs_torch.parallel.collectives import dense_rows_wire_bytes
from tpu_bfs_torch.reference import bfs_scipy
from tpu_bfs_torch.utils import roofline as troof

KW = dict(lanes=64, num_planes=4)
CAPS = (64, 32)


@pytest.fixture(scope="module")
def graphs():
    return jrmat(10, 8, seed=5), rmat_graph(10, 8, seed=5)


@pytest.fixture(scope="module")
def sources(graphs):
    g = graphs[1]
    return np.random.default_rng(7).choice(np.flatnonzero(g.degrees > 0), size=64,
                                           replace=False)


@pytest.fixture(scope="module")
def engines(graphs):
    """(plain, adaptive) port engines."""
    g = graphs[1]
    return (HybridMsBfsEngine(g, device="cpu", **KW),
            HybridMsBfsEngine(g, adaptive_push=CAPS, device="cpu", **KW))


@pytest.fixture(scope="module")
def jax_report(graphs, sources):
    eng = JHybrid(graphs[0], adaptive_push=CAPS, **KW)
    return jroof.roofline_hybrid(eng, sources, measured_gteps=1.0), eng.last_run_trace


def test_report_keys_levels_and_trace_equal_jax(engines, sources, jax_report):
    want, want_trace = jax_report
    eng = engines[1]
    got = troof.roofline_hybrid(eng, sources, measured_gteps=1.0)
    assert set(got) == set(want) | {"expand_kernel_bytes", "expand_kernel_t_at_peak_bw_s"}
    assert got["num_levels"] == want["num_levels"]
    for a, b in zip(got["levels"], want["levels"], strict=True):
        assert set(a) == set(b)
        assert (a["level"], a["frontier_rows"], a["took"]) == (
            b["level"], b["frontier_rows"], b["took"])
        assert set(a["phases_s"]) == set(b["phases_s"])
        assert set(a["bytes_model"]) == set(b["bytes_model"])
        assert a["bytes_model"]["push"] == b["bytes_model"]["push"]
        assert a["bytes_model"]["state"] == b["bytes_model"]["state"]
    assert eng.last_run_trace == want_trace
    assert got["trace_summary"] == want["trace_summary"]
    assert got["binding_term"] in got["phase_share"]
    assert abs(sum(got["phase_share"].values()) - 1.0) < 1e-9
    assert got["peak_gbs"] == troof.H100_PEAK_GBS == 3350.0
    assert got["expand_impl"] == "cuda"
    kb = got["expand_kernel_bytes"]
    assert kb["level_total"] == sum(v for k, v in kb.items() if k != "level_total") > 0
    assert got["ceiling_gteps_at_peak_bw"] > 0
    # The guard: one level more than a plain run counts (the claim-free
    # last level), as JAX's walk.
    assert got["num_levels"] == eng.run(sources).num_levels + 1


@pytest.mark.parametrize("gate", [False, True])
def test_phase_bytes_equal_jax_pallas(graphs, gate):
    jg, tg = graphs
    kw = dict(KW, pull_gate=True) if gate else dict(KW, adaptive_push=CAPS)
    jeng = JHybrid(jg, expand_impl="pallas", interpret=True, **kw)
    eng = HybridMsBfsEngine(tg, device="cpu", **kw)
    for nz, at in ((0, None), (10, None), (37, 3), (5, 0)):
        if not gate and at is not None:
            continue
        got = troof.phase_bytes(eng, nz_rows=nz, active_tiles=at)
        want = jroof.phase_bytes(jeng, nz_rows=nz, active_tiles=at)
        assert set(got) == set(want)
        for key in ("residual", "push", "state"):
            assert got.get(key) == want.get(key), key
        # dense: the port's K2 model over its row masks, equal in bytes.
        assert got["dense"] == tile_spmm_hbm_bytes(eng.hg.num_tiles, eng.hg.vt, eng.w)
        assert got["dense"] == want["dense"]
        assert (troof.pallas_expand_bytes(eng, active_tiles=at)
                == jroof.pallas_expand_bytes(jeng, active_tiles=at))
    if not gate:
        assert (troof.phase_bytes(eng, nz_rows=20)["push"]
                > troof.phase_bytes(eng, nz_rows=10)["push"])


def test_exchange_entry_is_dense_rows_wire_bytes():
    # A mesh engine's entry, from the attributes phase_bytes reads (no
    # rank group spawned): equal to JAX's on the same attributes.
    eng = types.SimpleNamespace(w=8, _gather_p=4, _gather_rows_loc=300)
    got = troof.phase_bytes(eng)
    assert got == {"exchange": dense_rows_wire_bytes(4, 300, 8)} == jroof.phase_bytes(eng)
    assert got["exchange"] > 0
    assert troof.phase_bytes(types.SimpleNamespace(w=8, _gather_p=1)) == {}


def test_phase_slices_compose_to_the_loop(engines, sources):
    import torch

    eng = engines[0]
    fns = troof.phase_fns(eng)
    fw = eng._seed_dev(sources)
    h = fns["hit"](eng.arrs, fw)
    assert torch.equal(h, fns["residual"](eng.arrs, fw) | fns["dense"](eng.arrs, fw))
    planes = tuple(torch.zeros_like(fw) for _ in range(eng.num_planes))
    _, vis2, _ = fns["claim"](h, fw)
    planes2 = fns["ripple"](planes, vis2)
    assert not any(p.any() for p in planes)  # the slices update nothing
    _, vis_f, planes_f, _, _ = eng._core_from(eng.arrs, fw, fw.clone(), planes, 0, 1)
    assert torch.equal(vis2, vis_f)
    for a, b in zip(planes2, planes_f):
        assert torch.equal(a, b)


def test_stepping_does_not_perturb_and_push_matches_the_gate(graphs, engines, sources):
    g, eng = graphs[1], engines[1]
    report = troof.roofline_hybrid(eng, sources)
    pushed = [la["took"] == "push" for la in report["levels"]]
    assert any(pushed)
    for la in report["levels"]:
        if la["took"] == "push":
            assert la["frontier_rows"] <= CAPS[0] and "push" in la["phases_s"]
        assert la["bytes_model"]["residual"] > 0 and la["bytes_model"]["state"] > 0
    res = eng.run(sources)
    assert eng.last_push_levels == pushed  # the loop's own light levels
    for i in (0, 31, 63):
        np.testing.assert_array_equal(res.distances_int32(i), bfs_scipy(g, int(sources[i])))


def test_gated_engine_walk(graphs, sources):
    # A pull-gated engine: each level's gate input is recorded, the byte
    # model shrinks with it, and the walk's level count is a plain run's.
    eng = HybridMsBfsEngine(graphs[1], pull_gate=True, device="cpu", **KW)
    report = troof.roofline_hybrid(eng, sources)
    assert report["pull_gate"] and report["num_levels"] == eng.run(sources).num_levels + 1
    tiles = [la["active_tiles"] for la in report["levels"]]
    assert tiles == sorted(tiles, reverse=True) and tiles[-1] < tiles[0]
    states = [la["bytes_model"]["state"] for la in report["levels"]]
    assert states[-1] < states[0]
    assert {r["direction"] for r in eng.last_run_trace} == {"pull-gated"}
