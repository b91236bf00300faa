"""The port's wide and hybrid engines against the JAX engines, lane by lane.

Both sides run the same seeded graph and sources with the same lanes and
planes: the JAX engines under interpret=True (the hybrid with expand_impl
"xla" and "pallas"), the port on device="cpu" (the kernels' plain twins).
num_levels, reached, edges_traversed, ecc and every lane's distances must
be equal, once on independently built structures and once on the JAX
structures carried across by tpu_bfs_torch.convert.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpu_bfs.algorithms.msbfs_hybrid import HybridMsBfsEngine as JHybrid
from tpu_bfs.algorithms.msbfs_wide import WidePackedMsBfsEngine as JWide
from tpu_bfs.graph import generate as jgen

from tpu_bfs_torch import convert
from tpu_bfs_torch.algorithms import _packed_common as tpc
from tpu_bfs_torch.algorithms.msbfs_hybrid import HybridMsBfsEngine, build_hybrid
from tpu_bfs_torch.algorithms.msbfs_wide import WidePackedMsBfsEngine
from tpu_bfs_torch.graph import generate as tgen
from tpu_bfs_torch.graph import io as tio
from tpu_bfs_torch.ops import ell_expand as k1
from tpu_bfs_torch.reference import bfs_python

LANES, PLANES, KCAP, TILE_THR = 64, 6, 8, 2

GRAPHS = {
    "rmat10": (lambda: jgen.rmat_graph(10, 16, seed=11), lambda: tgen.rmat_graph(10, 16, seed=11)),
    # Every occupied tile dense at tile_thr=2: an empty residual.
    "random_small": (lambda: jgen.random_graph(500, 2000, seed=12345),
                     lambda: tgen.random_graph(500, 2000, seed=12345)),
    # Mostly isolated vertices, a small residual beside ~800 dense tiles.
    "random_sparse": (lambda: jgen.random_graph(6000, 3000, seed=9),
                      lambda: tgen.random_graph(6000, 3000, seed=9)),
}

_graphs, _jax_runs = {}, {}


def graphs(name):
    if name not in _graphs:
        jb, tb = GRAPHS[name]
        _graphs[name] = (jb(), tb())
    return _graphs[name]


def sources_of(g):
    # Seeded picks over all vertices: isolated sources and repeats included.
    return np.random.default_rng(5).integers(0, g.num_vertices, size=LANES)


def jax_result(name, engine, impl):
    key = (name, engine, impl)
    if key not in _jax_runs:
        jg, _ = graphs(name)
        if engine == "wide":
            eng = JWide(jg, lanes=LANES, kcap=KCAP, num_planes=PLANES,
                        expand_impl=impl, interpret=True)
        else:
            eng = JHybrid(jg, lanes=LANES, kcap=KCAP, tile_thr=TILE_THR, num_planes=PLANES,
                          expand_impl=impl, interpret=True)
        _jax_runs[key] = (eng, eng.run(sources_of(jg)))
    return _jax_runs[key]


def port_engine(name, engine, via_convert):
    jg, tg = graphs(name)
    if engine == "wide":
        g = convert.ell_from_numpy(dataclasses.asdict(jax_result(name, "wide", "xla")[0].ell)) \
            if via_convert else tg
        return WidePackedMsBfsEngine(g, lanes=LANES, kcap=KCAP, num_planes=PLANES, device="cpu")
    g = convert.hybrid_from_numpy(dataclasses.asdict(jax_result(name, "hybrid", "xla")[0].hg)) \
        if via_convert else tg
    return HybridMsBfsEngine(g, lanes=LANES, kcap=KCAP, tile_thr=TILE_THR,
                             num_planes=PLANES, device="cpu")


def assert_same_result(res, want):
    assert res.num_levels == want.num_levels
    np.testing.assert_array_equal(res.reached, want.reached)
    np.testing.assert_array_equal(res.edges_traversed, want.edges_traversed)
    np.testing.assert_array_equal(res.ecc, want.ecc)
    for i in range(len(want.sources)):
        np.testing.assert_array_equal(res.distances_int32(i), want.distances_int32(i),
                                      err_msg=f"lane {i}")


PARITY_CASES = [
    (name, engine, impl, via)
    for name, variants in {
        "rmat10": [("wide", "xla"), ("wide", "pallas"), ("hybrid", "xla"), ("hybrid", "pallas")],
        "random_sparse": [("wide", "xla"), ("hybrid", "xla"), ("hybrid", "pallas")],
        "random_small": [("hybrid", "xla"), ("hybrid", "pallas")],
    }.items()
    for engine, impl in variants
    for via in (False, True)
]


@pytest.mark.parametrize("name,engine,impl,via_convert", PARITY_CASES)
def test_engine_bit_identical_to_jax(name, engine, impl, via_convert):
    _, want = jax_result(name, engine, impl)
    eng = port_engine(name, engine, via_convert)
    if engine == "hybrid":
        assert eng.hg.num_tiles > 0
        assert bool(eng.hg.res_light) == (name != "random_small")
    res = eng.run(sources_of(graphs(name)[1]))
    assert_same_result(res, want)


@pytest.mark.parametrize("engine", ["wide", "hybrid"])
def test_engine_matches_oracle_deep_graph(engine):
    # Path graph: eccentricity 63 needs 6 planes (64 levels); 5 truncate.
    n = 64
    g = tio.from_edges(np.arange(n - 1), np.arange(1, n), num_vertices=n)
    make = (lambda p: WidePackedMsBfsEngine(g, lanes=32, kcap=4, num_planes=p, device="cpu")) \
        if engine == "wide" else \
        (lambda p: HybridMsBfsEngine(g, lanes=32, kcap=4, tile_thr=1, num_planes=p,
                                     device="cpu"))
    res = make(6).run([0, 63, 31])
    assert res.num_levels == 63
    for i, s in enumerate([0, 63, 31]):
        np.testing.assert_array_equal(res.distances_int32(i), bfs_python(g, s)[0])
    with pytest.raises(RuntimeError, match="truncated"):
        make(5).run([0])
    partial = make(5).run([0], check_cap=False)
    assert partial.num_levels == 32


def test_max_levels_stops_early():
    _, tg = graphs("random_small")
    eng = HybridMsBfsEngine(tg, lanes=32, kcap=KCAP, tile_thr=TILE_THR, num_planes=PLANES,
                            device="cpu")
    full = eng.run([0])
    cut = eng.run([0], max_levels=2)
    assert cut.num_levels == 2 and cut.reached[0] < full.reached[0]
    d = cut.distances_int32(0)
    np.testing.assert_array_equal(d[d <= 2], full.distances_int32(0)[d <= 2])


def test_dispatch_fetch_and_timing():
    _, tg = graphs("random_small")
    eng = WidePackedMsBfsEngine(tg, lanes=32, kcap=KCAP, device="cpu")
    res = eng.fetch(eng.dispatch([1, 2, 3]))
    again = eng.run([1, 2, 3], time_it=True)
    np.testing.assert_array_equal(res.reached, again.reached)
    assert res.elapsed_s is None and again.elapsed_s > 0 and again.teps > 0


def test_engine_device_none_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tg = graphs("random_small")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HybridMsBfsEngine(tg, lanes=32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WidePackedMsBfsEngine(tg, lanes=32)


def test_engine_rejects_bad_arguments():
    _, tg = graphs("random_small")
    with pytest.raises(ValueError, match="num_planes"):
        WidePackedMsBfsEngine(tg, num_planes=9, device="cpu")
    with pytest.raises(ValueError, match="lanes"):
        HybridMsBfsEngine(tg, lanes=48, device="cpu")
    eng = WidePackedMsBfsEngine(tg, lanes=32, device="cpu")
    with pytest.raises(ValueError, match="need 1..32 sources"):
        eng.run(np.arange(33))
    with pytest.raises(ValueError, match="out of range"):
        eng.run([tg.num_vertices])


def test_auto_sizing_and_lifted_lane_quantum():
    _, tg = graphs("random_small")
    eng = HybridMsBfsEngine(tg, device="cpu")
    assert (eng.lanes, eng.num_planes) == (8192, 5)
    # Any multiple of 32 lanes runs the hybrid with dense tiles (no 4096-lane
    # quantum); each lane still equals the oracle.
    eng = HybridMsBfsEngine(tg, lanes=96, tile_thr=TILE_THR, kcap=KCAP, device="cpu")
    assert eng.hg.num_tiles > 0
    res = eng.run(np.arange(96))
    for i in (0, 40, 95):
        np.testing.assert_array_equal(res.distances_int32(i), bfs_python(tg, i)[0])


def test_make_hit_ors_dense_pass_into_residual_hits():
    # The hit table is the permuted residual expansion, with K2's hits ORed
    # into it in place (no separate zero-filled table).
    from tpu_bfs_torch.algorithms.msbfs_hybrid import expand_spec, make_hit
    from tpu_bfs_torch.ops.tile_spmm import tile_spmm_plain

    eng = port_engine("rmat10", "hybrid", False)
    hg, arrs = eng.hg, eng.arrs
    rng = np.random.default_rng(8)
    fw = rng.integers(0, 2**32, size=(hg.vt * 128, eng.w), dtype=np.uint32)
    fw[rng.random(fw.shape[0]) < 0.5] = 0
    fw[-1] = 0  # the residual's pad sentinel row
    fw = torch.from_numpy(fw.view(np.int32))
    hit = make_hit(hg, eng.w)(arrs, fw)
    residual = tpc.make_expand(expand_spec(hg), eng.w)(arrs, fw).index_select(
        0, arrs["inv_perm_ext"])
    assert "a_tiles" not in arrs  # one resident layout: the row masks
    dense = tile_spmm_plain(arrs["row_start"], arrs["col_tile"], None, fw,
                            num_row_tiles=hg.vt, masks=arrs["a_masks"])
    assert torch.equal(hit, residual | dense)
    assert dense.any() and (residual & ~dense).any()


def test_hybrid_odd_width_bit_identical_to_jax():
    # 96 lanes (w = 3): the width that takes the kernels' scalar paths.
    jg, tg = graphs("random_sparse")
    src = np.random.default_rng(6).integers(0, tg.num_vertices, size=96)
    want = JHybrid(jg, lanes=96, kcap=KCAP, tile_thr=TILE_THR, num_planes=PLANES,
                   expand_impl="pallas", interpret=True).run(src)
    res = HybridMsBfsEngine(tg, lanes=96, kcap=KCAP, tile_thr=TILE_THR, num_planes=PLANES,
                            device="cpu").run(src)
    assert_same_result(res, want)


def test_residual_sentinel_row_stays_zero_and_no_cpu_launches():
    _, tg = graphs("rmat10")
    hg = build_hybrid(tg, kcap=KCAP, tile_thr=TILE_THR)
    eng = HybridMsBfsEngine(hg, lanes=32, num_planes=PLANES, device="cpu")
    before = k1.ell_expand.launches
    res = eng.run(np.arange(32))
    assert k1.ell_expand.launches == before  # CPU tensors never launch
    assert not res._vis[hg.vt * 128 - 1].any()
    assert tpc.floor_lanes(eng.lanes) == eng.lanes
