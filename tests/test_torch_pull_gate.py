"""The port's pull gate against the JAX package's, piece by piece and end
to end.

The pieces (gate_forward_map, host_lane_mask, row_unsettled, the gated
bucket expansion in its dense, gated and heavy-skip branches, and the
gated state pass) take the same numpy inputs on both sides and must agree
bit for bit. The gated wide, hybrid and tiled engines must equal JAX's
gated engines on their raw state (visited table and counter planes) and on
the skipped-block counts, count for count; and the ungated engines on
everything extraction reads: distances, reached, ecc and parents. JAX runs
on the CPU (its Pallas kernel in interpret mode), the port with
device="cpu" (the kernels' plain twins).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bfs.algorithms import _packed_common as jpc
from tpu_bfs.algorithms.bfs_tiled import TiledBfsEngine as JTiled
from tpu_bfs.algorithms.msbfs_hybrid import HybridMsBfsEngine as JHybrid
from tpu_bfs.algorithms.msbfs_wide import WidePackedMsBfsEngine as JWide
from tpu_bfs.graph import ell as jell_mod
from tpu_bfs.graph import generate as jgen
from tpu_bfs.graph import io as jio
from tpu_bfs.utils import stats as jstats

from tpu_bfs_torch import convert
from tpu_bfs_torch.algorithms import _packed_common as tpc
from tpu_bfs_torch.algorithms.bfs_tiled import TiledBfsEngine
from tpu_bfs_torch.algorithms.msbfs_hybrid import HybridMsBfsEngine
from tpu_bfs_torch.algorithms.msbfs_wide import WidePackedMsBfsEngine, expand_spec
from tpu_bfs_torch.graph import ell as tell_mod
from tpu_bfs_torch.graph import generate as tgen
from tpu_bfs_torch.graph import io as tio
from tpu_bfs_torch.reference import bfs_scipy
from tpu_bfs_torch.utils import stats as tstats

LANES, PLANES = 64, 6


def _path(n):
    a, b = np.arange(n - 1), np.arange(1, n)
    return jio.from_edges(a, b, num_vertices=n), tio.from_edges(a, b, num_vertices=n)


GRAPHS = {
    # (kcap, tile_thr): small kcap puts hubs in the heavy section; tile_thr
    # keeps a residual beside the dense tiles.
    "rmat10": (lambda: (jgen.rmat_graph(10, 16, seed=11), tgen.rmat_graph(10, 16, seed=11)),
               8, 16),
    "rmat9": (lambda: (jgen.rmat_graph(9, 8, seed=5), tgen.rmat_graph(9, 8, seed=5)), 4, 8),
    "path200": (lambda: _path(200), 4, 1),
    # Mostly isolated vertices: isolated sources in the batch.
    "sparse": (lambda: (jgen.random_graph(3000, 2500, seed=9),
                        tgen.random_graph(3000, 2500, seed=9)), 4, 4),
}
_graphs = {}


def graphs(name):
    if name not in _graphs:
        _graphs[name] = GRAPHS[name][0]()
    return _graphs[name]


def sources_of(name, n=LANES):
    g = graphs(name)[1]
    if name == "sparse":  # every kind of lane: isolated, repeated, live
        return np.random.default_rng(5).integers(0, g.num_vertices, size=n)
    return np.random.default_rng(7).choice(np.flatnonzero(g.degrees > 0), size=n,
                                           replace=False)


def u32(t):
    return t.cpu().numpy().view(np.uint32)


# --- the pieces ---------------------------------------------------------------


def test_gate_forward_map_equals_jax():
    rng = np.random.default_rng(3)
    routing = rng.permutation(700).astype(np.int32)
    routing[rng.random(700) < 0.2] = 650  # rows routed to the shared zero row
    want = jell_mod.gate_forward_map(routing, 651, 650)
    got = tell_mod.gate_forward_map(routing, 651, 650)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rows,act,w", [
    ([0, 7, 2, 99, 5], 50, 2),  # lane 3 isolated
    (list(range(31)) + [40, 3], 41, 2),  # lane 31 (bit 31) and lane 32 (word 1)
    (np.arange(70) % 13, 12, 4),  # repeats, isolated rows, a spill into word 2
])
def test_host_lane_mask_equals_jax(rows, act, w):
    rows = np.asarray(rows)
    got = tpc.host_lane_mask(rows, act, w)
    np.testing.assert_array_equal(got, jpc.host_lane_mask(rows, act, w))
    # Exactly the seeded lanes: each live lane's bit, no isolated lane's.
    for lane, r in enumerate(rows):
        assert bool(got[lane // 32] >> np.uint32(lane % 32) & 1) == (r < act)


@pytest.mark.parametrize("act", [0, 200, 299])
def test_row_unsettled_equals_jax(act):
    rng = np.random.default_rng(act)
    vis = rng.integers(0, 2**32, size=(300, 3), dtype=np.uint32)
    vis[rng.random(300) < 0.5] = 0xFFFFFFFF
    mask = jpc.host_lane_mask(rng.integers(0, 300, size=70), act + 1, 3)
    vis[::7] |= mask  # settled rows
    want = np.asarray(jpc.row_unsettled(jnp.asarray(vis), act, jnp.asarray(mask)))
    got = tpc.row_unsettled(torch.from_numpy(vis.view(np.int32)), act,
                            torch.from_numpy(mask.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tpc.host_row_unsettled(vis, act, mask), want)


def test_seed_row_unsettled_equals_device_form():
    rng = np.random.default_rng(1)
    for rows_of in (np.array([5, 5, 5]), np.array([5, 9]), np.array([900, 901]),
                    np.array([5, 900]), rng.integers(0, 600, size=40)):
        act, rows = 512, 640
        mask = tpc.host_lane_mask(rows_of, act, 2)
        seed = np.zeros((rows, 2), np.uint32)
        for lane, r in enumerate(rows_of):
            if r < act:
                seed[r, lane // 32] |= np.uint32(1) << np.uint32(lane % 32)
        np.testing.assert_array_equal(tpc.seed_row_unsettled(rows_of, act, rows),
                                      tpc.host_row_unsettled(seed, act, mask))


@pytest.fixture(scope="module")
def expand_case():
    """One ELL (RMAT 13, kcap 8: a heavy section and light buckets of many
    blocks) with both packages' tables and a random frontier."""
    jg = jgen.rmat_graph(13, 8, seed=3)
    jell = jell_mod.build_ell(jg, kcap=8)
    tell = convert.ell_from_numpy(dataclasses.asdict(jell))
    act, w = tell.num_active, 3
    spec = expand_spec(tell)
    jspec = jpc.ExpandSpec(*spec)
    jarrs = {**jpc.expand_arrays(jell),
             **{k: jnp.asarray(v) for k, v in jpc.pallas_expand_arrays(jell, act).items()}}
    tarrs = tpc.expand_arrays(tell, act, "cpu")
    tarrs.update(tpc.gate_block_arrays(spec, tarrs))  # the gated expansion's block maps
    rng = np.random.default_rng(4)
    fw = rng.integers(0, 2**32, size=(act + 1, w), dtype=np.uint32)
    fw[rng.random(act + 1) < 0.6] = 0
    fw[act] = 0  # the sentinel row
    assert tell.num_heavy and len(tell.light) >= 3
    assert max(b.n for b in tell.light) >= 8 * 128  # many blocks in one bucket
    return tell, spec, jspec, jarrs, tarrs, fw, w


def _needed(tell, branch, rng):
    act, nh = tell.num_active, tell.num_heavy
    need = np.ones(act + 1, bool)
    if branch == "gated":  # a few light blocks, the heavy rows settled
        need[:] = False
        need[nh + rng.choice(act - nh, size=5, replace=False)] = True
    elif branch == "mixed":  # the heavy section runs, a few light blocks
        need[:] = False
        need[nh + rng.choice(act - nh, size=5, replace=False)] = True
        need[0] = True
    elif branch == "half":  # lights above the dense fraction: all-ones masks
        need = rng.random(act + 1) < 0.5
        need[0] = True
    need[act] = False
    return need


@pytest.mark.parametrize("branch", ["dense", "gated", "mixed", "half"])
def test_gated_expand_equals_jax(expand_case, branch):
    tell, spec, jspec, jarrs, tarrs, fw, w = expand_case
    need = _needed(tell, branch, np.random.default_rng(len(branch)))
    heavy = bool(need[: tell.num_heavy].any())
    assert heavy == (branch != "gated")
    got, skipped = tpc.make_gated_expand(spec, w)(
        tarrs, torch.from_numpy(fw.view(np.int32)), torch.from_numpy(need), heavy)
    for make in (jpc.make_gated_fori_expand,
                 lambda s, w: jpc.make_gated_pallas_expand(s, w, interpret=True)):
        want, want_skipped = make(jspec, w)(jarrs, jnp.asarray(fw), jnp.asarray(need))
        np.testing.assert_array_equal(u32(got), np.asarray(want))
        assert int(skipped) == int(want_skipped)
    assert (int(skipped) > 0) == (branch in ("gated", "mixed"))
    # The ungated expansion agrees on every needed row.
    full = tpc.make_expand(spec, w)(tarrs, torch.from_numpy(fw.view(np.int32)))
    np.testing.assert_array_equal(u32(got)[need], u32(full)[need])


@pytest.mark.parametrize("branch", ["gated", "dense", "none_active"])
@pytest.mark.parametrize("rows", [128 * 9, 128 * 9 + 57])  # whole blocks; a ragged tail
def test_gated_state_update_equals_jax(branch, rows):
    rng = np.random.default_rng(rows)
    w, planes_n, nt = 2, 4, rows // 128
    hit = rng.integers(0, 2**32, size=(rows, w), dtype=np.uint32)
    vis = rng.integers(0, 2**32, size=(rows, w), dtype=np.uint32)
    planes = [rng.integers(0, 2**32, size=(rows, w), dtype=np.uint32) for _ in range(planes_n)]
    need = np.zeros(rows, bool)
    if branch == "gated":
        need[[5, 300, 301]] = True  # blocks 0 and 2: 2 * 4 <= 9
    elif branch == "dense":
        need[::100] = True
    need[nt * 128:] = rng.random(rows - nt * 128) < 0.5
    nzt = int(need[: nt * 128].reshape(nt, 128).any(1).sum())
    jn, jv, jp = jpc.gated_state_update(jnp.asarray(hit), jnp.asarray(vis),
                                        tuple(jnp.asarray(p) for p in planes), jnp.asarray(need))
    t = [torch.from_numpy(a.copy().view(np.int32)) for a in [hit, vis] + planes]
    nxt = tpc.gated_state_update_(t[0], t[1], tuple(t[2:]), torch.from_numpy(need), nzt)
    np.testing.assert_array_equal(u32(nxt), np.asarray(jn))
    np.testing.assert_array_equal(u32(t[1]), np.asarray(jv))
    for p, q in zip(t[2:], jp):
        np.testing.assert_array_equal(u32(p), np.asarray(q))


# --- the engines -------------------------------------------------------------

_jax_runs = {}


def jax_gated(name, engine, impl="xla"):
    key = (name, engine, impl)
    if key not in _jax_runs:
        jg = graphs(name)[0]
        kcap, thr = GRAPHS[name][1:]
        kw = dict(lanes=LANES, kcap=kcap, num_planes=8 if name == "path200" else PLANES,
                  pull_gate=True, expand_impl=impl, interpret=True)
        eng = JWide(jg, **kw) if engine == "wide" else JHybrid(jg, tile_thr=thr, **kw)
        res = eng.run(sources_of(name))
        _jax_runs[key] = (res, np.asarray(eng.last_gate_level_counts))
    return _jax_runs[key]


def port_engine(name, engine, gate):
    tg = graphs(name)[1]
    kcap, thr = GRAPHS[name][1:]
    kw = dict(lanes=LANES, kcap=kcap, num_planes=8 if name == "path200" else PLANES,
              pull_gate=gate, device="cpu")
    return (WidePackedMsBfsEngine(tg, **kw) if engine == "wide"
            else HybridMsBfsEngine(tg, tile_thr=thr, **kw))


ENGINE_CASES = [(n, e) for n in GRAPHS for e in ("wide", "hybrid")]


@pytest.mark.parametrize("name,engine", ENGINE_CASES)
def test_gated_engine_bit_identical_to_jax_gated(name, engine):
    want, want_counts = jax_gated(name, engine)
    eng = port_engine(name, engine, True)
    res = eng.run(sources_of(name))
    np.testing.assert_array_equal(u32(res._vis), np.asarray(want._vis))
    assert len(res._planes) == len(want._planes)
    for p, q in zip(res._planes, want._planes):
        np.testing.assert_array_equal(u32(p), np.asarray(q))
    np.testing.assert_array_equal(eng.last_gate_level_counts.numpy(), want_counts)
    assert res.num_levels == want.num_levels
    # One host read a level: the loop ran num_levels + 1 levels (the last
    # found an empty frontier); each level's state pass saw its unsettled
    # blocks.
    assert eng.last_host_syncs == len(eng.last_gate_active_blocks) == res.num_levels + 1
    nt = eng._table_rows // tpc.GATE_TILE
    assert all(0 <= b <= nt for b in eng.last_gate_active_blocks)


@pytest.mark.parametrize("name,engine", ENGINE_CASES)
def test_gated_engine_equals_ungated_on_extraction(name, engine):
    srcs = sources_of(name)
    res = port_engine(name, engine, True).run(srcs)
    plain = port_engine(name, engine, False).run(srcs)
    assert res.num_levels == plain.num_levels
    np.testing.assert_array_equal(res.reached, plain.reached)
    np.testing.assert_array_equal(res.edges_traversed, plain.edges_traversed)
    np.testing.assert_array_equal(res.ecc, plain.ecc)
    v = graphs(name)[1].num_vertices
    trees, ptrees = (np.empty((len(srcs), v), np.int32) for _ in range(2))
    res.parents_into(trees)
    plain.parents_into(ptrees)
    np.testing.assert_array_equal(trees, ptrees)
    for i in range(len(srcs)):
        np.testing.assert_array_equal(res.distances_int32(i), plain.distances_int32(i))


def test_gate_skips_real_work():
    # The gate is not dead code: the engines skip blocks in the expansion
    # (with the heavy section) and in the state pass, and the hybrid skips
    # residual blocks too.
    calls = []
    real = tpc.gated_state_update_

    def spy(hit, vis, planes, need, nzt):
        calls.append(nzt * tpc.GATE_DENSE_DEN <= vis.shape[0] // tpc.GATE_TILE)
        return real(hit, vis, planes, need, nzt)

    tpc.gated_state_update_ = spy
    try:
        for engine in ("wide", "hybrid"):
            eng = port_engine("rmat10", engine, True)
            eng.run(sources_of("rmat10"))
            assert eng.last_gate_level_counts.sum() > 0
    finally:
        tpc.gated_state_update_ = real
    assert any(calls) and not all(calls)  # both forms of the state pass ran
    plain = port_engine("rmat10", "wide", False)
    plain.run(sources_of("rmat10"))
    assert plain.last_gate_level_counts is None


def test_gated_hybrid_pallas_counts_equal_xla():
    want, counts = jax_gated("rmat10", "hybrid", "pallas")
    xla_res, xla_counts = jax_gated("rmat10", "hybrid")
    np.testing.assert_array_equal(counts, xla_counts)
    eng = port_engine("rmat10", "hybrid", True)
    eng.run(sources_of("rmat10"))
    np.testing.assert_array_equal(eng.last_gate_level_counts.numpy(), counts)


def test_narrow_lane_mask_skips_live_claims():
    # A star of 2000 leaves with a 100-vertex tail: lane 0 starts at the
    # hub and settles every leaf at level 1, lane 1 starts at the tail's
    # end and reaches them 100 levels later. A mask that misses lane 1
    # gates those rows out while lane 1 still needs them: the gate must key
    # on every seeded lane, and this case would show one it missed.
    leaves, tail = 2000, 100
    u = np.r_[np.zeros(leaves, np.int64), 0, np.arange(leaves + 1, leaves + tail)]
    v = np.r_[np.arange(1, leaves + 1), leaves + 1, np.arange(leaves + 2, leaves + tail + 1)]
    g = tio.from_edges(u, v, num_vertices=leaves + tail + 1)
    srcs = np.array([0, leaves + tail])

    def run():
        return WidePackedMsBfsEngine(g, lanes=32, kcap=4, num_planes=8, pull_gate=True,
                                     device="cpu").run(srcs)

    good = run()
    want = bfs_scipy(g, int(srcs[1]))
    np.testing.assert_array_equal(good.distances_int32(1), want)
    real = tpc.host_lane_mask

    def narrow(rows, act, w):
        m = real(rows, act, w)
        m[0] &= ~np.uint32(2)  # drop lane 1
        return m

    tpc.host_lane_mask = narrow
    try:
        bad = run()
    finally:
        tpc.host_lane_mask = real
    assert not np.array_equal(bad.distances_int32(1), want)


def test_stats_gated_tiles_equal_jax():
    name = "rmat10"
    want, counts = jax_gated(name, "wide")
    eng = port_engine(name, "wide", True)
    res = eng.run(sources_of(name))
    cut = eng.last_gate_level_counts.numpy()[: res.num_levels + 1]
    for i in (0, 5):
        got = tstats.level_stats(res.distances_int32(i), graphs(name)[1].degrees, gated_tiles=cut)
        exp = jstats.level_stats(want.distances_int32(i), graphs(name)[0].degrees,
                                 gated_tiles=counts[: want.num_levels + 1])
        assert got.json_lines() == exp.json_lines()
        assert all('"gated_tiles"' in ln for ln in got.json_lines())
    plain = tstats.level_stats(res.distances_int32(0), graphs(name)[1].degrees)
    assert all('"gated_tiles"' not in ln for ln in plain.json_lines())


@pytest.mark.parametrize("name", ["rmat10", "sparse"])
def test_gated_tiled_engine_equals_jax(name):
    jg, tg = graphs(name)
    srcs = [int(s) for s in sources_of(name, 3)]
    jeng = JTiled(jg, tile_thr=4, pull_gate=True)
    eng = TiledBfsEngine(tg, tile_thr=4, pull_gate=True, device="cpu")
    plain = TiledBfsEngine(tg, tile_thr=4, device="cpu")
    assert eng.num_tiles > 0
    for s in srcs:
        want, got, ref = jeng.run(s), eng.run(s), plain.run(s)
        np.testing.assert_array_equal(got.distance, want.distance)
        np.testing.assert_array_equal(got.parent, want.parent)
        np.testing.assert_array_equal(got.distance, ref.distance)
        np.testing.assert_array_equal(got.parent, ref.parent)
        assert got.reached == ref.reached and got.num_levels == ref.num_levels
        assert eng.last_gate_skipped_tiles == jeng.last_gate_skipped_tiles
        assert eng.last_host_syncs == plain.last_host_syncs
    assert plain.last_gate_skipped_tiles is None


def test_gated_tiled_pass_equals_dense_pass():
    from tpu_bfs_torch.algorithms.bfs_tiled import (
        make_gated_tiles_expand,
        make_tiles_expand,
        tiles_on,
    )

    tg = graphs("rmat10")[1]
    eng = TiledBfsEngine(tg, tile_thr=4, device="cpu")
    vt, nt = eng.vt, eng.num_tiles
    rng = np.random.default_rng(2)
    for frac in (0.001, 0.01, 0.5):
        fb = torch.from_numpy(rng.random((vt, 128)) < frac)
        visited = torch.from_numpy(rng.random(vt * 128) < 0.9)
        visited.view(vt, 128)[: vt // 2] = True  # wholly visited row tiles
        nz = int(tiles_on(vt, eng._col_t, eng._seg, fb, visited).sum())
        got, skipped = make_gated_tiles_expand(vt, nt)(eng._a, eng._col_t, eng._seg, fb,
                                                       visited, nz)
        dense = make_tiles_expand(vt)(eng._a, eng._col_t, eng._seg, fb)
        assert torch.equal(got & ~visited, dense & ~visited)
        assert skipped == (nt - nz if nz * tpc.GATE_DENSE_DEN <= nt else 0)
