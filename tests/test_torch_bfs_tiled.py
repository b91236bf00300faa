"""The port's TiledBfsEngine (single-source, dense-tile bitset pass) against
tpu_bfs's, exactly.

The same seeded graphs and sources on both sides (the port on
device="cpu"): distances, parents, reached, num_levels and edges_traversed
equal, at the default tile threshold and at one low enough that most edges
sit in dense tiles. ``make_tiles_expand`` equals JAX's on the engine's own
tiles. The pull gate and checkpoint entry points are not ported and raise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_bfs.algorithms.bfs_tiled import TiledBfsEngine as JTiled
from tpu_bfs.algorithms.bfs_tiled import make_tiles_expand as jmake

from tpu_bfs_torch.algorithms.bfs_tiled import TiledBfsEngine, make_tiles_expand
from tpu_bfs_torch.reference import bfs_python
from torch_bfs_cases import NAMES, assert_same_result, graphs, sources

from torch_threads import cap_torch_threads

cap_torch_threads()


@pytest.mark.parametrize("tile_thr", [32, 2])
@pytest.mark.parametrize("name", NAMES)
def test_tiled_engine_equals_jax(name, tile_thr):
    jg, tg = graphs(name)
    jeng = JTiled(jg, tile_thr=tile_thr)
    teng = TiledBfsEngine(tg, tile_thr=tile_thr, device="cpu")
    assert (teng.num_tiles, teng.num_dense_edges) == (jeng.num_tiles, jeng.num_dense_edges)
    assert teng.dopt_caps == jeng.dopt_caps
    for s in sources(tg):
        want = jeng.run(int(s))
        got = teng.run(int(s))
        assert_same_result(got, want)
        np.testing.assert_array_equal(got.distance, bfs_python(tg, int(s))[0])


def test_tiles_carry_the_dense_levels():
    # Most edges tiled and a one-rung ladder too small for the hub's level:
    # the tile pass runs, and the result still equals the oracle and JAX.
    jg, tg = graphs("rmat12")
    teng = TiledBfsEngine(tg, tile_thr=2, dopt_caps=(1024,), device="cpu")
    assert teng.num_dense_edges > tg.num_edges // 2
    hub = int(np.argmax(tg.degrees))
    got = teng.run(hub, max_levels=None)
    assert_same_result(got, JTiled(jg, tile_thr=2, dopt_caps=(1024,)).run(hub))
    assert teng.last_host_syncs == got.num_levels + 1


@pytest.mark.parametrize("name", ["rmat10", "directed"])
def test_make_tiles_expand_equals_jax(name):
    jg, tg = graphs(name)
    teng = TiledBfsEngine(tg, tile_thr=2, device="cpu")
    jeng = JTiled(jg, tile_thr=2)
    rng = np.random.default_rng(6)
    fb = rng.random((teng.vt, 128)) < 0.1
    got = make_tiles_expand(teng.vt)(teng._a, teng._col_t, teng._seg, torch.from_numpy(fb))
    want = jmake(jeng.vt)(jeng._a, jeng._col_t, jeng._seg, jnp.asarray(fb))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_time_it_max_levels_and_errors():
    jg, tg = graphs("path200")
    teng = TiledBfsEngine(tg, device="cpu")
    r = teng.run(0, time_it=True, max_levels=50)
    assert r.elapsed_s > 0 and r.num_levels == 50
    assert_same_result(r, JTiled(jg).run(0, max_levels=50))
    with pytest.raises(ValueError, match="out of range"):
        teng.run(tg.num_vertices)
    # The gate and the checkpoint entry points, ported: a cut run through
    # start/advance equals the cut run.
    gated = TiledBfsEngine(tg, pull_gate=True, device="cpu")
    assert gated.pull_gate and gated.last_gate_skipped_tiles is None
    st = teng.advance(teng.start(0), 50)
    assert st.level == 50 and not st.done
    np.testing.assert_array_equal(teng.finish(st).distance, r.distance)
    with pytest.raises(ValueError, match="out of range"):
        teng.start(tg.num_vertices)
