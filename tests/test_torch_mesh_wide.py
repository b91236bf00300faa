"""The port's DistWideMsBfsEngine against the JAX engine, bit for bit, on
meshes of 1, 2, 4 and 8 ranks, and the mesh machinery under it.

For each mesh size one gloo group of spawned ranks runs every case of
``torch_mesh_cases.WIDE_CASES`` (the dense and sparse exchanges, heavy
shards, isolated and disconnected sources, the 64-vertex line at the plane
cap, 8192 lanes, a chained sparse checkpoint), while JAX runs the same
cases on make_mesh(P) over the conftest's virtual devices. Also: the
sharded ELL build, the collectives' host models against JAX's, checkpoints
across the mesh and single-device engines, and the launcher's refusals.
"""

import numpy as np
import pytest

from tpu_bfs.algorithms.msbfs_wide import WidePackedMsBfsEngine as JWide
from tpu_bfs.graph import generate as jgen
from tpu_bfs.graph import io as jio
from tpu_bfs.graph.ell import build_ell_sharded as jbuild_sharded
from tpu_bfs.parallel import collectives as jcoll
from tpu_bfs.parallel.dist_bfs import make_mesh
from tpu_bfs.parallel.dist_msbfs_wide import DistWideMsBfsEngine as JDistWide
from tpu_bfs.utils.checkpoint import PackedCheckpoint as JCheckpoint

import torch_mesh_cases as cases
from tpu_bfs_torch.algorithms.msbfs_wide import WidePackedMsBfsEngine
from tpu_bfs_torch.graph import generate as tgen
from tpu_bfs_torch.graph import io as tio
from tpu_bfs_torch.graph.ell import build_ell_sharded
from tpu_bfs_torch.parallel import collectives as tcoll
from tpu_bfs_torch.parallel.mesh import launch, start
from tpu_bfs_torch.utils.checkpoint import PackedCheckpoint

MESH_SIZES = [1, 2, 4, 8]
CASES = {c[0]: c for c in cases.WIDE_CASES}


def jax_case(p, case) -> dict:
    """The JAX engine's record of one case on make_mesh(p)."""
    return cases.case_record(case, cases.graph_of(case[1], jgen, jio),
                             lambda x, **kw: JDistWide(x, make_mesh(p), **kw), None, p,
                             lambda eng, t: np.asarray(t))


@pytest.fixture(scope="module", params=MESH_SIZES, ids=lambda p: f"P{p}")
def mesh_runs(request):
    """(P, port records, JAX records) of every case: the port's ranks run
    while JAX computes."""
    p = request.param
    group = start(p, cases.run_cases, "wide", cases.WIDE_CASES, device="cpu")
    jax = {name: jax_case(p, case) for name, case in CASES.items()}
    return p, group.result(), jax


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_wide_equals_jax(mesh_runs, name):
    p, port, jax = mesh_runs
    cases.assert_same(port[name], jax[name], f"P={p} {name}")


def test_mesh_wide_records_are_informative(mesh_runs):
    _p, port, _ = mesh_runs
    assert port["deep_truncated"]["truncated"] and port["deep_at_cap"]["levels"] == 32
    assert port["deep_at_cap"]["ecc"][0] == 32
    assert port["sparse"]["counts"][:-1].sum() >= 1
    assert port["ckpt_sparse"]["counts"].sum() == port["ckpt_sparse"]["ckpt_end"]["level"]
    assert port["disconnected"]["reached"][0] == 1
    assert port["lanes8192"]["dist"].shape[0] == len(cases.PICKS)


def test_mesh_wide_checkpoint_crosses_single_device(mesh_runs):
    # The port mesh's level-2 checkpoint finishes on JAX's single-chip wide
    # engine, and JAX's mesh checkpoint on the port's, each with the mesh's
    # distances.
    _p, port, jax = mesh_runs
    _name, gname, kw, src_spec, _mode = CASES["ckpt_sparse"]
    n = len(cases.sources_of(src_spec, cases.graph_of(gname, tgen, tio)))
    jeng = JWide(cases.graph_of(gname, jgen, jio), lanes=kw["lanes"], num_planes=5)
    res = jeng.finish(jeng.advance(JCheckpoint(**port["ckpt_sparse"]["ckpt2"])))
    teng = WidePackedMsBfsEngine(cases.graph_of(gname, tgen, tio), lanes=kw["lanes"],
                                 num_planes=5, device="cpu")
    tres = teng.finish(teng.advance(PackedCheckpoint(**jax["ckpt_sparse"]["ckpt2"])))
    for i in range(n):
        np.testing.assert_array_equal(res.distances_int32(i), port["ckpt_sparse"]["dist"][i])
        np.testing.assert_array_equal(tres.distances_int32(i), jax["ckpt_sparse"]["dist"][i])


@pytest.mark.parametrize("p", [1, 3, 4, 8])
@pytest.mark.parametrize("gname,kcap", [("rmat_small", 8), ("random_disconnected", 64)])
def test_build_ell_sharded_equals_jax(gname, kcap, p):
    ours = build_ell_sharded(cases.graph_of(gname, tgen, tio), p, kcap=kcap)
    theirs = jbuild_sharded(cases.graph_of(gname, jgen, jio), p, kcap=kcap)
    for f in ("num_vertices", "num_edges", "undirected", "kcap", "num_shards", "v_loc",
              "heavy_per_shard", "num_virtual", "m2", "fold_steps", "tail_rows"):
        assert getattr(ours, f) == getattr(theirs, f), f
    for f in ("old_of_new", "rank", "in_degree", "virtual", "fold_pad_map", "heavy_pick"):
        a, b = getattr(ours, f), getattr(theirs, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert [k for k, _ in ours.light] == [k for k, _ in theirs.light]
    for (_, a), (_, b) in zip(ours.light, theirs.light):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("p", [1, 2, 8])
@pytest.mark.parametrize("rows_loc,w", [(7, 1), (512, 2), (4096, 128)])
def test_row_gather_models_equal_jax(p, rows_loc, w):
    caps = tcoll.default_row_gather_caps(rows_loc, w)
    assert caps == jcoll.default_row_gather_caps(rows_loc, w)
    assert tcoll.rows_gather_branch_labels(caps) == jcoll.rows_gather_branch_labels(caps, ())
    assert tcoll.sparse_rows_wire_bytes_per_level(p, rows_loc, w, caps) == (
        jcoll.sparse_rows_wire_bytes_per_level(p, rows_loc, w, caps))
    assert tcoll.dense_rows_wire_bytes(p, rows_loc, w) == jcoll.dense_rows_wire_bytes(
        p, rows_loc, w)
    ladder = tcoll.normalize_caps(caps + (caps[0],))
    assert ladder == jcoll.normalize_caps(caps + (caps[0],))
    for biggest in (0, caps[0], caps[0] + 1, caps[-1], caps[-1] + 1):
        want = next((i for i, c in enumerate(ladder) if biggest <= c), len(ladder))
        assert tcoll.cap_ladder_select(biggest, caps) == want


def test_exchange_chain_merges_like_jax():
    prev = np.array([1, 2, 0], np.int32)
    now = np.array([0, 1, 1], np.int32)
    for level, nonce_prev, nonce in ((3, 7, 7), (3, 7, 8), (2, 7, 7), (0, None, None)):
        a = tcoll.merge_exchange_counts(
            tcoll.chained_prev_counts(prev, level, nonce_prev, nonce), now, level)
        b = jcoll.merge_exchange_counts(
            jcoll.chained_prev_counts(prev, level, nonce_prev, nonce), now, level)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cap", [2, 3])
def test_sparse_rows_gather_drops_the_fill_slots(cap):
    # Every rank's nonzero rows land at their global ids; the fill slots
    # (cap 3 > 2 rows) go to the extra last row, which stays zero.
    count, table = launch(3, cases.sparse_gather_rank, cap, device="cpu")
    assert count == 2 and table.shape == (19, 2)
    want = np.zeros((19, 2), np.int32)
    for r in range(3):
        want[(r % 6) * 3 + r] = [r + 1, -1]
        want[5 * 3 + r] = r + 10
    np.testing.assert_array_equal(table, want)


def test_launch_reports_a_failed_rank():
    with pytest.raises(RuntimeError, match="rank one fails"):
        launch(2, cases.fail_on_rank_one, device="cpu")


def test_mesh_needs_cuda_unless_the_cpu_is_named():
    import torch

    from tpu_bfs_torch.parallel.dist_msbfs_wide import DistWideMsBfsEngine

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch(2, cases.fail_on_rank_one)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistWideMsBfsEngine(cases.graph_of("line64", tgen, tio))


def test_spawned_ranks_import_no_jax():
    # This process imported JAX; the ranks it spawns must not.
    assert launch(2, cases.loaded_modules, device="cpu") == []


def test_no_rank_exits_before_its_peers_finish(tmp_path):
    # Rank 0 does no collective work and rank 1 works 1.5 s longer; rank 0
    # still leaves only after rank 1 is done, so a slow rank's group
    # never loses a peer while it is still joining (a gloo rank whose
    # peer has exited fails in init_process_group).
    assert launch(2, cases.exit_after_peers, str(tmp_path), device="cpu") == 0
    done = float((tmp_path / "rank1_done").read_text())
    assert float((tmp_path / "rank0_exit").read_text()) >= done
