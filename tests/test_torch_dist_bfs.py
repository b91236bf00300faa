"""The port's DistBfsEngine against the JAX engine, bit for bit, on meshes
of 1, 2, 4 and 8 ranks, and the 1D partition and exchanges under it.

For each mesh size one gloo group of spawned ranks runs every case of
``torch_mesh_cases.DIST_CASES`` (the ring, allreduce and sparse exchanges,
small cap ladders that run every rung and the dense fallback, the scan,
segment, scatter and dopt backends, the 64-vertex line, a disconnected
graph from an isolated source, a chained checkpoint and a level cap),
while JAX runs the same cases on make_mesh(P) over the conftest's virtual
devices: distances, parents, levels, reached and traversed counts,
per-branch level counts, modeled bytes and branch labels must be equal.
"""

import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from tpu_bfs.algorithms.bfs import BfsEngine as JBfsEngine
from tpu_bfs.graph import generate as jgen
from tpu_bfs.graph import io as jio
from tpu_bfs.parallel import collectives as jcoll
from tpu_bfs.parallel import partition as jpart
from tpu_bfs.parallel.compat import shard_map
from tpu_bfs.parallel.dist_bfs import DistBfsEngine as JDistBfsEngine
from tpu_bfs.parallel.dist_bfs import make_mesh
from tpu_bfs.utils.checkpoint import BfsCheckpoint as JCheckpoint

import torch_mesh_cases as cases
from tpu_bfs_torch.algorithms.bfs import BfsEngine
from tpu_bfs_torch.graph import generate as tgen
from tpu_bfs_torch.graph import io as tio
from tpu_bfs_torch.parallel import collectives as tcoll
from tpu_bfs_torch.parallel import partition as tpart
from tpu_bfs_torch.parallel.mesh import launch, start
from tpu_bfs_torch.utils.checkpoint import BfsCheckpoint

CASES = {c[0]: c for c in cases.DIST_CASES}


def jax_case(p, case) -> dict:
    """The JAX engine's record of one case on make_mesh(p)."""
    rec, _ = cases.dist_case_record(case, cases.graph_of(case[1], jgen, jio),
                                    lambda g, **kw: JDistBfsEngine(g, make_mesh(p), **kw))
    return rec


@pytest.fixture(scope="module", params=cases.DIST_MESHES, ids=lambda p: f"P{p}")
def mesh_runs(request):
    """(P, port records with host syncs, JAX records): the port's ranks run
    while JAX computes."""
    p = request.param
    group = start(p, cases.run_dist_cases, p, cases.DIST_CASES, device="cpu")
    jax = {name: jax_case(p, case) for name, case in CASES.items()}
    return p, group.result(), jax


@pytest.mark.parametrize("name", list(CASES))
def test_dist_bfs_equals_jax(mesh_runs, name):
    p, port, jax = mesh_runs
    cases.assert_same(port[name][0], jax[name], f"P={p} {name}")


def test_dist_bfs_records_are_informative(mesh_runs):
    # The cases reach what they are there for: every rung and the dense
    # fallback on a mesh, one-vertex frontiers 63 levels deep, an isolated
    # source, the level cap; and the host reads a level: one, plus the
    # rung's on a sparse mesh.
    p, port, _ = mesh_runs
    rec, syncs = port["sparse_rungs"]
    s = int(cases.sources_of(CASES["sparse_rungs"][3],
                             cases.graph_of("rmat_small", tgen, tio))[-1])
    counts = rec[f"counts_{s}"]
    assert rec[f"labels_{s}"] == ["sparse[1]", "sparse[8]", "sparse[64]", "dense"]
    assert syncs == counts.sum() * (2 if p > 1 else 1)
    assert (counts > 0).sum() >= (3 if p > 1 else 1)
    assert port["ring"][1] == port["ring"][0]["counts_499"].sum()
    assert port["dopt_sparse_line"][0]["levels_0"] == 63
    iso = port["segment_disconnected"][0]
    assert min(iso[k] for k in iso if k.startswith("reached_")) == 1
    assert port["cap"][0]["levels_0"] == 3 and port["cap"][0]["counts_0"].sum() == 3


@pytest.mark.parametrize("p", [1, 3, 4, 8])
@pytest.mark.parametrize("gname", ["random_small", "rmat_small", "random_disconnected"])
def test_partition_1d_equals_jax(gname, p):
    ours = tpart.partition_1d(cases.graph_of(gname, tgen, tio), p)
    theirs = jpart.partition_1d(cases.graph_of(gname, jgen, jio), p)
    for f in ("num_devices", "num_vertices", "cpk", "vloc", "ep_chip"):
        assert getattr(ours[0], f) == getattr(theirs[0], f), f
    for a, b in zip(ours[1:], theirs[1:]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tpart.out_csr_1d(ours[0], ours[1], ours[2]),
                    jpart.out_csr_1d(theirs[0], theirs[1], theirs[2])):
        np.testing.assert_array_equal(a, b)
    pids = ours[0].to_padded(np.arange(ours[0].num_vertices))
    np.testing.assert_array_equal(pids, theirs[0].to_padded(np.arange(ours[0].num_vertices)))
    np.testing.assert_array_equal(ours[0].from_padded(pids), np.arange(ours[0].num_vertices))


def _jax_collectives(p, n, caps, seed):
    """JAX's exchanges on the inputs of ``cases.collectives_rank``."""
    bools, ints = cases.collectives_inputs(p, n, seed)
    mesh = make_mesh(p)

    def local(xb, xi):
        xb, xi = xb[0], xi[0]
        hit, branch = jcoll.sparse_exchange_or(xb, "v", p, caps=caps)
        return (hit, branch[None],
                jcoll.reduce_scatter_or(xb, "v", p, impl="ring"),
                jcoll.reduce_scatter_or(xb, "v", p, impl="allreduce"),
                jcoll.reduce_scatter_min(xi, "v", p, impl="ring"),
                jcoll.reduce_scatter_min(xi, "v", p, impl="allreduce"))

    fn = shard_map(local, mesh=mesh, in_specs=(P("v", None), P("v", None)),
                   out_specs=(P("v"),) * 6, check_vma=False)
    out = {}
    for d, xb in bools.items():
        hit, br, ring, allr, mr, ma = (np.asarray(a) for a in fn(xb, ints))
        out.update({f"sparse_{d}": hit, f"branch_{d}": int(br[0]), f"ring_{d}": ring,
                    f"allreduce_{d}": allr})
        out["min_ring"], out["min_allreduce"] = mr, ma
    return out


@pytest.mark.parametrize("p", [2, 4])
def test_exchanges_equal_jax(p):
    # The OR exchanges at three densities (the sparse one on its id rungs
    # and its dense fallback) and the MIN merge, rank for rank.
    n, caps, seed = 300, (4, 64), 11
    port = launch(p, cases.collectives_rank, n, caps, seed, device="cpu")
    jax = _jax_collectives(p, n, caps, seed)
    assert port.keys() == jax.keys()
    for key, want in jax.items():
        np.testing.assert_array_equal(port[key], want, err_msg=key)
    assert {port[f"branch_{d}"] for d in (0.002, 0.05, 0.5)} == {0, 1, 2}


@pytest.mark.parametrize("p,n", [(1, 7), (2, 2048), (8, 1024), (8, 4096)])
def test_exchange_models_equal_jax(p, n):
    caps = tcoll.default_sparse_caps(n)
    assert caps == jcoll.default_sparse_caps(n)
    for impl in ("ring", "allreduce"):
        assert tcoll.dense_or_wire_bytes(p, n, impl) == jcoll.dense_or_wire_bytes(p, n, impl)
        assert tcoll.dense_2d_wire_bytes(p, 3, n, impl) == jcoll.dense_2d_wire_bytes(
            p, 3, n, impl)
    assert tcoll.sparse_wire_bytes_per_level(p, n, caps) == (
        jcoll.sparse_wire_bytes_per_level(p, n, caps))
    assert tcoll.column_gather_wire_bytes(p, n) == jcoll.column_gather_wire_bytes(p, n)


def test_dist_engines_refuse_bad_arguments_before_any_work():
    from tpu_bfs_torch.parallel.dist_bfs import DistBfsEngine
    from tpu_bfs_torch.parallel.dist_bfs2d import Dist2DBfsEngine

    g = cases.graph_of("line64", tgen, tio)
    with pytest.raises(ValueError, match="unknown exchange 'sprase'; have"):
        DistBfsEngine(g, exchange="sprase", device="cpu")
    with pytest.raises(ValueError, match="unknown exchange 'sliced' for the 2D engine"):
        Dist2DBfsEngine(g, exchange="sliced", device="cpu")
    with pytest.raises(KeyError, match="unknown expansion backend 'delta'"):
        DistBfsEngine(g, backend="delta", device="cpu")


def test_dist_checkpoint_crosses_engines_and_packages(mesh_runs):
    # The port mesh's level-2 checkpoint finishes on the port's and JAX's
    # BfsEngine, and JAX's mesh checkpoint on the port's, each with the
    # mesh's distances and trees.
    p, port, jax = mesh_runs
    rec, jrec = port["ckpt_sparse"][0], jax["ckpt_sparse"]
    g_t = cases.graph_of("rmat_small", tgen, tio)
    g_j = cases.graph_of("rmat_small", jgen, jio)
    teng, jeng = BfsEngine(g_t, device="cpu"), JBfsEngine(g_j)
    for done in (teng.finish(teng.advance(BfsCheckpoint(**rec["ckpt2_3"]))),
                 jeng.finish(jeng.advance(JCheckpoint(**rec["ckpt2_3"]))),
                 teng.finish(teng.advance(BfsCheckpoint(**jrec["ckpt2_3"])))):
        np.testing.assert_array_equal(done.distance, rec["dist_3"])
        np.testing.assert_array_equal(done.parent, rec["parent_3"])
    assert rec["ckpt2_3"]["level"] == 2 and rec["counts_3"].sum() == rec["levels_3"] + 1


def test_spawned_dist_ranks_import_no_jax():
    # Two ranks build and run both single-source mesh engines (with the
    # planner), DistSsspEngine and the kinds on the mesh wide engine without
    # importing JAX or the JAX package, though this process has both.
    assert launch(2, cases.dist_loaded_modules, device="cpu") == []


def test_dist_entry_points_need_cuda_unless_the_cpu_is_named():
    # No entry point of the single-source mesh falls back to the CPU: on a
    # host without a card, the engines, the CLI and Graph500 raise unless
    # device='cpu' is given.
    import torch

    from tpu_bfs_torch import cli, graph500
    from tpu_bfs_torch.parallel.dist_bfs import DistBfsEngine
    from tpu_bfs_torch.parallel.dist_bfs2d import Dist2DBfsEngine

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    g = cases.graph_of("line64", tgen, tio)
    for make in (lambda: DistBfsEngine(g), lambda: Dist2DBfsEngine(g),
                 lambda: graph500.run_graph500(8, 4, num_searches=2, devices=2),
                 lambda: graph500.run_graph500(8, 4, num_searches=2, mesh2d=(1, 2)),
                 lambda: cli.main(["0", "rmat:scale=8", "--mesh", "1x2", "--skip-cpu"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
