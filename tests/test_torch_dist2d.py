"""The port's Dist2DBfsEngine against the JAX engine, bit for bit, on
meshes of 1x1, 1x2, 2x2 and 2x4 ranks, and the 2D partition under it.

For each mesh shape one gloo group of spawned ranks runs every case of
``torch_mesh_cases.DIST2D_CASES`` (the ring, allreduce and sparse row
exchanges, the scan, segment, scatter and dopt backends, the 64-vertex
line, an isolated source, a chained checkpoint, a level cap) while JAX
runs the same cases on make_mesh_2d(R, C) over the conftest's virtual
devices. On meshes of more than one row the mesh rows may pick different
sparse rungs at one level; JAX's engine then deadlocks on the virtual
devices, so that case is held to JAX's ring results and to the byte model
of a JAX sparse engine that is built but not run. Checkpoints cross
between the 1D and 2D engines, BfsEngine and the JAX package.
"""

import dataclasses

import numpy as np
import pytest

from tpu_bfs.graph import generate as jgen
from tpu_bfs.graph import io as jio
from tpu_bfs.parallel import partition2d as jpart2d
from tpu_bfs.parallel.dist_bfs import DistBfsEngine as JDistBfsEngine
from tpu_bfs.parallel.dist_bfs import make_mesh
from tpu_bfs.parallel.dist_bfs2d import Dist2DBfsEngine as JDist2DBfsEngine
from tpu_bfs.parallel.dist_bfs2d import make_mesh_2d
from tpu_bfs.utils.checkpoint import load_checkpoint as jload_checkpoint

import torch_mesh_cases as cases
from tpu_bfs_torch.algorithms.bfs import BfsEngine
from tpu_bfs_torch.graph import generate as tgen
from tpu_bfs_torch.graph import io as tio
from tpu_bfs_torch.parallel import partition2d as tpart2d
from tpu_bfs_torch.parallel.mesh import launch, start

from torch_threads import cap_torch_threads

cap_torch_threads()

CASES = {c[0]: c for c in cases.DIST2D_CASES}
#: The case whose mesh rows may split on rungs (see the module docstring).
SPLIT = "sparse_rungs"


def jax_records(shape) -> dict:
    """JAX's records of every case on make_mesh_2d(*shape); with rows > 1,
    the split case's byte model (labels and bytes a level) instead."""
    out = {}
    for name, case in CASES.items():
        g = cases.graph_of(case[1], jgen, jio)
        if name == SPLIT and shape[0] > 1:
            eng = JDist2DBfsEngine(g, make_mesh_2d(*shape), **case[2])
            out["model"] = (eng.exchange_branch_labels(), list(eng.wire_bytes_per_level()))
            continue
        out[name], _ = cases.dist_case_record(
            case, g, lambda g, **kw: JDist2DBfsEngine(g, make_mesh_2d(*shape), **kw))
    return out


@pytest.fixture(scope="module", params=cases.DIST2D_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def mesh_runs(request):
    """(shape, port records with host syncs, JAX records)."""
    shape = request.param
    group = start(shape[0] * shape[1], cases.run_dist_cases, shape, cases.DIST2D_CASES,
                  device="cpu")
    jax = jax_records(shape)
    return shape, group.result(), jax


@pytest.mark.parametrize("name", list(CASES))
def test_dist2d_equals_jax(mesh_runs, name):
    shape, port, jax = mesh_runs
    rec = port[name][0]
    where = f"{shape[0]}x{shape[1]} {name}"
    if name in jax:
        cases.assert_same(rec, jax[name], where)
        return
    # Rows may split: JAX's ring results, its sparse engine's byte model,
    # and counts that cover every level and price as that model says.
    labels, per_level = jax["model"]
    ring = jax["ring"]
    for key, value in rec.items():
        field, s = key.rsplit("_", 1)
        if field == "labels":
            assert value == labels, where
        elif field == "per_level":
            assert value == per_level, where
        elif field == "counts":
            assert value.sum() == rec[f"levels_{s}"] + 1, where
        elif field == "bytes":
            assert value == float(np.dot(rec[f"counts_{s}"], per_level)), where
        else:
            np.testing.assert_array_equal(value, ring[key], err_msg=f"{where} {key}")


def test_dist2d_records_are_informative(mesh_runs):
    # Every rung and the dense fallback run on a mesh with a row exchange;
    # one host read a level, plus the rung's where mesh rows have peers.
    (rows, cols), port, _ = mesh_runs
    rec, syncs = port[SPLIT]
    s = int(cases.sources_of(CASES[SPLIT][3], cases.graph_of("rmat_small", tgen, tio))[-1])
    counts = rec[f"counts_{s}"]
    assert syncs == counts.sum() * (2 if cols > 1 else 1)
    assert (counts > 0).sum() >= (3 if cols > 1 else 1)
    assert port["dopt_line"][0]["levels_0"] == 63
    assert port["ring"][1] == port["ring"][0][f"counts_{s}"].sum()
    iso = port["disconnected"][0]
    assert min(iso[k] for k in iso if k.startswith("reached_")) == 1


@pytest.mark.parametrize("shape", [(1, 1), (2, 3), (2, 4), (4, 2)])
@pytest.mark.parametrize("gname", ["random_small", "rmat_small", "random_disconnected"])
def test_partition_2d_equals_jax(gname, shape):
    ours = tpart2d.partition_2d(cases.graph_of(gname, tgen, tio), *shape)
    theirs = jpart2d.partition_2d(cases.graph_of(gname, jgen, jio), *shape)
    assert (ours[0].rows, ours[0].cols, dataclasses.asdict(ours[0].base)) == (
        theirs[0].rows, theirs[0].cols, dataclasses.asdict(theirs[0].base))
    assert ours[0].ep2 == theirs[1].shape[2]
    for a, b in zip(ours[1:], theirs[1:]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tpart2d.out_csr_2d(ours[0], ours[1], ours[2]),
                    jpart2d.out_csr_2d(theirs[0], theirs[1], theirs[2])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_checkpoint_crosses_1d_2d_and_packages(shape, tmp_path):
    # A port 1D checkpoint finishes on a 2D mesh over the same ranks, a 2D
    # one back on the 1D engine, and the saved port file on JAX's 1D and
    # 2D engines; every tree is BfsEngine's.
    path = str(tmp_path / "ck.npz")
    got = launch(shape[0] * shape[1], cases.ckpt_cross_rank, shape, path, device="cpu")
    want = BfsEngine(cases.graph_of("rmat_small", tgen, tio), device="cpu").run(3)
    g = cases.graph_of("rmat_small", jgen, jio)
    jck = jload_checkpoint(path)
    assert got["level"] == jck.level == 2
    runs = [(got["dist"], got["parent"]), (got["back_dist"], got["back_parent"])]
    for jeng in (JDistBfsEngine(g, make_mesh(2)), JDist2DBfsEngine(g, make_mesh_2d(*shape))):
        res = jeng.finish(jeng.advance(jck))
        runs.append((res.distance, res.parent))
    for dist, parent in runs:
        np.testing.assert_array_equal(dist, want.distance)
        np.testing.assert_array_equal(parent, want.parent)
