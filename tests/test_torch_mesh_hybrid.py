"""The port's DistHybridMsBfsEngine against the JAX engine, bit for bit, on
meshes of 1, 2, 4 and 8 ranks.

For each mesh size one gloo group of spawned ranks runs every case of
``torch_mesh_cases.HYBRID_CASES`` (the gather layout, its dense and sparse
exchanges, gated and not, heavy rows, isolated and disconnected sources,
the 64-vertex line at the plane cap, chained checkpoints, the
prebuilt-dict and layout checks), while JAX runs the same cases on
make_mesh(P) over the conftest's virtual devices. Checkpoints cross
between the mesh and the single-device engines of both packages, and the
host build functions agree array for array. The ring-sliced layout's cases are
in tests/test_torch_mesh_sliced.py.
"""

import dataclasses

import numpy as np
import pytest

from tpu_bfs.algorithms.msbfs_hybrid import HybridMsBfsEngine as JHybrid
from tpu_bfs.graph import generate as jgen
from tpu_bfs.graph import io as jio
from tpu_bfs.parallel.dist_bfs import make_mesh
from tpu_bfs.parallel.dist_msbfs_hybrid import DistHybridMsBfsEngine as JDistHybrid
from tpu_bfs.parallel.dist_msbfs_hybrid import build_dist_hybrid as jbuild
from tpu_bfs.utils.checkpoint import PackedCheckpoint as JCheckpoint

import torch_mesh_cases as cases
from tpu_bfs_torch.algorithms.msbfs_hybrid import HybridMsBfsEngine
from tpu_bfs_torch.graph import generate as tgen
from tpu_bfs_torch.graph import io as tio
from tpu_bfs_torch.parallel.dist_msbfs_hybrid import build_dist_hybrid
from tpu_bfs_torch.parallel.mesh import start
from tpu_bfs_torch.utils.checkpoint import PackedCheckpoint

MESH_SIZES = [1, 2, 4, 8]
CASES = {c[0]: c for c in cases.HYBRID_CASES}


def jax_case(p, case) -> dict:
    """The JAX engine's record of one case on make_mesh(p)."""
    return cases.case_record(case, cases.graph_of(case[1], jgen, jio),
                             lambda x, **kw: JDistHybrid(x, make_mesh(p), **kw), jbuild, p,
                             lambda eng, t: np.asarray(t))


@pytest.fixture(scope="module", params=MESH_SIZES, ids=lambda p: f"P{p}")
def mesh_runs(request):
    """(P, port records, JAX records) of every case: the port's ranks run
    while JAX computes."""
    p = request.param
    group = start(p, cases.run_cases, "hybrid", cases.HYBRID_CASES, device="cpu")
    jax = {name: jax_case(p, case) for name, case in CASES.items()}
    return p, group.result(), jax


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_hybrid_equals_jax(mesh_runs, name):
    p, port, jax = mesh_runs
    cases.assert_same(port[name], jax[name], f"P={p} {name}")


def test_mesh_hybrid_records_are_informative(mesh_runs):
    # The cases reach what they are there for: truncation at the cap, an
    # eccentricity exactly at the cap, sparse rungs, gate skips, rejects.
    p, port, _ = mesh_runs
    assert port["deep_truncated"]["truncated"] and port["deep_at_cap"]["levels"] == 32
    assert port["sparse"]["labels"][-1] == "dense"
    assert port["sparse"]["counts"][:-1].sum() >= 1
    assert port["heavy_gated"]["gate"].sum() > 0
    assert "needs 'sliced'" in port["reject"]["layout"]
    assert f"mesh has {p}" in port["reject"]["shards"]
    assert (port["disconnected_sparse_gated"]["reached"][0] == 1
            and port["disconnected_sparse_gated"]["edges"][0] == 0)


def _jax_ckpt(fields):
    return JCheckpoint(**fields)


def _port_ckpt(fields):
    return PackedCheckpoint(**fields)


def test_mesh_checkpoint_resumes_on_jax_single_chip(mesh_runs):
    # A level-2 checkpoint of the port's mesh finishes on JAX's single-chip
    # hybrid with the mesh's own distances and counts.
    _p, port, _ = mesh_runs
    _name, gname, kw, src_spec, _mode = CASES["ckpt_sparse"]
    rec = port["ckpt_sparse"]
    g = cases.graph_of(gname, jgen, jio)
    eng = JHybrid(g, lanes=4096, num_planes=5, tile_thr=kw["tile_thr"], interpret=True)
    res = eng.finish(eng.advance(_jax_ckpt(rec["ckpt2"])))
    for i in range(len(cases.sources_of(src_spec, g))):
        np.testing.assert_array_equal(res.distances_int32(i), rec["dist"][i])
    np.testing.assert_array_equal(res.reached, rec["reached"])
    np.testing.assert_array_equal(res.edges_traversed, rec["edges"])


def test_jax_mesh_checkpoint_resumes_on_port_single_device(mesh_runs):
    # And the reverse: JAX's mesh checkpoint finishes on the port's
    # single-device hybrid with JAX's mesh distances.
    _p, _port, jax = mesh_runs
    _name, gname, kw, src_spec, _mode = CASES["ckpt_sparse"]
    rec = jax["ckpt_sparse"]
    g = cases.graph_of(gname, tgen, tio)
    eng = HybridMsBfsEngine(g, lanes=4096, num_planes=5, tile_thr=kw["tile_thr"],
                            device="cpu")
    res = eng.finish(eng.advance(_port_ckpt(rec["ckpt2"])))
    for i in range(len(cases.sources_of(src_spec, g))):
        np.testing.assert_array_equal(res.distances_int32(i), rec["dist"][i])
    np.testing.assert_array_equal(res.reached, rec["reached"])


@pytest.mark.parametrize("layout", ["gather", "sliced"])
@pytest.mark.parametrize("p", [1, 3, 4])
def test_build_dist_hybrid_equals_jax(p, layout):
    # The host build functions, array for array: heavy rows (kcap 8) beside dense
    # tiles, at mesh sizes that do and do not divide the tile count.
    tg = cases.graph_of("rmat_small", tgen, tio)
    jg = cases.graph_of("rmat_small", jgen, jio)
    ours = build_dist_hybrid(tg, p, kcap=8, tile_thr=300, layout=layout)
    theirs = jbuild(jg, p, kcap=8, tile_thr=300, layout=layout)
    assert ours.keys() == theirs.keys()
    assert ours["res_spec"].heavy and ours["num_tiles"] > 0
    for key, a in ours.items():
        b = theirs[key]
        if key == "res_spec":
            assert tuple(a) == tuple(b)
        elif key == "res_arrs":
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=key)


def test_ckpt_fields_cover_both_packages():
    # The checkpoint conversion above moves every field.
    assert [f.name for f in dataclasses.fields(JCheckpoint)] == [
        f.name for f in dataclasses.fields(PackedCheckpoint)]
