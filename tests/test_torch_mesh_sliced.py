"""The port's ring-sliced DistHybridMsBfsEngine (exchange='sliced')
against the JAX engine, bit for bit, on meshes of 1, 2, 4 and 8 ranks.

Each rank expands its edge groups against its resident frontier shard
while a [rows_loc, w] accumulator rotates the ring (``batch_isend_irecv``,
P - 1 steps; none at one rank). One gloo group of spawned ranks a mesh
size runs ``torch_mesh_cases.SLICED_CASES`` (a pure residual, heavy rows
gated, the 64-vertex line truncated at the plane cap, 8192 lanes) while
JAX runs them on make_mesh(P) over the conftest's virtual devices.
"""

import numpy as np
import pytest

from tpu_bfs.graph import generate as jgen
from tpu_bfs.graph import io as jio
from tpu_bfs.parallel.dist_bfs import make_mesh
from tpu_bfs.parallel.dist_msbfs_hybrid import DistHybridMsBfsEngine as JDistHybrid
from tpu_bfs.parallel.dist_msbfs_hybrid import build_dist_hybrid as jbuild

import torch_mesh_cases as cases
from tpu_bfs_torch.parallel.mesh import start

MESH_SIZES = [1, 2, 4, 8]
CASES = {c[0]: c for c in cases.SLICED_CASES}


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
    group = start(p, cases.run_cases, "hybrid", cases.SLICED_CASES, device="cpu")
    jax = {name: jax_case(p, case) for name, case in CASES.items()}
    return p, group.result(), jax


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_sliced_equals_jax(mesh_runs, name):
    p, port, jax = mesh_runs
    cases.assert_same(port[name], jax[name], f"P={p} {name}")


def test_mesh_sliced_records_are_informative(mesh_runs):
    # The ring ran one exchange a level, the gate skipped whole ranks'
    # contributions (P a rank) where a resident frontier was empty, and the
    # truncation probe ran at the cap.
    p, port, _ = mesh_runs
    assert port["pure_residual"]["counts"].tolist() == [port["pure_residual"]["levels"] + 1]
    assert port["heavy_gated"]["gate"].sum() % p == 0
    assert port["deep_truncated"]["truncated"]
    assert port["lanes8192"]["dist"].shape[0] == len(cases.PICKS)
