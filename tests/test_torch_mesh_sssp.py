"""The port's DistSsspEngine against JAX's, bit for bit, on meshes of 1, 2,
4 and 8 ranks and 2D meshes 2x2 and 2x4, on the JAX mesh-kinds test's
graph (``random_graph(96, 480, seed=3, weights=5)``); and the sharded
weights plane under it.

For each mesh size one gloo group of spawned ranks runs the cases of
``torch_mesh_cases.SSSP_CASES`` that run on it (the ring, allreduce and
sparse exchanges, small caps that run every rung, the sparse exchange with
delta ids and prediction, and the 2D mesh's hierarchical allreduce) while
JAX runs DistSsspEngine on make_mesh(P) or make_mesh_2d: distances,
rounds, reached, eccentricities, branch counts, labels and modeled bytes
are equal, and equal to the port's single-device SsspEngine and to
SciPy's dijkstra.
"""

import numpy as np
import pytest

from tpu_bfs.graph import generate as jgen
from tpu_bfs.graph.ell import build_ell_sharded as jbuild_sharded
from tpu_bfs.graph.ell import build_ell_weights_sharded as jweights_sharded
from tpu_bfs.parallel.dist_bfs import make_mesh
from tpu_bfs.parallel.dist_bfs2d import make_mesh_2d
from tpu_bfs.parallel.dist_sssp import DistSsspEngine as JDistSssp

import torch_mesh_cases as cases
from tpu_bfs_torch.graph import generate as tgen
from tpu_bfs_torch.graph.csr import INF_DIST
from tpu_bfs_torch.graph.ell import build_ell_sharded, build_ell_weights_sharded
from tpu_bfs_torch.parallel.mesh import start
from tpu_bfs_torch.workloads.sssp import SsspEngine

from torch_threads import cap_torch_threads

cap_torch_threads()


def _dijkstra(g, sources):
    import scipy.sparse as sp
    from scipy.sparse import csgraph

    m = g.to_scipy(weighted=True).tocoo()
    key = m.row.astype(np.int64) * g.num_vertices + m.col
    order = np.lexsort((m.data, key))
    k2, d2 = key[order], m.data[order]
    first = np.ones(len(k2), bool)
    first[1:] = k2[1:] != k2[:-1]
    mm = sp.csr_matrix((d2[first], (k2[first] // g.num_vertices, k2[first] % g.num_vertices)),
                       shape=(g.num_vertices, g.num_vertices))
    return csgraph.dijkstra(mm, directed=True, indices=sources)


@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize("gname,kcap", [("sssp", 64), ("rmat_heavy", 4)])
def test_build_ell_weights_sharded_equals_jax(gname, kcap, p):
    def graph(gen):
        if gname == "sssp":
            return cases.sssp_graph(gen)
        return gen.rmat_graph(9, 8, seed=4, weights=7)

    gt, gj = graph(tgen), graph(jgen)
    ours = build_ell_weights_sharded(gt, build_ell_sharded(gt, p, kcap=kcap))
    theirs = jweights_sharded(gj, jbuild_sharded(gj, p, kcap=kcap))
    assert (ours[0] is None) == (theirs[0] is None)
    if ours[0] is not None:
        np.testing.assert_array_equal(ours[0], theirs[0])
    assert len(ours[1]) == len(theirs[1]) and len(ours[1]) > 1
    for a, b in zip(ours[1], theirs[1]):
        np.testing.assert_array_equal(a, b)
    if gname == "rmat_heavy":
        assert ours[0] is not None  # the heavy rows' virtual slabs are covered


def jax_records(p) -> dict:
    g = cases.sssp_graph(jgen)
    out = {}
    for name, kw, shape, sizes in cases.SSSP_CASES:
        if p not in sizes:
            continue
        mesh = make_mesh_2d(*shape) if shape else make_mesh(p)
        eng = JDistSssp(g, mesh, lanes=32, **kw)
        out[(name, shape)] = cases.sssp_fields(eng, eng.run(np.asarray(cases.SSSP_SOURCES)))
    return out


@pytest.fixture(scope="module")
def reference():
    """The single-device SsspEngine's batch and SciPy's distances."""
    g = cases.sssp_graph(tgen)
    res = SsspEngine(g, lanes=32, device="cpu").run(np.asarray(cases.SSSP_SOURCES))
    want = _dijkstra(g, cases.SSSP_SOURCES)
    want = np.where(np.isinf(want), INF_DIST, want).astype(np.int32)
    return res, want


@pytest.fixture(scope="module", params=cases.SSSP_MESHES, ids=lambda p: f"P{p}")
def mesh_runs(request):
    p = request.param
    group = start(p, cases.sssp_rank, p, device="cpu")
    jax = jax_records(p)
    return p, group.result(), jax


def _case_ids():
    return [f"{name}-{shape[0]}x{shape[1]}" if shape else name
            for name, _kw, shape, _sizes in cases.SSSP_CASES]


@pytest.mark.parametrize("case", range(len(cases.SSSP_CASES)), ids=_case_ids())
def test_dist_sssp_equals_jax(mesh_runs, reference, case):
    p, port, jax = mesh_runs
    name, kw, shape, sizes = cases.SSSP_CASES[case]
    if p not in sizes:
        assert (name, shape) not in port
        return
    rec, reads, closes = port[(name, shape)]
    where = f"P={p} {name} {shape}"
    cases.assert_same(rec, jax[(name, shape)], where)
    res, want = reference
    np.testing.assert_array_equal(rec["dist"], want, err_msg=where)
    assert rec["rounds"] == res.rounds, where
    np.testing.assert_array_equal(rec["reached"], res.reached, err_msg=where)
    np.testing.assert_array_equal(rec["ecc"], res.ecc, err_msg=where)
    # Host reads: one a round, a second a close, and the sparse rung's on
    # every round that was not predicted.
    counts = rec["counts"]
    measured = counts.sum() - (counts[-1] if kw.get("predict") else 0)
    assert reads == rec["rounds"] + closes + (measured if kw["exchange"] == "sparse" else 0)
    assert rec["bytes"] == float(np.dot(counts, rec["per_level"]))


def test_dist_sssp_records_are_informative(mesh_runs):
    # The cases run what they are there for: several rungs and the dense
    # branch; delta ids; the predicted dense branch at four ranks or more.
    p, port, _ = mesh_runs
    used = set()
    for (name, _shape), (rec, _reads, _closes) in port.items():
        used |= {rec["labels"][i] for i in np.flatnonzero(rec["counts"])}
    if p == 4:
        assert {"sparse[2]", "sparse[8]", "dense", "dense-predicted"} <= used, used
    if p in (4, 8):
        assert any(s.startswith("delta8[") for s in used), used


def test_dist_sssp_refusals_equal_jax():
    from tpu_bfs_torch.parallel.dist_sssp import DistSsspEngine

    gt, gj = cases.sssp_graph(tgen), cases.sssp_graph(jgen)
    for kw in (dict(exchange="ring", delta_bits=(8,)), dict(exchange="allreduce", predict=True),
               dict(exchange="sprase"), dict(lanes=0)):
        with pytest.raises(ValueError) as want:
            JDistSssp(gj, 1, **kw)
        with pytest.raises(ValueError) as got:
            DistSsspEngine(gt, device="cpu", **kw)
        assert str(got.value) == cases.jax_text(str(want.value))
    unweighted = tgen.random_graph(20, 40, seed=1)
    with pytest.raises(ValueError, match="weighted graph"):
        DistSsspEngine(unweighted, device="cpu")
