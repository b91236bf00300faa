"""The workload kinds over the port's mesh wide engine against the JAX
package's mesh forms: CC (dense and sparse exchanges), k-hop (sparse with
delta ids) and p2p (sparse) over a ``DistWideMsBfsEngine``, the 1D rows of
the JAX package's mesh-kinds matrix (tests/test_workloads_dist.py), on the
same graph and sources.

One gloo group of spawned ranks a mesh size builds every adapter through
``build_workload_engine`` while JAX runs its own over DistWideMsBfsEngine
on make_mesh(P): the answers (extras, reached counts, levels) and the
sharded row map are equal, and equal to the single-device adapters and to
SciPy. Also: ``build_workload_engine('sssp', ...)`` on a mesh.
"""

import dataclasses

import numpy as np
import pytest

from tpu_bfs import workloads as jw
from tpu_bfs.graph import generate as jgen
from tpu_bfs.parallel.dist_bfs import make_mesh
from tpu_bfs.parallel.dist_msbfs_wide import DistWideMsBfsEngine as JDistWide

import torch_mesh_cases as cases
from tpu_bfs_torch import workloads as tw
from tpu_bfs_torch.algorithms.msbfs_wide import WidePackedMsBfsEngine
from tpu_bfs_torch.graph import generate as tgen
from tpu_bfs_torch.graph.csr import INF_DIST
from tpu_bfs_torch.parallel.mesh import start
from tpu_bfs_torch.reference import bfs_scipy

KINDS = {c[0]: c for c in cases.MESH_KINDS}


@dataclasses.dataclass
class Spec:
    lanes: int


def jax_records(p) -> dict:
    g = cases.sssp_graph(jgen)
    out = {}
    for name, kind, kw in cases.MESH_KINDS:
        base = JDistWide(g, make_mesh(p), **kw)
        out[name] = cases.kind_fields(kind, jw.build_workload_engine(kind, base, g,
                                                                     Spec(kw["lanes"])))
        if kind == "p2p":
            out["row_map"] = jw.id_of_row_map(base)
    return out


@pytest.fixture(scope="module", params=[2, 8], ids=lambda p: f"P{p}")
def mesh_runs(request):
    p = request.param
    group = start(p, cases.mesh_kinds_rank, device="cpu")
    jax = jax_records(p)
    return p, group.result(), jax


@pytest.fixture(scope="module")
def single():
    """The single-device adapters' answers (64-lane wide engines)."""
    g = cases.sssp_graph(tgen)
    return {kind: cases.kind_fields(kind, tw.build_workload_engine(
        kind, WidePackedMsBfsEngine(g, lanes=64, device="cpu"), g, Spec(64)))
        for kind in ("cc", "khop", "p2p")}


def _same(a: dict, b: dict, where: str) -> None:
    assert a.keys() == b.keys(), where
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{where} {k}")
        else:
            assert a[k] == b[k], f"{where} {k}: {a[k]} != {b[k]}"


@pytest.mark.parametrize("name", list(KINDS))
def test_mesh_kinds_equal_jax(mesh_runs, single, name):
    p, port, jax = mesh_runs
    where = f"P={p} {name}"
    _same(port[name], jax[name], where)
    _same(port[name], single[KINDS[name][1]], f"{where} single device")


def test_mesh_kinds_equal_oracles(mesh_runs):
    from scipy.sparse import csgraph

    p, port, _ = mesh_runs
    g = cases.sssp_graph(tgen)
    nc, _ = csgraph.connected_components(g.to_scipy(), directed=False)
    for name in ("cc-dense", "cc-sparse"):
        assert all(e["components"] == nc for e in port[name]["extras"])
    for i, s in enumerate(cases.KIND_SOURCES):
        d = bfs_scipy(g, int(s))
        assert port["khop-sparse"]["reached"][i] == int(((d != INF_DIST) & (d <= 2)).sum())
        e = port["p2p-sparse"]["extras"][i]
        t = cases.P2P_TARGETS[i]
        assert e["distance"] == int(d[t]) and e["path"][0] == s and e["path"][-1] == t
        assert len(e["path"]) == e["distance"] + 1
        assert all(g.has_edge(a, b) for a, b in zip(e["path"], e["path"][1:]))


def test_mesh_row_map_equals_jax(mesh_runs):
    # Chip-major table row -> vertex id, -1 on pad rows.
    p, port, jax = mesh_runs
    np.testing.assert_array_equal(port["row_map"], jax["row_map"])
    real = port["row_map"][port["row_map"] >= 0]
    assert sorted(real.tolist()) == list(range(cases.sssp_graph(tgen).num_vertices))
    assert port["p2p_reads"] >= 1
    assert port["p2p_scanner_kept"]  # built once a base, not once a batch


def test_build_workload_engine_sssp_on_a_mesh():
    # devices > 1 inside a rank group of that size: a DistSsspEngine (1D
    # ring by default, 2D allreduce with mesh_shape), equal to SsspEngine.
    from tpu_bfs_torch.workloads.sssp import SsspEngine

    forms = (((), "ring", "Mesh"), ((1, 2), "allreduce", "Mesh2D"))
    groups = [start(2, cases.workload_engine_rank, shape, device="cpu") for shape, *_ in forms]
    g = cases.sssp_graph(tgen)
    want = SsspEngine(g, lanes=4, device="cpu").run(np.asarray(cases.SSSP_SOURCES[:4]))
    for (_shape, exchange, mesh), group in zip(forms, groups):
        name, got_exchange, got_mesh, dist = group.result()
        assert (name, got_exchange, got_mesh) == ("DistSsspEngine", exchange, mesh)
        for i in range(4):
            np.testing.assert_array_equal(dist[i], want.distances_int32(i))
