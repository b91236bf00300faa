"""The exchange planner's knobs on the port's Dist2DBfsEngine against JAX's
on meshes of 1x1, 1x2, 2x2 and 2x4 ranks.

For each mesh shape one gloo group of spawned ranks runs every case of
``torch_mesh_cases.PLANNER_DIST2D_CASES``: ``wire_pack`` on the ring (both
collectives packed), the sparse row exchange on one rung with 16-bit delta
ids, and the whole planner (delta ids, sieve, predict), also with dopt
through a chained checkpoint. The planner's values are MAX-reduced over the
mesh row only, so on meshes of more than one row the rows may take
different branches at one level, each on its own subgroup; JAX's engine
then deadlocks on its virtual devices (as in tests/test_torch_dist2d.py),
so those cases are held to JAX's ring results and to the byte model of a
JAX planner engine that is built but not run. Everything else is held to
JAX's records.
"""

import numpy as np
import pytest

from tpu_bfs.graph import generate as jgen
from tpu_bfs.graph import io as jio
from tpu_bfs.parallel.dist_bfs2d import Dist2DBfsEngine as JDist2DBfsEngine
from tpu_bfs.parallel.dist_bfs2d import make_mesh_2d

import torch_mesh_cases as cases
from tpu_bfs_torch.graph import generate as tgen
from tpu_bfs_torch.graph import io as tio
from tpu_bfs_torch.parallel import collectives as tcoll
from tpu_bfs_torch.parallel.mesh import start

from torch_threads import cap_torch_threads

cap_torch_threads()

CASES = {c[0]: c for c in cases.PLANNER_DIST2D_CASES}
#: The cases whose mesh rows may split (see the module docstring).
SPLIT = ("planner", "planner_ckpt")


def _ring_of(case):
    """The case with the planner off and the ring exchange (its backend kept)."""
    name, gname, kw, src, mode = case
    return name, gname, {"exchange": "ring", **({"backend": kw["backend"]} if "backend" in kw
                                                else {})}, src, mode


def jax_records(shape) -> dict:
    """JAX's records on make_mesh_2d(*shape); for the split cases on meshes
    of more than one row, the ring records and the planner's byte model."""
    out = {}
    make = lambda g, **kw: JDist2DBfsEngine(g, make_mesh_2d(*shape), **kw)  # noqa: E731
    for name, case in CASES.items():
        g = cases.graph_of(case[1], jgen, jio)
        if name in SPLIT and shape[0] > 1:
            eng = make(g, **case[2])
            out[f"{name}_model"] = (eng.exchange_branch_labels(), list(eng.wire_bytes_per_level()))
            out[f"{name}_ring"], _ = cases.dist_case_record(_ring_of(case), g, make)
            continue
        out[name], _ = cases.dist_case_record(case, g, make)
    return out


@pytest.fixture(scope="module", params=cases.DIST2D_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def mesh_runs(request):
    """(shape, port records with host syncs, JAX records)."""
    shape = request.param
    group = start(shape[0] * shape[1], cases.planner_engines_rank, shape, device="cpu")
    jax = jax_records(shape)
    return shape, group.result()["dist"], jax


@pytest.mark.parametrize("name", list(CASES))
def test_planner_2d_equals_jax(mesh_runs, name):
    shape, port, jax = mesh_runs
    rec = port[name][0]
    where = f"{shape[0]}x{shape[1]} {name}"
    if name in jax:
        cases.assert_same(rec, jax[name], where)
        return
    # Rows may split: JAX's ring results, its planner engine's byte model,
    # and counts that cover every level and price as that model says.
    labels, per_level = jax[f"{name}_model"]
    ring = jax[f"{name}_ring"]
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
        elif field in ("ckpt2", "ckpt_end"):
            cases.assert_same({key: value}, {key: ring[key]}, where)
        else:
            np.testing.assert_array_equal(value, ring[key], err_msg=f"{where} {key}")


def test_planner_2d_records_are_informative(mesh_runs):
    # The one-rung case stays on 16-bit deltas where rows have peers; the
    # planner's host reads: one a level, plus its reads on the mesh row.
    (rows, cols), port, _ = mesh_runs
    rec, syncs = port["ids_delta16"]
    counts = rec["counts_250"]
    labels = rec["labels_250"]
    assert {labels[i] for i in np.flatnonzero(counts)} == (
        {"delta16[2048]"} if cols > 1 else {"dense"})
    rec, syncs = port["planner"]
    s = int(cases.sources_of(CASES["planner"][3], cases.graph_of("rmat_small", tgen, tio))[-1])
    kw = CASES["planner"][2]
    counts = rec[f"counts_{s}"]
    if rows == 1:
        extra = sum(int(c) * tcoll.planned_reads(b, kw["sparse_caps"], kw["delta_bits"], cols)
                    for b, c in enumerate(counts))
        assert syncs == counts.sum() + extra
    assert port["wire_pack"][0][f"labels_{s}"] is None
