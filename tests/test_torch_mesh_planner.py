"""The exchange planner's knobs on the port's mesh engines against JAX's,
bit for bit, on meshes of 1, 2, 4 and 8 ranks.

For each mesh size one gloo group of spawned ranks runs every case of
``torch_mesh_cases.PLANNER_DIST_CASES`` (DistBfsEngine with ``wire_pack``,
``delta_bits``, ``sieve`` and ``predict`` each alone, on the ring,
allreduce and sparse exchanges, and all together with dopt through a
chained checkpoint), ``PLANNER_WIDE_CASES`` and ``PLANNER_HYBRID_CASES``
(the packed mesh engines' delta-encoded row gather, ``wire_pack``
recorded), while JAX runs the same cases on make_mesh(P): distances,
parents, levels, reached and traversed counts, the raw tables, branch
counts, labels and modeled bytes are equal. The refusals are JAX's texts.
"""

import numpy as np
import pytest

from tpu_bfs.graph import generate as jgen
from tpu_bfs.graph import io as jio
from tpu_bfs.parallel.dist_bfs import DistBfsEngine as JDistBfsEngine
from tpu_bfs.parallel.dist_bfs import make_mesh
from tpu_bfs.parallel.dist_bfs2d import Dist2DBfsEngine as JDist2DBfsEngine
from tpu_bfs.parallel.dist_msbfs_hybrid import DistHybridMsBfsEngine as JDistHybrid
from tpu_bfs.parallel.dist_msbfs_hybrid import build_dist_hybrid as jbuild
from tpu_bfs.parallel.dist_msbfs_wide import DistWideMsBfsEngine as JDistWide

import torch_mesh_cases as cases
from tpu_bfs_torch.graph import generate as tgen
from tpu_bfs_torch.graph import io as tio
from tpu_bfs_torch.parallel import collectives as tcoll
from tpu_bfs_torch.parallel.mesh import start

from torch_threads import cap_torch_threads

cap_torch_threads()

DIST = {c[0]: c for c in cases.PLANNER_DIST_CASES}
WIDE = {c[0]: c for c in cases.PLANNER_WIDE_CASES}
HYBRID = {c[0]: c for c in cases.PLANNER_HYBRID_CASES}


def jax_records(p) -> dict:
    """JAX's records of every planner case on make_mesh(p)."""
    out = {"dist": {}, "wide": {}, "hybrid": {}}
    for name, case in DIST.items():
        out["dist"][name], _ = cases.dist_case_record(
            case, cases.graph_of(case[1], jgen, jio),
            lambda g, **kw: JDistBfsEngine(g, make_mesh(p), **kw))
    for kind, table, cls, build in (("wide", WIDE, JDistWide, None),
                                    ("hybrid", HYBRID, JDistHybrid, jbuild)):
        for name, case in table.items():
            out[kind][name] = cases.case_record(
                case, cases.graph_of(case[1], jgen, jio),
                lambda x, cls=cls, **kw: cls(x, make_mesh(p), **kw), build, p,
                lambda eng, t: np.asarray(t))
    return out


@pytest.fixture(scope="module", params=cases.DIST_MESHES, ids=lambda p: f"P{p}")
def mesh_runs(request):
    """(P, port records, JAX records): the port's ranks run while JAX
    computes."""
    p = request.param
    group = start(p, cases.planner_engines_rank, p, device="cpu")
    jax = jax_records(p)
    return p, group.result(), jax


@pytest.mark.parametrize("name", list(DIST))
def test_planner_knobs_equal_jax(mesh_runs, name):
    # One case a knob (wire_pack, delta_bits, sieve, predict), and all four.
    p, port, jax = mesh_runs
    cases.assert_same(port["dist"][name][0], jax["dist"][name], f"P={p} {name}")


@pytest.mark.parametrize("engine,name", [("wide", n) for n in WIDE] +
                         [("hybrid", n) for n in HYBRID])
def test_packed_mesh_planner_knobs_equal_jax(mesh_runs, engine, name):
    p, port, jax = mesh_runs
    cases.assert_same(port[engine][name], jax[engine][name], f"P={p} {engine} {name}")


def test_planner_records_are_informative(mesh_runs):
    # The cases reach what they are there for, and a planner level reads the
    # host once, twice sieved, never when predicted (plus the count's read).
    p, port, _ = mesh_runs
    seen = set()
    for name, (rec, syncs) in port["dist"].items():
        kw = DIST[name][2]
        if kw["exchange"] != "sparse":
            continue
        counts = [rec[k] for k in rec if k.startswith("counts_")][-1]
        labels = [rec[k] for k in rec if k.startswith("labels_")][-1]
        seen |= {labels[i] for i in np.flatnonzero(counts)}
        if DIST[name][4] == "run":
            extra = sum(int(c) * tcoll.planned_reads(b, kw["sparse_caps"],
                                                     kw.get("delta_bits", ()), p)
                        for b, c in enumerate(counts))
            assert syncs == counts.sum() + extra, name
    if p > 1:
        assert {"dense", "dense-predicted"} <= seen, seen
        assert any(s.startswith("delta8[") for s in seen), seen
        assert any(s.startswith("sieved-") and s != "sieved-dense" for s in seen), seen
        wide_labels = port["wide"]["delta"]["labels"]
        used = {wide_labels[i] for i in np.flatnonzero(port["wide"]["delta"]["counts"])}
        assert any(s.startswith("delta") for s in used), used


def test_planner_refusals_equal_jax():
    # The knobs without the sparse exchange refuse before any work, with
    # JAX's texts (cases.jax_text).
    from tpu_bfs_torch.parallel.dist_bfs import DistBfsEngine
    from tpu_bfs_torch.parallel.dist_bfs2d import Dist2DBfsEngine
    from tpu_bfs_torch.parallel.dist_msbfs_hybrid import DistHybridMsBfsEngine
    from tpu_bfs_torch.parallel.dist_msbfs_wide import DistWideMsBfsEngine

    tg, jg = cases.graph_of("line64", tgen, tio), cases.graph_of("line64", jgen, jio)
    for ours, theirs, kw in (
            (DistBfsEngine, JDistBfsEngine, dict(exchange="ring", sieve=True)),
            (DistBfsEngine, JDistBfsEngine, dict(exchange="allreduce", delta_bits=(8,))),
            (Dist2DBfsEngine, JDist2DBfsEngine, dict(exchange="ring", predict=True)),
            (DistWideMsBfsEngine, JDistWide, dict(exchange="dense", delta_bits=(8, 16))),
            (DistHybridMsBfsEngine, JDistHybrid, dict(exchange="sliced", delta_bits=(8,)))):
        with pytest.raises(ValueError) as want:
            theirs(jg, **kw)
        with pytest.raises(ValueError) as got:
            ours(tg, device="cpu", **kw)
        assert str(got.value) == cases.jax_text(str(want.value)), ours.__name__
