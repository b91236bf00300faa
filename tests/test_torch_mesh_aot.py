"""Mesh AOT: the dist engines' rank-local program inventories exported,
adopted and served, against the eager engines and JAX's.

For each mesh size P in {1, 2, 4} one gloo group of spawned ranks runs
``torch_mesh_cases.mesh_aot_rank``: every case of ``MESH_AOT_CASES``
(``DistWideMsBfsEngine`` dense and sparse, ``DistHybridMsBfsEngine`` in the
gather and sliced layouts, gated and not, ``DistSsspEngine`` ring and
sparse) and the 2D cases on 1x2 and 2x2 (``Dist2DBfsEngine``) export from
one engine, and a fresh engine on every rank adopts them. Its records
(distances, visited words, planes, exchange and gate counts, trees; SSSP
distances and rounds) must equal the un-adopted engine's and JAX's eager
dist engine's on the same virtual mesh (JAX's own mesh round trip is
slow-marked there, so the port is held to JAX's eager engines). The
stores' artifacts must name the kernel ops, hold no collective and no
table. On the wide case: a corrupt artifact of rank 1 is quarantined there
while rank 0 adopts, and rank 1's artifact under rank 0's name is stale
for rank 0. The serve tier preheats mesh rungs from an exported store, with
``torch.export.export`` made to raise, and answers as the eager rungs.
"""

import os

import numpy as np
import pytest
import torch

from tpu_bfs.graph import generate as jgen
from tpu_bfs.graph import io as jio
from tpu_bfs.parallel.dist_bfs import make_mesh
from tpu_bfs.parallel.dist_bfs2d import Dist2DBfsEngine as JDist2D
from tpu_bfs.parallel.dist_bfs2d import make_mesh_2d
from tpu_bfs.parallel.dist_msbfs_hybrid import DistHybridMsBfsEngine as JDistHybrid
from tpu_bfs.parallel.dist_msbfs_wide import DistWideMsBfsEngine as JDistWide
from tpu_bfs.parallel.dist_sssp import DistSsspEngine as JDistSssp

import torch_mesh_cases as cases
from tpu_bfs_torch import obs as tobs
from tpu_bfs_torch.graph import generate as tgen
from tpu_bfs_torch.parallel.mesh import start
from tpu_bfs_torch.utils import aot

from torch_threads import cap_torch_threads

cap_torch_threads()

MESH_SIZES = [1, 2, 4]
JAX_ENGINES = {"wide": JDistWide, "hybrid": JDistHybrid, "sssp": JDistSssp}
CASES = {c[0]: c for c in cases.MESH_AOT_CASES}
CASES_2D = {c[0]: c for c in cases.MESH_AOT_2D}


def jax_records(p) -> dict:
    """JAX's eager records of every case on ``p`` virtual devices."""
    out = {}
    for case in cases.MESH_AOT_CASES:
        if p in case[5]:
            make, run = cases.mesh_aot_engine(case, make_mesh(p), JAX_ENGINES, jgen, jio)
            out[case[0]] = run(make())
    g = cases.graph_of("rmat_small", jgen, jio)
    for name, shape, kw, sources in cases.MESH_AOT_2D:
        if shape[0] * shape[1] == p:
            out[name], _ = cases.dist_case_record(
                (name, "rmat_small", kw, sources, "run"), g,
                lambda g, **k: JDist2D(g, make_mesh_2d(*shape), **k))
    return out


@pytest.fixture(scope="module", params=MESH_SIZES, ids=lambda p: f"P{p}")
def mesh_runs(request, tmp_path_factory):
    """(P, the ranks' records, JAX's records, the stores' root)."""
    p = request.param
    root = str(tmp_path_factory.mktemp(f"mesh_aot_p{p}"))
    group = start(p, cases.mesh_aot_rank, root, device="cpu")
    jax = jax_records(p)
    return p, group.result(), jax, root


def _names(p):
    return [c[0] for c in cases.MESH_AOT_CASES if p in c[5]] + [
        name for name, shape, *_ in cases.MESH_AOT_2D if shape[0] * shape[1] == p]


def _inventory(name):
    """JAX's program names of a case's engine (the sliced layout adds its
    settle, SSSP its heavy close)."""
    if name in CASES and CASES[name][1] == "sssp":
        return ["dist_sssp_core", "dist_sssp_close"]
    return ["dist_core", "dist_settle"] if "sliced" in name else ["dist_core"]


@pytest.mark.parametrize("name", list(CASES) + list(CASES_2D))
def test_adopted_mesh_engine_equals_eager_and_jax(mesh_runs, name):
    p, port, jax, _root = mesh_runs
    if name not in _names(p):
        assert name not in port
        return
    rec = port[name]
    where = f"P={p} {name}"
    cases.assert_same(rec["adopted"], rec["eager"], f"{where} adopted vs eager")
    cases.assert_same(rec["adopted"], jax[name], f"{where} adopted vs JAX")
    # JAX's inventory names, every one adopted on rank 0 and run with no
    # runtime fallback; every rank stored its own program.
    want = _inventory(name)
    assert rec["names"] == rec["adopted_names"] == want, where
    assert all(calls >= 1 and fb == 0 for calls, fb in rec["calls"].values()), (where, rec)
    assert rec["counts"]["aot_hits"] == len(want) and rec["counts"]["aot_fallbacks"] == 0
    files = sorted(f for f in os.listdir(os.path.join(_root, name)) if f.endswith(".aot"))
    assert len(files) == p * len(want), (where, files)


def test_artifacts_name_the_kernels_and_hold_no_collective_or_table(mesh_runs):
    p, _port, _jax, root = mesh_runs
    seen = 0
    for name in _names(p):
        store = aot.ArtifactStore(os.path.join(root, name))
        key = aot.program_key(cases.mesh_aot_key(name, p))
        family = CASES[name][1] if name in CASES else "2d"
        for n in _inventory(name):
            for r in range(p):
                stored = aot.rank_program_name(n, r)
                path = store.path_for(key, stored)
                meta, off = store._read_header(path)
                assert meta["key"] == key and meta["name"] == stored
                assert meta["fingerprint"]["mesh"] == {"backend": "gloo", "device": "cpu"}
                with open(path, "rb") as f:
                    f.seek(off)
                    ep = aot.load_program(f.read())
                const = sum(t.numel() * t.element_size() for t in ep.constants.values()
                            if isinstance(t, torch.Tensor))
                assert const <= 256, (name, stored, const)
                targets = aot.AdoptedProgram(stored, ep, None).graph_targets()
                assert not any("c10d" in t or "all_reduce" in t or "all_gather" in t
                               or "broadcast" in t for t in targets), (name, stored)
                k1 = "tpu_bfs_torch.ell_expand.default" in targets
                k2 = "tpu_bfs_torch.tile_spmm.default" in targets
                if family == "2d" or n == "dist_settle":
                    assert not (k1 or k2), (name, stored)
                else:
                    assert k1, (name, stored, targets)
                    assert k2 == (family == "hybrid"), (name, stored)
                seen += 1
    assert seen == sum(p * len(_inventory(n)) for n in _names(p))


def test_a_corrupt_rank_quarantines_and_a_foreign_rank_is_stale(mesh_runs):
    p, port, _jax, root = mesh_runs
    if p == 1:
        assert "faults" not in port
        return
    eager = port["wide"]["eager"]
    corrupt, stale = port["faults"]["corrupt"], port["faults"]["stale"]
    # Columns: adopted programs, fallbacks, hits, own artifact quarantined.
    want = np.array([[1, 0, 1, 0]] * p)
    want[1] = [0, 1, 0, 1]
    np.testing.assert_array_equal(corrupt["ranks"], want)
    want = np.array([[1, 0, 1, 0]] * p)
    want[0] = [0, 1, 0, 0]  # stale: a fallback, never a quarantine
    np.testing.assert_array_equal(stale["ranks"], want)
    for arm in (corrupt, stale):
        cases.assert_same(arm["record"], eager, f"P={p} fault arm")
    key = cases.mesh_aot_key("wide", p)
    assert os.path.exists(aot.ArtifactStore(os.path.join(root, "wide_corrupt")).path_for(
        key, "dist_core.r1") + ".corrupt")
    # Rank constants enter the layout: no two ranks share one.
    assert len(set(port["layouts"][:, 0].tolist())) == p


# --- the store's mesh rules, no ranks ---------------------------------------

MESH_KEY = {"graph_key": "g", "engine": "wide", "lanes": 64, "planes": 4, "devices": 2}
GLOO_CPU = {"backend": "gloo", "device": "cpu"}


@pytest.mark.parametrize("other", [{"backend": "gloo", "device": "cuda"},
                                   {"backend": "nccl", "device": "cuda"}, None])
def test_a_mesh_artifact_is_stale_under_another_backend_and_never_quarantined(tmp_path,
                                                                              other):
    store = aot.ArtifactStore(tmp_path)
    path = store.put(MESH_KEY, "dist_core", b"p" * 64, mesh=GLOO_CPU)
    assert store.get(MESH_KEY, "dist_core", mesh=other) is None
    assert os.path.exists(path) and not os.path.exists(path + ".corrupt")
    assert store.counts()["aot_fallbacks"] == 1
    assert store.get(MESH_KEY, "dist_core", mesh=GLOO_CPU) == b"p" * 64
    assert os.listdir(tmp_path) == [os.path.basename(path)]  # no writer's .tmp left


def test_a_mesh_spec_probes_ready_only_with_every_rank(tmp_path):
    store = aot.ArtifactStore(tmp_path)
    store.put(MESH_KEY, "dist_core", b"r0" * 32, mesh=GLOO_CPU)
    assert not store.probe(MESH_KEY, mesh=GLOO_CPU)
    r1 = store.put(MESH_KEY, aot.rank_program_name("dist_core", 1), b"r1" * 32, mesh=GLOO_CPU)
    assert store.probe(MESH_KEY, mesh=GLOO_CPU)
    assert not store.probe(MESH_KEY, mesh={"backend": "nccl", "device": "cuda"})
    with open(r1, "r+b") as f:
        f.seek(-3, os.SEEK_END)
        f.write(b"xyz")
    assert not store.probe(MESH_KEY, mesh=GLOO_CPU)
    # Rank 0's file name is JAX's; the others carry the rank in the name.
    assert os.path.basename(store.path_for(MESH_KEY, "dist_core")).startswith(
        "wide-l64-p4-d2-dist_core-")
    assert "-dist_core.r1-" in os.path.basename(r1)
    assert store.counts() == {"aot_hits": 0, "aot_fallbacks": 0,
                              "aot_runtime_fallbacks": 0, "aot_exports": 2}


# --- the serve tier on a serving mesh ---------------------------------------


@pytest.fixture(scope="module")
def serving_mesh():
    from tpu_bfs_torch.parallel.mesh import serve_mesh

    ctl = serve_mesh(2, device="cpu")
    yield ctl
    ctl.close()


def _no_trace(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a preheated process must not trace")

    monkeypatch.setattr(torch.export, "export", refuse)


@pytest.mark.parametrize("engine,ladder", [("wide", "64,128"), ("hybrid", "4096"),
                                           ("dist2d", "32")])
def test_service_preheats_mesh_rungs_and_answers_as_the_eager_ones(
        serving_mesh, tmp_path, monkeypatch, engine, ladder):
    from tpu_bfs_torch.serve import BfsService

    g = tgen.rmat_graph(9, 8, seed=12)
    lanes = int(ladder.split(",")[-1])
    store_dir = str(tmp_path / "store")
    kw = dict(lanes=lanes, width_ladder=ladder, linger_ms=1.0, devices=2, engine=engine,
              device="cpu")
    svc = BfsService(g, **kw)
    try:
        base = {s: svc.query(s, timeout=120.0) for s in (0, 3, 5)}
        assert all(r.ok for r in base.values())
        rungs = len(svc.width_ladder)
        assert svc.export_aot(store_dir) == {"programs": rungs, "engines": rungs}
    finally:
        svc.close()
    files = [f for f in os.listdir(store_dir) if f.endswith(".aot")]
    assert len(files) == 2 * rungs and sum(".r1-" in f for f in files) == rungs
    _no_trace(monkeypatch)
    rec = tobs.arm(capacity=2048)
    try:
        pre = BfsService(g, aot_dir=store_dir, **kw)
        try:
            counts = rec.counts_by_name()
            assert counts.get("engine_adopt", 0) >= rungs and not counts.get("engine_build")
            snap = pre.statsz()["aot"]
            assert snap["aot_hits"] == rungs and snap["aot_fallbacks"] == 0
            for s, b in base.items():
                r = pre.query(s, timeout=120.0)
                assert r.ok and r.levels == b.levels and r.reached == b.reached
                np.testing.assert_array_equal(r.distances, b.distances)
            assert pre.statsz()["aot"]["aot_runtime_fallbacks"] == 0
        finally:
            pre.close()
    finally:
        tobs.disarm()
    if engine != "wide":
        return
    # One rank's artifact corrupt: that rank quarantines and runs eagerly,
    # rank 0 adopts, and the mesh program counts one fallback a rung.
    for f in files:
        if ".r1-" in f:
            with open(os.path.join(store_dir, f), "r+b") as fh:
                fh.seek(-10, os.SEEK_END)
                fh.write(b"\x00" * 4)
    pre = BfsService(g, aot_dir=store_dir, **kw)
    try:
        snap = pre.statsz()["aot"]
        assert snap["aot_hits"] == 0 and snap["aot_fallbacks"] == rungs
        for s, b in base.items():
            r = pre.query(s, timeout=120.0)
            assert r.ok and r.levels == b.levels
            np.testing.assert_array_equal(r.distances, b.distances)
    finally:
        pre.close()
    assert sum(f.endswith(".corrupt") for f in os.listdir(store_dir)) == rungs
