"""Cases and rank entry points of the mesh parity tests
(tests/test_torch_mesh_wide.py, tests/test_torch_mesh_hybrid.py).

This module imports no JAX: the spawned gloo ranks import it to run
``run_cases`` (``tpu_bfs_torch.parallel.mesh.start``). The test modules
build the same graphs with the JAX package through :func:`graph_of` and
run the JAX engines on its virtual mesh. Each case records what the parity
tests compare: per-lane distances, reached counts, eccentricities, levels
and the truncation flag, the raw visited words and planes in the
chip-major layout, the exchange counts, bytes and branch labels, the gate
counts, and BFS trees through the device parent scan.
"""

import dataclasses
import re

import numpy as np


def _path(io, n):
    u = np.arange(n - 1)
    return io.from_edges(u, u + 1, num_vertices=n)


GRAPHS = {
    "random_small": lambda gen, io: gen.random_graph(500, 2000, seed=12345),
    "random_disconnected": lambda gen, io: gen.random_graph(300, 150, seed=7),
    "rmat_small": lambda gen, io: gen.rmat_graph(10, 8, seed=3),
    # Path 0-1-...-63: one-vertex frontiers, 63 levels from vertex 0.
    "line64": lambda gen, io: _path(io, 64),
    "rmat12": lambda gen, io: gen.rmat_graph(12, 16, seed=2),
}


def graph_of(name, gen, io):
    """Case graph ``name`` built with a package's generate and io modules."""
    return GRAPHS[name](gen, io)


def sources_of(spec, g) -> np.ndarray:
    """A case's sources: a list, or ('active', n) for the first n vertices
    with an edge, ('iso', [...]) for the first isolated vertex then the
    list, or ('rng', n) for n seeded draws over all vertices."""
    if isinstance(spec, list):
        return np.asarray(spec, dtype=np.int64)
    kind, arg = spec
    if kind == "active":
        return np.flatnonzero(g.degrees > 0)[:arg].astype(np.int64)
    if kind == "iso":
        return np.asarray([int(np.flatnonzero(g.degrees == 0)[0])] + arg, dtype=np.int64)
    return np.random.default_rng(5).integers(0, g.num_vertices, size=arg)


# (name, graph, engine keywords, sources, mode). Modes: 'run' (a batch and
# its record), 'dispatch' (the truncation flag at the plane cap), 'ckpt'
# (start, advance 2 levels, advance to the end, finish), 'reject' (the
# prebuilt-dict and layout checks).
WIDE_CASES = [
    ("dense", "random_small", dict(lanes=64), [0, 1, 17, 255, 499, 3], "run"),
    ("sparse", "rmat_small", dict(lanes=64, exchange="sparse"), ("active", 40), "run"),
    ("heavy", "rmat_small", dict(lanes=64, kcap=8), ("active", 40), "run"),
    ("disconnected", "random_disconnected", dict(lanes=64, exchange="sparse"),
     ("iso", [0, 5, 9]), "run"),
    ("deep_at_cap", "line64", dict(lanes=32, num_planes=5), [31], "run"),
    ("deep_truncated", "line64", dict(lanes=32, num_planes=5), [0], "dispatch"),
    ("lanes8192", "random_disconnected", dict(lanes=8192), ("rng", 8192), "run"),
    ("ckpt_sparse", "rmat_small", dict(lanes=64, exchange="sparse"), ("active", 20), "ckpt"),
]

HYBRID_CASES = [
    ("dense", "random_small", dict(tile_thr=2), [0, 1, 17, 255, 499], "run"),
    ("sparse", "random_small", dict(tile_thr=4, exchange="sparse"), ("rng", 80), "run"),
    ("heavy_gated", "rmat_small", dict(tile_thr=300, kcap=8, pull_gate=True),
     ("active", 40), "run"),
    ("disconnected_sparse_gated", "random_disconnected",
     dict(tile_thr=2, exchange="sparse", pull_gate=True), ("iso", [0, 5, 9]), "run"),
    ("deep_at_cap", "line64", dict(tile_thr=2, num_planes=5), [31], "run"),
    ("deep_truncated", "line64", dict(tile_thr=2, num_planes=5), [0], "dispatch"),
    ("ckpt_sparse", "random_small", dict(tile_thr=2, exchange="sparse"), [0, 17, 255],
     "ckpt"),
    ("reject", "random_small", dict(tile_thr=2), [0, 17], "reject"),
]

#: The ring-sliced layout's cases (tests/test_torch_mesh_sliced.py).
SLICED_CASES = [
    ("pure_residual", "random_small", dict(tile_thr=10**9, exchange="sliced"),
     [0, 100, 499], "run"),
    ("heavy_gated", "rmat_small",
     dict(tile_thr=10**9, kcap=8, exchange="sliced", pull_gate=True), ("active", 12), "run"),
    ("deep_truncated", "line64", dict(tile_thr=2, num_planes=5, exchange="sliced"), [0],
     "dispatch"),
    ("lanes8192", "random_disconnected", dict(tile_thr=2, lanes=8192, exchange="sliced"),
     ("rng", 8192), "run"),
]

#: The card tests' cases (tests/test_torch_cuda.py): a one-rank NCCL group
#: against a one-rank gloo group on CPU tensors.
CARD_CASES = [
    ("hybrid_gather", "rmat12", dict(), ("rng", 4096), "run"),
    ("hybrid_sparse_gated", "rmat12", dict(exchange="sparse", pull_gate=True),
     ("rng", 4096), "run"),
    ("hybrid_sliced_gated", "rmat12", dict(exchange="sliced", pull_gate=True),
     ("rng", 4096), "run"),
    ("hybrid_ckpt", "rmat12", dict(lanes=256), ("rng", 256), "ckpt"),
]
CARD_WIDE_CASES = [
    ("wide_dense", "rmat12", dict(), ("rng", 4096), "run"),
    ("wide_sparse", "rmat12", dict(lanes=256, exchange="sparse"), ("rng", 256), "run"),
    ("wide_sparse_delta", "rmat12", dict(lanes=256, exchange="sparse", sparse_caps=(8, 64, 256),
                                         delta_bits=(8, 16)), ("rng", 256), "run"),
]

#: Lanes whose distances a record keeps of a batch over 128 lanes (those
#: below its width, and its last; a smaller batch keeps all, and its trees).
PICKS = [0, 4095, 4096, 8191]


def _host(x) -> np.ndarray:
    """A device tensor (the port's, maybe on a card) or array as numpy."""
    import torch

    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def record(eng, res, tables) -> dict:
    """What the parity tests compare of one batch; ``tables(eng, t)`` turns
    a result table into the chip-major host array (gathered on the mesh)."""
    s = len(res.sources)
    picks = range(s) if s <= 128 else sorted({i for i in PICKS if i < s} | {s - 1})
    out = {
        "levels": int(res.num_levels),
        "reached": np.asarray(res.reached),
        "edges": np.asarray(res.edges_traversed),
        "ecc": np.asarray(res.ecc),
        "dist": np.stack([res.distances_int32(i) for i in picks]),
        "vis": tables(eng, res._vis),
        "planes": [tables(eng, p) for p in res._planes],
        "counts": None if eng.last_exchange_level_counts is None
        else np.asarray(eng.last_exchange_level_counts),
        "bytes": eng.last_exchange_bytes,
        "labels": eng.exchange_branch_labels(),
        "gate": None if getattr(eng, "last_gate_level_counts", None) is None
        else _host(eng.last_gate_level_counts),
    }
    if s <= 128 and getattr(eng, "host_graph", None) is not None:
        v = eng.num_vertices
        out["parents"] = res.parents_into(np.empty((s, v), np.int32), device="device")
    return out


def assert_same(port: dict, jax: dict, where: str) -> None:
    """Two records (or checkpoints) equal field for field, bit for bit."""
    assert port.keys() == jax.keys(), where
    for key, a in port.items():
        b = jax[key]
        if key.startswith("ckpt"):
            for f, v in a.items():
                if f != "nonce":  # a random chain id
                    np.testing.assert_array_equal(v, b[f], err_msg=f"{where} {key}.{f}")
        elif key == "planes":
            assert len(a) == len(b), where
            for i, (pa, pb) in enumerate(zip(a, b)):
                np.testing.assert_array_equal(pa, pb, err_msg=f"{where} plane {i}")
        elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f"{where} {key}")
        else:
            assert a == b, f"{where} {key}: {a!r} != {b!r}"


def jax_text(msg: str) -> str:
    """A JAX refusal text as the port words it: the parenthesised reference
    to the JAX package's history reads "(the exchange planner)"."""
    return re.sub(r"\((?:the )?[A-Z]+ \d+(?: planner)?\)", "(the exchange planner)", msg)


def ckpt_fields(ckpt) -> dict:
    """A packed checkpoint's fields as plain values (either package's)."""
    return {f.name: getattr(ckpt, f.name) for f in dataclasses.fields(ckpt)}


def case_record(case, g, engine, build, p: int, tables) -> dict:
    """One case's record, for either package: ``engine(graph_or_dict,
    **kw)`` builds its mesh engine on its mesh of ``p`` ranks, ``build(g,
    p, **kw)`` is its ``build_dist_hybrid`` and ``tables(eng, t)`` a result
    table on the host, chip-major."""
    _name, _gname, kw, src_spec, mode = case
    sources = sources_of(src_spec, g)
    if mode == "reject":
        out = {}
        hd = build(g, p, layout="gather", **kw)
        for key, arg, ekw in (("layout", hd, {"exchange": "sliced"}),
                              ("shards", build(g, p + 1, **kw), {})):
            try:
                engine(arg, **ekw)
                out[key] = None
            except ValueError as exc:
                out[key] = str(exc)
        res = engine(hd).run(sources)  # a prebuilt dict of the right layout
        out["dist"] = np.stack([res.distances_int32(i) for i in range(len(sources))])
        return out
    eng = engine(g, **kw)
    if mode == "dispatch":
        pend = eng.dispatch(sources)
        return {"levels": int(pend.levels), "alive": bool(pend.alive),
                "truncated": bool(pend.truncated)}
    if mode == "ckpt":
        first = eng.advance(eng.start(sources), levels=2)
        last = eng.advance(first)
        out = record(eng, eng.finish(last), tables)
        out["ckpt2"] = ckpt_fields(first)
        out["ckpt_end"] = ckpt_fields(last)
        return out
    return record(eng, eng.run(sources), tables)


def _gathered(eng, t) -> np.ndarray:
    return eng._gather_rows(t).cpu().numpy().view(np.uint32)


def run_cases(mesh, kind, cases) -> dict:
    """Rank entry point: every case of ``cases`` ('wide' or 'hybrid'
    engines) on ``mesh``, keyed by case name."""
    from tpu_bfs_torch.graph import generate as tgen
    from tpu_bfs_torch.graph import io as tio
    from tpu_bfs_torch.parallel.dist_msbfs_hybrid import (
        DistHybridMsBfsEngine,
        build_dist_hybrid,
    )
    from tpu_bfs_torch.parallel.dist_msbfs_wide import DistWideMsBfsEngine

    cls = DistWideMsBfsEngine if kind == "wide" else DistHybridMsBfsEngine
    return {case[0]: case_record(case, graph_of(case[1], tgen, tio),
                                 lambda x, **kw: cls(x, mesh, **kw), build_dist_hybrid,
                                 mesh.num_shards, _gathered)
            for case in cases}


def sparse_gather_rank(mesh, cap):
    """Rank entry: one sparse row gather of two nonzero rows a rank, and
    this rank's count of them."""
    import torch

    from tpu_bfs_torch.parallel.collectives import row_gather_flags, sparse_rows_gather

    p, r = mesh.num_shards, mesh.rank
    nxt = torch.zeros((6, 2), dtype=torch.int32)
    nxt[r % 6] = torch.tensor([r + 1, -1], dtype=torch.int32)
    nxt[5] = r + 10
    count = int(row_gather_flags((nxt != 0).any(dim=1))[0])
    table = sparse_rows_gather(mesh, nxt, cap=cap, out_rows=6 * p,
                               gid_of=lambda ids: ids * p + r)
    return count, table.numpy()


def fail_on_rank_one(mesh):
    """Rank entry that raises on rank 1 (the launcher's error path)."""
    if mesh.rank == 1:
        raise ValueError("rank one fails")
    return mesh.rank


def loaded_modules(mesh):
    """Rank entry: the JAX and tpu_bfs modules this rank has imported."""
    import sys

    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "tpu_bfs"))


# --- the single-source mesh engines (DistBfsEngine, Dist2DBfsEngine) ---------

#: (name, graph, engine keywords, sources, mode) of tests/test_torch_dist_bfs.py
#: and tests/test_torch_dist2d.py. Modes: 'run' (every source's result and
#: the exchange record), 'ckpt' (start, 2 levels, the rest, finish) and
#: 'cap' (max_levels=3). Small caps make every sparse rung, the dense
#: fallback and both dopt branches run.
DIST_CASES = [
    ("ring", "random_small", dict(exchange="ring"), [0, 17, 499], "run"),
    ("allreduce", "rmat_small", dict(exchange="allreduce"), ("active", 3), "run"),
    ("sparse_rungs", "rmat_small", dict(exchange="sparse", sparse_caps=(1, 8, 64)),
     ("active", 3), "run"),
    ("sparse_default", "random_small", dict(exchange="sparse"), [0, 250], "run"),
    ("dopt", "rmat_small", dict(backend="dopt", dopt_caps=(16, 256)), ("active", 3), "run"),
    ("dopt_default", "random_small", dict(backend="dopt", exchange="allreduce"), [7], "run"),
    ("dopt_sparse_line", "line64", dict(backend="dopt", exchange="sparse", sparse_caps=(2,),
                                        dopt_caps=(4,)), [0, 40], "run"),
    ("segment_disconnected", "random_disconnected",
     dict(backend="segment", exchange="sparse", sparse_caps=(4, 32)), ("iso", [0, 5]), "run"),
    ("scatter", "random_small", dict(backend="scatter", exchange="allreduce"), [3], "run"),
    ("ckpt_sparse", "rmat_small", dict(exchange="sparse", sparse_caps=(4, 64)), [3], "ckpt"),
    ("cap", "line64", dict(), [0], "cap"),
]

#: The 2D cases. On meshes with more than one row, mesh rows may pick
#: different sparse rungs at one level; JAX's engine then deadlocks on its
#: virtual CPU devices, so 'sparse_rungs' runs against JAX on one-row
#: meshes only, and against the JAX ring case's results on the others.
#: 'sparse_ids' keeps every level on the id rung (rows never split).
DIST2D_CASES = [
    ("ring", "rmat_small", dict(exchange="ring"), ("active", 3), "run"),
    ("allreduce", "random_small", dict(exchange="allreduce"), [0, 17, 499], "run"),
    ("sparse_rungs", "rmat_small", dict(exchange="sparse", sparse_caps=(1, 8, 64)),
     ("active", 3), "run"),
    ("sparse_ids", "random_small", dict(exchange="sparse", sparse_caps=(10**6,)), [0, 250],
     "run"),
    ("dopt", "rmat_small", dict(backend="dopt", dopt_caps=(16, 256)), ("active", 3), "run"),
    ("dopt_line", "line64", dict(backend="dopt", exchange="allreduce", dopt_caps=(4,)),
     [0, 40], "run"),
    ("disconnected", "random_disconnected", dict(backend="segment"), ("iso", [0, 5]), "run"),
    ("ckpt", "rmat_small", dict(exchange="allreduce", backend="dopt"), [3], "ckpt"),
    ("cap", "line64", dict(backend="scatter"), [0], "cap"),
]

#: The 1D mesh sizes and 2D mesh shapes the parity tests run.
DIST_MESHES = [1, 2, 4, 8]
DIST2D_MESHES = [(1, 1), (1, 2), (2, 2), (2, 4)]


def bfs_fields(res) -> dict:
    """A single-source BfsResult's fields (either package's)."""
    return {"dist": np.asarray(res.distance), "parent": res.parent,
            "levels": int(res.num_levels), "reached": int(res.reached),
            "edges": int(res.edges_traversed)}


def exchange_fields(eng) -> dict:
    """A mesh engine's exchange record (either package's)."""
    counts = eng.last_exchange_level_counts
    return {"counts": None if counts is None else np.asarray(counts),
            "bytes": eng.last_exchange_bytes, "labels": eng.exchange_branch_labels(),
            "per_level": list(eng.wire_bytes_per_level())}


def dist_case_record(case, g, engine):
    """One single-source case's record and its engine, for either package:
    ``engine(g, **kw)`` builds the mesh engine."""
    _name, _gname, kw, src_spec, mode = case
    eng = engine(g, **kw)
    out = {}
    for s in (int(x) for x in sources_of(src_spec, g)):
        if mode == "ckpt":
            first = eng.advance(eng.start(s), levels=2)
            last = eng.advance(first)
            out[f"ckpt2_{s}"] = ckpt_fields(first)
            out[f"ckpt_end_{s}"] = ckpt_fields(last)
            res = eng.finish(last)
        else:
            res = eng.run(s, max_levels=3 if mode == "cap" else None)
        out.update({f"{k}_{s}": v for k, v in bfs_fields(res).items()})
        out.update({f"{k}_{s}": v for k, v in exchange_fields(eng).items()})
    return out, eng


def run_dist_cases(mesh, shape, cases) -> dict:
    """Rank entry point: every single-source case on ``mesh``, 1D for an
    int ``shape`` and 2D for an (R, C) one, keyed by case name; with the
    host syncs of each case's last run."""
    from tpu_bfs_torch.graph import generate as tgen
    from tpu_bfs_torch.graph import io as tio
    from tpu_bfs_torch.parallel.dist_bfs import DistBfsEngine
    from tpu_bfs_torch.parallel.dist_bfs2d import Dist2DBfsEngine
    from tpu_bfs_torch.parallel.mesh import make_mesh_2d

    if isinstance(shape, tuple):
        m2 = make_mesh_2d(*shape, mesh=mesh)
        make = lambda g, **kw: Dist2DBfsEngine(g, m2, **kw)  # noqa: E731
    else:
        make = lambda g, **kw: DistBfsEngine(g, mesh, **kw)  # noqa: E731
    out = {}
    for case in cases:
        rec, eng = dist_case_record(case, graph_of(case[1], tgen, tio), make)
        out[case[0]] = (rec, eng.last_host_syncs)
    return out


def collectives_rank(mesh, n: int, caps, seed: int) -> dict:
    """Rank entry: the single-source exchanges on seeded per-rank inputs
    (bool [P*n] at three densities, int32 [P*n]); each result all-gathered
    in rank order."""
    import torch

    from tpu_bfs_torch.parallel import collectives as coll

    p, r = mesh.num_shards, mesh.rank
    rng = np.random.default_rng(seed + r)
    out = {}
    for dens in (0.002, 0.05, 0.5):
        x = torch.from_numpy(rng.random(p * n) < dens)
        hit, branch = coll.sparse_exchange_or(x, mesh, caps=caps)
        out[f"sparse_{dens}"] = mesh.all_gather_rows(hit).numpy()
        out[f"branch_{dens}"] = branch
        for impl in ("ring", "allreduce"):
            got = coll.reduce_scatter_or(x, mesh, impl=impl)
            out[f"{impl}_{dens}"] = mesh.all_gather_rows(got).numpy()
    vals = torch.from_numpy(rng.integers(-50, 2**31 - 1, size=p * n).astype(np.int32))
    for impl in ("ring", "allreduce"):
        got = coll.reduce_scatter_min(vals, mesh, impl=impl)
        out[f"min_{impl}"] = mesh.all_gather_rows(got).numpy()
    return out


def collectives_inputs(p: int, n: int, seed: int):
    """Every rank's inputs of :func:`collectives_rank`, stacked [P, P*n]:
    the bool arrays by density and the int32 array."""
    bools = {d: [] for d in (0.002, 0.05, 0.5)}
    ints = []
    for r in range(p):
        rng = np.random.default_rng(seed + r)
        for d in bools:
            bools[d].append(rng.random(p * n) < d)
        ints.append(rng.integers(-50, 2**31 - 1, size=p * n).astype(np.int32))
    return {d: np.stack(v) for d, v in bools.items()}, np.stack(ints)


def dist_loaded_modules(mesh):
    """Rank entry: build and run the single-source mesh engines (with the
    planner's knobs), DistSsspEngine and the kinds over the mesh wide
    engine, then list the JAX and tpu_bfs modules this rank has imported."""
    import sys

    from tpu_bfs_torch.graph import generate as tgen
    from tpu_bfs_torch.graph import io as tio
    from tpu_bfs_torch.parallel.dist_bfs import DistBfsEngine
    from tpu_bfs_torch.parallel.dist_bfs2d import Dist2DBfsEngine
    from tpu_bfs_torch.parallel.dist_sssp import DistSsspEngine
    from tpu_bfs_torch.parallel.mesh import make_mesh_2d

    g = graph_of("random_small", tgen, tio)
    planner = dict(wire_pack=True, delta_bits=(8, 16), sieve=True, predict=True)
    DistBfsEngine(g, mesh, exchange="sparse", backend="dopt", **planner).run(0)
    Dist2DBfsEngine(g, make_mesh_2d(1, mesh.num_shards, mesh=mesh), exchange="sparse",
                    **planner).run(0)
    DistSsspEngine(sssp_graph(tgen), mesh, lanes=4, exchange="sparse", delta_bits=(8,),
                   predict=True).run(np.asarray(SSSP_SOURCES[:4]))
    mesh_kinds_rank(mesh)
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "tpu_bfs"))


def exit_after_peers(mesh, marker_dir: str):
    """Rank entry of the launcher's exit check: rank 1 finishes 1.5 s after
    rank 0, and rank 0 records when its process exits."""
    import atexit
    import time
    from pathlib import Path

    if mesh.rank == 0:
        atexit.register(lambda: Path(marker_dir, "rank0_exit").write_text(repr(time.time())))
    else:
        time.sleep(1.5)
        Path(marker_dir, f"rank{mesh.rank}_done").write_text(repr(time.time()))
    return mesh.rank


def ckpt_cross_rank(mesh, shape, path: str) -> dict:
    """Rank entry: a 1D traversal checkpointed at level 2 (rank 0 saves it
    to ``path``) finishes on a 2D mesh of ``shape`` over the same ranks,
    and a 2D checkpoint one level later finishes back on the 1D engine."""
    from tpu_bfs_torch.graph import generate as tgen
    from tpu_bfs_torch.graph import io as tio
    from tpu_bfs_torch.parallel.dist_bfs import DistBfsEngine
    from tpu_bfs_torch.parallel.dist_bfs2d import Dist2DBfsEngine
    from tpu_bfs_torch.parallel.mesh import make_mesh_2d
    from tpu_bfs_torch.utils.checkpoint import save_checkpoint

    g = graph_of("rmat_small", tgen, tio)
    one = DistBfsEngine(g, mesh, exchange="sparse", sparse_caps=(4, 64))
    ck = one.advance(one.start(3), levels=2)
    if mesh.rank == 0:
        save_checkpoint(path, ck)
    two = Dist2DBfsEngine(g, make_mesh_2d(*shape, mesh=mesh), backend="dopt",
                          exchange="sparse")
    res = two.finish(two.advance(ck))
    back = one.finish(one.advance(two.advance(ck, levels=1)))
    return {"level": ck.level, "dist": res.distance, "parent": res.parent,
            "back_dist": back.distance, "back_parent": back.parent}


#: The card tests' single-source mesh runs (tests/test_torch_cuda.py).
CARD_DIST_RUNS = [dict(exchange="ring"), dict(exchange="allreduce"),
                  dict(exchange="sparse"), dict(exchange="sparse", backend="dopt"),
                  dict(exchange="sparse", wire_pack=True, delta_bits=(8, 16), sieve=True,
                       predict=True)]


def card_dist_rank(mesh, shape, sources) -> dict:
    """Rank entry: every ``CARD_DIST_RUNS`` engine on RMAT 12, 1D for an
    int ``shape`` and 2D for an (R, C) one, from each source (and one
    checkpointed traversal); {(run, source): (distances, parents)}."""
    from tpu_bfs_torch.graph import generate as tgen
    from tpu_bfs_torch.graph import io as tio
    from tpu_bfs_torch.parallel.dist_bfs import DistBfsEngine
    from tpu_bfs_torch.parallel.dist_bfs2d import Dist2DBfsEngine
    from tpu_bfs_torch.parallel.mesh import make_mesh_2d

    g = graph_of("rmat12", tgen, tio)
    m2 = make_mesh_2d(*shape, mesh=mesh) if isinstance(shape, tuple) else None
    out = {}
    for i, kw in enumerate(CARD_DIST_RUNS):
        eng = Dist2DBfsEngine(g, m2, **kw) if m2 else DistBfsEngine(g, mesh, **kw)
        for s in sources:
            r = eng.run(int(s))
            out[(i, int(s))] = (r.distance, r.parent)
        r = eng.finish(eng.advance(eng.advance(eng.start(int(sources[0])), levels=2)))
        out[(i, "ckpt")] = (r.distance, r.parent)
    return out


# --- the exchange planner (tests/test_torch_planner.py) ----------------------

#: (name, planner keywords) of the exchange-level planner checks. The host
#: carries (prev_biggest, growing) are part of a case; the visited chunk and
#: its mesh total come from the inputs. The last case predicts dense.
PLANNER_EXCHANGES = [
    ("delta", dict(delta_bits=(8, 16))),
    ("delta_sieve", dict(delta_bits=(8, 16), sieve=True)),
    ("sieve_packed", dict(sieve=True, wire_pack=True)),
    ("predict_measured", dict(predict=True, prev_biggest=10, growing=True)),
    ("all", dict(delta_bits=(4, 8, 16), sieve=True, predict=True, prev_biggest=1000,
                 growing=False, wire_pack=True)),
    ("predicted", dict(predict=True, prev_biggest=1000, growing=True, delta_bits=(8,))),
]
PLANNER_DENSITIES = (0.002, 0.05, 0.5)


def planner_inputs(p: int, n: int, seed: int):
    """Every rank's inputs of :func:`planner_rank`, stacked: the bool [P,
    P*n] contributions by density and the [P, n] visited chunks."""
    contrib = {d: [] for d in PLANNER_DENSITIES}
    vis = []
    for r in range(p):
        rng = np.random.default_rng(seed + r)
        for d in PLANNER_DENSITIES:
            contrib[d].append(rng.random(p * n) < d)
        vis.append(rng.random(n) < (0.9 if r % 2 == 0 else 0.3))
    return {d: np.stack(v) for d, v in contrib.items()}, np.stack(vis)


def planner_rank(mesh, n: int, caps, seed: int) -> dict:
    """Rank entry: the packed reduce-scatters, the packed sparse fallback
    and every ``PLANNER_EXCHANGES`` case at each density; results
    all-gathered in rank order (hits, and the claims ``hit & ~visited``),
    branches and carried counts."""
    import torch

    from tpu_bfs_torch.parallel import collectives as coll

    p, r = mesh.num_shards, mesh.rank
    contrib, vis = planner_inputs(p, n, seed)
    visited = torch.from_numpy(vis[r])
    total = int(mesh.all_reduce_(visited.sum(dtype=torch.int64).reshape(1), "sum").item())
    out = {}
    for d in PLANNER_DENSITIES:
        x = torch.from_numpy(contrib[d][r])
        for impl in ("ring", "allreduce"):
            got = coll.reduce_scatter_or(x, mesh, impl=impl, wire_pack=True)
            out[f"packed_{impl}_{d}"] = mesh.all_gather_rows(got).numpy()
        hit, branch = coll.sparse_exchange_or(x, mesh, caps=caps, wire_pack=True)
        out[f"sparse_packed_{d}"] = (mesh.all_gather_rows(hit).numpy(), branch)
        for name, kw in PLANNER_EXCHANGES:
            hit, branch, biggest = coll.planned_sparse_exchange_or(
                x, mesh, caps=caps, visited=visited, visited_total=total, **kw)
            out[f"{name}_{d}"] = (mesh.all_gather_rows(hit).numpy(),
                                  mesh.all_gather_rows(hit & ~visited).numpy(), branch, biggest)
    return out


# --- the planner on the mesh engines (tests/test_torch_mesh_planner.py) ------

#: Planner cases of DistBfsEngine, every knob on its own and together; small
#: caps make the rungs, the encodings and the dense fallback all run.
PLANNER_DIST_CASES = [
    ("wire_pack", "random_small", dict(exchange="ring", wire_pack=True), [0, 17], "run"),
    ("wire_pack_allreduce", "rmat_small", dict(exchange="allreduce", wire_pack=True),
     ("active", 2), "run"),
    ("delta_bits", "rmat_small", dict(exchange="sparse", sparse_caps=(4, 64),
                                      delta_bits=(8, 16)), ("active", 3), "run"),
    ("sieve", "rmat12", dict(exchange="sparse", sparse_caps=(16, 256), sieve=True),
     ("active", 2), "run"),
    ("predict", "rmat_small", dict(exchange="sparse", sparse_caps=(2, 16), predict=True),
     ("active", 3), "run"),
    ("all_dopt_ckpt", "rmat_small", dict(exchange="sparse", sparse_caps=(4, 64), backend="dopt",
                                         wire_pack=True, delta_bits=(8, 16), sieve=True,
                                         predict=True), [3], "ckpt"),
]

#: The 2D planner cases. 'ids_delta16' keeps every level on one rung and one
#: encoding (a cap above any row chunk, 16-bit deltas), so mesh rows never
#: split and JAX runs it on every shape; the others may split rows, which
#: deadlocks JAX's engine on its virtual devices (see DIST2D_CASES), so on
#: meshes with more than one row they are held to JAX's ring records.
PLANNER_DIST2D_CASES = [
    ("wire_pack", "rmat_small", dict(exchange="ring", wire_pack=True), ("active", 3), "run"),
    ("ids_delta16", "random_small", dict(exchange="sparse", sparse_caps=(2048,),
                                         delta_bits=(16,), wire_pack=True), [0, 250], "run"),
    ("planner", "rmat_small", dict(exchange="sparse", sparse_caps=(2, 16), delta_bits=(8, 16),
                                   sieve=True, predict=True), ("active", 3), "run"),
    ("planner_ckpt", "rmat_small", dict(exchange="sparse", backend="dopt", delta_bits=(8, 16),
                                        predict=True), [3], "ckpt"),
]

#: The packed mesh engines' planner knobs (the sparse row gather's delta
#: ids; wire_pack recorded).
PLANNER_WIDE_CASES = [
    ("delta", "rmat_small", dict(lanes=64, exchange="sparse", sparse_caps=(2, 24, 200),
                                 delta_bits=(8, 16), wire_pack=True), ("active", 40), "run"),
    ("delta_ckpt", "rmat_small", dict(lanes=64, exchange="sparse", delta_bits=(4,)),
     ("active", 20), "ckpt"),
]
PLANNER_HYBRID_CASES = [
    ("delta", "random_small", dict(tile_thr=4, exchange="sparse", sparse_caps=(4, 40, 300),
                                   delta_bits=(8, 16), wire_pack=True), ("rng", 80), "run"),
]


def planner_engines_rank(mesh, shape) -> dict:
    """Rank entry of the planner's engine checks on ``mesh``: for an int
    ``shape`` the 1D cases and the packed engines' cases, for an (R, C)
    one the 2D cases; with each single-source case's host reads."""
    out = {"dist": run_dist_cases(mesh, shape, PLANNER_DIST2D_CASES if isinstance(shape, tuple)
                                  else PLANNER_DIST_CASES)}
    if not isinstance(shape, tuple):
        out["wide"] = run_cases(mesh, "wide", PLANNER_WIDE_CASES)
        out["hybrid"] = run_cases(mesh, "hybrid", PLANNER_HYBRID_CASES)
    return out


# --- the mesh SSSP engine (tests/test_torch_mesh_sssp.py) ----------------------

#: (name, DistSsspEngine keywords, mesh shape or None for 1D) and the mesh
#: sizes each runs on; the JAX test's graph and sources.
SSSP_CASES = [
    ("ring", dict(exchange="ring"), None, (1, 2, 4, 8)),
    ("allreduce", dict(exchange="allreduce"), None, (2, 4)),
    ("sparse", dict(exchange="sparse"), None, (1, 2, 4, 8)),
    ("sparse_small_caps", dict(exchange="sparse", sparse_caps=(2, 8)), None, (4,)),
    ("planner", dict(exchange="sparse", delta_bits=(8, 16), predict=True), None, (1, 4, 8)),
    ("2d", dict(exchange="allreduce"), (2, 2), (4,)),
    ("2d", dict(exchange="allreduce"), (2, 4), (8,)),
]
SSSP_SOURCES = [0, 7, 33, 95, 1, 64]
SSSP_MESHES = [1, 2, 4, 8]


def sssp_graph(gen):
    """The JAX mesh-kinds test's weighted graph."""
    return gen.random_graph(96, 480, seed=3, weights=5)


def sssp_fields(eng, res) -> dict:
    """A mesh SSSP batch's record (either package's)."""
    return {"dist": np.stack([res.distances_int32(i) for i in range(len(res.sources))]),
            "rounds": int(res.rounds), "reached": np.asarray(res.reached),
            "ecc": np.asarray(res.ecc), "counts": np.asarray(eng.last_exchange_level_counts),
            "bytes": eng.last_exchange_bytes, "labels": eng.exchange_branch_labels(),
            "per_level": list(eng.wire_bytes_per_level())}


def sssp_rank(mesh, p: int) -> dict:
    """Rank entry: every SSSP case that runs on ``p`` ranks, keyed by (name,
    shape), each with the host reads and closes of its batch."""
    from tpu_bfs_torch.graph import generate as tgen
    from tpu_bfs_torch.parallel.dist_sssp import DistSsspEngine
    from tpu_bfs_torch.parallel.mesh import make_mesh_2d

    g = sssp_graph(tgen)
    out = {}
    for name, kw, shape, sizes in SSSP_CASES:
        if p not in sizes:
            continue
        m = make_mesh_2d(*shape, mesh=mesh) if shape else mesh
        eng = DistSsspEngine(g, m, lanes=32, **kw)
        res = eng.run(np.asarray(SSSP_SOURCES))
        out[(name, shape)] = (sssp_fields(eng, res), eng.last_host_reads, eng.last_closes)
    return out


# --- the workload kinds on the mesh (tests/test_torch_mesh_kinds.py) ----------

#: (name, kind, DistWideMsBfsEngine keywords): the 1D rows of the JAX
#: package's mesh-kinds matrix.
MESH_KINDS = [
    ("cc-dense", "cc", dict(lanes=64, exchange="dense")),
    ("cc-sparse", "cc", dict(lanes=64, exchange="sparse")),
    ("khop-sparse", "khop", dict(lanes=64, exchange="sparse", delta_bits=(8, 16))),
    ("p2p-sparse", "p2p", dict(lanes=64, exchange="sparse")),
]
KIND_SOURCES = [0, 7, 33, 95, 1, 64]
P2P_TARGETS = [95, 60, 41, 2, 90, 3]


def kind_fields(kind: str, eng) -> dict:
    """One kind's answers over the JAX test's graph and sources (either
    package's adapter ``eng``)."""
    src = np.asarray(KIND_SOURCES, dtype=np.int64)
    if kind == "cc":
        res = eng.run(src[:3])
        return {"extras": [res.extras(i) for i in range(3)], "reached": np.asarray(res.reached)}
    if kind == "khop":
        res = eng.run(src, k=2)
        return {"reached": np.asarray(res.reached), "extras": [res.extras(i) for i in range(6)]}
    res = eng.run(src, targets=np.asarray(P2P_TARGETS, dtype=np.int64))
    return {"extras": [res.extras(i) for i in range(6)], "reached": np.asarray(res.reached),
            "levels": np.asarray(res.ecc)}


def mesh_kinds_rank(mesh) -> dict:
    """Rank entry: every ``MESH_KINDS`` adapter over a DistWideMsBfsEngine
    on ``mesh``, built through ``build_workload_engine``; with the base's
    row map, p2p's host reads and whether its parent scanner was kept."""
    import dataclasses

    from tpu_bfs_torch import workloads as tw
    from tpu_bfs_torch.graph import generate as tgen
    from tpu_bfs_torch.parallel.dist_msbfs_wide import DistWideMsBfsEngine

    g = sssp_graph(tgen)

    @dataclasses.dataclass
    class Spec:
        lanes: int

    out = {}
    for name, kind, kw in MESH_KINDS:
        base = DistWideMsBfsEngine(g, mesh, **kw)
        eng = tw.build_workload_engine(kind, base, g, Spec(kw["lanes"]))
        out[name] = kind_fields(kind, eng)
        if kind == "p2p":
            out["p2p_reads"] = eng.last_host_reads
            out["row_map"] = tw.id_of_row_map(base)
            # The walk's scanner stays on the base for the next batch.
            out["p2p_scanner_kept"] = bool(getattr(base, "_parent_scanner_cache", None))
    return out


def workload_engine_rank(mesh, shape) -> tuple:
    """Rank entry: ``build_workload_engine('sssp', ...)`` with ``devices`` the
    group's size (and ``mesh_shape``): the engine's class name, mesh shape
    and exchange, and one batch's distances."""
    import dataclasses

    from tpu_bfs_torch import workloads as tw
    from tpu_bfs_torch.graph import generate as tgen

    @dataclasses.dataclass
    class Spec:
        lanes: int = 4
        devices: int = mesh.num_shards
        device: str = "cpu"
        mesh_shape: tuple = shape

    eng = tw.build_workload_engine("sssp", None, sssp_graph(tgen), Spec())
    res = eng.run(np.asarray(SSSP_SOURCES[:4]))
    return (type(eng).__name__, eng._exchange, type(eng.mesh).__name__,
            np.stack([res.distances_int32(i) for i in range(4)]))


#: The card tests' mesh SSSP runs (tests/test_torch_cuda.py).
CARD_SSSP_RUNS = [dict(exchange="ring"), dict(exchange="allreduce"),
                  dict(exchange="sparse", delta_bits=(8, 16), predict=True)]


def shard_minplus_errs(eng, dist) -> list:
    """K1 minplus on a DistSsspEngine's shard tables against its plain twin,
    over every bucket, on the light plane and on the heavy close's: the
    largest absolute difference of each (launches not counted)."""
    import torch

    from tpu_bfs_torch.ops import ell_expand as k1

    saved = k1.ell_expand.launches
    names = (["virtual"] if eng.sell.virtual is not None else []) + [
        f"light{i}" for i in range(len(eng.sell.light))]
    errs = []
    for suf in ("wl", "w"):
        got, want = ([fn(eng.arrs[f"{n}_need"], eng.arrs[f"{n}_gt"], dist,
                         eng.arrs[f"{n}_{suf}_gt"], op="minplus") for n in names]
                     for fn in (k1.ell_expand, k1.ell_expand_plain))
        errs.append(max(int((a.long() - b.long()).abs().max()) for a, b in zip(got, want)))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    k1.ell_expand.launches = saved
    return errs


def card_sssp_rank(mesh) -> dict:
    """Rank entry: every ``CARD_SSSP_RUNS`` DistSsspEngine on weighted RMAT
    12 at 128 lanes; per run the distance table (rank order), rounds,
    closes, host reads, K1 launches and buckets, and K1 against its twin on
    the rank's shard tables."""
    from tpu_bfs_torch.graph.generate import rmat_graph
    from tpu_bfs_torch.ops import ell_expand as k1
    from tpu_bfs_torch.parallel.dist_sssp import DistSsspEngine

    g = rmat_graph(12, 16, seed=11, weights=8)
    src = np.random.default_rng(5).integers(0, g.num_vertices, size=128)
    out = {}
    for i, kw in enumerate(CARD_SSSP_RUNS):
        eng = DistSsspEngine(g, mesh, lanes=128, **kw)
        before = k1.ell_expand.launches
        res = eng.run(src)
        out[i] = {"dists": np.stack([res.distances_int32(j) for j in (0, 77, 127)]),
                  "rounds": res.rounds, "closes": eng.last_closes,
                  "reads": eng.last_host_reads, "launches": k1.ell_expand.launches - before,
                  "buckets": (eng.sell.virtual is not None) + len(eng.sell.light),
                  "errs": shard_minplus_errs(eng, res._dist),
                  "counts": np.asarray(eng.last_exchange_level_counts)}
    return out


# Engine-trace cases (tests/test_torch_trace.py): (name, graph, engine
# keywords, source, levels of a first chunk or None). A chunked case
# records the trace of its resumed chunk (level0 > 0).
TRACE_CASES_1D = [
    ("ring", "rmat_small", dict(exchange="ring"), 3, None),
    ("allreduce_dopt", "rmat_small", dict(exchange="allreduce", backend="dopt"), 3, None),
    ("sparse", "rmat_small", dict(exchange="sparse", sparse_caps=(1, 8, 64)), 3, None),
    ("planned", "rmat_small", dict(exchange="sparse", delta_bits=(8, 16), sieve=True,
                                   predict=True), 3, None),
    ("resumed", "rmat_small", dict(exchange="sparse"), 3, 2),
    ("path100", "path100", dict(exchange="ring"), 0, None),
]
TRACE_CASES_2D = [
    ("ring", "rmat_small", dict(exchange="ring"), 3, None),
    ("dopt", "rmat_small", dict(exchange="allreduce", backend="dopt"), 3, None),
    ("resumed", "rmat_small", dict(exchange="ring"), 3, 2),
]
TRACE_CASES_2D_ONE_ROW = [  # sparse 2D: JAX deadlocks when mesh rows split
    ("sparse", "rmat_small", dict(exchange="sparse", sparse_caps=(1, 8, 64)), 3, None),
]
GRAPHS["path100"] = lambda gen, io: _path(io, 100)


def trace_case_record(case, g, engine) -> dict:
    """One trace case's rows and summary (either package)."""
    _name, _gname, kw, source, first = case
    eng = engine(g, **kw)
    if first is None:
        eng.run(source)
    else:
        eng.advance(eng.advance(eng.start(source), levels=first))
    return {"trace": eng.last_run_trace, "summary": trace_summary_of(eng)}


def trace_summary_of(eng) -> dict:
    from tpu_bfs_torch.obs.engine_trace import trace_summary

    return trace_summary(eng.last_run_trace, eng)


def run_trace_cases(mesh, shape, cases, packed=()) -> dict:
    """Rank entry point: the single-source trace cases on ``mesh`` (1D for
    an int ``shape``, 2D for an (R, C) one), then the packed mesh cases
    (name, graph, engine keywords, sources) with the recorder armed."""
    from tpu_bfs_torch import obs
    from tpu_bfs_torch.graph import generate as tgen
    from tpu_bfs_torch.graph import io as tio
    from tpu_bfs_torch.parallel.dist_bfs import DistBfsEngine
    from tpu_bfs_torch.parallel.dist_bfs2d import Dist2DBfsEngine
    from tpu_bfs_torch.parallel.dist_msbfs_wide import DistWideMsBfsEngine
    from tpu_bfs_torch.parallel.mesh import make_mesh_2d

    if isinstance(shape, tuple):
        m2 = make_mesh_2d(*shape, mesh=mesh)
        make = lambda g, **kw: Dist2DBfsEngine(g, m2, **kw)  # noqa: E731
    else:
        make = lambda g, **kw: DistBfsEngine(g, mesh, **kw)  # noqa: E731
    out = {case[0]: trace_case_record(case, graph_of(case[1], tgen, tio), make)
           for case in cases}
    obs.arm()
    try:
        for name, gname, kw, sources in packed:
            eng = DistWideMsBfsEngine(graph_of(gname, tgen, tio), mesh, **kw)
            eng.run(np.asarray(sources))
            out[name] = {"trace": eng.last_run_trace, "summary": trace_summary_of(eng)}
    finally:
        obs.disarm()
    return out


def mesh_serve_shard_k1(rank, g, lanes: int, sources) -> int:
    """Serving-mesh entry (``parallel/mesh.MeshController.build`` runs it on
    each rank of the 2-rank rung): a ``DistWideMsBfsEngine`` batch on the
    rank's device, then K1 on the rank's own shard tables against its twin
    over the batch's gathered visited table. Returns the mismatched words
    summed over the rung."""
    import torch

    from tpu_bfs_torch.ops import ell_expand as k1
    from tpu_bfs_torch.parallel.dist_msbfs_wide import DistWideMsBfsEngine

    mesh = rank.mesh(2)
    eng = DistWideMsBfsEngine(g, mesh, lanes=lanes, num_planes=8)
    res = eng.run(np.asarray(sources))
    fw = eng._exchange_rows(res._vis, 0)
    names = (["virtual"] if eng.sell.virtual is not None else []) + [
        f"light{i}" for i in range(len(eng.sell.light))]
    bad = torch.zeros(1, dtype=torch.int64, device=mesh.device)
    for n in names:
        got = k1.ell_expand(eng.arrs[f"{n}_need"], eng.arrs[f"{n}_gt"], fw, op="or")
        want = k1.ell_expand_plain(eng.arrs[f"{n}_need"], eng.arrs[f"{n}_gt"], fw, op="or")
        bad += (got != want).sum()
    return int(mesh.all_reduce_(bad, "sum").item())


def fail_dispatch_on_rank(rank, target: int) -> None:
    """Serving-mesh entry (``MeshController.build`` on every rank): from now
    on ``DistWideMsBfsEngine.dispatch`` raises on rank ``target`` alone, as
    an out-of-memory on one of several ranks sharing a card would."""
    if rank.rank != target:
        return

    from tpu_bfs_torch.parallel.dist_msbfs_wide import DistWideMsBfsEngine

    def dispatch(self, *args, **kw):
        raise RuntimeError(f"rank {target} alone cannot dispatch")

    DistWideMsBfsEngine.dispatch = dispatch


# --- mesh AOT (tests/test_torch_mesh_aot.py) ------------------------------------

#: (name, engine family, graph, engine keywords, sources, mesh sizes): each
#: case's engine exports its rank-local programs, and a fresh engine on
#: every rank adopts them.
MESH_AOT_CASES = [
    ("wide", "wide", "rmat_small", dict(lanes=64), ("rng", 64), (1, 2, 4)),
    ("wide_sparse", "wide", "rmat_small",
     dict(lanes=64, exchange="sparse", delta_bits=(8, 16)), ("active", 40), (2, 4)),
    ("hybrid", "hybrid", "rmat_small", dict(tile_thr=16), ("rng", 64), (1, 2, 4)),
    ("hybrid_gated", "hybrid", "rmat_small", dict(tile_thr=300, kcap=8, pull_gate=True),
     ("active", 40), (1, 2, 4)),
    ("sliced", "hybrid", "rmat_small", dict(tile_thr=16, exchange="sliced"), ("rng", 64),
     (2, 4)),
    ("sliced_gated", "hybrid", "rmat_small", dict(tile_thr=8, exchange="sliced",
                                                  pull_gate=True), ("active", 40), (4,)),
    ("sssp", "sssp", "sssp", dict(lanes=32), None, (1, 2, 4)),
    ("sssp_sparse", "sssp", "sssp", dict(lanes=32, exchange="sparse", predict=True), None,
     (4,)),
]
#: (name, (rows, cols), Dist2DBfsEngine keywords, sources): the 2D cases,
#: each on the mesh of its rows x cols ranks.
MESH_AOT_2D = [
    ("2d_1x2", (1, 2), dict(exchange="ring", backend="dopt"), [0, 3, 77]),
    ("2d_2x2", (2, 2), dict(exchange="allreduce", backend="scan"), [0, 3, 77]),
]


def mesh_aot_key(name: str, p: int) -> dict:
    """The program key a case's store is written under."""
    return {"graph_key": name, "engine": name, "lanes": 64, "planes": 5, "devices": p}


def mesh_aot_engine(case, mesh, pkg_engines, gen, io):
    """``(make, run)`` of a 1D case for either package: ``make()`` builds
    its engine on ``mesh``, ``run(eng)`` its record."""
    name, family, gname, kw, src_spec, _sizes = case
    cls = pkg_engines[family]
    if family == "sssp":
        g = sssp_graph(gen)
        src = np.asarray(SSSP_SOURCES)
        return (lambda: cls(g, mesh, **kw)), (lambda eng: sssp_fields(eng, eng.run(src)))
    g = graph_of(gname, gen, io)
    src = sources_of(src_spec, g)
    tables = _gathered if pkg_engines.get("port") else (lambda eng, t: np.asarray(t))
    return (lambda: cls(g, mesh, **kw)), (lambda eng: record(eng, eng.run(src), tables))


def _adopt_case(make, run, root: str, key: dict, aot) -> dict:
    """Eager run, export, a fresh engine adopting, its run: the record."""
    import os

    eng = make()
    eager = run(eng)
    store = aot.ArtifactStore(os.path.join(root, key["graph_key"]))
    names = aot.export_engine_programs(eng, key, store)
    fresh = make()
    adopted = aot.adopt_engine_programs(fresh, key, store)
    got = run(fresh)
    calls = {n: (getattr(fresh, attr).calls, getattr(fresh, attr).fallback_calls)
             for n, attr, *_ in fresh.export_programs() if n in adopted}
    return {"eager": eager, "adopted": got, "names": names, "adopted_names": adopted,
            "calls": calls, "counts": store.counts(), "layout": aot.layout_digest(fresh)}


def _rank_flags(mesh, values) -> np.ndarray:
    """[P, n] int64: every rank's ``values`` (n ints), in rank order."""
    import torch

    t = torch.tensor([list(values)], dtype=torch.int64, device=mesh.device)
    return mesh.all_gather_rows(t).cpu().numpy()


def _fault_arms(mesh, root: str, make, run, key: dict, aot) -> dict:
    """On a copy of a case's store: rank 1's artifact corrupted (rank 1
    quarantines it and runs eagerly, the others adopt), then rank 1's
    artifact copied over rank 0's (stale for rank 0: not quarantined).
    Every rank's (adopted, fallbacks, quarantined) and the runs' records."""
    import os
    import shutil

    import torch.distributed as dist

    src_dir = os.path.join(root, key["graph_key"])
    out = {}
    for arm in ("corrupt", "stale"):
        arm_dir = os.path.join(root, f"{key['graph_key']}_{arm}")
        r0 = aot.ArtifactStore(src_dir).path_for(key, "dist_core")
        r1 = aot.ArtifactStore(src_dir).path_for(key, aot.rank_program_name("dist_core", 1))
        if mesh.rank == 0:
            shutil.copytree(src_dir, arm_dir)
            if arm == "corrupt":
                with open(os.path.join(arm_dir, os.path.basename(r1)), "r+b") as f:
                    f.seek(-10, os.SEEK_END)
                    byte = f.read(1)
                    f.seek(-10, os.SEEK_END)
                    f.write(bytes([byte[0] ^ 0xFF]))
            else:
                shutil.copyfile(os.path.join(arm_dir, os.path.basename(r1)),
                                os.path.join(arm_dir, os.path.basename(r0)))
        dist.barrier(group=mesh.group)
        store = aot.ArtifactStore(arm_dir)
        fresh = make()
        adopted = aot.adopt_engine_programs(fresh, key, store)
        own = store.path_for(key, aot.rank_program_name("dist_core", mesh.rank))
        c = store.counts()
        out[arm] = {"ranks": _rank_flags(mesh, (len(adopted), c["aot_fallbacks"],
                                                c["aot_hits"], os.path.exists(own + ".corrupt"))),
                    "record": run(fresh)}
    return out


def mesh_aot_rank(mesh, root: str) -> dict:
    """Rank entry: every ``MESH_AOT_CASES`` case that runs on this mesh's
    size, exported and adopted (:func:`_adopt_case`), the fault arms on the
    wide case, the 2D case of this size, and every rank's layout digest of
    the wide case (rank constants enter it)."""
    from tpu_bfs_torch.graph import generate as tgen
    from tpu_bfs_torch.graph import io as tio
    from tpu_bfs_torch.parallel.dist_bfs2d import Dist2DBfsEngine
    from tpu_bfs_torch.parallel.dist_msbfs_hybrid import DistHybridMsBfsEngine
    from tpu_bfs_torch.parallel.dist_msbfs_wide import DistWideMsBfsEngine
    from tpu_bfs_torch.parallel.dist_sssp import DistSsspEngine
    from tpu_bfs_torch.parallel.mesh import make_mesh_2d
    from tpu_bfs_torch.utils import aot

    p = mesh.num_shards
    engines = {"wide": DistWideMsBfsEngine, "hybrid": DistHybridMsBfsEngine,
               "sssp": DistSsspEngine, "port": True}
    out = {}
    for case in MESH_AOT_CASES:
        if p not in case[5]:
            continue
        make, run = mesh_aot_engine(case, mesh, engines, tgen, tio)
        key = mesh_aot_key(case[0], p)
        out[case[0]] = _adopt_case(make, run, root, key, aot)
        if case[0] == "wide" and p > 1:
            out["faults"] = _fault_arms(mesh, root, make, run, key, aot)
            out["layouts"] = _rank_flags(mesh, [int(out["wide"]["layout"][:15], 16)])
    g = graph_of("rmat_small", tgen, tio)
    for name, shape, kw, sources in MESH_AOT_2D:
        if shape[0] * shape[1] != p:
            continue
        m2 = make_mesh_2d(*shape, mesh=mesh)
        case = (name, "rmat_small", kw, sources, "run")
        out[name] = _adopt_case(lambda: Dist2DBfsEngine(g, m2, **kw),
                                lambda eng: dist_case_record(case, g, lambda g_, **k: eng)[0],
                                root, mesh_aot_key(name, p), aot)
    return out


# --- the checksummed ring of integrity/wire.py (tests/test_torch_wirecheck.py) ---


class CorruptingMesh:
    """A mesh whose ``ring_shift`` flips bit ``bit`` of word ``word`` of
    what rank ``rank`` receives at hop ``hop``: a corrupted wire."""

    def __init__(self, mesh, rank: int, hop: int, word: int, bit: int):
        self.mesh, self.num_shards, self.rank = mesh, mesh.num_shards, mesh.rank
        self._at, self._word, self._bit, self._calls = (rank, hop), word, bit, 0

    def ring_shift(self, t):
        out = self.mesh.ring_shift(t)
        if (self.rank, self._calls) == self._at:
            out = out.clone()
            # The bit as an int32 value (bit 31 is the sign).
            out[self._word] ^= (1 << self._bit) - ((1 << 32) if self._bit == 31 else 0)
        self._calls += 1
        return out


def checksummed_ring_rank(mesh, chunks_i32, wire_check: bool, corrupt):
    """Every rank's ``(own, bad_hops)`` of ``checksummed_ring_or`` over its
    ``chunks_i32[rank]`` ([P, words] int32), gathered to rank 0;
    ``corrupt`` is ``(rank, hop, word, bit)`` or None."""
    import torch

    from tpu_bfs_torch.integrity.wire import checksummed_ring_or

    m = mesh if corrupt is None else CorruptingMesh(mesh, *corrupt)
    own, bad = checksummed_ring_or(torch.from_numpy(chunks_i32[mesh.rank]), m,
                                   wire_check=wire_check)
    every = mesh.all_gather_rows(own[None]).numpy()
    bads = mesh.all_gather_rows(bad.reshape(1)).numpy()
    return every, bads


def engine_wire_rank(mesh):
    """The mesh engines' own runs under the wire tap, each exchange call
    booked to its branch (``utils/wirecheck.ExchangeTap``): the dense and
    sparse hybrids, the delta-row wide engine (k-hop), the 1D planner and
    the sparse SSSP engine; the reports and every rank's signature."""
    from tpu_bfs_torch.analysis.graph import WireTap
    from tpu_bfs_torch.graph.generate import random_graph, rmat_graph
    from tpu_bfs_torch.parallel.dist_bfs import DistBfsEngine
    from tpu_bfs_torch.parallel.dist_msbfs_hybrid import DistHybridMsBfsEngine
    from tpu_bfs_torch.parallel.dist_msbfs_wide import DistWideMsBfsEngine
    from tpu_bfs_torch.parallel.dist_sssp import DistSsspEngine
    from tpu_bfs_torch.utils.wirecheck import (
        ExchangeTap,
        branch_arg,
        branch_result,
        gather_signatures,
    )

    g = rmat_graph(10, 8, seed=3)
    gw = random_graph(96, 480, seed=3, weights=5)
    src = np.flatnonzero(g.degrees > 0)[:64]
    reports = []
    with WireTap() as tap:
        for exchange in ("dense", "sparse"):
            eng = DistHybridMsBfsEngine(g, mesh, lanes=64, exchange=exchange)
            xt = ExchangeTap(tap, eng, "_gather", branch_arg,
                             measure_in_flags=exchange == "sparse")
            eng.run(src)
            reports.append(xt.report())
        eng = DistWideMsBfsEngine(g, mesh, lanes=64, exchange="sparse", delta_bits=(8, 16))
        xt = ExchangeTap(tap, eng, "_exchange_rows", branch_arg, measure_in_flags=True)
        eng.run(src)
        reports.append(xt.report())
        eng = DistBfsEngine(g, mesh, exchange="sparse", delta_bits=(8, 16), sieve=True,
                            predict=True)
        xt = ExchangeTap(tap, eng, "_exchange_step", branch_result)
        eng.run(int(src[0]))
        reports.append(xt.report())
        eng = DistSsspEngine(gw, mesh, lanes=32, exchange="sparse", delta_bits=(8, 16),
                             predict=True)
        xt = ExchangeTap(tap, eng, "_exchange_round", branch_result)
        eng.run(np.arange(32) % 96)
        reports.append(xt.report())
    return reports, gather_signatures(mesh, tap.signature())
