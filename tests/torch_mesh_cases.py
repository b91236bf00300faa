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

    from tpu_bfs_torch.parallel.collectives import nonzero_rows, sparse_rows_gather

    p, r = mesh.num_shards, mesh.rank
    nxt = torch.zeros((6, 2), dtype=torch.int32)
    nxt[r % 6] = torch.tensor([r + 1, -1], dtype=torch.int32)
    nxt[5] = r + 10
    count = int(nonzero_rows(nxt))
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
    """Rank entry: build and run a DistBfsEngine, then list the JAX and
    tpu_bfs modules this rank has imported."""
    import sys

    from tpu_bfs_torch.graph import generate as tgen
    from tpu_bfs_torch.graph import io as tio
    from tpu_bfs_torch.parallel.dist_bfs import DistBfsEngine
    from tpu_bfs_torch.parallel.dist_bfs2d import Dist2DBfsEngine
    from tpu_bfs_torch.parallel.mesh import make_mesh_2d

    g = graph_of("random_small", tgen, tio)
    DistBfsEngine(g, mesh, exchange="sparse", backend="dopt").run(0)
    Dist2DBfsEngine(g, make_mesh_2d(1, mesh.num_shards, mesh=mesh), exchange="sparse").run(0)
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
                  dict(exchange="sparse"), dict(exchange="sparse", backend="dopt")]


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
