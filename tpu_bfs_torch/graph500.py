"""Graph500-style BFS benchmark harness, the port of ``tpu_bfs/graph500.py``.

Seeded Kronecker/RMAT generation, random search keys among vertices with
degree > 0, per-search validation (Graph500 checks BFS-tree properties; the
reference only reruns itself on the CPU, bfs.cu:798-815) and harmonic-mean
TEPS.

    python -m tpu_bfs_torch.graph500 --scale 16
    python -m tpu_bfs_torch.graph500 --mode batched --scale 16
    python -m tpu_bfs_torch.graph500 --mode hybrid --scale 8 --device cpu

Modes: ``'single'`` (the official kernel-2 shape, one ``BfsEngine``
traversal per search), ``'batched'`` (all searches in one ``MsBfsEngine``
batch) and ``'hybrid'`` (all searches in one batch of the flagship
``HybridMsBfsEngine``). A mesh run spawns its ranks
(``parallel.mesh.launch``; ``cuda:r``, or gloo ranks with ``device='cpu'``)
and returns rank 0's result: ``mode='hybrid', devices=N`` runs the sharded
``DistHybridMsBfsEngine``, ``mode='single', devices=N`` the 1D
``DistBfsEngine`` and ``mode='single', mesh2d=(R, C)`` the 2D
``Dist2DBfsEngine`` on R * C ranks.

    python -m tpu_bfs_torch.graph500 --mode hybrid --devices 2 --scale 10 --device cpu
    python -m tpu_bfs_torch.graph500 --devices 4 --exchange sparse --scale 10 --device cpu
    python -m tpu_bfs_torch.graph500 --mesh 2x2 --backend dopt --scale 10 --device cpu
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from tpu_bfs_torch import validate
from tpu_bfs_torch.graph.csr import INF_DIST, Graph
from tpu_bfs_torch.graph.generate import rmat_graph


@dataclasses.dataclass
class Graph500Result:
    scale: int
    edge_factor: int
    num_searches: int
    teps: list[float]  # per-search TEPS
    validated: bool
    mode: str
    graph_s: float | None = None  # host graph generation, seconds
    engine_s: float | None = None  # engine build, seconds

    @property
    def harmonic_mean_teps(self) -> float:
        return len(self.teps) / sum(1.0 / t for t in self.teps)


def sample_search_keys(g: Graph, n: int, *, seed: int = 2) -> np.ndarray:
    """Graph500 samples search keys uniformly among vertices with degree > 0."""
    rng = np.random.default_rng(seed)
    candidates = np.flatnonzero(g.degrees > 0)
    return rng.choice(candidates, size=min(n, len(candidates)), replace=False)


def traversed_edges(g: Graph, dist: np.ndarray) -> int:
    """Graph500 TEPS numerator: input edges with both endpoints reached."""
    reached = dist != INF_DIST
    slots = int(reached[g.coo[0]].sum())  # dst also reached for a full BFS
    return slots // 2 if g.undirected else slots


def run_graph500(
    scale: int,
    edge_factor: int = 16,
    *,
    seed: int = 1,
    num_searches: int = 64,
    mode: str = "single",
    validate_searches: int = 4,
    validate_mode: str = "oracle",
    num_planes: int = 5,
    lanes: int | None = None,
    engine_cls=None,
    devices: int = 1,
    mesh2d: tuple[int, int] | None = None,
    exchange: str | None = None,
    backend: str = "scan",
    device=None,
) -> Graph500Result:
    """Generate, run, validate and score a Graph500-style BFS benchmark.

    mode='single': one traversal at a time through ``BfsEngine`` with the
    expansion ``backend``, each search's TEPS over its own time (the
    official kernel-2 shape).
    mode='batched': every search in one ``MsBfsEngine`` batch; per-search
    TEPS divides the batch time evenly (not comparable with single-stream
    numbers, but the way to use the device when there are many sources).
    mode='hybrid': every search in one batch of the flagship
    ``HybridMsBfsEngine``, the same equal-share accounting; ``num_planes``
    caps depth at 2**planes levels and ``lanes`` sets the batch width.
    ``engine_cls`` replaces the mode's engine, built as
    ``engine_cls(g, device=device)``. ``device`` is CUDA unless named.
    ``devices`` / ``mesh2d`` distribute the run: the single mode over a 1D
    mesh (or the 2D edge partition with ``mesh2d``), the hybrid mode over
    the sharded-state ``DistHybridMsBfsEngine``. ``exchange`` is the mesh
    engine's: 'ring' (default), 'allreduce' or 'sparse' for the single
    mode; 'dense' (default), 'sparse' or 'sliced' for the hybrid."""
    if mode not in ("single", "batched", "hybrid"):
        raise ValueError(f"unknown mode {mode!r}; have 'single', 'batched', 'hybrid'")
    if validate_mode not in ("oracle", "certify"):
        raise ValueError(f"unknown validate_mode {validate_mode!r}; have 'oracle', 'certify'")
    distributed = devices > 1 or mesh2d is not None
    if exchange is not None and not distributed:
        raise ValueError("exchange applies to a mesh run (devices > 1 or mesh2d)")
    if distributed and mode == "batched":
        raise ValueError("mode='batched' is single-device; use mode='hybrid' (sharded "
                         "DistHybridMsBfsEngine) or mode='single' on a mesh")
    if mesh2d is not None and mode == "hybrid":
        raise ValueError("hybrid mode shards 1D (row-tile round-robin); pass "
                         "devices=N instead of a 2D mesh")
    if distributed:
        from tpu_bfs_torch.parallel.mesh import launch

        ranks = devices if mesh2d is None else mesh2d[0] * mesh2d[1]
        return launch(ranks, _mesh_rank, dict(
            scale=scale, edge_factor=edge_factor, seed=seed, num_searches=num_searches,
            mode=mode, validate_searches=validate_searches, validate_mode=validate_mode,
            num_planes=num_planes, lanes=lanes, engine_cls=engine_cls, exchange=exchange,
            backend=backend, mesh2d=mesh2d), device=device)
    return _run(scale, edge_factor, seed=seed, num_searches=num_searches, mode=mode,
                validate_searches=validate_searches, validate_mode=validate_mode,
                num_planes=num_planes, lanes=lanes, engine_cls=engine_cls, backend=backend,
                device=device)


def _mesh_rank(mesh, kw) -> Graph500Result:
    """One rank of a mesh run: the whole harness on ``mesh``."""
    return _run(**kw, device=mesh.device, mesh=mesh)


def _run(scale, edge_factor, *, seed, num_searches, mode, validate_searches, validate_mode,
         num_planes, lanes, engine_cls, backend, device, mesh=None, mesh2d=None,
         exchange=None) -> Graph500Result:
    t0 = time.perf_counter()
    g = rmat_graph(scale, edge_factor, seed=seed)
    graph_s = time.perf_counter() - t0
    keys = sample_search_keys(g, num_searches)

    t0 = time.perf_counter()
    if engine_cls is not None:
        eng = engine_cls(g, device=device)
    elif mode == "hybrid" and mesh is not None:
        from tpu_bfs_torch.parallel.dist_msbfs_hybrid import DistHybridMsBfsEngine

        lanes_kw = {} if lanes is None else {"lanes": lanes}
        eng = DistHybridMsBfsEngine(g, mesh, num_planes=num_planes,
                                    exchange=exchange or "dense", **lanes_kw)
    elif mode == "hybrid":
        from tpu_bfs_torch.algorithms.msbfs_hybrid import HybridMsBfsEngine

        lanes_kw = {} if lanes is None else {"lanes": lanes}
        eng = HybridMsBfsEngine(g, num_planes=num_planes, device=device, **lanes_kw)
    elif mode == "batched":
        from tpu_bfs_torch.algorithms.msbfs import MsBfsEngine

        eng = MsBfsEngine(g, device=device)
    elif mesh2d is not None:
        from tpu_bfs_torch.parallel.dist_bfs2d import Dist2DBfsEngine
        from tpu_bfs_torch.parallel.mesh import make_mesh_2d

        eng = Dist2DBfsEngine(g, make_mesh_2d(*mesh2d, mesh=mesh), backend=backend,
                              **({"exchange": exchange} if exchange else {}))
    elif mesh is not None:
        from tpu_bfs_torch.parallel.dist_bfs import DistBfsEngine

        eng = DistBfsEngine(g, mesh, backend=backend,
                            **({"exchange": exchange} if exchange else {}))
    else:
        from tpu_bfs_torch.algorithms.bfs import BfsEngine

        eng = BfsEngine(g, backend=backend, device=device)
    engine_s = time.perf_counter() - t0
    teps, dists, parents = [], [], None
    if mode == "hybrid":
        res = eng.run(keys, time_it=True)
        per_search = res.elapsed_s / len(keys)
        # One lane at a time, keeping only the lanes to validate: the whole
        # [S, V] matrix would be some 17 GB at scale 26. Parents come from
        # the engine's own result (PackedBatchResult.parents_int32), the
        # BFS-tree artifact Graph500 asks for.
        parents = []
        for i in range(len(keys)):
            d = res.distances_int32(i)
            teps.append(traversed_edges(g, d) / per_search)
            if i < validate_searches:
                dists.append(d)
                parents.append(res.parents_int32(i))
    elif mode == "batched":
        res = eng.run(keys, time_it=True)
        per_search = res.elapsed_s / len(keys)  # an equal time share per search
        teps = [traversed_edges(g, d) / per_search for d in res.distance]
        dists = res.distance
    else:
        for s in keys:
            r = eng.run(int(s), with_parents=False, time_it=True)
            teps.append(r.edges_traversed / r.elapsed_s)
            dists.append(r.distance)

    from tpu_bfs_torch.reference import bfs_scipy

    n_validate = min(validate_searches, len(keys))
    for i in range(n_validate):
        s = int(keys[i])
        if validate_mode == "oracle":
            validate.check_distances(dists[i], bfs_scipy(g, s))
        # The hybrid validates its result's own trees; the other modes the
        # deterministic min-parent tree of their distances, as in the JAX
        # package. The oracle-free certificate (parent chains + edge
        # levels) is, with validate_mode='certify', the whole validation.
        mp = parents[i] if parents is not None else validate.min_parent_from_dist(g, s, dists[i])
        validate.certify_bfs(g, s, dists[i], mp)
    return Graph500Result(
        scale=scale,
        edge_factor=edge_factor,
        num_searches=len(keys),
        teps=teps,
        validated=n_validate > 0,  # the checks raise on a mismatch
        mode=mode,
        graph_s=graph_s,
        engine_s=engine_s,
    )


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="tpu_bfs_torch.graph500")
    ap.add_argument("--scale", type=int, default=16)
    ap.add_argument("--ef", type=int, default=16)
    ap.add_argument("--searches", type=int, default=64)
    ap.add_argument("--mode", choices=["single", "batched", "hybrid"], default="single")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--validate", type=int, default=4, metavar="N",
                    help="validate the first N searches (0 to skip)")
    ap.add_argument("--validate-mode", default="oracle", choices=["oracle", "certify"],
                    help="'oracle' = SciPy compare + certificate; 'certify' = the "
                    "oracle-free property certificate only (two O(E) passes)")
    ap.add_argument("--planes", type=int, default=5, metavar="P", choices=range(1, 9),
                    help="hybrid mode: bit-plane count (depth cap 2**P)")
    ap.add_argument("--lanes", type=int, default=None, metavar="N",
                    help="hybrid mode: packed batch width (default: engine auto sizing)")
    ap.add_argument("--devices", type=int, default=1,
                    help="shard over N ranks, one device each (single: 1D vertex "
                    "partition; hybrid: sharded-state engine)")
    ap.add_argument("--exchange", default=None,
                    choices=["ring", "allreduce", "sparse", "dense", "sliced"],
                    help="the mesh run's frontier exchange (single mode: ring/allreduce/"
                    "sparse, default ring; hybrid mode: dense/sparse/sliced, default dense)")
    ap.add_argument("--mesh", default=None, metavar="RxC",
                    help="single mode: 2D edge partition over an RxC mesh of R*C ranks")
    ap.add_argument("--backend", default="scan", choices=["scan", "segment", "scatter", "dopt"],
                    help="single mode: frontier-expansion backend")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain kernel twins)")
    args = ap.parse_args(argv)
    if args.exchange is not None and args.devices == 1 and not args.mesh:
        ap.error("--exchange applies to mesh runs (--devices N or --mesh RxC)")
    mesh2d = None
    if args.mesh:
        try:
            mesh2d = tuple(int(t) for t in args.mesh.lower().split("x"))
            if len(mesh2d) != 2:
                raise ValueError(mesh2d)
        except ValueError:
            ap.error(f"--mesh must look like RxC (e.g. 2x4), got {args.mesh!r}")
    res = run_graph500(
        args.scale,
        args.ef,
        seed=args.seed,
        num_searches=args.searches,
        mode=args.mode,
        validate_searches=args.validate,
        validate_mode=args.validate_mode,
        num_planes=args.planes,
        lanes=args.lanes,
        devices=args.devices,
        mesh2d=mesh2d,
        exchange=args.exchange,
        backend=args.backend,
        device=args.device,
    )
    print(
        f"graph500 scale={res.scale} ef={res.edge_factor} mode={res.mode} "
        f"searches={res.num_searches} validated={res.validated} "
        f"harmonic_mean_GTEPS={res.harmonic_mean_teps / 1e9:.4f}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
