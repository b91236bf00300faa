"""Graph500-style BFS benchmark harness, the port of ``tpu_bfs/graph500.py``.

Seeded Kronecker/RMAT generation, random search keys among vertices with
degree > 0, per-search validation (Graph500 checks BFS-tree properties; the
reference only reruns itself on the CPU, bfs.cu:798-815) and harmonic-mean
TEPS.

    python -m tpu_bfs_torch.graph500 --mode hybrid --scale 16
    python -m tpu_bfs_torch.graph500 --mode hybrid --scale 8 --device cpu

Only ``mode='hybrid'`` on one device is ported: the flagship
``HybridMsBfsEngine`` runs every search in one packed batch. The
single-source (``'single'``), ``MsBfsEngine`` (``'batched'``) and mesh
(``devices > 1``, ``mesh2d``) runs need engines that are not ported yet and
raise ``NotImplementedError``; they never fall back to another engine.
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


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to tpu_bfs_torch yet (ROADMAP Queue 1 item {item}); "
        "run mode='hybrid' on one device"
    )


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
    device=None,
) -> Graph500Result:
    """Generate, run, validate and score a Graph500-style BFS benchmark.

    mode='hybrid': every search in one batch of the flagship engine
    (``engine_cls``, default ``HybridMsBfsEngine``, built as
    ``engine_cls(g, device=device)``); per-search TEPS divides the batch
    time evenly, and ``num_planes`` caps depth at 2**planes levels.
    ``device`` is CUDA unless named. The single-source run's expansion
    backend and the mesh runs' frontier exchange come with those runs."""
    if mode not in ("single", "batched", "hybrid"):
        raise ValueError(f"unknown mode {mode!r}; have 'single', 'batched', 'hybrid'")
    if validate_mode not in ("oracle", "certify"):
        raise ValueError(f"unknown validate_mode {validate_mode!r}; have 'oracle', 'certify'")
    if devices > 1 or mesh2d is not None:
        raise _unported("a mesh run (devices > 1 or mesh2d)", "10")
    if mode == "single":
        raise _unported("mode='single' (the single-source BfsEngine)", "8")
    if mode == "batched":
        raise _unported("mode='batched' (MsBfsEngine)", "8")

    t0 = time.perf_counter()
    g = rmat_graph(scale, edge_factor, seed=seed)
    graph_s = time.perf_counter() - t0
    keys = sample_search_keys(g, num_searches)

    t0 = time.perf_counter()
    if engine_cls is None:
        from tpu_bfs_torch.algorithms.msbfs_hybrid import HybridMsBfsEngine

        lanes_kw = {} if lanes is None else {"lanes": lanes}
        eng = HybridMsBfsEngine(g, num_planes=num_planes, device=device, **lanes_kw)
    else:
        eng = engine_cls(g, device=device)
    engine_s = time.perf_counter() - t0
    res = eng.run(keys, time_it=True)
    per_search = res.elapsed_s / len(keys)
    # One lane at a time, keeping only the lanes to validate: the whole
    # [S, V] matrix would be some 17 GB at scale 26. Parents come from the
    # engine's own result (PackedBatchResult.parents_int32), the BFS-tree
    # artifact Graph500 asks for.
    teps, dists, parents = [], [], []
    for i in range(len(keys)):
        d = res.distances_int32(i)
        teps.append(traversed_edges(g, d) / per_search)
        if i < validate_searches:
            dists.append(d)
            parents.append(res.parents_int32(i))

    from tpu_bfs_torch.reference import bfs_scipy

    n_validate = min(validate_searches, len(keys))
    for i in range(n_validate):
        s = int(keys[i])
        if validate_mode == "oracle":
            validate.check_distances(dists[i], bfs_scipy(g, s))
        # The oracle-free certificate (parent chains + edge levels); with
        # validate_mode='certify' it is the whole validation.
        validate.certify_bfs(g, s, dists[i], parents[i])
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
    ap.add_argument("--mode", choices=["single", "batched", "hybrid"], default="single",
                    help="only 'hybrid' is ported; the others exit with an error")
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
                    help="shard over N devices (not ported: N > 1 exits with an error)")
    ap.add_argument("--mesh", default=None, metavar="RxC",
                    help="2D mesh (not ported: exits with an error)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain kernel twins)")
    args = ap.parse_args(argv)
    mesh2d = None
    if args.mesh:
        try:
            mesh2d = tuple(int(t) for t in args.mesh.lower().split("x"))
            if len(mesh2d) != 2:
                raise ValueError(mesh2d)
        except ValueError:
            ap.error(f"--mesh must look like RxC (e.g. 2x4), got {args.mesh!r}")
    try:
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
            device=args.device,
        )
    except NotImplementedError as exc:
        raise SystemExit(f"tpu_bfs_torch.graph500: {exc}")
    print(
        f"graph500 scale={res.scale} ef={res.edge_factor} mode={res.mode} "
        f"searches={res.num_searches} validated={res.validated} "
        f"harmonic_mean_GTEPS={res.harmonic_mean_teps / 1e9:.4f}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
