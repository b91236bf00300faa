"""Command-line entry point of the PyTorch port.

Keeps the reference's argument order, ``<source> <graph>`` (README.md:13),
and the flow of ``tpu_bfs/cli.py``'s ``--multi-source`` path: load the
graph, run the CPU golden BFS, run one packed batch, validate lane 0's
distances and BFS tree (or certify lane 0 with ``--certify``), and save
every lane's distances or trees on request.

    python -m tpu_bfs_torch 0 rmat:scale=14,ef=16 --multi-source 1,2,3
    python -m tpu_bfs_torch 2 graph.txt --multi-source 5,9 --engine wide --device cpu
    python -m tpu_bfs_torch 0 rmat:scale=14 --multi-source 1,2 --certify --save-parent p.npy

Graph sources: a file path, ``-`` for stdin, or ``rmat:scale=..,ef=..,seed=..``
/ ``random:n=..,m=..,seed=..``. Only the multi-source engines are ported;
a run without ``--multi-source`` exits with an error.
"""

from __future__ import annotations

import argparse

import numpy as np


def _parse_spec(spec: str):
    kind, _, rest = spec.partition(":")
    kw = {}
    if rest:
        for item in rest.split(","):
            k, _, v = item.partition("=")
            kw[k.strip()] = int(v)
    return kind, kw


def load_graph(spec: str):
    from tpu_bfs_torch.graph import generate, io

    if spec.startswith("rmat:") or spec == "rmat":
        _, kw = _parse_spec(spec)
        return generate.rmat_graph(kw.get("scale", 16), kw.get("ef", 16), seed=kw.get("seed", 1))
    if spec.startswith("random:"):
        _, kw = _parse_spec(spec)
        return generate.random_graph(
            kw.get("n", 1024), kw.get("m", 8192), seed=kw.get("seed", 12345)
        )
    if spec == "-":
        return io.read_stdin()
    return io.load_edge_list(spec)


def _make_engine(args, g):
    kw = {"device": args.device}
    if args.lanes is not None:
        kw["lanes"] = args.lanes
    if args.engine == "wide":
        from tpu_bfs_torch.algorithms.msbfs_wide import WidePackedMsBfsEngine

        return WidePackedMsBfsEngine(g, num_planes=args.planes or 5, **kw)
    from tpu_bfs_torch.algorithms.msbfs_hybrid import HybridMsBfsEngine

    return HybridMsBfsEngine(g, num_planes=args.planes or "auto", **kw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpu_bfs_torch",
        description="Multi-source BFS on an NVIDIA GPU (PyTorch + CUDA port of tpu_bfs).",
    )
    ap.add_argument("source", type=int, help="source vertex (reference argv[1])")
    ap.add_argument("graph", help="graph file, '-' for stdin, or rmat:/random: spec")
    ap.add_argument("--multi-source", default=None, metavar="V1,V2,...",
                    help="run these sources concurrently with <source> in one packed batch")
    ap.add_argument("--engine", default="hybrid", choices=["hybrid", "wide"],
                    help="'hybrid' = dense tiles + gathers (flagship), 'wide' = gathers only")
    ap.add_argument("--lanes", type=int, default=None, metavar="N",
                    help="packed batch width (default: auto sizing, cap 8192)")
    ap.add_argument("--planes", type=int, default=None, metavar="P", choices=range(1, 9),
                    help="bit planes; caps the traversal depth at 2**P levels")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain kernel twins)")
    ap.add_argument("--certify", action="store_true",
                    help="validate lane 0 with the oracle-free BFS certificate (two "
                    "O(E) host passes, validate.certify_bfs) instead of the CPU "
                    "golden rerun")
    ap.add_argument("--no-parents", action="store_true",
                    help="skip lane 0's BFS-tree check after the distance check")
    ap.add_argument("--save-dist", default=None, metavar="PATH",
                    help="save every lane's distances to .npy, [S, V] int32")
    ap.add_argument("--save-parent", default=None, metavar="PATH",
                    help="save every lane's BFS tree to .npy, [S, V] int32 (on the "
                    "card, always the device parent scan)")
    args = ap.parse_args(argv)

    if args.multi_source is None:
        raise SystemExit(
            "single-source backends are not ported yet: tpu_bfs_torch runs "
            "--multi-source batches only (the wide and hybrid packed engines)"
        )
    try:
        extra = [int(t) for t in args.multi_source.split(",") if t.strip()]
    except ValueError:
        raise SystemExit(f"--multi-source must be comma-separated ints, got "
                         f"{args.multi_source!r}")

    from tpu_bfs_torch import validate
    from tpu_bfs_torch.reference import bfs_golden

    g = load_graph(args.graph)
    sources = np.asarray([args.source] + extra)
    bad = sources[(sources < 0) | (sources >= g.num_vertices)]
    if len(bad):
        raise SystemExit(
            f"--multi-source vertices {bad.tolist()} out of range [0, {g.num_vertices})"
        )
    # The certificate replaces the golden rerun.
    golden = None if args.certify else bfs_golden(g, int(sources[0]))
    engine = _make_engine(args, g)
    try:
        res = engine.run(sources, time_it=True)
    except RuntimeError as exc:
        if "truncated" not in str(exc):
            raise
        raise SystemExit(f"{exc}\nhint: rerun with --planes 8 (depth 254)")
    print(f"Elapsed time in milliseconds ({engine.device}): "
          f"{res.elapsed_s * 1e3:.3f} ({len(sources)} sources)")
    for i, s in enumerate(sources):
        print(f"source {int(s)}: reached {int(res.reached[i])} vertices, "
              f"traversed edges {int(res.edges_traversed[i])}")
    if res.teps:
        print(f"Harmonic-mean GTEPS/source: {res.teps / 1e9:.4f}")
    if args.certify:
        validate.certify_bfs(g, int(sources[0]), res.distances_int32(0), res.parents_int32(0))
        print(f"Output certified (oracle-free, lane 0 of {len(sources)})")
    else:
        validate.check_distances(res.distances_int32(0), golden)
        if not args.no_parents:
            # The engine's BFS tree too, which the reference never checks
            # (bfs.cu:940; checkOutput compares distances only).
            validate.check_parents(g, int(sources[0]), res.distances_int32(0),
                                   res.parents_int32(0))
        print("Output OK")
    if args.save_dist:
        np.save(args.save_dist, np.stack([res.distances_int32(i) for i in range(len(sources))]))
    if args.save_parent:
        out = np.empty((len(sources), g.num_vertices), np.int32)
        np.save(args.save_parent, res.parents_into(out))
    return 0
