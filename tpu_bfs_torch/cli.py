"""Command-line entry point of the PyTorch port.

Keeps the reference's argument order and flow, ``./a.out <source> <graph>``
(README.md:13, bfs.cu:783-823): load the graph, run the CPU golden BFS, run
the BFS on the device, validate the distances and the BFS tree (or certify
them with ``--certify``), print the timings, and save the distances or the
tree on request. ``--backend`` picks the single-source engine;
``--multi-source`` runs a packed batch instead, validating lane 0, as
``tpu_bfs/cli.py`` does.

    python -m tpu_bfs_torch 0 rmat:scale=14,ef=16
    python -m tpu_bfs_torch 0 rmat:scale=14 --backend dopt --stats --repeat 3
    python -m tpu_bfs_torch 2 graph.txt --backend tiled --device cpu
    python -m tpu_bfs_torch 0 rmat:scale=14,ef=16 --multi-source 1,2,3
    python -m tpu_bfs_torch 2 graph.txt --multi-source 5,9 --engine wide --device cpu
    python -m tpu_bfs_torch 0 rmat:scale=14 --multi-source 1,2 --certify --save-parent p.npy
    python -m tpu_bfs_torch 0 rmat:scale=14 --multi-source 1,2 --engine hybrid --pull-gate --stats
    python -m tpu_bfs_torch 0 rmat:scale=14 --multi-source 1,2 --engine hybrid --adaptive-push 8192,64
    python -m tpu_bfs_torch 0 rmat:scale=14 --multi-source 1,2 --engine wide --profile-dir prof
    python -m tpu_bfs_torch 0 rmat:scale=14 --ckpt state.npz --ckpt-every 2
    python -m tpu_bfs_torch 0 rmat:scale=14 --resume state.npz
    python -m tpu_bfs_torch 0 rmat:scale=14 --multi-source 1,2,3 --devices 2 --exchange sparse
    python -m tpu_bfs_torch 0 rmat:scale=14 --devices 4 --exchange sparse --device cpu
    python -m tpu_bfs_torch 0 rmat:scale=14 --mesh 2x2 --backend dopt --device cpu

Graph sources: a file path, ``-`` for stdin, or ``rmat:scale=..,ef=..,seed=..``
/ ``random:n=..,m=..,seed=..``. With no ``--engine``, a batch of 512
sources or fewer runs the 512-lane packed engine and a larger one the
hybrid, as in the JAX CLI (the wide engine with ``--ckpt``/``--resume``,
the hybrid with ``--pull-gate``); ``--adaptive-push ROWS,DEG`` needs
``--engine wide|hybrid`` on one device. ``--profile-dir DIR`` writes a
``torch.profiler`` Chrome trace of each timed run into DIR (CUDA activity
on the card, or the run fails). Checkpoint files are the JAX CLI's: a
run checkpointed by one resumes in the other. A transient failure mid-chunk
rebuilds the engine and resumes from the last chunk
(``utils/recovery.advance_with_recovery``).

The operations flags: ``--faults SPEC`` arms a fault-injection schedule
(``faults.py``), ``--obs [SPEC]`` the telemetry recorder and
``--trace-out PATH`` a Perfetto trace of the run with the engine's
per-level track. With ``--stats`` the run also prints the engine-trace
summary (``trace {...}``: always on a single-source mesh, on the packed
engines when the recorder is armed) and, when a retry fired, the
``{"recovery": ...}`` line. On a mesh every rank arms the schedule and
the recorder, so one spec fires as in the JAX CLI's one process; rank 0
prints and writes the trace.

    python -m tpu_bfs_torch 0 rmat:scale=14 --multi-source 1,2 --engine hybrid --stats --trace-out t.json
    python -m tpu_bfs_torch 0 rmat:scale=14 --ckpt s.npz --faults 'seed=7:transient@advance:n=1' --stats

A mesh run spawns its ranks (``parallel.mesh.launch``): each runs the
whole command on its device (``cuda:r``, or gloo ranks with ``--device
cpu``), and rank 0's output is printed. Under ``torchrun`` (``WORLD_SIZE``
set) each rank joins the group that exists instead and rank 0 prints.
``--devices N`` runs the single-source ``DistBfsEngine`` (1D vertex
partition; ``--exchange ring|allreduce|sparse``), or with
``--multi-source`` a packed mesh engine (the hybrid unless ``--engine
wide``); ``--mesh RxC`` runs ``Dist2DBfsEngine`` on R * C ranks. The
exchange planner's flags: ``--wire-pack`` (32 vertices a word on the
single-source exchanges; recorded on the packed engines, whose words
already carry one bit a lane), and with ``--exchange sparse``
``--sparse-delta`` (delta-encoded ids; the packed engines' row ids too),
``--sparse-sieve`` and ``--sparse-predict`` (single-source).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import sys
import time

import numpy as np

#: This rank's mesh (``parallel.mesh.Mesh``) inside a --devices run.
_MESH = None


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

    # weights=W attaches the edge_weights plane (values in [1, W]), as the
    # JAX CLI does; SSSP reads it, BFS ignores it.
    if spec.startswith("rmat:") or spec == "rmat":
        _, kw = _parse_spec(spec)
        return generate.rmat_graph(kw.get("scale", 16), kw.get("ef", 16), seed=kw.get("seed", 1),
                                   weights=kw.get("weights") or None)
    if spec.startswith("random:"):
        _, kw = _parse_spec(spec)
        return generate.random_graph(
            kw.get("n", 1024), kw.get("m", 8192), seed=kw.get("seed", 12345),
            weights=kw.get("weights") or None,
        )
    if spec == "-":
        return io.read_stdin()
    return io.load_edge_list(spec)


#: The JAX CLI's default engine rule (``tpu_bfs/cli.py:207-208``): the
#: 512-lane packed engine for this many sources or fewer, else the hybrid.
PACKED_MAX_SOURCES = 512


def default_engine(n_sources: int) -> str:
    return "packed" if n_sources <= PACKED_MAX_SOURCES else "hybrid"


def packed_lanes(n_sources: int) -> int:
    """The packed engine's default width: the sources rounded up to whole
    32-lane words, at least one (``tpu_bfs/cli.py:231-235``)."""
    return max(32, -(-n_sources // 32) * 32)


def _mesh_engine_errors(args) -> None:
    """The JAX CLI's refusals of a --devices batch (``tpu_bfs/cli.py:163-205``)."""
    if args.engine == "packed":
        raise SystemExit("--engine packed is single-device; use --engine hybrid or "
                         "wide with --devices")
    if args.exchange == "allreduce":
        raise SystemExit("--exchange allreduce applies to single-source --devices "
                         "runs; the packed engines exchange 'ring' (dense), "
                         "'sparse', or 'sliced' (hybrid)")
    if args.engine == "wide" and args.exchange == "sliced":
        raise SystemExit("--exchange sliced is a hybrid-engine layout (ring-"
                         "rotated expansion over dense tiles + pair ELL); use "
                         "--engine hybrid")
    if args.engine == "wide" and args.pull_gate:
        raise SystemExit("--pull-gate on a mesh runs through the distributed "
                         "hybrid engine; drop --engine wide")


def _make_mesh_engine(args, g):
    from tpu_bfs_torch.parallel.mesh import make_mesh

    mesh = _MESH if _MESH is not None else make_mesh(args.devices, device=args.device)
    kw = {"num_planes": args.planes or 5,
          "exchange": args.exchange if args.exchange in ("sparse", "sliced") else "dense"}
    if args.lanes is not None:
        kw["lanes"] = args.lanes
    if args.wire_pack:
        kw["wire_pack"] = True  # recorded: the lane words are already packed
    if args.sparse_delta:
        from tpu_bfs_torch.parallel.collectives import DELTA_BITS_DEFAULT

        kw["delta_bits"] = DELTA_BITS_DEFAULT
    if args.engine == "wide":
        from tpu_bfs_torch.parallel.dist_msbfs_wide import DistWideMsBfsEngine

        return DistWideMsBfsEngine(g, mesh, **kw)
    from tpu_bfs_torch.parallel.dist_msbfs_hybrid import DistHybridMsBfsEngine

    return DistHybridMsBfsEngine(g, mesh, pull_gate=args.pull_gate, **kw)


def _make_ms_engine(args, g, n_sources: int):
    if args.devices > 1:
        return _make_mesh_engine(args, g)
    engine = args.engine
    if engine is None:
        engine = default_engine(n_sources)
        if engine == "packed" and (args.ckpt or args.resume):
            engine = "wide"  # checkpoints need the wide/hybrid state
        if engine == "packed" and args.pull_gate:
            engine = "hybrid"  # the gate lives in the wide/hybrid loop
    kw = {"device": args.device}
    if engine == "packed":
        from tpu_bfs_torch.algorithms.msbfs_packed import PackedMsBfsEngine

        if args.pull_gate:
            raise SystemExit("--pull-gate applies to the wide/hybrid engines (the 512-lane "
                             "packed engine keeps no settled-mask state); use --engine wide "
                             "or hybrid")
        if args.planes is not None:
            raise SystemExit("--planes applies to the wide and hybrid engines; the packed "
                             "engine counts 8 planes (depth 254)")
        lanes = args.lanes if args.lanes is not None else packed_lanes(n_sources)
        return PackedMsBfsEngine(g, lanes=lanes, **kw)
    if args.lanes is not None:
        kw["lanes"] = args.lanes
    if args.pull_gate:
        kw["pull_gate"] = True
    if args.adaptive_push:
        if g.num_input_edges < 10_000:
            # The push pass wins by skipping a whole-table scan, which a
            # tiny table barely costs (the JAX CLI's condition and advice).
            print(f"WARNING: --adaptive-push on a tiny graph ({g.num_input_edges} edges < 1e4) "
                  "usually LOSES; it pays off when light levels skip a large table scan.",
                  file=sys.stderr, flush=True)
        kw["adaptive_push"] = args.adaptive_push
    if engine == "wide":
        from tpu_bfs_torch.algorithms.msbfs_wide import WidePackedMsBfsEngine

        return WidePackedMsBfsEngine(g, num_planes=args.planes or 5, **kw)
    from tpu_bfs_torch.algorithms.msbfs_hybrid import HybridMsBfsEngine

    return HybridMsBfsEngine(g, num_planes=args.planes or "auto", **kw)


def _make_single_engine(args, g):
    if _MESH is not None:
        from tpu_bfs_torch.parallel.collectives import DELTA_BITS_DEFAULT

        kw = {"exchange": args.exchange, "backend": args.backend, "wire_pack": args.wire_pack,
              "delta_bits": DELTA_BITS_DEFAULT if args.sparse_delta else (),
              "sieve": args.sparse_sieve, "predict": args.sparse_predict}
        if args.mesh:
            from tpu_bfs_torch.parallel.dist_bfs2d import Dist2DBfsEngine
            from tpu_bfs_torch.parallel.mesh import make_mesh_2d

            return Dist2DBfsEngine(g, make_mesh_2d(*args.mesh_shape, mesh=_MESH), **kw)
        from tpu_bfs_torch.parallel.dist_bfs import DistBfsEngine

        return DistBfsEngine(g, _MESH, **kw)
    if args.backend == "tiled":
        from tpu_bfs_torch.algorithms.bfs_tiled import TiledBfsEngine

        return TiledBfsEngine(g, pull_gate=args.pull_gate, device=args.device)
    from tpu_bfs_torch.algorithms.bfs import BfsEngine

    return BfsEngine(g, backend=args.backend, device=args.device)


def _print_stats(distance, g, gated_tiles=None) -> None:
    from tpu_bfs_torch.utils.stats import level_stats

    for line in level_stats(distance, g.degrees, gated_tiles=gated_tiles).json_lines():
        print(line)


def _print_recovery() -> None:
    """The recovery counters' line, when a retry or rebuild fired."""
    from tpu_bfs_torch.utils.stats import recovery_stats_line

    line = recovery_stats_line()
    if line:
        print(line)


def _rank0() -> bool:
    return _MESH is None or _MESH.rank == 0


def _arm_ops(args) -> None:
    """Arm the fault schedule (``--faults``, else ``TPU_BFS_FAULTS``) and
    the telemetry recorder (``--obs``, else ``TPU_BFS_OBS``; ``--trace-out``
    implies one) in this process; rank 0 of a mesh reports."""
    from tpu_bfs_torch import faults
    from tpu_bfs_torch import obs

    sched = faults.arm_from_spec_or_env(args.faults)
    rec = obs.arm_for_run(args.obs, args.trace_out)
    if not _rank0():
        return
    if sched is not None:
        print(f"[faults] schedule armed: {sched.to_spec()}", file=sys.stderr)
    if rec is not None:
        print(f"[obs] telemetry recorder armed (flight window {rec.window_s:.0f}s, dump dir "
              f"{rec.dump_dir!r})", file=sys.stderr)


def _finish_obs(args, engine, label: str) -> None:
    """The run's epilogue: with --stats the engine-trace summary line; with
    --trace-out the Perfetto JSON (the recorder's spans and the engine's
    per-level track)."""
    import json

    from tpu_bfs_torch import obs

    trace = getattr(engine, "last_run_trace", None)
    if args.stats and trace:
        from tpu_bfs_torch.obs.engine_trace import trace_summary

        print("trace " + json.dumps(trace_summary(trace, engine)))
    rec = obs.ACTIVE
    if args.trace_out and rec is not None and _rank0():
        from tpu_bfs_torch.obs.exporters import write_perfetto

        write_perfetto(rec.snapshot(), args.trace_out, t0=rec.t0,
                       level_traces=[(label, trace)] if trace else [],
                       meta={"tool": "tpu_bfs_torch", "graph": args.graph})
        print(f"[obs] trace written -> {args.trace_out}", file=sys.stderr)


def _maybe_profile(profile_dir, device, name: str):
    """A ``torch.profiler`` session around one timed run that writes its
    Chrome trace to ``profile_dir/name`` on exit, or a no-op without a
    directory. CPU activity always; on a CUDA device also CUDA activity,
    which must be available and must record at least one kernel, or this
    raises (a CPU-only trace of a card run would hide the device)."""
    if not profile_dir:
        return contextlib.nullcontext()
    from tpu_bfs_torch.utils.profile import profiled

    return profiled(os.path.join(profile_dir, name), device)


def _timed_runs(args, run, device=None, **span):
    """``run()`` ``--repeat`` times, each inside a "run" span when the
    recorder is armed and a profiler session with ``--profile-dir``; the
    last result."""
    from tpu_bfs_torch import obs

    res = None
    rank = "" if _MESH is None else f"_rank{_MESH.rank}"
    for rep in range(max(1, args.repeat)):
        rec = obs.ACTIVE
        if rec is not None:
            rec.begin("run", "cli", cat="cli", rep=rep, **span)
        try:
            with _maybe_profile(args.profile_dir, device, f"trace{rank}_rep{rep}.json"):
                res = run()
        finally:
            # finally: a handled truncation must not leave the span open.
            if rec is not None:
                rec.end("run", "cli", cat="cli", rep=rep,
                        levels=None if res is None else res.num_levels)
    return res


def _aot_log(msg: str) -> None:
    # Every rank of a mesh run adopts and exports its own programs; rank 0
    # speaks for them, as JAX's single controller does.
    if _rank0():
        print(f"[aot] {msg}", file=sys.stderr, flush=True)


def _run_multi_source(args, g, golden, sources, resume_st=None) -> int:
    """<source> plus the listed keys in one packed batch, lane 0 validated;
    with ``--ckpt``/``--resume``, a chunked batch through start/advance/finish."""
    from tpu_bfs_torch import obs, validate

    with obs.maybe_span("engine_build", "cli", cat="cli", lanes=args.lanes, engine=args.engine):
        engine = _make_ms_engine(args, g, len(sources))
    aot_store = aot_spec = None
    if args.aot:
        # One-shot AOT: adopt this engine's programs from the store when an
        # earlier run exported them, and export them back after the run.
        from tpu_bfs_torch.utils import aot as aot_mod

        aot_store = aot_mod.ArtifactStore(args.aot, log=_aot_log)
        aot_spec = {
            "graph_key": args.graph,
            "engine": type(engine).__name__,
            "lanes": engine.lanes,
            "planes": getattr(engine, "num_planes", 8),
            "pull_gate": bool(getattr(engine, "pull_gate", False)),
            "devices": args.devices,
        }
        adopted = aot_mod.adopt_engine_programs(engine, aot_spec, aot_store, log=_aot_log)
        if not adopted:
            _aot_log(f"no adoptable artifacts in {args.aot}; running JIT "
                     "(the store is populated after this run)")
    try:
        if args.ckpt or resume_st is not None:
            from tpu_bfs_torch.utils import checkpoint as ck
            from tpu_bfs_torch.utils.recovery import advance_with_recovery

            save = None
            if args.ckpt:
                def save(c):
                    if _rank0():
                        ck.save_packed_checkpoint(args.ckpt, c)
                    print(f"checkpoint @ level {c.level} -> {args.ckpt}")
            st = resume_st if resume_st is not None else engine.start(sources)
            engine, st, _ = advance_with_recovery(
                lambda: _make_ms_engine(args, g, len(sources)), st, engine=engine,
                levels_per_chunk=max(1, args.ckpt_every) if args.ckpt else None,
                max_level=args.max_levels, save=save, log=lambda m: print(f"[recovery] {m}"))
            res = engine.finish(st)
        else:
            def run():
                res = engine.run(sources, max_levels=args.max_levels, time_it=True)
                print(f"Elapsed time in milliseconds ({engine.device}): "
                      f"{res.elapsed_s * 1e3:.3f} ({len(sources)} sources)")
                return res

            res = _timed_runs(args, run, engine.device, sources=len(sources))
    except RuntimeError as exc:
        if "truncated" not in str(exc):
            raise
        if engine.num_planes >= 8:
            # The packed engine, or wide/hybrid at --planes 8: no batch
            # engine counts deeper.
            raise SystemExit(f"{exc}\nhint: 254 levels (8 planes) is the deepest a "
                             "--multi-source batch counts; this graph is deeper, so run "
                             "its sources one at a time without --multi-source")
        if args.ckpt or resume_st is not None:
            raise SystemExit(f"{exc}\nhint: restart with --planes 8 (depth 254); a "
                             "checkpoint's plane count is fixed at start, so existing "
                             "checkpoints from this run cannot be resumed deeper")
        alt = "" if args.devices > 1 else " or --engine packed"
        raise SystemExit(f"{exc}\nhint: rerun with --planes 8 (depth 254){alt}")
    if aot_store is not None:
        # Export after the run: the engine is warmed, and one rebuilt by the
        # recovery path exports its final programs (adopted entries
        # re-export their originals).
        from tpu_bfs_torch.utils import aot as aot_mod

        names = aot_mod.export_engine_programs(engine, aot_spec, aot_store, log=_aot_log)
        _aot_log(f"exported {len(names)} programs -> {args.aot}")
    for i, s in enumerate(sources):
        print(f"source {int(s)}: reached {int(res.reached[i])} vertices, "
              f"traversed edges {int(res.edges_traversed[i])}")
    if res.teps:
        print(f"Harmonic-mean GTEPS/source: {res.teps / 1e9:.4f}")
    if args.stats:
        gated = getattr(engine, "last_gate_level_counts", None)
        if gated is not None:
            # Cut to the batch's levels, not lane 0's eccentricity: the
            # deeper levels of other lanes are where the gate skips most.
            gated = gated.cpu().numpy()[: res.num_levels + 1]
        _print_stats(res.distances_int32(0), g, gated)
        _print_recovery()
    if args.certify:
        validate.certify_bfs(g, int(sources[0]), res.distances_int32(0), res.parents_int32(0))
        print(f"Output certified (oracle-free, lane 0 of {len(sources)})")
    elif golden is not None:
        validate.check_distances(res.distances_int32(0), golden)
        if not args.no_parents:
            # The engine's BFS tree too, which the reference never checks
            # (bfs.cu:940; checkOutput compares distances only).
            validate.check_parents(g, int(sources[0]), res.distances_int32(0),
                                   res.parents_int32(0))
        print("Output OK")
    # On a mesh every rank computes (the extraction is collective) and rank 0 saves.
    if args.save_dist:
        dists = np.stack([res.distances_int32(i) for i in range(len(sources))])
        if _rank0():
            np.save(args.save_dist, dists)
    if args.save_parent:
        out = res.parents_into(np.empty((len(sources), g.num_vertices), np.int32))
        if _rank0():
            np.save(args.save_parent, out)
    _finish_obs(args, engine, type(engine).__name__)
    return 0


def _run_single_source(args, g, golden, resume_st=None) -> int:
    """The reference's own run: one BFS from <source>, timed on the device;
    with ``--ckpt``/``--resume``, a chunked run through start/advance/finish."""
    from tpu_bfs_torch import obs, validate

    with obs.maybe_span("engine_build", "cli", cat="cli", backend=args.backend,
                        devices=args.devices):
        engine = _make_single_engine(args, g)
    if args.ckpt or resume_st is not None:
        from tpu_bfs_torch.utils import checkpoint as ck
        from tpu_bfs_torch.utils.recovery import advance_with_recovery

        save = None
        if args.ckpt:
            def save(c):
                if _rank0():
                    ck.save_checkpoint(args.ckpt, c)
                print(f"checkpointed at level {c.level}")
        st = resume_st if resume_st is not None else engine.start(args.source)
        engine, st, _ = advance_with_recovery(
            lambda: _make_single_engine(args, g), st, engine=engine,
            levels_per_chunk=max(1, args.ckpt_every) if args.ckpt else None,
            max_level=args.max_levels, save=save, log=lambda m: print(f"[recovery] {m}"))
        res = engine.finish(st, with_parents=not args.no_parents)
    else:
        def run():
            res = engine.run(args.source, max_levels=args.max_levels,
                             with_parents=not args.no_parents, time_it=True)
            # The reference prints the device time (bfs.cu:624-626); an
            # isolated source needs no device run and has no time.
            if res.elapsed_s is not None:
                print(f"Elapsed time in milliseconds ({engine.device.type}): "
                      f"{res.elapsed_s * 1e3:.3f}")
            return res

        res = _timed_runs(args, run, engine.device, source=args.source)
    if res.teps:
        print(f"Traversed edges: {res.edges_traversed}  GTEPS: {res.teps / 1e9:.4f}")
    print(f"Reached {res.reached} vertices in {res.num_levels} levels")
    skipped = getattr(engine, "last_gate_skipped_tiles", None)
    if skipped is not None:
        print(f"Pull gate skipped {skipped} dense-tile passes")
    if args.stats:
        _print_stats(res.distance, g)
        _print_recovery()
    if args.certify:
        parent = (res.parent if res.parent is not None
                  else validate.min_parent_from_dist(g, res.source, res.distance))
        validate.certify_bfs(g, res.source, res.distance, parent)
        print("Output certified (oracle-free)")
    elif golden is not None:
        # checkOutput (bfs.cu:374-384), and the tree, which the reference
        # never checks.
        validate.check_distances(res.distance, golden)
        if res.parent is not None:
            validate.check_parents(g, res.source, res.distance, res.parent)
        print("Output OK")
    # On a mesh every rank holds the whole result, and rank 0 saves it.
    if args.save_dist and _rank0():
        np.save(args.save_dist, res.distance)
    if args.save_parent and res.parent is not None and _rank0():
        np.save(args.save_parent, res.parent)
    _finish_obs(args, engine, type(engine).__name__)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpu_bfs_torch",
        description="BFS on an NVIDIA GPU (PyTorch + CUDA port of tpu_bfs).",
    )
    ap.add_argument("source", type=int, help="source vertex (reference argv[1])")
    ap.add_argument("graph", help="graph file, '-' for stdin, or rmat:/random: spec")
    ap.add_argument("--backend", default=None,
                    choices=["scan", "segment", "scatter", "delta", "dopt", "tiled"],
                    help="single-source frontier expansion (default 'scan'; 'dopt' = "
                    "direction-optimizing top-down/bottom-up switch; 'tiled' adds the "
                    "dense-tile bitset pass)")
    ap.add_argument("--max-levels", type=int, default=None)
    ap.add_argument("--skip-cpu", action="store_true",
                    help="skip the CPU golden run and the validation (the reference "
                    "always validates, bfs.cu:798-815)")
    ap.add_argument("--repeat", type=int, default=1, help="timed repetitions")
    ap.add_argument("--stats", action="store_true", help="print per-level JSON stats")
    ap.add_argument("--multi-source", default=None, metavar="V1,V2,...",
                    help="run these sources concurrently with <source> in one packed batch")
    ap.add_argument("--engine", default=None, choices=["hybrid", "wide", "packed"],
                    help="--multi-source engine: 'hybrid' = dense tiles + gathers "
                    "(flagship), 'wide' = gathers only, 'packed' = up to 512 lanes "
                    "(depth 254). Default: 'packed' for <= 512 sources, else 'hybrid'")
    ap.add_argument("--lanes", type=int, default=None, metavar="N",
                    help="--multi-source batch width (default: the sources rounded up to "
                    "32 for 'packed', auto sizing with an 8192 cap otherwise)")
    ap.add_argument("--planes", type=int, default=None, metavar="P", choices=range(1, 9),
                    help="wide/hybrid bit planes; caps the traversal depth at 2**P levels")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain kernel twins)")
    ap.add_argument("--certify", action="store_true",
                    help="validate with the oracle-free BFS certificate (two O(E) host "
                    "passes, validate.certify_bfs) instead of the CPU golden rerun; "
                    "implies --skip-cpu")
    ap.add_argument("--no-parents", action="store_true",
                    help="skip the BFS tree (its extraction and its check)")
    ap.add_argument("--save-dist", default=None, metavar="PATH",
                    help="save the distances to .npy, [V] int32 ([S, V] with --multi-source)")
    ap.add_argument("--save-parent", default=None, metavar="PATH",
                    help="save the BFS tree to .npy, [V] int32 ([S, V] with --multi-source; "
                    "on the card, always the device parent scan)")
    ap.add_argument("--pull-gate", action="store_true",
                    help="frontier-aware pull expansion (default off): settled rows' bucket "
                    "blocks (skipped inside K1) and state blocks, and for --backend tiled the "
                    "dense-tile passes, are skipped per level, bit-identical to the plain "
                    "scan. --multi-source wide/hybrid engines and --backend tiled; --stats "
                    "adds per-level gated_tiles counts")
    ap.add_argument("--adaptive-push", default=None, metavar="ROWS,DEG",
                    help="level-adaptive expansion for --multi-source --engine wide|hybrid "
                    "(single device): levels with <= ROWS active rows, all with out-degree "
                    "<= DEG, take a push pass over those rows' out-edges instead of the "
                    "full ELL/tile scan; bit-identical results")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="write a torch.profiler Chrome trace of each timed run into DIR "
                    "(CPU activity, and CUDA activity on the card)")
    ap.add_argument("--ckpt", default=None, metavar="PATH",
                    help="checkpoint the traversal state to PATH (npz, the JAX CLI's "
                    "format) every --ckpt-every levels")
    ap.add_argument("--ckpt-every", type=int, default=4, metavar="N",
                    help="levels per checkpoint chunk (default 4)")
    ap.add_argument("--resume", default=None, metavar="PATH",
                    help="resume a traversal from a checkpoint written by --ckpt (its "
                    "source or sources replace the command line's)")
    ap.add_argument("--devices", type=int, default=1, metavar="N",
                    help="device count; >1 runs on a mesh of N ranks, one device each: "
                    "single-source DistBfsEngine, or with --multi-source the sharded "
                    "hybrid (--engine wide: the wide engine)")
    ap.add_argument("--mesh", default=None, metavar="RxC",
                    help="2D mesh shape (e.g. 2x4): the 2D edge partition engine on R*C "
                    "ranks instead of the 1D vertex partition")
    ap.add_argument("--exchange", default="ring",
                    choices=["ring", "allreduce", "sparse", "sliced"],
                    help="mesh frontier exchange: single-source 'ring' / 'allreduce' (dense "
                    "OR reduce-scatter) or 'sparse' (queue-style ids with the dense "
                    "fallback); with --multi-source, 'ring' = the dense row gather, "
                    "'sparse' = row ids and words, 'sliced' (hybrid) = the ring-rotated "
                    "expansion")
    ap.add_argument("--wire-pack", action="store_true",
                    help="ship the single-source mesh exchanges' bool buffers as 32-bit words, "
                    "32 vertices a word (the 1D exchanges and the sparse dense fallback, both "
                    "2D collectives); bit-identical results. The --multi-source mesh engines "
                    "already exchange packed lane words: there it is recorded")
    ap.add_argument("--sparse-delta", action="store_true",
                    help="delta-encode the sparse exchange's ids (first id and 8- or 16-bit "
                    "deltas in 32-bit words, the width picked a level from the all-reduced "
                    "widest gap); with --multi-source, the sparse row gather's ids. Needs "
                    "--exchange sparse on a mesh")
    ap.add_argument("--sparse-sieve", action="store_true",
                    help="the sparse exchange's visited sieve: on levels where it pays, each "
                    "receiver's packed visited chunk goes back once and senders drop "
                    "visited ids. Single-source mesh runs with --exchange sparse")
    ap.add_argument("--sparse-predict", action="store_true",
                    help="the sparse exchange's history prediction: a level after one that "
                    "overflowed every rung, with the frontier still growing, takes the dense "
                    "exchange without the measuring read. Single-source mesh runs with "
                    "--exchange sparse")
    ap.add_argument("--faults", default=None, metavar="SPEC",
                    help="arm a deterministic fault-injection schedule (tpu_bfs_torch/faults.py), "
                    "e.g. 'seed=7:transient@advance:n=1,corrupt_ckpt:n=1'; default: the "
                    "TPU_BFS_FAULTS env var, else disabled. --stats prints the recovery "
                    "counters when a retry fired")
    ap.add_argument("--obs", default=None, metavar="SPEC", nargs="?", const="1",
                    help="arm the telemetry recorder (tpu_bfs_torch/obs): span tracing, the "
                    "packed engines' per-level traces and the flight recorder. SPEC e.g. "
                    "'dump_dir=/tmp/fr,window=60'; bare --obs uses defaults; default: the "
                    "TPU_BFS_OBS env var, else disabled. --stats adds the trace-summary line")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome/Perfetto trace-event JSON of the run here (host spans "
                    "and a per-level engine-trace track: frontier count, direction, gated "
                    "tiles, exchange choice, modeled wire bytes; implies --obs)")
    ap.add_argument("--aot", default=None, metavar="DIR",
                    help="AOT artifact store (utils/aot): install this run's engine "
                    "programs from DIR when exported there before (skipping the "
                    "torch.export trace), and export them back after the run: the "
                    "one-shot analog of the server's --preheat/--export-aot "
                    "(multi-source packed engines; with --devices N each rank adopts "
                    "and exports its own programs; stale or corrupt artifacts fall "
                    "back to the eager programs)")
    args = ap.parse_args(argv)
    multi, on_mesh = args.multi_source is not None, bool(args.mesh) or args.devices > 1
    if args.aot is not None and not multi:
        ap.error("--aot pairs with --multi-source (the packed MS engines "
                 "are the AOT-exportable family; single-source engines "
                 "compile in seconds)")
    # The JAX CLI's guards and texts.
    if args.adaptive_push is not None:
        if args.engine not in ("wide", "hybrid") or args.devices > 1 or not multi:
            ap.error("--adaptive-push pairs with --multi-source --engine wide|hybrid on a "
                     "single device")
        try:
            r, d = (int(t) for t in args.adaptive_push.split(","))
            if r < 1 or d < 1:
                raise ValueError
        except ValueError:
            ap.error(f"--adaptive-push must be ROWS,DEG positive ints, got "
                     f"{args.adaptive_push!r}")
        args.adaptive_push = (r, d)
    if args.pull_gate and args.adaptive_push is not None:
        ap.error("--pull-gate and --adaptive-push cannot combine (both gate the per-level "
                 "scan; measure them separately)")
    if args.pull_gate and not multi and (args.backend != "tiled" or on_mesh):
        ap.error("--pull-gate for single-source runs needs --backend tiled on a single "
                 "device (the other single-source backends have no tile pass to gate)")
    if on_mesh and args.backend in ("delta", "tiled"):
        ap.error(f"--backend {args.backend} is single-device only")
    if args.wire_pack and not on_mesh:
        ap.error("--wire-pack packs multi-device exchanges; add --devices N or --mesh RxC "
                 "(a single chip moves nothing over the wire)")
    if args.sparse_delta or args.sparse_sieve or args.sparse_predict:
        if not on_mesh:
            ap.error("--sparse-delta/--sparse-sieve/--sparse-predict reshape multi-device "
                     "exchanges; add --devices N or --mesh RxC")
        if args.exchange != "sparse":
            ap.error("--sparse-delta/--sparse-sieve/--sparse-predict apply to the "
                     "queue-style id exchange; add --exchange sparse")
    if (args.sparse_sieve or args.sparse_predict) and multi:
        ap.error("--sparse-sieve/--sparse-predict are single-source exchange-planner "
                 "features (1D --devices or --mesh RxC); --multi-source row gathers support "
                 "--sparse-delta only")
    if args.exchange == "sliced" and not (multi and args.devices > 1):
        ap.error("--exchange sliced is the packed hybrid engine's ring-rotation layout; "
                 "use it with --multi-source --devices N")
    if multi and args.mesh:
        ap.error("--multi-source shards 1D (row-tile round-robin); pass --devices N "
                 "instead of a 2D mesh")
    if args.mesh:
        try:
            args.mesh_shape = tuple(int(t) for t in args.mesh.lower().split("x"))
            if len(args.mesh_shape) != 2:
                raise ValueError(args.mesh)
        except ValueError:
            ap.error(f"--mesh must look like RxC (e.g. 2x4), got {args.mesh!r}")
    if on_mesh:
        if multi:
            _mesh_engine_errors(args)
        if _MESH is None:
            ranks = args.devices if not args.mesh else args.mesh_shape[0] * args.mesh_shape[1]
            return _run_mesh(args, ranks, sys.argv[1:] if argv is None else list(argv))
    _arm_ops(args)
    if (args.ckpt or args.resume) and args.multi_source is not None and args.engine == "packed":
        ap.error("--ckpt/--resume with --multi-source needs the wide or hybrid engine (the "
                 "512-lane packed engine keeps no resumable state)")
    if (args.ckpt or args.resume) and (args.repeat > 1 or args.profile_dir):
        ap.error("--repeat/--profile-dir do not apply to checkpointed runs")

    sources = None
    if args.multi_source is not None:
        try:
            extra = [int(t) for t in args.multi_source.split(",") if t.strip()]
        except ValueError:
            raise SystemExit(f"--multi-source must be comma-separated ints, got "
                             f"{args.multi_source!r}")
        sources = np.asarray([args.source] + extra)
        if args.backend is not None:
            raise SystemExit("--backend picks the single-source engine; a --multi-source "
                             "batch picks its engine with --engine")
    else:
        args.backend = args.backend or "scan"
        unread = [f for f, v in (("--engine", args.engine), ("--lanes", args.lanes),
                                 ("--planes", args.planes)) if v is not None]
        if unread:
            raise SystemExit(f"{'/'.join(unread)} apply to --multi-source batches; a "
                             "single-source run picks its engine with --backend")
    if args.certify:
        args.skip_cpu = True  # the certificate replaces the golden rerun

    from tpu_bfs_torch.reference import bfs_golden

    from tpu_bfs_torch import obs

    t0 = time.perf_counter()
    with obs.maybe_span("graph_load", "cli", cat="cli", graph=args.graph):
        g = load_graph(args.graph)
    # The reference prints these (bfs.cu:789-790).
    print(f"Number of vertices {g.num_vertices}")
    print(f"Number of edges {g.num_edges}")
    print(f"[load] {time.perf_counter() - t0:.3f}s")
    # The JAX CLI's checks and texts: <source> first, then the batch.
    if not (0 <= args.source < g.num_vertices):
        raise SystemExit(f"source {args.source} out of range [0, {g.num_vertices})")
    resume_st = _load_resume(args, sources is not None)
    if resume_st is not None:
        if sources is not None:
            sources = resume_st.sources
        else:
            args.source = resume_st.source
    if sources is not None:
        bad = sources[(sources < 0) | (sources >= g.num_vertices)]
        if len(bad):
            raise SystemExit(f"--multi-source vertices {bad.tolist()} out of range "
                             f"[0, {g.num_vertices})")
    check = sources if sources is not None else np.asarray([args.source])
    golden = None
    if not args.skip_cpu:
        t0 = time.perf_counter()
        golden = bfs_golden(g, int(check[0]))
        # The reference prints the CPU time (runCpu, bfs.cu:211-219).
        print(f"Elapsed time in milliseconds (CPU): {(time.perf_counter() - t0) * 1e3:.2f}")
    if sources is not None:
        return _run_multi_source(args, g, golden, sources, resume_st)
    return _run_single_source(args, g, golden, resume_st)


def _mesh_rank_main(mesh, argv):
    """One rank of a --devices run: the whole command on ``mesh``, its
    output captured. Returns ``(rank 0's output, exit code or message)``."""
    global _MESH
    _MESH = mesh
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
    except SystemExit as exc:  # a refusal or a truncation hint
        rc = exc.code
    return buf.getvalue(), rc


def _run_mesh(args, ranks: int, argv) -> int:
    """A mesh run on its ``ranks`` ranks, rank 0's output printed: the
    ranks are spawned here, or, under torchrun, this process is one of them."""
    from tpu_bfs_torch.parallel.mesh import launch, make_mesh

    if "WORLD_SIZE" in os.environ:
        mesh = make_mesh(ranks, device=args.device)
        text, rc = _mesh_rank_main(mesh, argv)
        text = text if mesh.rank == 0 else ""
    else:
        if args.graph == "-":
            raise SystemExit("--devices reads the graph in every rank: give a file or a "
                             "generator spec, not stdin")
        text, rc = launch(ranks, _mesh_rank_main, argv, device=args.device)
    print(text, end="")
    if rc not in (0, None):
        raise SystemExit(rc)
    return 0


def _load_resume(args, multi_source: bool):
    """The ``--resume`` checkpoint (packed for a --multi-source batch), or
    None. A packed one sets the batch width when --lanes is not given."""
    if not args.resume:
        return None
    from tpu_bfs_torch.utils import checkpoint as ck

    try:
        if not multi_source:
            st = ck.load_checkpoint(args.resume)
            print(f"resumed source {st.source} at level {st.level}")
            return st
        st = ck.load_packed_checkpoint(args.resume)
    except ValueError as exc:  # e.g. a single-source checkpoint with --multi-source
        raise SystemExit(f"--resume: {exc}")
    if args.lanes is None:
        args.lanes = int(st.frontier.shape[1]) * 32
    print(f"resumed {len(st.sources)} sources at level {st.level} ({args.lanes} lanes)")
    return st
