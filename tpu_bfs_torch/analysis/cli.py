"""``python -m tpu_bfs_torch.analysis``: run the passes and gate on new
findings, the port of ``tpu_bfs/analysis/cli.py`` (JAX's flags, JSON keys
and exit codes).

Exit status: 0 when every finding is baseline-suppressed (or none
exist), 1 on a new finding, 2 on a bad argument or a missing card. The
baseline (``--baseline``, default the port's ``analysis/baseline.txt``)
holds one fingerprint a line; stale entries are reported, and
``--write-baseline`` rewrites it from the current findings.

``--fast`` runs the subset that needs no device and exports no program:
the uniformity taint, the lock, lifecycle and fault-coverage passes and
the ladder model. The default also exports every program of
``analysis/configs.py`` and runs the dtype scan, the host-op scan, the
peak estimates and the in-place certificates over them, the guard drive
on the card, and the retrace and lazy-distance sentinels. It runs on the
card unless ``--device cpu`` is given; without a card and without that
flag it fails and says so. The mesh configs run on a gloo group of
:data:`SWEEP_RANKS` ranks (on the card, gloo ranks sharing it).

One summary line a pass goes to stderr (``# <pass>: N finding(s); ...``)
and every new finding to stdout; ``--json`` writes the whole report
instead (``ok``, ``findings``, ``suppressed``, ``stale_baseline``,
``passes``).
"""

from __future__ import annotations

import argparse
import json
import sys

from tpu_bfs_torch.analysis import (
    DEFAULT_BASELINE,
    PASSES,
    SOURCE_PASSES,
    Finding,
    apply_baseline,
    load_baseline,
    run_pass,
)

#: The ladder model's operating point: the flagship's RMAT 21 shape.
MODEL_VERTICES = 1 << 21
MODEL_EDGES = 1 << 25
MODEL_DEVICES = 8
#: Ranks of the mesh configs' gloo group in the program sweep (on the card,
#: gloo ranks sharing it): two, so every rank-local program has a peer.
SWEEP_RANKS = 2


def _log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def _summary(name: str, findings, info: dict) -> None:
    counts = {k: (len(v) if isinstance(v, (list, dict, set, tuple)) else v)
              for k, v in info.items()}
    _log(f"{name}: {len(findings)} finding(s); {counts}")


def run_memory_static() -> tuple[list[Finding], dict]:
    from tpu_bfs_torch.analysis.memory import check_registry_ladders

    findings, ladders = check_registry_ladders(
        num_vertices=MODEL_VERTICES, num_edges=MODEL_EDGES, device_count=MODEL_DEVICES)
    return findings, {"ladders": {fam: [{"lanes": w, "model_bytes": b} for w, b in entries]
                                  for fam, entries in ladders.items()}}


def analyse_program(spec, skip: set, *, guard: bool) -> tuple[list[Finding], dict | None]:
    """The program passes over one :class:`configs.ProgramSpec`: the dtype
    scan, the host-op scan and (on the card) the guard drive, the peak
    estimate and the in-place certificate. Returns the findings and the
    peak certificate (None when memory is skipped)."""
    from tpu_bfs_torch.analysis import dtypes, memory, transfer
    from tpu_bfs_torch.analysis.graph import user_input_names, walk_program

    ep = spec.export()
    walk = walk_program(ep)
    out: list[Finding] = []
    est = None
    if "dtype" not in skip:
        out += dtypes.check_walk(spec.name, walk)
    if "transfer" not in skip:
        out += transfer.check_host_ops(spec.name, walk)
        if guard:
            out += transfer.check_guard_drive(spec.name, spec.fn, transfer.materialize(spec.args))
    if "memory" not in skip:
        est = memory.estimate_walk(spec.name, walk)
        out += memory.check_in_place(spec.name, walk,
                                     memory.documented_in_place(spec.fn),
                                     user_input_names(ep))
    return out, est


def run_sentinels(device) -> tuple[list[Finding], dict]:
    """The retrace sentinel over an adopted single-device wide engine
    (exported into a fresh store, adopted, driven twice at one shape) and
    the lazy-distance contract on the same engine."""
    import tempfile

    import numpy as np

    from tpu_bfs_torch.algorithms.msbfs_wide import WidePackedMsBfsEngine
    from tpu_bfs_torch.analysis import transfer
    from tpu_bfs_torch.analysis.configs import _graph
    from tpu_bfs_torch.utils.aot import (
        ArtifactStore,
        adopt_engine_programs,
        export_engine_programs,
    )

    g = _graph()
    eng = WidePackedMsBfsEngine(g, lanes=64, device=device)
    n = eng.num_vertices
    turn = {"i": 0}

    def drive(engine):
        turn["i"] += 1  # same shape, other sources each drive
        return engine.fetch(engine.dispatch((np.arange(engine.lanes) + turn["i"]) % n))

    spec = {"graph_key": "analysis", "engine": "wide", "lanes": eng.lanes, "planes": eng.num_planes}
    with tempfile.TemporaryDirectory(prefix="tpu_bfs_torch_analysis_") as root:
        store = ArtifactStore(root)
        export_engine_programs(eng, spec, store)
        adopt_engine_programs(eng, spec, store)
        findings = transfer.check_adopted_retrace("wide-adopted", eng, drive, store)
        counts = store.counts()
    findings += transfer.check_lazy_distances("wide-adopted", eng, np.arange(eng.lanes) % n)
    return findings, {"adopted": list(getattr(eng, "_aot_adopted", ())), **counts}


def _sweep_rank(mesh, configs, skip, guard: bool):
    """One rank of the program sweep: every rank builds each mesh engine in
    order; rank 0 also builds the single-device ones and analyses every
    program. Returns rank 0's ``(findings, estimates, programs)``."""
    import torch

    from tpu_bfs_torch.analysis.configs import iter_programs
    from tpu_bfs_torch.parallel.mesh import make_mesh_2d, square_shape

    torch.set_num_threads(1)
    mesh2d = make_mesh_2d(*square_shape(mesh.num_shards), mesh=mesh)
    findings, estimates, programs = [], [], []
    lead = mesh.rank == 0
    for spec in iter_programs(configs, mesh=mesh, mesh2d=mesh2d, device=mesh.device,
                              analyse=lead):
        f, est = analyse_program(spec, skip, guard=guard)
        findings += f
        programs.append(spec.name)
        if est is not None:
            estimates.append(est)
    return findings, estimates, programs


def run_program_passes(configs, skip: set, *, device: str):
    from tpu_bfs_torch.parallel.mesh import launch

    guard = device.startswith("cuda")
    return launch(SWEEP_RANKS, _sweep_rank, configs, skip, guard, device=device,
                  backend="gloo")


def _resolve_device(device: str | None) -> str:
    """The sweep's device: the card unless ``--device`` names the CPU; a
    run without a card and without ``--device cpu`` is refused."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit(
                "no CUDA device: the full analysis run exports and drives the programs on "
                "the card; pass --device cpu to run it on the CPU, or --fast for the passes "
                "that need no device")
        return "cuda:0"
    if device == "cuda":
        return "cuda:0"
    return device


def judged_baseline(baseline: set, skip, programs) -> set:
    """The baseline entries this run can judge: those of a pass that ran
    and, for a program pass, of a program it analysed (an entry naming
    another run's program is neither matched nor stale here)."""
    programs = set(programs)
    out = set()
    for fp in baseline:
        pass_name, _, where = fp.partition(":")
        if pass_name.split("/")[0] in skip:
            continue
        if pass_name.split("/")[0] in ("dtype", "transfer", "memory") and (
                pass_name != "memory/ladder" and where.rsplit(":", 1)[0] not in programs):
            continue
        out.add(fp)
    return out


def _finding_json(f: Finding) -> dict:
    return {"pass": f.pass_name, "where": f.where, "message": f.message,
            "fingerprint": f.fingerprint}


def main(argv=None) -> int:
    from tpu_bfs_torch.analysis.configs import ALL_CONFIGS, NOT_BUILT
    from tpu_bfs_torch.analysis.locks import repo_root

    ap = argparse.ArgumentParser(
        prog="python -m tpu_bfs_torch.analysis",
        description="Static and program checks of the port: collective uniformity, "
                    "transfers and retraces, lock discipline, dtypes, memory, exception-path "
                    "lifecycles, fault-site coverage.")
    ap.add_argument("--fast", action="store_true",
                    help="the subset that needs no device and exports no program: the "
                         "uniformity taint, locks, lifecycle, faultcov and the ladder model")
    ap.add_argument("--configs", default=None, metavar="A,B",
                    help="restrict the program sweep (names from analysis/configs.py)")
    ap.add_argument("--skip", default="", metavar="PASS,..",
                    help=f"skip passes: any of {','.join(PASSES)}")
    ap.add_argument("--pass", dest="passes", action="append", choices=PASSES,
                    help="run only this pass (repeatable; default: all)")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="suppression file (default: the port's analysis/baseline.txt; "
                         "missing = empty)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline file from the current findings and exit 0")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="write the whole report to stdout as one JSON object")
    ap.add_argument("--device", default=None,
                    help="the program sweep's device (default: the card; 'cpu' to run it "
                         "on the CPU)")
    ap.add_argument("--root", default=repo_root(), help="the checkout to check")
    args = ap.parse_args(argv)

    skip = {tok.strip() for tok in args.skip.split(",") if tok.strip()}
    unknown = skip - set(PASSES)
    if unknown:
        _log(f"unknown pass(es) in --skip: {sorted(unknown)}; have: {', '.join(PASSES)}")
        return 2
    if args.passes:
        skip |= set(PASSES) - set(args.passes)
    configs = None
    if args.configs:
        configs = tuple(tok.strip() for tok in args.configs.split(",") if tok.strip())
        bad = [c for c in configs if c not in ALL_CONFIGS]
        if bad:
            _log(f"unknown config(s) {bad}; have: {', '.join(ALL_CONFIGS)}")
            return 2
    program_passes = {"dtype", "transfer", "memory"} - skip
    device = None
    if not args.fast and program_passes:
        try:
            device = _resolve_device(args.device)
        except SystemExit as exc:
            _log(str(exc))
            return 2

    findings: list[Finding] = []
    info: dict = {}
    by_pass: dict = {name: [] for name in PASSES}
    for name in SOURCE_PASSES:
        if name not in skip:
            f, info[name] = run_pass(name, args.root)
            by_pass[name] += f
    if "memory" not in skip:
        f, info["memory"] = run_memory_static()
        by_pass["memory"] += f
    if device is not None:
        prog_f, estimates, programs = run_program_passes(configs, skip, device=device)
        for f in prog_f:
            by_pass[f.pass_name.split("/")[0]].append(f)
        for name in ("dtype", "transfer"):
            if name not in skip:
                info.setdefault(name, {})["programs"] = programs
        if "memory" not in skip:
            info["memory"]["program_estimates"] = estimates
        info.setdefault("configs", {})["not_built"] = dict(NOT_BUILT)
        if "transfer" not in skip:
            sent_f, info["transfer"]["sentinels"] = run_sentinels(device)
            by_pass["transfer"] += sent_f
    elif args.fast:
        for name in ("dtype", "transfer"):
            if name not in skip:
                info[name] = {"programs": [], "mode": "fast: no program exported"}
    for name in PASSES:
        if name not in skip:
            _summary(name, by_pass[name], info.get(name, {}))
            findings += by_pass[name]

    if args.write_baseline:
        with open(args.baseline, "w") as f:
            f.write("# python -m tpu_bfs_torch.analysis baseline: one suppressed finding "
                    "fingerprint per line.\n")
            for fp in sorted({x.fingerprint for x in findings}):
                f.write(fp + "\n")
        _log(f"baseline written: {len(findings)} fingerprint(s) -> {args.baseline}")
        return 0

    new, suppressed, stale = apply_baseline(findings, judged_baseline(
        load_baseline(args.baseline), skip, info.get("dtype", {}).get("programs", ())))
    if args.as_json:
        print(json.dumps({
            "ok": not new,
            "findings": [_finding_json(f) for f in new],
            "suppressed": [_finding_json(f) for f in suppressed],
            "stale_baseline": sorted(stale),
            "passes": info,
        }, indent=2, sort_keys=True, default=str))
    else:
        for f in new:
            print(f.render())
    for fp in sorted(stale):
        _log(f"STALE baseline entry (no matching finding — delete it): {fp}")
    _log(f"analyze: {len(findings)} finding(s) total, {len(suppressed)} suppressed, "
         f"{len(new)} new, {len(stale)} stale baseline entr{'y' if len(stale) == 1 else 'ies'}")
    if new:
        _log("FAIL: new findings above — fix them or (for a parked known issue) add their "
             "fingerprints to the baseline")
        return 1
    _log("OK: all passes clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
