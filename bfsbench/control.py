"""The control of ``correct``, and the program's readings on many seeds,
through one set-up on the card.

    python3 -m bfsbench.control --workload <cell> --seconds 5 \\
        --seeds 1 2 3 ... --control-seeds 101 102 103

The configuration states exact hop distances and whole components. The
control breaks that guarantee with the program's own depth bound
(``dispatch(keys, max_levels=L)``): each batch stops one level short of
the deepest level the warm batch reached, as a change that dropped a
search's last, light level would. For each seed the script runs a window
of ``--seconds`` and the run's comparison, and prints the readings as one
JSON object. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys

from bfsbench import cache, harness
from bfsbench.tracing import Spans


def depth_cut(session) -> None:
    """Plant the control: every dispatch stops one level short."""
    bound = max(session.warm_levels - 1, 1)
    dispatch = session.engine.dispatch
    session.engine.dispatch = lambda keys: dispatch(keys, max_levels=bound)


def readings(session, seed: int, seconds: float) -> dict:
    run = session.window(seed, seconds)
    lanes, dist, ecc = session.lane_outputs(run, seed)
    run.last = None
    checks = harness.check(session.reference(), run, lanes, dist, ecc)
    return {"seed": seed, "batches": len(run.batches), "correct": harness.is_correct(checks),
            "checks": {k: c["value"] for k, c in checks.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    cache.use_build_dirs()
    import torch

    if not torch.cuda.is_available():
        print("bfsbench.control: no CUDA device", file=sys.stderr)
        return 3
    cell = harness.load_cell(args.workload)
    first = (args.seeds or args.control_seeds or [0])[0]
    session = harness.Session(cell, seed=first, device="cuda", cache_root=cache.CACHE_DIR,
                              spans=Spans())
    out = {"workload": cell.name, "warm_levels": session.warm_levels,
           "program": [], "control": []}
    for s in args.seeds:
        out["program"].append(readings(session, s, args.seconds))
        print(json.dumps(out["program"][-1]), file=sys.stderr, flush=True)
    if args.control_seeds:
        depth_cut(session)
    for s in args.control_seeds:
        out["control"].append(readings(session, s, args.seconds))
        print(json.dumps(out["control"][-1]), file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
