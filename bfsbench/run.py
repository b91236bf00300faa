"""Run one cell of ``BENCHMARK.json`` once on the card and print its result.

    python3 -m bfsbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result object; the last lines of
standard error are the numbers compared, each with its limit. The run
fails, and prints no result, when there is no CUDA device or fewer than
the cell asks for, when the port cannot be imported, or when a JAX module
or the JAX package is loaded once the window has closed. It never falls
back to the CPU.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402


def power_limit_w() -> float | None:
    """The card's power limit as ``nvidia-smi`` reads it (printed beside
    the roofline shares: a card below 700 W runs slower under load)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from bfsbench import cache

    cache.use_build_dirs()
    import torch

    if not torch.cuda.is_available():
        print("bfsbench: no CUDA device (torch.cuda.is_available() is false); "
              "the benchmark runs only on the card", file=sys.stderr)
        return 3
    from bfsbench import harness

    cell = harness.load_cell(args.workload)
    if torch.cuda.device_count() < cell.chips:
        print(f"bfsbench: {args.workload} needs {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    torch.cuda.reset_peak_memory_stats()
    try:
        import tpu_bfs_torch  # noqa: F401
    except ImportError as exc:
        print(f"bfsbench: the port tpu_bfs_torch cannot be imported: {exc}", file=sys.stderr)
        return 3
    result = harness.run_cell(cell, seed=args.seed, seconds=args.seconds,
                              trace=bool(args.trace), device="cuda", t0=T0,
                              device_info={"power_limit_w": power_limit_w()})
    banned = harness.banned_modules()
    if banned:
        print(f"bfsbench: the run loaded {', '.join(banned)}", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
