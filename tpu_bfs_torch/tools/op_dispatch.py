#!/usr/bin/env python3
"""Host cost of one K1 call through each layer of the kernel-op route.

    python3 -m tpu_bfs_torch.tools.op_dispatch                # on the card
    python3 -m tpu_bfs_torch.tools.op_dispatch --device cpu

Times ``--calls`` calls a series (host clock, after a warm-up) of K1
``or`` on one 128-row tile, one frontier word and one slot, so a call's
host work, not the kernel, is what shows: 25 rounds, the series in turns
within each, and each series' median round. On CUDA the card is idle
before each round and a round is enqueue-bound. Each series calls the same
kernel through:

- ``wrapper``: ``ops.ell_expand.ell_expand``, the operand checks, then the
  registered op (every path's route);
- ``op``: ``torch.ops.tpu_bfs_torch.ell_expand.default``, the op registered
  with ``torch.library.Library`` (a kernel a dispatch key);
- ``custom_op``: the same kernel function registered with
  ``torch.library.custom_op`` under a namespace of this tool's own (the
  registration the port's ops used before);
- ``kernel``: the kernel function itself (the CUDA launch or the CPU twin).

Prints the card's name and power limit (on CUDA), then one JSON line:
microseconds a call for each series and the layers' differences.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch


def _custom_op(kernel):
    """``kernel`` registered as a ``torch.library.custom_op`` with a fake."""
    from tpu_bfs_torch.ops.ell_expand import _ell_expand_fake

    @torch.library.custom_op("tpu_bfs_torch_dispatch_probe::ell_expand", mutates_args=())
    def op(need_blk: torch.Tensor, gt: torch.Tensor, fw: torch.Tensor,
           wt: torch.Tensor | None, op: str) -> torch.Tensor:
        return kernel(need_blk, gt, fw, wt, op)

    op.register_fake(_ell_expand_fake)
    return op


def measure(device: str, calls: int, rounds: int = 25) -> dict:
    from tpu_bfs_torch.ops import ell_expand as k1

    dev = torch.device(device)
    kernel = k1._ell_expand_cuda if dev.type == "cuda" else k1._ell_expand_cpu
    need = torch.ones(1, dtype=torch.int32, device=dev)
    gt = torch.zeros((1, k1.TILE), dtype=torch.int32, device=dev)
    fw = torch.ones((2, 1), dtype=torch.int32, device=dev)
    series = {
        "wrapper": lambda: k1.ell_expand(need, gt, fw),
        "op": lambda: k1.ell_expand_op(need, gt, fw, None, "or"),
        "custom_op": (lambda op: lambda: op(need, gt, fw, None, "or"))(_custom_op(kernel)),
        "kernel": lambda: kernel(need, gt, fw, None, "or"),
    }
    want = k1.ell_expand_plain(need.cpu(), gt.cpu(), fw.cpu())
    launches = k1.ell_expand.launches
    for name, call in series.items():
        if not torch.equal(call().cpu(), want):
            raise SystemExit(f"{name}: the result differs from the plain twin")
        for _ in range(min(200, calls)):
            call()
    # The series in turns, each round starting from the next one, so a
    # shared host's drift and bursts fall on all alike; the median round.
    per = max(1, calls // rounds)
    times = {name: [] for name in series}
    names = list(series)
    for r in range(rounds):
        for name in names[r % len(names):] + names[:r % len(names)]:
            call = series[name]
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(per):
                call()
            times[name].append((time.perf_counter() - t0) / per * 1e6)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    us = {name: statistics.median(ts) for name, ts in times.items()}
    k1.ell_expand.launches = launches  # a measurement, not a path's launches
    return {
        "device": device, "calls": per * rounds, "rounds": rounds, "us_per_call": us,
        "op_over_kernel_us": us["op"] - us["kernel"],
        "custom_op_over_kernel_us": us["custom_op"] - us["kernel"],
        "checks_us": us["wrapper"] - us["op"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--calls", type=int, default=5000)
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device (pass --device cpu)", file=sys.stderr)
            return 1
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=False)
        print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: none")
    print(json.dumps(measure(args.device, args.calls)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
