"""Device timing of one engine run, the port of ``tpu_bfs/utils/timing.py``.

The reference times each run with std::chrono (bfs.cu:624-626). Here the
first CUDA call builds and loads the kernels and warms the allocator, so an
engine runs once untimed before its first timed run.
"""

from __future__ import annotations

import time

import torch


def fence(device) -> None:
    """Wait until every kernel queued on ``device`` has finished; a no-op
    off the card (CPU tensor ops return complete)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_timed(call, *, warm: bool, device):
    """Run ``call`` and return ``(result, elapsed_seconds)``.

    With ``warm``, one untimed run goes first. The timed run is fenced by
    ``torch.cuda.synchronize(device)`` on both sides, so the time is the
    device's, not the enqueue's. The JAX version also subtracts the fence's
    own epilogue, measured on a finished output: that corrects the round
    trip of a remote TPU's element read (about 0.1 s), and a local
    synchronize has no such cost to correct."""
    if warm:
        call()
    fence(device)
    t0 = time.perf_counter()
    out = call()
    fence(device)
    return out, max(time.perf_counter() - t0, 1e-9)
