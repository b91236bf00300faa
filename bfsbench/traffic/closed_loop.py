"""The closed loop with one caller: draw a batch's keys, ``dispatch``,
``fetch``, and start the next only when the last has come back. The window
holds whole batches: it ends with the first batch that ends at or after
``seconds``. A batch that raises counts as failed and the loop goes on.

Only one batch's result is alive at a time: each is dropped before the
next dispatch, except the window's last, which the check reads."""

from __future__ import annotations

import dataclasses
import sys
import time
import traceback

import numpy as np


@dataclasses.dataclass
class Batch:
    keys: np.ndarray
    t0: float
    t1: float = 0.0
    num_levels: int = 0
    reached: np.ndarray | None = None
    edges: np.ndarray | None = None
    error: str | None = None


@dataclasses.dataclass
class WindowRun:
    batches: list
    t0: float
    t1: float
    last: object  # the last batch's result, None if it failed

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def run(engine, adapter, sampler, seconds: float, spans, sync) -> WindowRun:
    batches, last = [], None
    sync()
    t_start = time.perf_counter()
    while True:
        with spans.span("keys"):
            keys = sampler.next()
        b = Batch(keys=keys, t0=time.perf_counter())
        res = None
        try:
            with spans.span("dispatch"):
                pend = engine.dispatch(keys)
            with spans.span("fetch"):
                res = engine.fetch(pend)
            del pend
            b.num_levels, b.reached, b.edges = adapter.counts(res)
        except Exception as exc:  # a failed batch is counted, the loop goes on
            if not any(x.error for x in batches):
                traceback.print_exc(file=sys.stderr)
            b.error = f"{type(exc).__name__}: {exc}"
            res = None
        b.t1 = time.perf_counter()
        batches.append(b)
        if b.t1 - t_start >= seconds:
            last = res
            break
        del res
    sync()
    return WindowRun(batches=batches, t0=t_start, t1=time.perf_counter(), last=last)
