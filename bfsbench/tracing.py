"""The benchmark's own spans, and the device trace of the measured window.

Spans are host-clock intervals the benchmark records around its calls into
the program (``graph``, ``from_edges``, ``engine_build``, ``warm``, and in
the window ``keys``, ``dispatch``, ``fetch``). In a traced run each span
inside the window is also a ``torch.profiler`` annotation
(``bfsbench.<name>``), so the trace places it against the device's
kernels. The trace is exported as a Chrome trace into a temporary
directory under ``TMPDIR``, read back, and deleted.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
import shutil
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bfsbench.window"


@dataclasses.dataclass
class Span:
    name: str
    t0: float
    t1: float

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class Spans:
    def __init__(self):
        self.spans: list[Span] = []
        self.annotate = False

    @contextlib.contextmanager
    def span(self, name: str):
        rf = contextlib.nullcontext()
        if self.annotate:
            from torch.profiler import record_function

            rf = record_function(f"bfsbench.{name}")
        t0 = time.perf_counter()
        with rf:
            yield
        self.spans.append(Span(name, t0, time.perf_counter()))

    def seconds(self, name: str, after: float | None = None) -> float:
        return sum(s.seconds for s in self.spans
                   if s.name == name and (after is None or s.t0 >= after))

    def count(self, name: str, after: float | None = None) -> int:
        return sum(1 for s in self.spans if s.name == name and (after is None or s.t0 >= after))


@dataclasses.dataclass
class DeviceOp:
    name: str  # short_name(raw)
    cat: str
    ts: float  # microseconds, trace clock
    dur: float
    raw: str = ""


@dataclasses.dataclass
class CpuOp:
    name: str
    ts: float
    dur: float
    dims: list


def short_name(name: str) -> str:
    """A kernel's name without its return type and parameter list: cut at
    the first ``(`` outside template brackets, at most 160 characters."""
    s = name.replace("(anonymous namespace)::", "")
    s = s[5:] if s.startswith("void ") else s
    depth = 0
    for i, ch in enumerate(s):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth <= 0:
            s = s[:i]
            break
    return s.strip()[:160]


@dataclasses.dataclass
class TraceWindow:
    """What the per-layer readers read of the trace: the traced window's
    device operations, the program's recorded op calls with their input
    shapes, and the benchmark's annotations (all in trace microseconds,
    clipped to the window)."""

    start: float
    end: float
    device_ops: list
    cpu_ops: list
    annotations: list
    device_name: str

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e6

    def kernels(self, *patterns: str) -> list:
        ks = [op for op in self.device_ops if op.cat == "kernel"]
        if patterns:
            ks = [op for op in ks if any(p in op.raw for p in patterns)]
        return ks

    def ops(self, name: str) -> list:
        return [op for op in self.cpu_ops if op.name == name]

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, sorted."""
        merged = []
        for op in sorted(self.device_ops, key=lambda o: o.ts):
            a, b = op.ts, op.ts + op.dur
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_seconds(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def idle_gaps(self) -> list:
        """[(start, end)] of the window's stretches with no device operation."""
        gaps, t = [], self.start
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.end > t:
            gaps.append((t, self.end))
        return gaps

    def idle_by_span(self) -> dict:
        """Idle microseconds by the benchmark span open at the time (the
        window's spans follow one another; ``between`` outside them)."""
        out: dict[str, float] = {}
        for a, b in self.idle_gaps():
            covered = 0.0
            i = max(bisect.bisect_right(self._starts, a) - 1, 0)
            while i < len(self.annotations) and self.annotations[i][1] < b:
                name, s, d = self.annotations[i]
                part = min(b, s + d) - max(a, s)
                if part > 0:
                    out[name] = out.get(name, 0.0) + part
                    covered += part
                i += 1
            if b - a - covered > 0:
                out["between"] = out.get("between", 0.0) + (b - a - covered)
        return out

    def __post_init__(self):
        self.annotations.sort(key=lambda a: a[1])
        self._starts = [a[1] for a in self.annotations]


def read_chrome_trace(path: str, device_name: str) -> TraceWindow:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    window = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW]
    if not window:
        raise RuntimeError(f"the trace holds no {WINDOW} annotation")
    start = float(window[0]["ts"])
    end = start + float(window[0]["dur"])
    device_ops, cpu_ops, annotations = [], [], []
    for e in events:
        if e.get("ph") != "X" or "ts" not in e:
            continue
        ts, dur, cat = float(e["ts"]), float(e.get("dur", 0.0)), e.get("cat", "")
        if ts < start or ts >= end:
            continue
        if cat in DEVICE_CATS:
            device_ops.append(DeviceOp(short_name(e["name"]), cat, ts, min(dur, end - ts),
                                       e["name"]))
        elif cat == "cpu_op":
            cpu_ops.append(CpuOp(e["name"], ts, dur, e.get("args", {}).get("Input Dims", [])))
        elif cat == "user_annotation" and e["name"].startswith("bfsbench.") \
                and e["name"] != WINDOW:
            annotations.append((e["name"][len("bfsbench."):], ts, dur))
    return TraceWindow(start, end, device_ops, cpu_ops, annotations, device_name)


class WindowProfiler:
    """``torch.profiler`` over the measured window (CPU ops with their
    input shapes, and the CUDA activity when there is a card)."""

    def __init__(self, cuda: bool):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        self.prof = profile(activities=acts, record_shapes=True)

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        return False

    def window(self):
        from torch.profiler import record_function

        return record_function(WINDOW)

    def read(self, device_name: str) -> TraceWindow:
        tmp = tempfile.mkdtemp(prefix="bfsbench_trace_")
        try:
            path = os.path.join(tmp, "window.json")
            self.prof.export_chrome_trace(path)
            return read_chrome_trace(path, device_name)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
