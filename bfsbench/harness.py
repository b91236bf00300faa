"""One run of one cell: set-up, the measured window, the check, the metrics.

``run_cell`` is the whole run; ``run.py`` wraps it with the device checks
and the printing. A :class:`Session` holds what set-up built (the graph,
the engine, one warm batch) and runs windows on it, so the control
(``control.py``) can drive many seeds through one set-up.

How ``correct`` is decided (every limit is 0: each comparison is exact):

- ``failed_batches``: batches of the window that raised;
- ``lanes_reached_wrong``, ``lanes_edges_wrong``: lanes, over every batch
  of the window, whose ``reached`` or ``edges_traversed`` differ from the
  key's component size or input-edge count in the reference's component
  table (a lane the program did not return counts as wrong);
- ``sampled_dist_wrong``: over the 32 lanes of one word of the window's
  last batch, drawn from the seed, the vertices whose hop distance
  (decoded from the bit planes) differs from the reference search's;
- ``sampled_ecc_wrong``: those lanes whose eccentricity differs.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

from bfsbench import cache
from bfsbench.tracing import Spans, TraceWindow, WindowProfiler
from bfsbench.reference import bfs as ref_bfs
from bfsbench.reference import components as ref_cc
from bfsbench.reference import graph as ref_graph

BENCH_DIR = Path(__file__).resolve().parent
MANIFEST = BENCH_DIR.parent / "BENCHMARK.json"
#: Top-level module names no run may hold once its window has closed.
BANNED_MODULES = ("jax", "jaxlib", "flax", "tpu_bfs")
SAMPLED_LANES = 32  # one packed word of lanes


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_plugin(kind: str, name: str):
    """Module ``bfsbench/<kind>/<name>.py``, found by name."""
    path = BENCH_DIR / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {name!r} ({path})")
    mod_name = f"bfsbench.{kind}." + name.replace("-", "_").replace(".", "_")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def banned_modules() -> list[str]:
    """Loaded modules whose whole top-level name is banned."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in BANNED_MODULES})


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    lanes: int
    chips: int


def load_cell(name: str, manifest: dict | None = None) -> Cell:
    """The cell named in ``BENCHMARK.json``, from its own files."""
    manifest = read_json(MANIFEST) if manifest is None else manifest
    entries = [w for w in manifest["workloads"] if w["name"] == name]
    if not entries:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    entry = entries[0]
    spec = read_json(BENCH_DIR / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if spec[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json has {key}={spec[key]!r}, "
                             f"BENCHMARK.json {entry[key]!r}")
    return Cell(
        name=name, config_name=entry["config"],
        config=read_json(BENCH_DIR / "configs" / f"{entry['config']}.json"),
        traffic_name=entry["traffic"],
        traffic=read_json(BENCH_DIR / "traffic" / f"{entry['traffic']}.json"),
        lanes=int(spec["lanes"]), chips=int(spec["chips"]))


def cell_metrics(manifest: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: end-to-end, or per-layer."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


@dataclasses.dataclass(frozen=True)
class BenchGraph:
    """The edge list both sides get, with the key sampler's candidates."""

    u: np.ndarray  # [E] int32
    v: np.ndarray  # [E] int32
    num_vertices: int
    num_input_edges: int  # generated, before self-loops are dropped
    candidates: np.ndarray  # vertices of degree > 0, int64
    cache_dir: Path


def load_graph(config_name: str, config: dict, cache_root: Path) -> BenchGraph:
    params = config["graph"]
    gen = load_plugin("graphs", params["generator"])
    gdir = cache.graph_dir(cache_root, config_name, params, gen.source_files())
    nv = 1 << int(params["scale"])
    got = cache.load_arrays(gdir, ("u", "v", "candidates", "generated"))
    if got is None:
        u, v = gen.edges(params, Path(cache_root) / "native")
        generated = np.array([len(u)], dtype=np.int64)
        if params.get("drop_self_loops", False):
            keep = u != v
            u, v = u[keep], v[keep]
        u, v = u.astype(np.int32), v.astype(np.int32)
        candidates = np.flatnonzero(ref_graph.degrees(u, v, nv) > 0).astype(np.int64)
        got = dict(u=u, v=v, candidates=candidates, generated=generated)
        cache.save_arrays(gdir, got)
    return BenchGraph(got["u"], got["v"], nv, int(got["generated"][0]), got["candidates"], gdir)


@dataclasses.dataclass(frozen=True)
class Reference:
    row_ptr: np.ndarray
    col: np.ndarray
    table: ref_cc.ComponentTable


def load_reference(graph: BenchGraph) -> Reference:
    """The reference's adjacency and component table (cached beside the
    edge list: built once a checkout, from the edge list alone)."""
    got = cache.load_arrays(graph.cache_dir, ("ref_row_ptr", "ref_col", "ref_label"))
    if got is None:
        row_ptr, col = ref_graph.undirected_csr(graph.u, graph.v, graph.num_vertices)
        got = dict(ref_row_ptr=row_ptr, ref_col=col, ref_label=ref_cc.labels(row_ptr, col))
        cache.save_arrays(graph.cache_dir, got)
    return Reference(got["ref_row_ptr"], got["ref_col"],
                     ref_cc.table(got["ref_label"], graph.u))


def _sync(device) -> None:
    if str(device).startswith("cuda"):
        import torch

        torch.cuda.synchronize()


class Session:
    """Set-up once: the graph, the engine, one warm batch of the cell's shape."""

    def __init__(self, cell: Cell, *, seed: int, device, cache_root: Path, spans):
        self.cell = cell
        self.device = device
        self.spans = spans
        cfg, traffic = cell.config, cell.traffic
        with spans.span("graph"):
            self.graph = load_graph(cell.config_name, cfg, cache_root)
        self.adapter = load_plugin("engines", cfg["engine"]["name"])
        self.sampler_mod = load_plugin("traffic", traffic["sampler"])
        self.loop = load_plugin("traffic", traffic["loop"])
        self.engine = self.adapter.build(self.graph, cfg["engine"], cell.lanes, device, spans)
        with spans.span("warm"):
            warm = self.sampler(seed, self.sampler_mod.WARM).next()
            res = self.engine.fetch(self.engine.dispatch(warm))
            self.warm_levels = self.adapter.counts(res)[0]
            del res
            _sync(device)
        self._reference = None

    def sampler(self, seed: int, stream: int):
        return self.sampler_mod.Sampler(self.graph.candidates,
                                        self.cell.traffic["keys_per_batch"], seed, stream)

    def window(self, seed: int, seconds: float):
        """The measured window on ``seed``'s keys."""
        return self.loop.run(self.engine, self.adapter,
                               self.sampler(seed, self.sampler_mod.WINDOW), seconds,
                               self.spans, lambda: _sync(self.device))

    def sampled_lanes(self, seed: int, batch_keys: int) -> np.ndarray:
        """The lanes of one word of a batch, the word drawn from the seed."""
        words = -(-batch_keys // SAMPLED_LANES)
        wi = int(self.sampler_mod.rng(seed, self.sampler_mod.CHECK).integers(words))
        return np.arange(wi * SAMPLED_LANES, min((wi + 1) * SAMPLED_LANES, batch_keys))

    def lane_outputs(self, run, seed: int):
        """The sampled lanes and their program outputs (from the last batch)."""
        lanes = self.sampled_lanes(seed, len(run.batches[-1].keys))
        if run.last is None:
            return lanes, None, None
        dist, ecc = self.adapter.lane_outputs(run.last, lanes)
        return lanes, dist, ecc

    def close(self) -> None:
        """Free the engine and its device memory."""
        self.engine = None
        gc.collect()
        if str(self.device).startswith("cuda"):
            import torch

            torch.cuda.empty_cache()

    def reference(self) -> Reference:
        if self._reference is None:
            self._reference = load_reference(self.graph)
        return self._reference


def _wrong(got: np.ndarray, want: np.ndarray) -> int:
    """Lanes whose value differs; a lane the program did not return is wrong."""
    m = min(len(got), len(want))
    return int(np.count_nonzero(got[:m] != want[:m])) + (len(want) - m)


def check(ref: Reference, run, lanes, dist, ecc) -> dict:
    """The numbers compared, each ``{"value", "limit"}`` (module docstring)."""
    tab = ref.table
    failed = reached_wrong = edges_wrong = 0
    for b in run.batches:
        if b.error is not None:
            failed += 1
            continue
        reached_wrong += _wrong(b.reached, tab.reached(b.keys))
        edges_wrong += _wrong(b.edges, tab.traversed(b.keys))
    nv = len(ref.row_ptr) - 1
    if dist is None:  # the last batch never came back: no sampled answer
        dist_wrong, ecc_wrong = len(lanes) * nv, len(lanes)
    else:
        want = ref_bfs.distances(ref.row_ptr, ref.col, run.batches[-1].keys[lanes])
        dist_wrong = int(np.count_nonzero(dist != want))
        ecc_wrong = int(np.count_nonzero(ecc != ref_bfs.eccentricity(want)))
    readings = dict(failed_batches=failed, lanes_reached_wrong=reached_wrong,
                    lanes_edges_wrong=edges_wrong, sampled_dist_wrong=dist_wrong,
                    sampled_ecc_wrong=ecc_wrong)
    return {k: {"value": v, "limit": 0} for k, v in readings.items()}


def is_correct(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


@dataclasses.dataclass
class RunRecord:
    """What the metric readers (``metrics/<name>.py``) read of one run."""

    cell: Cell
    spans: Spans
    setup_s: float
    run: object  # the traffic loop's WindowRun
    peak_bytes: int | None
    reference: Reference
    trace: TraceWindow | None
    device_name: str
    facts: dict  # the engine adapter's kernel_facts


def breakdown(tw: TraceWindow) -> dict:
    """The device operations that took most time, and the idle time by the
    benchmark span that was open, each at most 10, in seconds."""
    ops: dict[str, float] = {}
    for op in tw.device_ops:
        ops[op.name] = ops.get(op.name, 0.0) + op.dur / 1e6
    idle = {name: us / 1e6 for name, us in tw.idle_by_span().items()}
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [list(kv) for kv in top], "idle_gaps": [list(kv) for kv in gaps]}


def run_cell(cell: Cell, *, seed: int, seconds: float, trace: bool, device,
             cache_root: Path = cache.CACHE_DIR, t0: float | None = None,
             manifest: dict | None = None, plant=None, device_info: dict | None = None) -> dict:
    """One run; returns the result object (without printing it).

    ``plant(session)``, for the control and the tests, changes the system
    under test after set-up; the benchmark's own runs never pass one."""
    import torch

    manifest = read_json(MANIFEST) if manifest is None else manifest
    t0 = time.perf_counter() if t0 is None else t0
    cuda = str(device).startswith("cuda")
    spans = Spans()
    sess = Session(cell, seed=seed, device=device, cache_root=cache_root, spans=spans)
    if plant is not None:
        plant(sess)
    setup_s = time.perf_counter() - t0
    prof = None
    if trace:
        prof = WindowProfiler(cuda)
        with prof:
            spans.annotate = True
            with prof.window():
                run = sess.window(seed, seconds)
            spans.annotate = False
    else:
        run = sess.window(seed, seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else None
    lanes, dist, ecc = sess.lane_outputs(run, seed)
    run.last = None
    facts = sess.adapter.kernel_facts(sess.engine)
    sess.close()
    device_name = torch.cuda.get_device_name() if cuda else "cpu"
    tw = prof.read(device_name) if trace else None
    ref = sess.reference()
    checks = check(ref, run, lanes, dist, ecc)
    record = RunRecord(cell, spans, setup_s, run, peak, ref, tw, device_name, facts)
    metrics = {}
    for m in cell_metrics(manifest, cell.name, trace):
        value = load_plugin("metrics", m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    keys_per_batch = len(run.batches[0].keys)
    failed = sum(len(b.keys) for b in run.batches if b.error is not None)
    dev = {"platform": "gpu" if cuda else "cpu", "kind": device_name, "count": cell.chips,
           "memory_peak_bytes": peak}
    if tw is not None:
        dev["busy_s"] = tw.busy_seconds()
        dev["window_s"] = tw.seconds
    dev.update(device_info or {})
    result = {
        "correct": is_correct(checks),
        "attempted": keys_per_batch * len(run.batches),
        "failed": failed,
        "metrics": metrics,
        "device": dev,
    }
    if tw is not None:
        result["breakdown"] = breakdown(tw)
    result["checks"] = checks
    return result
