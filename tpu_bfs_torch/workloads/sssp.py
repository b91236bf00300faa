"""Bucketed delta-stepping SSSP over the ELL tables, the port of
``tpu_bfs/workloads/sssp.py``.

The bucketed ELL the packed BFS engines expand runs MIN-PLUS instead of OR:
``out[v] = min over in-edges (u, v) of dist[u] + w(u, v)`` over an int32
tentative-distance table [rows, L], one column per SSSP lane. The weight
planes (``graph/ell.build_ell_weights``) ride the bucket tables slot for
slot, padded to whole 128-row blocks like the index tables. Every bucket
is one K1 launch with ``op="minplus"`` (``make_expand``; CUDA on the card,
``ell_expand_plain`` on CPU tensors), and the heavy rows' fold pyramid
folds with ``minimum``, whose identity ``INF_W`` is K1's
``MINPLUS_IDENT``.

The loop is delta-stepping's light/heavy bucket loop (Meyer and Sanders,
via Buluç and Madduri, arXiv:1104.4518): within the current bucket
``[.., hi)``, only LIGHT edges (weight <= delta) relax, to a fixed point;
when a light sweep changes nothing, one relaxation over ALL edges (the
heavy close) runs and the bound advances by delta. It ends when nothing
changed and no finite distance sits at or above the bound: a Bellman-Ford
fixed point, the shortest paths for positive weights.

JAX runs the loop as one ``lax.while_loop`` with a ``lax.cond`` for the
close. Here the host steers it: a round whose light sweep changed
something reads the device once (that round's ``alive`` is then known to
be true and its bound unchanged); a close round reads a second time, after
the close. ``rounds`` counts the same bodies as JAX; ``last_host_reads``
and ``last_closes`` record the reads and closes of the last batch.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tpu_bfs_torch import faults as _faults
from tpu_bfs_torch.algorithms._packed_common import expand_arrays, make_expand, resolve_device
from tpu_bfs_torch.algorithms.msbfs_wide import expand_spec
from tpu_bfs_torch.graph.csr import INF_DIST, Graph
from tpu_bfs_torch.graph.dynamic import (
    device_overlay_tables,
    empty_overlay_tables,
    make_overlay_fold,
)
from tpu_bfs_torch.graph.ell import build_ell, build_ell_weights, pad_gate_blocks
from tpu_bfs_torch.ops.ell_expand import MINPLUS_IDENT

#: On-device "unreached" tentative distance. 2**29 keeps every sum the
#: expansion forms (dist + weight, each <= INF_W) under 2**30, far from
#: int32 overflow, while any true shortest distance (< V * wmax) stays far
#: below it at every supported scale.
INF_W = np.int32(1 << 29)


def _check_kernel_ident() -> None:
    # K1 bakes the min-plus identity in (csrc/ell_expand.cu); gated and pad
    # rows absorb under min only if both definitions agree.
    assert MINPLUS_IDENT == int(INF_W), (MINPLUS_IDENT, int(INF_W))


class SsspDispatch:
    """A finished SSSP loop whose result is not assembled yet (the host
    steers the loop, so dispatch returns after it; the split keeps the JAX
    dispatch/fetch protocol)."""

    __slots__ = ("sources", "dist", "rounds", "alive", "t0")

    def __init__(self, sources, dist, rounds, alive, t0):
        self.sources = sources
        self.dist = dist
        self.rounds = rounds
        self.alive = alive
        self.t0 = t0


class SsspBatchResult:
    """Batch result with lazy per-lane distance columns: ``reached`` and
    ``ecc`` reduce on the device; ``distances_int32(i)`` copies ONE [rows]
    column to the host, maps it to real vertex ids and caches it."""

    def __init__(self, engine, sources, dist, rounds, reached, ecc, iso,
                 elapsed_s=None):
        self._engine = engine
        self.sources = np.asarray(sources, dtype=np.int32)
        self._dist = dist  # device [rows, L] int32
        self.rounds = rounds  # delta-stepping bodies run
        n = len(self.sources)
        self.reached = np.asarray(reached)[:n].astype(np.int64)
        self.ecc = np.asarray(ecc)[:n].astype(np.int32)
        self.edges_traversed = None
        self.elapsed_s = elapsed_s
        self._iso = iso
        if iso is not None and iso.any():
            self.reached[iso] = 1
            self.ecc[iso] = 0
        self._col_cache: dict = {}

    @property
    def num_levels(self) -> int:
        """Max weighted distance over the batch (the BFS result's field
        name, so generic consumers read one protocol)."""
        return int(self.ecc.max()) if len(self.ecc) else 0

    def extras(self, i: int) -> dict:
        return {"weighted": True, "sssp_rounds": int(self.rounds)}

    def distances_int32(self, i: int) -> np.ndarray:
        if not (0 <= i < len(self.sources)):
            raise IndexError(i)
        eng = self._engine
        if self._iso is not None and self._iso[i]:
            d = np.full(eng.num_vertices, INF_DIST, np.int32)
            d[self.sources[i]] = 0
            return d
        if i not in self._col_cache:
            col = self._dist[: eng._act, i].cpu().numpy()
            full = np.full(eng.num_vertices, INF_DIST, np.int32)
            m = eng._rank < eng._act
            vals = col[eng._rank[m]]
            full[m] = np.where(vals >= INF_W, INF_DIST, vals)
            self._col_cache[i] = full
        return self._col_cache[i]


class SsspEngine:
    """Delta-stepping SSSP over the weighted bucketed ELL.

    ``lanes`` concurrent sources a batch (each an int32 column); ``delta``
    is the bucket width (0: the mean edge weight, rounded); ``max_rounds``
    bounds the loop (a round is one light sweep, or a light sweep and a
    heavy close; exceeding it raises rather than mislabels). ``device`` is
    CUDA unless named. ``overlay=(rows, kcap)`` arms the dynamic-graph
    delta overlay (``graph/dynamic.py``): the light sweep folds the
    overlay's light plane ``ov_wl`` and the heavy close its full plane
    ``ov_w`` after K1, as the base tables split ``wl``/``w``. ``ell`` is
    ``build_ell`` of ``graph`` and ``weights`` its
    ``build_ell_weights`` (another engine's ``ell`` and ``ell_weights``),
    to build several engines over one graph without repeating the host
    builds."""

    kind = "sssp"

    def __init__(self, graph: Graph, *, lanes: int = 32, kcap: int = 64,
                 delta: int = 0, max_rounds: int = 4096, overlay: tuple = (),
                 device=None, ell=None, weights=None):
        self.overlay = tuple(int(x) for x in overlay) if overlay else ()
        if graph.weights is None:
            raise ValueError(
                "sssp needs a weighted graph (generate with weights=W or "
                "attach a weights plane)"
            )
        if lanes < 1:
            raise ValueError(f"lanes must be >= 1, got {lanes}")
        _check_kernel_ident()
        self.device = resolve_device(device)
        self.host_graph = graph
        if ell is None:
            ell = build_ell(graph, kcap=kcap)
        elif ell.kcap != kcap:
            raise ValueError(f"ell was built with kcap={ell.kcap}, the engine asks {kcap}")
        self.ell = ell
        #: The host weight slabs of ``ell`` (``build_ell_weights``).
        self.ell_weights = build_ell_weights(graph, ell) if weights is None else weights
        self.lanes = int(lanes)
        self.num_vertices = graph.num_vertices
        self.undirected = graph.undirected
        self.max_rounds = int(max_rounds)
        self._act = self.ell.num_active
        self._rank = self.ell.rank
        self._table_rows = self._act + 1  # + the all-INF sentinel row
        if delta <= 0:
            delta = max(1, int(round(float(graph.weights.mean())))) \
                if len(graph.weights) else 1
        self.delta = int(delta)
        self.arrs = self._build_arrays()
        if self.overlay:
            # Arm the fold with all-pad tables; a mutation swaps values.
            self.set_overlay(empty_overlay_tables(self.overlay, self._act, weighted=True))
        spec = expand_spec(self.ell)
        self._expand_light = make_expand(spec, self.lanes, op="minplus", wsuf="wl")
        self._expand_full = make_expand(spec, self.lanes, op="minplus", wsuf="w")
        if self.overlay:
            # The light sweep reads the delta-thresholded ov_wl plane, the
            # heavy close the full ov_w plane, as the base tables' wl/w.
            self._expand_light = make_overlay_fold(
                self._expand_light, op="minplus", weights_key="ov_wl")
            self._expand_full = make_overlay_fold(
                self._expand_full, op="minplus", weights_key="ov_w")
        self.last_host_reads = None
        self.last_closes = None
        self._warmed = False

    def _build_arrays(self) -> dict:
        """The ELL's kernel tables (pad slots gather the all-INF sentinel
        row ``act``) and, per bucket, the weight planes padded slot for
        slot with them: ``{bucket}_w_gt`` (every edge, the heavy close) and
        ``{bucket}_wl_gt`` (light edges only; heavy slots hold INF_W, so
        their candidates absorb under min). Pad weight 0: INF + 0 is the
        min identity."""
        arrs = expand_arrays(self.ell, self._act, self.device)
        vw, lw = self.ell_weights
        planes = ([("virtual", vw)] if vw is not None else []) + [
            (f"light{i}", w) for i, w in enumerate(lw)]
        for name, w in planes:
            wt = pad_gate_blocks(w.T, 0)  # pad weight 0 stays 0 in wl (0 <= delta)
            wl = np.where(wt <= self.delta, wt, INF_W).astype(np.int32)
            for suf, plane in (("w", wt), ("wl", wl)):
                arrs[f"{name}_{suf}_gt"] = torch.from_numpy(plane).to(self.device)
        return arrs

    def set_overlay(self, tables) -> None:
        """Swap the delta-overlay tables. The light plane ``ov_wl`` is
        derived here from ``ov_w`` and this engine's ``delta`` (pad slots,
        weight 0, pass the threshold and gather the all-INF sentinel row).
        One atomic dict rebind; shapes must match the armed capacity."""
        if not self.overlay:
            raise ValueError(
                "engine built without an overlay — pass overlay=(rows, "
                "kcap) at construction to serve a dynamic graph"
            )
        new = device_overlay_tables(tables, self.overlay, self.device, weighted=True)
        w = new["ov_w"]
        new["ov_wl"] = torch.where(w <= self.delta, w, int(INF_W))
        self.arrs = {**self.arrs, **new}

    def _iso_of(self, sources: np.ndarray):
        return self._rank[sources] >= self._act

    def _seed(self, rows: np.ndarray, keep: np.ndarray) -> torch.Tensor:
        """[rows, L] INF_W with 0 at (row of source i, lane i). Isolated
        sources (no table row) put INF at row 0, a no-op under min; their
        lanes are patched on the host (SsspBatchResult)."""
        L = self.lanes
        dist0 = torch.full((self._table_rows, L), int(INF_W), dtype=torch.int32,
                           device=self.device)
        flat = np.where(keep, rows, 0) * L + np.arange(len(rows))
        vals = np.where(keep, 0, INF_W).astype(np.int32)
        dist0.view(-1).scatter_reduce_(
            0, torch.from_numpy(flat.astype(np.int64)).to(self.device),
            torch.from_numpy(vals).to(self.device), "amin")
        return dist0

    def _core(self, dist: torch.Tensor, max_rounds: int):
        """The delta-stepping loop over ``dist`` (consumed). Returns
        ``(dist, rounds, alive)``; records the host reads and the closes."""
        inf = int(INF_W)
        delta = self.delta
        hi, rounds, alive, reads, closes = delta, 0, True, 0, 0
        while alive and rounds < max_rounds:
            # The current bucket and the settled rows relax out; later
            # buckets are masked to INF (the delta-stepping invariant).
            new = self._light_round(self.arrs, dist, hi)
            changed_l = bool((new < dist).any())  # the round's first read
            reads += 1
            if not changed_l:
                # The bucket is stable: one relaxation over ALL edges (the
                # heavy close), then the bound advances.
                new2 = self._close_round(self.arrs, new, hi)
                hi += delta
                # Finite distances at or above the bound still need
                # bucketing; with none and no change, the loop is done.
                alive = bool(torch.stack([
                    (new2 < new).any(), ((new2 < inf) & (new2 >= hi)).any(),
                ]).any())  # the close round's second read
                reads += 1
                closes += 1
                new = new2
            dist = new
            rounds += 1
        self.last_host_reads, self.last_closes = reads, closes
        return dist, rounds, alive

    def _light_round(self, arrs, dist: torch.Tensor, hi):
        """One light round: the rows below the bound ``hi`` (an int or a
        0-d int32 tensor) relax over the light edges."""
        masked = dist.masked_fill(dist >= hi, int(INF_W))
        return torch.minimum(dist, self._expand_light(arrs, masked))

    def _close_round(self, arrs, dist: torch.Tensor, hi):
        """The heavy close: the rows below ``hi`` relax over every edge."""
        masked = dist.masked_fill(dist >= hi, int(INF_W))
        return torch.minimum(dist, self._expand_full(arrs, masked))

    def analysis_programs(self):
        """The rank-free programs of a batch for ``analysis/`` (JAX's
        ``analysis_programs``): the light round and the heavy close over
        a [rows, lanes] table, ``(name, fn, example args)``."""
        from tpu_bfs_torch.utils.aot import ArgSpec

        table = ArgSpec((self._table_rows, self.lanes), torch.int32, self.device)
        hi = ArgSpec((), torch.int32, self.device)
        return [("sssp_light", self._light_round, (self.arrs, table, hi)),
                ("sssp_close", self._close_round, (self.arrs, table, hi))]

    def _summaries(self, dist: torch.Tensor):
        """Per-lane reached count and weighted eccentricity, [L] each."""
        act = self._act
        if act == 0:
            z = np.zeros(self.lanes, np.int64)
            return z, z
        d = dist[:act]
        fin = d < int(INF_W)
        reached = fin.sum(dim=0)
        ecc = torch.where(fin, d, 0).amax(dim=0)
        return reached.cpu().numpy(), ecc.cpu().numpy()

    def dispatch(self, sources, **_ignored) -> SsspDispatch:
        if _faults.ACTIVE is not None:
            # The fault site "sssp_dispatch", the packed engines' "dispatch"
            # twin (DistSsspEngine inherits it).
            _faults.ACTIVE.hit("sssp_dispatch", lanes=self.lanes)
        sources = np.asarray(sources, dtype=np.int64)
        if sources.ndim != 1 or not (1 <= len(sources) <= self.lanes):
            raise ValueError(f"need 1..{self.lanes} sources, got {sources.shape}")
        if sources.min() < 0 or sources.max() >= self.num_vertices:
            raise ValueError("source out of range")
        rows = self._rank[sources].astype(np.int64)
        dist0 = self._seed(rows, rows < self._act)
        t0 = time.perf_counter()
        dist, rounds, alive = self._core(dist0, self.max_rounds)
        return SsspDispatch(sources, dist, rounds, alive, t0)

    def fetch(self, pend: SsspDispatch, *, check_cap: bool = True,
              time_it: bool = False) -> SsspBatchResult:
        if _faults.ACTIVE is not None:
            _faults.ACTIVE.hit("sssp_fetch", lanes=self.lanes)
        if time_it and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = (time.perf_counter() - pend.t0) if time_it else None
        self._warmed = True
        if check_cap and pend.alive:
            raise RuntimeError(
                f"sssp still relaxing after {pend.rounds} rounds "
                f"(max_rounds={self.max_rounds}) - raise max_rounds or "
                f"delta for this graph"
            )
        reached, ecc = self._summaries(pend.dist)
        iso = self._iso_of(pend.sources)
        return SsspBatchResult(
            self, pend.sources, pend.dist, pend.rounds, reached, ecc,
            iso if iso.any() else None, elapsed_s=elapsed,
        )

    def run(self, sources, *, time_it: bool = False, check_cap: bool = True,
            **_ignored) -> SsspBatchResult:
        if time_it and not self._warmed:
            self.dispatch(sources)
        return self.fetch(self.dispatch(sources), check_cap=check_cap, time_it=time_it)
