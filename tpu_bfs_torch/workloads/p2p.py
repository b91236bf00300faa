"""Point-to-point shortest path with bidirectional early exit, the port of
``tpu_bfs/workloads/p2p.py``.

A query (s, t) rides two adjacent lanes of one wide batch: lane 2i floods
from s, lane 2i+1 from t (on an undirected graph the reverse search is the
same expansion). The loop steps the base engine's resumable core
(``_core_from``) one level at a time and stops once every pair's two
visited sets meet. If D = d(s, t), they meet after ceil(D / 2) levels and
the answer is exact then: every meet vertex v has d_s(v) + d_t(v) >= D,
and a midpoint of a shortest path reaches equality. So the loop expands
about half the levels of a full BFS, and ``levels`` reports the levels
expanded.

The meet check a level is a small device reduction over the visited words;
the per-pair distance and meet vertex come from one pass over the counter
planes. The path is walked through the two lanes' deterministic min-parent
trees from the device parent scan (``parent_scan.py``, K1 ``min``): one
scan pass, and one copy to the host, per pass of 128 lanes, walked in the
scanner's row space, not decoded into whole trees.

Over a mesh base (``DistWideMsBfsEngine``) each rank steps its own rows:
the meet check is all-reduced (MAX) and the per-pair minimum taken over
the ranks, the first chip-major row breaking ties as on one device; every
rank then walks the same paths through the same scan passes.
"""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np
import torch

from tpu_bfs_torch.algorithms._packed_common import (
    _assemble_packed_result,
    acquire_parent_scanner,
    parent_scanner_of,
)
from tpu_bfs_torch.workloads import ExchangeRecordDelegate, id_of_row_map

#: "No meet" distance: far above any labelable distance (the plane cap is
#: 254) and safe to double without overflow.
_BIG = np.int32(1 << 20)

_EVEN_BITS = 0x55555555  # bit 2j of a word: pair j's source lane


def _or_rows(x: torch.Tensor) -> torch.Tensor:
    """[n, w] int32 -> [w]: the bitwise OR of all rows (a halving tree)."""
    if x.shape[0] == 0:
        return torch.zeros(x.shape[1], dtype=x.dtype, device=x.device)
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        y = x[:h] | x[h: 2 * h]
        if x.shape[0] % 2:
            y[0] |= x[-1]
        x = y
    return x[0]


def _make_pair_kernels(rows: int, act: int, w: int, num_planes: int):
    """``(pair_met, pair_dist)`` over the wide engine's word-major tables
    ([rows, w] int32, the first ``act`` rows real).

    ``pair_met(vis) -> [w*16] bool``: pair p (lanes 2p, 2p+1) has a row both
    lanes visited. ``pair_dist(planes, vis, src_bits) -> (dist [w*16] int32,
    row [w*16] int64)``: the minimum over rows of d_s(row) + d_t(row)
    (_BIG-based where a lane has not visited the row) and the first row
    reaching it, the meet vertex."""
    npairs = w * 16
    pair_shifts = None
    shifts = None

    def pair_met(vis):
        nonlocal pair_shifts
        if act == 0:
            return torch.zeros(npairs, dtype=torch.bool, device=vis.device)
        if pair_shifts is None:
            pair_shifts = 2 * torch.arange(16, dtype=torch.int32, device=vis.device)
        v = vis[:act]
        # Bit 2j: both lanes 2j and 2j+1 visited the row. >> is arithmetic
        # on int32: bit 31 lands in bit 30, the mask drops the sign copies.
        both = _or_rows(v & (v >> 1) & _EVEN_BITS)
        return (((both[:, None] >> pair_shifts) & 1) != 0).reshape(-1)

    def pair_dist(planes, vis, src_bits):
        nonlocal shifts
        dev = vis.device
        dmin = torch.full((npairs,), 2 * int(_BIG), dtype=torch.int32, device=dev)
        rmin = torch.zeros(npairs, dtype=torch.int64, device=dev)
        if act == 0:
            return dmin, rmin
        if shifts is None:
            shifts = torch.arange(32, dtype=torch.int32, device=dev)
        for wi in range(w):
            cnt = torch.zeros((act, 32), dtype=torch.int32, device=dev)
            for i, p in enumerate(planes):
                cnt += ((p[:act, wi, None] >> shifts) & 1) << i
            visw = ((vis[:act, wi, None] >> shifts) & 1) != 0
            srcw = ((src_bits[:act, wi, None] >> shifts) & 1) != 0
            d = torch.where(srcw, 0, torch.where(visw, cnt + 1, int(_BIG)))
            s = d[:, 0::2] + d[:, 1::2]  # [act, 16]
            srow = s.argmin(dim=0)  # the first row of the minimum
            dmin[wi * 16: (wi + 1) * 16] = s.gather(0, srow[None, :])[0]
            rmin[wi * 16: (wi + 1) * 16] = srow
        return dmin, rmin

    return pair_met, pair_dist


class P2pPending:
    """A dispatched (seeded, not yet stepped) bidirectional batch."""

    __slots__ = ("sources", "targets", "inter", "fw0", "n")

    def __init__(self, sources, targets, inter, fw0):
        self.sources = sources
        self.targets = targets
        self.inter = inter
        self.fw0 = fw0
        self.n = len(sources)


class P2pResult:
    """Per-pair outcomes with the paths. ``ecc`` carries the LEVELS
    EXPANDED (the same for every pair of the batch)."""

    def __init__(self, *, reached, levels_expanded, extras_list):
        n = len(extras_list)
        self.reached = np.asarray(reached, dtype=np.int64)
        self.ecc = np.full(n, int(levels_expanded), np.int32)
        self.edges_traversed = None
        self._extras = extras_list

    def extras(self, i: int) -> dict | None:
        return self._extras[i] if i < len(self._extras) else None

    def distances_int32(self, i: int):
        raise ValueError("p2p answers carry the path, not a distance table")


class _ScanTree:
    """One lane's parent array as a pass of the parent scan holds it: ``[v]``
    is v's parent (original ids), read through the scanner's row map."""

    def __init__(self, pc: np.ndarray, col: int, rank: np.ndarray, act: int):
        self._pc, self._col, self._rank, self._act = pc, col, rank, act

    def __len__(self) -> int:
        return len(self._rank)

    def __getitem__(self, v: int) -> int:
        r = int(self._rank[v])
        return int(self._pc[r, self._col]) if r < self._act else -1


class P2pServeEngine(ExchangeRecordDelegate):
    """kind="p2p" over a base WIDE packed engine. ``lanes`` counts PAIRS,
    half the base's lanes; ``ladder_lanes`` is the base width.
    ``last_host_reads`` counts the last batch's device-to-host reads in
    the level loop and the meet checks; ``last_paths_s`` is its seconds in
    the path walks (the parent scan passes, their copies and the walks)."""

    kind = "p2p"

    def __init__(self, base):
        if getattr(base, "pull_gate", False):
            raise ValueError(
                "p2p drives the resumable core level by level; the pull "
                "gate's batch-scoped lane mask does not compose with "
                "that (build the base engine ungated)"
            )
        if not base.undirected:
            raise ValueError(
                "p2p's bidirectional meet is exact on undirected graphs "
                "only (the target-side flood must equal the reverse "
                "search); serve directed graphs without the p2p kind"
            )
        self.base = base
        self.pairs = base.lanes // 2
        if self.pairs < 1:
            raise ValueError("p2p needs a base engine of >= 2 lanes (one pair)")
        self.lanes = self.pairs
        self.ladder_lanes = base.lanes
        self.num_vertices = base.num_vertices
        self._id_of_row = id_of_row_map(base)
        # A mesh base keeps its own [rows_loc, w] rows of chip-major tables.
        self._mesh = getattr(base, "mesh", None)
        self._view = getattr(base, "_src_bits_view", None)
        if self._mesh is not None:
            rows = act = base._rows_loc
        else:
            rows, act = int(getattr(base, "_table_rows", base._act + 1)), base._act
        self._pair_met, self._pair_dist = _make_pair_kernels(rows, act, base.w, base.num_planes)
        self.last_host_reads = None
        self.last_paths_s = None

    def analysis_programs(self):
        """The meet check and the per-pair reduction for ``analysis/``
        (JAX's ``p2p_pair_met``, ``p2p_pair_dist``)."""
        from tpu_bfs_torch.utils.aot import ArgSpec

        base = self.base
        rows = base._rows_loc if self._mesh is not None else int(
            getattr(base, "_table_rows", base._act + 1))
        table = ArgSpec((rows, base.w), torch.int32, base.device)
        return [("p2p_pair_met", self._pair_met, (table,)),
                ("p2p_pair_dist", self._pair_dist, ((table,) * base.num_planes, table, table))]

    def warm_residency(self) -> None:
        """The serve registry's warm-up hook: build and cache the base
        engine's parent scanner now, so the first path walk of a served
        batch does not pay for it (``parent_scanner_of`` caches the
        scanner, or its unavailability, on the engine)."""
        parent_scanner_of(self.base)

    def dispatch(self, sources, *, targets=None, **_ignored) -> P2pPending:
        sources = np.asarray(sources, dtype=np.int64)
        if targets is None:
            # Warm-up default: a fixed non-trivial target per lane.
            targets = (sources + 1) % self.num_vertices
        targets = np.asarray(targets, dtype=np.int64)
        if sources.shape != targets.shape or sources.ndim != 1:
            raise ValueError("sources/targets must be equal-length 1-D")
        if not (1 <= len(sources) <= self.pairs):
            raise ValueError(f"need 1..{self.pairs} pairs, got {len(sources)}")
        for arr, what in ((sources, "source"), (targets, "target")):
            if len(arr) and (arr.min() < 0 or arr.max() >= self.num_vertices):
                raise ValueError(f"{what} out of range")
        inter = np.empty(2 * len(sources), dtype=np.int64)
        inter[0::2] = sources
        inter[1::2] = targets
        return P2pPending(sources, targets, inter, self.base._seed_dev(inter))

    def _met(self, vis: torch.Tensor) -> torch.Tensor:
        """[w*16] bool: pair p has met (on some rank's rows of a mesh)."""
        met = self._pair_met(vis)
        if self._mesh is None:
            return met
        return self._mesh.all_reduce_(met.to(torch.int32), "max") != 0

    def _dist_rows(self, planes, vis, src_bits):
        """The per-pair meet distance and chip-major meet row: on a mesh the
        minimum over the ranks' own, the lowest rank (the first chip-major
        row) on ties."""
        dist, row = self._pair_dist(planes, vis, src_bits)
        if self._mesh is None:
            return dist, row
        dists = self._mesh.all_gather_rows(dist[None])  # [P, npairs]
        rows = self._mesh.all_gather_rows(row[None])
        r = dists.argmin(dim=0)  # the first minimum
        return (dists.gather(0, r[None])[0],
                r * self.base._rows_loc + rows.gather(0, r[None])[0])

    def fetch(self, pend: P2pPending, **_ignored) -> P2pResult:
        base = self.base
        n = pend.n
        fw = pend.fw0
        # The core updates vis and the planes in place; the seed table
        # stays as the batch's source bits (a mesh base's own rows of it).
        src_bits = pend.fw0 if self._view is None else self._view(pend.fw0)
        vis = src_bits.clone()
        planes = tuple(torch.zeros_like(vis) for _ in range(base.num_planes))
        level, alive = 0, True
        # Level 0 meets only where s == t.
        met = self._met(vis)[:n].cpu().numpy()
        reads = 1
        while not met.all() and alive and level < base.max_levels_cap:
            fw, vis, planes, level, alive = base._core_from(
                base.arrs, fw, vis, planes, level, level + 1)
            met = self._met(vis)[:n].cpu().numpy()
            reads += 2  # the level's alive flag and its meet check
        self.last_host_reads = reads
        dist, row = self._dist_rows(planes, vis, src_bits)
        dist = dist[:n].cpu().numpy()
        row = row[:n].cpu().numpy()
        iso = base._iso_of(pend.inter)
        res = _assemble_packed_result(
            base, pend.inter, planes, vis, pend.fw0, level, alive, None,
        )
        extras = []
        walks = []
        reached = np.empty(n, np.int64)
        for i in range(n):
            s, t = int(pend.sources[i]), int(pend.targets[i])
            reached[i] = int(res.reached[2 * i]) + int(res.reached[2 * i + 1])
            if iso[2 * i] or iso[2 * i + 1]:
                # An isolated endpoint reaches nothing beyond itself.
                found = s == t
                extras.append({
                    "target": t, "met": found,
                    "distance": 0 if found else None,
                    "path": [s] if found else None,
                })
                continue
            if s == t:
                extras.append({"target": t, "met": True, "distance": 0, "path": [s]})
                continue
            if dist[i] >= _BIG:
                extras.append({"target": t, "met": False, "distance": None, "path": None})
                continue
            extras.append({"target": t, "met": True, "distance": int(dist[i]), "path": None})
            walks.append((i, s, t, int(self._id_of_row[row[i]])))
        t0 = time.perf_counter()
        for i, path in self._paths(res, walks).items():
            extras[i]["path"] = path
        self.last_paths_s = time.perf_counter() - t0
        return P2pResult(reached=reached, levels_expanded=level, extras_list=extras)

    def _paths(self, res, walks) -> dict:
        """{i: s -> meet -> t} for each ``(i, s, t, meet)`` of ``walks``,
        through the two lanes' min-parent trees. With the engine's scanner
        (always on the card): one scan pass per pass of lanes that holds a
        walked pair, copied to the host once and walked in place. On the
        CPU without one: the host scatter-min per lane."""
        if not walks:
            return {}
        scanner = acquire_parent_scanner(self.base, "device" if res._on_card() else "auto")
        if scanner is None:
            return {i: self._reconstruct(res, i, s, t, meet) for i, s, t, meet in walks}
        ell = scanner.ell
        perm = res._scan_row_map(scanner)
        lpp = scanner.lanes_per_pass
        by_pass = defaultdict(list)
        for walk in walks:
            by_pass[2 * walk[0] // lpp].append(walk)
        out = {}
        for p, group in sorted(by_pass.items()):
            lane0 = p * lpp
            nw = -(-min(lpp, len(res.sources) - lane0) // 32)
            pc = res._scan_pass(scanner, lane0 // 32, nw, perm).cpu().numpy()
            for i, s, t, meet in group:
                out[i] = _join(
                    _walk_to_root(_ScanTree(pc, 2 * i - lane0, ell.rank, ell.num_active),
                                  meet, s),
                    _walk_to_root(_ScanTree(pc, 2 * i + 1 - lane0, ell.rank, ell.num_active),
                                  meet, t))
        return out

    def _reconstruct(self, res, i: int, s: int, t: int, vmeet: int):
        """s -> meet -> t through the two lanes' whole parent arrays."""
        return _join(_walk_to_root(res.parents_int32(2 * i), vmeet, s),
                     _walk_to_root(res.parents_int32(2 * i + 1), vmeet, t))

    def run(self, sources, *, targets=None, time_it: bool = False,
            **_ignored) -> P2pResult:
        return self.fetch(self.dispatch(sources, targets=targets))


def _join(half_s, half_t):
    """The path s .. meet .. t from the walks meet -> s and meet -> t; None
    if either chain broke (a met pair always walks clean)."""
    if half_s is None or half_t is None:
        return None
    return list(reversed(half_s)) + half_t[1:]


def _walk_to_root(parent, frm: int, root: int):
    """Parent-pointer walk frm -> root; None if the chain breaks."""
    path = [frm]
    v = frm
    for _ in range(len(parent)):
        if v == root:
            return path
        v = int(parent[v])
        if v < 0:
            return None
        path.append(v)
    return None
