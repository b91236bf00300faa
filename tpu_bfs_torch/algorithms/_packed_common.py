"""Shared machinery of the wide and hybrid packed multi-source BFS engines,
the port of ``tpu_bfs/algorithms/_packed_common.py``'s engine-facing parts.

A batch of up to ``lanes`` sources runs as one traversal over [rows, w]
int32 tables, lane ``l`` at word ``l // 32``, bit ``l % 32`` (word-major).
Each level the engine's ``hit_of`` expands the frontier; the claim is
``next = hit & ~visited``; ``num_planes`` bit-sliced counter planes count
the levels each row stays unvisited. Reached counts and degree sums reduce
on the device; distances decode lazily, one 32-lane word at a time.

The JAX ``lax.while_loop`` becomes a host loop with exactly one
device-to-host sync per level (the ``alive`` flag).

Parent trees are derived after the loop (``PackedBatchResult.parents_*``):
the device parent scan of ``parent_scan.py`` over the engine's full ELL,
or, on the CPU or when asked for, one host scatter-min per lane.

Engines plug in through attributes ``arrs``, ``lanes``, ``w``,
``max_levels_cap``, ``num_planes``, ``undirected``, ``device``, ``_rank``,
``_act``, ``_warmed``, ``num_vertices``, ``host_graph`` and the callables
``_core``, ``_seed_dev``, ``_lane_stats``, ``_extract_word``, ``_lane_ecc``,
``_full_parent_ell``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from tpu_bfs_torch.graph.csr import INF_DIST
from tpu_bfs_torch.graph.ell import build_ell, pad_gate_blocks
from tpu_bfs_torch.ops.ell_expand import COMBINE, KERNEL_OPS, TILE, ell_expand
from tpu_bfs_torch.validate import min_parent_from_dist

UNREACHED = np.uint8(255)  # uint8 distance sentinel; see distances_int32()


def ripple_increment_(planes, carry_bits) -> None:
    """Bit-sliced ripple-carry: planes + 1 wherever carry_bits is set. The
    JAX ``ripple_increment`` (``msbfs_packed.py``) returns new planes; this
    one updates each plane tensor in place (one carry transient instead of a
    second set of planes)."""
    for p in planes:
        nxt = p & carry_bits
        p ^= carry_bits
        carry_bits = nxt


#: Default device-memory budget of the packed state: an 80 GB H100 less
#: 16 GB of headroom for the allocator's fragmentation and CUDA context.
HBM_BUDGET_BYTES = int(64e9)

#: Live [rows, w] int32 tables besides the planes: the seed table (kept for
#: extraction), frontier, visited, and up to five transients of one level
#: (bucket outputs, their concatenation or permutation, the dense pass, the
#: claim and the ripple carry).
LIVE_TABLES = 8


def resolve_device(device) -> torch.device:
    """The engine's device: CUDA unless the caller names another. With
    ``device=None`` and no CUDA device this raises; it never moves to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' explicitly to run "
                "the plain PyTorch versions of the kernels on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def floor_lanes(lanes: int) -> int:
    """Largest reachable lane count <= ``lanes``: a power-of-two word count x 32."""
    w = max(lanes // 32, 1)
    return 32 << (w.bit_length() - 1)


class PackedStateDoesntFitError(ValueError):
    """Even the 32-lane table cannot fit the device-memory budget."""


def auto_lanes(
    rows: int,
    num_planes: int,
    *,
    fixed_bytes: int = 0,
    hbm_budget_bytes: int = HBM_BUDGET_BYTES,
    max_lanes: int = 4096,
    on_unfit: str = "floor",
) -> int:
    """Largest power-of-two lane count whose packed state fits the budget.

    The state is ``num_planes + LIVE_TABLES`` [rows, w] int32 tables at their
    exact size (a CUDA allocation has no tile padding, unlike the TPU model
    ``tpu_padded_words`` of the JAX package) plus ``fixed_bytes`` of
    lane-independent residents. ``on_unfit='raise'`` raises
    :class:`PackedStateDoesntFitError` when even 32 lanes do not fit."""
    if on_unfit not in ("floor", "raise"):
        raise ValueError(f"on_unfit must be floor|raise, got {on_unfit!r}")

    def need(w):
        return (num_planes + LIVE_TABLES) * rows * w * 4 + fixed_bytes

    w = floor_lanes(max_lanes) // 32
    while w > 1 and need(w) > hbm_budget_bytes:
        w //= 2
    if on_unfit == "raise" and need(w) > hbm_budget_bytes:
        raise PackedStateDoesntFitError(
            f"packed state cannot fit: {rows} rows x {num_planes} planes needs "
            f"{need(w) / 1e9:.2f} GB at 32 lanes vs the {hbm_budget_bytes / 1e9:.2f} "
            f"GB budget ({fixed_bytes / 1e9:.2f} GB fixed residents)"
        )
    return 32 * w


def auto_planes(
    rows: int,
    *,
    fixed_bytes: int = 0,
    hbm_budget_bytes: int = HBM_BUDGET_BYTES,
    preferred: int = 5,
    min_planes: int = 4,
    max_lanes: int = 4096,
) -> int:
    """Largest plane count <= ``preferred`` (>= ``min_planes``) whose state
    still fits ``max_lanes`` lanes; ``preferred`` when none does."""
    for p in range(preferred, min_planes - 1, -1):
        if auto_lanes(rows, p, fixed_bytes=fixed_bytes,
                      hbm_budget_bytes=hbm_budget_bytes, max_lanes=max_lanes) == max_lanes:
            return p
    return preferred


class ExpandSpec(NamedTuple):
    """Shape metadata of a bucketed-ELL expansion (see graph/ell.py)."""

    kcap: int
    heavy: bool
    num_virtual: int
    fold_steps: int
    light_meta: tuple  # ((k, n), ...)
    tail_rows: int  # identity rows appended after the buckets


def pallas_expand_arrays(ell_like, sentinel: int) -> dict:
    """Host int32 tables the kernel takes: each bucket's transposed index
    table padded to whole 128-row blocks with ``sentinel`` (which must name
    the engine's identity frontier row) - ``virtual_gt`` and ``light{i}_gt``,
    the same arrays as the JAX package's ``pallas_expand_arrays``."""
    arrs = {}
    if ell_like.virtual is not None:
        arrs["virtual_gt"] = pad_gate_blocks(
            np.ascontiguousarray(ell_like.virtual.idx.T), sentinel
        )
    for i, b in enumerate(ell_like.light):
        arrs[f"light{i}_gt"] = pad_gate_blocks(np.ascontiguousarray(b.idx.T), sentinel)
    return arrs


def expand_arrays(ell_like, sentinel: int, device) -> dict:
    """Device tensors of one expansion: the kernel tables
    (:func:`pallas_expand_arrays`), an all-ones gate per table
    (``{name}_need``), and the heavy fold map and pick (int64)."""
    arrs = {}
    for name, tbl in pallas_expand_arrays(ell_like, sentinel).items():
        arrs[name] = torch.from_numpy(tbl).to(device)
        arrs[name.removesuffix("_gt") + "_need"] = torch.ones(
            tbl.shape[1] // TILE, dtype=torch.int32, device=device
        )
    if ell_like.virtual is not None:
        arrs["fold_pad_map"] = torch.from_numpy(ell_like.fold_pad_map.astype(np.int64)).to(device)
        arrs["heavy_pick"] = torch.from_numpy(ell_like.heavy_pick.astype(np.int64)).to(device)
    return arrs


def arrs_nbytes(host_tables: dict) -> int:
    return sum(int(np.asarray(t).nbytes) for t in host_tables.values())


def make_expand(spec: ExpandSpec, w: int, *, op: str = "or"):
    """The bucketed-ELL expansion: one ``ell_expand`` launch per bucket
    (the JAX ``make_pallas_expand`` form), the heavy rows' fold pyramid and
    ``heavy_pick`` in plain torch. Returns ``expand(arrs, fw)``: the bucket
    outputs (heavy, light..., ``tail_rows`` identity rows), a fresh tensor."""
    combine = COMBINE[op]
    ident = KERNEL_OPS[op][0]

    def _full(n, fw):
        return torch.full((n, w), ident, dtype=torch.int32, device=fw.device)

    def _bucket(arrs, fw, name, n):
        return ell_expand(arrs[f"{name}_need"], arrs[f"{name}_gt"], fw, op=op)[:n]

    def expand(arrs, fw):
        parts = []
        if spec.heavy:
            acc = _bucket(arrs, fw, "virtual", spec.num_virtual)
            vr_ext = torch.cat([acc, _full(1, fw)])
            cur = vr_ext.index_select(0, arrs["fold_pad_map"])
            pyramid = [cur]
            for _ in range(spec.fold_steps):
                pairs = cur.view(-1, 2, w)
                cur = combine(pairs[:, 0], pairs[:, 1])
                pyramid.append(cur)
            pyr = torch.cat(pyramid) if len(pyramid) > 1 else pyramid[0]
            parts.append(pyr.index_select(0, arrs["heavy_pick"]))
        for i, (_k, n) in enumerate(spec.light_meta):
            parts.append(_bucket(arrs, fw, f"light{i}", n))
        if spec.tail_rows:
            parts.append(_full(spec.tail_rows, fw))
        return torch.cat(parts) if len(parts) > 1 else parts[0].clone()

    return expand


def make_packed_loop(hit_of, num_planes: int):
    """The level loop of the wide and hybrid engines. ``hit_of(arrs, fw)``
    returns a fresh [rows, w] hit table, which the loop overwrites in place.
    Returns ``(core, core_from)``:

    - ``core(arrs, fw0, max_levels) -> (planes, vis, levels, alive,
      truncated)``: a fresh traversal (visited starts as the seed table,
      which is left untouched for extraction; planes start at zero);
    - ``core_from(arrs, fw, vis, planes, level0, max_levels) -> (fw, vis,
      planes, level, alive)``: resume from mid-traversal state; updates
      ``vis`` and ``planes`` in place.
    """

    def core_from(arrs, fw, vis, planes, level0, max_levels):
        level, alive = int(level0), True
        while alive and level < max_levels:
            nxt = hit_of(arrs, fw)
            nxt &= ~vis
            vis |= nxt
            # Pad/sentinel rows count up harmlessly (never visited, never
            # decoded).
            ripple_increment_(planes, ~vis)
            alive = bool(nxt.any())  # the level's one device-to-host sync
            fw = nxt
            level += 1
        return fw, vis, planes, level, alive

    def core(arrs, fw0, max_levels):
        planes = tuple(torch.zeros_like(fw0) for _ in range(num_planes))
        fw, vis, planes, levels, alive = core_from(
            arrs, fw0, fw0.clone(), planes, 0, max_levels
        )
        # At the cap with the last level still claiming, the traversal is
        # incomplete only if one more level would claim: one claim-free
        # expansion decides it, so an eccentricity exactly at the cap does
        # not report a false truncation.
        truncated = bool(
            alive and levels >= max_levels
            and (hit_of(arrs, fw) & ~vis).any()
        )
        return planes, vis, levels, alive, truncated

    return core, core_from


def seed_scatter_args(rows_of_sources: np.ndarray, act: int):
    """Host (rows, words, bits) of word-major lane seeding; entries without a
    row (>= ``act``: isolated sources) get a zero bit at row 0, and the
    result assembly patches their lanes on the host."""
    ranks = np.asarray(rows_of_sources).astype(np.int64)
    lanes = np.arange(len(ranks), dtype=np.int64)
    keep = ranks < act
    bits = np.where(keep, np.left_shift(1, lanes % 32), 0).astype(np.uint32)
    return np.where(keep, ranks, 0), lanes // 32, bits.view(np.int32)


def make_state_kernels(v: int, rows: int, w: int, num_planes: int, *,
                       active: int | None = None,
                       in_deg_host: np.ndarray | None = None,
                       device=None):
    """``(seed, lane_stats, extract_word, lane_ecc)`` over a [rows, w] table
    whose first ``act`` rows are real vertices in rank order.

    ``lane_stats`` sums degrees in int64 directly (the JAX package sums int32
    row blocks because the TPU has no int64); the totals are equal."""
    act = v if active is None else min(active, v)
    in_deg = (
        None if in_deg_host is None
        else torch.from_numpy(np.asarray(in_deg_host[:act], dtype=np.int64)).to(device)
    )
    shifts = torch.arange(32, dtype=torch.int32, device=device)
    # Row chunk of the [chunk, w, 32] bit-unpacked transients: <= 2**24 entries.
    chunk = max(1, (1 << 24) // (w * 32))

    def bits_of(table, s, e):
        return (table[s:e, :, None] >> shifts) & 1  # [e-s, w, 32]

    def seed(rws, words, bits):
        fw0 = torch.zeros((rows, w), dtype=torch.int32, device=device)
        # Distinct lanes own distinct (word, bit) pairs, so the scatter-add is
        # an OR; lane bit 31 is negative in int32 and still adds its bit.
        fw0.index_put_((rws, words), bits, accumulate=True)
        return fw0

    def lane_stats(vis):
        """Per-lane reached count and degree sum, [w, 32] int64 each."""
        if in_deg is None:
            raise ValueError("make_state_kernels needs in_deg_host for lane_stats")
        reached = torch.zeros((w, 32), dtype=torch.int64, device=device)
        deg = torch.zeros((w, 32), dtype=torch.int64, device=device)
        for s in range(0, act, chunk):
            e = min(s + chunk, act)
            bits = bits_of(vis, s, e)
            reached += bits.sum(0)
            deg += (bits * in_deg[s:e, None, None]).sum(0)
        return reached, deg

    def decode(planes, s, e, dtype):
        cnt = torch.zeros((e - s, w, 32), dtype=dtype, device=device)
        for i, p in enumerate(planes):
            cnt += bits_of(p, s, e).to(dtype) << i
        return cnt

    def extract_word(planes, vis, src_bits, wi):
        """Distances of word-column ``wi``'s 32 lanes as [act, 32] uint8."""
        cnt = torch.zeros((act, 32), dtype=torch.uint8, device=device)
        for i, p in enumerate(planes):
            cnt += ((p[:act, wi, None] >> shifts) & 1).to(torch.uint8) << i
        visw = ((vis[:act, wi, None] >> shifts) & 1) != 0
        srcw = ((src_bits[:act, wi, None] >> shifts) & 1) != 0
        unreached = torch.full_like(cnt, int(UNREACHED))
        return torch.where(srcw, torch.zeros_like(cnt), torch.where(visw, cnt + 1, unreached))

    def lane_ecc(planes, vis, src_bits):
        """Per-lane eccentricity (max finite distance) as [w, 32] int32."""
        out = torch.zeros((w, 32), dtype=torch.int32, device=device)
        for s in range(0, act, chunk):
            e = min(s + chunk, act)
            dist = decode(planes, s, e, torch.int32) + 1
            dist = torch.where(bits_of(vis, s, e) != 0, dist, 0)
            dist = torch.where(bits_of(src_bits, s, e) != 0, 0, dist)
            out = torch.maximum(out, dist.amax(0))
        return out

    return seed, lane_stats, extract_word, lane_ecc


@dataclasses.dataclass
class PackedBatchResult:
    """Batch result with lazy per-word distance extraction: distances stay
    bit-sliced on the device, and ``distances_int32(i)`` decodes (and caches)
    only the 32-lane word holding lane i. Parent trees come from the device
    parent scan (``parent_scan.py``) or the host scatter-min."""

    sources: np.ndarray  # [S] int32
    num_levels: int  # max distance over all lanes
    reached: np.ndarray  # [S] int64
    edges_traversed: np.ndarray  # [S] int64, exact
    elapsed_s: float | None
    _engine: object
    _planes: tuple
    _vis: torch.Tensor
    _src_bits: torch.Tensor
    # Lanes whose source is isolated (no table row); None when there are none.
    _iso: np.ndarray | None = None
    _ecc_cache: np.ndarray | None = None
    _word_cache: dict = dataclasses.field(default_factory=dict)
    _parent_cache: dict = dataclasses.field(default_factory=dict)
    # Decoded parent columns of ONE word (32 lanes), see _parent_lane_scan.
    _pword_cache: dict = dataclasses.field(default_factory=dict)
    # The card's single-lane scanner, see _lane_scanner.
    _scanner: object = None

    @property
    def teps(self) -> float | None:
        """Harmonic-mean per-source TEPS under the batch time share."""
        if not self.elapsed_s:
            return None
        per_source_time = self.elapsed_s / len(self.sources)
        t = self.edges_traversed / per_source_time
        return float(len(t) / np.sum(1.0 / np.maximum(t, 1e-9)))

    @property
    def ecc(self) -> np.ndarray:
        """[S] int32 per-lane eccentricity, reduced on the device and cached."""
        if self._ecc_cache is None:
            eng = self._engine
            e = eng._lane_ecc(self._planes, self._vis, self._src_bits)
            e = e.cpu().numpy().reshape(-1)[: len(self.sources)].astype(np.int32)
            if self._iso is not None:
                e[self._iso] = 0  # an isolated source's component is itself
            self._ecc_cache = e
        return self._ecc_cache

    def distance_u8_lane(self, i: int) -> np.ndarray:
        """[V] uint8 distances of batch entry i (UNREACHED where unreached)."""
        if not (0 <= i < len(self.sources)):
            raise IndexError(i)
        eng = self._engine
        if self._iso is not None and self._iso[i]:
            d = np.full(eng.num_vertices, UNREACHED, np.uint8)
            d[self.sources[i]] = 0
            return d
        wi, col = divmod(i, 32)
        if wi not in self._word_cache:
            dr = eng._extract_word(self._planes, self._vis, self._src_bits, wi).cpu().numpy()
            # A vertex has a row iff rank < act; isolated ones stay UNREACHED.
            full = np.full((eng.num_vertices, 32), UNREACHED, np.uint8)
            m = eng._rank < eng._act
            full[m] = dr[eng._rank[m]]
            self._word_cache[wi] = full
        return self._word_cache[wi][:, col]

    def distances_int32(self, i: int) -> np.ndarray:
        d8 = self.distance_u8_lane(i)
        return np.where(d8 == UNREACHED, INF_DIST, d8.astype(np.int32))

    def parents_int32(self, i: int) -> np.ndarray:
        """BFS tree of batch entry i: [V] int32 parents (the source maps to
        itself, unreached vertices to NO_PARENT), the deterministic
        min-parent tree of ``validate.min_parent_from_dist``. Lazy and
        cached per lane, so querying a few lanes never pays for the batch."""
        if not (0 <= i < len(self.sources)):
            raise IndexError(i)
        if i not in self._parent_cache:
            self._parent_cache[i] = self._parent_lane(i)
        return self._parent_cache[i]

    def _on_card(self) -> bool:
        """Whether the engine's tensors are on a CUDA device: there every
        tree comes from the device scan, and no path moves to the host."""
        return self._engine.device.type == "cuda"

    def _parent_lane(self, i: int) -> np.ndarray:
        """One lane's tree. On the card, always the device scan through the
        result's scanner (:meth:`_lane_scanner`); every error, out of memory
        included, propagates. On the CPU, the scan rides a scanner that the
        engine already caches, else the host scatter-min."""
        if self._on_card():
            return self._parent_lane_scan(i, self._lane_scanner())
        scanner = getattr(self._engine, "_parent_scanner_cache", None) or None
        if scanner is not None:
            return self._parent_lane_scan(i, scanner)
        return self._parent_lane_host(i)

    def _lane_scanner(self):
        """The scanner of this result's single-lane queries on the card,
        acquired on first use and held by the result: the wide engine's
        cached one, or the hybrid's own full-ELL scanner, whose device
        memory goes with the result, so its lanes pay one ELL build."""
        if self._scanner is None:
            self._scanner = acquire_parent_scanner(self._engine, "device")
        return self._scanner

    def _parent_lane_host(self, i: int) -> np.ndarray:
        """The device-free O(E) host scatter-min of one lane."""
        return min_parents_lane(
            getattr(self._engine, "host_graph", None),
            int(self.sources[i]),
            self.distances_int32(i),
        )

    def _parent_lane_scan(self, i: int, scanner) -> np.ndarray:
        """One lane's tree through ``scanner``: one pass over the lane's
        32-lane word (UNREACHED-padded), bit-equal to the host scatter-min.
        The word's decoded columns are cached, one word at a time, so 32
        lanes of one word cost one pass."""
        ell = scanner.ell
        src = int(self.sources[i])
        out = np.full(self._engine.num_vertices, -1, np.int32)
        if self._iso is not None and self._iso[i]:
            out[src] = src
            return out
        wi, col = divmod(i, 32)
        pc = self._pword_cache.get(wi)
        if pc is None:
            perm = self._scan_row_map(scanner)
            pc = self._scan_pass(scanner, wi, 1, perm).cpu().numpy()[:, :32]
            self._pword_cache.clear()  # one word resident at a time
            self._pword_cache[wi] = pc
        out[ell.old_of_new[: ell.num_active]] = pc[:, col]
        return out

    def parents_into(self, out: np.ndarray, *, device: str = "auto") -> np.ndarray:
        """Fill ``out[i]`` ([S, V] int32) with every lane's parent tree.

        ``device='auto'`` runs the device min-key scan (one ``min``
        expansion per 128 lanes). On the card that is the only automatic
        path: when the scan is unavailable it raises, and its errors, out
        of memory included, propagate. On the CPU, ``auto`` takes the
        per-lane host path where the engine has no scanner. ``'host'``
        forces the host path; ``'device'`` runs the scan or raises."""
        n = len(self.sources)
        v = self._engine.num_vertices
        if out.shape != (n, v):
            raise ValueError(f"out is {out.shape}, need ({n}, {v})")
        _check_parent_device(device)
        if device == "host":
            return self._parents_into_host(out)
        if self._on_card():
            device = "device"
        scanner = self._scanner or acquire_parent_scanner(self._engine, device)
        if scanner is None:  # 'auto' on the CPU, and the engine has no scanner
            return self._parents_into_host(out)
        return self._parents_into_scan(out, scanner)

    def _parents_into_host(self, out: np.ndarray) -> np.ndarray:
        """Per-lane host extraction, the device-free path (it never
        re-enters the scan), evicting each 32-lane distance word once its
        lanes are done: peak host memory is ``out`` plus one word."""
        prev_word = None
        for i in range(len(self.sources)):
            cached = self._parent_cache.pop(i, None)
            out[i] = cached if cached is not None else self._parent_lane_host(i)
            wi = i // 32
            if prev_word is not None and wi != prev_word:
                self._word_cache.pop(prev_word, None)
            prev_word = wi
        if prev_word is not None:
            self._word_cache.pop(prev_word, None)
        return out

    def _parents_into_scan(self, out: np.ndarray, scanner) -> np.ndarray:
        """The device scan, ``lanes_per_pass`` lanes a pass: device pass,
        one copy to the host, host decode."""
        n = len(self.sources)
        perm = self._scan_row_map(scanner)
        id_of_row = scanner.ell.old_of_new[: scanner.ell.num_active]
        lpp = scanner.lanes_per_pass
        for lane0 in range(0, n, lpp):
            nw = -(-min(lpp, n - lane0) // 32)
            pc = self._scan_pass(scanner, lane0 // 32, nw, perm).cpu().numpy()
            _decode_pass(out[lane0 : lane0 + lpp], pc, id_of_row)
        if self._iso is not None:
            # Isolated sources never reach the device: their component is
            # {source} (as in distance_u8_lane).
            for lane in np.flatnonzero(self._iso[:n]):
                out[lane].fill(-1)
                out[lane][self.sources[lane]] = self.sources[lane]
        return out

    def _scan_row_map(self, scanner) -> torch.Tensor | None:
        """Engine extraction rows of the scanner's rows, through original
        ids, as an int64 index on the device; None when both row spaces are
        the same (the single-device engines' active-first rank)."""
        eng, ell = self._engine, scanner.ell
        act = ell.num_active
        if eng._act == act and np.array_equal(eng._rank, ell.rank):
            return None
        perm = np.asarray(eng._rank)[ell.old_of_new[:act]].astype(np.int64)
        if len(perm) and (perm.min() < 0 or perm.max() >= eng._act):
            raise RuntimeError(
                "engine row map does not cover the scanner's active vertices "
                f"(rows [{perm.min()}, {perm.max()}] vs {eng._act} extraction rows)"
            )
        return torch.from_numpy(perm).to(scanner.device)

    def _scan_pass(self, scanner, w0: int, nw: int, perm) -> torch.Tensor:
        """One device pass of the parent scan over the 32-lane words
        [w0, w0 + nw): [act, lanes_per_pass] int32 parents on the device."""
        return scanner.scan(self._scan_cols(scanner, w0, nw, perm))

    def _scan_cols(self, scanner, w0: int, nw: int, perm) -> torch.Tensor:
        """A pass's input: the distances of words [w0, w0 + nw), re-rowed by
        ``perm`` (see :meth:`_scan_row_map`) and UNREACHED-padded to
        [act, lanes_per_pass] uint8."""
        eng = self._engine
        cols = [eng._extract_word(self._planes, self._vis, self._src_bits, wi)
                for wi in range(w0, w0 + nw)]
        dist_cols = torch.cat(cols, dim=1) if nw > 1 else cols[0]
        if perm is not None:
            dist_cols = dist_cols.index_select(0, perm)
        pad = scanner.lanes_per_pass - 32 * nw
        if pad:
            dist_cols = torch.cat([dist_cols, torch.full(
                (dist_cols.shape[0], pad), int(UNREACHED), dtype=torch.uint8,
                device=dist_cols.device)], dim=1)
        return dist_cols


def _decode_pass(dest: np.ndarray, pc: np.ndarray, id_of_row: np.ndarray) -> None:
    """Host half of a scan pass: row j of ``dest`` becomes lane j's tree in
    original-id order, from column j of the pass's [act, L] host parents."""
    for j, row in enumerate(dest):
        row.fill(-1)
        row[id_of_row] = pc[:, j]


def parent_scanner_of(engine):
    """The engine's ParentScanner, or None when there is none (no
    full-coverage ELL, or V too large for the 32-bit key at the engine's
    level cap).

    A scanner that borrows the engine's own ELL tables (the wide engine: no
    extra device memory) is cached on the engine. One that built and moved
    its own full ELL (the hybrid, whose dense tiles exist to avoid holding
    one) is returned uncached, so its device memory goes with it after the
    export. Unavailability is cached either way."""
    cached = getattr(engine, "_parent_scanner_cache", None)
    if cached is not None:
        return cached or None  # False marks a probed-and-unavailable engine
    from tpu_bfs_torch.algorithms.parent_scan import ParentScanner, ParentScanUnavailable

    scanner = None
    borrowed = False
    get = getattr(engine, "_full_parent_ell", None)
    if get is not None:
        ell, arrs = get()
        borrowed = arrs is not None
        if ell is not None:
            try:
                scanner = ParentScanner(ell, arrs=arrs, max_dist=engine.max_levels_cap,
                                        device=engine.device)
            except ParentScanUnavailable:
                scanner = None
    if scanner is None:
        engine._parent_scanner_cache = False
    elif borrowed:
        engine._parent_scanner_cache = scanner
    return scanner


def _check_parent_device(device: str) -> None:
    if device not in ("auto", "host", "device"):
        raise ValueError(f"device must be auto|host|device, got {device!r}")


def acquire_parent_scanner(engine, device: str):
    """The engine's scanner, or None for the host path (``'host'``, or
    ``'auto'`` without a scanner). ``'device'`` raises when no scanner
    exists; errors of the build, out of memory included, propagate."""
    _check_parent_device(device)
    scanner = parent_scanner_of(engine) if device != "host" else None
    if scanner is None and device == "device":
        raise ValueError(
            "device parent scan unavailable for this engine (needs a "
            "full-coverage ELL or a retained host graph, and V small "
            "enough for the 32-bit key encoding); pass device='host' for "
            "the per-lane host scatter-min"
        )
    return scanner


def lazy_full_parent_ell(host_graph, kcap: int = 64):
    """``_full_parent_ell`` of engines whose own tables cannot serve the
    scan (the hybrid's residual misses the dense-tile edges): a fresh full
    in-neighbor ELL of the retained host graph, with tables the scanner
    owns; ``(None, None)`` without a host graph."""
    if host_graph is None:
        return None, None
    return build_ell(host_graph, kcap=kcap), None


def min_parents_lane(graph, source: int, dist: np.ndarray) -> np.ndarray:
    """One lane's min-parent tree from its distances on the host. ``graph``
    is the engine's ``host_graph``; None means the engine was built from a
    prebuilt structure that no longer has the edge list."""
    if graph is None:
        raise ValueError(
            "parent extraction needs the edge list: construct the engine "
            "from a Graph (a prebuilt ELL or hybrid graph does not retain it)"
        )
    return min_parent_from_dist(graph, source, dist)


def _check_batch_sources(engine, sources) -> np.ndarray:
    sources = np.asarray(sources, dtype=np.int64)
    if sources.ndim != 1 or len(sources) == 0 or len(sources) > engine.lanes:
        raise ValueError(f"need 1..{engine.lanes} sources, got {sources.shape}")
    if sources.min() < 0 or sources.max() >= engine.num_vertices:
        raise ValueError("source out of range")
    return sources


def _assemble_packed_result(engine, sources, planes, vis, src_bits, levels, alive,
                            elapsed) -> PackedBatchResult:
    """Lane stats on the device, isolated-lane patching, and the level count
    (the last level found an empty frontier iff not alive)."""
    s = len(sources)
    r, d = engine._lane_stats(vis)
    reached = r.cpu().numpy().reshape(-1)[:s].astype(np.int64)
    slot_sum = d.cpu().numpy().reshape(-1)[:s]
    edges = slot_sum // 2 if engine.undirected else slot_sum
    iso = engine._iso_of(sources)
    if iso.any():
        reached[iso] = 1
        edges[iso] = 0
    else:
        iso = None
    return engine.result_cls(
        sources=sources.astype(np.int32),
        num_levels=levels - 1 if levels > 0 and not alive else levels,
        reached=reached,
        edges_traversed=edges,
        elapsed_s=elapsed,
        _engine=engine,
        _planes=planes,
        _vis=vis,
        _src_bits=src_bits,
        _iso=iso,
    )


@dataclasses.dataclass
class PackedDispatch:
    """A finished level loop whose result is not assembled yet. The host
    loop blocks once per level, so dispatch returns after the traversal;
    the split keeps the JAX package's dispatch/fetch protocol."""

    sources: np.ndarray
    fw0: torch.Tensor  # seed table, doubles as the batch's source bits
    planes: tuple
    vis: torch.Tensor
    levels: int
    alive: bool
    truncated: bool
    max_levels: int
    t0: float


def dispatch_packed_batch(engine, sources, *, max_levels: int | None = None) -> PackedDispatch:
    """Seed and run one packed batch."""
    sources = _check_batch_sources(engine, sources)
    cap = engine.max_levels_cap
    max_levels = cap if max_levels is None else min(max_levels, cap)
    fw0 = engine._seed_dev(sources)
    t0 = time.perf_counter()
    planes, vis, levels, alive, truncated = engine._core(engine.arrs, fw0, max_levels)
    return PackedDispatch(
        sources=sources, fw0=fw0, planes=planes, vis=vis, levels=levels,
        alive=alive, truncated=truncated, max_levels=max_levels, t0=t0,
    )


def fetch_packed_batch(engine, pend: PackedDispatch, *, check_cap: bool = True,
                       time_it: bool = False) -> PackedBatchResult:
    """Check the depth cap and assemble the batch's result."""
    if time_it and pend.vis.device.type == "cuda":
        torch.cuda.synchronize(pend.vis.device)
    elapsed = (time.perf_counter() - pend.t0) if time_it else None
    engine._warmed = True
    if check_cap and pend.truncated and pend.max_levels == engine.max_levels_cap:
        raise RuntimeError(
            f"traversal truncated at {pend.levels} levels; "
            f"num_planes={engine.num_planes} caps at {engine.max_levels_cap} "
            "- construct the engine with more planes for this graph"
        )
    return _assemble_packed_result(
        engine, pend.sources, pend.planes, pend.vis, pend.fw0, pend.levels,
        pend.alive, elapsed,
    )


def run_packed_batch(engine, sources, *, max_levels: int | None = None,
                     time_it: bool = False, check_cap: bool = True) -> PackedBatchResult:
    """One dispatch immediately fetched; ``time_it`` warms up first (the
    first CUDA call builds and loads the kernels)."""
    if time_it and not engine._warmed:
        dispatch_packed_batch(engine, sources, max_levels=max_levels)
    pend = dispatch_packed_batch(engine, sources, max_levels=max_levels)
    return fetch_packed_batch(engine, pend, check_cap=check_cap, time_it=time_it)


class PackedRunProtocol:
    """``run`` / ``dispatch`` / ``fetch`` for every packed engine, plus the
    shared seeding and lane-map hooks. ``result_cls`` is the class of a
    batch's result."""

    result_cls = PackedBatchResult

    def run(self, sources, *, max_levels=None, time_it=False, check_cap=True):
        return run_packed_batch(
            self, sources, max_levels=max_levels, time_it=time_it, check_cap=check_cap
        )

    def dispatch(self, sources, *, max_levels=None):
        return dispatch_packed_batch(self, sources, max_levels=max_levels)

    def fetch(self, pend, *, check_cap=True):
        return fetch_packed_batch(self, pend, check_cap=check_cap)

    def _iso_of(self, sources: np.ndarray) -> np.ndarray:
        return self._rank[sources] >= self._act

    def _seed_dev(self, sources: np.ndarray) -> torch.Tensor:
        rws, words, bits = seed_scatter_args(self._rank[sources], self._act)
        dev = self.device
        return self._seed(
            torch.from_numpy(rws).to(dev), torch.from_numpy(words).to(dev),
            torch.from_numpy(bits).to(dev),
        )
