"""Shared machinery of the wide and hybrid packed multi-source BFS engines,
the port of ``tpu_bfs/algorithms/_packed_common.py``'s engine-facing parts.

A batch of up to ``lanes`` sources runs as one traversal over [rows, w]
int32 tables, lane ``l`` at word ``l // 32``, bit ``l % 32`` (word-major).
Each level the engine's ``hit_of`` expands the frontier; the claim is
``next = hit & ~visited``; ``num_planes`` bit-sliced counter planes count
the levels each row stays unvisited. Reached counts and degree sums reduce
on the device; distances decode lazily, one 32-lane word at a time.

The JAX ``lax.while_loop`` becomes a host loop with exactly one
device-to-host sync per level (the ``alive`` flag; with the pull gate, also
the next level's gate counts, in the same read; with the adaptive push,
the next level's push plan). The JAX ``lax.cond`` choices of the gate
become device masks (K1's ``need_blk``) or host branches on those counts,
and the adaptive push's a host branch on its plan.

A batch's state checkpoints to the host (``start`` / ``advance`` /
``finish``) in real-vertex-id row order as uint32, the JAX package's
``PackedCheckpoint`` layout, so checkpoints cross between the packages.

Parent trees are derived after the loop (``PackedBatchResult.parents_*``):
the device parent scan of ``parent_scan.py`` over the engine's full ELL,
or, on the CPU or when asked for, one host scatter-min per lane.

Engines plug in through attributes ``arrs``, ``lanes``, ``w``,
``max_levels_cap``, ``num_planes``, ``undirected``, ``device``, ``_rank``,
``_act``, ``_warmed``, ``num_vertices``, ``host_graph``, ``_in_deg`` and the
callables ``_step``, ``_core``, ``_core_from``, ``_deeper``, ``_seed_dev``,
``_lane_stats``, ``_extract_word``, ``_lane_ecc``, ``_full_parent_ell``, and
``_table_rows``.

Every fixed-shape program the loop and the extraction call (the level
step ``_step``, ``_seed``, ``_lane_stats``, ``_extract_word``,
``_lane_ecc``) takes its tables as arguments, so it exports as a
``torch.export`` program (:func:`packed_aot_programs`, ``utils/aot.py``);
the loops call ``_step`` anew each level, so an adopted program stands in.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from tpu_bfs_torch import faults
from tpu_bfs_torch import obs as _obs
from tpu_bfs_torch.algorithms.frontier import _nonzero_static
from tpu_bfs_torch.graph.csr import INF_DIST
from tpu_bfs_torch.graph.ell import build_ell, pad_gate_blocks
from tpu_bfs_torch.ops.ell_expand import COMBINE, KERNEL_OPS, TILE, ell_expand
from tpu_bfs_torch.utils.aot import AotProgramProtocol, ArgSpec
from tpu_bfs_torch.validate import min_parent_from_dist

UNREACHED = np.uint8(255)  # uint8 distance sentinel; see distances_int32()


#: ``min_lane``'s value for a row no lane visited.
NO_LANE = np.int32(1 << 30)


def min_lane(vis: torch.Tensor, act: int) -> torch.Tensor:
    """[rows, w] word-major visited table -> [act] int32 smallest visiting
    lane of each real row, ``NO_LANE`` where no lane visited: the lowest
    set bit of the row's first nonzero word. A fixed handful of passes over
    the table, whatever its width."""
    if act == 0:
        return torch.zeros(0, dtype=torch.int32, device=vis.device)
    v = vis[:act]
    nz = v != 0
    first = nz.to(torch.uint8).argmax(dim=1)  # the first nonzero word (0 if none)
    word = v.gather(1, first[:, None]).squeeze(1).long() & 0xFFFFFFFF
    low = word & -word  # its lowest set bit, exactly a power of two (or 0)
    _, exp = torch.frexp(low.double())  # low == 2**(exp - 1)
    lane = first * 32 + exp.long() - 1
    return torch.where(nz.any(dim=1), lane, int(NO_LANE)).to(torch.int32)


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
        arrs["virtual_gt"] = pad_gate_blocks(ell_like.virtual.idx.T, sentinel)
    for i, b in enumerate(ell_like.light):
        arrs[f"light{i}_gt"] = pad_gate_blocks(b.idx.T, sentinel)
    return arrs


def expand_arrays(ell_like, sentinel: int, device) -> dict:
    """Device tensors of one expansion: the kernel tables
    (:func:`pallas_expand_arrays`), an all-ones gate per table
    (``{name}_need``), and the heavy fold map and pick (int64)."""
    return device_expand_arrays(pallas_expand_arrays(ell_like, sentinel),
                                ell_like.fold_pad_map, ell_like.heavy_pick, device)


def device_expand_arrays(tables: dict, fold_pad_map, heavy_pick, device) -> dict:
    """:func:`expand_arrays` from the host kernel tables (name ->
    [k, nb*128] int32) and the heavy fold map and pick (None without a
    heavy section)."""
    arrs = {}
    for name, tbl in tables.items():
        arrs[name] = torch.from_numpy(tbl).to(device)
        arrs[name.removesuffix("_gt") + "_need"] = torch.ones(
            tbl.shape[1] // TILE, dtype=torch.int32, device=device
        )
    if fold_pad_map is not None:
        arrs["fold_pad_map"] = torch.from_numpy(fold_pad_map.astype(np.int64)).to(device)
        arrs["heavy_pick"] = torch.from_numpy(heavy_pick.astype(np.int64)).to(device)
    return arrs


def arrs_nbytes(host_tables: dict) -> int:
    return sum(int(np.asarray(t).nbytes) for t in host_tables.values())


def _weight_slab(op: str, wsuf: str | None):
    """``wt_of(arrs, name)``: the min-plus weight slab of bucket ``name``
    (``{name}_{wsuf}_gt``, padded slot for slot with ``{name}_gt``), or None
    for the ops that take no weights."""
    if (op == "minplus") != (wsuf is not None):
        raise ValueError("op='minplus' needs wsuf (the weight plane); or/min take none")
    if wsuf is None:
        return lambda arrs, name: None
    return lambda arrs, name: arrs[f"{name}_{wsuf}_gt"]


def _expand_pieces(spec: ExpandSpec, w: int, op: str, wsuf: str | None = None):
    """``(full, heavy)`` of a bucketed-ELL expansion: ``full(n, fw)`` is
    ``n`` identity rows; ``heavy(arrs, fw)`` the heavy section, one K1
    launch over the virtual rows, then their fold pyramid and
    ``heavy_pick`` in plain torch. ``wsuf`` names min-plus's weight plane."""
    combine = COMBINE[op]
    ident = KERNEL_OPS[op][0]
    wt_of = _weight_slab(op, wsuf)

    def full(n, fw):
        return torch.full((n, w), ident, dtype=torch.int32, device=fw.device)

    def heavy(arrs, fw):
        acc = ell_expand(arrs["virtual_need"], arrs["virtual_gt"], fw,
                         wt_of(arrs, "virtual"), op=op)[: spec.num_virtual]
        vr_ext = torch.cat([acc, full(1, fw)])
        cur = vr_ext.index_select(0, arrs["fold_pad_map"])
        pyramid = [cur]
        for _ in range(spec.fold_steps):
            pairs = cur.view(-1, 2, w)
            cur = combine(pairs[:, 0], pairs[:, 1])
            pyramid.append(cur)
        pyr = torch.cat(pyramid) if len(pyramid) > 1 else pyramid[0]
        return pyr.index_select(0, arrs["heavy_pick"])

    return full, heavy


def make_expand(spec: ExpandSpec, w: int, *, op: str = "or", wsuf: str | None = None):
    """The bucketed-ELL expansion: one ``ell_expand`` launch per bucket
    (the JAX ``make_pallas_expand`` form), the heavy rows' fold pyramid and
    ``heavy_pick`` in plain torch. Returns ``expand(arrs, fw)``: the bucket
    outputs (heavy, light..., ``tail_rows`` identity rows), a fresh tensor.
    With ``op="minplus"``, ``wsuf`` picks the weight plane each launch adds
    (``arrs["{bucket}_{wsuf}_gt"]``)."""
    full, heavy = _expand_pieces(spec, w, op, wsuf)
    wt_of = _weight_slab(op, wsuf)

    def expand(arrs, fw):
        parts = [heavy(arrs, fw)] if spec.heavy else []
        for i, (_k, n) in enumerate(spec.light_meta):
            name = f"light{i}"
            parts.append(ell_expand(arrs[f"{name}_need"], arrs[f"{name}_gt"], fw,
                                    wt_of(arrs, name), op=op)[:n])
        if spec.tail_rows:
            parts.append(full(spec.tail_rows, fw))
        return torch.cat(parts) if len(parts) > 1 else parts[0].clone()

    return expand


# --- The pull gate -----------------------------------------------------------
#
# A row is settled once every active lane (a batch entry that seeded a table
# row) has visited it: ``vis[r] & lane_mask == lane_mask``. A settled row
# never claims again (``hit & ~vis`` is empty on every active lane, and
# frontier words carry only active lanes' bits), so the pull work that
# produces its hit, and its claim and plane ripple, can be skipped with
# bit-identical distances and parents. The gate works in GATE_TILE-row
# blocks: K1 skips a gated-out tile (``need_blk``), and the state pass
# gathers only the blocks still holding an unsettled row.

GATE_TILE = 128  # rows per gate block
# The compacted passes pay off only when most blocks are settled; each gated
# pass falls back to the dense form above this active fraction. Policy
# only: both forms are bit-identical on everything extraction reads.
GATE_DENSE_DEN = 4  # gated only when active blocks <= total / 4


def host_lane_mask(rows_of_sources: np.ndarray, act: int, w: int) -> np.ndarray:
    """[w] uint32 active-lane mask: the OR of every non-isolated batch
    entry's (word, bit) seed slot (the keep rule of seed_scatter_args).
    Lanes outside the batch and isolated-source lanes are vacuously
    settled. An all-ones mask is always safe (it only delays settling); a
    mask missing a seeded lane would skip live claims."""
    ranks = np.asarray(rows_of_sources, dtype=np.int64)
    lanes = np.arange(len(ranks))
    keep = ranks < act
    mask = np.zeros(w, np.uint32)
    np.bitwise_or.at(mask, lanes[keep] // 32,
                     np.uint32(1) << (lanes[keep] % 32).astype(np.uint32))
    return mask


def row_unsettled(vis: torch.Tensor, act: int, lane_mask: torch.Tensor) -> torch.Tensor:
    """[rows] bool: True where a real row (< ``act``) still has an active
    lane unvisited, so its pull work must run. ``lane_mask`` is the [w]
    int32 view of :func:`host_lane_mask`."""
    m = lane_mask[None, :]
    uns = ((vis & m) != m).any(dim=1)
    uns[act:] = False
    return uns


def host_row_unsettled(vis: np.ndarray, act: int, lane_mask: np.ndarray) -> np.ndarray:
    """:func:`row_unsettled` of a host [rows, w] uint32 table."""
    uns = ((vis & lane_mask[None, :]) != lane_mask[None, :]).any(axis=1)
    uns[act:] = False
    return uns


def seed_row_unsettled(rows_of_sources: np.ndarray, act: int, rows: int) -> np.ndarray:
    """:func:`row_unsettled` of a fresh batch's seed table, from its sources
    alone: a row is settled at level 0 only if it is the one row every
    active lane starts from, and every row is when no lane is active."""
    need = np.arange(rows) < act
    r = np.asarray(rows_of_sources, dtype=np.int64)
    kept = np.unique(r[r < act])
    if len(kept) == 0:
        need[:] = False
    elif len(kept) == 1:
        need[kept[0]] = False
    return need


def _gate_bucket_starts(spec: ExpandSpec) -> np.ndarray:
    """The first gate block of each light bucket, and their total."""
    nbs = [-(-n // GATE_TILE) for _k, n in spec.light_meta]
    return np.concatenate([[0], np.cumsum(nbs)]).astype(np.int64)


def gate_block_arrays(spec: ExpandSpec, arrs: dict) -> dict:
    """The block-id maps of :func:`make_gated_expand`, device tables an
    engine adds to its ``arrs`` (so an exported gated step takes them as
    arguments): ``gate_row_block``, the block of each output row, with the
    heavy and tail rows at a dump block; ``gate_block_bucket``, the bucket
    of each block; ``gate_bucket_blocks``, each bucket's block count."""
    if not spec.light_meta:
        return {}
    starts = _gate_bucket_starts(spec)
    nbs = np.diff(starts)
    nh = arrs["heavy_pick"].shape[0] if spec.heavy else 0
    ids = [np.full(nh, starts[-1], np.int64)]
    for i, (_k, n) in enumerate(spec.light_meta):
        ids.append(starts[i] + np.arange(n, dtype=np.int64) // GATE_TILE)
    ids.append(np.full(spec.tail_rows, starts[-1], np.int64))
    bucket = np.repeat(np.arange(len(nbs), dtype=np.int64), nbs)
    device = next(iter(arrs.values())).device
    return {k: torch.from_numpy(x).to(device) for k, x in (
        ("gate_row_block", np.concatenate(ids)), ("gate_block_bucket", bucket),
        ("gate_bucket_blocks", nbs.astype(np.int64)))}


def make_gated_expand(spec: ExpandSpec, w: int, *, op: str = "or"):
    """The gated form of :func:`make_expand` (the JAX
    ``make_gated_pallas_expand``): the gate rides into K1 as its
    ``need_blk`` mask, and a gated-out tile writes the identity without a
    gather. Per light bucket, the mask is the bucket's blocks that hold a
    needed row, or all ones when more than 1/GATE_DENSE_DEN of them do
    (the dense fallback is the same kernel, not a second path); it is built
    on the device, so no host read decides it. The heavy section is skipped
    whole when none of its output rows is needed, which the host learned in
    the previous level's sync.

    Every bucket's mask comes out of one pass over ``needed`` (the block-id
    maps of :func:`gate_block_arrays`, in ``arrs``): a level pays a fixed
    handful of small ops for the gate, not a handful per bucket.

    Returns ``expand(arrs, fw, needed, heavy) -> (outputs, skipped)``:
    ``needed`` is [outputs' rows] bool on the device, ``heavy`` a host
    bool, ``skipped`` the skipped blocks (a device int64 scalar). Skipped
    rows come out as the identity, whose claim the caller masks away."""
    full, heavy_section = _expand_pieces(spec, w, op)
    heavy_blocks = -(-spec.num_virtual // GATE_TILE) if spec.heavy else 0
    starts = _gate_bucket_starts(spec)
    nbs = np.diff(starts)

    def expand(arrs, fw, needed, heavy):
        parts = []
        skipped = torch.zeros((), dtype=torch.int64, device=fw.device)
        if spec.heavy:
            if heavy:
                parts.append(heavy_section(arrs, fw))
            else:
                parts.append(full(arrs["heavy_pick"].shape[0], fw))
                skipped += heavy_blocks
        if spec.light_meta:
            row_block, block_bucket, nb = (
                arrs["gate_row_block"], arrs["gate_block_bucket"], arrs["gate_bucket_blocks"])
            hits = torch.zeros(int(starts[-1]) + 1, dtype=torch.int32, device=fw.device)
            hits.index_add_(0, row_block, needed.to(torch.int32))
            blk = hits[:-1] > 0
            nzb = torch.zeros(len(nbs), dtype=torch.int64, device=fw.device)
            nzb.index_add_(0, block_bucket, blk.long())
            take_gated = nzb * GATE_DENSE_DEN <= nb
            mask = torch.where(take_gated.index_select(0, block_bucket), blk, True).to(torch.int32)
            skipped += torch.where(take_gated, nb - nzb, 0).sum()
            for i, (_k, n) in enumerate(spec.light_meta):
                m = mask[int(starts[i]) : int(starts[i + 1])]
                parts.append(ell_expand(m, arrs[f"light{i}_gt"], fw, op=op)[:n])
        if spec.tail_rows:
            parts.append(full(spec.tail_rows, fw))
        out = torch.cat(parts) if len(parts) > 1 else parts[0].clone()
        return out, skipped

    return expand


def gated_state_update_(hit, vis, planes, need, nzt: int) -> torch.Tensor:
    """Claim, visited-OR and plane ripple over only the GATE_TILE blocks
    that still hold an unsettled row (``need``; ``nzt`` of them, a count
    the host read in the previous level's sync): the pull gate's state
    pass. Updates ``vis`` and ``planes`` in place, consumes ``hit``, and
    returns the claim ``nxt``.

    Skipped blocks match the dense update on everything extraction reads:
    their claim is empty, ``vis`` is unchanged, and the plane bits a dense
    ripple would still move there belong to inactive lanes or pad rows.
    The ragged tail block always updates densely. Above 1/GATE_DENSE_DEN
    active blocks the whole table updates densely, as in the JAX
    ``gated_state_update``. The active blocks are gathered
    (``index_select`` copies), updated and written back (``index_copy_``),
    so nothing aliases."""
    T = GATE_TILE
    rows, w = vis.shape
    nt = rows // T
    if nt == 0 or nzt * GATE_DENSE_DEN > nt:
        hit &= ~vis
        vis |= hit
        ripple_increment_(planes, ~vis)
        return hit
    body = nt * T
    nxt = torch.zeros_like(vis)
    if nzt:
        idx = _nonzero_static(need[:body].view(nt, T).any(dim=1), nzt).long()

        def blocks(t):
            return t[:body].view(nt, T, w)

        nx = blocks(hit).index_select(0, idx)
        v = blocks(vis).index_select(0, idx)
        nx &= ~v
        v |= nx
        pts = [blocks(p).index_select(0, idx) for p in planes]
        ripple_increment_(pts, ~v)
        for p, pt in zip(planes, pts):
            blocks(p).index_copy_(0, idx, pt)
        blocks(vis).index_copy_(0, idx, v)
        blocks(nxt).index_copy_(0, idx, nx)
    if rows > body:  # the tail, densely
        nx = hit[body:]
        v = vis[body:]
        nx &= ~v
        v |= nx
        ripple_increment_([p[body:] for p in planes], ~v)
        nxt[body:] = nx
    return nxt


class GateRead(NamedTuple):
    """What the host knows of a level's gate before the level runs."""

    nzt: int  # gate blocks (of the table's whole blocks) holding an unsettled row
    heavy: bool  # whether any heavy bucket-output row is needed


class GatedRun(NamedTuple):
    """A gated loop's record besides the state."""

    counts: torch.Tensor  # [gate_levels] int32 skipped blocks per level
    syncs: int  # device-to-host reads in the loop: one a level
    active_blocks: list  # per level, the state blocks holding an unsettled row


def level_step(hit_of):
    """One level of the plain loop as a fixed-shape program:
    ``step(arrs, fw, vis, planes) -> (nxt, alive)``. The hit (``hit_of``,
    the kernels), the claim ``hit & ~vis``, the visited OR and the plane
    ripple, updating ``vis`` and ``planes`` in place; ``alive`` is the claim's
    any() as a 0-d tensor, for the host to read. This is the engine's
    ``_step``, the ``core`` program of its AOT inventory
    (:func:`packed_aot_programs`)."""

    def step(arrs, fw, vis, planes):
        nxt = hit_of(arrs, fw)
        nxt &= ~vis
        vis |= nxt
        # Pad/sentinel rows count up harmlessly (never visited, never
        # decoded).
        ripple_increment_(planes, ~vis)
        return nxt, nxt.any()

    return step


def make_packed_loop(step, hit_of, num_planes: int):
    """The level loop of the wide and hybrid engines: a host loop over
    ``step(arrs, fw, vis, planes) -> (nxt, alive)`` (:func:`level_step`,
    called anew each level, so an adopted program stands in for it), with
    the level's one device-to-host read of ``alive``. ``hit_of(arrs, fw)``
    is the step's hit, which ``deeper`` runs alone. Returns ``(core,
    core_from, deeper)``:

    - ``core(arrs, fw0, max_levels) -> (planes, vis, levels, alive,
      truncated)``: a fresh traversal (visited starts as the seed table,
      which is left untouched for extraction; planes start at zero);
    - ``core_from(arrs, fw, vis, planes, level0, max_levels) -> (fw, vis,
      planes, level, alive)``: resume from mid-traversal state; updates
      ``vis`` and ``planes`` in place;
    - ``deeper(arrs, fw, vis) -> bool``: whether one more level would
      claim anything (a claim-free expansion; the state is untouched).
    """

    def deeper(arrs, fw, vis):
        return bool((hit_of(arrs, fw) & ~vis).any())

    def core_from(arrs, fw, vis, planes, level0, max_levels):
        level, alive = int(level0), True
        while alive and level < max_levels:
            fw, alive = step(arrs, fw, vis, planes)
            alive = bool(alive)  # the level's one device-to-host sync
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
        truncated = alive and levels >= max_levels and deeper(arrs, fw, vis)
        return planes, vis, levels, alive, truncated

    return core, core_from, deeper


def make_gated_level(hit_of, *, act: int, needed_of, heavy_rows: int):
    """One level of the pull-gated loop (the gated mode of the JAX
    ``make_packed_loop``). ``hit_of(arrs, fw, needed, heavy) -> (hit,
    skipped)`` is the gated expansion; ``needed_of(arrs, need)`` maps the
    per-row unsettled mask to bucket-output order, whose first
    ``heavy_rows`` rows are the heavy section's. Returns ``(probe, level,
    step)``:

    - ``probe(arrs, vis, lane_mask) -> (need, needed)``;
    - ``level(arrs, fw, vis, planes, need, needed, lane_mask, heavy, nzt)
      -> (nxt, skipped, need, needed, stats)``: the expansion, the gated
      state pass (updating ``vis`` and ``planes`` in place) and the next
      level's probe; ``stats`` is the int64 (alive, unsettled blocks, heavy
      needed) the host reads. ``heavy`` and ``nzt`` are the host's gate;
    - ``step(arrs, fw, vis, planes, needed, lane_mask)``: ``level`` with
      the heavy section on and the dense state pass, the fixed-shape form
      that is the engine's ``_step`` and its ``core`` program. The gate's
      other forms (a skipped heavy section, the compacted state pass, whose
      shape is the host's count) run eagerly, as the push pass does."""
    T = GATE_TILE

    def probe(arrs, vis, lane_mask):
        need = row_unsettled(vis, act, lane_mask)
        return need, needed_of(arrs, need)

    def level(arrs, fw, vis, planes, need, needed, lane_mask, heavy, nzt):
        hit, skipped = hit_of(arrs, fw, needed, heavy)
        nxt = gated_state_update_(hit, vis, planes, need, nzt)
        need, needed = probe(arrs, vis, lane_mask)
        nt = need.shape[0] // T
        stats = torch.stack([
            nxt.any().long(),
            need[: nt * T].view(nt, T).any(dim=1).sum(),
            needed[:heavy_rows].any().long(),
        ])
        return nxt, skipped, need, needed, stats

    def step(arrs, fw, vis, planes, needed, lane_mask):
        return level(arrs, fw, vis, planes, None, needed, lane_mask, True, vis.shape[0] // T)

    return probe, level, step


def make_gated_packed_loop(step, hit_of, probe, level, num_planes: int, *,
                           gate_levels: int, heavy_rows: int):
    """The pull-gated level loop over :func:`make_gated_level`'s pieces: a
    level whose gate needs the heavy section and the dense state pass
    calls ``step`` (anew each level, so an adopted program stands in for
    it), any other ``level``.

    Each level ends with one device-to-host read: ``alive``, and the next
    level's unsettled block count and heavy flag, computed right after the
    claim. The first level's come from the host (:class:`GateRead`), so a
    loop of L levels reads L times. Returns ``(core, core_from, deeper)``
    with the ungated signatures plus ``lane_mask`` ([w] int32) and
    ``gate0``; ``core`` and ``core_from`` also return a :class:`GatedRun`
    (the skipped blocks per level, at the absolute level index as in JAX)."""
    T = GATE_TILE

    def deeper(arrs, fw, vis, lane_mask):
        # The heavy section runs: its settled rows claim nothing anyway.
        _, needed = probe(arrs, vis, lane_mask)
        return bool((hit_of(arrs, fw, needed, True)[0] & ~vis).any())

    def core_from(arrs, fw, vis, planes, level0, max_levels, lane_mask, gate0):
        counts = torch.zeros(max(gate_levels, 1), dtype=torch.int32, device=vis.device)
        need, needed = probe(arrs, vis, lane_mask)
        nt = vis.shape[0] // T
        gate, lvl, alive, syncs, active = gate0, int(level0), True, 0, []
        while alive and lvl < max_levels:
            active.append(gate.nzt)
            dense = nt == 0 or gate.nzt * GATE_DENSE_DEN > nt
            if dense and (gate.heavy or not heavy_rows):
                nxt, skipped, need, needed, stats = step(arrs, fw, vis, planes, needed,
                                                         lane_mask)
            else:
                nxt, skipped, need, needed, stats = level(
                    arrs, fw, vis, planes, need, needed, lane_mask, gate.heavy, gate.nzt)
            counts[min(lvl, gate_levels - 1)] = skipped
            a, nzt, heavy = stats.tolist()  # the level's one sync
            alive, gate = bool(a), GateRead(int(nzt), bool(heavy))
            syncs += 1
            fw = nxt
            lvl += 1
        return fw, vis, planes, lvl, alive, GatedRun(counts, syncs, active)

    def core(arrs, fw0, max_levels, lane_mask, gate0):
        planes = tuple(torch.zeros_like(fw0) for _ in range(num_planes))
        fw, vis, planes, levels, alive, run = core_from(
            arrs, fw0, fw0.clone(), planes, 0, max_levels, lane_mask, gate0
        )
        truncated = alive and levels >= max_levels and deeper(arrs, fw, vis, lane_mask)
        return planes, vis, levels, alive, truncated, run

    return core, core_from, deeper


class PullGateHost:
    """Pull-gate bookkeeping of the wide and hybrid engines: the batch's
    lane mask and first-level gate (host side), and the core wrappers that
    thread them into the gated loop and keep its record:
    ``last_gate_level_counts`` ([gate_levels] int32 skipped blocks per
    level, on the device), ``last_host_syncs`` and
    ``last_gate_active_blocks`` (per level run, the state blocks that held
    an unsettled row, of ``_table_rows // GATE_TILE``). An engine calls
    :meth:`_install_gate` when built with ``pull_gate=True``; it needs
    ``_rank``, ``_act``, ``_table_rows``, ``w``, ``num_planes``,
    ``max_levels_cap`` and ``device``."""

    pull_gate = False
    last_gate_level_counts = None
    last_host_syncs = None
    last_gate_active_blocks = None

    def _install_gate(self, hit_of, *, needed_of, heavy_rows: int, heavy_needed_host):
        """``heavy_needed_host(need)``: whether a host [rows] unsettled mask
        needs a heavy output row (``needed_of`` on the host)."""
        self.pull_gate = True
        self._gate_heavy_host = heavy_needed_host
        probe, level, self._step = make_gated_level(
            hit_of, act=self._act, needed_of=needed_of, heavy_rows=heavy_rows)
        # The step's ``needed`` length: the expansion's output rows.
        self._gate_needed_rows = needed_of(
            self.arrs, torch.zeros(self._table_rows, dtype=torch.bool, device=self.device)
        ).shape[0]
        self._gate_loop = make_gated_packed_loop(
            self._call_step, hit_of, probe, level, self.num_planes,
            gate_levels=self.max_levels_cap, heavy_rows=heavy_rows,
        )
        self._core, self._core_from, self._deeper = (
            self._gated_core, self._gated_core_from, self._gated_deeper)

    def _note_batch_sources(self, sources) -> None:
        """The batch's lane mask, and the seed table's unsettled rows: every
        gated loop starts after this (dispatch and advance call it)."""
        if not self.pull_gate:
            return
        rows = np.asarray(self._rank)[np.asarray(sources, dtype=np.int64)]
        self._lane_mask = host_lane_mask(rows, self._act, self.w)
        self._lane_mask_dev = torch.from_numpy(self._lane_mask.view(np.int32)).to(self.device)
        self._gate_need0 = seed_row_unsettled(rows, self._act, self._table_rows)

    def _note_resume_state(self, vis_host: np.ndarray) -> None:
        """The unsettled rows of a resumed host visited table ([rows, w]
        uint32), for the first level's gate."""
        if self.pull_gate:
            self._gate_need0 = host_row_unsettled(vis_host, self._act, self._lane_mask)

    def _gate0(self) -> GateRead:
        """The first level's gate, from the noted host unsettled rows."""
        need = self._gate_need0
        nt = len(need) // GATE_TILE
        nzt = int(need[: nt * GATE_TILE].reshape(nt, GATE_TILE).any(axis=1).sum())
        return GateRead(nzt, self._gate_heavy_host(need))

    def _gated_core(self, arrs, fw0, max_levels):
        planes, vis, levels, alive, truncated, run = self._gate_loop[0](
            arrs, fw0, max_levels, self._lane_mask_dev, self._gate0())
        self._record(run)
        return planes, vis, levels, alive, truncated

    def _gated_core_from(self, arrs, fw, vis, planes, level0, max_levels):
        fw, vis, planes, level, alive, run = self._gate_loop[1](
            arrs, fw, vis, planes, level0, max_levels, self._lane_mask_dev, self._gate0())
        self._record(run)
        return fw, vis, planes, level, alive

    def _record(self, run: GatedRun) -> None:
        self.last_gate_level_counts = run.counts
        self.last_host_syncs = run.syncs
        self.last_gate_active_blocks = run.active_blocks

    def _gated_deeper(self, arrs, fw, vis):
        return self._gate_loop[2](arrs, fw, vis, self._lane_mask_dev)


# --- Level-adaptive push -----------------------------------------------------
#
# A light level (at most ``row_cap`` active frontier rows, none with
# out-degree above ``deg_cap``) ORs each active row's frontier words into
# its out-neighbours' hit rows instead of running the whole pull (every K1
# bucket, and K2 in the hybrid). Pushing over out-edges equals pulling over
# in-edges bit for bit: the push table is edge-exact, directed or not. The
# JAX package decides on the device with ``lax.cond``; here the next
# level's decision is computed right after the claim and read in the same
# transfer as ``alive``, so a level keeps its one host read.


def build_push_table(host_graph, rank: np.ndarray, act: int, deg_cap: int):
    """Out-CSR push table in rank space for the level-adaptive expansion:
    ``([act+1, deg_cap] int32 out-neighbor rows (pad/sentinel = act),
    [act] bool ineligibility mask — rows with out-degree > deg_cap)``.
    Rank space must be active-first (every edge endpoint < act). The JAX
    package's ``build_push_table``, host NumPy."""
    src, dst = host_graph.coo
    rs = rank[src].astype(np.int64)
    rd = rank[dst].astype(np.int32)
    out_deg = np.bincount(rs, minlength=act)[:act]
    elig = out_deg <= deg_cap
    order = np.argsort(rs, kind="stable")
    rs_s, rd_s = rs[order], rd[order]
    rp = np.zeros(act + 1, np.int64)
    np.cumsum(out_deg, out=rp[1:])
    pos = np.arange(len(rs_s), dtype=np.int64) - rp[rs_s]
    keep = elig[rs_s]
    pt = np.full((act + 1, deg_cap), act, np.int32)
    pt[rs_s[keep], pos[keep]] = rd_s[keep]
    return pt, ~elig


class PushPlan(NamedTuple):
    """What the host knows of a level's frontier before the level runs."""

    light: bool  # the level takes the push pass
    rows: int  # active frontier rows
    pairs: int  # their out-edges in the push table (every slot that is not a pad)


class AdaptivePush:
    """The push pass and its gate (the JAX ``make_adaptive_hit``) over the
    push table of :func:`build_push_table`, whose device arrays ride in the
    engine's ``arrs`` (:meth:`device_arrays`): ``push_t``, ``push_inelig``
    and ``push_deg`` (each row's push slots in use).

    The push is plain PyTorch. PyTorch has no bitwise-OR scatter, and two
    active rows often share an out-neighbour, so the (destination, source)
    pairs are sorted by destination and OR-reduced within each run of equal
    destinations by doubling steps (after step s, each pair holds the OR of
    the next 2**s pairs of its run); the head of each run then holds its
    whole OR, and one ``index_add_`` of the heads (the other pairs zeroed)
    writes every destination row once. OR is commutative and idempotent,
    so this equals JAX's sequential scatter, repeated edges included. The
    number of steps is bounded on the host by the pairs and by the most
    pairs any row can receive."""

    def __init__(self, push_cfg, pt: np.ndarray, inelig: np.ndarray, *, act: int,
                 out_rows: int):
        self.row_cap, self.deg_cap = (int(x) for x in push_cfg)
        self.act, self.out_rows = act, out_rows
        self._pt, self._inelig = pt, inelig
        used = pt[:act] != act
        self._deg = used.sum(axis=1).astype(np.int32)
        received = np.bincount(pt[:act][used], minlength=1)
        self.max_mult = max(int(received.max()), 1)

    def device_arrays(self, device) -> dict:
        return {
            "push_t": torch.from_numpy(self._pt).to(device),
            "push_inelig": torch.from_numpy(self._inelig).to(device),
            "push_deg": torch.from_numpy(self._deg).to(device),
        }

    def nbytes(self) -> int:
        return self._pt.nbytes + self._inelig.nbytes + self._deg.nbytes

    def _plan(self, rows: int, bad: bool, pairs: int) -> PushPlan:
        return PushPlan(rows <= self.row_cap and not bad, int(rows), int(pairs))

    def host_plan(self, table_rows) -> PushPlan:
        """The plan of a frontier whose active table rows the host knows (a
        batch's seed rows, or a checkpoint's frontier rows)."""
        rows = np.asarray(table_rows, dtype=np.int64)
        live = np.unique(rows[rows < self.act])
        return self._plan(len(live), bool(self._inelig[live].any()), self._deg[live].sum())

    def probe(self, arrs, fw):
        """``(active, stats)`` of a frontier on the device: its [act] active
        rows and the int64 (light, rows, pairs) the next level's plan reads."""
        active = fw[: self.act].any(dim=1)
        rows = active.sum()
        bad = (active & arrs["push_inelig"]).any()
        pairs = (arrs["push_deg"] * active).sum(dtype=torch.int64)
        light = (rows <= self.row_cap) & ~bad
        return active, torch.stack([light.long(), rows, pairs])

    @staticmethod
    def plan_of(stats) -> PushPlan:
        """The host :class:`PushPlan` of ``probe``'s stats, read back."""
        light, rows, pairs = stats
        return PushPlan(bool(light), int(rows), int(pairs))

    def hit(self, arrs, fw, plan: PushPlan, active=None):
        """The push pass: a fresh [out_rows, w] hit table of the frontier's
        out-edges. ``plan`` (the frontier's row and pair counts) sizes every
        compaction, so no host read happens here; ``active`` is the
        frontier's active-row mask when the caller has it."""
        hit = torch.zeros((self.out_rows, fw.shape[1]), dtype=torch.int32, device=fw.device)
        if plan.pairs == 0:
            return hit
        if active is None:
            active = fw[: self.act].any(dim=1)
        rows = _nonzero_static(active, plan.rows).long()
        nb = arrs["push_t"].index_select(0, rows)  # [rows, deg_cap], pads = act
        slot = _nonzero_static((nb != self.act).view(-1), plan.pairs).long()
        dst, order = torch.sort(nb.view(-1).index_select(0, slot).long())
        src = rows.index_select(0, slot.index_select(0, order) // self.deg_cap)
        vals = fw.index_select(0, src)  # [pairs, w], the source words
        for i in range((min(plan.pairs, self.max_mult) - 1).bit_length()):
            s = 1 << i
            vals[:-s] |= torch.where((dst[s:] == dst[:-s])[:, None], vals[s:], 0)
        head = torch.ones_like(dst, dtype=torch.bool)
        head[1:] = dst[1:] != dst[:-1]
        # One nonzero contribution per destination: the add is the OR.
        hit.index_add_(0, dst, torch.where(head[:, None], vals, 0))
        return hit


class AdaptiveRun(NamedTuple):
    """An adaptive loop's record besides the state."""

    pushed: list  # per level run, whether it took the push pass
    syncs: int  # device-to-host reads in the loop: one a level


def make_adaptive_level(hit_of, push: AdaptivePush):
    """One level of the adaptive loop. Returns ``(settle, step)``:
    ``settle(arrs, hit, vis, planes) -> (nxt, active, stats)`` claims a hit
    table (``hit & ~vis``), ORs it into ``vis``, ripples the planes (both in
    place) and probes the claim for the next level's plan (``push.probe``);
    ``step(arrs, fw, vis, planes)`` is ``settle`` over the pull hit
    (``hit_of``, the kernels), the fixed-shape form that is the engine's
    ``_step`` and its ``core`` program. The push pass, whose shapes are the
    plan's counts, runs eagerly."""

    def settle(arrs, nxt, vis, planes):
        nxt &= ~vis
        vis |= nxt
        ripple_increment_(planes, ~vis)
        active, stats = push.probe(arrs, nxt)
        return nxt, active, stats

    def step(arrs, fw, vis, planes):
        return settle(arrs, hit_of(arrs, fw), vis, planes)

    return settle, step


def make_adaptive_packed_loop(step, hit_of, settle, push: AdaptivePush, num_planes: int):
    """The level loop with the adaptive push (the JAX ``make_packed_loop``
    over ``make_adaptive_hit``). A light level settles ``push.hit``, any
    other calls ``step`` (:func:`make_adaptive_level`, anew each level, so
    an adopted program stands in for it). Each level ends with one
    device-to-host read: the next level's plan (light, active rows, pairs),
    computed right after the claim; ``alive`` is its row count, since a
    claim lands only on real rows. The first level's plan is the caller's
    (``plan0``). Returns ``(core, core_from, deeper)`` with the plain
    signatures plus ``plan0``; ``core`` and ``core_from`` also return an
    :class:`AdaptiveRun`."""

    def deeper(arrs, fw, vis):
        # The pull: the push pass equals it bit for bit.
        return bool((hit_of(arrs, fw) & ~vis).any())

    def core_from(arrs, fw, vis, planes, level0, max_levels, plan0):
        plan, level, alive, active, pushed = plan0, int(level0), True, None, []
        while alive and level < max_levels:
            pushed.append(plan.light)
            if plan.light:
                nxt, active, stats = settle(arrs, push.hit(arrs, fw, plan, active), vis, planes)
            else:
                nxt, active, stats = step(arrs, fw, vis, planes)
            plan = push.plan_of(stats.tolist())  # the level's one device-to-host sync
            alive = plan.rows > 0
            fw = nxt
            level += 1
        return fw, vis, planes, level, alive, AdaptiveRun(pushed, len(pushed))

    def core(arrs, fw0, max_levels, plan0):
        planes = tuple(torch.zeros_like(fw0) for _ in range(num_planes))
        fw, vis, planes, levels, alive, run = core_from(
            arrs, fw0, fw0.clone(), planes, 0, max_levels, plan0
        )
        truncated = alive and levels >= max_levels and deeper(arrs, fw, vis)
        return planes, vis, levels, alive, truncated, run

    return core, core_from, deeper


class AdaptivePushHost:
    """Adaptive-push bookkeeping of the wide and hybrid engines: the first
    level's plan (from the batch's seed rows or a checkpoint's frontier,
    on the host) and the core wrappers that thread it into the loop and
    keep its record: ``last_push_levels`` (per level run, whether it took
    the push pass) and ``last_host_syncs``. An engine calls
    :meth:`_install_push` when built with ``adaptive_push``; it needs
    ``_rank``, ``_act``, ``num_planes`` and ``arrs``."""

    _push = None
    _push_plan0 = None
    last_push_levels = None

    def _install_push(self, hit_of, push: AdaptivePush) -> None:
        self._push = push
        settle, self._step = make_adaptive_level(hit_of, push)
        self._push_loop = make_adaptive_packed_loop(self._call_step, hit_of, settle, push,
                                                    self.num_planes)
        self._core, self._core_from, self._deeper = (
            self._adaptive_core, self._adaptive_core_from, self._push_loop[2])

    def _note_push_sources(self, sources) -> None:
        """The first level's plan of a fresh batch, from its seed rows."""
        if self._push is not None:
            self._push_plan0 = self._push.host_plan(
                np.asarray(self._rank)[np.asarray(sources, dtype=np.int64)])

    def _note_push_frontier(self, real: np.ndarray) -> None:
        """The first level's plan of a resumed batch, from its checkpoint's
        real-id [V, w] frontier."""
        if self._push is not None:
            live = np.flatnonzero(real.any(axis=1))
            self._push_plan0 = self._push.host_plan(np.asarray(self._rank)[live])

    def _note_push_plan(self, plan: PushPlan) -> None:
        """The next level's plan, from a caller that stepped the loop itself."""
        self._push_plan0 = plan

    def _take_push_plan0(self, arrs, fw) -> PushPlan:
        """The noted plan, consumed; without one, the frontier's plan read
        from the device (one extra read, for a caller that noted nothing)."""
        plan, self._push_plan0 = self._push_plan0, None
        if plan is None:
            plan = self._push.plan_of(self._push.probe(arrs, fw)[1].tolist())
        return plan

    def _adaptive_core(self, arrs, fw0, max_levels):
        planes, vis, levels, alive, truncated, run = self._push_loop[0](
            arrs, fw0, max_levels, self._take_push_plan0(arrs, fw0))
        self._record_push(run)
        return planes, vis, levels, alive, truncated

    def _adaptive_core_from(self, arrs, fw, vis, planes, level0, max_levels):
        fw, vis, planes, level, alive, run = self._push_loop[1](
            arrs, fw, vis, planes, level0, max_levels, self._take_push_plan0(arrs, fw))
        self._record_push(run)
        return fw, vis, planes, level, alive

    def _record_push(self, run: AdaptiveRun) -> None:
        self.last_push_levels = run.pushed
        self.last_host_syncs = run.syncs


def seed_scatter_args(rows_of_sources: np.ndarray, act: int):
    """Host (rows, words, bits) of word-major lane seeding; entries without a
    row (>= ``act``: isolated sources) get a zero bit at row 0, and the
    result assembly patches their lanes on the host."""
    ranks = np.asarray(rows_of_sources).astype(np.int64)
    lanes = np.arange(len(ranks), dtype=np.int64)
    keep = ranks < act
    bits = np.where(keep, np.left_shift(1, lanes % 32), 0).astype(np.uint32)
    return np.where(keep, ranks, 0), lanes // 32, bits.view(np.int32)


def _or_rows(t: torch.Tensor) -> torch.Tensor:
    """[n, w] int32 -> [w]: the bitwise OR over the rows (bitwise OR has no
    torch reduction), as a halving tree: the first step folds the rows
    past the largest power of two below n onto the first ones, the rest
    halve. Zero for no rows."""
    n = t.shape[0]
    if n == 0:
        return t.new_zeros(t.shape[1])
    if n > 1:
        h = 1 << ((n - 1).bit_length() - 1)  # h < n <= 2h
        t = t[: n - h] | t[h:n] if n == 2 * h else torch.cat([t[: n - h] | t[h:n], t[n - h: h]])
        while h > 1:
            h //= 2
            t = t[:h] | t[h:]
    return t[0]


def make_state_kernels(v: int, rows: int, w: int, num_planes: int, *,
                       active: int | None = None,
                       in_deg_host: np.ndarray | None = None,
                       device=None):
    """``(seed, lane_stats, extract_word, lane_ecc, in_deg)`` over a [rows,
    w] table whose first ``act`` rows are real vertices in rank order;
    ``in_deg`` is the [act] int32 device in-degree table that
    ``lane_stats(vis, in_deg)`` takes (None without ``in_deg_host``).

    Every table comes in as an argument (``extract_word``'s word column
    ``wi`` as a 0-d device tensor, the engine's ``_word(wi)``), so each
    function exports as a program that holds no table
    (:func:`packed_aot_programs`). The lane
    reductions loop over the 32 lane bits of a word, a fixed 32 steps over
    the whole [act, w] table, so a program's size does not grow with the
    graph. ``lane_stats`` sums degrees in int64 directly (the JAX package
    sums int32 row blocks because the TPU has no int64); the totals are
    equal."""
    act = v if active is None else min(active, v)
    in_deg = (
        None if in_deg_host is None
        else torch.from_numpy(np.asarray(in_deg_host[:act], dtype=np.int32)).to(device)
    )
    shifts = torch.arange(32, dtype=torch.int32, device=device)

    def seed(rws, words, bits):
        fw0 = torch.zeros((rows, w), dtype=torch.int32, device=device)
        # Distinct lanes own distinct (word, bit) pairs, so the scatter-add is
        # an OR; lane bit 31 is negative in int32 and still adds its bit.
        fw0.index_put_((rws, words), bits, accumulate=True)
        return fw0

    def lane_stats(vis, in_deg):
        """Per-lane reached count and degree sum, [w, 32] int64 each (a
        degree times a 0/1 bit fits int32; the sums are taken in int64)."""
        if in_deg is None:
            raise ValueError("make_state_kernels needs in_deg_host for lane_stats")
        v, deg_col = vis[:act], in_deg[:, None]
        reached, deg = [], []
        for b in range(32):
            bit = (v >> b) & 1  # [act, w]
            reached.append(bit.sum(0, dtype=torch.int64))
            deg.append((bit * deg_col).sum(0, dtype=torch.int64))
        return torch.stack(reached, 1), torch.stack(deg, 1)

    def extract_word(planes, vis, src_bits, wi):
        """Distances of word-column ``wi``'s 32 lanes as [act, 32] uint8."""
        col = wi.reshape(1)

        def lanes(t):
            return (t[:act].index_select(1, col) >> shifts) & 1  # [act, 32]

        cnt = torch.zeros((act, 32), dtype=torch.uint8, device=device)
        for i, p in enumerate(planes):
            cnt += lanes(p).to(torch.uint8) << i
        visw = lanes(vis) != 0
        srcw = lanes(src_bits) != 0
        unreached = torch.full_like(cnt, int(UNREACHED))
        return torch.where(srcw, torch.zeros_like(cnt), torch.where(visw, cnt + 1, unreached))

    def lane_ecc(planes, vis, src_bits):
        """Per-lane eccentricity (max finite distance) as [w, 32] int32: a
        bit-sliced max over the rows, from the top counter plane down. The
        candidates (visited, not the source) keep only the rows holding a
        plane's bit wherever some candidate holds it, and that plane's OR
        over the rows is the max's bit; no lane is unpacked."""
        cand = vis[:act] & ~src_bits[:act]
        any_cand = _or_rows(cand)
        top = []
        for p in reversed(planes):
            hit = _or_rows(cand & p[:act])
            cand = cand & (p[:act] | ~hit)
            top.append(hit)
        cnt = torch.zeros((w, 32), dtype=torch.int32, device=device)
        for i, hit in enumerate(reversed(top)):
            cnt |= ((hit[:, None] >> shifts) & 1) << i
        return torch.where(((any_cand[:, None] >> shifts) & 1) != 0, cnt + 1, 0)

    return seed, lane_stats, extract_word, lane_ecc, in_deg


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
            dr = eng._extract_word(self._planes, self._vis, self._src_bits,
                                   eng._word(wi)).cpu().numpy()
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
        cols = [eng._extract_word(self._planes, self._vis, self._src_bits, eng._word(wi))
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

    A scanner over device tables the engine lends (the wide engine's own,
    no extra device memory; the mesh wide engine's full ELL, built for the
    scan and kept) is cached on the engine. One that built and moved
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
                            elapsed, iso_override=None) -> PackedBatchResult:
    """Lane stats on the device, isolated-lane patching, and the level count
    (the last level found an empty frontier iff not alive). ``iso_override``
    (a checkpoint's recorded isolated lanes) wins over the engine's own."""
    s = len(sources)
    r, d = engine._lane_stats(vis, engine._in_deg)
    reached = r.cpu().numpy().reshape(-1)[:s].astype(np.int64)
    slot_sum = d.cpu().numpy().reshape(-1)[:s]
    edges = slot_sum // 2 if engine.undirected else slot_sum
    iso = engine._iso_of(sources) if iso_override is None else iso_override
    # The distributed wide engine seeds a table of another row order than
    # its result tables; its view converts.
    src_bits = getattr(engine, "_src_bits_view", lambda t: t)(src_bits)
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


def _engine_dispatch_lock(engine) -> threading.Lock:
    """The engine's dispatch lock: the serve tier may dispatch on one
    engine from two threads (the scheduler, and the extraction worker
    re-dispatching after a transient failure), and the pull gate's
    batch-scoped lane mask must bind to its own batch's level loop.
    ``dict.setdefault`` is atomic, so racers agree on one lock."""
    lock = engine.__dict__.get("_dispatch_lock")
    if lock is None:
        lock = engine.__dict__.setdefault("_dispatch_lock", threading.Lock())
    return lock


def dispatch_packed_batch(engine, sources, *, max_levels: int | None = None) -> PackedDispatch:
    """Seed and run one packed batch."""
    if faults.ACTIVE is not None:
        # The fault injection site "dispatch" (tpu_bfs_torch/faults.py).
        faults.ACTIVE.hit("dispatch", lanes=engine.lanes,
                          devices=faults.mesh_devices(engine))
    sources = _check_batch_sources(engine, sources)
    cap = engine.max_levels_cap
    max_levels = cap if max_levels is None else min(max_levels, cap)
    with _engine_dispatch_lock(engine):
        engine._note_batch_sources(sources)  # the pull gate's lane mask
        engine._note_push_sources(sources)  # the adaptive push's first plan
        fw0 = engine._seed_dev(sources)
        t0 = time.perf_counter()
        planes, vis, levels, alive, truncated = engine._core(engine.arrs, fw0, max_levels)
    return PackedDispatch(
        sources=sources, fw0=fw0, planes=planes, vis=vis, levels=levels,
        alive=alive, truncated=truncated, max_levels=max_levels, t0=t0,
    )


def check_not_truncated(engine, pend: PackedDispatch) -> None:
    """Raise when the batch stopped at the engine's depth cap with levels
    still to claim (a bound below the cap stops by request)."""
    if pend.truncated and pend.max_levels == engine.max_levels_cap:
        raise RuntimeError(
            f"traversal truncated at {pend.levels} levels; "
            f"num_planes={engine.num_planes} caps at {engine.max_levels_cap} "
            "- construct the engine with more planes for this graph"
        )


def fetch_packed_batch(engine, pend: PackedDispatch, *, check_cap: bool = True,
                       time_it: bool = False) -> PackedBatchResult:
    """Check the depth cap and assemble the batch's result."""
    if faults.ACTIVE is not None:
        # The fault injection site "fetch": slow_extract sleeps here.
        faults.ACTIVE.hit("fetch", lanes=engine.lanes,
                          devices=faults.mesh_devices(engine))
    if time_it and pend.vis.device.type == "cuda":
        torch.cuda.synchronize(pend.vis.device)
    elapsed = (time.perf_counter() - pend.t0) if time_it else None
    engine._warmed = True
    if check_cap:
        check_not_truncated(engine, pend)
    result = _assemble_packed_result(
        engine, pend.sources, pend.planes, pend.vis, pend.fw0, pend.levels,
        pend.alive, elapsed,
    )
    if _obs.ACTIVE is not None and engine.records_run_trace:
        # The trace copies the gate counters off the device: behind the
        # ACTIVE guard, a disarmed fetch pays this one attribute check.
        from tpu_bfs_torch.obs.engine_trace import record_packed_run

        record_packed_run(engine, pend.levels, recorder=_obs.ACTIVE)
    return result


def run_packed_batch(engine, sources, *, max_levels: int | None = None,
                     time_it: bool = False, check_cap: bool = True) -> PackedBatchResult:
    """One dispatch immediately fetched; ``time_it`` warms up first (the
    first CUDA call builds and loads the kernels)."""
    if time_it and not engine._warmed:
        dispatch_packed_batch(engine, sources, max_levels=max_levels)
    pend = dispatch_packed_batch(engine, sources, max_levels=max_levels)
    return fetch_packed_batch(engine, pend, check_cap=check_cap, time_it=time_it)


def packed_table_to_real(engine, table: torch.Tensor) -> np.ndarray:
    """Engine-layout [rows, w] int32 table -> real-vertex-id [V, w] uint32
    host array, the checkpoints' layout. Rows of isolated vertices (no
    table row) come out all-zero, their live content. A mesh engine's rank
    holds only its own rows: its ``_gather_rows`` assembles the table."""
    gather = getattr(engine, "_gather_rows", None)
    t = (table if gather is None else gather(table)).cpu().numpy().view(np.uint32)
    real = np.zeros((engine.num_vertices, engine.w), np.uint32)
    m = engine._rank < engine._act
    real[m] = t[engine._rank[m]]
    return real


def packed_real_to_host_table(engine, real: np.ndarray) -> np.ndarray:
    """Real-vertex-id [V, w] checkpoint array -> engine-layout [rows, w]
    uint32 host table (pad and sentinel rows zero)."""
    if real.shape != (engine.num_vertices, engine.w):
        raise ValueError(
            f"checkpoint table is {real.shape}, engine expects "
            f"({engine.num_vertices}, {engine.w}) — lane count and graph "
            "must match the engine the checkpoint resumes on"
        )
    t = np.zeros((engine._table_rows, engine.w), np.uint32)
    m = engine._rank < engine._act
    t[engine._rank[m]] = real[m]
    return t


def packed_real_to_table(engine, real: np.ndarray) -> torch.Tensor:
    """Real-vertex-id [V, w] checkpoint array -> engine-layout [rows, w]
    int32 tensor on the engine's device (the same bits)."""
    return _device_table(engine, packed_real_to_host_table(engine, real))


def _device_table(engine, table: np.ndarray) -> torch.Tensor:
    """A host engine-layout table on the device; a mesh rank keeps its own
    rows (``_own_rows``)."""
    own = getattr(engine, "_own_rows", None)
    if own is not None:
        table = own(table)
    return torch.from_numpy(np.ascontiguousarray(table).view(np.int32)).to(engine.device)


def _fw_hooks(engine):
    """The frontier's real-id conversions: the distributed wide engine's
    loop carries a replicated rank-order frontier, unlike its visited and
    plane tables, and converts it with ``_fw_table_from_real`` and
    ``_fw_real_from_table``; every other engine as its other tables."""
    to_fw = getattr(engine, "_fw_table_from_real", None) or (
        lambda real: packed_real_to_table(engine, real))
    from_fw = getattr(engine, "_fw_real_from_table", None) or (
        lambda table: packed_table_to_real(engine, table))
    return to_fw, from_fw


def start_packed_batch(engine, sources):
    """Level-0 state of a packed batch as a host checkpoint: frontier and
    visited tables and zero counter planes, in real-vertex-id row order,
    and the isolated lanes (so any finishing engine can patch them)."""
    from tpu_bfs_torch.utils.checkpoint import PackedCheckpoint, _new_nonce

    sources = _check_batch_sources(engine, sources)
    seed_view = getattr(engine, "_src_bits_view", lambda t: t)
    seed_real = packed_table_to_real(engine, seed_view(engine._seed_dev(sources)))
    planes = np.zeros((engine.num_planes, engine.num_vertices, engine.w), np.uint32)
    return PackedCheckpoint(
        sources=sources, level=0, alive=True, frontier=seed_real,
        visited=seed_real.copy(), planes=planes,
        iso=np.asarray(engine._iso_of(sources), dtype=bool), nonce=_new_nonce(),
    )


def advance_packed_batch(engine, ckpt, levels: int | None = None):
    """Run at most ``levels`` more levels from a packed checkpoint. The loop
    state is restored exactly, so chunked advancing labels the same
    distances, bit for bit, as one uninterrupted run."""
    from tpu_bfs_torch.utils.checkpoint import PackedCheckpoint

    if ckpt.planes.shape[0] != engine.num_planes:
        raise ValueError(
            f"checkpoint has {ckpt.planes.shape[0]} planes, engine has {engine.num_planes}"
        )
    if not ckpt.alive:
        return ckpt
    engine._note_batch_sources(ckpt.sources)
    cap = engine.max_levels_cap
    ml = min(ckpt.level + levels, cap) if levels is not None else cap
    # visited converts first: it raises the descriptive lane-count/graph error.
    vis_host = packed_real_to_host_table(engine, ckpt.visited)
    engine._note_resume_state(vis_host)
    vis = _device_table(engine, vis_host)
    planes = tuple(packed_real_to_table(engine, p) for p in ckpt.planes)
    engine._note_push_frontier(ckpt.frontier)
    to_fw, from_fw = _fw_hooks(engine)
    fw = to_fw(ckpt.frontier)
    # The chain identity of the mesh engines' exchange accounting.
    engine._pending_chain_nonce = ckpt.nonce
    fw, vis, planes, level, alive = engine._core_from(engine.arrs, fw, vis, planes,
                                                      ckpt.level, ml)
    if alive and level >= cap:
        # At the plane cap with the last level still claiming: an
        # eccentricity exactly at the cap claims nothing more and ends
        # cleanly (level cap + 1, not alive, as an uninterrupted run counts
        # it); anything else is a truncation, which must raise rather than
        # let a caller's advance loop spin at a level that cannot move. The
        # check is claim-free, so the tables stay those of the run.
        if engine._deeper(engine.arrs, fw, vis):
            raise RuntimeError(
                f"traversal truncated at {cap} levels; num_planes={engine.num_planes} "
                f"caps at {cap} — construct the engine with more planes for this graph"
            )
        level, alive = level + 1, False
    return PackedCheckpoint(
        sources=ckpt.sources, level=int(level), alive=bool(alive),
        frontier=from_fw(fw),
        visited=packed_table_to_real(engine, vis),
        planes=np.stack([packed_table_to_real(engine, p) for p in planes]),
        iso=ckpt.iso, nonce=ckpt.nonce,
    )


def finish_packed_batch(engine, ckpt) -> PackedBatchResult:
    """A (finished or partial) packed checkpoint as a batch result, with the
    same lazy extraction as a direct run; the checkpoint's recorded
    isolated lanes are patched."""
    sources = _check_batch_sources(engine, ckpt.sources)
    vis = packed_real_to_table(engine, ckpt.visited)
    planes = tuple(packed_real_to_table(engine, p) for p in ckpt.planes)
    return _assemble_packed_result(
        engine, sources, planes, vis, engine._seed_dev(sources), ckpt.level,
        ckpt.alive, None, iso_override=ckpt.iso,
    )


def packed_layout(engine, spec: ExpandSpec, **extra) -> dict:
    """The engine's static layout (``aot_layout()``, checked by the AOT
    store through ``utils/aot.layout_digest``): every Python constant its
    programs bake in, which no argument shape shows. The expansion's bucket
    boundaries (a bucket's real rows, sliced out of its 128-row-padded
    output), heavy section and tail rows, the active and table rows, the
    vertex count, words and planes, and the engine's own (``extra``). A
    compaction that moves vertices between buckets keeps every table's
    padded shape but changes this."""
    def plain(x):
        return [plain(v) for v in x] if isinstance(x, (tuple, list)) else int(x)

    return {"expand": plain(spec), "act": int(engine._act),
            "table_rows": int(engine._table_rows),
            "num_vertices": int(engine.num_vertices), "w": int(engine.w),
            "planes": int(engine.num_planes), **{k: int(v) for k, v in extra.items()}}


def packed_aot_programs(engine):
    """The serving-path program inventory of the single-device packed
    engines (the JAX ``packed_aot_programs``, under its names): ``core``,
    one level step (``_step``: :func:`level_step`, the gated
    :func:`make_gated_level` step carrying the lane mask when
    ``pull_gate``, the adaptive engine's pull step); ``seed``;
    ``lane_stats``; ``extract_word``; ``lane_ecc``. Each is ``(name, attr,
    fn, example_args)``: the engine attribute it lives on, the callable (the
    original under an adopted program), and example arguments, the engine's
    own tables (``arrs``, the in-degree table) and :class:`ArgSpec` shapes
    for the state tables, so the export shapes are the serving shapes (the
    executor pads every dispatch to ``lanes`` sources) and no table is a
    constant of a program. The level loop stays on the host: its one read a
    level decides whether to step again."""
    dev, lanes = engine.device, engine.lanes
    table = ArgSpec((engine._table_rows, engine.w), torch.int32, dev)
    planes = (table,) * engine.num_planes

    def orig(attr):
        fn = getattr(engine, attr)
        return getattr(fn, "_aot_original", fn)

    if engine.pull_gate:
        needed = ArgSpec((engine._gate_needed_rows,), torch.bool, dev)
        lane_mask = ArgSpec((engine.w,), torch.int32, dev)
        core_args = (engine.arrs, table, table, planes, needed, lane_mask)
    else:
        core_args = (engine.arrs, table, table, planes)
    return [
        ("core", "_step", orig("_step"), core_args),
        ("seed", "_seed", orig("_seed"),
         (ArgSpec((lanes,), torch.int64, dev), ArgSpec((lanes,), torch.int64, dev),
          ArgSpec((lanes,), torch.int32, dev))),
        ("lane_stats", "_lane_stats", orig("_lane_stats"), (table, engine._in_deg)),
        ("extract_word", "_extract_word", orig("_extract_word"),
         (planes, table, table, ArgSpec((), torch.int64, dev))),
        ("lane_ecc", "_lane_ecc", orig("_lane_ecc"), (planes, table, table)),
    ]


class PackedRunProtocol(PullGateHost, AdaptivePushHost, AotProgramProtocol):
    """``run`` / ``dispatch`` / ``fetch`` and checkpoint ``start`` /
    ``advance`` / ``finish`` for every packed engine, plus the shared
    seeding and lane-map hooks, the pull gate's and the adaptive push's
    bookkeeping, and the AOT program inventory (:func:`packed_aot_programs`;
    the mesh engines have none yet).
    ``result_cls`` is the class of a batch's result."""

    result_cls = PackedBatchResult
    #: Whether an armed fetch records ``last_run_trace`` (obs/engine_trace).
    records_run_trace = True
    #: The [act] device in-degree table ``_lane_stats`` takes.
    _in_deg = None
    #: The programs' static layout (:func:`packed_layout`), set at build.
    _aot_layout = None

    def aot_layout(self) -> dict:
        if self._aot_layout is None:
            raise NotImplementedError(f"{type(self).__name__} has no AOT layout")
        return self._aot_layout

    def export_programs(self):
        if not hasattr(self, "_step"):
            # The mesh engines step their own loops, collectives inside: no
            # inventory yet (utils/aot.MESH_AOT_ITEM).
            return super().export_programs()
        return packed_aot_programs(self)

    def _call_step(self, *args):
        """One level through ``_step``, read anew each call: an adopted
        program installed over ``_step`` takes over the loop."""
        return self._step(*args)

    def _word(self, wi: int) -> torch.Tensor:
        """Word column ``wi`` as a 0-d device tensor (a view of a cached
        arange), the form ``_extract_word``'s program takes."""
        ids = self.__dict__.get("_word_ids")
        if ids is None:
            ids = self.__dict__.setdefault(
                "_word_ids", torch.arange(self.w, device=self.device))
        return ids[wi]

    def start(self, sources):
        """Level-0 batch state as a host checkpoint (real-id rows)."""
        return start_packed_batch(self, sources)

    def advance(self, ckpt, levels: int | None = None):
        """At most ``levels`` more levels; bit-identical to no stop."""
        return advance_packed_batch(self, ckpt, levels)

    def finish(self, ckpt):
        """A (finished or partial) checkpoint as a batch result."""
        return finish_packed_batch(self, ckpt)

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
