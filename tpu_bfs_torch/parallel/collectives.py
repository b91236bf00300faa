"""Frontier exchanges of the mesh engines, the port of
``tpu_bfs/parallel/collectives.py``: the row gathers of
``DistWideMsBfsEngine`` and ``DistHybridMsBfsEngine``, and the unpacked
OR and MIN reduce-scatters and the queue-style sparse OR exchange of the
single-source engines (``DistBfsEngine``, ``Dist2DBfsEngine``).

JAX picks an exchange on the device: a ``pmax`` of a population count
feeds a ``lax.cond`` ladder (``cap_ladder_select``), so every chip takes
the same branch. Here the host steers: it reads the ``all_reduce``'d count
and :func:`cap_ladder_select` turns it into the branch every rank runs.
The per-branch level counts, their byte models and the chained checkpoint
accounting are the JAX package's, rung for rung.

NCCL has no bitwise-OR reduction, and none is needed: the unpacked OR
exchanges reduce with SUM (the ``allreduce`` form, as in JAX) or OR
locally after point-to-point hops (``ring``), and the parent merge uses
MIN. The packed (``wire_pack``), delta-encoded (``delta_bits``), sieved
and predicted forms are not ported (ROADMAP Queue 1 item 3.5).
"""



from __future__ import annotations

import numpy as np
import torch


def normalize_caps(caps) -> tuple[int, ...]:
    """The canonical cap ladder: ascending and deduplicated, so the branch
    indices, byte models and counters agree on one rung list."""
    return tuple(sorted({int(c) for c in caps}))


def cap_ladder_select(biggest: int, caps) -> int:
    """The branch of a level whose largest per-rank row count is
    ``biggest``: the position of the smallest rung that covers it, or
    ``len(caps)`` (the dense slab) when every rung overflows."""
    ladder = normalize_caps(caps)
    for idx, cap in enumerate(ladder):
        if biggest <= cap:
            return idx
    return len(ladder)


def rows_gather_branch_count(caps) -> int:
    """Branches of :func:`sparse_rows_gather`: one per rung, plus dense."""
    return len(normalize_caps(caps)) + 1


def rows_gather_branch_labels(caps) -> list[str]:
    """Labels of the branches, index-aligned with the counters."""
    return [f"sparse[{c}]" for c in normalize_caps(caps)] + ["dense"]


def default_row_gather_caps(rows_loc: int, w: int) -> tuple[int, ...]:
    """Two rungs, half and a sixteenth of the break-even row count: a
    gathered row costs a 4-byte id and 4w payload bytes against the dense
    slab's 4w a row, so ids win below rows_loc*32w/(32w + 32) rows."""
    be = (rows_loc * 32 * w) // (32 * w + 32)
    return tuple(sorted({max(1, be // 16), max(1, be // 2)}))


def dense_rows_wire_bytes(p: int, rows_loc: int, w: int) -> float:
    """Bytes one rank moves a level gathering every peer's [rows_loc, w]
    int32 slab (the dense exchange, and the sliced layout's P-1 ring hops)."""
    return 0.0 if p == 1 else float((p - 1) * rows_loc * 4 * w)


def sparse_rows_wire_bytes_per_level(p: int, rows_loc: int, w: int, caps) -> list[float]:
    """Modeled bytes one rank moves a level for each branch of
    :func:`sparse_rows_gather`, in label order: per rung ``c`` ids and rows
    from every peer plus the 4-byte count, and the dense slab plus it."""
    nb = rows_gather_branch_count(caps)
    if p == 1:
        return [0.0] * nb
    return [float((p - 1) * c * (4 + 4 * w) + 4) for c in normalize_caps(caps)] + [
        dense_rows_wire_bytes(p, rows_loc, w) + 4.0]


def merge_exchange_counts(prev, counts, resumed_level: int):
    """Per-branch level counts of one checkpointed traversal, chunk after
    chunk: ``prev`` joins only when it covers exactly the levels before
    ``resumed_level`` and has the same branch space; else the count
    restarts with this chunk."""
    counts = np.asarray(counts)
    if resumed_level > 0 and prev is not None:
        prev = np.asarray(prev)
        if prev.shape == counts.shape and prev.sum() == resumed_level:
            return counts + prev
    return counts


def chained_prev_counts(prev, resumed_level: int, prev_nonce, nonce):
    """``prev`` if it belongs to the chain being resumed (the engine last
    recorded under the checkpoint's nonce), else None."""
    if resumed_level > 0 and (nonce is None or prev_nonce != nonce):
        return None
    return prev


class ExchangeAccounting:
    """Exchange bookkeeping of the mesh engines. Hosts set ``_exchange`` and
    ``sparse_caps`` and define ``wire_bytes_per_level``; ``_record_exchange``
    keeps ``last_exchange_level_counts`` (levels per branch, chained over a
    checkpointed traversal's chunks) and ``last_exchange_bytes`` (modeled,
    one rank). The host knows the counts when the loop ends, so recording
    is immediate. A truncation probe's extra exchange is not counted, as in
    JAX."""

    last_exchange_level_counts = None
    last_exchange_bytes = None
    _exchange_chain_nonce = None

    def _record_exchange(self, branch_counts, resumed_level: int = 0,
                         chain_nonce=None) -> None:
        prev = chained_prev_counts(self.last_exchange_level_counts, resumed_level,
                                   self._exchange_chain_nonce, chain_nonce)
        self._exchange_chain_nonce = chain_nonce
        counts = merge_exchange_counts(prev, branch_counts, resumed_level)
        self.last_exchange_level_counts = counts
        self.last_exchange_bytes = float(np.dot(counts, self.wire_bytes_per_level()))

    def exchange_branch_labels(self) -> list[str] | None:
        """Labels aligned with the counters (None for the dense exchanges)."""
        if self._exchange != "sparse":
            return None
        return rows_gather_branch_labels(self.sparse_caps)


class RowGatherExchangeAccounting(ExchangeAccounting):
    """The packed mesh engines' accounting: hosts also set ``w``,
    ``_gather_p`` and ``_gather_rows_loc``."""

    def wire_bytes_per_level(self) -> list[float]:
        """Modeled bytes a level for each branch, aligned with the labels."""
        if self._exchange == "sparse":
            return sparse_rows_wire_bytes_per_level(
                self._gather_p, self._gather_rows_loc, self.w, self.sparse_caps)
        return [dense_rows_wire_bytes(self._gather_p, self._gather_rows_loc, self.w)]


def nonzero_rows(t: torch.Tensor) -> torch.Tensor:
    """The number of rows of ``t`` holding a set bit (a device int32 scalar)."""
    return (t != 0).any(dim=1).sum(dtype=torch.int32)


def sparse_rows_gather(mesh, nxt: torch.Tensor, *, cap: int, out_rows: int, gid_of):
    """One rung of the queue-style row gather: every rank's (global row id,
    row words) pairs for its at most ``cap`` nonzero rows of ``nxt``
    [rows_loc, w], written into a zeroed [out_rows + 1, w] table.

    ``gid_of(ids)`` maps local row ids to global table rows. Slots past a
    rank's rows carry the id ``out_rows`` and a zero row, so they all land
    on the table's extra last row, which stays zero: no duplicate id ever
    names a real row (each global row belongs to one rank). Callers slice
    the table to ``out_rows`` rows, or keep the zero row as a sentinel."""
    rows_loc, w = nxt.shape
    dev = nxt.device
    any_row = (nxt != 0).any(dim=1)
    pos = torch.cumsum(any_row, dim=0, dtype=torch.int32) - 1
    slot = torch.where(any_row & (pos < cap), pos, cap)
    ids = torch.full((cap + 1,), rows_loc, dtype=torch.int64, device=dev)
    ids[slot.long()] = torch.arange(rows_loc, dtype=torch.int64, device=dev)
    ids = ids[:cap]
    ok = ids < rows_loc
    vals = nxt.index_select(0, torch.where(ok, ids, 0))
    vals *= ok[:, None].to(vals.dtype)
    gids = torch.where(ok, gid_of(ids), out_rows)
    ag_ids = mesh.all_gather_rows(gids)
    ag_vals = mesh.all_gather_rows(vals)
    table = torch.zeros((out_rows + 1, w), dtype=nxt.dtype, device=dev)
    table.index_copy_(0, ag_ids, ag_vals)
    return table


# --- the single-source exchanges --------------------------------------------


def planner_unported(knob: str) -> NotImplementedError:
    """The refusal of an exchange-planner knob the port does not have."""
    return NotImplementedError(
        f"{knob} (the packed, delta, sieve and predict exchange forms) is not "
        "ported to tpu_bfs_torch yet (ROADMAP Queue 1 item 3.5)"
    )


def check_planner_knobs(*, wire_pack=False, delta_bits=(), sieve=False,
                        predict=False) -> None:
    """Raise :func:`planner_unported` for the first knob that is on."""
    for name, on in (("wire_pack", wire_pack), ("delta_bits", delta_bits),
                     ("sieve", sieve), ("predict", predict)):
        if on:
            raise planner_unported(name)


def _check_impl(impl: str) -> None:
    if impl not in ("ring", "allreduce"):
        raise ValueError(
            f"unknown reduce-scatter impl {impl!r}; have 'ring', 'allreduce' "
            "(the queue-style exchange is sparse_exchange_or, wired only "
            "through engines that accept exchange='sparse')"
        )


def ring_reduce_scatter(x_full: torch.Tensor, mesh, op) -> torch.Tensor:
    """Reduce-scatter ``x_full`` ([P*n] on each rank) down to this rank's
    [n] chunk, combining with ``op`` around a ring of P - 1 shifts.

    After s steps rank i holds the partial reduction of chunk (i - 1 - s)
    mod P over ranks i - s .. i; after P - 1 steps, chunk i's whole
    reduction. Bool chunks travel as bytes, one a vertex, as JAX's PRED."""
    p = mesh.num_shards
    if p == 1:
        return x_full
    n = x_full.shape[0] // p
    i = mesh.rank
    chunks = x_full.view(p, n)
    as_bytes = x_full.dtype == torch.bool
    acc = chunks[(i - 1) % p]
    for s in range(1, p):
        got = mesh.ring_shift(acc.view(torch.uint8) if as_bytes else acc)
        acc = op(got.view(torch.bool) if as_bytes else got, chunks[(i - 1 - s) % p])
    return acc


def reduce_scatter_or(x_full: torch.Tensor, mesh, *, impl: str = "ring") -> torch.Tensor:
    """OR-reduce-scatter of a bool contribution buffer [P*n]: this rank's
    [n] chunk. ``ring`` ships one byte a vertex a hop; ``allreduce`` is
    JAX's form, an int32 SUM over the whole buffer, then ``> 0`` on the
    rank's chunk (four bytes a vertex)."""
    _check_impl(impl)
    if impl == "ring":
        return ring_reduce_scatter(x_full, mesh, torch.logical_or)
    n = x_full.shape[0] // mesh.num_shards
    summed = mesh.all_reduce_(x_full.to(torch.int32), "sum")
    return summed[mesh.rank * n : (mesh.rank + 1) * n] > 0


def reduce_scatter_min(x_full: torch.Tensor, mesh, *, impl: str = "ring") -> torch.Tensor:
    """MIN-reduce-scatter of an int32 buffer [P*n] (the parent merge, the
    analog of the reference's elementwise min result merge,
    bfs.cu:426-438): ``ring`` with ``minimum``, or an ``all_reduce`` MIN."""
    _check_impl(impl)
    if impl == "ring":
        return ring_reduce_scatter(x_full, mesh, torch.minimum)
    n = x_full.shape[0] // mesh.num_shards
    m = mesh.all_reduce_(x_full.clone(), "min")
    return m[mesh.rank * n : (mesh.rank + 1) * n]


def default_sparse_caps(vloc: int) -> tuple[int, ...]:
    """The two-rung id ladder of :func:`sparse_exchange_or`: against the
    dense ring's vloc bytes a 4-byte id breaks even at vloc/4 ids; the wide
    rung is half of that, the tight one a sixteenth."""
    be = vloc * 8 // 32
    return tuple(sorted({max(16, be // 16), max(16, be // 2)}))


def resolve_sparse_caps(caps, vloc: int) -> tuple[int, ...]:
    """An engine's ``sparse_caps`` argument as a ladder: None is
    :func:`default_sparse_caps` of the ``vloc``-vertex chunk, an int one
    rung."""
    if caps is None:
        return default_sparse_caps(vloc)
    return normalize_caps((caps,) if isinstance(caps, int) else caps)


def sparse_exchange_or(x_full: torch.Tensor, mesh, *, caps):
    """The two-phase queue-style frontier exchange, the form of the
    reference's per-destination buckets (bfs.cu:148-150, peer-copied at
    bfs.cu:604-606). Returns ``(hit [n] bool, branch)``.

    - phase 1: an ``all_reduce`` MAX of the largest per-destination chunk
      popcount (the own chunk excluded: it never crosses the wire), read
      on the host, picks the smallest rung of ``caps`` that covers it;
    - phase 2a (a rung fits): each destination chunk's set bits, compacted
      into a fixed [P, cap] int32 id buffer with the sentinel n, go out in
      one ``all_to_all_single`` and are scattered into the local chunk;
    - phase 2b (every rung overflows): the dense ring.

    ``branch`` is the rung's position in :func:`normalize_caps` order, or
    ``len(caps)`` for the dense fallback. One rank returns ``x_full`` on
    the dense branch with no collective and no read, as JAX does."""
    p = mesh.num_shards
    ladder = normalize_caps(caps)
    if p == 1:
        return x_full, len(ladder)
    n = x_full.shape[0] // p
    i = mesh.rank
    chunks = x_full.view(p, n)
    remote = chunks.clone()
    remote[i] = False
    counts = remote.sum(dim=1, dtype=torch.int64)
    biggest = int(mesh.all_reduce_(counts.max().reshape(1), "max").item())
    branch = cap_ladder_select(biggest, ladder)
    if branch == len(ladder):
        return ring_reduce_scatter(x_full, mesh, torch.logical_or), branch
    cap = ladder[branch]
    dev = x_full.device
    pos = torch.cumsum(remote, dim=1, dtype=torch.int32) - 1
    slot = torch.where(remote, pos, cap).long()  # unset and own bits -> the dump column
    buf = torch.full((p, cap + 1), n, dtype=torch.int32, device=dev)
    buf.scatter_(1, slot, torch.arange(n, dtype=torch.int32, device=dev).expand(p, n))
    recv = mesh.all_to_all(buf[:, :cap].contiguous())
    hit = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    hit[recv.reshape(-1).long()] = True  # the sentinel n lands in the dump slot
    return hit[:n] | chunks[i], branch


def dense_or_wire_bytes(p: int, n: int, impl: str) -> float:
    """Modeled bytes one rank sends a level in the dense OR exchange:
    ``ring``, P - 1 chunks of n one-byte elements; ``allreduce``, an int32
    [P*n] all-reduce at its bandwidth-optimal 2(P-1)n words. The
    termination count is outside the model, as in JAX."""
    if p == 1:
        return 0.0
    return float(2 * (p - 1) * n * 4 if impl == "allreduce" else (p - 1) * n)


def column_gather_wire_bytes(rows: int, w: int) -> float:
    """Modeled bytes one rank sends a level in the 2D column all-gather:
    its [w] bool slice, rows - 1 times."""
    return 0.0 if rows <= 1 else float((rows - 1) * w)


def dense_2d_wire_bytes(rows: int, cols: int, w: int, impl: str) -> float:
    """The 2D level's modeled bytes: the column all-gather plus the row
    reduce-scatter over the mesh row."""
    return column_gather_wire_bytes(rows, w) + dense_or_wire_bytes(cols, w, impl)


def sparse_wire_bytes_per_level(p: int, n: int, caps) -> list[float]:
    """Modeled bytes a level for each :func:`sparse_exchange_or` branch, in
    branch order: per rung c, P - 1 id chunks of c int32 plus the 4-byte
    phase-1 scalar; the dense ring plus the scalar. One rank moves none."""
    ladder = normalize_caps(caps)
    if p == 1:
        return [0.0] * (len(ladder) + 1)
    return [float((p - 1) * c * 4 + 4) for c in ladder] + [
        dense_or_wire_bytes(p, n, "ring") + 4.0]
