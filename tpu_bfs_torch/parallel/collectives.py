"""Row-gather frontier exchanges of the packed mesh engines, the port of the
parts of ``tpu_bfs/parallel/collectives.py`` that ``DistWideMsBfsEngine``
and ``DistHybridMsBfsEngine`` use.

JAX picks an exchange on the device: a ``pmax`` of the new-frontier row
count feeds a ``lax.cond`` ladder (``cap_ladder_select``), so every chip
takes the same branch. Here the host steers: the engines read the row
count once a level, in the same ``all_reduce`` as the ``alive`` flag, and
:func:`cap_ladder_select` turns it into the branch every rank runs. The
per-branch level counts, their byte model and the chained checkpoint
accounting are the JAX package's, rung for rung. The delta-encoded id
stream (``delta_bits``) is not ported (ROADMAP Queue 1 item 3).
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


def record_row_gather_exchange(prev, branch_counts, resumed_level: int, *, exchange: str,
                               p: int, rows_loc: int, w: int, caps):
    """``(counts, bytes)``: the chained per-branch level counts and their
    modeled bytes (the dense exchange has the one slab entry). A
    truncation probe's extra gather is not counted, as in JAX."""
    counts = merge_exchange_counts(prev, branch_counts, resumed_level)
    if exchange == "sparse":
        per = sparse_rows_wire_bytes_per_level(p, rows_loc, w, caps)
    else:
        per = [dense_rows_wire_bytes(p, rows_loc, w)]
    return counts, float(np.dot(counts, per))


class RowGatherExchangeAccounting:
    """Exchange bookkeeping of the packed mesh engines. Hosts set
    ``_exchange``, ``sparse_caps``, ``w``, ``_gather_p`` and
    ``_gather_rows_loc``; ``_record_exchange`` keeps
    ``last_exchange_level_counts`` ([branches] int32, levels per branch)
    and ``last_exchange_bytes`` (modeled, per rank). The host knows the
    counts when the loop ends, so recording is immediate."""

    last_exchange_level_counts = None
    last_exchange_bytes = None
    _exchange_chain_nonce = None

    def _record_exchange(self, branch_counts, resumed_level: int, chain_nonce=None) -> None:
        prev = chained_prev_counts(self.last_exchange_level_counts, resumed_level,
                                   self._exchange_chain_nonce, chain_nonce)
        self._exchange_chain_nonce = chain_nonce
        self.last_exchange_level_counts, self.last_exchange_bytes = record_row_gather_exchange(
            prev, branch_counts, resumed_level, exchange=self._exchange, p=self._gather_p,
            rows_loc=self._gather_rows_loc, w=self.w, caps=self.sparse_caps)

    def exchange_branch_labels(self) -> list[str] | None:
        """Labels aligned with the counters (None for the dense exchange)."""
        if self._exchange != "sparse":
            return None
        return rows_gather_branch_labels(self.sparse_caps)

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
