"""Frontier exchanges of the mesh engines, the port of
``tpu_bfs/parallel/collectives.py``: the row gathers of
``DistWideMsBfsEngine`` and ``DistHybridMsBfsEngine``, the OR and MIN
reduce-scatters and the queue-style sparse OR exchange of the
single-source engines (``DistBfsEngine``, ``Dist2DBfsEngine``), the
exchange planner, and the (min, +) value exchanges of ``DistSsspEngine``.

JAX picks an exchange on the device: a ``pmax`` of a population count
feeds a ``lax.cond`` ladder (``cap_ladder_select``), so every chip takes
the same branch. Here the host steers: it reads the ``all_reduce``'d count
and :func:`cap_ladder_select` turns it into the branch every rank runs.
The per-branch level counts, their byte models and the chained checkpoint
accounting are the JAX package's, rung for rung.

NCCL has no bitwise-OR reduction, and none is needed: the unpacked OR
exchanges reduce with SUM (the ``allreduce`` form, as in JAX) or OR
locally after point-to-point hops (``ring``), and the parent merge uses
MIN. The packed wire (``wire_pack``, :func:`pack_bits`) ships 32 vertices
a word: its ring ORs words after each hop, and its ``allreduce`` is one
``all_to_all`` of per-destination word chunks and a local OR fold, as in
JAX (packed words are never summed). Words are int32 here, bit for bit
JAX's uint32 words; ``>>`` is arithmetic, so every decode masks.

The planner (:func:`planned_sparse_exchange_or`) adds delta-encoded ids
(:func:`delta_encode_ids`), a visited sieve and history prediction to the
sparse exchange. Every branch it takes is a function of all-reduced or
carried host values, so every rank (every rank of a 2D mesh row) takes
it; every collective runs outside the per-rank work, in one order.
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


# --- the packed wire format --------------------------------------------------


def packed_words(n: int) -> int:
    """32-bit words that carry ``n`` booleans (32 vertices a word)."""
    return -(-n // 32)


def _shifts(n: int, step: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device) * step


def pack_bits(x: torch.Tensor) -> torch.Tensor:
    """A bool tensor's last axis as int32 words: vertex ``32*j + i`` is bit
    ``i`` of word ``j`` (JAX's uint32 layout, bit 31 the sign here). The
    tail word's unused bits are zero, the identity of OR, so packed chunks
    of several ranks combine with a word OR as the bools would."""
    n = x.shape[-1]
    nw = packed_words(n)
    xb = x.to(torch.int32)
    if nw * 32 != n:
        xb = torch.cat([xb, xb.new_zeros(x.shape[:-1] + (nw * 32 - n,))], dim=-1)
    xb = xb.reshape(x.shape[:-1] + (nw, 32))
    # The bits are disjoint, so the sum is their OR (no carry).
    return (xb << _shifts(32, 1, x.device)).sum(dim=-1, dtype=torch.int32)


def unpack_bits(words: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: int32 words back to ``n`` booleans."""
    nw = words.shape[-1]
    bits = (words[..., None] >> _shifts(32, 1, words.device)) & 1
    return bits.reshape(words.shape[:-1] + (nw * 32,))[..., :n] != 0


def _packed_reduce_scatter_or(x_full: torch.Tensor, mesh, impl: str) -> torch.Tensor:
    """The packed OR-reduce-scatter of both dense impls. ``ring``: each
    destination chunk packed to words, the same P - 1 hops with a word OR.
    ``allreduce``: a SUM of words would carry across bits, and the unpacked
    form only keeps its own chunk of the sum anyway, so it is one
    ``all_to_all`` of the per-destination word chunks and a local OR fold
    (JAX's move)."""
    p = mesh.num_shards
    if p == 1:
        return x_full
    n = x_full.shape[0] // p
    words = pack_bits(x_full.view(p, n))  # [p, nw]
    if impl == "ring":
        out = ring_reduce_scatter(words.reshape(-1), mesh, torch.bitwise_or)
    else:
        recv = mesh.all_to_all(words)
        out = recv[0].clone()
        for j in range(1, p):
            out |= recv[j]
    return unpack_bits(out, n)


# --- the row gathers of the packed mesh engines ------------------------------


def _rung_names(caps, delta_bits) -> list[str]:
    """Per cap c, each delta width then plain ids: the rung labels every
    branch layout is built from."""
    names = []
    for c in normalize_caps(caps):
        names += [f"delta{b}[{c}]" for b in delta_bits]
        names.append(f"sparse[{c}]")
    return names


def rows_gather_branch_count(caps, delta_bits=()) -> int:
    """Branches of :func:`sparse_rows_gather`: per rung each delta width
    then plain ids, plus dense: K*(W+1) + 1."""
    return len(normalize_caps(caps)) * (len(delta_bits) + 1) + 1


def rows_gather_branch_labels(caps, delta_bits=()) -> list[str]:
    """Labels of the branches, index-aligned with the counters."""
    return _rung_names(caps, delta_bits) + ["dense"]


def delta_rung(dmax: int, delta_bits) -> int:
    """The encoding of a rung whose widest id gap is ``dmax``: the position
    of the narrowest delta width that holds it, or ``len(delta_bits)``
    (plain 4-byte ids) when none does."""
    for e, b in enumerate(delta_bits):
        if dmax <= (1 << b) - 1:
            return e
    return len(delta_bits)


def rows_gather_branch(biggest: int, dmax: int, caps, delta_bits=()) -> int:
    """The flat branch of a row exchange whose all-reduced row count and
    id gap are ``biggest`` and ``dmax``: rung ``ri`` and encoding ``e`` at
    ``ri*(W+1) + e``, dense last."""
    w1 = len(delta_bits) + 1
    ri = cap_ladder_select(biggest, caps)
    if ri == len(normalize_caps(caps)):
        return ri * w1
    return ri * w1 + delta_rung(dmax, delta_bits)


def branch_rung(branch: int, caps, delta_bits=()):
    """``(cap, bits)`` of a flat row-exchange branch (``bits`` None for
    plain ids), or None for the dense branch."""
    ladder = normalize_caps(caps)
    ri, e = divmod(branch, len(delta_bits) + 1)
    if ri >= len(ladder):
        return None
    return ladder[ri], (delta_bits[e] if e < len(delta_bits) else None)


def default_row_gather_caps(rows_loc: int, w: int, delta_bits=()) -> tuple[int, ...]:
    """Two rungs, half and a sixteenth of the break-even row count: a
    gathered row costs an id (4 bytes, or min(delta_bits)/8 delta-encoded)
    and 4w payload bytes against the dense slab's 4w a row."""
    id_bits = min(delta_bits) if delta_bits else 32
    be = (rows_loc * 32 * w) // (32 * w + id_bits)
    return tuple(sorted({max(1, be // 16), max(1, be // 2)}))


def dense_rows_wire_bytes(p: int, rows_loc: int, w: int) -> float:
    """Bytes one rank moves a level gathering every peer's [rows_loc, w]
    int32 slab (the dense exchange, and the sliced layout's P-1 ring hops)."""
    return 0.0 if p == 1 else float((p - 1) * rows_loc * 4 * w)


def sparse_rows_wire_bytes_per_level(p: int, rows_loc: int, w: int, caps,
                                     delta_bits=()) -> list[float]:
    """Modeled bytes one rank moves a level for each branch of
    :func:`sparse_rows_gather`, in label order. With no delta ladder each
    branch pays the 4-byte count; with one, the 8-byte (count, gap) pair,
    and a delta rung ships ``delta_words(c, b)`` id words instead of ``c``
    ids (the 4w-byte row payload is the same)."""
    nb = rows_gather_branch_count(caps, delta_bits)
    if p == 1:
        return [0.0] * nb
    if not delta_bits:
        return [float((p - 1) * c * (4 + 4 * w) + 4) for c in normalize_caps(caps)] + [
            dense_rows_wire_bytes(p, rows_loc, w) + 4.0]
    out = []
    for c in normalize_caps(caps):
        out += [float((p - 1) * (4 * delta_words(c, b) + 4 * c * w) + 8) for b in delta_bits]
        out.append(float((p - 1) * c * (4 + 4 * w) + 8))
    return out + [dense_rows_wire_bytes(p, rows_loc, w) + 8.0]


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


def gate_and_stamp_chain(engine, resumed_level: int, chain_nonce):
    """The engine's previous counters gated through
    :func:`chained_prev_counts`, and the engine stamped with the new chain
    nonce: the first step of every ``_record_exchange``."""
    prev = chained_prev_counts(engine.last_exchange_level_counts, resumed_level,
                               getattr(engine, "_exchange_chain_nonce", None), chain_nonce)
    engine._exchange_chain_nonce = chain_nonce
    return prev


class ExchangeAccounting:
    """Exchange bookkeeping of the mesh engines. Hosts set ``_exchange``,
    ``sparse_caps`` and ``delta_bits`` and define ``wire_bytes_per_level``; ``_record_exchange``
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
        prev = gate_and_stamp_chain(self, resumed_level, chain_nonce)
        counts = merge_exchange_counts(prev, branch_counts, resumed_level)
        self.last_exchange_level_counts = counts
        self.last_exchange_bytes = float(np.dot(counts, self.wire_bytes_per_level()))

    def exchange_branch_labels(self) -> list[str] | None:
        """Labels aligned with the counters (None for the dense exchanges)."""
        if self._exchange != "sparse":
            return None
        return rows_gather_branch_labels(self.sparse_caps, self.delta_bits)


class RowGatherExchangeAccounting(ExchangeAccounting):
    """The packed mesh engines' accounting: hosts also set ``w``,
    ``_gather_p``, ``_gather_rows_loc`` and ``delta_bits``."""

    def wire_bytes_per_level(self) -> list[float]:
        """Modeled bytes a level for each branch, aligned with the labels."""
        if self._exchange == "sparse":
            return sparse_rows_wire_bytes_per_level(
                self._gather_p, self._gather_rows_loc, self.w, self.sparse_caps,
                self.delta_bits)
        return [dense_rows_wire_bytes(self._gather_p, self._gather_rows_loc, self.w)]


def row_gather_flags(changed: torch.Tensor, delta_bits=()) -> torch.Tensor:
    """The device int32 values a row exchange's rung is picked from, to be
    all-reduced (MAX) with the level's other flags: the number of rows
    ``changed`` marks and, with a delta ladder, their widest id gap."""
    count = changed.sum(dtype=torch.int32).reshape(1)
    if not delta_bits:
        return count
    return torch.cat([count, max_id_gap(changed[None]).reshape(1)])


def _compact_rows(changed: torch.Tensor, cap: int) -> torch.Tensor:
    """The first ``cap`` row ids ``changed`` marks, ascending, as int64,
    the rest the sentinel ``len(changed)`` (``jnp.nonzero`` with a fill)."""
    rows_loc = changed.shape[0]
    dev = changed.device
    pos = torch.cumsum(changed, dim=0, dtype=torch.int32) - 1
    slot = torch.where(changed & (pos < cap), pos, cap)
    ids = torch.full((cap + 1,), rows_loc, dtype=torch.int64, device=dev)
    ids[slot.long()] = torch.arange(rows_loc, dtype=torch.int64, device=dev)
    return ids[:cap]


def _gathered_row_ids(mesh, ids: torch.Tensor, rows_loc: int, out_rows: int, gid_of,
                      bits, gid_of_src) -> torch.Tensor:
    """Every rank's compacted row ids as global rows, [P * cap] int64, in
    rank order; ``out_rows`` where a slot holds no row. Plain: each rank
    maps its own ids (``gid_of``) and gathers them. Delta (``bits``): each
    rank gathers first-id plus ``bits``-wide deltas of its LOCAL ids, and
    the receiver decodes them and maps each sender's (``gid_of_src(ids,
    src)``); decoded tail duplicates are masked to ``out_rows`` too."""
    ok = ids < rows_loc
    if bits is None:
        return mesh.all_gather_rows(torch.where(ok, gid_of(ids), out_rows))
    cap = ids.shape[0]
    words = delta_encode_ids(ids.to(torch.int32)[None], rows_loc, bits)
    ag = mesh.all_gather_rows(words)  # [P, delta_words(cap, bits)]
    dec, valid = delta_decode_ids(ag, cap, bits)
    dec = dec.long()
    src = torch.arange(ag.shape[0], dtype=torch.int64, device=ids.device)[:, None]
    okd = valid & (dec < rows_loc)
    return torch.where(okd, gid_of_src(dec, src), out_rows).reshape(-1)


def sparse_rows_gather(mesh, nxt: torch.Tensor, *, cap: int, out_rows: int, gid_of,
                       bits: int | None = None, gid_of_src=None):
    """One rung of the queue-style row gather: every rank's (global row id,
    row words) pairs for its at most ``cap`` nonzero rows of ``nxt``
    [rows_loc, w], written into a zeroed [out_rows + 1, w] table.

    ``gid_of(ids)`` maps local row ids to global table rows; with ``bits``
    the ids travel delta-encoded and ``gid_of_src(ids, src)`` maps a
    sender's. Slots past a rank's rows carry the id ``out_rows`` and a zero
    row, so they all land on the table's extra last row, which stays zero:
    no duplicate id ever names a real row (each global row belongs to one
    rank). Callers slice the table to ``out_rows`` rows, or keep the zero
    row as a sentinel."""
    rows_loc, w = nxt.shape
    ids = _compact_rows((nxt != 0).any(dim=1), cap)
    ok = ids < rows_loc
    vals = nxt.index_select(0, torch.where(ok, ids, 0))
    vals *= ok[:, None].to(vals.dtype)
    ag_vals = mesh.all_gather_rows(vals)
    ag_ids = _gathered_row_ids(mesh, ids, rows_loc, out_rows, gid_of, bits, gid_of_src)
    table = torch.zeros((out_rows + 1, w), dtype=nxt.dtype, device=nxt.device)
    table.index_copy_(0, ag_ids, ag_vals)
    return table


# --- the single-source exchanges --------------------------------------------


def _check_impl(impl: str) -> None:
    if impl not in ("ring", "allreduce"):
        raise ValueError(
            f"unknown reduce-scatter impl {impl!r}; have 'ring', 'allreduce' "
            "(the queue-style exchange is sparse_exchange_or, wired only "
            "through engines that accept exchange='sparse')"
        )


def ring_reduce_scatter(x_full: torch.Tensor, mesh, op) -> torch.Tensor:
    """Reduce-scatter ``x_full`` ([P*n, ...] on each rank) down to this
    rank's [n, ...] chunk, combining with ``op`` around a ring of P - 1
    shifts.

    After s steps rank i holds the partial reduction of chunk (i - 1 - s)
    mod P over ranks i - s .. i; after P - 1 steps, chunk i's whole
    reduction. Bool chunks travel as bytes, one a vertex, as JAX's PRED."""
    p = mesh.num_shards
    if p == 1:
        return x_full
    n = x_full.shape[0] // p
    i = mesh.rank
    chunks = x_full.view((p, n) + tuple(x_full.shape[1:]))
    as_bytes = x_full.dtype == torch.bool
    acc = chunks[(i - 1) % p]
    for s in range(1, p):
        got = mesh.ring_shift(acc.view(torch.uint8) if as_bytes else acc)
        acc = op(got.view(torch.bool) if as_bytes else got, chunks[(i - 1 - s) % p])
    return acc


def reduce_scatter_or(x_full: torch.Tensor, mesh, *, impl: str = "ring",
                      wire_pack: bool = False) -> torch.Tensor:
    """OR-reduce-scatter of a bool contribution buffer [P*n]: this rank's
    [n] chunk. ``ring`` ships one byte a vertex a hop; ``allreduce`` is
    JAX's form, an int32 SUM over the whole buffer, then ``> 0`` on the
    rank's chunk (four bytes a vertex). ``wire_pack`` ships 32-bit words,
    32 vertices a word (:func:`_packed_reduce_scatter_or`)."""
    _check_impl(impl)
    if wire_pack:
        return _packed_reduce_scatter_or(x_full, mesh, impl)
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


def default_sparse_caps(vloc: int, *, wire_pack: bool = False,
                        delta_bits=()) -> tuple[int, ...]:
    """The two-rung id ladder of the sparse exchange, calibrated against
    the dense fallback and the id encoding: break-even is dense bytes (vloc,
    or vloc/8 packed) over an id's bytes (4, or min(delta_bits)/8); the wide
    rung is half of it, the tight one a sixteenth."""
    dense_bytes = vloc // 8 if wire_pack else vloc
    entry_bits = min(delta_bits) if delta_bits else 32
    be = dense_bytes * 8 // entry_bits
    return tuple(sorted({max(16, be // 16), max(16, be // 2)}))


def resolve_sparse_caps(caps, vloc: int, *, wire_pack: bool = False,
                        delta_bits=()) -> tuple[int, ...]:
    """An engine's ``sparse_caps`` argument as a ladder: None is
    :func:`default_sparse_caps` of the ``vloc``-vertex chunk, an int one
    rung."""
    if caps is None:
        return default_sparse_caps(vloc, wire_pack=wire_pack, delta_bits=delta_bits)
    return normalize_caps((caps,) if isinstance(caps, int) else caps)


def _dense_or(x_full: torch.Tensor, mesh, wire_pack: bool) -> torch.Tensor:
    """The sparse exchanges' dense fallback: the ring, packed or not."""
    if wire_pack:
        return _packed_reduce_scatter_or(x_full, mesh, "ring")
    return ring_reduce_scatter(x_full, mesh, torch.logical_or)


def _compact_chunks(rem: torch.Tensor, cap: int) -> torch.Tensor:
    """[P, cap] int32: each destination chunk's first ``cap`` set positions
    of ``rem`` [P, n], ascending, then the sentinel n."""
    p, n = rem.shape
    pos = torch.cumsum(rem, dim=1, dtype=torch.int32) - 1
    slot = torch.where(rem & (pos < cap), pos, cap).long()  # the rest -> the dump column
    buf = torch.full((p, cap + 1), n, dtype=torch.int32, device=rem.device)
    buf.scatter_(1, slot, torch.arange(n, dtype=torch.int32, device=rem.device).expand(p, n))
    return buf[:, :cap].contiguous()


def _scatter_hit(ids: torch.Tensor, n: int) -> torch.Tensor:
    """[n] bool with the received ``ids`` set; the sentinel n and decoded
    tail duplicates are harmless (a dump slot, a second set)."""
    hit = torch.zeros(n + 1, dtype=torch.bool, device=ids.device)
    hit[ids.reshape(-1).long()] = True
    return hit[:n]


def sparse_exchange_or(x_full: torch.Tensor, mesh, *, caps, wire_pack: bool = False):
    """The two-phase queue-style frontier exchange, the form of the
    reference's per-destination buckets (bfs.cu:148-150, peer-copied at
    bfs.cu:604-606). Returns ``(hit [n] bool, branch)``.

    - phase 1: an ``all_reduce`` MAX of the largest per-destination chunk
      popcount (the own chunk excluded: it never crosses the wire), read
      on the host, picks the smallest rung of ``caps`` that covers it;
    - phase 2a (a rung fits): each destination chunk's set bits, compacted
      into a fixed [P, cap] int32 id buffer with the sentinel n, go out in
      one ``all_to_all_single`` and are scattered into the local chunk;
    - phase 2b (every rung overflows): the dense ring (packed with
      ``wire_pack``).

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
        return _dense_or(x_full, mesh, wire_pack), branch
    recv = mesh.all_to_all(_compact_chunks(remote, ladder[branch]))
    return _scatter_hit(recv, n) | chunks[i], branch


def dense_or_wire_bytes(p: int, n: int, impl: str, *, wire_pack: bool = False) -> float:
    """Modeled bytes one rank sends a level in the dense OR exchange:
    ``ring``, P - 1 chunks of n one-byte elements; ``allreduce``, an int32
    [P*n] all-reduce at its bandwidth-optimal 2(P-1)n words; with
    ``wire_pack`` either, P - 1 chunks of ceil(n/32) words. The termination
    count is outside the model, as in JAX."""
    if p == 1:
        return 0.0
    if wire_pack:
        return float((p - 1) * 4 * packed_words(n))
    return float(2 * (p - 1) * n * 4 if impl == "allreduce" else (p - 1) * n)


def column_gather_wire_bytes(rows: int, w: int, *, wire_pack: bool = False) -> float:
    """Modeled bytes one rank sends a level in the 2D column all-gather:
    its [w] bool slice (ceil(w/32) words packed), rows - 1 times."""
    if rows <= 1:
        return 0.0
    return float((rows - 1) * 4 * packed_words(w)) if wire_pack else float((rows - 1) * w)


def dense_2d_wire_bytes(rows: int, cols: int, w: int, impl: str, *,
                        wire_pack: bool = False) -> float:
    """The 2D level's modeled bytes: the column all-gather plus the row
    reduce-scatter over the mesh row."""
    return column_gather_wire_bytes(rows, w, wire_pack=wire_pack) + dense_or_wire_bytes(
        cols, w, impl, wire_pack=wire_pack)


def sparse_wire_bytes_per_level(p: int, n: int, caps, *, wire_pack: bool = False) -> list[float]:
    """Modeled bytes a level for each :func:`sparse_exchange_or` branch, in
    branch order: per rung c, P - 1 id chunks of c int32 plus the 4-byte
    phase-1 scalar; the dense ring (packed with ``wire_pack``) plus the
    scalar. One rank moves none."""
    ladder = normalize_caps(caps)
    if p == 1:
        return [0.0] * (len(ladder) + 1)
    return [float((p - 1) * c * 4 + 4) for c in ladder] + [
        dense_or_wire_bytes(p, n, "ring", wire_pack=wire_pack) + 4.0]


# --- delta-encoded id chunks -------------------------------------------------

#: The delta width ladder: 8-bit deltas cover id gaps up to 255, 16-bit up
#: to 65535; wider gaps ship plain 4-byte ids at the same cap rung.
DELTA_BITS_DEFAULT = (8, 16)
_DELTA_BITS_ALLOWED = (4, 8, 16)


def check_delta_bits(delta_bits) -> tuple[int, ...]:
    """A delta width ladder, validated and canonical (ascending, deduped,
    each dividing 32: fields never straddle a word)."""
    out = tuple(sorted({int(b) for b in delta_bits}))
    bad = [b for b in out if b not in _DELTA_BITS_ALLOWED]
    if bad:
        raise ValueError(
            f"delta_bits must be drawn from {_DELTA_BITS_ALLOWED} "
            f"(fixed-width fields packed into uint32 words), got {bad}"
        )
    return out


def delta_words(cap: int, bits: int) -> int:
    """Words one destination's delta-encoded chunk ships: a header word
    (the first id) and ceil(cap*bits/32) words of deltas."""
    return 1 + -(-cap * bits // 32)


def delta_encode_ids(buf: torch.Tensor, sentinel: int, bits: int) -> torch.Tensor:
    """Ascending id chunks as int32 words (JAX's uint32 words, bit for bit).

    ``buf`` [..., cap] int32 holds each chunk's valid ids strictly
    ascending in a prefix, ``sentinel`` after. Out: [..., delta_words(cap,
    bits)], word 0 the first id (``sentinel`` for an empty chunk), then cap
    ``bits``-wide deltas LSB-first, 32 // bits a word. Valid deltas are at
    least 1 and tail fields 0, so the decoder needs no length. The caller
    ensures every delta fits (the all-reduced gap picks ``bits``)."""
    cap = buf.shape[-1]
    valid = buf < sentinel
    prev = torch.cat([buf[..., :1], buf[..., :-1]], dim=-1)
    prev_valid = torch.cat([torch.zeros_like(valid[..., :1]), valid[..., :-1]], dim=-1)
    d = torch.where(valid & prev_valid, buf - prev, 0).to(torch.int32)
    per = 32 // bits
    pad = -cap % per
    if pad:
        d = torch.cat([d, d.new_zeros(d.shape[:-1] + (pad,))], dim=-1)
    du = d.reshape(d.shape[:-1] + (-1, per))
    # Disjoint fields: the sum is their OR (16-bit fields fill bits 16-31).
    words = (du << _shifts(per, bits, buf.device)).sum(dim=-1, dtype=torch.int32)
    return torch.cat([buf[..., :1].to(torch.int32), words], dim=-1)


def delta_decode_ids(words: torch.Tensor, cap: int, bits: int):
    """Inverse of :func:`delta_encode_ids`: ``(ids [..., cap] int32, valid
    [..., cap] bool)``. Tail positions repeat the last valid id and are
    invalid; an empty chunk decodes to the encoder's sentinel everywhere
    (position 0 reports valid: callers gate on ``ids < sentinel``)."""
    first = words[..., :1]
    per = 32 // bits
    # >> is arithmetic on int32: the mask drops the sign copies.
    fields = (words[..., 1:, None] >> _shifts(per, bits, words.device)) & ((1 << bits) - 1)
    d = fields.reshape(words.shape[:-1] + (-1,))[..., :cap]
    ids = first + torch.cumsum(d, dim=-1, dtype=torch.int32)
    valid = torch.cat([torch.ones_like(d[..., :1], dtype=torch.bool), d[..., 1:] > 0], dim=-1)
    return ids, valid


def max_id_gap(rem: torch.Tensor) -> torch.Tensor:
    """The largest gap between consecutive set bits within a row of a
    [..., n] bool matrix, over every row, as a device int32 scalar: the
    widest delta an id stream of those rows carries (rows with fewer than
    two set bits give 0)."""
    n = rem.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=rem.device)
    last = torch.cummax(torch.where(rem, idx, -1), dim=-1).values
    prev = torch.cat([torch.full(rem.shape[:-1] + (1,), -1, dtype=torch.int32,
                                 device=rem.device), last[..., :-1]], dim=-1)
    gaps = torch.where(rem & (prev >= 0), idx - prev, 0)
    return gaps.max() if gaps.numel() else torch.zeros((), dtype=torch.int32,
                                                      device=rem.device)


# --- the exchange planner ------------------------------------------------------


def planned_branch_count(caps, delta_bits) -> int:
    """Branches of :func:`planned_sparse_exchange_or`: B = K*(W+1) sparse
    branches twice (unsieved, sieved), the two dense ones and the
    predicted dense: 2B + 3."""
    b = len(normalize_caps(caps)) * (len(delta_bits) + 1)
    return 2 * b + 3


def planned_branch_labels(caps, delta_bits) -> list[str]:
    """Labels of the planner's branches, index-aligned with its byte model
    and the branches it returns."""
    names = _rung_names(caps, delta_bits)
    return (names + ["dense"] + [f"sieved-{s}" for s in names]
            + ["sieved-dense", "dense-predicted"])


def sieve_wire_bytes(p: int, n: int) -> float:
    """Bytes one rank moves for the sieve: one all-gather of each
    receiver's packed [ceil(n/32)] visited chunk."""
    return 0.0 if p == 1 else float((p - 1) * 4 * packed_words(n))


def planned_sparse_wire_bytes_per_level(p: int, n: int, caps, delta_bits, *,
                                        wire_pack: bool = False) -> list[float]:
    """Modeled bytes a level for each planner branch, in label order: a
    measured level pays 8 bytes for the (count, gap) pair, a sieved one
    twice that plus the visited transfer, the predicted dense none."""
    nb = planned_branch_count(caps, delta_bits)
    if p == 1:
        return [0.0] * nb
    sparse = []
    for c in normalize_caps(caps):
        sparse += [float((p - 1) * 4 * delta_words(c, b)) for b in delta_bits]
        sparse.append(float((p - 1) * 4 * c))
    dense = dense_or_wire_bytes(p, n, "ring", wire_pack=wire_pack)
    sv = sieve_wire_bytes(p, n)
    return ([s + 8.0 for s in sparse] + [dense + 8.0]
            + [s + sv + 16.0 for s in sparse] + [dense + sv + 16.0] + [dense])


def planned_reads(branch: int, caps, delta_bits, p: int) -> int:
    """Host reads of a planner level that took ``branch``: none on one rank
    or predicted, two sieved (the second measure), one otherwise."""
    b = len(normalize_caps(caps)) * (len(delta_bits) + 1)
    if p == 1 or branch == 2 * b + 2:
        return 0
    return 2 if branch > b else 1


def planned_sparse_exchange_or(x_full: torch.Tensor, mesh, *, caps, delta_bits=(),
                               sieve: bool = False, visited=None, visited_total: int = 0,
                               predict: bool = False, prev_biggest: int = -1,
                               growing: bool = False, wire_pack: bool = False):
    """:func:`sparse_exchange_or` with the exchange planner: per level,
    delta ids, plain ids, the dense ring or a sieved form, chosen from
    values every rank holds. Returns ``(hit [n] bool, branch, biggest)``.

    - **delta ids** (``delta_bits``): the compacted chunks are ascending,
      so each ships first-id plus bit-packed deltas
      (:func:`delta_encode_ids`). Phase 1 all-reduces a (count, gap) pair:
      the gap picks the narrowest width that holds it, or plain ids.
    - **sieve** (``sieve``; ``visited`` this rank's [n] chunk,
      ``visited_total`` the mesh's visited count): when the modeled id
      savings (visited density x biggest x 4 bytes, in float32 as JAX)
      beat the packed visited chunk's cost and a smaller rung is reachable,
      every receiver's packed visited chunk is all-gathered and senders
      drop visited ids before a second measure. The sieved ``hit`` equals
      the raw OR on this rank's unvisited positions (and its own chunk),
      all the claim ``hit & ~visited`` reads.
    - **prediction** (``predict``; ``prev_biggest`` the last measured
      level's count, ``growing`` the frontier's growth): a level after one
      that overflowed every rung, with the frontier still growing, takes
      the dense ring without phase 1.

    ``branch`` indexes :func:`planned_branch_labels`; ``biggest`` is the
    measured count (``prev_biggest`` when predicted) for the next level."""
    p = mesh.num_shards
    n = x_full.shape[0] // p
    ladder = normalize_caps(caps)
    delta_bits = check_delta_bits(delta_bits)
    nk, nw = len(ladder), len(delta_bits)
    b = nk * (nw + 1)
    if p == 1:
        return x_full, b, 0
    i = mesh.rank
    chunks = x_full.view(p, n)
    remote = chunks.clone()
    remote[i] = False

    def measure(rem):
        pair = torch.stack([rem.sum(dim=1, dtype=torch.int32).max(),
                            max_id_gap(rem).to(torch.int32)])
        return mesh.all_reduce_(pair, "max").tolist()  # the phase-1 read

    def encode(rem, biggest, dmax, base):
        ri = cap_ladder_select(biggest, ladder)
        if ri == nk:
            return _dense_or(x_full, mesh, wire_pack), base + b
        cap = ladder[ri]
        buf = _compact_chunks(rem, cap)
        e = delta_rung(dmax, delta_bits)
        if e == nw:
            ids = mesh.all_to_all(buf)
        else:
            recv = mesh.all_to_all(delta_encode_ids(buf, n, delta_bits[e]))
            ids, _ = delta_decode_ids(recv, cap, delta_bits[e])
        return _scatter_hit(ids, n), base + ri * (nw + 1) + e

    if predict and prev_biggest > ladder[-1] and growing:
        hit, branch, biggest = _dense_or(x_full, mesh, wire_pack), 2 * b + 2, prev_biggest
    else:
        biggest, dmax = measure(remote)
        sieve_on = False
        if sieve:
            rho = np.float32(visited_total) / np.float32(p * n)
            gain = rho * np.float32(biggest) * np.float32(4.0)
            sieve_on = bool(gain > np.float32(4.0 * packed_words(n))) and biggest > ladder[0]
        if sieve_on:
            allv = mesh.all_gather_rows(pack_bits(visited)[None])  # [p, nw]
            rem2 = remote & ~unpack_bits(allv, n)
            hit, branch = encode(rem2, *measure(rem2), b + 1)
        else:
            hit, branch = encode(remote, biggest, dmax, 0)
    return hit | chunks[i], branch, biggest


# --- the (min, +) value exchanges ----------------------------------------------
#
# The OR exchanges move bitmaps; SSSP's distances are int32 words under
# elementwise min, which has an identity (INF), so the same machinery
# applies: the dense forms become MIN reductions, the queue-style form
# ships (row id, value row) pairs on the row gather's cap ladder and delta
# codec, and the receiver folds them with a scatter-MIN, which, unlike the
# OR gather's SET, is safe under duplicate ids.


def minplus_rows_branch_count(caps, delta_bits, *, predict: bool = False) -> int:
    """Branches of :func:`sparse_rows_exchange_min`: the row gather's, plus
    the predicted dense when prediction is on."""
    return rows_gather_branch_count(caps, delta_bits) + (1 if predict else 0)


def minplus_rows_branch_labels(caps, delta_bits, *, predict: bool = False) -> list[str]:
    """Labels of the min exchange's branches."""
    labels = rows_gather_branch_labels(caps, delta_bits)
    return labels + ["dense-predicted"] if predict else labels


def dense_min_wire_bytes(p: int, rows_loc: int, lanes: int) -> float:
    """Bytes one rank moves a round in the dense min exchange of a
    replicated [p*rows_loc, lanes] int32 table: 2(P-1) rows_loc x 4 lanes
    (ring reduce-scatter and all-gather, or the all-reduce's optimum)."""
    return 0.0 if p == 1 else float(2 * (p - 1) * rows_loc * 4 * lanes)


def minplus_rows_wire_bytes_per_level(p: int, rows_loc: int, lanes: int, caps,
                                      delta_bits=(), *, predict: bool = False) -> list[float]:
    """Modeled bytes a round for each :func:`sparse_rows_exchange_min`
    branch: the row gather's model with ``lanes`` distance words a row, and
    the predicted dense (an all-gather of every rank's rows) with no
    measuring scalar."""
    base = sparse_rows_wire_bytes_per_level(p, rows_loc, lanes, caps, delta_bits)
    if not predict:
        return base
    return base + [0.0 if p == 1 else dense_rows_wire_bytes(p, rows_loc, lanes)]


def sparse_rows_exchange_min(mesh, new_loc: torch.Tensor, changed: torch.Tensor,
                             table: torch.Tensor, *, cap: int, out_rows: int, gid_of,
                             ident: int, bits: int | None = None, gid_of_src=None) -> None:
    """One rung of the queue-style min exchange, in place: every rank's at
    most ``cap`` rows that ``changed`` marks, as (global row id, value row
    of ``new_loc``) pairs, scatter-MINed into ``table`` [out_rows + 1,
    lanes], the replicated previous values with a last row that absorbs
    empty slots (their values are ``ident``, min's identity). Ids map and
    travel as in :func:`sparse_rows_gather`."""
    rows_loc, lanes = new_loc.shape
    ids = _compact_rows(changed, cap)
    ok = ids < rows_loc
    vals = new_loc.index_select(0, torch.where(ok, ids, 0))
    vals.masked_fill_(~ok[:, None], ident)
    ag_vals = mesh.all_gather_rows(vals)
    ag_ids = _gathered_row_ids(mesh, ids, rows_loc, out_rows, gid_of, bits, gid_of_src)
    table.scatter_reduce_(0, ag_ids[:, None].expand(-1, lanes), ag_vals, "amin")
