"""The modeled wire bytes against the port's own wire, the port of
``tpu_bfs/utils/wirecheck.py``.

Every wire-byte figure the mesh engines print is modeled: a formula of
``parallel/collectives.py`` over the levels each branch took. JAX proves
its formulas from the compiled program's collective instructions. The
port proves them from the bytes it actually hands its process group:
each audit turns the wire tap on (``analysis/graph.WireTap``, over the
four collectives of ``parallel/mesh.Mesh``), drives the engine's own
exchange once per branch, with a frontier built to land on that branch,
and compares the counted bytes a branch with the model. The wire
conventions (a permute sends its operand once, an all-to-all keeps its
own piece, control scalars priced flat) are JAX's and are listed in
``analysis/graph.py``.

HLO holds every branch of a program; a tap sees only the branches that
ran, so every audit drives each branch itself. Each runs inside a rank
of a mesh (``mesh`` argument: a ``Mesh``, or a ``Mesh2D`` for the 2D
audits), every rank calling it with the same arguments, and returns
JAX's result keys with ``hlo_per_level`` named ``counted_per_level``.
:func:`run_audits` launches a gloo group of CPU ranks and runs a list of
audits in it.

One shape a small graph cannot reach is driven at another size:

- a plain-id rung of a delta ladder runs only when an id gap passes the
  widest delta (16 bits), which no chunk of fewer than 65,536 ids holds.
  The row gathers take their rung as an argument, so their plain rungs
  run at the engine's shapes. The 1D planner picks the encoding itself:
  its plain rungs run on a 2^17-vertex chunk, whose rung collectives
  have the same shapes (a rung's ids do not depend on the chunk), and
  the sieved ones count the visited gather of the engine's chunk, which
  is the only collective whose size the chunk sets.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_bfs_torch.analysis.graph import WireTap, total_wire_bytes

#: A plain-id rung's probe chunk: ids 2^16 + 2 apart fit.
_WIDE_CHUNK = 1 << 17
_WIDE_GAP = 70_000


def _floats(xs) -> list[float]:
    return [float(x) for x in xs]


def _bool_ids(n: int, ids, device) -> torch.Tensor:
    out = torch.zeros(n, dtype=torch.bool, device=device)
    if len(ids):
        out[torch.as_tensor(np.asarray(ids, dtype=np.int64), device=device)] = True
    return out


def _rung_ids(count: int, gap: int) -> list[int]:
    """``count`` ascending ids whose widest gap is ``gap`` (1 for dense
    runs): 0, then a run of consecutive ids from ``gap``."""
    if count <= 0:
        return []
    if gap <= 1:
        return list(range(count))
    return [0] + [gap + i for i in range(count - 1)]


def _remote_contrib(mesh, n: int, ids, device) -> torch.Tensor:
    """A [P * n] contribution: ``ids`` set in every remote destination's
    chunk (this rank's own chunk empty)."""
    p = mesh.num_shards
    chunk = _bool_ids(n, ids, device)
    x = chunk.repeat(p)
    x[mesh.rank * n:(mesh.rank + 1) * n] = False
    return x


def _sum_calls(calls, op=None) -> float:
    return total_wire_bytes(c for c in calls if op is None or c.op == op)


def _count(calls, op, pred=None) -> int:
    return sum(1 for c in calls if c.op == op and (pred is None or pred(c)))


# --- the single-source 1D exchanges ------------------------------------------


def _planner_carry(vis_total: int = 0, prev_biggest: int = -1, prev_count: int = 0):
    from tpu_bfs_torch.parallel.dist_bfs import PlannerCarry

    plan = PlannerCarry(vis_total)
    plan.prev_biggest, plan.prev_count = prev_biggest, prev_count
    return plan


def _drive_step(eng, mesh, contrib, visited, plan, front: int, vis_scale: int = 1):
    """One exchange step of ``eng`` under the tap: ``(branch, calls)``."""
    with WireTap() as tap:
        _, branch, _ = eng._exchange_step(contrib, mesh, visited, plan, front, vis_scale)
    return branch, tap.calls


def check_1d_sparse(graph, mesh, wire_pack: bool = False) -> dict:
    """1D ``DistBfsEngine``, queue-style sparse exchange: each cap rung and
    the dense ring driven once (``sparse_wire_bytes_per_level``)."""
    from tpu_bfs_torch.parallel.collectives import sparse_wire_bytes_per_level
    from tpu_bfs_torch.parallel.dist_bfs import DistBfsEngine

    p = mesh.num_shards
    eng = DistBfsEngine(graph, mesh, exchange="sparse", wire_pack=wire_pack)
    n, caps, dev = eng.part.vloc, eng.sparse_caps, eng.device
    visited = torch.zeros(n, dtype=torch.bool, device=dev)
    counted, branches, ring_steps, scalars = [], [], 0, 0
    for want, count in list(enumerate(caps)) + [(len(caps), caps[-1] + 1)]:
        branch, calls = _drive_step(eng, mesh, _remote_contrib(mesh, n, range(count), dev),
                                    visited, _planner_carry(), 1)
        branches.append(branch == want)
        counted.append(_sum_calls(calls))
        scalars = max(scalars, _count(calls, "all-reduce"))
        if want == len(caps):
            ring_steps = _count(calls, "collective-permute")
    modeled = sparse_wire_bytes_per_level(p, n, caps, wire_pack=wire_pack)
    return {
        "config": (f"1D sparse exchange, P={p}, vloc={n}, caps={caps}, "
                   f"wire_pack={wire_pack}"),
        "modeled_per_level": modeled,
        "counted_per_level": counted,
        "ring_steps": ring_steps,
        "scalar_allreduces": scalars,
        "agree": (all(branches) and _floats(modeled) == _floats(counted)
                  and ring_steps == p - 1),
    }


def check_planned_sparse(graph, mesh, wire_pack: bool = False) -> dict:
    """The exchange planner (delta ids (8, 16), sieve, prediction): every
    one of its 2B + 3 branches driven once against
    ``planned_sparse_wire_bytes_per_level``. A delta rung ships
    ``delta_words(cap, b)`` words a destination; the sieve adds one
    packed visited all-gather; a measured level pays one int32 pair, a
    sieved level two; the predicted dense level measures nothing. The
    plain-id rungs run on a wide chunk (module docstring)."""
    from tpu_bfs_torch.parallel.collectives import (
        DELTA_BITS_DEFAULT,
        packed_words,
        planned_branch_count,
        planned_sparse_wire_bytes_per_level,
    )
    from tpu_bfs_torch.parallel.dist_bfs import DistBfsEngine

    p = mesh.num_shards
    delta_bits = DELTA_BITS_DEFAULT
    eng = DistBfsEngine(graph, mesh, exchange="sparse", wire_pack=wire_pack,
                        delta_bits=delta_bits, sieve=True, predict=True)
    n, caps, dev = eng.part.vloc, eng.sparse_caps, eng.device
    nw, nk, ne = packed_words(n), len(caps), len(delta_bits) + 1
    b = nk * ne
    nb = planned_branch_count(caps, delta_bits)
    counted: list = [None] * nb
    hit_branch = [False] * nb
    sieve_gather = None  # the visited gather at the engine's chunk

    def run(want: int, size: int, ids, *, sieve_ids=(), predicted=False):
        nonlocal sieve_gather
        contrib = _remote_contrib(mesh, size, ids, dev)
        visited = _bool_ids(size, sieve_ids, dev)
        plan = (_planner_carry(0, caps[-1] + 1, 0) if predicted
                else _planner_carry(p * size if len(sieve_ids) else 0))
        branch, calls = _drive_step(eng, mesh, contrib, visited, plan, 1)
        gathers = [c for c in calls if c.op == "all-gather"]
        if size == n and gathers:
            sieve_gather = gathers[0]
        elif size != n:  # the wide chunk's gather -> the engine chunk's
            calls = [c for c in calls if c.op != "all-gather"] + (
                [sieve_gather] if gathers else [])
        hit_branch[want] = branch == want
        counted[want] = _sum_calls(calls)
        return calls

    def gap_of(e: int) -> int:
        return 1 if e == 0 else (1 << delta_bits[e - 1]) + 1

    def sieved(want: int, size: int, keep):
        """The sieved branch ``want``: more remote ids than the widest
        rung and the visited chunk's words, all but ``keep`` visited at
        the receiver, so the second measure lands on ``keep``'s rung."""
        big = max(caps[-1] + 1, packed_words(size) + 1)
        kept = set(keep)
        return run(want, size, sorted(kept | set(range(big))),
                   sieve_ids=[i for i in range(1, big) if i not in kept])

    sieve_calls = {}
    for ri, cap in enumerate(caps):  # delta encodings at the engine's chunk
        for e in range(ne - 1):
            run(ri * ne + e, n, _rung_ids(cap, gap_of(e)))
            sieve_calls[ri, e] = sieved(b + 1 + ri * ne + e, n, _rung_ids(cap, gap_of(e)))
    for ri, cap in enumerate(caps):  # plain ids, with the sieve's gather known
        run(ri * ne + ne - 1, _WIDE_CHUNK, _rung_ids(cap, _WIDE_GAP))
        sieved(b + 1 + ri * ne + ne - 1, _WIDE_CHUNK, _rung_ids(cap, _WIDE_GAP))
    over = caps[-1] + 1
    run(b, n, range(over))  # dense: every rung overflows, no sieve
    ring = run(2 * b + 1, n, range(n), sieve_ids=[1])  # sieved, still past every rung
    run(2 * b + 2, n, range(over), predicted=True)
    perms = [c for c in ring if c.op == "collective-permute"]
    chunk = 4 * nw if wire_pack else n
    modeled = planned_sparse_wire_bytes_per_level(p, n, caps, delta_bits, wire_pack=wire_pack)
    pairs = sum(1 for calls in sieve_calls.values() for c in calls
                if c.op == "all-reduce" and c.operand_bytes == 8)
    return {
        "config": (f"planned sparse exchange, P={p}, vloc={n}, caps={caps}, "
                   f"delta_bits={delta_bits}, wire_pack={wire_pack}"),
        "modeled_per_level": modeled,
        "counted_per_level": counted,
        "branches_driven": hit_branch,
        "sieve_allgathers": _count(ring, "all-gather"),
        "ring_permutes": len(perms),
        "pair_pmaxes": pairs // max(len(sieve_calls), 1),
        "agree": (all(hit_branch)
                  and _count(ring, "all-gather") == 1
                  and len(perms) == p - 1 and all(c.operand_bytes == chunk for c in perms)
                  and _floats(modeled) == _floats(counted)),
    }


def check_packed_exchange(graph, mesh) -> dict:
    """The packed wire moves exactly 1/8 the ring's bytes and 1/32 the
    int32 all-reduce's operand, with the same collective count: the 1D
    exchange driven four ways (ring and allreduce, plain and packed)."""
    from tpu_bfs_torch.parallel.collectives import dense_or_wire_bytes, packed_words
    from tpu_bfs_torch.parallel.dist_bfs import DistBfsEngine

    p = mesh.num_shards
    calls, n = {}, None
    for impl in ("ring", "allreduce"):
        for packed in (False, True):
            eng = DistBfsEngine(graph, mesh, exchange=impl, wire_pack=packed)
            n, dev = eng.part.vloc, eng.device
            contrib = _remote_contrib(mesh, n, range(0, n, 3), dev)
            _, calls[impl, packed] = _drive_step(
                eng, mesh, contrib, torch.zeros(n, dtype=torch.bool, device=dev),
                _planner_carry(), 1)
    nw = packed_words(n)
    ring_plain = [c for c in calls["ring", False] if c.op == "collective-permute"]
    ring_packed = [c for c in calls["ring", True] if c.op == "collective-permute"]
    ar_plain = [c for c in calls["allreduce", False] if c.op == "all-reduce"]
    a2a_packed = [c for c in calls["allreduce", True] if c.op == "all-to-all"]
    ring_bytes = _sum_calls(ring_plain)
    ring_packed_bytes = _sum_calls(ring_packed)
    ar_operand = sum(c.operand_bytes for c in ar_plain)
    a2a_operand = sum(c.operand_bytes for c in a2a_packed)
    counts = {k: len(v) for k, v in calls.items()}
    modeled = {impl: dense_or_wire_bytes(p, n, impl, wire_pack=True)
               for impl in ("ring", "allreduce")}
    counted = {"ring": ring_packed_bytes, "allreduce": _sum_calls(a2a_packed)}
    return {
        "config": f"packed vs plain 1D exchange, P={p}, vloc={n}",
        "vloc": n,
        "ring_permute_result_bytes": ring_plain[0].operand_bytes if ring_plain else None,
        "allreduce_operand_bytes": ar_operand,
        "ring_reduction": ring_bytes / ring_packed_bytes if ring_packed_bytes else None,
        "allreduce_operand_reduction": ar_operand / a2a_operand if a2a_operand else None,
        "collective_counts": {f"{i}/{k}": c for (i, k), c in counts.items()},
        "modeled_packed_per_level": modeled,
        "counted_packed_per_level": counted,
        "agree": (
            len(ring_plain) == len(ring_packed) == p - 1
            and len(ar_plain) == 1 and len(a2a_packed) == 1
            and counts["ring", True] == counts["ring", False]
            and counts["allreduce", True] == counts["allreduce", False]
            and ring_packed_bytes * 8 == ring_bytes
            and a2a_operand * 32 == ar_operand
            and counted == {k: float(v) for k, v in modeled.items()}
            and ring_packed_bytes == (p - 1) * 4 * nw
        ),
    }


def check_wire_checksum(mesh, words: int = 64) -> dict:
    """The per-hop chunk checksum (``integrity/wire.checksummed_ring_or``)
    costs exactly one int32 word a chunk a hop, with the same collective
    count: the checksummed packed ring run both ways, its result equal."""
    from tpu_bfs_torch.integrity.wire import checksummed_ring_or

    p = mesh.num_shards
    rng = np.random.default_rng(mesh.rank)
    chunks = torch.from_numpy(
        rng.integers(-2**31, 2**31, size=(p, words), dtype=np.int64).astype(np.int32))
    perms, outs, bads = {}, {}, {}
    for checked in (False, True):
        with WireTap() as tap:
            outs[checked], bads[checked] = checksummed_ring_or(chunks, mesh, wire_check=checked)
        perms[checked] = tap.calls
    plain_bytes, checked_bytes = _sum_calls(perms[False]), _sum_calls(perms[True])
    return {
        "config": f"checksummed packed ring, P={p}, {words} words/chunk",
        "permutes": {c: _count(v, "collective-permute") for c, v in perms.items()},
        "plain_permute_bytes": plain_bytes,
        "checked_permute_bytes": checked_bytes,
        "checksum_overhead_bytes": checked_bytes - plain_bytes,
        "collective_counts": {c: len(v) for c, v in perms.items()},
        "agree": (
            _count(perms[False], "collective-permute")
            == _count(perms[True], "collective-permute") == p - 1
            and len(perms[True]) == len(perms[False])
            and checked_bytes - plain_bytes == 4 * (p - 1)
            and all(c.operand_bytes == 4 * words for c in perms[False])
            and all(c.operand_bytes == 4 * (words + 1) for c in perms[True])
            and torch.equal(outs[False], outs[True]) and int(bads[True]) == 0
        ),
    }


# --- the 2D exchanges -----------------------------------------------------------


def _drive_2d_level(eng, mesh2d, contrib, new):
    """The 2D level's collectives under the tap: the row exchange of
    ``contrib`` over 'c', then the column gather of ``new`` over 'r'."""
    plan = _planner_carry()
    with WireTap() as tap:
        _, branch, _ = eng._exchange_step(contrib, mesh2d.c, torch.zeros_like(new), plan, 1,
                                          eng.rows)
        eng._gather_col(new)
    return branch, tap.calls


def check_2d(graph, mesh2d, exchange: str = "ring", backend: str = "scan",
             wire_pack: bool = False) -> dict:
    """2D ``Dist2DBfsEngine``: one level's column all-gather over 'r' and
    row reduce-scatter over 'c' against ``dense_2d_wire_bytes``."""
    from tpu_bfs_torch.parallel.collectives import dense_2d_wire_bytes, packed_words
    from tpu_bfs_torch.parallel.dist_bfs2d import Dist2DBfsEngine

    rows, cols = mesh2d.rows, mesh2d.cols
    eng = Dist2DBfsEngine(graph, mesh2d, exchange=exchange, backend=backend,
                          wire_pack=wire_pack)
    w, dev = eng.part.w, eng.device
    nw = packed_words(w)
    _, calls = _drive_2d_level(eng, mesh2d, _remote_contrib(mesh2d.c, w, range(0, w, 3), dev),
                               _bool_ids(w, range(0, w, 5), dev))
    col = [c for c in calls if c.op == "all-gather"]
    row = [c for c in calls if c.op != "all-gather"]
    if exchange == "ring":
        chunk = 4 * nw if wire_pack else w
        row_ok = (_count(row, "collective-permute", lambda c: c.operand_bytes == chunk)
                  == cols - 1 == len(row))
    elif wire_pack:
        row_ok = len(row) == 1 and row[0].op == "all-to-all"
    else:
        row_ok = len(row) == 1 and row[0].op == "all-reduce" \
            and row[0].operand_bytes == 4 * cols * w
    modeled = dense_2d_wire_bytes(rows, cols, w, exchange, wire_pack=wire_pack)
    counted = _sum_calls(calls)
    return {
        "config": f"2D {exchange}/{backend}, mesh {rows}x{cols}, w={w}, wire_pack={wire_pack}",
        "modeled_per_level": modeled,
        "counted_per_level": counted,
        "column_allgathers": len([c for c in col if c.wire_bytes > 0]),
        "agree": (modeled == counted and len(col) == 1 and row_ok
                  and (col[0].wire_bytes > 0) == (rows > 1)),
    }


def check_2d_sparse(graph, mesh2d) -> dict:
    """2D queue-style row exchange: the column all-gather plus each sparse
    rung or the ring fallback over 'c', against the engine's own
    ``wire_bytes_per_level``."""
    from tpu_bfs_torch.parallel.dist_bfs2d import Dist2DBfsEngine

    rows, cols = mesh2d.rows, mesh2d.cols
    eng = Dist2DBfsEngine(graph, mesh2d, exchange="sparse")
    w, caps, dev = eng.part.w, eng.sparse_caps, eng.device
    new = _bool_ids(w, range(0, w, 5), dev)
    counted, ok, ring_steps, col_ags = [], [], 0, 0
    for want, count in list(enumerate(caps)) + [(len(caps), caps[-1] + 1)]:
        branch, calls = _drive_2d_level(eng, mesh2d, _remote_contrib(mesh2d.c, w, range(count),
                                                                     dev), new)
        ok.append(branch == want)
        counted.append(_sum_calls(calls))
        col_ags = _count(calls, "all-gather", lambda c: c.wire_bytes > 0)
        if want == len(caps):
            ring_steps = _count(calls, "collective-permute")
    modeled = eng.wire_bytes_per_level()
    return {
        "config": f"2D sparse row exchange, mesh {rows}x{cols}, w={w}, caps={caps}",
        "modeled_per_level": modeled,
        "counted_per_level": counted,
        "column_allgathers": col_ags,
        "ring_steps": ring_steps,
        "agree": (all(ok) and _floats(modeled) == _floats(counted)
                  and col_ags == (1 if rows > 1 else 0) and ring_steps == cols - 1),
    }


# --- the row gathers of the packed mesh engines -------------------------------------


def _row_probe(rows_loc: int, w: int, count: int, device) -> torch.Tensor:
    """A [rows_loc, w] int32 frontier whose first ``count`` rows are
    nonzero (the row gathers take their rung and encoding as an argument,
    so the probe only has to fit it: every gap is 1)."""
    nxt = torch.zeros((rows_loc, w), dtype=torch.int32, device=device)
    nxt[:count] = 1
    return nxt


def _rows_audit(eng, mesh, gather, delta_bits) -> tuple[list, list]:
    """Per branch of a row-gather engine: the rung's flag all-reduce (the
    count, and the widest gap with a delta ladder: ``row_gather_flags``)
    and ``gather(nxt, branch)``, tapped. Returns ``(counted, calls)``."""
    from tpu_bfs_torch.parallel.collectives import (
        branch_rung,
        row_gather_flags,
        rows_gather_branch_count,
    )

    caps, rows_loc, w = eng.sparse_caps, eng._gather_rows_loc, eng.w
    counted, every = [], []
    for branch in range(rows_gather_branch_count(caps, delta_bits)):
        rung = branch_rung(branch, caps, delta_bits)
        count = rows_loc if rung is None else min(rung[0], rows_loc)
        nxt = _row_probe(rows_loc, w, count, eng.device)
        with WireTap() as tap:
            mesh.all_reduce_(row_gather_flags((nxt != 0).any(dim=1), delta_bits), "max")
            gather(nxt, branch)
        counted.append(_sum_calls(tap.calls))
        every.append(tap.calls)
    return counted, every


def check_rows_sparse(graph, mesh, lanes: int = 64) -> dict:
    """``DistWideMsBfsEngine``, queue-style sparse row gather
    (``sparse_rows_gather``): each cap rung's (ids, rows) all-gathers and
    the dense slab, each with the count's 4-byte all-reduce, against
    ``sparse_rows_wire_bytes_per_level``."""
    from tpu_bfs_torch.parallel.collectives import sparse_rows_wire_bytes_per_level
    from tpu_bfs_torch.parallel.dist_msbfs_wide import DistWideMsBfsEngine

    p = mesh.num_shards
    eng = DistWideMsBfsEngine(graph, mesh, lanes=lanes, exchange="sparse")
    counted, calls = _rows_audit(eng, mesh, eng._exchange_rows, ())
    modeled = sparse_rows_wire_bytes_per_level(p, eng._gather_rows_loc, eng.w, eng.sparse_caps)
    return {
        "config": (f"dist-wide sparse rows, P={p}, rows_loc={eng._gather_rows_loc}, "
                   f"w={eng.w}, caps={eng.sparse_caps}"),
        "modeled_per_level": modeled,
        "counted_per_level": counted,
        "all_gathers": sum(_count(c, "all-gather") for c in calls),
        "agree": _floats(modeled) == _floats(counted),
    }


def check_rows_delta(graph, mesh, lanes: int = 64) -> dict:
    """The delta-encoded sparse row gather (``DistWideMsBfsEngine`` with
    ``delta_bits=(8, 16)``): per rung one id all-gather an encoding
    (``delta_words(cap, b)`` words, or cap int32 plain) beside the shared
    [cap, w] row gather, and the (count, gap) pair, against
    ``sparse_rows_wire_bytes_per_level``."""
    from tpu_bfs_torch.parallel.collectives import (
        DELTA_BITS_DEFAULT,
        sparse_rows_wire_bytes_per_level,
    )
    from tpu_bfs_torch.parallel.dist_msbfs_wide import DistWideMsBfsEngine

    p = mesh.num_shards
    delta_bits = DELTA_BITS_DEFAULT
    eng = DistWideMsBfsEngine(graph, mesh, lanes=lanes, exchange="sparse",
                              delta_bits=delta_bits)
    counted, calls = _rows_audit(eng, mesh, eng._exchange_rows, delta_bits)
    modeled = sparse_rows_wire_bytes_per_level(p, eng._gather_rows_loc, eng.w,
                                               eng.sparse_caps, delta_bits)
    return {
        "config": (f"dist-wide delta rows, P={p}, rows_loc={eng._gather_rows_loc}, w={eng.w}, "
                   f"caps={eng.sparse_caps}, delta_bits={delta_bits}"),
        "modeled_per_level": modeled,
        "counted_per_level": counted,
        "all_gathers": sum(_count(c, "all-gather") for c in calls),
        "agree": _floats(modeled) == _floats(counted),
    }


def check_minplus_exchange(graph, mesh, lanes: int = 32) -> dict:
    """The (min, +) value exchange of ``DistSsspEngine`` (delta ids and
    prediction on): each rung's shared value gather and one id gather an
    encoding, the dense rebuild with its pair and the predicted one
    without, against ``minplus_rows_wire_bytes_per_level``; and the
    measured (prediction off) min exchange issues as many all-gathers a
    branch as the OR row gather of ``DistWideMsBfsEngine`` on the same
    ladder."""
    from tpu_bfs_torch.parallel.collectives import (
        DELTA_BITS_DEFAULT,
        branch_rung,
        minplus_rows_wire_bytes_per_level,
        row_gather_flags,
        sparse_rows_exchange_min,
    )
    from tpu_bfs_torch.parallel.dist_msbfs_wide import DistWideMsBfsEngine
    from tpu_bfs_torch.parallel.dist_sssp import DistSsspEngine
    from tpu_bfs_torch.workloads.sssp import INF_W

    p = mesh.num_shards
    delta_bits = DELTA_BITS_DEFAULT
    eng = DistSsspEngine(graph, mesh, lanes=lanes, exchange="sparse", delta_bits=delta_bits,
                         predict=True)
    sell, caps, dev = eng.sell, eng.sparse_caps, eng.device
    n = sell.v_loc
    table = torch.full((sell.v_pad + 1, lanes), int(INF_W), dtype=torch.int32, device=dev)
    own_prev = eng._own(table).clone()
    world = eng._world

    def minplus_gather(new_loc, branch):
        """The engine's exchange at ``branch`` (``_exchange_round``'s body
        after its flag read)."""
        rung = branch_rung(branch, caps, delta_bits)
        if rung is None:
            return eng._dense_gather(new_loc)
        changed = (new_loc < own_prev).any(dim=1)
        out = table.clone()
        sparse_rows_exchange_min(
            world, new_loc, changed, out, cap=rung[0], bits=rung[1], out_rows=sell.v_pad,
            gid_of=lambda ids: ids * p + world.rank, ident=int(INF_W),
            gid_of_src=lambda ids, src: ids * p + src)
        return out

    counted, calls = [], []
    for branch in range(eng._nb - 1):
        rung = branch_rung(branch, caps, delta_bits)
        count = n if rung is None else min(rung[0], n)
        new_loc = torch.where(_row_probe(n, lanes, count, dev) != 0, 1, int(INF_W))
        with WireTap() as tap:
            world.all_reduce_(row_gather_flags((new_loc < own_prev).any(dim=1), delta_bits),
                              "max")
            minplus_gather(new_loc.to(torch.int32), branch)
        counted.append(_sum_calls(tap.calls))
        calls.append(tap.calls)
    # The predicted dense round: no measure, the dense rebuild.
    new_loc = torch.ones((n, lanes), dtype=torch.int32, device=dev)
    with WireTap() as tap:
        _, branch, _, reads = eng._exchange_round(new_loc, table, own_prev, caps[-1] + 1, True)
    counted.append(_sum_calls(tap.calls))
    calls.append(tap.calls)
    predicted_ok = branch == eng._nb - 1 and reads == 0
    modeled = minplus_rows_wire_bytes_per_level(p, n, lanes, caps, delta_bits, predict=True)
    # The OR counterpart, same ladder and encodings: all-gathers a branch.
    eng_or = DistWideMsBfsEngine(graph, mesh, lanes=32 * (-(-lanes // 32)), exchange="sparse",
                                 delta_bits=delta_bits, sparse_caps=caps)
    _, or_calls = _rows_audit(eng_or, mesh, eng_or._exchange_rows, delta_bits)
    ags = {
        "minplus_planner": sum(_count(c, "all-gather") for c in calls),
        "minplus_measured": sum(_count(c, "all-gather") for c in calls[:-1]),
        "or_rows": sum(_count(c, "all-gather") for c in or_calls),
    }
    pairs = max(_count(c, "all-reduce", lambda x: x.operand_bytes == 8) for c in calls)
    return {
        "config": (f"min-plus rows exchange, P={p}, v_loc={n}, lanes={lanes}, caps={caps}, "
                   f"delta_bits={delta_bits}, predict=True"),
        "modeled_per_level": modeled,
        "counted_per_level": counted,
        "all_gathers": ags,
        "pair_pmaxes": pairs,
        "agree": (predicted_ok and pairs == 1
                  and ags["minplus_measured"] == ags["or_rows"]
                  and ags["minplus_planner"] == ags["minplus_measured"] + (1 if p > 1 else 0)
                  and _floats(modeled) == _floats(counted)),
    }


# --- the hybrid engine ------------------------------------------------------------


def _hybrid_level_calls(eng) -> tuple[list, list]:
    """One batch of a ``DistHybridMsBfsEngine`` under the tap: the
    collectives of its level loop (each level's exchange in ``_level``
    and its flag read in ``_read``, the reads the levels made) and of the
    whole batch."""
    levels, reads = [], []

    def tapped(fn, into):
        def call(*args, **kw):
            with WireTap() as tap:
                out = fn(*args, **kw)
            into.append(tap.calls)
            return out
        return call

    eng._level, eng._read = tapped(eng._level, levels), tapped(eng._read, reads)
    try:
        with WireTap() as batch:
            eng.run(np.asarray([0]))
    finally:
        del eng._level, eng._read
    loop = [c for calls in levels + reads[len(reads) - len(levels):] for c in calls]
    return loop, batch.calls


def check_gated_hybrid(graph, mesh, exchange: str = "dense") -> dict:
    """The pull gate moves no extra collective bytes a level: one batch of
    the gated and the ungated ``DistHybridMsBfsEngine`` on the same graph
    and mesh, the multisets of their level loops' collectives (op, wire
    bytes, pieces) equal. A batch's own extras are reported beside:
    gated, the first level's flag read and the skipped-block counters'
    sum (JAX sums its chips' counters on its one host; here every rank
    is a process)."""
    from collections import Counter

    from tpu_bfs_torch.parallel.dist_msbfs_hybrid import DistHybridMsBfsEngine

    p = mesh.num_shards
    colls, batch = {}, {}
    for gate in (False, True):
        eng = DistHybridMsBfsEngine(graph, mesh, exchange=exchange, pull_gate=gate)
        loop, whole = _hybrid_level_calls(eng)
        colls[gate] = sorted((c.op, c.wire_bytes, c.pieces) for c in loop)
        batch[gate] = Counter((c.op, c.shape, c.dtype) for c in whole)
    return {
        "config": f"gated-vs-ungated dist hybrid, P={p}, exchange={exchange}",
        "ungated_collectives": colls[False],
        "gated_collectives": colls[True],
        "gated_batch_extra": sorted((batch[True] - batch[False]).elements()),
        "agree": (colls[False] == colls[True] and len(colls[False]) > 0
                  and not batch[False] - batch[True]),
    }


def check_sliced_hybrid(graph, mesh, lanes: int | None = None) -> dict:
    """The ring-sliced ``DistHybridMsBfsEngine``: one level's rotation
    sends (P - 1) [rows_loc, w] int32 slabs, the model's bytes."""
    from tpu_bfs_torch.parallel.dist_msbfs_hybrid import DistHybridMsBfsEngine

    p = mesh.num_shards
    kw = {} if lanes is None else {"lanes": lanes}
    eng = DistHybridMsBfsEngine(graph, mesh, exchange="sliced", **kw)
    rows_loc = eng._gather_rows_loc
    fw = torch.zeros((rows_loc, eng.w), dtype=torch.int32, device=eng.device)
    fw[0] = 1
    with WireTap() as tap:
        eng._hit_sliced(fw, False)
    perms = [c for c in tap.calls if c.op == "collective-permute"]
    slab = rows_loc * eng.w * 4
    modeled = 0.0 if p == 1 else float((p - 1) * slab)
    counted = _sum_calls(tap.calls)
    return {
        "config": f"sliced hybrid, P={p}, rows_loc={rows_loc}, w={eng.w}",
        "modeled_per_level": modeled,
        "counted_per_level": counted,
        "permute_result_bytes": sorted({c.operand_bytes for c in perms}),
        "ring_steps": len(perms),
        "agree": (modeled == counted and len(perms) == p - 1 == len(tap.calls)
                  and all(c.operand_bytes == slab for c in perms)),
    }


# --- running the audits on a gloo group --------------------------------------------

#: Every audit, by JAX's name.
AUDITS = {
    "check_1d_sparse": check_1d_sparse,
    "check_2d": check_2d,
    "check_planned_sparse": check_planned_sparse,
    "check_rows_delta": check_rows_delta,
    "check_2d_sparse": check_2d_sparse,
    "check_rows_sparse": check_rows_sparse,
    "check_minplus_exchange": check_minplus_exchange,
    "check_packed_exchange": check_packed_exchange,
    "check_wire_checksum": check_wire_checksum,
    "check_gated_hybrid": check_gated_hybrid,
    "check_sliced_hybrid": check_sliced_hybrid,
}
_TWO_D = ("check_2d", "check_2d_sparse")


def make_graph(spec):
    """A port graph from a picklable spec: ``("random", n, m, seed[,
    weights])`` or ``("rmat", scale, edge_factor, seed)``."""
    from tpu_bfs_torch.graph.generate import random_graph, rmat_graph

    if spec[0] == "random":
        kw = {"weights": spec[4]} if len(spec) > 4 else {}
        return random_graph(spec[1], spec[2], seed=spec[3], **kw)
    if spec[0] == "rmat":
        return rmat_graph(spec[1], spec[2], seed=spec[3])
    raise ValueError(f"unknown graph spec {spec!r}")


def audit_rank(mesh, audits) -> dict:
    """Run ``audits`` (``[(name, graph spec or None, kwargs), ...]``) in
    this rank, every rank the same list; returns ``{"reports": [...],
    "signature": [...]}``, the signature this rank's ordered collectives
    (``analysis/uniformity.check_rank_signatures`` compares them)."""
    from tpu_bfs_torch.parallel.mesh import make_mesh_2d

    reports, meshes_2d = [], {}
    with WireTap() as tap:
        for name, graph, kw in audits:
            kw = dict(kw)
            if name in _TWO_D:
                shape = (kw.pop("rows", 1), kw.pop("cols", mesh.num_shards))
                if shape not in meshes_2d:
                    meshes_2d[shape] = make_mesh_2d(*shape, mesh=mesh)
                target = meshes_2d[shape]
            else:
                target = mesh
            args = (target,) if graph is None else (make_graph(graph), target)
            reports.append(AUDITS[name](*args, **kw))
    return {"reports": reports, "signature": tap.signature()}


def gather_signatures(mesh, signature: list) -> list:
    """Every rank's ``signature`` (a list of plain tuples), gathered over
    ``mesh`` as pickled bytes outside any tap; the same list on every rank."""
    import pickle

    from tpu_bfs_torch.parallel import mesh as mesh_mod

    saved, mesh_mod._TAP = mesh_mod._TAP, None
    try:
        blob = torch.frombuffer(bytearray(pickle.dumps(signature)), dtype=torch.uint8)
        size = mesh.all_reduce_(torch.tensor([blob.numel()], dtype=torch.int64,
                                             device=mesh.device), "max")
        pad = torch.zeros(int(size.item()), dtype=torch.uint8, device=mesh.device)
        pad[: blob.numel()] = blob.to(mesh.device)
        every = mesh.all_gather_rows(pad[None]).view(mesh.num_shards, -1).cpu()
    finally:
        mesh_mod._TAP = saved
    return [pickle.loads(bytes(row.numpy())) for row in every]


def _audit_main(mesh, audits):
    torch.set_num_threads(1)
    out = audit_rank(mesh, audits)
    return {**out, "signatures": gather_signatures(mesh, out["signature"])}


# --- an engine's own run ------------------------------------------------------------


class ExchangeTap:
    """Counts a mesh engine's exchange bytes a branch over its own runs:
    the engine's exchange method (``method``) is wrapped on the instance,
    and each call's collectives (from the process's wire tap, which must be
    on) are booked to its branch (``branch_of(args, result)``). With
    ``measure_in_flags`` (the row gathers: their rung's count and gap ride
    the level's flag all-reduce beside the alive word), the all-reduce
    just before each call is booked too, less its 4-byte alive word (the
    termination flag, outside every model)."""

    def __init__(self, tap: WireTap, engine, method: str, branch_of, *,
                 measure_in_flags: bool = False):
        self.tap, self.engine, self.method = tap, engine, method
        self.measure_in_flags = measure_in_flags
        self.levels: dict = {}
        self.counted: dict = {}
        inner = getattr(engine, method)

        def call(*args, **kw):
            start = len(tap.calls)
            out = inner(*args, **kw)
            calls = tap.calls[start:]
            branch = int(branch_of(args, out))
            nbytes = _sum_calls(calls)
            if measure_in_flags:
                flags = [c for c in tap.calls[:start] if c.op == "all-reduce"]
                if flags and flags[-1].wire_bytes:  # control words, priced flat
                    nbytes += flags[-1].operand_bytes - 4.0
            self.levels[branch] = self.levels.get(branch, 0) + 1
            self.counted[branch] = self.counted.get(branch, 0.0) + nbytes
            return out

        setattr(engine, method, call)

    def report(self) -> dict:
        """Per branch the levels, the counted and the modeled bytes
        (levels x ``wire_bytes_per_level``); ``agree`` when all equal."""
        model = self.engine.wire_bytes_per_level()
        labels = getattr(self.engine, "exchange_branch_labels", lambda: None)() or [
            f"branch{i}" for i in range(len(model))]
        rows = {labels[b]: {"levels": n, "counted": self.counted[b],
                            "modeled": float(n * model[b])}
                for b, n in sorted(self.levels.items())}
        delattr(self.engine, self.method)
        return {"engine": type(self.engine).__name__, "branches": rows,
                "agree": bool(rows) and all(r["counted"] == r["modeled"]
                                            for r in rows.values())}


def branch_arg(args, _out) -> int:
    """The branch of an exchange that takes it as its second argument
    (``_exchange_rows``, ``_gather``)."""
    return args[1]


def branch_result(_args, out) -> int:
    """The branch of an exchange that returns it second
    (``_exchange_step``, ``_exchange_round``)."""
    return out[1]


def serve_rank_audits(ctx, devices: int, audits) -> dict:
    """:func:`audit_rank` on a serving mesh's rung of ``devices`` ranks
    (``parallel/mesh.MeshController.build`` runs it on every rank of the
    rung): the reports and every rank's signature."""
    mesh = ctx.mesh(devices)
    out = audit_rank(mesh, audits)
    return {"reports": out["reports"], "signatures": gather_signatures(mesh, out["signature"])}


def run_audits(p: int, audits) -> dict:
    """:func:`audit_rank` on a fresh gloo group of ``p`` CPU ranks: rank
    0's reports, and ``signatures``, every rank's ordered collectives."""
    from tpu_bfs_torch.parallel.mesh import launch

    return launch(p, _audit_main, list(audits), device="cpu", backend="gloo")
