"""Edge-centric BFS level primitives, the port of
``tpu_bfs/algorithms/frontier.py``.

One level of the reference's queue BFS (queueBfs, bfs.cu:134-165) claims
vertices with ``atomicMin`` and appends them with ``atomicAdd``. Here a level
is edge-centric and race-free:

    active[e] = frontier[src[e]]                         (gather)
    hit[v]    = OR over edges e with dst[e] == v of active[e]
    next      = hit & ~visited

Distances come from the level counter; parents are a pure function of the
final distances (``extract_parents``, one scatter-min after the loop).

Porting notes, each a place where PyTorch differs from JAX:

- JAX's ``.at[i].add`` accumulates duplicate indices; ``t[i] += x`` in torch
  keeps one of them. Every scatter with repeated indices here is
  ``index_add_`` or ``scatter_reduce_`` (``out_rp`` repeats at zero-degree
  vertices, and so do ``sparse_topdown``'s row starts).
- JAX drops out-of-range scatter indices (``mode="drop"``); torch raises (a
  device assert on CUDA). The guards send such writes to a dump row past the
  end, which is then cut off.
- ``jnp.nonzero(size=...)`` becomes a cumsum and an index write of static
  size (``_nonzero_static``), so the sparse step has no host sync of its own.
- ``lax.cond`` runs one branch on the device. Here the host picks the branch
  of ``level_step_dopt`` from the frontier's size and out-degree sum, which
  the engines read in the level's one host sync; the rung taken per level is
  the one JAX takes.
- Counters and prefix sums are int32 (``cumsum`` of a bool gives int64
  unless told otherwise): an [ep, K] scan of the batched engine is half the
  bytes. An [ep, K] prefix sum runs along the minor axis of its [K, ep]
  transpose (``_cumsum0``): torch's CUDA scan along a leading axis walks it
  with one thread per column.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

INT32_MAX = 2**31 - 1


class EdgeData(NamedTuple):
    """Device edge arrays of one graph (see ``graph/csr.DeviceGraph``), all
    int32. ``out_rp`` / ``perm_ds`` / ``nbr_sm`` may be None for backends
    that do not read them."""

    src: torch.Tensor  # [ep] dst-major
    dst: torch.Tensor  # [ep] non-decreasing
    in_rp: torch.Tensor  # [vp+1] CSR-by-dst boundaries
    out_rp: torch.Tensor | None = None  # [vp+1] CSR-by-src boundaries
    perm_ds: torch.Tensor | None = None  # [ep] src-major position of dst-major edge i
    nbr_sm: torch.Tensor | None = None  # [ep] neighbor (dst) ids in src-major order


_EXPAND_BACKENDS = {}


def expand_or(active, dst, in_row_ptr, vp: int, *, backend: str = "scan"):
    """hit[v] = OR over e with dst[e] == v of active[e].

    ``active`` is [ep] or [ep, K] bool (the edge axis leads). ``dst`` must be
    non-decreasing and below ``vp`` for 'scan' and 'segment'
    (``DeviceGraph`` guarantees both); ``in_row_ptr`` is the [vp+1]
    CSR-by-dst row pointer (None lets 'segment' derive it from ``dst``;
    'scan' needs it)."""
    if backend not in _EXPAND_BACKENDS:
        raise KeyError(
            f"unknown expansion backend {backend!r}; have {sorted(_EXPAND_BACKENDS)}"
        )
    return _EXPAND_BACKENDS[backend](active, dst, in_row_ptr, vp)


def _cumsum0(x):
    """int32 prefix sum along the leading (edge) axis of [n] or [n, K] ``x``.
    For [n, K] the scan runs over the contiguous [K, n] transpose, whose
    minor-axis scan is parallel within each row, and the result is viewed
    back as [n, K]."""
    if x.dim() == 1:
        return torch.cumsum(x, dim=0, dtype=torch.int32)
    return torch.cumsum(x.t().contiguous(), dim=1, dtype=torch.int32).t()


def _in_range(idx, n: int):
    """``idx`` with every entry outside [0, n) sent to the dump row n."""
    return torch.where((idx >= 0) & (idx < n), idx, n)


def _expand_scatter(active, dst, in_row_ptr, vp):
    # JAX: zeros.at[dst].max(active, mode="drop"). A count of hits per row
    # (index_add_ accumulates duplicates) is positive exactly where the OR is.
    hit = torch.zeros((vp + 1,) + active.shape[1:], dtype=torch.int32, device=active.device)
    hit.index_add_(0, _in_range(dst, vp), active.to(torch.int32))
    return hit[:vp] > 0


def _expand_segment(active, dst, in_row_ptr, vp):
    # JAX: segment_max over the sorted dst. torch.segment_reduce reduces
    # floating types only, so the 0/1 flags ride in float32 (exact).
    if in_row_ptr is None:
        in_row_ptr = torch.searchsorted(
            dst, torch.arange(vp + 1, dtype=dst.dtype, device=dst.device))
    seg = torch.segment_reduce(active.to(torch.float32), "max",
                               offsets=in_row_ptr.to(torch.int64), axis=0,
                               unsafe=True, initial=0.0)
    return seg > 0


def _expand_scan(active, dst, in_row_ptr, vp):
    """Scatter-free segment-OR: an int32 prefix sum of the active flags,
    differenced at the CSR-by-dst row boundaries, hit[v] = csum[rp[v+1]] -
    csum[rp[v]] > 0. (JAX prepends a zero row to the sum; here row rp - 1
    is gathered and rp == 0 masked to zero, which saves a copy of the
    [ep, K] sum.) The dense revival of the reference's dead scan-BFS
    pipeline (runCudaScanBfs, bfs.cu:706-781)."""
    csum = _cumsum0(active)
    at = csum.index_select(0, (in_row_ptr - 1).clamp_(min=0))
    nonzero = in_row_ptr > 0
    if at.dim() > 1:
        nonzero = nonzero[:, None]
    at = torch.where(nonzero, at, 0)
    return (at[1:] - at[:-1]) > 0


_EXPAND_BACKENDS["scatter"] = _expand_scatter
_EXPAND_BACKENDS["segment"] = _expand_segment
_EXPAND_BACKENDS["scan"] = _expand_scan


def active_bits_delta(frontier, out_rp, ep: int):
    """Frontier expansion into src-major edge space without a per-edge
    frontier gather: +1 / -1 at each frontier vertex's out-row boundaries,
    then a prefix sum. active[e] = 1 iff edge e's source is in the frontier.
    ``frontier`` is [vp] or [vp, K]. Zero-degree vertices repeat a boundary,
    so the marks accumulate (``index_add_``)."""
    f = frontier.to(torch.int32)
    delta = torch.zeros((ep + 1,) + frontier.shape[1:], dtype=torch.int32,
                        device=frontier.device)
    delta.index_add_(0, out_rp[:-1], f)
    delta.index_add_(0, out_rp[1:], -f)
    return _cumsum0(delta)[:ep] > 0


def _nonzero_static(mask, size: int):
    """The first ``size`` indices where the 1-D ``mask`` is set, as int32,
    zero-filled (``jnp.nonzero(mask, size=size, fill_value=0)``): an int32
    prefix sum and one index write, without a host sync."""
    pos = torch.cumsum(mask, dim=0, dtype=torch.int32) - 1
    slot = torch.where(mask & (pos < size), pos, size)
    out = torch.zeros(size + 1, dtype=torch.int32, device=mask.device)
    # Set slots are distinct; every unset entry lands in the dump slot.
    out[slot] = torch.arange(mask.shape[0], dtype=torch.int32, device=mask.device)
    return out[:size]


def sparse_topdown(edges: EdgeData, frontier, visited=None, *, edge_cap: int,
                   vert_cap: int, out_size: int | None = None):
    """One top-down level over only the frontier's out-edges, in static
    shapes: the frontier's adjacency lists laid head to head in an
    ``edge_cap``-slot buffer, one gather of the neighbors, one scatter of
    the hits. Work is O(vp + edge_cap) whatever E is; callers take this
    branch only when the frontier's out-degree sum fits. ``out_size`` sets
    the hit length when neighbors live in another index space;
    ``visited=None`` skips the claim."""
    vp = out_size if out_size is not None else frontier.shape[0]
    out_rp = edges.out_rp
    dev = frontier.device
    nfront = frontier.sum(dtype=torch.int32)
    vids = _nonzero_static(frontier, vert_cap)
    slot_ok = torch.arange(vert_cap, dtype=torch.int32, device=dev) < nfront
    deg = torch.where(slot_ok, out_rp[vids + 1] - out_rp[vids], 0)
    ends = torch.cumsum(deg, dim=0, dtype=torch.int32)
    starts = ends - deg
    total = ends[-1]
    # owner[j] = the compacted row that edge slot j belongs to: +1 at each
    # row start, prefix-summed. Zero-degree rows share a start, so the
    # marks accumulate; their rows own no slot.
    delta = torch.zeros(edge_cap + 1, dtype=torch.int32, device=dev)
    delta.index_add_(0, torch.clamp(starts, max=edge_cap), slot_ok.to(torch.int32))
    owner = torch.cumsum(delta[:edge_cap], dim=0, dtype=torch.int32) - 1
    eslot = torch.arange(edge_cap, dtype=torch.int32, device=dev)
    valid = eslot < total
    owner = owner.clamp_(0, vert_cap - 1)
    eidx = out_rp[vids[owner]] + (eslot - starts[owner])
    nbr = edges.nbr_sm[torch.where(valid, eidx, 0)]
    # JAX writes `valid` with max at vp - 1 for the invalid slots and drops
    # out-of-range ids; here both go to the dump row vp.
    hit = torch.zeros(vp + 1, dtype=torch.bool, device=dev)
    hit[torch.where(valid, _in_range(nbr, vp), vp)] = True
    hit = hit[:vp]
    return hit if visited is None else hit & ~visited


def default_dopt_caps(ep: int) -> tuple[int, ...]:
    """Capacity ladder of the sparse top-down rungs: about E/64 and E/8,
    rounded down to 1024. Levels whose frontier out-degree sum exceeds the
    top rung run the dense step."""
    return tuple(max(1024, (ep >> s) // 1024 * 1024) for s in (6, 3))


def out_degrees(edges: EdgeData):
    """[vp] int32 out-degree of each vertex (from ``out_rp``)."""
    return edges.out_rp[1:] - edges.out_rp[:-1]


def frontier_sums(frontier, out_deg):
    """[2] int64 device tensor (frontier size, frontier out-degree sum):
    what ``level_step_dopt`` picks its branch from, read by the host in one
    sync."""
    return torch.stack([frontier.sum(dtype=torch.int64),
                        torch.where(frontier, out_deg, 0).sum(dtype=torch.int64)])


def dopt_rung(caps, nfront: int, fsum: int, vp: int) -> int | None:
    """The smallest rung of ``caps`` whose edge capacity covers ``fsum``
    and whose vertex capacity (``min(cap, vp)``) covers ``nfront``; None
    selects the dense step. The JAX ``lax.cond`` chain nests the rungs so
    that the same one runs."""
    for edge_cap in sorted(caps):
        if fsum <= edge_cap and nfront <= min(edge_cap, vp):
            return edge_cap
    return None


def level_step_dopt(edges: EdgeData, frontier, visited, *, caps: tuple,
                    dense_backend: str = "scan", nfront: int | None = None,
                    fsum: int | None = None):
    """Direction-optimizing level step (Beamer's top-down/bottom-up switch
    in static shapes): the smallest rung of ``caps`` that covers the
    frontier runs ``sparse_topdown``, else the dense edge-centric step.
    ``nfront`` and ``fsum`` are the frontier's size and out-degree sum as
    host ints; without them this reads them (one host sync)."""
    vp = frontier.shape[0]
    if nfront is None or fsum is None:
        nfront, fsum = frontier_sums(frontier, out_degrees(edges)).tolist()
    edge_cap = dopt_rung(caps, nfront, fsum, vp)
    if edge_cap is not None:
        return sparse_topdown(edges, frontier, visited, edge_cap=edge_cap,
                              vert_cap=min(edge_cap, vp))
    active = frontier.index_select(0, edges.src)
    return expand_or(active, edges.dst, edges.in_rp, vp, backend=dense_backend) & ~visited


class DoptExpand:
    """Claim-free direction-optimizing expansion of the mesh engines
    (``tpu_bfs/algorithms/frontier.py:make_dopt_expand``).

    ``expand(frontier, nfront, fsum)`` returns hit [out_size]: the smallest
    rung of ``caps`` whose edge capacity covers the frontier's local
    out-degree sum ``fsum`` (and whose vertex capacity, ``min(cap,
    vert_limit)``, covers its size ``nfront``) runs ``sparse_topdown``,
    otherwise ``dense_fn(frontier)``. ``nfront`` and ``fsum`` are host
    ints, read from :meth:`sums` in the level's one host read, so each rank
    picks its own branch. No branch runs a collective: ranks may diverge,
    and the exchange and the termination count stay outside, as in JAX."""

    def __init__(self, edata: EdgeData, caps, *, vert_limit: int, out_size: int, dense_fn):
        self.edata, self.caps = edata, tuple(sorted(caps))
        self.vert_limit, self.out_size, self.dense_fn = vert_limit, out_size, dense_fn
        self.out_deg = out_degrees(edata)

    def sums(self, frontier):
        """[2] int64 device tensor: the frontier's size and out-degree sum."""
        return frontier_sums(frontier, self.out_deg)

    def __call__(self, frontier, nfront: int, fsum: int):
        edge_cap = dopt_rung(self.caps, nfront, fsum, self.vert_limit)
        if edge_cap is None:
            return self.dense_fn(frontier)
        return sparse_topdown(self.edata, frontier, None, edge_cap=edge_cap,
                              vert_cap=min(edge_cap, self.vert_limit), out_size=self.out_size)


def level_step(edges: EdgeData, frontier, visited, *, backend: str = "scan", caps=(),
               nfront: int | None = None, fsum: int | None = None):
    """One BFS level: the next frontier mask (one iteration of the
    reference's level loop, runCudaQueueBfs bfs.cu:569-621, with the visited
    test folded in as ``& ~visited``).

    'delta' replaces the data-dependent ``frontier[src]`` gather by a static
    permutation gather (``act_src[perm_ds]``); 'dopt' is
    :func:`level_step_dopt` over the ladder ``caps`` (``nfront`` / ``fsum``
    as there)."""
    vp = frontier.shape[0]
    if backend == "dopt":
        return level_step_dopt(edges, frontier, visited, caps=caps, nfront=nfront, fsum=fsum)
    if backend == "delta":
        act_src = active_bits_delta(frontier, edges.out_rp, edges.perm_ds.shape[0])
        active = act_src.index_select(0, edges.perm_ds)
        return _expand_scan(active, edges.dst, edges.in_rp, vp) & ~visited
    active = frontier.index_select(0, edges.src)
    return expand_or(active, edges.dst, edges.in_rp, vp, backend=backend) & ~visited


def min_parent_candidates(src, dst, dist):
    """Deterministic min-parent from a distance array, without the source
    fix-up: ``dist`` is [vp] or [vp, K] int32; parent[v] = min{u : (u, v) in
    E, dist[u] == dist[v] - 1}, -1 where unreached or parentless. One
    scatter-min replaces the reference's atomic-race parent claim
    (bfs.cu:146-147)."""
    du = dist.index_select(0, src)
    dv = dist.index_select(0, dst)
    ok = (du != INT32_MAX) & (du + 1 == dv)
    src_b = src if dist.dim() == 1 else src[:, None]
    cand = torch.where(ok, src_b, INT32_MAX)
    del du, dv, ok
    idx = dst.to(torch.int64)
    if dist.dim() > 1:
        idx = idx[:, None].expand_as(cand)
    parent = torch.full(dist.shape, INT32_MAX, dtype=torch.int32, device=dist.device)
    parent.scatter_reduce_(0, idx, cand, "amin")
    parent = torch.where(parent == INT32_MAX, -1, parent)
    return torch.where(dist == INT32_MAX, -1, parent)


def extract_parents(src, dst, dist, source: int):
    """Deterministic min-parent tree of a final [vp] distance array: the
    source maps to itself, unreached vertices to -1."""
    parent = min_parent_candidates(src, dst, dist)
    parent[source] = source
    return parent
