"""Single-source BFS engine, the port of ``tpu_bfs/algorithms/bfs.py``.

The analog of the reference's host level loop (runCudaQueueBfs,
bfs.cu:542-629), and of ``./a.out src graph`` as a whole (bfs.cu:783-823).
The JAX engine compiles its level loop into one ``lax.while_loop``; here the
loop runs on the host and syncs with the device once per level, to read
whether the new frontier is empty (for 'dopt', the frontier's size and
out-degree sum, as one two-element tensor, which also picks the next
level's branch). A high-diameter graph pays that sync on every level:
``last_host_syncs`` counts them.

``start`` / ``advance`` / ``finish`` checkpoint a traversal to the host
(``utils/checkpoint.BfsCheckpoint``, real vertex ids): the loop resumes
from the saved state, bit-identical to no stop, on any single-source
engine of either package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_bfs_torch.algorithms._packed_common import resolve_device
from tpu_bfs_torch.algorithms.frontier import (
    INT32_MAX,
    EdgeData,
    default_dopt_caps,
    extract_parents,
    frontier_sums,
    level_step,
    out_degrees,
)
from tpu_bfs_torch.graph.csr import INF_DIST, DeviceGraph, Graph
from tpu_bfs_torch.utils.timing import run_timed

BACKENDS = ("scan", "segment", "scatter", "delta", "dopt")


def run_level_loop(step, frontier, visited, dist, level0: int, max_levels: int, *,
                   sums=None, first_sums=None, alive: bool = True):
    """The host level loop shared by the single-source engines.

    ``step(frontier, visited, *info)`` returns the next frontier. Without
    ``sums``, each level's one host sync reads whether the new frontier is
    empty (``info`` is then ``(None, None)``, and ``alive`` says whether the
    initial frontier is). With ``sums`` (a frontier -> [k] int64 device
    function whose first value is the frontier's size), that tensor is the
    level's one sync and ``info``, and ``first_sums`` gives it for the
    initial frontier. ``dist`` and ``visited`` are updated in place.
    Returns ``(frontier, level, syncs)``."""
    level, syncs = level0, 0
    info = tuple(first_sums) if sums is not None else (None, None)
    if sums is not None:
        alive = info[0] > 0
    while alive and level < max_levels:
        new = step(frontier, visited, *info)
        dist.masked_fill_(new, level + 1)
        visited |= new
        frontier = new
        level += 1
        if sums is None:
            alive = bool(new.any())
        else:
            info = tuple(sums(new).tolist())
            alive = info[0] > 0
        syncs += 1
    return frontier, level, syncs


def host_frontier_sums(frontier: np.ndarray, out_row_ptr: np.ndarray) -> tuple[int, int]:
    """(size, out-degree sum) of a host bool frontier over a row pointer:
    the first ``sums`` of a level loop, without a device read."""
    deg = np.diff(np.asarray(out_row_ptr, dtype=np.int64))[: len(frontier)]
    return int(frontier.sum()), int(deg[frontier].sum())


@dataclasses.dataclass
class BfsResult:
    source: int
    distance: np.ndarray  # [V] int32, INF_DIST if unreached
    parent: np.ndarray | None  # [V] int32, -1 if unreached, source -> source
    num_levels: int  # eccentricity of the source (max distance reached)
    reached: int  # vertices reached (incl. source)
    edges_traversed: int  # input edges with both endpoints reached (Graph500 TEPS)
    elapsed_s: float | None = None

    @property
    def teps(self) -> float | None:
        if not self.elapsed_s:
            return None
        return self.edges_traversed / self.elapsed_s

    def level_sizes(self) -> np.ndarray:
        """Frontier size per level, from the distance histogram (the
        reference reads a managed counter each level, bfs.cu:617)."""
        reached = self.distance[self.distance != INF_DIST]
        return np.bincount(reached, minlength=self.num_levels + 1)


class BfsEngine:
    """A device-resident graph and a level loop that runs BFS from any
    source (initCuda2 + runCudaQueueBfs, bfs.cu:308-360, 542-629).
    ``backend`` is one of ``BACKENDS``; ``caps`` is the 'dopt' rung ladder
    (default ``default_dopt_caps``). ``device`` is CUDA unless named."""

    def __init__(self, graph: Graph | DeviceGraph, *, backend: str = "scan", device=None,
                 caps: tuple[int, ...] | None = None):
        if backend not in BACKENDS:
            raise KeyError(f"unknown expansion backend {backend!r}; have {sorted(BACKENDS)}")
        dg = DeviceGraph.from_graph(graph) if isinstance(graph, Graph) else graph
        if dg.ep >= 2**31 - 1:
            raise ValueError(f"{dg.ep} edge slots overflow the int32 device row pointers")
        self.dg = dg
        self.backend = backend
        self.device = resolve_device(device)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(self.device)

        self.src = put(dg.src)
        self.dst = put(dg.dst)
        need_delta, need_dopt = backend == "delta", backend == "dopt"
        nbr_sm = None
        if need_dopt:
            # Neighbor ids in src-major order: dst_sm[perm_ds[i]] = dst[i].
            dst_sm = np.empty(dg.ep, dtype=np.int32)
            dst_sm[dg.perm_ds] = dg.dst
            nbr_sm = put(dst_sm)
        if caps is None:
            caps = default_dopt_caps(dg.ep) if need_dopt else ()
        self.caps = tuple(sorted(set(caps)))
        self.edges = EdgeData(
            src=self.src, dst=self.dst, in_rp=put(dg.in_row_ptr),
            out_rp=put(dg.out_row_ptr) if (need_delta or need_dopt) else None,
            perm_ds=put(dg.perm_ds) if need_delta else None,
            nbr_sm=nbr_sm,
        )
        self._out_deg = out_degrees(self.edges) if need_dopt else None
        self.last_host_syncs = 0
        self._warmed = False

    @property
    def vp(self) -> int:
        return self.dg.vp

    def _init_state(self, source: int):
        frontier0 = torch.zeros(self.vp, dtype=torch.bool, device=self.device)
        frontier0[source] = True
        dist0 = torch.full((self.vp,), INT32_MAX, dtype=torch.int32, device=self.device)
        dist0[source] = 0
        return frontier0, frontier0.clone(), dist0

    def _loop(self, frontier, visited, dist, level0: int, max_levels: int,
              first: tuple[int, int]):
        """The level loop from a state; ``first`` is the initial frontier's
        (size, out-degree sum), known on the host, so the loop starts
        without a device read."""
        edges, backend, caps = self.edges, self.backend, self.caps

        def step(frontier, visited, nfront, fsum):
            return level_step(edges, frontier, visited, backend=backend, caps=caps,
                              nfront=nfront, fsum=fsum)

        kw = {"alive": first[0] > 0}
        if backend == "dopt":
            kw = {"sums": lambda f: frontier_sums(f, self._out_deg), "first_sums": first}
        frontier, level, syncs = run_level_loop(step, frontier, visited, dist, level0,
                                                max_levels, **kw)
        self.last_host_syncs = syncs
        return frontier, level

    def distances(self, source: int, *, max_levels: int | None = None):
        """Device distance array [vp] int32 and the loop's level count; no
        host transfer."""
        frontier0, visited, dist = self._init_state(source)
        ml = max_levels if max_levels is not None else self.vp
        rp = self.dg.out_row_ptr
        _, level = self._loop(frontier0, visited, dist, 0, ml,
                              (1, int(rp[source + 1] - rp[source])))
        return dist, level

    # --- checkpoint and resume (utils/checkpoint.py) ---

    def start(self, source: int):
        """Level-0 state as a host checkpoint (no device work)."""
        from tpu_bfs_torch.utils.checkpoint import initial_checkpoint

        return initial_checkpoint(self.dg.num_vertices, source)

    def _pad_state(self, ckpt):
        """A checkpoint's [V] arrays padded to [vp], on the host."""
        v, vp = self.dg.num_vertices, self.vp
        f = np.zeros(vp, dtype=bool)
        f[:v] = ckpt.frontier
        vis = np.zeros(vp, dtype=bool)
        vis[:v] = ckpt.visited
        d = np.full(vp, INF_DIST, dtype=np.int32)
        d[:v] = ckpt.distance
        return f, vis, d

    def advance(self, ckpt, levels: int | None = None):
        """At most ``levels`` more levels from a checkpoint, as a new host
        checkpoint (``done`` once the frontier is empty); resuming in
        chunks gives the distances of one uninterrupted run, bit for bit."""
        from tpu_bfs_torch.utils.checkpoint import BfsCheckpoint

        if len(ckpt.frontier) != self.dg.num_vertices:
            raise ValueError(f"checkpoint has {len(ckpt.frontier)} vertices, graph has "
                             f"{self.dg.num_vertices}")
        f0, vis0, d0 = self._pad_state(ckpt)
        cap = ckpt.level + levels if levels is not None else self.vp
        put = lambda a: torch.from_numpy(a).to(self.device)  # noqa: E731
        visited, dist = put(vis0), put(d0)
        frontier, level = self._loop(put(f0.copy()), visited, dist, ckpt.level,
                                     min(cap, self.vp),
                                     host_frontier_sums(f0, self.dg.out_row_ptr))
        v = self.dg.num_vertices
        return BfsCheckpoint(
            source=ckpt.source, level=int(level),
            frontier=frontier.cpu().numpy()[:v], visited=visited.cpu().numpy()[:v],
            distance=dist.cpu().numpy()[:v], nonce=ckpt.nonce,
        )

    def finish(self, ckpt, *, with_parents: bool = True) -> BfsResult:
        """A (finished or partial) checkpoint as a BfsResult."""
        _, _, d0 = self._pad_state(ckpt)
        return self._package(torch.from_numpy(d0).to(self.device), ckpt.source,
                             with_parents, None)

    def run(self, source: int, *, max_levels: int | None = None, with_parents: bool = True,
            time_it: bool = False) -> BfsResult:
        if not (0 <= source < self.dg.num_vertices):
            raise ValueError(f"source {source} out of range")
        elapsed = None
        if time_it:
            (dist_dev, _), elapsed = run_timed(
                lambda: self.distances(source, max_levels=max_levels),
                warm=not self._warmed, device=self.device,
            )
            self._warmed = True
        else:
            dist_dev, _ = self.distances(source, max_levels=max_levels)
        return self._package(dist_dev, source, with_parents, elapsed)

    def _package(self, dist_dev, source: int, with_parents: bool, elapsed) -> BfsResult:
        v = self.dg.num_vertices
        parent = None
        if with_parents:
            parent = extract_parents(self.src, self.dst, dist_dev, source).cpu().numpy()[:v]
        dist = dist_dev.cpu().numpy()[:v]
        reached_mask = dist != INF_DIST
        reached = int(reached_mask.sum())
        # The loop's level count includes the last step, which finds an
        # empty frontier; the source's eccentricity is the max distance.
        num_levels = int(dist[reached_mask].max()) if reached else 0
        return BfsResult(
            source=source, distance=dist, parent=parent, num_levels=num_levels,
            reached=reached, edges_traversed=self._count_traversed_edges(dist_dev != INT32_MAX),
            elapsed_s=elapsed,
        )

    def _count_traversed_edges(self, reached_mask: torch.Tensor) -> int:
        """Graph500 TEPS numerator: input edges with both endpoints reached,
        counted over directed slots and halved for undirected graphs (each
        input edge is two slots, bfs.cu:860-861). ``reached_mask`` is the
        [vp] device mask; the count runs on the device, where the edges
        are (the JAX engine counts on the host)."""
        e = self.dg.num_edges
        slots = int((reached_mask.index_select(0, self.src[:e])
                     & reached_mask.index_select(0, self.dst[:e])).sum())
        return slots // 2 if self.dg.undirected else slots


def bfs(graph: Graph, source: int, *, backend: str = "scan", with_parents: bool = True,
        max_levels: int | None = None, device=None) -> BfsResult:
    """One-shot BFS (builds a BfsEngine per call)."""
    return BfsEngine(graph, backend=backend, device=device).run(
        source, with_parents=with_parents, max_levels=max_levels
    )
