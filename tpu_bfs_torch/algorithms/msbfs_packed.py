"""The 512-lane bit-packed multi-source engine, the port of
``tpu_bfs/algorithms/msbfs_packed.py``: the CLI's engine for batches of
512 sources or fewer.

A batch of up to ``lanes`` sources runs as one traversal over [rows, w]
int32 tables, 32 lanes a word. Each level expands the frontier through the
bucketed ELL, one K1 (``ell_expand``, CUDA on the card) launch per bucket
and the heavy rows' fold pyramid: the JAX ``make_packed_expand`` is the same
gather-OR over the same ``build_ell`` tables as the wide engine's
``make_expand``, so this engine is the wide one (``msbfs_wide.py``) with 8
counter planes, a depth cap of 254 levels, a fixed lane count and the JAX
result API (``PackedBfsResult``). The JAX engine caps a deeper traversal
silently; this one raises, as the wide engine does, unless ``run`` is given
a smaller ``max_levels``.

``UNREACHED`` and ``ripple_increment_`` live in ``_packed_common.py`` (the
packed machinery imports them) and are re-exported here, where the JAX
package defines them.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from tpu_bfs_torch.algorithms._packed_common import (
    UNREACHED,
    PackedBatchResult,
    packed_aot_programs,
    ripple_increment_,
)
from tpu_bfs_torch.algorithms.msbfs_wide import WidePackedMsBfsEngine
from tpu_bfs_torch.graph.csr import Graph
from tpu_bfs_torch.graph.ell import EllGraph

__all__ = ["MAX_LEVELS", "UNREACHED", "PackedBfsResult", "PackedMsBfsEngine",
           "ripple_increment_"]

MAX_LEVELS = 254  # the bit-sliced counters are 8 planes wide


@dataclasses.dataclass
class PackedBfsResult(PackedBatchResult):
    """A packed batch's result with the JAX ``PackedBfsResult`` API: besides
    ``distances_int32``, ``parents_int32``, ``parents_into``, ``teps``,
    ``reached``, ``edges_traversed``, ``ecc`` and ``num_levels``, the whole
    [S, V] ``distance_u8`` table."""

    _dist_u8: np.ndarray | None = None

    @property
    def distance_u8(self) -> np.ndarray:
        """[S, V] uint8 distances, UNREACHED where not reached; decoded from
        the device state on first access, one 32-lane word at a time."""
        if self._dist_u8 is None:
            self._dist_u8 = np.stack(
                [self.distance_u8_lane(i) for i in range(len(self.sources))])
            self._word_cache.clear()
        return self._dist_u8


class PackedMsBfsEngine(WidePackedMsBfsEngine):
    """Runs up to ``lanes`` BFS sources concurrently, bit-packed (``lanes``
    a multiple of 32; 256 is the JAX package's default, w = 8 words).
    ``graph`` is a ``Graph`` or a prebuilt ``EllGraph`` (which several
    engines may share; ``ell`` shares one beside a ``Graph``); ``undirected``
    overrides the ELL's flag for the TEPS count. ``device`` is CUDA unless
    named."""

    result_cls = PackedBfsResult
    # The JAX engine runs its own loop outside the packed fetch, so it
    # records no per-level trace; neither does this one.
    records_run_trace = False

    def __init__(self, graph: Graph | EllGraph, *, lanes: int = 256, kcap: int = 64,
                 undirected: bool | None = None, ell: EllGraph | None = None, device=None):
        if lanes % 32 or lanes < 32:
            raise ValueError("lanes must be a multiple of 32")
        super().__init__(graph, lanes=lanes, kcap=kcap, num_planes=8, ell=ell, device=device)
        if undirected is not None:
            self.undirected = undirected

    def export_programs(self):
        """JAX's inventory of this engine (``msbfs_packed.py``): ``core``,
        ``extract`` (here the per-word extraction the result decodes with),
        ``lane_stats`` and ``lane_ecc``; the seed is absent, as in JAX, where
        it is a host pass."""
        progs = {name: entry for name, *entry in packed_aot_programs(self)}
        return [("extract" if name == "extract_word" else name, *progs[name])
                for name in ("core", "extract_word", "lane_stats", "lane_ecc")]
