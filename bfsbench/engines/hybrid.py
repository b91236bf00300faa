"""``tpu_bfs_torch.algorithms.msbfs_hybrid.HybridMsBfsEngine``, the port's
flagship: dense 128x128 tiles through K2, the residual ELL through K1, the
adaptive push on light levels. The window calls its ``dispatch`` and
``fetch`` back to back, the pair its ``run`` makes once warmed."""

from __future__ import annotations

import numpy as np

from bfsbench.reference.bfs import UNREACHED


def build(graph, settings: dict, lanes: int, device, spans):
    from tpu_bfs_torch.algorithms.msbfs_hybrid import HybridMsBfsEngine
    from tpu_bfs_torch.graph.io import from_edges

    with spans.span("from_edges"):
        g = from_edges(graph.u, graph.v, num_vertices=graph.num_vertices, directed=False,
                       num_input_edges=graph.num_input_edges)
    push = settings.get("adaptive_push")
    with spans.span("engine_build"):
        engine = HybridMsBfsEngine(
            g, lanes=lanes, max_lanes=lanes, num_planes=settings["num_planes"],
            kcap=settings["kcap"], tile_thr=settings["tile_thr"],
            a_budget_bytes=settings["a_budget_bytes"],
            adaptive_push=None if push is None else tuple(push), device=device)
    if engine.lanes != lanes:
        raise RuntimeError(f"the engine took {engine.lanes} lanes, the cell asks {lanes}")
    return engine


def kernel_facts(engine) -> dict:
    """What the kernel readers need beyond a launch's shapes: for K2, the
    column slabs and row tiles its tile table names (``bfsbench/roofline.py``)."""
    from bfsbench.roofline import K2Tiles

    hg = engine.hg
    if not hg.num_tiles:
        return {}
    tiles = K2Tiles(len(np.unique(hg.col_tile)), int(np.count_nonzero(np.diff(hg.row_start))))
    return {"k2_tiles": {(hg.vt, hg.num_tiles): tiles}}


def counts(result):
    return int(result.num_levels), np.asarray(result.reached), np.asarray(result.edges_traversed)


def lane_outputs(result, lanes) -> tuple[np.ndarray, np.ndarray]:
    """``(dist [k, V] int32 with UNREACHED, ecc [k] int32)`` of ``lanes``."""
    from tpu_bfs_torch.graph.csr import INF_DIST

    dist = np.stack([result.distances_int32(int(i)) for i in lanes])
    dist[dist == INF_DIST] = UNREACHED
    return dist, np.asarray(result.ecc)[np.asarray(lanes)].astype(np.int32)
