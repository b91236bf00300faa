"""The analysed program inventory, the port of ``tpu_bfs/analysis/configs.py``:
one :class:`ProgramSpec` a program of each of JAX's configs
(:data:`ALL_CONFIGS`, JAX's names) that the port builds.

Engines with an AOT inventory give theirs (``export_programs()``: the
packed engines' level step, seed, lane stats, extraction and ecc; the
mesh engines' rank-local ``dist_core``, ``dist_settle``,
``dist_sssp_core``, ``dist_sssp_close``); the others give
``analysis_programs()`` of the same form (``DistBfsEngine``'s expansion
and claim, ``SsspEngine``'s light round and close, the CC label fold, the
p2p pair reductions, k-hop's base programs). Each is exported with
``utils/aot.export_program``; the mesh engines' programs are rank-local
(the collectives run on the host between them), so rank 0's are the
ones analysed, every rank building each engine in the same order.

The graph is JAX's calibration shape (``random_graph(96, 480, seed=3)``,
with ``weights=5`` for SSSP). The mesh is the sweep's rank group: JAX's
configs name 8 devices (2 x 4 for 2D); here the mesh has the sweep's
ranks (2 by default: 1 x 2 for 2D). The three ``*-pallas`` configs differ
from their twins only in JAX's Pallas interpret flag, which the port does
not have (its kernels are the same ops either way): they are in
:data:`NOT_BUILT`, with that reason.
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

#: Configs the port has no counterpart of, with the reason.
NOT_BUILT = {
    "serve-wide-pallas": "JAX's expand_impl='pallas' interpret flag; the port's K1 is the same "
                         "registered op in every config (serve-landmark-warm's wide engine)",
    "serve-sssp-pallas": "JAX's expand_impl='pallas' interpret flag (serve-sssp runs K1 minplus)",
    "serve-dynamic-pallas": "JAX's expand_impl='pallas' interpret flag (serve-dynamic runs K1 "
                            "under the overlay fold)",
}

ALL_CONFIGS = (
    "1d-ring", "1d-allreduce", "1d-sparse", "1d-sparse-planner", "1d-dopt",
    "2d-ring", "2d-allreduce", "2d-dopt", "2d-sparse", "2d-sparse-planner",
    "wide-sparse-rows", "wide-delta-rows",
    "hybrid-dense", "hybrid-sparse", "hybrid-sliced",
    "serve-dist-wide", "serve-dist-hybrid", "serve-dist2d",
    "serve-sssp", "serve-khop", "serve-cc", "serve-p2p",
    "serve-dist-sssp", "serve-dist-sssp-2d",
    "serve-dist-cc", "serve-dist-khop", "serve-dist-p2p",
    "serve-landmark-warm",
    "serve-wide-pallas", "serve-sssp-pallas",
    "serve-dynamic", "serve-dynamic-pallas", "serve-dynamic-sssp",
)

@dataclasses.dataclass
class ProgramSpec:
    config: str  # e.g. "1d-sparse-planner"
    label: str  # the program, e.g. "claim"
    fn: object
    args: tuple  # example arguments: tensors and utils/aot.ArgSpec shapes
    engine: object

    @property
    def name(self) -> str:
        return f"{self.config}/{self.label}"

    def export(self):
        """The program's ``torch.export.ExportedProgram`` (made once)."""
        ep = self.__dict__.get("_exported")
        if ep is None:
            from tpu_bfs_torch.utils.aot import export_program

            ep = self.__dict__["_exported"] = export_program(self.fn, self.args)
        return ep


@lru_cache(maxsize=2)
def _graph(weighted: bool = False):
    from tpu_bfs_torch.graph.generate import random_graph

    kw = {"weights": 5} if weighted else {}
    return random_graph(96, 480, seed=3, **kw)


_PLANNER = dict(exchange="sparse", delta_bits=(8, 16), sieve=True, predict=True)
_ONE_D = {"1d-ring": dict(exchange="ring"), "1d-allreduce": dict(exchange="allreduce"),
          "1d-sparse": dict(exchange="sparse"), "1d-sparse-planner": _PLANNER,
          "1d-dopt": dict(exchange="ring", backend="dopt")}
_TWO_D = {"2d-ring": dict(exchange="ring"), "2d-allreduce": dict(exchange="allreduce"),
          "2d-dopt": dict(exchange="ring", backend="dopt"), "2d-sparse": dict(exchange="sparse"),
          "2d-sparse-planner": _PLANNER}
#: Single-device serve configs, built through the registry (JAX's specs).
_REGISTRY = {
    "serve-sssp": dict(kind="sssp", engine="wide", lanes=32),
    "serve-khop": dict(kind="khop", engine="wide", lanes=64),
    "serve-cc": dict(kind="cc", engine="wide", lanes=64),
    "serve-p2p": dict(kind="p2p", engine="wide", lanes=64),
    "serve-landmark-warm": dict(engine="wide", lanes=32),
    "serve-dynamic": dict(engine="wide", lanes=32, overlay=(64, 32)),
    "serve-dynamic-sssp": dict(kind="sssp", engine="wide", lanes=32, overlay=(64, 32)),
}


def is_mesh_config(config: str) -> bool:
    return config not in _REGISTRY


def build_engine(config: str, *, mesh=None, mesh2d=None, device="cpu"):
    """The port's engine of JAX config ``config``: a mesh config on this
    rank's ``mesh`` (``mesh2d`` for the 2D ones), a single-device one on
    ``device``."""
    if config in NOT_BUILT:
        raise KeyError(f"{config}: not built by the port ({NOT_BUILT[config]})")
    g = _graph()
    if config in _REGISTRY:
        from tpu_bfs_torch.serve.registry import EngineRegistry, EngineSpec

        kw = _REGISTRY[config]
        if kw.get("kind") == "sssp":
            g = _graph(True)
        reg = EngineRegistry(capacity=1, warm=False, device=device)
        return reg.get(EngineSpec(graph_key=reg.add_graph("g", g), **kw))
    from tpu_bfs_torch.parallel.dist_bfs import DistBfsEngine
    from tpu_bfs_torch.parallel.dist_bfs2d import Dist2DBfsEngine, Dist2DServeEngine
    from tpu_bfs_torch.parallel.dist_msbfs_hybrid import DistHybridMsBfsEngine
    from tpu_bfs_torch.parallel.dist_msbfs_wide import DistWideMsBfsEngine
    from tpu_bfs_torch.parallel.dist_sssp import DistSsspEngine
    from tpu_bfs_torch.workloads.cc import CcServeEngine
    from tpu_bfs_torch.workloads.khop import KhopServeEngine
    from tpu_bfs_torch.workloads.p2p import P2pServeEngine

    if config in _ONE_D:
        return DistBfsEngine(g, mesh, **_ONE_D[config])
    if config in _TWO_D:
        return Dist2DBfsEngine(g, mesh2d, **_TWO_D[config])
    if config == "wide-sparse-rows":
        return DistWideMsBfsEngine(g, mesh, lanes=64, exchange="sparse")
    if config in ("wide-delta-rows", "serve-dist-wide"):
        return DistWideMsBfsEngine(g, mesh, lanes=64, exchange="sparse", delta_bits=(8, 16))
    if config.startswith("hybrid-"):
        return DistHybridMsBfsEngine(g, mesh, exchange=config.split("-", 1)[1])
    if config == "serve-dist-hybrid":
        return DistHybridMsBfsEngine(g, mesh, lanes=4096, exchange="sparse")
    if config in ("serve-dist2d", "serve-dist-khop"):
        eng = Dist2DServeEngine(g, Dist2DBfsEngine(g, mesh2d, **_PLANNER), lanes=32)
        return KhopServeEngine(eng) if config == "serve-dist-khop" else eng
    if config == "serve-dist-sssp":
        return DistSsspEngine(_graph(True), mesh, lanes=32, exchange="sparse",
                              delta_bits=(8, 16), predict=True)
    if config == "serve-dist-sssp-2d":
        return DistSsspEngine(_graph(True), mesh2d, lanes=32, exchange="allreduce")
    if config == "serve-dist-cc":
        return CcServeEngine(DistWideMsBfsEngine(g, mesh, lanes=64, exchange="sparse"))
    if config == "serve-dist-p2p":
        return P2pServeEngine(DistWideMsBfsEngine(g, mesh, lanes=64, exchange="sparse",
                                                  delta_bits=(8, 16)))
    raise KeyError(config)


def programs_of(engine) -> list:
    """``[(label, fn, args), ...]``: the engine's AOT inventory, else its
    ``analysis_programs()``."""
    if hasattr(engine, "export_programs"):
        return [(name, fn, args) for name, _attr, fn, args in engine.export_programs()]
    if hasattr(engine, "analysis_programs"):
        return list(engine.analysis_programs())
    return []


def iter_programs(configs=None, *, mesh=None, mesh2d=None, device="cpu", analyse=True):
    """Yield a :class:`ProgramSpec` a program of every requested config
    the port builds, engines built one at a time. Every rank of ``mesh``
    calls this with the same configs (the mesh engines' builds are
    collective); ``analyse=False`` (ranks past 0) builds the mesh engines
    and yields nothing."""
    for config in configs or ALL_CONFIGS:
        if config in NOT_BUILT:
            continue
        if not analyse and not is_mesh_config(config):
            continue
        eng = build_engine(config, mesh=mesh, mesh2d=mesh2d, device=device)
        if not analyse:
            continue
        for label, fn, args in programs_of(eng):
            yield ProgramSpec(config, label, fn, args, eng)
