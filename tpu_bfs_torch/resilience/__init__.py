"""Mesh-level fault tolerance, the port of ``tpu_bfs/resilience``.

A mesh fault (a lost participant, a hung collective, a restarting
backend) turns into a degrade-and-resume instead of a failed query:

- :mod:`~tpu_bfs_torch.resilience.failover`: the degraded-mesh ladder
  (full mesh, then halvings, down to one device) and the engine a rung
  serves with;
- :mod:`~tpu_bfs_torch.resilience.probe`: the mesh heartbeat (an
  all-reduce of ones over a rung's ranks) and the background prober that
  promotes a degraded service back onto a wider mesh;
- :mod:`~tpu_bfs_torch.resilience.resume`: level-checkpointed query
  resume: the 2D serve engine snapshots a query's state every K levels,
  so a query re-admitted after a mesh fault continues from its last
  snapshot on the degraded mesh.

Detection is the shared classifier's (``utils/recovery.is_mesh_fault``),
the serve-tier wiring is ``serve/frontend.py``'s and injection is
``faults.py``'s mesh kinds.
"""

from tpu_bfs_torch.resilience.failover import degrade_ladder, floor_config, next_mesh_rung
from tpu_bfs_torch.resilience.probe import MeshHealthProbe, mesh_heartbeat
from tpu_bfs_torch.resilience.resume import ResumeCache, ResumePolicy

__all__ = [
    "MeshHealthProbe",
    "ResumeCache",
    "ResumePolicy",
    "degrade_ladder",
    "floor_config",
    "mesh_heartbeat",
    "next_mesh_rung",
]
