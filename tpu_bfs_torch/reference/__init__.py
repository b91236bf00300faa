"""CPU golden oracles of the PyTorch port."""

from tpu_bfs_torch.reference.cpu_bfs import bfs_golden, bfs_python, bfs_scipy

__all__ = ["bfs_golden", "bfs_python", "bfs_scipy"]
