"""PyTorch and CUDA port of tpu_bfs: bit-packed multi-source BFS on an NVIDIA H100.

The JAX package ``tpu_bfs`` stays the reference; this package mirrors its
module names (``graph/``, ``ops/``, ``algorithms/``, ``reference/``) and
imports nothing of it. The two TPU kernels are CUDA C++ in ``csrc/``, built
at first use (``ops/_build.py``); each has a plain PyTorch twin that runs
for CPU tensors. Engines run on CUDA unless given ``device="cpu"``.
"""

__version__ = "0.1.0"
