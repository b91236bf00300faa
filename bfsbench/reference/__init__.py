"""The plain reference: NumPy only, independent of the program.

It builds its own adjacency from the edge list the benchmark hands both
sides, labels components, counts each component's input edges by
Graph500's rule, and runs a breadth-first search. It imports neither
``jax`` nor ``tpu_bfs`` nor anything of ``tpu_bfs_torch``.
"""
