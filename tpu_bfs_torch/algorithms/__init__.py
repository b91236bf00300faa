"""Packed multi-source BFS engines of the PyTorch port."""
