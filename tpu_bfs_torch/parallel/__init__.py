"""The port's mesh engines on ``torch.distributed``: one process per rank,
each building its own shard and running the same level loop (SPMD)."""
