"""The window's ``dispatch`` spans, summed, over the sum of its batches'
level counts (``num_levels``): host milliseconds a BFS level."""


def read(record):
    levels = sum(b.num_levels for b in record.run.batches if b.error is None)
    if not levels:
        return None
    return record.spans.seconds("dispatch", after=record.run.t0) * 1e3 / levels
