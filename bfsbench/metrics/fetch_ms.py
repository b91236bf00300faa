"""The window's ``fetch`` spans, summed, over its batches: milliseconds of
lane statistics and result assembly a batch."""


def read(record):
    n = record.spans.count("fetch", after=record.run.t0)
    return record.spans.seconds("fetch", after=record.run.t0) * 1e3 / n if n else None
