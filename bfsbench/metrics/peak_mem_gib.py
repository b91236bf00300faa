"""``torch.cuda.max_memory_allocated()`` over set-up and window (the peak
statistics reset at process start), in GiB; none without a card."""


def read(record):
    return None if record.peak_bytes is None else record.peak_bytes / 2**30
