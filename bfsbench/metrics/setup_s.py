"""Process start to the first timed batch: graph, ``from_edges``, engine
build, kernel load and one warm batch of the cell's shape."""


def read(record):
    return record.setup_s
