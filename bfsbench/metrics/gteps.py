"""Traversed edges of every lane of every batch the window completed, over
the window's seconds, in billions. A lane's traversed edges are Graph500's:
the input edges of its key's component, from the reference's component
table, so the count of work does not depend on the program."""


def read(record):
    run, table = record.run, record.reference.table
    edges = sum(int(table.traversed(b.keys).sum()) for b in run.batches if b.error is None)
    return edges / run.seconds / 1e9
