"""The benchmark's span around the engine's constructor (the host table
build, the push table, the copies to the device)."""


def read(record):
    return record.spans.seconds("engine_build")
