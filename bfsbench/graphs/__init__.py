"""Graph generators, one module a family, named by a configuration's
``graph.generator``. Each has ``edges(params, build_dir) -> (u, v)`` (int64
endpoints of every input edge, in generation order) and ``source_files()``
(the files whose hash keys the benchmark's edge-list cache)."""
