"""Engine adapters, one module an engine, named by a configuration's
``engine.name``. Each has ``build(graph, settings, lanes, device, spans)``
(the system under test, built from the benchmark's edge list), ``counts(result)``
(a batch's level count and per-lane reached and traversed-edge counts) and
``lane_outputs(result, lanes)`` (full distance rows and eccentricities of
some lanes) and ``kernel_facts(engine)`` (what the kernel readers need
beyond a launch's shapes). These are the only modules of the benchmark that import the
program."""
