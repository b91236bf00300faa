"""Traffic: each mix is a data file ``<traffic>.json`` naming a key
sampler (``sampler``) and a loop (``loop``), modules of this folder, with
their parameters. The sampler draws search keys from ``--seed``; the loop
runs the measured window."""
