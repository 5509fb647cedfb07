"""The benchmark of ``scann_tpu_torch``, the PyTorch and CUDA package.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the CUDA card
and prints one JSON line. Everything that belongs to one configuration,
traffic mix, per-cell limit or metric is a file of its own, found by the
name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the deployment (data shape, index recipe,
  stated guarantees);
- ``mixes/<traffic>.json``: the traffic, read by ``traffic.py``;
- ``limits/<cell>.json``: the limits of the numbers that decide
  ``correct``;
- ``metrics/<metric>.py``: one reader a metric, ``read(run)``.

``reference/`` is the plain reference (plain PyTorch, imports nothing of
the program). Nothing here imports ``jax`` or the JAX package.
"""
