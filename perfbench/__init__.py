"""The benchmark of ``repro_torch``, the PyTorch/CUDA port, on one NVIDIA
H100.

``python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line. Everything that belongs to one configuration, traffic mix or
per-layer metric sits in a file of its own, found by its name:

* ``configs/<config>.json``: the model's sizes, dtypes and deployment;
  ``family`` names the modules ``models/<family>.py`` (raw weights from
  the seed, the port's model built on them) and
  ``reference/<family>.py`` (the plain f32 reference);
* ``traffic/<mix>.json``: a generator ``kind`` and its parameters; the
  kind is the module ``generators/<kind>.py``;
* ``metrics/<metric>.py``: one reader per per-layer metric;
* ``limits/<cell>.json``: the limit of each number the correctness check
  compares in that cell.

Nothing here imports ``jax``, ``jaxlib``, ``flax`` or the JAX package
``repro``; only the port is measured.
"""
