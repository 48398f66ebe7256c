"""The JAX package's three examples as modules of the port, each run as
``python -m repro_torch.examples.<name>`` on the card by default
(``--device cpu`` runs the kernels' plain versions) and callable as
``main(argv) -> dict``, the figures it prints:

- :mod:`~repro_torch.examples.quickstart`: Algorithm 1 on one 512×512
  matrix, SRR against QER under one rank budget;
- :mod:`~repro_torch.examples.ptq_serve`: calibrate, quantize three ways,
  then serve continuously, paged with prefix reuse, and speculatively;
- :mod:`~repro_torch.examples.train_e2e`: pretrain through a simulated
  preemption and resume, then QPEFT from the SRR and the QER inits.
"""
