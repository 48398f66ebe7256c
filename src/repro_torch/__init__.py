"""PyTorch + CUDA port of the SRR (preserve-then-quantize) system.

The JAX package ``repro`` is the reference; this package reproduces all
of it that is not XLA's own on an NVIDIA Hopper card: the paper's
library (``core``: SRR, the QER baselines, the scalings, the rank
oracle, QPEFT) and quantizers, calibration, the ten architectures of the
model zoo, the serving engine (continuous or bucketed batching over a
slot or paged KV cache, sampling, speculative decoding, the HTTP
frontend and its observability), training and QPEFT, the lowering tools
and the three examples (``examples``). The seven Pallas kernels of the
JAX package are hand-written CUDA C++ kernels under ``kernels/csrc``;
each has a plain PyTorch version beside it, which the wrappers run for
tensors on the CPU.

The package imports ``torch``, ``numpy`` and the standard library only.
"""
