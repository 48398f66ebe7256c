"""PyTorch + CUDA port of the SRR (preserve-then-quantize) serving stack.

The JAX package ``repro`` is the reference; this package reproduces its
serving main path — SRR post-training quantization into the Q + LR
container, the dense RoPE/SwiGLU/GQA decoder and the continuous-batching
engine — on an NVIDIA Hopper card. The four Pallas kernels of that path
are hand-written CUDA C++ kernels under ``kernels/csrc``; each has a
plain PyTorch version beside it, which the wrappers run for tensors on
the CPU.

The package imports ``torch``, ``numpy`` and the standard library only.
"""
