"""PyTorch + CUDA port of the SRR (preserve-then-quantize) serving stack.

The JAX package ``repro`` is the reference; this package reproduces its
serving main path — SRR post-training quantization into the Q + LR
container, the RoPE/SwiGLU/GQA decoder (dense, or with DeepSeek-style
MoE blocks) and the continuous-batching engine over a slot or paged KV
cache — on an NVIDIA Hopper card. The seven Pallas kernels of the JAX
package are hand-written CUDA C++ kernels under ``kernels/csrc``; each
has a plain PyTorch version beside it, which the wrappers run for
tensors on the CPU.

The package imports ``torch``, ``numpy`` and the standard library only.
"""
