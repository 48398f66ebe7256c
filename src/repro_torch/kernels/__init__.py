"""Hand-written CUDA kernels of the serving path, each beside its plain
PyTorch version (run for CPU tensors) and a launch counter."""
