"""Plain PyTorch references, one module per configuration family. Each
reads the raw tensors the harness drew and imports nothing of the port,
of JAX or of the JAX package."""
