"""SRR post-training quantization (identity scaling) for the port."""
