"""Serving engine of the port: continuous batching (or the bucketed
baseline), per-request sampling and self-speculative decoding."""
from repro_torch.serve.engine import Engine, Request, Result, ServeConfig
from repro_torch.serve.sampling import SamplingParams

__all__ = ["Engine", "Request", "Result", "SamplingParams", "ServeConfig"]
