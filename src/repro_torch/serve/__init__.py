"""Continuous-batching serving engine of the port."""
from repro_torch.serve.engine import Engine, Request, Result, ServeConfig

__all__ = ["Engine", "Request", "Result", "ServeConfig"]
