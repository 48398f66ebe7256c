"""Serving of the port: continuous batching (or the bucketed baseline),
per-request sampling, self-speculative decoding, the OpenAI-compatible
HTTP frontend and the serving observability (telemetry, sanitizer)."""
from repro_torch.serve.engine import Engine, Request, Result, ServeConfig
from repro_torch.serve.http import (EngineServer, encode_text, render_chat,
                                    serve_http)
from repro_torch.serve.pages import PagedKVCache, PagePool, set_block_table_row
from repro_torch.serve.prefix import RadixPrefixCache
from repro_torch.serve.sampling import SamplingParams, lane_seed, sample_tokens
from repro_torch.serve.sanitizer import Sanitizer, SanitizerError
from repro_torch.serve.scheduler import (ContinuousScheduler, SchedulerStats,
                                         StepBudget)
from repro_torch.serve.slots import SlotKVCache, SlotState, SlotTable, write_slot
from repro_torch.serve.telemetry import (NULL_TELEMETRY, MetricsRegistry,
                                         NullTelemetry, Telemetry, Tracer,
                                         latency_summary, percentile)

__all__ = [
    "ContinuousScheduler", "Engine", "EngineServer", "MetricsRegistry",
    "NULL_TELEMETRY", "NullTelemetry", "PagePool", "PagedKVCache",
    "RadixPrefixCache", "Request", "Result", "SamplingParams",
    "Sanitizer", "SanitizerError",
    "SchedulerStats", "ServeConfig", "SlotKVCache", "SlotState",
    "SlotTable", "StepBudget", "Telemetry", "Tracer", "encode_text",
    "lane_seed", "latency_summary", "percentile", "render_chat",
    "sample_tokens", "serve_http", "set_block_table_row", "write_slot",
]
