"""``repro_torch.obs`` — the observability export surface (port of
``repro.obs``).

Serving-side primitives live in :mod:`repro_torch.serve.telemetry`;
quantize-time introspection in :mod:`repro_torch.obs.quant`::

    from repro_torch import obs
    p95 = obs.percentile(latencies, 0.95)
    reg = obs.MetricsRegistry()
    rec = obs.QuantRecorder()
"""
from repro_torch.obs.quant import (
    NULL_QUANT_RECORDER,
    LayerQuantRecord,
    NullQuantRecorder,
    QuantRecorder,
)
from repro_torch.serve.telemetry import (
    NULL_TELEMETRY,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NullTelemetry,
    Telemetry,
    Tracer,
    latency_summary,
    log_buckets,
    percentile,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "LayerQuantRecord", "MetricsRegistry",
    "NULL_QUANT_RECORDER", "NULL_TELEMETRY", "NullQuantRecorder",
    "NullTelemetry", "QuantRecorder", "Telemetry", "Tracer",
    "latency_summary", "log_buckets", "percentile",
]
