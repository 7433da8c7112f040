"""repro_torch.obs — tracing and metrics (stdlib-only, below core)."""
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .trace import (NULL_TRACER, NullTracer, Tracer, get_tracer,
                    set_tracer, tracing)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "NULL_TRACER", "NullTracer", "Tracer", "get_tracer", "set_tracer",
    "tracing",
]
