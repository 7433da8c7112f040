"""Continuous-batching serving: KV cache accounting, the DHP-planned
scheduler, slot decode steps, the ServingEngine runtime and synthetic
request traces."""
from .runtime import RequestMetrics, ServeReport, ServingEngine
from .scheduler import ServeRequest
from .trace import sample_trace

__all__ = ["RequestMetrics", "ServeReport", "ServingEngine",
           "ServeRequest", "sample_trace"]
