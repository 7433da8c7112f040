"""Continuous-batching serving: KV cache accounting, the DHP-planned
scheduler, slot decode steps and the ServingEngine runtime."""
from .runtime import RequestMetrics, ServeReport, ServingEngine
from .scheduler import ServeRequest

__all__ = ["RequestMetrics", "ServeReport", "ServingEngine",
           "ServeRequest"]
