"""repro_torch.obs — tracing, metrics and post-run analytics
(stdlib-only, below core)."""
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .report import (GroupRecord, RunRecorder, RunReport, build_report,
                     scale_fit, scale_fit_mape, step_model_error,
                     straggler_scores, wave_stats)
from .trace import (NULL_TRACER, NullTracer, Tracer, get_tracer,
                    set_tracer, tracing, validate_trace)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "GroupRecord", "RunRecorder", "RunReport", "build_report",
    "scale_fit", "scale_fit_mape", "step_model_error",
    "straggler_scores", "wave_stats",
    "NULL_TRACER", "NullTracer", "Tracer", "get_tracer", "set_tracer",
    "tracing", "validate_trace",
]
