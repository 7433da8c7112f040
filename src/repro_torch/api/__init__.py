"""Public API: the Engine, ClusterSpec, the strategy registry, the plan
IR and its files, and the serving runtime."""
from ..core.cost_model import MMSequence, ModalitySpan
from ..core.scheduler import (PLAN_IR_VERSION, ExecutionPlan, GroupDelta,
                              PlanCache, PlanValidationError, diff_plans,
                              load_plans, save_plans)
from ..serving.runtime import ServeReport, ServingEngine
from ..serving.scheduler import ServeRequest
from ..serving.trace import sample_trace
from .cluster import ClusterSpec, resolve_devices
from .engine import (Engine, StepMetrics, demo_cost_model,
                     metrics_from_json, metrics_to_json)
from .strategies import (STRATEGY_REGISTRY, BruteForceStrategy,
                         DHPStrategy, MeasuredCostModel, OracleStrategy,
                         ReplayStrategy, StaticStrategy, Strategy,
                         available_strategies, get_strategy,
                         register_strategy)

__all__ = [
    "ClusterSpec", "resolve_devices",
    "Engine", "StepMetrics", "demo_cost_model",
    "metrics_from_json", "metrics_to_json",
    "Strategy", "StaticStrategy", "DHPStrategy", "BruteForceStrategy",
    "OracleStrategy", "MeasuredCostModel", "ReplayStrategy",
    "STRATEGY_REGISTRY", "available_strategies", "get_strategy",
    "register_strategy",
    "MMSequence", "ModalitySpan",
    "PLAN_IR_VERSION", "ExecutionPlan", "GroupDelta", "PlanCache",
    "PlanValidationError", "diff_plans", "save_plans", "load_plans",
    "ServingEngine", "ServeReport", "ServeRequest", "sample_trace",
]
