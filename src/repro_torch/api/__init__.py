"""Public API: the Engine, ClusterSpec, the strategy registry."""
from .cluster import ClusterSpec, resolve_devices
from .engine import (Engine, StepMetrics, demo_cost_model,
                     metrics_from_json, metrics_to_json)
from .strategies import (STRATEGY_REGISTRY, DHPStrategy, StaticStrategy,
                         Strategy, available_strategies, get_strategy)

__all__ = ["ClusterSpec", "resolve_devices", "Engine", "StepMetrics",
           "metrics_from_json", "metrics_to_json",
           "demo_cost_model", "STRATEGY_REGISTRY", "DHPStrategy",
           "StaticStrategy", "Strategy", "available_strategies",
           "get_strategy"]
