"""Public API: the Engine, ClusterSpec, the strategy registry."""
from .cluster import ClusterSpec, resolve_devices
from .engine import Engine, EngineState, demo_cost_model
from .strategies import (STRATEGY_REGISTRY, DHPStrategy, StaticStrategy,
                         Strategy, available_strategies, get_strategy)

__all__ = ["ClusterSpec", "resolve_devices", "Engine", "EngineState",
           "demo_cost_model", "STRATEGY_REGISTRY", "DHPStrategy",
           "StaticStrategy", "Strategy", "available_strategies",
           "get_strategy"]
