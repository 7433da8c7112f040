"""DHP core — the host-side planner the serving path runs: cost model
(Eqs. 7-10), Stage-1 BFD packing, Stage-2 2D-DP allocation, the plan IR
and its cache, and the bucketing pool."""
from .allocator import Allocation, IncrementalAllocator
from .cost_model import (CostCoeffs, CostModel, Hardware, ModalitySpan,
                         SeqInfo, analytic_coeffs, slice_spans, spans_eta)
from .group_pool import (BUCKET_LADDERS, GroupPool, PoolStats,
                         make_bucket_fn, pow2_bucket)
from .packing import AtomicGroup, fill_modality_row, pack_sequences
from .scheduler import (PLAN_IR_VERSION, DHPScheduler, ExecutionPlan,
                        GroupPlan, MicroBatchPlan, MicroBatchPlanner,
                        PlanCache, PlanValidationError, static_plan)

__all__ = [
    "Allocation", "IncrementalAllocator",
    "CostCoeffs", "CostModel", "Hardware", "ModalitySpan", "SeqInfo",
    "analytic_coeffs", "slice_spans", "spans_eta",
    "BUCKET_LADDERS", "GroupPool", "PoolStats", "make_bucket_fn",
    "pow2_bucket",
    "AtomicGroup", "fill_modality_row", "pack_sequences",
    "PLAN_IR_VERSION", "DHPScheduler", "ExecutionPlan", "GroupPlan",
    "MicroBatchPlan", "MicroBatchPlanner", "PlanCache",
    "PlanValidationError", "static_plan",
]
