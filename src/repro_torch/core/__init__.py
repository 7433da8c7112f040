"""DHP core — the host-side planner: cost model (Eqs. 7-10), Stage-1
BFD packing, Stage-2 2D-DP allocation (with its exhaustive and
pure-Python oracles), the plan IR with its files and cache, the
bucketing pool, the Profiler that fits the cost model's coefficients
from timed groups, and the cluster simulator of the paper's tables."""
from .allocator import (Allocation, IncrementalAllocator, allocate,
                        allocate_bruteforce, allocate_many,
                        allocate_reference, evaluate_degrees)
from .cost_model import (CostCoeffs, CostModel, Hardware, MMSequence,
                         ModalitySpan, SeqInfo, analytic_coeffs,
                         as_seq_infos, slice_spans, spans_eta)
from .distributions import sample_batch, sample_mm_batch
from .group_pool import (BUCKET_LADDERS, GroupPool, PoolStats,
                         make_bucket_fn, pow2_bucket)
from .packing import AtomicGroup, fill_modality_row, pack_sequences
from .profiler import Profiler, profiling_grid
from .scheduler import (PLAN_IR_VERSION, DHPScheduler, ExecutionPlan,
                        GroupDelta, GroupPlan, MicroBatchPlan,
                        MicroBatchPlanner, PlanCache, PlanValidationError,
                        diff_plans, load_plans, plans_from_json,
                        plans_to_json, save_plans, static_plan)
from .simulator import ClusterSimulator, end_to_end_table, scaling_table

__all__ = [
    "Allocation", "IncrementalAllocator", "allocate",
    "allocate_bruteforce", "allocate_many", "allocate_reference",
    "evaluate_degrees",
    "CostCoeffs", "CostModel", "Hardware", "MMSequence", "ModalitySpan",
    "SeqInfo", "analytic_coeffs", "as_seq_infos", "slice_spans",
    "spans_eta", "sample_batch", "sample_mm_batch",
    "BUCKET_LADDERS", "GroupPool", "PoolStats", "make_bucket_fn",
    "pow2_bucket",
    "AtomicGroup", "fill_modality_row", "pack_sequences",
    "Profiler", "profiling_grid",
    "PLAN_IR_VERSION", "DHPScheduler", "ExecutionPlan", "GroupDelta",
    "GroupPlan", "MicroBatchPlan", "MicroBatchPlanner", "PlanCache",
    "PlanValidationError", "diff_plans", "load_plans", "plans_from_json",
    "plans_to_json", "save_plans", "static_plan",
    "ClusterSimulator", "end_to_end_table", "scaling_table",
]
