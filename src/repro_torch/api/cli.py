"""The port's Engine CLI: `python -m repro_torch.api.cli` trains, and
`python -m repro_torch.api.cli serve` serves (also the
`repro-torch-train` and `repro-torch-serve` scripts).

One loop, every strategy; on the card unless `--device cpu`:

  python -m repro_torch.api.cli --arch internvl3-2b --strategy dhp --steps 20
  python -m repro_torch.api.cli --strategy megatron --reduced --device cpu
  python -m repro_torch.api.cli --list-strategies

Plan IR persistence (the JAX package's file format, so either package
replays the other's trace):

  python -m repro_torch.api.cli --steps 10 --save-plans plans.json
  python -m repro_torch.api.cli --replay-plans plans.json   # same groups

Serving a synthetic request trace through the continuous-batching
runtime:

  python -m repro_torch.api.cli serve --arch internvl3-2b --requests 16
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from ..core.scheduler import load_plans, save_plans
from .cluster import ClusterSpec
from .engine import Engine, StepMetrics
from .strategies import (ReplayStrategy, available_strategies,
                         get_strategy)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro-torch-train",
        description="Train via the unified Engine with a pluggable "
                    "parallelism strategy.")
    ap.add_argument("--arch", default="internvl3-2b")
    ap.add_argument("--strategy", default=None,
                    choices=available_strategies(),
                    help="parallelism strategy (default: dhp)")
    ap.add_argument("--mode", default=None,
                    choices=available_strategies(),
                    help="deprecated alias for --strategy")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8,
                    help="global batch (sequences per step)")
    ap.add_argument("--seq-len", type=int, default=512,
                    help="max tokens per sequence")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized model variant")
    ap.add_argument("--dataset", default="openvid")
    ap.add_argument("--mem-budget", type=float, default=1024.0,
                    help="per-rank activation budget in tokens (demo)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (every visible card, the default), "
                    "'cuda:i' or 'cpu'")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--list-strategies", action="store_true")
    ap.add_argument("--save-plans", metavar="PATH", default=None,
                    help="write the executed plan trace (Plan IR JSON) "
                    "to PATH for later --replay-plans")
    ap.add_argument("--replay-plans", metavar="PATH", default=None,
                    help="replay a saved plan trace instead of "
                    "planning (bit-identical group assignments)")
    ap.add_argument("--no-lookahead", action="store_true",
                    help="disable the planner pipeline: plan each "
                    "batch synchronously before executing it")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="write a Chrome trace-event JSON timeline of "
                    "the run to PATH (open at https://ui.perfetto.dev); "
                    "switches execution to measuring mode")
    ap.add_argument("--report", metavar="PATH", default=None,
                    help="write the post-run analytics report "
                    "(imbalance, stragglers, cost-model MAPE) to PATH "
                    "as JSON; implies measuring mode")
    ap.add_argument("--metrics", metavar="PATH", default=None,
                    help="write per-step StepMetrics history to PATH "
                    "as JSON")
    return ap


def make_engine(args, default_strategy: str = "dhp") -> Engine:
    """argparse namespace -> configured Engine."""
    from ..training.optimizer import AdamW, cosine_schedule

    replay = getattr(args, "replay_plans", None)
    if replay:
        strategy = ReplayStrategy(plans=load_plans(replay))
    else:
        name = (getattr(args, "strategy", None)
                or getattr(args, "mode", None) or default_strategy)
        strategy = get_strategy(name)
    cluster = ClusterSpec.auto(mem_budget=args.mem_budget,
                               device=getattr(args, "device", "cuda"))
    return Engine(
        args.arch,
        cluster,
        strategy=strategy,
        optimizer=AdamW(lr=cosine_schedule(args.lr, 10, args.steps)),
        reduced=args.reduced,
        seed=args.seed,
    )


def run(args, default_strategy: str = "dhp") -> List[StepMetrics]:
    """Build an Engine from CLI args and train: the whole command."""
    engine = make_engine(args, default_strategy)
    print(f"arch={engine.cfg.arch_id} strategy={engine.strategy.name} "
          f"ranks={engine.cluster.n_replicas} device={engine.device}")
    steps = args.steps
    if getattr(args, "replay_plans", None):
        steps = min(steps, len(engine.strategy))
        print(f"replaying {steps} recorded plans from "
              f"{args.replay_plans}")
    plan_log: Optional[list] = (
        [] if getattr(args, "save_plans", None) else None)
    trace = getattr(args, "trace", None)
    report = getattr(args, "report", None)
    history = engine.train(
        steps=steps, dataset=args.dataset,
        global_batch=args.batch, max_tokens=args.seq_len,
        lookahead=not getattr(args, "no_lookahead", False),
        plan_log=plan_log, log=print,
        trace=trace, report=report or bool(trace))
    print("executable pool:", engine.executor.pool.stats)
    cache = engine.strategy.plan_cache
    if cache is not None:
        print("plan cache:", cache.stats)
    if plan_log is not None:
        save_plans(args.save_plans, plan_log)
        print(f"saved {len(plan_log)} plans -> {args.save_plans}")
    if trace:
        print(f"saved trace -> {trace}")
    if engine.last_report is not None:
        print(engine.last_report.summary())
        if report:
            print(f"saved report -> {report}")
    metrics_path = getattr(args, "metrics", None)
    if metrics_path:
        import json

        from .engine import metrics_to_json
        with open(metrics_path, "w") as f:
            json.dump(metrics_to_json(history), f, indent=1)
        print(f"saved metrics -> {metrics_path}")
    if args.checkpoint:
        engine.save_checkpoint(args.checkpoint)
        print("saved", args.checkpoint)
    engine.close()
    return history


def main(argv: Optional[List[str]] = None, *,
         default_strategy: str = "dhp") -> None:
    args = build_parser().parse_args(argv)
    if args.list_strategies:
        for name in available_strategies():
            print(name)
        return
    run(args, default_strategy)


# ---------------------------------------------------------------------------
# serving: the continuous-batching runtime CLI
# ---------------------------------------------------------------------------
def build_serve_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro-torch-serve",
        description="Serve a synthetic heterogeneous request trace "
                    "through the continuous-batching runtime "
                    "(DHP-planned chunked prefill + paged KV cache).")
    ap.add_argument("--arch", default="internvl3-2b")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized model variant")
    ap.add_argument("--requests", type=int, default=16,
                    help="trace length (number of requests)")
    ap.add_argument("--dataset", default="openvid",
                    choices=("msrvtt", "internvid", "openvid"),
                    help="prompt-length distribution (paper Fig. 1)")
    ap.add_argument("--slots", type=int, default=4,
                    help="decode slots (bucketed to the pow2 ladder)")
    ap.add_argument("--max-prompt", type=int, default=192)
    ap.add_argument("--mean-new", type=int, default=16,
                    help="mean generated tokens per request (geometric)")
    ap.add_argument("--max-new", type=int, default=48)
    ap.add_argument("--prefill-chunk", type=int, default=64,
                    help="max prompt tokens prefetched per request per "
                    "iteration (chunked prefill)")
    ap.add_argument("--arrival-rate", type=float, default=None,
                    help="Poisson arrival rate (requests/s); default: "
                    "all requests arrive at t=0")
    ap.add_argument("--strategy", default="dhp",
                    help="prefill grouping strategy (registry name)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (every visible card, the default), "
                    "'cuda:i' or 'cpu'")
    ap.add_argument("--checkpoint", default=None,
                    help="load params from a checkpoint before serving")
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="write a Chrome trace-event JSON timeline of "
                    "the serving loop (prefill/decode spans, KV and "
                    "queue counter tracks) to PATH")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def serve_main(argv: Optional[List[str]] = None) -> None:
    import numpy as np

    from ..serving.trace import sample_trace

    args = build_serve_parser().parse_args(argv)
    engine = Engine(args.arch, ClusterSpec.auto(device=args.device),
                    strategy=args.strategy, reduced=args.reduced,
                    seed=args.seed)
    if args.checkpoint:
        engine.load_checkpoint(args.checkpoint)
    rng = np.random.default_rng(args.seed)
    trace = sample_trace(
        args.dataset, args.requests, rng, vocab=engine.cfg.vocab,
        max_prompt=args.max_prompt, mean_new_tokens=args.mean_new,
        max_new_tokens=args.max_new, arrival_rate=args.arrival_rate)
    srv = engine.serving(slots=args.slots,
                         prefill_chunk=args.prefill_chunk,
                         strategy=args.strategy)
    print(f"arch={engine.cfg.arch_id} family={engine.cfg.family} "
          f"slots={srv.n_slots} requests={len(trace)} "
          f"dataset={args.dataset} device={engine.device}")
    report = srv.run(trace, log=print, trace=args.trace)
    print(report.summary())
    if args.trace:
        print(f"saved trace -> {args.trace}")
    print(f"kv: peak_blocks={report.peak_kv_blocks} "
          f"occupancy_max={max(report.kv_occupancy):.2f} "
          f"cache_len={report.cache_len}")
    print(f"planner: schedule={report.schedule_ms:.1f}ms "
          f"plan_cache={report.plan_cache}")
    engine.close()


def entry(argv: Optional[List[str]] = None) -> None:
    """`python -m repro_torch.api.cli [serve] ...`: a first argument
    `serve` runs `serve_main` on the rest, anything else `main`."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["serve"]:
        serve_main(argv[1:])
    else:
        main(argv)


if __name__ == "__main__":
    entry()
