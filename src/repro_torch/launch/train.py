"""End-to-end training launcher: a thin wrapper over the port's Engine
CLI (`repro_torch.api.cli`).

There is ONE training loop (`Engine.train`): heterogeneous batches from a
video-length distribution, the selected Strategy planning every global
batch (with a lookahead thread), and the executor running each CP group
through the kernels, as a ring where its degree is above 1. `--mode`
(alias `--strategy`) selects the parallelism policy from the registry:

  * `static` / `megatron` / `deepspeed` — fixed-degree baselines;
  * `dhp` / `dhp-faithful`              — the paper's dynamic system;
  * `bruteforce`                        — exact Stage-2 solver (tiny runs);
  * `oracle`                            — plans with measured costs.

On the card unless `--device cpu`:

  python -m repro_torch.launch.train --arch internvl3-2b --mode dhp --steps 20
  python -m repro_torch.launch.train --reduced --device cpu --steps 2

The default stays the legacy `--mode static` (the Engine CLI defaults
to dhp). The old `run_static` / `run_dhp` entry points remain as
deprecated shims that route through the same Engine loop.
"""
from __future__ import annotations

import warnings

from ..api.cli import build_parser, run  # noqa: F401  (re-export)
from ..api.cli import main as _api_main


def main(argv=None):
    """Legacy launcher entry: keeps the default of `--mode static`."""
    _api_main(argv, default_strategy="static")


def _run_with_strategy(args, strategy: str):
    args.strategy = strategy
    if not hasattr(args, "mode"):
        args.mode = strategy
    return [m.loss for m in run(args)]


def run_static(args):
    """Deprecated: use `repro_torch.api.Engine(strategy='static').train()`."""
    warnings.warn(
        "run_static is deprecated; use repro_torch.api.Engine with "
        "strategy='static'", DeprecationWarning, stacklevel=2)
    return _run_with_strategy(args, "static")


def run_dhp(args):
    """Deprecated: use `repro_torch.api.Engine(strategy='dhp').train()`."""
    warnings.warn(
        "run_dhp is deprecated; use repro_torch.api.Engine with "
        "strategy='dhp'", DeprecationWarning, stacklevel=2)
    return _run_with_strategy(args, "dhp")


if __name__ == "__main__":
    main()
