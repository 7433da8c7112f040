"""Dynamic group management & pooling (§5 Implementation (1)).

The paper pools communication groups because creating them per batch is
expensive. `GroupPool` keeps the pieces of that idea the port runs:

  * the padding-bucket ladder (`make_bucket_fn`) that bounds the number
    of distinct shapes a run meets — pow2 (default, fewest shapes,
    worst-case 2x padding), geometric 1.25x, or multiple-of-256;
  * `executable_for(key, build)` — a keyed, optionally LRU-capped cache
    of built step functions, with `PoolStats` hit/miss accounting. In
    eager PyTorch a "build" is cheap (no tracing), but the keys are the
    same bucketed shapes the JAX package compiles for, so the stats read
    the same way;
  * `mesh_for(start, degree)` — the devices of the rank slice
    [start, start+degree) (a rank is one device), cached per slot, and
    `reconfigure(delta)`, which consumes a plan's GroupDelta. The
    executor runs a group of degree > 1 as a ring on one device when
    the slot's ranks are that device (several ranks may name one card);
    a slot over several devices needs a process group a slot, which the
    executor with one process a card over NCCL will add.
"""
from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from functools import partial
from typing import (Any, Callable, Dict, Hashable, List, Optional,
                    Sequence, Tuple, Union)

from ..obs.trace import get_tracer


def pow2_bucket(n: int, minimum: int = 128) -> int:
    """Smallest power-of-two >= n (>= minimum) — the padding bucket."""
    b = minimum
    while b < n:
        b *= 2
    return b


def geometric_bucket(n: int, minimum: int = 128,
                     ratio: float = 1.25) -> int:
    """Smallest rung of a geometric `ratio` ladder >= n (8-aligned).

    Worst-case padding overhead is `ratio` (vs 2x for pow2) at the cost
    of log_ratio / log_2 more distinct rungs (~3.1x for ratio=1.25)."""
    b = minimum
    while b < n:
        b = int(math.ceil(b * ratio / 8.0)) * 8
    return b


def multiple_bucket(n: int, multiple: int = 256) -> int:
    """Round up to a multiple — near-constant absolute padding; the rung
    count grows linearly with the longest length seen."""
    return max(multiple, ((n + multiple - 1) // multiple) * multiple)


BUCKET_LADDERS = ("pow2", "geometric", "mult256")


def make_bucket_fn(kind: Union[str, Callable[[int], int]] = "pow2",
                   minimum: int = 64) -> Callable[[int], int]:
    """Resolve a bucket-ladder name (or pass a callable through)."""
    if callable(kind):
        return kind
    if kind == "pow2":
        return partial(pow2_bucket, minimum=minimum)
    if kind == "geometric":
        return partial(geometric_bucket, minimum=minimum)
    if kind == "mult256":
        return multiple_bucket
    raise ValueError(
        f"unknown bucket ladder {kind!r}; expected one of "
        f"{BUCKET_LADDERS} or a callable")


@dataclasses.dataclass
class PoolStats:
    mesh_hits: int = 0
    mesh_misses: int = 0
    exe_hits: int = 0
    exe_misses: int = 0
    exe_evictions: int = 0
    #: group slots (re)created because a GroupDelta named them as new or
    #: resized relative to the previous plan (see `reconfigure`).
    groups_reconfigured: int = 0


class GroupPool:
    """Rank slots, bucket ladder and cache of built step functions."""

    def __init__(self, devices: Sequence[Any] = (),
                 bucket_fn: Union[str, Callable[[int], int]] = "pow2",
                 max_executables: Optional[int] = None):
        """`devices`: one per rank. `bucket_fn`: padding-bucket ladder, a
        name from BUCKET_LADDERS or a callable n -> bucket.
        `max_executables`: LRU cap on the cache (None = unbounded)."""
        self.devices = list(devices)
        self.n_replicas = len(self.devices)
        self._meshes: Dict[Tuple[int, int], List[Any]] = {}
        self.bucket_fn = make_bucket_fn(bucket_fn)
        self.max_executables = max_executables
        self._exes: "OrderedDict[Hashable, Any]" = OrderedDict()
        self.stats = PoolStats()

    def bucket(self, n: int) -> int:
        """Padding bucket for `n` tokens under the pool's ladder."""
        return self.bucket_fn(n)

    def mesh_for(self, start: int, degree: int) -> List[Any]:
        """The devices of ranks [start, start+degree): a CP group's
        ring."""
        key = (start, degree)
        if key in self._meshes:
            self.stats.mesh_hits += 1
            return self._meshes[key]
        self.stats.mesh_misses += 1
        if not (0 <= start and degree >= 1
                and start + degree <= self.n_replicas):
            raise ValueError(f"rank slot {key} outside "
                             f"{self.n_replicas} ranks")
        mesh = self.devices[start:start + degree]
        self._meshes[key] = mesh
        return mesh

    def executable_for(self, key: Hashable,
                       build: Callable[[], Any]) -> Tuple[Any, bool]:
        """Memoized build: `build()` is invoked only on pool miss.

        Returns `(exe, was_miss)`. LRU: hits refresh recency; over-cap
        inserts evict the least-recently-used entry."""
        if key in self._exes:
            self.stats.exe_hits += 1
            self._exes.move_to_end(key)
            return self._exes[key], False
        self.stats.exe_misses += 1
        with get_tracer().span("exe_build", "pool",
                               args={"key": repr(key)}):
            exe = build()
        self._exes[key] = exe
        if (self.max_executables is not None
                and len(self._exes) > self.max_executables):
            self._exes.popitem(last=False)
            self.stats.exe_evictions += 1
        return exe, True

    def reconfigure(self, delta) -> Dict[str, int]:
        """Apply a plan's GroupDelta: create the slots the delta names as
        `created`/`resized` and count `reused` slots as zero-cost pool
        hits (§5 (1)). Returns {created, resized, reused} counts."""
        if delta is None:
            return {"created": 0, "resized": 0, "reused": 0}
        for start, degree in list(delta.created) + list(delta.resized):
            if start + degree <= self.n_replicas:
                self.mesh_for(start, degree)
        self.stats.groups_reconfigured += delta.n_reconfigured
        return {"created": len(delta.created),
                "resized": len(delta.resized),
                "reused": len(delta.reused)}

    def __len__(self) -> int:
        return len(self._exes)
