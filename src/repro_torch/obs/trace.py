"""Tracing — monotonic-clock spans exported as Chrome trace-event JSON.

The DHP pitch is "millisecond-class planning hidden behind execution",
which is exactly the kind of claim a scalar metric cannot settle: you
need to SEE the planner thread's solve sitting under the device step,
which stage of a slow schedule() ate the budget, and which rank's group
stretched a wave. `Tracer` records that timeline:

  * spans (`ph: "X"` complete events) + instants + counter tracks,
    timestamped off ONE `time.perf_counter()` epoch so host threads and
    simulated-rank tracks share a timebase;
  * one track per host thread (main loop, lookahead planner thread, …)
    under the "host" process, and one track per simulated rank under the
    "ranks" process — the per-rank timeline the straggler analytics in
    `obs/report.py` visualise;
  * a ring buffer (`capacity` events, oldest evicted first) so tracing a
    long run has bounded memory;
  * `to_json()` / `save()` emit the Chrome trace-event format — load the
    file at https://ui.perfetto.dev or chrome://tracing.

The module-global default tracer is a `NullTracer` whose every method is
a no-op (`get_tracer()` in a hot path costs one attribute read); callers
opt in per run via `set_tracer` or the `tracing(...)` context manager —
`Engine.train(trace=...)` and `ServingEngine.run(trace=...)` do this.

Everything here is stdlib-only: the obs package sits BELOW repro_torch.core
in the import graph so any layer may instrument itself.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Iterator, Optional

#: Chrome trace-event process ids: host python threads vs simulated ranks.
PID_HOST = 1
PID_RANKS = 2

_PROCESS_NAMES = {PID_HOST: "host", PID_RANKS: "ranks"}


class _NullSpan:
    """Reusable no-op context manager (no allocation per span)."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """The disabled tracer: every method is a true no-op."""

    enabled = False

    def span(self, name: str, cat: str = "host", *,
             args: Optional[dict] = None) -> _NullSpan:
        return _NULL_SPAN

    def complete(self, name: str, start_s: float, dur_s: float,
                 cat: str = "host", *, args: Optional[dict] = None,
                 pid: Optional[int] = None,
                 tid: Optional[int] = None) -> None:
        pass

    def rank_span(self, name: str, rank: int, start_s: float,
                  dur_s: float, *, args: Optional[dict] = None) -> None:
        pass

    def instant(self, name: str, cat: str = "host", *,
                args: Optional[dict] = None) -> None:
        pass

    def counter(self, name: str, values: Dict[str, float]) -> None:
        pass


NULL_TRACER = NullTracer()


class _Span:
    """Context manager recording one complete event on the current
    thread's track."""

    __slots__ = ("_tr", "_name", "_cat", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Optional[dict]):
        self._tr = tracer
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        self._tr.complete(self._name, self._t0, t1 - self._t0,
                          self._cat, args=self._args)
        return False


class Tracer:
    """Thread-safe ring-buffered trace recorder.

    All timestamps come from `time.perf_counter()` relative to the
    tracer's construction instant, exported in microseconds (the Chrome
    trace-event unit). Thread ids are assigned in registration order
    (tid 0 = first thread to emit — usually the main loop; the lookahead
    planner thread gets its own track automatically). Rank-track events
    (`rank_span`) land under a separate "ranks" process with tid = rank
    index.
    """

    enabled = True

    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._t0 = time.perf_counter()
        #: deque(maxlen=...) IS the ring buffer: appends past capacity
        #: evict the OLDEST event, so the newest window always survives.
        self._events: "deque[dict]" = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._thread_ids: Dict[int, int] = {}
        self._track_names: Dict[tuple, str] = {}
        self.dropped = 0          # events evicted by the ring buffer

    # -- track bookkeeping ----------------------------------------------
    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._thread_ids.get(ident)
        if tid is None:
            with self._lock:
                tid = self._thread_ids.setdefault(
                    ident, len(self._thread_ids))
                self._track_names.setdefault(
                    (PID_HOST, tid), threading.current_thread().name)
        return tid

    def _rank_tid(self, rank: int) -> int:
        key = (PID_RANKS, int(rank))
        if key not in self._track_names:
            with self._lock:
                self._track_names.setdefault(key, f"rank {int(rank)}")
        return int(rank)

    def _ts(self, t_s: float) -> float:
        return (t_s - self._t0) * 1e6

    def _push(self, ev: dict) -> None:
        if len(self._events) == self.capacity:
            self.dropped += 1
        self._events.append(ev)

    # -- emission --------------------------------------------------------
    def span(self, name: str, cat: str = "host", *,
             args: Optional[dict] = None) -> _Span:
        """Context manager: a complete event on the calling thread's
        track, timed from __enter__ to __exit__."""
        return _Span(self, name, cat, args)

    def complete(self, name: str, start_s: float, dur_s: float,
                 cat: str = "host", *, args: Optional[dict] = None,
                 pid: Optional[int] = None,
                 tid: Optional[int] = None) -> None:
        """A complete event with EXPLICIT perf_counter() times — for
        callers that already hold the timestamps (the scheduler's stage
        clocks, the executor's measured group seconds)."""
        ev = {"name": name, "cat": cat, "ph": "X",
              "ts": self._ts(start_s), "dur": max(dur_s, 0.0) * 1e6,
              "pid": PID_HOST if pid is None else pid,
              "tid": self._tid() if tid is None else tid}
        if args:
            ev["args"] = args
        self._push(ev)

    def rank_span(self, name: str, rank: int, start_s: float,
                  dur_s: float, *, args: Optional[dict] = None) -> None:
        """A complete event on simulated rank `rank`'s track."""
        self.complete(name, start_s, dur_s, "rank", args=args,
                      pid=PID_RANKS, tid=self._rank_tid(rank))

    def instant(self, name: str, cat: str = "host", *,
                args: Optional[dict] = None) -> None:
        ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
              "ts": self._ts(time.perf_counter()),
              "pid": PID_HOST, "tid": self._tid()}
        if args:
            ev["args"] = args
        self._push(ev)

    def counter(self, name: str, values: Dict[str, float]) -> None:
        """A counter-track sample (`ph: "C"`) — Perfetto renders these as
        stacked area charts (e.g. KV occupancy, queue depth)."""
        self._push({"name": name, "cat": "counter", "ph": "C",
                    "ts": self._ts(time.perf_counter()),
                    "pid": PID_HOST, "tid": 0,
                    "args": dict(values)})

    # -- export ----------------------------------------------------------
    def __len__(self) -> int:
        return len(self._events)

    def to_json(self) -> dict:
        """The Chrome trace-event document. Metadata (process/thread
        names) lives outside the ring buffer so track labels survive
        eviction."""
        with self._lock:
            names = dict(self._track_names)
            events = list(self._events)
        meta = []
        for pid, pname in _PROCESS_NAMES.items():
            meta.append({"name": "process_name", "ph": "M", "pid": pid,
                         "tid": 0, "args": {"name": pname}})
        for (pid, tid), tname in sorted(names.items()):
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tid, "args": {"name": tname}})
        return {"traceEvents": meta + events,
                "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)


# -- schema validation --------------------------------------------------------
_REQUIRED = {"X": ("ts", "dur"), "i": ("ts",), "C": ("ts", "args"),
             "M": ("args",)}


def validate_trace(obj: Any) -> int:
    """Validate a Chrome trace-event document; returns the event count.

    Checks the invariants Perfetto/chrome://tracing rely on — top-level
    `traceEvents` list; every event carries `name`/`ph`/`pid`/`tid`;
    per-phase required fields (`ts`+`dur` for complete events, `ts` for
    instants/counters, `args` for metadata); numeric, non-negative
    times. Raises ValueError on the first violation."""
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("trace must be a dict with a traceEvents list")
    events = obj["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("traceEvents must be a list")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i} is not an object")
        for field in ("name", "ph", "pid", "tid"):
            if field not in ev:
                raise ValueError(f"event {i} missing {field!r}: {ev}")
        ph = ev["ph"]
        if ph not in _REQUIRED:
            raise ValueError(f"event {i} has unknown phase {ph!r}")
        if not isinstance(ev["pid"], int) or not isinstance(ev["tid"],
                                                            int):
            raise ValueError(f"event {i}: pid/tid must be ints: {ev}")
        for field in _REQUIRED[ph]:
            if field not in ev:
                raise ValueError(
                    f"event {i} (ph={ph}) missing {field!r}: {ev}")
        for field in ("ts", "dur"):
            if field in ev:
                v = ev[field]
                if not isinstance(v, (int, float)) or v < 0:
                    raise ValueError(
                        f"event {i}: {field} must be a non-negative "
                        f"number, got {v!r}")
    return len(events)


# -- the process-global default tracer ---------------------------------------
_tracer: Any = NULL_TRACER


def get_tracer():
    """The process-global tracer (NULL_TRACER unless a run opted in)."""
    return _tracer


def set_tracer(tracer) -> Any:
    """Install `tracer` as the global default (None -> NULL_TRACER)."""
    global _tracer
    _tracer = tracer if tracer is not None else NULL_TRACER
    return _tracer


@contextmanager
def tracing(tracer) -> Iterator[Any]:
    """Scoped `set_tracer`: restores the previous tracer on exit."""
    prev = _tracer
    set_tracer(tracer)
    try:
        yield _tracer
    finally:
        set_tracer(prev)
