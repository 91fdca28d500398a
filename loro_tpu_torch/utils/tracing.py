"""Lightweight tracing: spans -> Chrome trace JSON, plus trace contexts
(the port's copy of loro_tpu/utils/tracing.py).

reference: the `tracing` spans on loro's hot paths + dev-utils
(crates/dev-utils/src/lib.rs:9-31 writes ./log/trace-*.json for
chrome://tracing when DEBUG is set).  Same contract here: zero overhead
unless enabled (env LORO_TPU_TRACE=1 or enable()); `span(name)` context
managers on import/merge/export paths; dump() writes the trace file.

Span observers: add_span_observer() registers a callback that receives every span's (name, duration_s) so
ONE instrumentation point feeds both the chrome trace and the metrics
histograms.  ``instant()`` events fire observers too (duration 0.0), so
the bridge sees point events as well as spans.  With no observers and
tracing disabled, span() keeps its zero-overhead contract.

The observer list is COPY-ON-WRITE: ``span()`` iterates an immutable
tuple snapshot while add/remove rebuild it under the module lock, so a
concurrent (un)register can never skip or double-fire an observer
mid-iteration.

Trace contexts: a trace id is
a process-unique opaque string minted at a request entry point
(``new_trace_id()``) and carried end-to-end — push tickets, pipeline
rounds, WAL round stamps, follower applies.  ``set_current()`` /
``current()`` keep a per-thread ambient id so deep layers (the WAL
append inside a pipelined commit) can stamp the request that caused
them without threading an argument through every signature.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Tuple

_enabled = os.environ.get("LORO_TPU_TRACE", "") not in ("", "0")
_events: List[Dict[str, Any]] = []
_lock = threading.Lock()
_t0 = time.perf_counter()
# COW snapshot: readers iterate whatever tuple they loaded; writers
# replace the whole tuple under _lock (never mutate in place)
_span_observers: Tuple[Callable[[str, float], None], ...] = ()


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def is_enabled() -> bool:
    return _enabled


def add_span_observer(fn: Callable[[str, float], None]) -> None:
    """Register a (name, duration_seconds) callback fired at every span
    exit and instant event, independent of chrome-trace collection (the
    obs bridge).  Copy-on-write under the module lock: a span iterating
    the old snapshot is unaffected."""
    global _span_observers
    with _lock:
        if fn not in _span_observers:
            _span_observers = _span_observers + (fn,)


def remove_span_observer(fn: Callable[[str, float], None]) -> None:
    global _span_observers
    with _lock:
        if fn in _span_observers:
            _span_observers = tuple(f for f in _span_observers if f is not fn)


# -- trace contexts ----------------------------------------------------
# process-unique request ids: pid + monotonic counter (deterministic,
# no wall clock / randomness — chaos replays stay byte-stable where it
# matters and the id still tells you which process minted it)
_trace_counter = itertools.count(1)
_ambient = threading.local()


def new_trace_id(prefix: str = "t") -> str:
    """Mint a process-unique trace id (cheap: one counter bump)."""
    return f"{prefix}{os.getpid():x}-{next(_trace_counter):x}"


def set_current(trace_id: Optional[str]) -> None:
    """Install the ambient trace id for this thread (None clears it).
    Deep layers read it via ``current()`` to stamp work they perform on
    behalf of a request (e.g. the WAL append inside a commit)."""
    _ambient.trace = trace_id


def current() -> Optional[str]:
    """The ambient trace id of this thread, or None."""
    return getattr(_ambient, "trace", None)


@contextmanager
def ambient(trace_id: Optional[str]):
    """Scope an ambient trace id (restores the previous one)."""
    prev = current()
    set_current(trace_id)
    try:
        yield
    finally:
        set_current(prev)


@contextmanager
def span(name: str, **args):
    """Trace span; ~zero cost when tracing is off and no observer is
    registered."""
    obs = _span_observers  # COW snapshot: stable for this span
    if not _enabled and not obs:
        yield
        return
    start = (time.perf_counter() - _t0) * 1e6
    try:
        yield
    finally:
        end = (time.perf_counter() - _t0) * 1e6
        if _enabled:
            with _lock:
                _events.append(
                    {
                        "name": name,
                        "ph": "X",
                        "ts": start,
                        "dur": end - start,
                        "pid": os.getpid(),
                        "tid": threading.get_ident() % 0xFFFF,
                        "args": {k: _safe(v) for k, v in args.items()} if args else {},
                    }
                )
        for fn in obs:
            fn(name, (end - start) * 1e-6)


def instant(name: str, **args) -> None:
    obs = _span_observers
    if not _enabled and not obs:
        return
    if _enabled:
        with _lock:
            _events.append(
                {
                    "name": name,
                    "ph": "i",
                    "ts": (time.perf_counter() - _t0) * 1e6,
                    "pid": os.getpid(),
                    "tid": threading.get_ident() % 0xFFFF,
                    "s": "t",
                    "args": {k: _safe(v) for k, v in args.items()} if args else {},
                }
            )
    # point events reach the obs bridge too (duration 0.0): counters of
    # named occurrences, not timings
    for fn in obs:
        fn(name, 0.0)


def _safe(v):
    if isinstance(v, (int, float, str, bool)) or v is None:
        return v
    return str(v)


def events() -> List[Dict[str, Any]]:
    with _lock:
        return list(_events)


def clear() -> None:
    with _lock:
        _events.clear()


# dump() collision guard: the default filename carries the pid and a
# monotonic per-process counter, so two dumps in one wall-second differ
_dump_counter = itertools.count(1)


def dump(path: Optional[str] = None) -> str:
    """Write chrome://tracing JSON; returns the path.  The default
    path is collision-free across processes and across same-second
    dumps (timestamp + pid + per-process counter)."""
    if path is None:
        os.makedirs("log", exist_ok=True)
        path = os.path.join(
            "log",
            f"trace-{int(time.time())}-{os.getpid()}-{next(_dump_counter)}.json",
        )
    with _lock:
        data = {"traceEvents": list(_events)}
    with open(path, "w") as f:
        json.dump(data, f)
    return path
