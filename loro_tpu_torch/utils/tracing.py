"""Lightweight tracing: spans -> Chrome trace JSON, plus trace contexts
(the port's copy of loro_tpu/utils/tracing.py, with the port's profiler
mirror and device spans).

reference: the `tracing` spans on loro's hot paths + dev-utils
(crates/dev-utils/src/lib.rs:9-31 writes ./log/trace-*.json for
chrome://tracing when DEBUG is set).  Same contract here: zero overhead
unless enabled (env LORO_TPU_TRACE=1 or enable()); `span(name)` context
managers on import/merge/export paths; dump() writes the trace file.

Span observers: add_span_observer() registers a callback that receives every span's (name, duration_s) so
ONE instrumentation point feeds both the chrome trace and the metrics
histograms.  ``instant()`` events fire observers too (duration 0.0), so
the bridge sees point events as well as spans.  A span's args reach the
Chrome events alone.

The observer list is COPY-ON-WRITE: ``span()`` iterates an immutable
tuple snapshot while add/remove rebuild it under the module lock, so a
concurrent (un)register can never skip or double-fire an observer
mid-iteration.

Live and off.  A span is live when tracing is enabled or an observer is
registered; otherwise it is off: ``span()`` and ``device_span()`` only
yield (None), opening no profiler range, constructing no CUDA event and
taking no lock.  A live span yields its args dict, to which the body may
add args known only at its end (a count of fallbacks taken).

Profiler mirror.  While ``torch.profiler`` records, a live ``span(name)``
also opens ``record_function("loro_tpu_torch." + name)``, so the span sits
in the profiler's host timeline on the kernels' clock.

Device spans.  ``device_span(name, device=...)`` records a CUDA event
pair on the device's current stream around its body (live and on a CUDA
device only).  It is delivered later and never waited for:
``resolve_device_spans()`` delivers each pending pair whose end event has
completed (``Event.query()``), oldest first; fleet merges call it after
their fetch, and every live span calls it as it closes.  Delivered like a
span: a Chrome ``X`` event with ``cat: "device"`` whose ``ts`` is when the
start event was enqueued (host clock) and ``dur`` the events' elapsed
time, and the observers with that duration in seconds.  At most
``DEVICE_PENDING_MAX`` pairs wait; past that the oldest is dropped.  A
pair that cannot be recorded (a device error has poisoned the context)
is no span, and the body's own error stands.  Dropped and unrecorded
spans are counted in the module integer ``device_spans_dropped``, which
obs exports as ``trace.device_spans_dropped_total``.

Spans timed by the caller.  ``record(name, t0_ns, t1_ns)`` delivers a host
span the caller timed on ``time.perf_counter_ns()``, and
``add_device_span(name, t0_ns, start, end, device)`` queues an event pair the
caller recorded; both do nothing when off.  StageClock hands its stages
to tracing this way, so they have no profiler mirror.

Clock.  ``ts`` is microseconds of ``time.perf_counter_ns()`` since the
module's origin.  ``dump()`` writes that origin beside one reading of
both clocks (``otherData.clock``), so a dump lays onto a
``torch.profiler`` export, whose timestamps are on the epoch clock:
epoch_ns = time_ns - (perf_counter_ns - origin_perf_counter_ns) + ts * 1000.

Span catalogue (args in parentheses; "device" marks a device span):

- ``doc.import`` (bytes), ``decode`` (mode), ``oplog.import``
  (n_changes), ``state.apply`` (n_changes); instants ``doc.export``
  (mode), ``doc.internal_state`` (dump): the LoroDoc paths (doc.py).
- ``fleet.text.payloads`` (docs, payload_bytes): Fleet.merge_text_payloads,
  the whole call; ``fleet.text.changes`` (docs): merge_text_changes.
- ``fleet.text.extract`` (docs, fallbacks): the payload explode loop, or
  the change lists' extract.
- ``fleet.text.stack`` (docs, rows): stacking and padding the extracts.
- ``fleet.text.upload``: the first supervised launch of the text merge
  (host staging of the pageable upload); ``fleet.text.launch``: the
  second (the device merge's launches); ``fleet.text.merge_device``
  (device): events around the second launch on the mesh's first device.
- ``fleet.text.fetch``: both supervised fetches (the host waits for the
  card there); ``fleet.text.decode`` (docs): the texts' decode.
- ``fugue.rank`` (device; D, m): the list ranking of D rings of m tokens
  (ops/fugue_batch._order_core around _rank_dist).
- ``resident.<stage>``: each StageClock stage of a resident batch (host
  stages as spans, device stages as device spans on a card), with
  StageClock's own times.

Trace contexts: a trace id is
a process-unique opaque string minted at a request entry point
(``new_trace_id()``) and carried end-to-end — push tickets, pipeline
rounds, WAL round stamps, follower applies.  ``set_current()`` /
``current()`` keep a per-thread ambient id so deep layers (the WAL
append inside a pipelined commit) can stamp the request that caused
them without threading an argument through every signature.
"""
from __future__ import annotations

import collections
import itertools
import json
import os
import sys
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

_enabled = os.environ.get("LORO_TPU_TRACE", "") not in ("", "0")
_events: List[Dict[str, Any]] = []
_lock = threading.Lock()
_t0_ns = time.perf_counter_ns()  # the clock origin of every ts
# COW snapshot: readers iterate whatever tuple they loaded; writers
# replace the whole tuple under _lock (never mutate in place)
_span_observers: Tuple[Callable[[str, float], None], ...] = ()

PROFILER_PREFIX = "loro_tpu_torch."
DEVICE_PENDING_MAX = 4096
# device spans waiting for their end event: (name, ts_us, args, start, end, tid)
_pending: Deque[tuple] = collections.deque()
device_spans_dropped = 0  # device spans dropped or never recorded (obs: trace.device_spans_dropped_total)


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
    exit, device span delivery and instant event, independent of
    chrome-trace collection (the obs bridge).  Copy-on-write under the
    module lock: a span iterating the old snapshot is unaffected."""
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


def _now_us() -> float:
    return (time.perf_counter_ns() - _t0_ns) / 1e3


def _profiler_range(name: str):
    """An entered torch.profiler.record_function("loro_tpu_torch." + name)
    while torch's profiler records, else None.  A process that has not
    imported torch has no profiler running."""
    torch = sys.modules.get("torch")
    if torch is None or not torch._C._autograd._profiler_enabled():
        return None
    rf = torch.profiler.record_function(PROFILER_PREFIX + name)
    rf.__enter__()
    return rf


def _deliver(name: str, ts: float, dur_us: float, args: Dict[str, Any], obs, cat: Optional[str] = None,
             tid: Optional[int] = None) -> None:
    """One finished span to the Chrome events (when enabled) and the
    observer snapshot `obs`."""
    if _enabled:
        ev = {
            "name": name,
            "ph": "X",
            "ts": ts,
            "dur": dur_us,
            "pid": os.getpid(),
            "tid": threading.get_ident() % 0xFFFF if tid is None else tid,
            "args": {k: _safe(v) for k, v in args.items()} if args else {},
        }
        if cat is not None:
            ev["cat"] = cat
        with _lock:
            _events.append(ev)
    for fn in obs:
        fn(name, dur_us * 1e-6)


@contextmanager
def span(name: str, **args):
    """Trace span; ~zero cost when tracing is off and no observer is
    registered.  A live span yields its args dict (the body may add to
    it), mirrors itself into torch's profiler while that records, and
    delivers the device spans that have completed as it closes."""
    obs = _span_observers  # COW snapshot: stable for this span
    if not _enabled and not obs:
        yield None
        return
    note = _profiler_range(name)
    start = _now_us()
    try:
        yield args
    finally:
        end = _now_us()
        if note is not None:
            note.__exit__(None, None, None)
        _deliver(name, start, end - start, args, obs)
        if _pending:
            resolve_device_spans()


def record(name: str, t0_ns: int, t1_ns: int, **args) -> None:
    """Deliver a host span that the caller timed from `t0_ns` to `t1_ns`
    on time.perf_counter_ns(); nothing when off."""
    obs = _span_observers
    if not _enabled and not obs:
        return
    _deliver(name, (t0_ns - _t0_ns) / 1e3, (t1_ns - t0_ns) / 1e3, args, obs)


def _count_dropped(n: int) -> None:
    global device_spans_dropped
    with _lock:
        device_spans_dropped += n


def add_device_span(name: str, t0_ns: int, start, end, device, **args) -> None:
    """Queue a device span over an event pair the caller recorded on
    `device` (a torch.device of the card), `start` at time.perf_counter_ns()
    `t0_ns`; nothing when off.  Delivered by resolve_device_spans() once
    `end` has completed."""
    global device_spans_dropped
    if not _enabled and not _span_observers:
        return
    with _lock:
        if len(_pending) >= DEVICE_PENDING_MAX:
            _pending.popleft()
            device_spans_dropped += 1
        _pending.append((name, (t0_ns - _t0_ns) / 1e3, args, start, end, 0xCDA0 + (device.index or 0)))


@contextmanager
def device_span(name: str, device=None, **args):
    """Device span: a CUDA event pair on `device`'s current stream around
    the body, recorded only when live and `device` (a torch.device) is a
    CUDA device (anything else: the body alone).  Never waited for:
    resolve_device_spans() delivers it once its end event has completed.
    A pair that cannot be recorded is counted and dropped; the body's own
    error, if any, is what the caller sees."""
    if not _enabled and not _span_observers:
        yield None
        return
    if getattr(device, "type", None) != "cuda":
        yield args
        return
    import torch

    try:
        stream = torch.cuda.current_stream(device)
        a = torch.cuda.Event(enable_timing=True)  # tpulint: disable=LT-DEV(timing events on the caller's stream: recorded and queried, never synchronized)
        b = torch.cuda.Event(enable_timing=True)  # tpulint: disable=LT-DEV(timing events on the caller's stream: recorded and queried, never synchronized)
        t0_ns = time.perf_counter_ns()
        a.record(stream)
    except RuntimeError:  # a poisoned context: no span
        a = None
    try:
        yield args
    finally:
        if a is None:
            _count_dropped(1)
        else:
            try:
                b.record(stream)
            except RuntimeError:
                _count_dropped(1)
            else:
                add_device_span(name, t0_ns, a, b, stream.device, **args)


def resolve_device_spans() -> int:
    """Deliver the pending device spans whose end event has completed,
    oldest first, stopping at the first that has not (``Event.query()``:
    never a wait); returns how many were delivered.  Inside a CUDA graph
    capture it delivers none; on a device error it drops them all,
    counted, and leaves the error to the program's own sync point."""
    global device_spans_dropped
    if not _pending:
        return 0
    import torch

    if torch.cuda.is_current_stream_capturing():
        return 0
    done = []
    with _lock:
        try:
            while _pending and _pending[0][4].query():
                done.append(_pending.popleft())
        except RuntimeError:  # a device error: the spans' times are lost with it
            device_spans_dropped += len(_pending)
            _pending.clear()
    obs = _span_observers
    for name, ts, args, a, b, tid in done:
        _deliver(name, ts, a.elapsed_time(b) * 1e3, args, obs, cat="device", tid=tid)
    return len(done)


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
                    "ts": _now_us(),
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
    dumps (timestamp + pid + per-process counter).  ``otherData.clock``
    holds the ts origin and one reading of both clocks (module docstring)."""
    if path is None:
        os.makedirs("log", exist_ok=True)
        path = os.path.join(
            "log",
            f"trace-{int(time.time())}-{os.getpid()}-{next(_dump_counter)}.json",  # tpulint: disable=LT-TIME(artifact filename stamp; wall time is the point)
        )
    clock = {"origin_perf_counter_ns": _t0_ns, "perf_counter_ns": time.perf_counter_ns(), "time_ns": time.time_ns()}
    with _lock:
        data = {"traceEvents": list(_events), "otherData": {"clock": clock}}
    with open(path, "w") as f:
        json.dump(data, f)
    return path
