"""Always-on flight recorder: a bounded ring of structured events (the
port's copy of loro_tpu/obs/flight.py).

The metrics registry (metrics.py) answers "how many / how fast"; the
tracer (utils/tracing.py) answers "where did the time go" when it was
turned on IN ADVANCE.  Neither answers the question that follows a
device failure or a degradation: *what happened in the last few seconds
before things went wrong*.  This module is the black box: an always-on,
capacity-bounded ring of structured events (supervisor retries and
failures, degradations, fault-site fires, lock-witness edges, probe
outcomes) that costs one lock and one slot write per event while
enabled and a single attribute check when disabled.

The ring is ON by default with a small capacity (1024 events, or
``LORO_FLIGHT_CAP``): memory is bounded by construction (old events are
overwritten) and the callers are per-launch paths, never per-op loops.

Dump points:

- ``DeviceSupervisor.note_degradation`` and the probe's failure paths
  call ``dump_on(reason)``, a no-op unless auto-dumping is armed
  (``LORO_FLIGHT_DIR=<dir>`` or ``set_auto_dump(dir)``), so tests that
  degrade on purpose never write files;
- ``dump(path)`` / ``snapshot()`` on demand.

Thread contract: ``record()`` may be called from any thread, including
while holding other named locks: ``obs.flight`` is the innermost level
in ``analysis/lockorder.py``, and a thread-local reentrancy guard makes
nested records (the lock witness observing the flight lock itself) a
silent no-op instead of a self-deadlock.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from ..analysis.lockwitness import named_lock

_WALL = time.time  # injectable wall clock


class FlightRecorder:
    """Bounded ring of ``{"i", "t", "wall", "kind", ...fields}`` events.

    ``capacity`` bounds memory; ``clock`` (monotonic-ish, relative
    ordering) and ``wall`` (cross-process correlation stamps) are
    injectable for fake-clock tests."""

    def __init__(self, capacity: int = 1024, clock=time.perf_counter,
                 wall=_WALL):
        self._lock = named_lock("obs.flight")
        self._clock = clock
        self._wall = wall
        self._on = True
        self._guard = threading.local()
        self._configure(capacity)

    def _configure(self, capacity: int) -> None:
        self.capacity = max(1, int(capacity))
        self._ring: List[Optional[tuple]] = [None] * self.capacity
        self._next = 0       # ring slot the next event lands in
        self._recorded = 0   # total events ever recorded
        self._dumps = 0

    # -- switches ------------------------------------------------------
    @property
    def on(self) -> bool:
        return self._on

    def enable(self, capacity: Optional[int] = None) -> None:
        with self._lock:
            if capacity is not None and capacity != self.capacity:
                self._configure(capacity)
            self._on = True

    def disable(self) -> None:
        self._on = False

    def clear(self) -> None:
        with self._lock:
            self._configure(self.capacity)

    # -- the hot path --------------------------------------------------
    def record(self, kind: str, **fields) -> None:
        """Append one event.  Disabled fast path: one attribute check,
        no lock, no slot write (net-zero allocations — the perf
        guard).  Reentrant records (an observer of the flight lock
        itself) are silently dropped instead of self-deadlocking."""
        if not self._on:
            return
        if getattr(self._guard, "held", False):
            return
        self._guard.held = True
        try:
            ev = (self._clock(), self._wall(), kind, fields or None)
            with self._lock:
                self._ring[self._next] = ev
                self._next = (self._next + 1) % self.capacity
                self._recorded += 1
        finally:
            self._guard.held = False

    # -- reads ---------------------------------------------------------
    def _ordered(self) -> List[tuple]:
        with self._lock:
            if self._recorded < self.capacity:
                raw = self._ring[: self._next]
            else:
                raw = self._ring[self._next:] + self._ring[: self._next]
            first = self._recorded - min(self._recorded, self.capacity)
            return [(first + i, ev) for i, ev in enumerate(raw)
                    if ev is not None]

    def events(self) -> List[Dict[str, Any]]:
        """Every retained event, oldest first, as JSON-able dicts."""
        out = []
        for i, (t, wall, kind, fields) in self._ordered():
            ev = {"i": i, "t": round(t, 6), "wall": wall, "kind": kind}
            if fields:
                ev.update(fields)
            out.append(ev)
        return out

    def tail(self, n: int = 200) -> List[Dict[str, Any]]:
        """The newest ``n`` events (oldest-first within the tail)."""
        return self.events()[-max(0, int(n)):]

    @property
    def recorded_total(self) -> int:
        with self._lock:
            return self._recorded

    def snapshot(self) -> dict:
        """JSON-able dump: config + every retained event."""
        with self._lock:
            recorded, dumps = self._recorded, self._dumps
        return {
            "flight": 1,  # format tag
            "pid": os.getpid(),
            "capacity": self.capacity,
            "recorded_total": recorded,
            "dumps": dumps,
            "events": self.events(),
        }

    # -- dumping -------------------------------------------------------
    def dump(self, path: Optional[str] = None) -> str:
        """Write the snapshot as JSON; returns the path.  The default
        path (under ``./log``) is collision-free: timestamp + pid + a
        per-recorder counter."""
        with self._lock:
            self._dumps += 1
            n = self._dumps
        if path is None:
            os.makedirs("log", exist_ok=True)
            path = os.path.join(
                "log",
                f"flight-{int(self._wall())}-{os.getpid()}-{n}.json",
            )
        snap = self.snapshot()
        with open(path, "w") as f:
            json.dump(snap, f)
        return path


# -- module-level default recorder -------------------------------------
# built LAZILY at first use, so a malformed LORO_FLIGHT_CAP raises a
# typed ConfigError at the first record()/recorder() call (the repo's
# knob convention) instead of an untyped ValueError at package import
_default: Optional[FlightRecorder] = None
_default_lock = threading.Lock()
_auto_dump_dir: Optional[str] = os.environ.get("LORO_FLIGHT_DIR") or None
_auto_dump_counter = itertools.count(1)


def _env_cap() -> int:
    raw = os.environ.get("LORO_FLIGHT_CAP", "").strip()
    if not raw:
        return 1024
    try:
        v = int(raw)
        if v <= 0:
            raise ValueError("must be positive")
    except ValueError:
        from ..errors import ConfigError

        raise ConfigError(
            "LORO_FLIGHT_CAP", raw, "a positive integer event capacity"
        ) from None
    return v


def recorder() -> FlightRecorder:
    global _default
    r = _default
    if r is None:
        with _default_lock:
            if _default is None:
                _default = FlightRecorder(capacity=_env_cap())
            r = _default
    return r


def record(kind: str, **fields) -> None:
    recorder().record(kind, **fields)


def events() -> List[Dict[str, Any]]:
    return recorder().events()


def tail(n: int = 200) -> List[Dict[str, Any]]:
    return recorder().tail(n)


def snapshot() -> dict:
    return recorder().snapshot()


def enable(capacity: Optional[int] = None) -> None:
    recorder().enable(capacity)


def disable() -> None:
    recorder().disable()


def is_on() -> bool:
    return recorder().on


def clear() -> None:
    recorder().clear()


def dump(path: Optional[str] = None) -> str:
    return recorder().dump(path)


def set_auto_dump(dir: Optional[str]) -> None:
    """Arm (or disarm with None) failure-path auto-dumping: while
    armed, ``dump_on(reason)`` writes a snapshot into ``dir``.  Off by
    default so fault-injection tests exercising degradations on
    purpose never write files."""
    global _auto_dump_dir
    _auto_dump_dir = dir


def dump_on(reason: str) -> Optional[str]:
    """Failure-path hook (supervisor degradations, probe wedge paths):
    record the trigger, then write a snapshot IF auto-dumping is armed
    (``LORO_FLIGHT_DIR`` / ``set_auto_dump``).  Returns the path or
    None."""
    from . import metrics as _m

    record("flight.trigger", reason=reason)
    _m.counter(
        "flight.triggers_total",
        "failure-path flight-dump triggers (degradations, wedge paths)",
    ).inc(reason=reason)
    if _auto_dump_dir is None:
        return None
    try:
        os.makedirs(_auto_dump_dir, exist_ok=True)
        # a process-monotonic counter, NOT recorded_total: the ring
        # may be disabled (recorded_total frozen), and two same-reason
        # dumps must never overwrite the black box they exist to keep
        path = recorder().dump(os.path.join(
            _auto_dump_dir,
            f"flight-{reason.replace('/', '_')}-{os.getpid()}-"
            f"{next(_auto_dump_counter)}.json",
        ))
    except OSError:
        return None  # advisory: a full disk must not break degradation
    _m.counter("flight.dumps_total", "flight snapshots written").inc(
        reason=reason
    )
    return path
