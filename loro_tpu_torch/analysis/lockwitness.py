"""Runtime lock-order witness: named locks + the acquisition graph (the
port's copy of loro_tpu/analysis/lockwitness.py).

Locks of the port's threaded planes are built through
``named_lock(name)`` / ``named_rlock(name)`` instead of bare
``threading.Lock()``: the batch device locks (``fleet.dev``), the
supervisor's counters (``supervisor.state``) and the flight recorder's
ring (``obs.flight``).  The wrapper is inert by default (one module flag
check per acquire); ``witness().enable()`` (or ``LORO_LOCK_WITNESS=1``)
turns on recording:

- every acquisition taken while other named locks are held records an
  edge ``held -> acquired`` into a process-global graph, keyed by lock
  NAME (all ``fleet.dev`` batch locks are one node: the order is a
  property of the code paths, not the instances);
- ``check_declared()`` verifies every edge against the declared partial
  order in ``lockorder.py``; ``assert_acyclic()`` proves deadlock
  freedom of the witnessed graph (any cycle is a latent deadlock,
  declared or not); ``enable(strict=True)`` raises typed
  ``errors.LockOrderViolation`` AT the offending acquire (tests);
- ``dump(path)`` writes the witnessed graph as a JSON artifact.

The wrapper implements the private ``_release_save`` /
``_acquire_restore`` / ``_is_owned`` protocol, so
``threading.Condition(named_lock(...))`` works for both Lock and RLock
and the witness stays consistent across ``wait()``.

Reentrant same-name acquisition never records an edge: two different
``fleet.dev`` instances nested would be a same-name self-edge, which
sequential per-batch loops legitimately produce; cross-NAME order is
what deadlocks are made of here.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional, Tuple

from ..errors import LockOrderViolation
from . import lockorder


class _Held(threading.local):
    def __init__(self):
        self.counts: Dict[str, int] = {}
        self.order: List[str] = []  # acquisition order, distinct names


class LockWitness:
    """Process-global acquisition graph + enable/strict switches."""

    def __init__(self):
        self._glock = threading.Lock()
        self.enabled = False
        self.strict = False
        self._edges: Dict[Tuple[str, str], int] = {}
        self._first_thread: Dict[Tuple[str, str], str] = {}
        self._violations: List[str] = []
        self._held = _Held()

    # -- lifecycle -----------------------------------------------------
    def enable(self, strict: bool = False) -> None:
        with self._glock:
            self.enabled = True
            self.strict = strict

    def disable(self) -> None:
        with self._glock:
            self.enabled = False
            self.strict = False

    def reset(self) -> None:
        with self._glock:
            self._edges.clear()
            self._first_thread.clear()
            self._violations.clear()

    # -- recording (called from NamedLock with the lock HELD) ----------
    def note_acquire(self, name: str) -> None:
        held = self._held
        if held.counts.get(name, 0):
            held.counts[name] += 1
            return  # reentrant: no edge, no order change
        new_edges: List[Tuple[str, str]] = []
        bad: List[str] = []
        for h in held.order:
            if h != name:
                new_edges.append((h, name))
                if not lockorder.allowed(h, name):
                    bad.append(
                        f"{h!r} held while acquiring {name!r} "
                        f"(thread {threading.current_thread().name})"
                    )
        held.counts[name] = 1
        held.order.append(name)
        if new_edges or bad:
            tname = threading.current_thread().name
            first: List[Tuple[str, str]] = []
            with self._glock:
                for e in new_edges:
                    n = self._edges.get(e, 0)
                    if n == 0:
                        first.append(e)
                    self._edges[e] = n + 1
                    self._first_thread.setdefault(e, tname)
                self._violations.extend(bad)
            self._obs_update(len(bad))
            # flight recorder: first-seen edges are rare, structural
            # events — exactly what a post-mortem wants.  Fired OUTSIDE
            # _glock; the recorder's reentrancy guard drops the nested
            # record its own lock acquisition would otherwise produce.
            if first or bad:
                try:
                    from ..obs import flight

                    for a, b in first:
                        flight.record("lock.edge", held=a, acquired=b)
                    for msg in bad:
                        flight.record("lock.violation", detail=msg)
                except Exception:  # the flight ring must never break a lock acquire
                    pass
        if bad and self.strict:
            raise LockOrderViolation("; ".join(bad))

    def note_release(self, name: str) -> None:
        held = self._held
        n = held.counts.get(name, 0)
        if n > 1:
            held.counts[name] = n - 1
        elif n == 1:
            del held.counts[name]
            try:
                held.order.remove(name)
            except ValueError:
                pass
        # n == 0: enable() happened mid-hold; nothing to unwind

    def note_release_all(self, name: str) -> int:
        """Condition.wait path: the lock is fully released regardless
        of recursion depth.  Returns the count to restore."""
        held = self._held
        n = held.counts.pop(name, 0)
        if n:
            try:
                held.order.remove(name)
            except ValueError:
                pass
        return n

    def note_acquire_restore(self, name: str, count: int) -> None:
        held = self._held
        if count:
            held.counts[name] = count
            held.order.append(name)

    def _obs_update(self, new_violations: int) -> None:
        try:
            from ..obs import metrics as obs

            obs.gauge(
                "analysis.witness_edges",
                "distinct witnessed lock-order edges",
            ).set(len(self._edges))
            if new_violations:
                obs.counter(
                    "analysis.lock_order_violations_total",
                    "witnessed acquisitions the declared order forbids",
                ).inc(new_violations)
        except Exception:  # metrics must never break a lock acquire
            pass

    # -- reads ---------------------------------------------------------
    def edges(self) -> Dict[Tuple[str, str], int]:
        with self._glock:
            return dict(self._edges)

    def violations(self) -> List[str]:
        with self._glock:
            return list(self._violations)

    def check_declared(self) -> List[str]:
        """Every witnessed edge checked against lockorder.LEVELS."""
        return lockorder.check_edges(self.edges())

    def assert_acyclic(self) -> None:
        cyc = lockorder.find_cycle(self.edges())
        if cyc is not None:
            raise LockOrderViolation(
                "witnessed lock graph has a cycle (latent deadlock): "
                + " -> ".join(cyc)
            )

    def dump(self, path: Optional[str] = None) -> str:
        """Write the witnessed graph artifact; returns the path."""
        if path is None:
            path = os.environ.get("LORO_LOCK_WITNESS_DUMP",
                                  ".lockwitness.json")
        with self._glock:
            data = {
                "levels": dict(lockorder.LEVELS),
                "edges": [
                    {"from": a, "to": b, "count": n,
                     "first_thread": self._first_thread.get((a, b), "")}
                    for (a, b), n in sorted(self._edges.items())
                ],
                "violations": list(self._violations),
            }
        data["cycle"] = lockorder.find_cycle(
            (e["from"], e["to"]) for e in data["edges"]
        )
        with open(path, "w") as f:
            json.dump(data, f, indent=1)
        return path


_witness = LockWitness()


def witness() -> LockWitness:
    return _witness


class NamedLock:
    """A threading.Lock/RLock with a witness name.  API-compatible as a
    context manager, via acquire/release, and as the lock of a
    ``threading.Condition`` (the private protocol below)."""

    __slots__ = ("name", "_lk", "_reentrant")

    def __init__(self, name: str, lock, reentrant: bool):
        self.name = name
        self._lk = lock
        self._reentrant = reentrant

    def __repr__(self) -> str:
        return f"<NamedLock {self.name} {self._lk!r}>"

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._lk.acquire(blocking, timeout)
        if ok and _witness.enabled:
            try:
                _witness.note_acquire(self.name)
            except BaseException:
                # strict-mode violation: leave the system consistent —
                # undo the bookkeeping AND the physical acquire before
                # surfacing the typed error
                _witness.note_release(self.name)
                self._lk.release()
                raise
        return ok

    def release(self) -> None:
        # unwind by RECORDED state, not the enabled flag: disabling the
        # witness while a worker thread is mid-critical-section must
        # not leak the name into its held-set forever (note_release is
        # a no-op when nothing was recorded)
        _witness.note_release(self.name)
        self._lk.release()

    def __enter__(self) -> "NamedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    # -- threading.Condition private protocol --------------------------
    def _release_save(self):
        cnt = _witness.note_release_all(self.name)  # no-op when unrecorded
        if self._reentrant:
            state = self._lk._release_save()
        else:
            self._lk.release()
            state = None
        return (state, cnt)

    def _acquire_restore(self, saved) -> None:
        state, cnt = saved
        if self._reentrant:
            self._lk._acquire_restore(state)
        else:
            self._lk.acquire()
        if _witness.enabled:
            _witness.note_acquire_restore(self.name, max(cnt, 1))

    def _is_owned(self) -> bool:
        if self._reentrant:
            return self._lk._is_owned()
        # plain-lock emulation (CPython Condition fallback)
        if self._lk.acquire(False):
            self._lk.release()
            return False
        return True


def named_lock(name: str) -> NamedLock:
    return NamedLock(name, threading.Lock(), reentrant=False)


def named_rlock(name: str) -> NamedLock:
    return NamedLock(name, threading.RLock(), reentrant=True)


if os.environ.get("LORO_LOCK_WITNESS", "") == "1":
    _witness.enable()
