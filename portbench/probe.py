"""What a run records for the metric readers: the window's operations,
wall time and set-up time and each timed step's host time; in a traced
run also the host time of named functions of the program, wrapped where
their callers look them up, and CUDA-event spans around them.

A target is ``"module:attr"`` or ``"module:Class.method"``.  A wrapper
records only while the window is open, so set-up calls leave no trace.
On a card each wrapped call is also a ``torch.profiler`` annotation under
the target's name, which names the host's work in the idle gaps.
"""
from __future__ import annotations

import importlib
import time
from contextlib import nullcontext
from typing import Callable, Dict, List, Optional


class Probe:
    def __init__(self, torch, cuda: bool):
        self.torch = torch
        self.cuda = cuda
        self.open = False  # the measured window is open
        self.step = 0  # timed steps begun
        self.step_ms: List[float] = []  # host ms of each timed step (every run)
        self.calls: Dict[str, List[dict]] = {}  # target -> one record a call in the window
        self.trace: Optional[dict] = None  # timing.reduce_trace of the window
        self.ops = 0  # the benchmark's count of operations the window completed
        self.window_s = 0.0  # the window's wall time
        self.setup_s = 0.0  # process start to the first timed step
        self._specs: Dict[str, dict] = {}
        self._undo: List[Callable[[], None]] = []

    # -- wrapping ------------------------------------------------------
    def want(self, target: str, sync: bool = False, events: bool = False) -> None:
        """Ask for `target` to be wrapped: `sync` waits for the device at
        the call's end (its host time then covers its device work),
        `events` records a CUDA event pair around it."""
        s = self._specs.setdefault(target, {"sync": False, "events": False})
        s["sync"] |= sync
        s["events"] |= events

    def install(self) -> None:
        for target, spec in self._specs.items():
            mod_name, _, path = target.partition(":")
            owner = importlib.import_module(mod_name)
            *outer, attr = path.split(".")
            for part in outer:
                owner = getattr(owner, part)
            fn = getattr(owner, attr)  # AttributeError: a renamed target is a missing metric, loudly
            setattr(owner, attr, self._wrapper(target, fn, spec))
            self._undo.append(lambda o=owner, a=attr, f=fn: setattr(o, a, f))

    def uninstall(self) -> None:
        while self._undo:
            self._undo.pop()()

    def _wrapper(self, target: str, fn, spec: dict):
        probe, torch = self, self.torch
        sync = spec["sync"] and self.cuda
        events = spec["events"] and self.cuda
        rec = self.calls.setdefault(target, [])
        label = target.replace(":", ".")

        def wrapped(*args, **kwargs):
            if not probe.open:
                return fn(*args, **kwargs)
            ev = None
            with torch.profiler.record_function(label) if probe.cuda else nullcontext():
                if events:
                    ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                    ev[0].record()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                if events:
                    ev[1].record()
                if sync:
                    torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            shape = tuple(args[0].shape) if args and hasattr(args[0], "shape") else None
            rec.append({"step": probe.step, "host_ms": ms, "events": ev, "shape": shape})
            return out

        wrapped.__wrapped__ = fn
        return wrapped

    # -- reading ---------------------------------------------------------
    def ms_per_step(self, *targets: str) -> Optional[float]:
        """Host ms of the targets' calls in the window, a timed step."""
        calls = [c for t in targets for c in self.calls.get(t, [])]
        if not calls or not self.step_ms:
            return None
        return sum(c["host_ms"] for c in calls) / len(self.step_ms)

    def event_ms(self, target: str) -> List[tuple]:
        """(CUDA-event ms, shape) of each of the target's calls."""
        out = []
        for c in self.calls.get(target, []):
            if c["events"] is not None:
                a, b = c["events"]
                b.synchronize()
                out.append((a.elapsed_time(b), c["shape"]))
        return out

