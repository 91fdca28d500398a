"""Bounded fan-in: many sessions' pushes -> batched ingest rounds (the
port of loro_tpu/sync/fanin.py).

Concurrent client sessions push single-doc update payloads at arbitrary
times; the resident path wants wide per-doc ROUNDS (one device launch
covers the whole fleet) and the pipeline executor wants several rounds
per coalesced group.  ``FanIn`` is the funnel between the two shapes:

- ``submit(di, payload, ...)`` enqueues one push and returns a
  ``PushTicket`` whose ``epoch()`` resolves once the push's round is
  committed (and, on a ``durable_fsync="group"`` server, fsync'd — an
  acked push is never lost to a crash);
- a single worker thread drains the queue into *batches*; the commit
  callback (``SyncServer._commit_batch``) packs a batch into rounds —
  one entry per doc per round, same-doc pushes spilling to the next
  round in FIFO order — and feeds them to the resident pipeline;
- the queue is BOUNDED: ``submit`` blocks at ``max_queue`` queued
  pushes (``sync.backpressure_waits_total``), so a stalled device
  propagates backpressure to the pushing sessions instead of
  accumulating unbounded staged work.  Nothing is ever dropped.

Failure contract mirrors ``parallel/pipeline.py``: a commit-callback
error fails every waiting ticket and closes the intake typed; per-push
data errors (poison payloads) are the commit callback's business — it
fails only the offending ticket (``errors.PushRejected``) and the rest
of the batch lands.  A real device failure in the resident ingest is a
commit-callback error: every ticket of its batch fails with the typed
``DeviceFailure`` and later pushes are refused.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Optional

from ..analysis.lockwitness import named_lock
from ..obs import metrics as obs


class PushTicket:
    """Handle for one submitted push: ``epoch()`` blocks until the
    push's round committed and returns the visible epoch to ack.

    Request tracing: ``trace_id`` is minted at
    push entry and carried through every stage; ``marks`` accumulates
    ``(stage_name, perf_counter)`` pairs at the stage BOUNDARIES the
    push crosses (fan-in dequeue, pipeline stage/commit, fsync,
    visibility), so ``breakdown()`` telescopes them into per-stage
    durations that sum EXACTLY to the push-to-visible total."""

    __slots__ = ("_ev", "_epoch", "_error", "t0", "trace_id", "marks")

    def __init__(self, trace_id: Optional[str] = None):
        self._ev = threading.Event()
        self._epoch: Optional[int] = None
        self._error: Optional[BaseException] = None
        self.t0 = time.perf_counter()  # push-to-visible clock start
        self.trace_id = trace_id
        self.marks: List[tuple] = []   # (stage_name, t) in crossing order

    def mark(self, stage: str, t: Optional[float] = None) -> None:
        self.marks.append((stage, time.perf_counter() if t is None else t))

    def _resolve(self, epoch: int) -> None:
        self._epoch = epoch
        self._ev.set()

    def _fail(self, err: BaseException) -> None:
        self._error = err
        self._ev.set()

    @property
    def done(self) -> bool:
        return self._ev.is_set()

    def epoch(self, timeout: Optional[float] = None) -> int:
        if not self._ev.wait(timeout):
            raise TimeoutError("push not committed yet")
        if self._error is not None:
            raise self._error
        return self._epoch

    def breakdown(self) -> dict:
        """Per-stage timing attribution (milliseconds): the durations
        between consecutive marks, named by the stage each mark closes,
        plus ``total_ms`` (creation -> last mark).  Telescoping by
        construction: ``sum(stages) == total_ms`` exactly (the chaos
        ``attribution`` invariant gates this).  Stages a path skipped
        (e.g. no pipeline -> no stage/coalesce split) are absent."""
        out: dict = {"trace_id": self.trace_id}
        prev = self.t0
        for name, t in self.marks:
            out[f"{name}_ms"] = (t - prev) * 1e3
            prev = t
        out["total_ms"] = (prev - self.t0) * 1e3
        return out


class FanIn:
    """Bounded push queue + single drain worker.

    ``commit``: callable taking a list of ``(di, payload, ticket,
    session)`` items (one drained batch, FIFO); it must resolve or fail
    every ticket it is handed.  ``max_queue``: backpressure bound;
    ``max_batch``: most items handed to one commit call (default: the
    queue bound, so one drain can cover a full queue).
    """

    def __init__(self, commit, max_queue: int = 64,
                 max_batch: Optional[int] = None, family: str = ""):
        self._commit = commit
        self._max_queue = max(1, int(max_queue))
        self._max_batch = (
            self._max_queue if max_batch is None else max(1, int(max_batch))
        )
        self._family = family
        self._lock = named_lock("fanin.queue")
        self._cv = threading.Condition(self._lock)
        self._q: deque = deque()  # (di, payload, ticket, session)
        self._busy = False        # worker inside a commit call
        self._stop = False
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        # count-based report (the bench `sync` sidecar + test guards)
        self._pushes = 0
        self._batches = 0
        self._max_batch_seen = 0
        self._max_queue_seen = 0
        self._backpressure_waits = 0

    # -- producer side -------------------------------------------------
    def submit(self, di: int, payload, ticket: PushTicket, session=None) -> None:
        with self._cv:
            self._check_open()
            if len(self._q) >= self._max_queue:
                self._backpressure_waits += 1
                obs.counter(
                    "sync.backpressure_waits_total",
                    "pushes that blocked on the bounded fan-in queue",
                ).inc(family=self._family)
            while len(self._q) >= self._max_queue and self._error is None \
                    and not self._stop:
                self._cv.wait()
            self._check_open()
            self._q.append((di, payload, ticket, session))
            self._pushes += 1
            self._max_queue_seen = max(self._max_queue_seen, len(self._q))
            obs.gauge(
                "sync.fanin_depth", "pushes queued behind the fan-in worker"
            ).set(len(self._q), family=self._family)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="loro-sync-fanin", daemon=True
                )
                self._thread.start()
            self._cv.notify_all()

    def _check_open(self) -> None:
        if self._stop:
            raise RuntimeError("sync fan-in is closed")
        if self._error is not None:
            raise RuntimeError(
                "sync fan-in failed; no further pushes accepted"
            ) from self._error

    def flush(self) -> None:
        """Block until every submitted push has been committed (its
        ticket resolved or failed).  Re-raises the worker error."""
        if threading.current_thread() is self._thread:
            return
        with self._cv:
            while (self._q or self._busy) and self._error is None:
                self._cv.wait()
            if self._error is not None:
                raise RuntimeError("sync fan-in failed") from self._error

    def close(self) -> None:
        """Drain, then stop the worker.  Idempotent."""
        err = None
        try:
            self.flush()
        except RuntimeError as e:
            err = e
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        t = self._thread
        if t is not None and threading.current_thread() is not t:
            t.join(timeout=30.0)
        if err is not None:
            raise err

    @property
    def closed(self) -> bool:
        return self._stop

    # -- worker --------------------------------------------------------
    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._stop and self._error is None:
                    self._cv.notify_all()  # wake flushers: idle
                    self._cv.wait()
                if (self._stop and not self._q) or self._error is not None:
                    self._cv.notify_all()
                    return
                batch: List[tuple] = []
                while self._q and len(batch) < self._max_batch:
                    batch.append(self._q.popleft())
                now = time.perf_counter()
                for _di, _pl, tk, _s in batch:
                    # attribution: time queued behind the fan-in worker
                    tk.mark("queue_wait", now)
                self._busy = True
                self._batches += 1
                self._max_batch_seen = max(self._max_batch_seen, len(batch))
                obs.gauge(
                    "sync.fanin_depth",
                    "pushes queued behind the fan-in worker",
                ).set(len(self._q), family=self._family)
                self._cv.notify_all()  # backpressured producers refill
            try:
                self._commit(batch)
            except BaseException as e:  # noqa: BLE001 — fail every waiter
                with self._cv:
                    self._error = e
                    self._busy = False
                    for _di, _pl, tk, _s in batch:
                        if not tk.done:
                            tk._fail(e)
                    while self._q:
                        _di, _pl, tk, _s = self._q.popleft()
                        tk._fail(e)
                    self._cv.notify_all()
                obs.counter(
                    "sync.fanin_errors_total",
                    "fan-in commit batches that raised (intake closed)",
                ).inc(family=self._family)
                return
            with self._cv:
                self._busy = False
                self._cv.notify_all()

    # -- reporting -----------------------------------------------------
    def report(self) -> dict:
        with self._lock:
            return {
                "pushes": self._pushes,
                "batches": self._batches,
                "max_batch": self._max_batch_seen,
                "queue_bound": self._max_queue,
                "max_queue_seen": self._max_queue_seen,
                "backpressure_waits": self._backpressure_waits,
            }
