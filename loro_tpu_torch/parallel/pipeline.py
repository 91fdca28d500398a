"""Pipelined resident ingest: host/device overlap + round coalescing.

The serial resident serving loop pays four sequential costs per sync
round: host staging (decode, order maintenance, id maps), the WAL
append(+fsync), the device scatter launch, and the draining sync that
makes the card finish the round (the server's, inside its supervised
launch).  Where the launch + drain + fsync floor dominates a round,
overlapping it with the next round's host work is the gain; where host
staging dominates, there is little to hide (chip_smoke.py phase 4n
measures both on the card).

``PipelinedIngest`` attacks the fixed costs the way a read-optimized
differential store overlaps its delta buffer with the batch merge
(arXiv:1109.6885), and the way eg-walker keeps the incremental path
cheap per delta (arXiv:2409.14252):

- **round coalescing** — queued rounds drain into coalesced groups of
  up to ``coalesce`` rounds (``server.ingest_stage``): one device
  scatter/fold per structure per group instead of per round, with the
  host epoch clock, journal records, poison isolation and per-round
  ack epochs untouched (the coalesced state is byte-for-byte the
  serial state — tests/test_torch_server.py and
  tests/test_torch_pipeline.py gate it against serial ingest and the
  JAX package);
- **double-buffered host/device overlap** — a stage thread runs group
  N+1's host work (decode, ShadowOrder/id-map staging, per-round epoch
  stamps) while the commit thread ships group N's merged scatter and
  waits for the card; the stage phase launches nothing (a rare capacity
  grow serializes on the batch's device lock).  Both threads' Python
  share the interpreter lock: what overlaps the staging is the commit's
  device work and the calls that release the lock (native staging,
  numpy, the device sync);
- **bounded depth + backpressure** — at most ``depth`` groups' worth
  of rounds queue before ``submit`` blocks, and exactly one staged
  group waits behind the in-flight commit, so a stalled device never
  accumulates unbounded staged work; the launch queue itself stays
  under the DeviceSupervisor drain budget (never-SIGKILL rules hold:
  nothing here ever signals a process).

With ``durable_fsync="group"`` the group's journal records share one
fsync and a round's epoch future resolves only after it — an acked
round is never lost to a crash (``ResidentServer.durable_epoch``).

Every outcome feeds the obs registry (``pipeline.*``) and ``report()``
returns the compact dict bench.py banks as the ``pipeline`` sidecar.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Optional, Sequence

from ..analysis.lockwitness import named_lock
from ..obs import metrics as obs
from ..utils import tracing


class PendingRound:
    """Handle for one submitted round: ``epoch()`` blocks until the
    round's group has been applied (and, in group-commit mode, fsynced)
    and returns the visible epoch clients ack.

    ``trace_id`` (set by the submitter) rides into the commit thread's
    ambient trace context so the WAL round record is stamped with the
    request that caused it; ``marks`` carries the stage-boundary
    timestamps the owning PushTickets fold into their breakdowns
    (docs/OBSERVABILITY.md "Request tracing")."""

    __slots__ = ("_ev", "_epoch", "_error", "trace_id", "marks")

    def __init__(self):
        self._ev = threading.Event()
        self._epoch: Optional[int] = None
        self._error: Optional[BaseException] = None
        self.trace_id: Optional[str] = None
        self.marks: List[tuple] = []  # (stage_name, perf_counter)

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
            raise TimeoutError("round not applied yet")
        if self._error is not None:
            raise self._error
        return self._epoch


class PipelinedIngest:
    """Two-stage ingest executor over one ``ResidentServer``.

    ``coalesce``: max rounds per device group; ``depth``: max groups'
    worth of rounds queued before ``submit`` blocks (backpressure).
    ``cid``: default container id for submitted rounds (map/counter
    families need none); per-submit ``cid`` overrides, and a group
    never mixes cids.

    Construct via ``ResidentServer.pipeline(...)`` so ``close()`` /
    ``checkpoint()`` can drain it.  Thread contract: ``submit`` may be
    called from any ONE producer thread at a time; reads of the server
    are safe after ``flush()``.
    """

    def __init__(self, server, cid=None, coalesce: int = 4, depth: int = 2):
        self._server = server
        self._cid = cid
        self._coalesce = max(1, int(coalesce))
        # tiered residency (parallel/residency.py): the server may bound
        # how many DISTINCT docs one group touches — a group's docs
        # co-reside in device slots until it commits, so unbounded
        # grouping could outgrow the hot set.  None = no bound.
        self._doc_budget = getattr(server, "pipeline_doc_budget", None)
        self._max_queued = self._coalesce * max(1, int(depth))
        self._lock = named_lock("pipeline.queue")
        self._cv = threading.Condition(self._lock)
        self._q: deque = deque()        # (updates, cid, PendingRound)
        self._commit_q: deque = deque() # (handle, [PendingRound]) — len <= 1
        self._staging = False
        self._committing = False
        self._stop = False
        self._error: Optional[BaseException] = None
        self._stage_thread: Optional[threading.Thread] = None
        self._commit_thread: Optional[threading.Thread] = None
        # report counters
        self._rounds = 0
        self._groups = 0
        self._coalesced_rounds = 0
        self._max_group = 0
        self._max_depth_seen = 0
        self._backpressure_waits = 0
        self._stage_s = 0.0
        self._commit_s = 0.0
        self._overlap_s = 0.0
        self._t0: Optional[float] = None

    # -- producer side -------------------------------------------------
    def submit(self, per_doc_updates: Sequence, cid=None,
               trace: Optional[str] = None) -> PendingRound:
        """Queue one sync round (same payload contract as
        ``ResidentServer.ingest``).  Blocks while the queue is at the
        backpressure bound; returns a ``PendingRound`` whose
        ``epoch()`` resolves once the round's group lands.

        Change-list entries are FROZEN here (codec round trip): the
        live Change objects are aliased with the producing doc's oplog,
        which extends them in place on later commits (change RLE) — and
        unlike serial ingest, a queued round survives across those
        commits.  Freezing at submit pins the round to the ops it held
        when submitted, exactly what a prompt serial ingest would have
        applied.  Bytes payloads are immutable and ride as-is (this is
        the recommended form: zero extra host work)."""
        from ..codec.binary import decode_changes, encode_changes

        per_doc_updates = [
            u if u is None or isinstance(u, (bytes, bytearray))
            else decode_changes(bytes(encode_changes(list(u))))
            for u in per_doc_updates
        ]
        pr = PendingRound()
        # set BEFORE the round is visible to the workers: the commit
        # thread reads it for the ambient WAL trace stamp
        pr.trace_id = trace if trace is not None else tracing.current()
        with self._cv:
            self._check_open()
            if self._t0 is None:
                self._t0 = time.perf_counter()
            if len(self._q) >= self._max_queued:
                self._backpressure_waits += 1
                obs.counter("pipeline.backpressure_waits_total").inc(
                    family=self._server.family
                )
            while len(self._q) >= self._max_queued and self._error is None \
                    and not self._stop:
                self._cv.wait()
            self._check_open()
            self._q.append((list(per_doc_updates), cid if cid is not None
                            else self._cid, pr))
            self._rounds += 1
            self._max_depth_seen = max(self._max_depth_seen, len(self._q))
            obs.gauge(
                "pipeline.depth", "rounds staged behind the device group"
            ).set(len(self._q), family=self._server.family)
            if self._stage_thread is None:
                self._stage_thread = threading.Thread(
                    target=self._stage_run, name="loro-pipeline-stage",
                    daemon=True,
                )
                self._commit_thread = threading.Thread(
                    target=self._commit_run, name="loro-pipeline-commit",
                    daemon=True,
                )
                self._stage_thread.start()
                self._commit_thread.start()
            self._cv.notify_all()
        return pr

    def _check_open(self) -> None:
        if self._stop:
            raise RuntimeError("pipeline is closed")
        if self._error is not None:
            raise RuntimeError(
                "pipeline failed; no further rounds accepted"
            ) from self._error

    def flush(self) -> None:
        """Block until every submitted round is applied (and its group
        fsynced).  Re-raises the first worker error.  No-op from the
        pipeline's own threads (the auto-checkpoint a worker ingest
        triggers calls back into the server's drain hook)."""
        me = threading.current_thread()
        if me is self._stage_thread or me is self._commit_thread:
            return
        with self._cv:
            while (self._q or self._commit_q or self._staging
                   or self._committing) and self._error is None:
                self._cv.wait()
            if self._error is not None:
                raise RuntimeError("pipeline failed") from self._error

    def close(self) -> None:
        """Drain, then stop the workers.  Idempotent."""
        err = None
        try:
            self.flush()
        except RuntimeError as e:
            err = e
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        me = threading.current_thread()
        for t in (self._stage_thread, self._commit_thread):
            if t is not None and me is not t:
                t.join(timeout=30.0)
        if err is not None:
            raise err

    @property
    def closed(self) -> bool:
        return self._stop

    # -- stage worker --------------------------------------------------
    def _pop_group(self) -> List[tuple]:
        """Up to ``coalesce`` queued rounds sharing one cid (groups
        never mix container ids — ingest_stage takes one).  With a
        server doc budget, the group also stops before its DISTINCT
        touched docs would exceed it (tiered hot-set bound); the first
        round is always taken, so an over-budget single round reaches
        the server and fails typed there."""
        group: List[tuple] = []
        docs_seen: set = set()
        while self._q and len(group) < self._coalesce:
            if group and self._q[0][1] != group[0][1]:
                break
            if self._doc_budget is not None and group:
                nxt = {
                    di for di, u in enumerate(self._q[0][0]) if u is not None
                }
                if len(docs_seen | nxt) > self._doc_budget:
                    break
            group.append(self._q.popleft())
            if self._doc_budget is not None:
                docs_seen.update(
                    di for di, u in enumerate(group[-1][0]) if u is not None
                )
        return group

    def _fail_all(self, e: BaseException, group=None) -> None:
        """Mark the pipeline failed and resolve every waiter (the
        in-flight group, the staged group, and the whole queue)."""
        with self._cv:
            self._error = e
            self._staging = self._committing = False
            for _ups, _c, pr in group or ():
                pr._fail(e)
            while self._commit_q:
                _h, futs = self._commit_q.popleft()
                for pr in futs:
                    pr._fail(e)
            while self._q:
                _ups, _c, pr = self._q.popleft()
                pr._fail(e)
            self._cv.notify_all()

    def _stage_run(self) -> None:
        srv = self._server
        while True:
            with self._cv:
                while not self._q and not self._stop and self._error is None:
                    self._cv.notify_all()  # wake flushers: stage idle
                    self._cv.wait()
                if (self._stop and not self._q) or self._error is not None:
                    self._cv.notify_all()
                    return
                group = self._pop_group()
                self._staging = True
                obs.gauge(
                    "pipeline.depth", "rounds staged behind the device group"
                ).set(len(self._q), family=srv.family)
                self._cv.notify_all()  # backpressured producers refill
            t0 = time.perf_counter()
            try:
                handle = srv.ingest_stage(
                    [ups for ups, _c, _p in group], group[0][1]
                )
            except BaseException as e:  # noqa: BLE001 — fail every waiter
                self._fail_all(e, group)
                return
            dt = time.perf_counter() - t0
            futs = [pr for _ups, _c, pr in group]
            for pr in futs:
                # attribution: waited-for-grouping, then host staging
                pr.marks.append(("coalesce_wait", t0))
                pr.marks.append(("stage", t0 + dt))
            exclusive = (
                handle.mode != "group" or handle.error_index is not None
            )
            with self._cv:
                self._stage_s += dt
                if self._committing:
                    # this stage ran while a commit was on the device —
                    # the overlap the executor exists for
                    self._overlap_s += dt
                # double buffering: exactly one staged group may wait
                # behind the in-flight commit
                while self._commit_q and self._error is None:
                    self._cv.wait()
                if self._error is not None:
                    for pr in futs:
                        pr._fail(self._error)
                    return
                self._commit_q.append((handle, futs))
                self._staging = False
                self._cv.notify_all()
                if exclusive:
                    # serial-completion handles (poison round, degraded
                    # server) mutate host state in the commit thread:
                    # stall staging until this group fully commits
                    while self._commit_q and self._error is None \
                            and not self._stop:
                        self._cv.wait()

    # -- commit worker -------------------------------------------------
    def _commit_run(self) -> None:
        srv = self._server
        while True:
            with self._cv:
                while not self._commit_q and not self._stop \
                        and self._error is None:
                    self._cv.notify_all()  # wake flushers: commit idle
                    self._cv.wait()
                if self._error is not None or (
                    self._stop and not self._commit_q
                ):
                    self._cv.notify_all()
                    return
                handle, futs = self._commit_q[0]
                self._committing = True
                self._cv.notify_all()
            t0 = time.perf_counter()
            try:
                # ambient trace: the WAL appends inside ingest_commit
                # stamp their round records with the request that led
                # the group (group granularity — one fsync window)
                with tracing.ambient(next(
                    (pr.trace_id for pr in futs if pr.trace_id), None
                )):
                    epochs = srv.ingest_commit(handle)
            except BaseException as e:  # noqa: BLE001 — fail every waiter
                with self._cv:
                    self._commit_q.popleft()
                for pr in futs:
                    pr._fail(e)
                self._fail_all(e)
                return
            dt = time.perf_counter() - t0
            with self._cv:
                self._commit_q.popleft()
                self._commit_s += dt
                self._groups += 1
                self._max_group = max(self._max_group, len(futs))
                if len(futs) > 1:
                    self._coalesced_rounds += len(futs)
                now = t0 + dt
                for pr, ep in zip(futs, epochs):
                    pr.marks.append(("commit", now))
                    pr._resolve(ep)
                self._committing = False
                self._cv.notify_all()

    # -- reporting -----------------------------------------------------
    def report(self) -> dict:
        """Compact outcome dict (the bench ``pipeline`` sidecar).
        ``overlap_fraction`` is the share of host staging time that ran
        while a device commit was in flight — the double-buffering
        actually achieved, not a modeled number."""
        with self._lock:
            wall = (
                time.perf_counter() - self._t0 if self._t0 is not None else 0.0
            )
            return {
                "rounds": self._rounds,
                "groups": self._groups,
                "coalesced_rounds": self._coalesced_rounds,
                "max_group": self._max_group,
                "coalesce_limit": self._coalesce,
                "max_depth_seen": self._max_depth_seen,
                "queue_bound": self._max_queued,
                "backpressure_waits": self._backpressure_waits,
                "stage_s": round(self._stage_s, 3),
                "commit_s": round(self._commit_s, 3),
                "overlap_s": round(self._overlap_s, 3),
                "overlap_fraction": (
                    round(self._overlap_s / self._stage_s, 3)
                    if self._stage_s > 0 else 0.0
                ),
                "wall_s": round(wall, 3),
            }
