"""ReadBatcher: many sessions' pulls -> one batched delta-export launch
(the port of loro_tpu/sync/readbatch.py).

The read-side dual of ``fanin.FanIn``.  Writes are batched, pipelined,
sharded and tiered across the doc axis; without this module every
``Session.pull()`` would walk a per-doc host ``LoroDoc`` oracle, one doc
at a time, where readers outnumber writers.  This module lifts the pull
path onto the device:

- concurrent ``pull()``s on a window coalesce into ONE batched
  selection launch over the device-resident change-span index
  (``ops/export_batch.py``) — the count guard in the tests: launches
  per window == 1, however many sessions pulled;
- identical ``(doc, frontier)`` requests in a window FRAME ONCE and
  share the wire bytes (a fan-out of readers at the same frontier —
  the common case after a notification — pays one encode, not N);
- framing rides the exact oracle code path
  (``doc.frame_columnar_updates`` over the stored changes, trimmed by
  ``oplog.trim_known_prefix``), so batched device pulls are
  byte-identical to ``ExportMode.Updates`` oracle exports;
- the launch routes through the ``DeviceSupervisor`` via the family
  batch's ``export_select`` entry; an ARMED fault (``read_batch``, or
  an ``export_launch`` fault the supervisor turns into a
  ``DeviceFailure`` with ``injected`` set) degrades ONLY that window to
  per-request oracle pulls — typed, counted, invisible to sessions.  A
  real device failure (a CUDA error, an out-of-memory, a kernel that
  failed to launch) is not served from the host: the window's tickets
  fail with the typed ``DeviceFailure`` (``readbatch.
  window_errors_total``), so the puller sees it.  The JAX package
  degrades the window on any DeviceFailure; the port only on an armed
  one, so no host bytes hide a card that failed;
- the host oracle stays authoritative for everything the index cannot
  serve: first-sync snapshots, ``StaleFrontier``, bounded
  ``UpdatesInRange`` pulls, and frontiers below the index floor
  (pre-SyncServer history on a recovered/restored resident).

The queue is UNBOUNDED on purpose (unlike the fan-in): a pull request
is O(frontier) bytes with no staged payload, the window drain is one
launch regardless of depth, and a bounded queue here could deadlock a
session submitting under the server lock against a degraded window
re-entering the oracle under that same lock.

There is NO dedicated read thread: pulls are leader-driven.  The
first missing puller becomes the window leader (``ReadBatcher.drive``)
— it sleeps one short gather beat so racing pulls pile into its
window, then drains, launches, frames and resolves every ticket;
followers block on their tickets.  Repeat ``(doc, frontier)`` pulls
against an unchanged doc skip the window entirely: the **frame cache**
(invalidated per doc at commit) serves them inline.

Locks (analysis/lockorder.py): ``sync.readbatch`` (queue/cv) and
``sync.readplane`` (index + changelog + frame cache) sit between
``sync.server`` and ``fanin.queue`` — the commit path feeds the plane
while holding the server lock; the window leader takes the plane lock
with the queue lock released and takes the SERVER lock only on the
degraded path, with the plane lock released.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from ..analysis.lockwitness import named_lock
from ..core.version import VersionVector
from ..errors import DeviceFailure, SyncError
from ..obs import metrics as obs
from ..resilience import faultinject

faultinject.register_site(
    "read_batch", "ReadBatcher window worker: fires before any device "
    "work on a drained pull window — the whole window degrades to "
    "per-doc oracle pulls (typed, counted, invisible to sessions)")
faultinject.register_site(
    "export_launch", "batched delta-export selection launch (shared "
    "with parallel.fleet's export_select site)")


class PullTicket:
    """Handle for one batched pull: ``result()`` blocks until the
    window serving it resolves, then returns ``(data, new_vv, epoch)``
    — the wire bytes, the client's advanced frontier (a private copy),
    and the committed epoch the pull covers (the ack watermark).

    ``trace_id`` and ``stages`` carry the read-side attribution
    (window-wait / launch / frame, or the cache-hit and degraded
    paths) the serving window fills in before resolving — the pull
    dual of ``fanin.PushTicket.breakdown()``."""

    __slots__ = ("_ev", "_data", "_vv", "_epoch", "_error", "t0",
                 "trace_id", "stages")

    def __init__(self, trace_id: Optional[str] = None):
        self._ev = threading.Event()
        self._data: Optional[bytes] = None
        self._vv: Optional[VersionVector] = None
        self._epoch = 0
        self._error: Optional[BaseException] = None
        self.t0 = time.perf_counter()
        self.trace_id = trace_id
        self.stages: Optional[dict] = None

    def _resolve(self, data: bytes, vv: VersionVector, epoch: int) -> None:
        self._data, self._vv, self._epoch = data, vv, epoch
        self._ev.set()

    def _fail(self, err: BaseException) -> None:
        self._error = err
        self._ev.set()

    @property
    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: Optional[float] = None
               ) -> Tuple[bytes, VersionVector, int]:
        if not self._ev.wait(timeout):
            raise TimeoutError("batched pull not served yet")
        if self._error is not None:
            raise self._error
        return self._data, self._vv, self._epoch


def _index_device(resident):
    """The device the read plane's index lives on: the resident's own
    device, or the first shard's for a sharded fleet (whose index is
    fleet-wide)."""
    dev = getattr(resident, "_device", None)
    if dev is None:
        dev = resident.devices[0]
    return dev


class ReadPlane:
    """The device-resident read state: one ``ops.export_batch.
    ExportIndex`` fed from the sync commit path (the same decoded
    changes the oracle imports, after the causality gate — so index
    rows ARE the oracle's stored changes) under ``sync.readplane``.

    Plus the **frame cache**: per doc, the last few framed ``(frontier
    -> wire bytes)`` exports.  A doc's delta-since-frontier is
    deterministic between commits, so the cache is exact until the
    next feed invalidates the doc — and a reader fan-out (many
    sessions at the same frontier after one notification) serves
    inline off it, no window, no launch, no re-encode."""

    FRAME_CACHE_PER_DOC = 8

    def __init__(self, server):
        from ..ops.export_batch import ExportIndex

        self._lock = named_lock("sync.readplane")
        # index floor = the oracle head at read-plane birth: pulls
        # whose frontier does not dominate it need pre-index history
        # and stay on the oracle path (recovered servers etc.)
        floors = [
            server._oracle.docs[i].oplog_vv() for i in range(server.n_docs)
        ]
        self.index = ExportIndex(
            server.n_docs, family=server.family, floor_vvs=floors,
            device=_index_device(server.resident),
        )
        # di -> {frontier_key: (data, head_vv, epoch)} (FIFO-bounded)
        self._frames: List[Dict[tuple, tuple]] = [
            {} for _ in range(server.n_docs)
        ]

    def note_changes(self, di: int, chs) -> None:
        """Commit-path feed (caller holds the server lock; this nests
        ``sync.readplane`` under it — the declared order).  Invalidates
        the doc's frame cache: its head moved."""
        with self._lock:
            self.index.note_changes(di, chs)
            self._frames[di].clear()

    def covers(self, di: int, from_vv: VersionVector) -> bool:
        # floor VVs only ever advance, by whole-object swap
        # (prune_below), so this read is safe lock-free — but a pull
        # that passed here may still see its rows pruned before its
        # window processes; _process_device re-checks under the plane
        # lock and re-routes casualties to the oracle
        return self.index.covers(di, from_vv)

    # -- frame cache (caller holds sync.readplane) ---------------------
    @staticmethod
    def frame_key(from_vv: VersionVector) -> tuple:
        return tuple(sorted(from_vv.items()))

    def cached_frame(self, di: int, key: tuple):
        return self._frames[di].get(key)

    def store_frame(self, di: int, key: tuple, data: bytes,
                    head_vv: VersionVector, epoch: int) -> None:
        cache = self._frames[di]
        if len(cache) >= self.FRAME_CACHE_PER_DOC:
            cache.pop(next(iter(cache)))  # FIFO: oldest frontier out
        cache[key] = (data, head_vv, epoch)

    def report(self) -> dict:
        with self._lock:
            return self.index.report()


class ReadBatcher:
    """Unbounded pull queue + leader-elected window processing.

    No dedicated worker thread: the first pulling session to find no
    leader BECOMES the window leader (``drive``) — it waits one short
    gather beat so concurrent pulls pile into its window, drains the
    queue, runs the one selection launch, frames, and resolves every
    ticket including its own.  Followers just block on their tickets.
    Under a reader storm this keeps the whole window on a thread that
    already holds the GIL instead of paying a scheduler handoff per
    window."""

    def __init__(self, server, max_window: int = 256,
                 gather_s: float = 0.002, sleep=None):
        self._server = server
        self.plane = ReadPlane(server)
        self._max_window = max(1, int(max_window))
        # the coalescing beat: the leader sleeps this long before
        # draining, letting racing pulls join its window (one launch
        # instead of N); bounded, so a solo pull pays at most
        # gather_s extra latency.  `sleep` is injectable (fake-clock
        # tests), defaulting to time.sleep.
        self._gather_s = max(0.0, float(gather_s))
        self._sleep = sleep if sleep is not None else time.sleep
        self._lock = named_lock("sync.readbatch")
        self._cv = threading.Condition(self._lock)
        self._q: deque = deque()  # (di, from_vv, ticket)
        self._busy = False  # a leader is gathering/processing
        self._stop = False
        # count-based report (the bench `readplane` sidecar + the
        # one-launch-per-window test guard)
        self._pulls = 0
        self._queued = 0
        self._cache_hits = 0
        self._windows = 0
        self._max_window_seen = 0
        self._frames = 0
        self._frames_shared = 0
        self._degraded_windows = 0
        self._degraded_pulls = 0

    # -- producer side (sessions; may hold the server lock) ------------
    def try_cached(self, di: int, from_vv: VersionVector):
        """Inline fast path: serve this pull straight off the frame
        cache — no queue, no worker round-trip, no launch.  Returns
        ``(data, new_vv, epoch)`` or None on a miss.  Exact by the
        cache's invalidate-on-feed contract (the bytes were framed
        from a device selection at the same doc head)."""
        if self._stop:
            return None
        key = ReadPlane.frame_key(from_vv)
        with self.plane._lock:
            hit = self.plane.cached_frame(di, key)
            if hit is None:
                return None
            data, head_vv, epoch = hit
        with self._lock:
            self._pulls += 1
            self._cache_hits += 1
        obs.counter(
            "readbatch.frame_cache_hits_total",
            "pulls served inline off the read-plane frame cache",
        ).inc(family=self._server.family)
        return data, head_vv.copy(), epoch

    def submit(self, di: int, from_vv: VersionVector,
               trace: Optional[str] = None) -> PullTicket:
        """Enqueue one pull (cheap — callers may hold the server
        lock).  The caller must then ``drive()`` the ticket OUTSIDE
        the server lock: leadership can run the degraded-window
        fallback, which re-enters the oracle under that lock."""
        tk = PullTicket(trace_id=trace)
        with self._cv:
            if self._stop:
                raise SyncError("read batcher is closed")
            self._q.append((di, from_vv, tk))
            self._pulls += 1
            self._queued += 1
            obs.gauge(
                "readbatch.depth", "pulls queued behind the window leader"
            ).set(len(self._q), family=self._server.family)
        return tk

    def drive(self, tk: PullTicket) -> Tuple[bytes, VersionVector, int]:
        """Serve until ``tk`` resolves: become the window leader when
        none is active (gather beat -> drain -> one launch -> frame ->
        resolve), else wait as a follower.  Hold NO locks on entry."""
        while not tk.done:
            with self._cv:
                if tk.done:
                    break
                if self._busy:
                    # follower: the live leader's window (or a later
                    # one we lead ourselves) will resolve us
                    self._cv.wait(0.1)
                    continue
                self._busy = True
            self._lead_once(gather=True)
        return tk.result()

    def _lead_once(self, gather: bool) -> None:
        """One leadership turn (caller set ``_busy``): optional gather
        beat, drain a window, process it, release leadership."""
        try:
            if gather and self._gather_s > 0.0:
                # coalescing beat OUTSIDE the queue lock: racing
                # pulls enqueue into this window meanwhile
                self._sleep(self._gather_s)
            with self._cv:
                window: List[tuple] = []
                while self._q and len(window) < self._max_window:
                    window.append(self._q.popleft())
                if window:
                    self._windows += 1
                    self._max_window_seen = max(
                        self._max_window_seen, len(window)
                    )
            if window:
                self._process_guarded(window)
        finally:
            with self._cv:
                self._busy = False
                self._cv.notify_all()

    def _process_guarded(self, window: List[tuple]) -> None:
        try:
            self._process(window)
        except BaseException as e:  # noqa: BLE001 — fail the window's waiters typed, stay serving
            # a window-level logic error fails ITS tickets (pull
            # raises at the caller) and the batcher keeps serving:
            # selection is a pure read, the next window is
            # independent state
            for _di, _vv, tk in window:
                if not tk.done:
                    tk._fail(e)
            obs.counter(
                "readbatch.window_errors_total",
                "read windows that raised outside the degradation "
                "contract (tickets failed typed)",
            ).inc(family=self._server.family)

    def warmup(self, max_window: Optional[int] = None,
               max_peers: int = 4) -> int:
        """Warm the selection launch for every window-size bucket this
        batcher can form (up to ``max_window``, capped by the batcher's
        own window cap; ``max_peers`` bounds the frontier-width bucket —
        pass the widest per-doc writer count expected), so the first
        reader storm never pays a first launch's cost inside a pull
        (``ExportIndex.warm``).  Warm launches run against throwaway
        tensors of the live shapes, so the plane lock is NOT held across
        them (commits and cached pulls never stall behind a warm), but
        they ride the same device routing real windows use — the batch
        device lock plus the ``DeviceSupervisor`` — so they never
        interleave with an in-place grow/evict on the device and a dead
        device surfaces as typed ``DeviceFailure``.  Returns the number
        of shapes warmed; no-op once closed."""
        if self._stop:
            return 0
        n = self._max_window if max_window is None else min(
            int(max_window), self._max_window
        )

        def thunk():
            return self.plane.index.warm(max(1, n), max_peers)

        sup = self._supervisor()
        batch = getattr(self._server.resident, "batch", None)
        # tiered resident: the hot-set inner batch owns the device
        # queue (the same resolution TieredBatch.export_select does)
        batch = getattr(batch, "inner", batch)
        lock = getattr(batch, "_dev_lock", None)
        if lock is not None:
            with lock:
                done = sup.launch(
                    thunk, label=f"sync.read_warm.{self._server.family}"
                )
        else:
            done = sup.launch(
                thunk, label=f"sync.read_warm.{self._server.family}"
            )
        if done:
            obs.counter(
                "readbatch.warm_launches_total",
                "selection-kernel shapes pre-compiled by warmup()",
            ).inc(done, family=self._server.family)
        return done

    def flush(self) -> None:
        """Block until every submitted pull has been served (pulls are
        leader-driven, so an empty idle queue means done)."""
        with self._cv:
            while self._q or self._busy:
                self._cv.wait(0.05)

    def close(self) -> None:
        """Refuse new submits, then serve anything still queued
        OURSELVES — pulls are leader-driven, and a ticket whose
        submitter died between submit() and drive() (async exception,
        or an external caller that abandoned ``result(timeout)``) has
        no leader coming; waiting on one would hang this close (and
        ``SyncServer.close`` with it).  Idempotent; late pulls route
        to the oracle path (``closed`` gates the Session.pull
        routing)."""
        with self._cv:
            self._stop = True
        while True:
            with self._cv:
                if self._busy:
                    self._cv.wait(0.05)
                    continue
                if not self._q:
                    self._cv.notify_all()
                    return
                self._busy = True
            self._lead_once(gather=False)

    @property
    def closed(self) -> bool:
        return self._stop

    def _process(self, window: List[tuple]) -> None:
        srv = self._server
        obs.histogram(
            "readbatch.window_pulls", "pulls coalesced per read window",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256),
        ).observe(len(window), family=srv.family)
        try:
            # mid-batch failure choke point #1: before any device work
            faultinject.check("read_batch")
            resolved = self._process_device(window)
        except (DeviceFailure, faultinject.InjectedFault) as e:
            if isinstance(e, DeviceFailure) and not e.injected:
                # a real device failure: _process_guarded fails the
                # window's tickets with it, typed; no host bytes
                raise
            self._degrade_window(window, e)
            return
        now = time.perf_counter()
        wait = obs.histogram(
            "sync.pull_wait_seconds",
            "pull submit -> batched window served (device path)",
        )
        stage_h = obs.histogram(
            "trace.pull_stage_seconds",
            "per-stage pull latency attribution (read plane)",
        )
        for tk, data, vv, ep in resolved:
            tk._resolve(data, vv, ep)
            wait.observe(now - tk.t0, family=srv.family,
                         exemplar=tk.trace_id)
            for name, ms in (tk.stages or {}).items():
                if name.endswith("_ms"):
                    stage_h.observe(ms * 1e-3, family=srv.family,
                                    stage=name[:-3],
                                    exemplar=tk.trace_id)

    def _process_device(self, window: List[tuple]) -> List[tuple]:
        """One launch for the whole window; frames deduped by (doc,
        frontier).  Returns ``(ticket, data, new_vv, epoch)`` rows."""
        from ..doc import frame_columnar_updates
        from ..oplog.oplog import trim_known_prefix

        srv = self._server
        t_win = time.perf_counter()  # attribution: window drain time
        groups: Dict[tuple, list] = {}
        order: List[tuple] = []
        for di, vv, tk in window:
            key = (di, tuple(sorted(vv.items())))
            g = groups.get(key)
            if g is None:
                groups[key] = g = [di, vv, []]
                order.append(g)
            g[2].append(tk)
        out: List[tuple] = []
        stale: List[list] = []
        win_hits = win_shared = 0
        with self.plane._lock:
            # epoch snapshot: reads BEFORE any ticket resolves, while
            # holding the plane lock — the commit path feeds the plane
            # before bumping the epoch (both under the server lock), so
            # the index always covers at least this watermark
            epoch = srv._committed_epoch
            # frame-cache pass: groups framed since the doc's last
            # commit serve without re-selection; only misses launch
            # (zero misses -> zero launches for this window)
            misses: List[list] = []
            for g in order:
                di, from_vv, _tks = g
                key = ReadPlane.frame_key(from_vv)
                hit = self.plane.cached_frame(di, key)
                if hit is None:
                    # covers re-check under the plane lock: a compact()
                    # may have pruned index rows this frontier needs
                    # AFTER the routing check passed (the submit ran
                    # under the server lock with the old floor) — a
                    # below-floor selection would silently drop the
                    # pruned changes, so these pulls re-route to the
                    # oracle outside the plane lock instead
                    if not self.plane.index.covers(di, from_vv):
                        stale.append(g)
                        continue
                    g.append(key)
                    misses.append(g)
                else:
                    win_hits += len(g[2])
                    data, head, ep0 = hit
                    for tk in g[2]:
                        tk.stages = {
                            "window_wait_ms": (t_win - tk.t0) * 1e3,
                            "cache_hit": True,
                        }
                        out.append((tk, data, head.copy(), ep0))
            sel = self._launch(
                [(g[0], g[1]) for g in misses]
            ) if misses else []
            t_sel = time.perf_counter()
            for g, idx in zip(misses, sel):
                di, from_vv, tks, key = g
                t_f0 = time.perf_counter()
                log = self.plane.index.changes[di]
                picked = []
                for i in idx:
                    ch = log[int(i)]
                    start = from_vv.get(ch.peer)
                    if ch.ctr_start < start:
                        ch = trim_known_prefix(ch, start)
                    picked.append(ch)
                data = frame_columnar_updates(picked)
                head = self.plane.index.head_vv(di)
                self._frames += 1
                win_shared += len(tks) - 1
                self.plane.store_frame(di, key, data, head, epoch)
                t_f1 = time.perf_counter()
                for tk in tks:
                    tk.stages = {
                        "window_wait_ms": (t_win - tk.t0) * 1e3,
                        "launch_ms": (t_sel - t_win) * 1e3,
                        "frame_ms": (t_f1 - t_f0) * 1e3,
                    }
                    # per-ticket VV copy: sessions mutate their
                    # frontier in place on later pushes
                    out.append((tk, data, head.copy(), epoch))
        # pruned-from-under-us pulls: serve off the oracle, outside the
        # plane lock (the server lock must never nest under readplane)
        for g in stale:
            di, from_vv, tks = g[0], g[1], g[2]
            t_o0 = time.perf_counter()
            with srv._lock:
                data, new_vv, _first = srv._oracle_pull(di, from_vv, None)
                ep1 = srv._committed_epoch
            t_o1 = time.perf_counter()
            obs.counter(
                "readbatch.floor_reroutes_total",
                "window pulls re-routed to the oracle because "
                "compaction pruned their index rows mid-flight",
            ).inc(len(tks), family=srv.family)
            for tk in tks:
                tk.stages = {
                    "window_wait_ms": (t_win - tk.t0) * 1e3,
                    "oracle_ms": (t_o1 - t_o0) * 1e3,
                    "rerouted": True,
                }
                out.append((tk, data, new_vv.copy(), ep1))
        # counter updates AFTER the plane lock (readbatch < readplane
        # in the declared order, so never nest the queue lock under it)
        if win_hits:
            with self._lock:
                self._cache_hits += win_hits
            obs.counter(
                "readbatch.frame_cache_hits_total",
                "pulls served inline off the read-plane frame cache",
            ).inc(win_hits, family=srv.family)
        if win_shared:
            self._frames_shared += win_shared
            obs.counter(
                "readbatch.frames_shared_total",
                "pulls served off another request's frame "
                "(same doc+frontier in the window)",
            ).inc(win_shared, family=srv.family)
        return out

    def _supervisor(self):
        """The resident's DeviceSupervisor, or the process one when the
        resident has no single supervisor (the sharded fleet runs one
        per shard; the read plane's index is fleet-wide)."""
        sup = getattr(self._server.resident, "_sup", None)
        if sup is not None:
            return sup()
        from ..resilience import get_supervisor

        return get_supervisor()

    def _launch(self, requests):
        """Route the selection launch through the family batch's
        ``export_select`` entry (device lock + supervisor + fault
        site); a resident with no single batch (the sharded fleet)
        launches the index directly under the supervisor."""
        resident = self._server.resident
        entry = getattr(getattr(resident, "batch", None), "export_select", None)
        if entry is not None:
            return entry(self.plane.index, requests, sup=self._supervisor())

        def thunk():
            faultinject.check("export_launch")
            return self.plane.index.select(requests)

        return self._supervisor().launch(
            thunk, label=f"sync.read_batch.{self._server.family}"
        )

    # -- typed degradation: this window only ---------------------------
    def _degrade_window(self, window: List[tuple], cause) -> None:
        """Serve every pull of a window that hit an ARMED fault off the
        per-doc oracle — sessions see bytes, never the fault.  The NEXT
        window tries the device again (selection is stateless)."""
        srv = self._server
        self._degraded_windows += 1
        obs.counter(
            "readbatch.degraded_windows_total",
            "read windows degraded whole to per-doc oracle pulls "
            "(DeviceFailure / injected fault)",
        ).inc(family=srv.family)
        self._supervisor().note_degradation(f"sync.read_batch.{srv.family}")
        for di, from_vv, tk in window:
            try:
                t_o0 = time.perf_counter()
                with srv._lock:
                    data, new_vv, _first = srv._oracle_pull(di, from_vv, None)
                    epoch = srv._committed_epoch
                self._degraded_pulls += 1
                obs.counter(
                    "readbatch.degraded_pulls_total",
                    "pulls served by the oracle inside degraded windows",
                ).inc(family=srv.family)
                tk.stages = {
                    "oracle_ms": (time.perf_counter() - t_o0) * 1e3,
                    "degraded": True,
                }
                tk._resolve(data, new_vv, epoch)
            except BaseException as e:  # noqa: BLE001 — per-ticket isolation on the fallback path
                tk._fail(e)

    # -- reporting -----------------------------------------------------
    def report(self) -> dict:
        with self._lock:
            out = {
                "pulls": self._pulls,
                "queued": self._queued,
                "cache_hits": self._cache_hits,
                "windows": self._windows,
                "max_window": self._max_window_seen,
                "frames": self._frames,
                "frames_shared": self._frames_shared,
                "degraded_windows": self._degraded_windows,
                "degraded_pulls": self._degraded_pulls,
            }
        out.update(self.plane.report())
        return out
