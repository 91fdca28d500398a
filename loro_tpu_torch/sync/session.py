"""One client session of a SyncServer (the port of
loro_tpu/sync/session.py).

A session is the server-side half of one connected client replica:

- a per-doc **client version vector** — what the client is known to
  hold.  ``pull(di)`` exports only the delta since that frontier
  (``ExportMode.Updates`` on the per-doc oracle — columnar-updates
  bytes a stock client ``import_()``s), then advances the frontier and
  acks the covered epoch into the resident compaction floors;
- ``push(di, data)`` feeds the client's own update bytes through the
  server's bounded fan-in (``fanin.PushTicket`` resolves at commit);
- a **delta-notification plane**: committed epochs mark the session's
  dirty-doc set (self-coalescing — a slow reader accumulates one flag
  per doc, never an unbounded event log) and ``poll()`` waits on it;
- a **presence inbox**: Awareness/EphemeralStore blobs broadcast by
  other sessions (bounded, drop-oldest — presence is ephemeral by
  definition).

First-sync contract: when the server oracle is *shallow* (its history
floor was trimmed by the checkpoint ladder — every recovered server is)
and the client frontier sits below that floor, a delta cannot exist.
An EMPTY client gets the documented first-sync path instead: ``pull``
returns a full snapshot (the oracle's shallow base rides along, a
fresh ``LoroDoc`` imports it directly).  A NON-empty client below the
floor raises typed ``errors.StaleFrontier`` — it must resync from a
fresh doc.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, Optional

from ..core.version import VersionVector
from ..errors import SessionClosed
from ..obs import flight
from ..obs import heat as heat_acct
from ..obs import metrics as obs
from ..resilience import faultinject
from ..utils import tracing

faultinject.register_site(
    "sync_pull", "Session.pull: raise/delay before the delta export "
    "(client-visible read-path failures)")

# presence inbox bound: a session that never polls drops its OLDEST
# presence blobs (counted) — presence is last-writer-wins ephemeral
# state, so the newest blobs are the ones that matter
PRESENCE_INBOX_CAP = 256


class Session:
    """Construct via ``SyncServer.connect()`` (never directly): the
    server owns the registry, replica registration and presence
    lifecycle this object participates in."""

    def __init__(self, server, sid: str, peer: int, subscribe: bool = True):
        self._server = server
        self.sid = sid
        self.peer = peer  # presence-plane peer id (never a CRDT peer)
        self.subscribed = subscribe
        self.closed = False
        self.last_seen = time.monotonic()
        self._polling = 0  # threads blocked in poll(): never TTL-idle
        # di -> VersionVector the client is known to hold
        self._vv: Dict[int, VersionVector] = {}
        # committed docs the client has not pulled yet (self-coalescing)
        self._dirty: Dict[int, int] = {}  # di -> newest committed epoch
        self._presence: deque = deque()   # encoded presence blobs
        self._dropped_presence = 0
        # attribution of the session's most recent pull (trace id,
        # serving path, per-stage ms); None until the first pull
        self.last_pull: Optional[dict] = None

    # -- internal (called by the server under its lock) ----------------
    def _touch(self) -> None:
        self.last_seen = time.monotonic()

    def _check_open(self) -> None:
        if self.closed:
            raise SessionClosed(f"session {self.sid!r} is closed")

    def _mark_dirty(self, di: int, epoch: int) -> None:
        if self._dirty.get(di, -1) < epoch:
            self._dirty[di] = epoch

    def _push_presence(self, blob: bytes) -> None:
        if len(self._presence) >= PRESENCE_INBOX_CAP:
            self._presence.popleft()
            self._dropped_presence += 1
            obs.counter(
                "sync.presence_dropped_total",
                "presence blobs dropped from slow sessions' inboxes",
            ).inc(family=self._server.family)
        self._presence.append(blob)

    # -- sync ----------------------------------------------------------
    def push(self, di: int, data: bytes):
        """Queue the client's update bytes (a ``doc.export_updates``
        blob) for doc ``di``.  Returns a ``fanin.PushTicket``; blocks
        only on fan-in backpressure.  Malformed envelopes raise typed
        ``errors.PushRejected`` here, before anything is queued."""
        self._check_open()
        return self._server._push(self, di, data)

    def pull(self, di: int, to_frontiers=None, min_epoch=None,
             wait_s: float = 5.0) -> bytes:
        """Delta since this client's frontier for doc ``di`` as
        columnar-updates bytes (``client_doc.import_()`` them), or the
        first-sync snapshot when the oracle is shallow and the client
        is empty.  ``to_frontiers`` bounds the delta
        (``ExportMode.UpdatesInRange``) — e.g. replaying up to a known
        stable point; default is everything the server holds.  Advances
        the client frontier and acks the covered epoch.

        ``min_epoch=`` is the read-your-writes gate:
        block up to ``wait_s`` until the server's committed epoch
        reaches it — pass a push ticket's epoch to read your own write
        from a replication follower; typed ``errors.ReplicaLag`` on
        timeout.  Trivial on a leader (tickets resolve at/after the
        committed epoch).

        Batchable pulls (unbounded, frontier at/above the read-plane
        floor, not a shallow first-sync case) coalesce with concurrent
        pulls into one device export launch through the server's
        ``ReadBatcher``, byte-identical to the oracle export.  Under an
        armed fault the window is served off the oracle transparently;
        a real device failure raises the typed ``DeviceFailure`` here,
        with no host bytes in its place.  Everything else stays on the
        per-doc oracle."""
        self._check_open()
        faultinject.check("sync_pull", doc=di)
        srv = self._server
        trace_id = tracing.new_trace_id("g")
        t_pull0 = time.perf_counter()
        if min_epoch is not None:
            self._wait_min_epoch(di, int(min_epoch), wait_s)
        tk = hit = None
        with srv._lock:
            self._touch()
            from_vv = self._vv.get(di) or VersionVector()
            if to_frontiers is None and srv._route_device(di, from_vv):
                # inline fast path first: a frame already cut at this
                # (doc, frontier) since the doc's last commit serves
                # without a window round-trip (the reader fan-out case)
                hit = srv._readbatch.try_cached(di, from_vv)
                if hit is None:
                    from ..errors import SyncError

                    try:
                        # enqueue under the lock (frontier snapshot is
                        # atomic with the routing decision); the window
                        # drive runs OUTSIDE it
                        tk = srv._readbatch.submit(
                            di, from_vv.copy(), trace=trace_id
                        )
                    except SyncError:
                        tk = None  # closed under us: oracle path below
        if tk is not None or hit is not None:
            data, new_vv, epoch = (
                hit if hit is not None else srv._readbatch.drive(tk)
            )
            stages = dict(tk.stages) if tk is not None and tk.stages \
                else {"cache_hit": True}
            if hit is not None or stages.get("cache_hit"):
                path = "cache"
            elif stages.get("degraded"):
                path = "oracle_degraded"
            elif stages.get("rerouted"):
                path = "oracle_reroute"
            else:
                path = "device"
            stages.update(
                trace_id=trace_id, path=path,
                total_ms=(time.perf_counter() - t_pull0) * 1e3,
            )
            self.last_pull = stages
            flight.record("sync.pull", family=srv.family, doc=di,
                          trace=trace_id, path=path, bytes=len(data))
            with srv._lock:
                self._touch()
                cur = self._vv.get(di)
                if cur is not None:
                    # never regress: a push of ours may have committed
                    # (and advanced the frontier) while the window ran
                    new_vv.merge(cur)
                self._vv[di] = new_vv
                # the window covers `epoch`; a commit landing after its
                # snapshot re-marked the doc — keep that flag alive
                if self._dirty.get(di, -1) <= epoch:
                    self._dirty.pop(di, None)
                srv._ack_at(self, di, epoch)
            heat_acct.tick_doc(di, "pull")
            obs.counter("sync.pulls_total").inc(family=srv.family, kind="delta")
            obs.counter(
                "sync.pulls_batched_total",
                "pulls served by the batched device read plane",
            ).inc(family=srv.family)
            obs.histogram(
                "sync.pull_bytes", "bytes served per pull",
                buckets=(64, 256, 1024, 4096, 16384, 65536, 262144, 1048576),
            ).observe(len(data), family=srv.family)
            return data
        t_o0 = time.perf_counter()
        with srv._lock:
            self._touch()
            from_vv = self._vv.get(di) or VersionVector()
            data, new_vv, first_sync = srv._oracle_pull(
                di, from_vv, to_frontiers
            )
            self._vv[di] = new_vv
            if to_frontiers is None:
                self._dirty.pop(di, None)
                # a FULL pull covers everything committed: ack it into
                # the compaction floors.  A bounded pull integrates
                # strictly less — acking the committed epoch for it
                # would let compact() reclaim rows this client still
                # needs (ResidentServer.ack's contract), so it never
                # acks and the dirty flag survives for the catch-up
                srv._ack(self, di)
        now = time.perf_counter()
        self.last_pull = {
            "trace_id": trace_id,
            "path": "snapshot" if first_sync else "oracle",
            "oracle_ms": (now - t_o0) * 1e3,
            "total_ms": (now - t_pull0) * 1e3,
        }
        flight.record("sync.pull", family=srv.family, doc=di,
                      trace=trace_id, path=self.last_pull["path"],
                      bytes=len(data))
        heat_acct.tick_doc(di, "pull")
        obs.counter("sync.pulls_total").inc(
            family=srv.family, kind="snapshot" if first_sync else "delta"
        )
        obs.histogram(
            "sync.pull_bytes", "bytes served per pull",
            buckets=(64, 256, 1024, 4096, 16384, 65536, 262144, 1048576),
        ).observe(len(data), family=srv.family)
        return data

    def _wait_min_epoch(self, di: int, min_epoch: int,
                        wait_s: float) -> None:
        """Block until the server's committed epoch reaches
        ``min_epoch`` (replicated applies and local commits both
        notify the wakeup condition); typed ``ReplicaLag`` on
        timeout."""
        srv = self._server
        deadline = time.monotonic() + max(0.0, wait_s)
        with srv._lock:
            while srv._committed_epoch < min_epoch:
                left = deadline - time.monotonic()
                if left <= 0:
                    from ..errors import ReplicaLag

                    obs.counter(
                        "repl.min_epoch_timeouts_total",
                        "pull(min_epoch=) gates that timed out lagging",
                    ).inc(family=srv.family)
                    raise ReplicaLag(
                        f"doc {di}: committed epoch "
                        f"{srv._committed_epoch} < min_epoch "
                        f"{min_epoch} after {wait_s}s — the replica is "
                        "lagging; retry, or pull from the leader"
                    )
                srv._wakeup.wait(left)
                self._check_open()

    def frontier(self, di: int) -> VersionVector:
        """The client's known frontier for doc ``di`` (copy)."""
        vv = self._vv.get(di)
        return vv.copy() if vv is not None else VersionVector()

    # -- notifications -------------------------------------------------
    def poll(self, timeout: Optional[float] = None) -> dict:
        """Wait up to ``timeout`` for activity, then drain it:
        ``{"docs": {di: newest_epoch, ...}, "presence": [blobs...]}``.
        Empty dict members mean nothing happened (timeout).  The docs
        map is self-coalesced: however many epochs landed since the
        last poll, the client does ONE pull per dirty doc."""
        self._check_open()
        srv = self._server
        deadline = None if timeout is None else time.monotonic() + timeout
        with srv._lock:
            self._touch()
            # a BLOCKED poller is not idle: TTL expiry skips sessions
            # with a live poll (expire_sessions), so a quiet reader is
            # never disconnected mid-wait
            self._polling += 1
            try:
                while not self._dirty and not self._presence:
                    if deadline is None:
                        srv._wakeup.wait()
                    else:
                        left = deadline - time.monotonic()
                        if left <= 0 or not srv._wakeup.wait(left):
                            break
                    self._check_open()
            finally:
                self._polling -= 1
                self._touch()
            docs = dict(self._dirty)
            self._dirty.clear()
            presence = list(self._presence)
            self._presence.clear()
        return {"docs": docs, "presence": presence}

    def dirty_docs(self) -> Dict[int, int]:
        """Non-blocking view of docs with unpulled commits."""
        with self._server._lock:
            return dict(self._dirty)

    # -- presence ------------------------------------------------------
    def set_presence(self, state) -> None:
        """Publish this session's presence state (cursor, name, ...) to
        every other subscribed session.  Never touches the oplog."""
        self._check_open()
        self._server.presence.set_state(self, state)

    def broadcast_presence(self, blob: bytes) -> None:
        """Relay a client-encoded Awareness or EphemeralStore blob."""
        self._check_open()
        self._server.presence.broadcast(self, blob)

    def presence_states(self) -> dict:
        """The server's aggregated presence view (peer -> state)."""
        return self._server.presence.states()

    # -- lifecycle -----------------------------------------------------
    def close(self) -> None:
        self._server.disconnect(self)

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
