"""Read-only SyncServer over a follower resident.

The whole session surface — ``pull`` (batched device read plane
included), ``poll``, presence, frontiers, first-sync snapshots, TTL
expiry — works unchanged over a follower; the ONE difference is that a
``push()`` raises typed ``errors.NotLeader`` carrying the leader's
identity so clients redirect instead of guessing.  ``promote()`` flips
the server writable in place: the same sessions keep their frontiers
and start pushing.

The follower feeds committed rounds through ``_apply_replicated``
(the leader-side ``_commit_batch`` oracle/read-plane/fan-out tail,
minus the fan-in that never runs here): oracle import, change-span
index feed, committed-epoch bump, dirty marks and poll wakeups — so a
follower pull is byte-identical to the leader's at the same epoch (the
differential gate in tests/test_replication.py) and ``poll()``ers wake
on replicated commits exactly like on local ones.

Read-your-writes across the fleet: ``Session.pull(min_epoch=ticket_
epoch)`` blocks until the replica has applied that epoch (typed
``ReplicaLag`` on timeout) — push to the leader, read your write from
any follower.
"""
from __future__ import annotations

import struct
from typing import Optional

from ..errors import NotLeader
from ..obs import metrics as obs
from ..sync.server import SyncServer

_DATA_ERRORS = (ValueError, TypeError, KeyError, IndexError, struct.error)


class ReadOnlySyncServer(SyncServer):
    """``ReadOnlySyncServer.over(follower_resident, leader_id=...)`` —
    always construct via ``over`` (a follower resident already knows
    its family/cid).  ``pipeline`` is forced off: there is no write
    path to pipeline until promotion."""

    def __init__(self, *args, leader_id: Optional[str] = None, **kw):
        kw["pipeline"] = False
        super().__init__(*args, **kw)
        self.leader_id = leader_id
        self._writable = False

    # -- the read-only contract ----------------------------------------
    def _push(self, session, di: int, data: bytes):
        if not self._writable:
            obs.counter(
                "repl.not_leader_pushes_total",
                "pushes refused typed by read-only followers",
            ).inc(family=self.family)
            raise NotLeader(
                f"doc {di}: this server is a read-only follower — "
                "push to the leader", leader=self.leader_id,
            )
        return super()._push(session, di, data)

    def _promote_writable(self) -> None:
        """Called by ``Follower.promote()`` once the resident is
        durable-attached and writable: pushes start landing through the
        coalesced-ingest path (no pipeline is attached — attach one via
        ``resident.pipeline()`` before promoting if wanted)."""
        with self._lock:
            self._writable = True
            self.leader_id = None

    # -- replicated-round feed (Follower._apply_new) -------------------
    def _apply_replicated(self, epoch: int, cid, updates) -> None:
        """Apply one shipped round's frozen wire bytes to the serving
        planes: per-doc oracle import + change-span index feed (before
        the epoch bump — the window-snapshot contract), then the
        committed-epoch bump, dirty marks and poll wakeups."""
        from ..codec.binary import decode_changes

        if cid is not None and self.cid is None:
            self.cid = cid
        dirty = {}
        with self._lock:
            for di, u in enumerate(updates):
                if u is None:
                    continue
                try:
                    chs = decode_changes(bytes(u))
                except _DATA_ERRORS:
                    # shipped bytes applied once on the leader already;
                    # a decode failure here means damage on our side —
                    # isolate the doc, never the stream
                    obs.counter(
                        "repl.apply_decode_errors_total",
                        "shipped round entries the follower oracle "
                        "could not decode",
                    ).inc(family=self.family)
                    continue
                for ch in chs:
                    for op in ch.ops:
                        self._oracle._seen_cids[di].setdefault(op.container)
                self._oracle.docs[di]._import_changes(
                    list(chs), origin="repl"
                )
                self._head_vv.pop(di, None)
                if self._readbatch is not None:
                    self._readbatch.plane.note_changes(di, chs)
                dirty[di] = epoch
            if epoch > self._committed_epoch:
                self._committed_epoch = epoch
            self._oracle.epoch = self._committed_epoch
            if not dirty:
                # empty rounds still advance the epoch: wake min_epoch
                # gates waiting on it
                self._wakeup.notify_all()
        if dirty:
            self._fan_out_deltas(dirty)
