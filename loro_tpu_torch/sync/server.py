"""SyncServer: session-oriented sync front-end over a ResidentServer (the
port of loro_tpu/sync/server.py).

This is the serving layer the resident stack was built for: many concurrent client sessions speaking the existing columnar
updates wire format to one resident fleet.  Three planes:

- **fan-in** (``fanin.FanIn``): sessions push single-doc update bytes;
  a bounded queue batches concurrent pushes into per-doc ingest rounds
  (one entry per doc per round, same-doc pushes spill FIFO to the next
  round) and feeds them to ``ResidentServer.pipeline()`` as coalesced
  groups — one device launch per group, backpressure to the pushers
  when the queue is full.  Each push's ``PushTicket`` resolves with the
  round's visible epoch at commit, and never before the WAL fsync
  covering it on a ``durable_fsync="group"`` server (an acked push is
  never lost to a crash).
- **fan-out**: committed epochs mark every subscribed session's
  dirty-doc set (self-coalescing) and wake ``poll()``ers; sessions
  then ``pull()`` the delta since their own frontier from the per-doc
  **oracle** — host ``LoroDoc`` mirrors fed the exact same rounds the
  device batch ingests (byte-identical by the differential-fuzz
  contract), seeded from the resident's mirror anchor + journal so a
  ``persist.recover_server`` reopen serves deltas immediately.
- **presence** (``presence.PresencePlane``): Awareness/EphemeralStore
  blobs broadcast through the same session fan-out with TTL expiry,
  never touching the oplog.

Degradation: an ARMED fault inside resident ingest
(``DeviceFailure.injected``) degrades the epoch to the resident's host
mirror transparently (pushes keep committing, pulls keep serving).  A
real device failure (a CUDA error, an out-of-memory, a kernel that
failed to launch) is not hidden behind a host result: the port's
ResidentServer raises it typed, the fan-in's commit-error branch fails
every ticket of that batch with the ``DeviceFailure`` and later pushes
are refused (the fan-in's RuntimeError, as in the JAX package).  The JAX package degrades on any
DeviceFailure; the port only on an armed one.  A poison push fails only
ITS ticket (typed ``errors.PushRejected``); fault sites ``sync_push`` /
``sync_pull`` / ``session_stall`` inject at the new choke points.

The server runs on one device (``device=``, default the card,
``DeviceUnavailable`` without one; tests pass ``"cpu"``) where the JAX
package's takes ``mesh=``.  The fan-in thread hands each batch's rounds
to the resident pipeline, whose stage and commit threads ingest them
(``pipeline=False``: the fan-in thread ingests them itself).

The delta-since-frontier export is eg-walker's version-vector machinery
as implemented by the oplog.
"""
from __future__ import annotations

import struct
import threading
import time
from typing import Dict, List, Optional

from ..analysis.lockwitness import named_rlock
from ..device import DeviceLike
from ..errors import DecodeError, PushRejected, StaleFrontier, SyncError
from ..obs import flight
from ..obs import heat as heat_acct
from ..obs import metrics as obs
from ..resilience import faultinject
from ..utils import tracing
from .fanin import FanIn, PushTicket

faultinject.register_site(
    "sync_push", "SyncServer push entry: raise/delay before the fan-in "
    "queue, or mangle the client's update bytes (typed PushRejected)")
faultinject.register_site(
    "session_stall", "sync fan-out delivery: delay one session's "
    "notification slot (slow-consumer backpressure)")
from .presence import PresencePlane
from .session import Session

_DATA_ERRORS = (ValueError, TypeError, KeyError, IndexError, struct.error)


class SyncServer:
    """Session front-end over one resident family.

    ``SyncServer(family, n_docs, cid=..., device=..., **caps)`` builds
    and owns a fresh ``ResidentServer`` on ``device`` (default the card;
    capacity/durability kwargs pass through);
    ``SyncServer.over(resident)`` fronts an existing one — e.g. the
    server ``persist.recover_server`` returns — without owning its
    lifecycle.  ``cid`` is the served container id (required for the
    positional families, same contract as ``ResidentServer.ingest``;
    map/counter need none; a recovered server already knows its cid).

    ``pipeline=True`` routes fan-in batches through a
    ``PipelinedIngest`` executor (round coalescing + host/device
    overlap); ``False`` falls back to ``ingest_coalesced`` — byte-
    identical state either way.  ``max_queue`` bounds the fan-in
    (backpressure); ``session_ttl`` seconds of idleness expires a
    session (replica floors dropped, presence departure fanned out).

    Thread contract: any number of session threads may push/pull/poll
    concurrently; reads (``texts()``...) flush the fan-in first.
    """

    def __init__(self, family: Optional[str] = None,
                 n_docs: Optional[int] = None, device: DeviceLike = "cuda",
                 cid=None,
                 resident=None, pipeline: bool = True, coalesce: int = 8,
                 depth: int = 2, max_queue: int = 64,
                 session_ttl: float = 30.0, read_batch: bool = True,
                 **caps):
        if resident is None:
            from ..parallel.server import ResidentServer

            if family is None or n_docs is None:
                raise ValueError(
                    "SyncServer needs (family, n_docs) to build a resident "
                    "server, or resident=/.over() to front an existing one"
                )
            resident = ResidentServer(family, n_docs, device=device, **caps)
            self._own_resident = True
        else:
            if caps:
                raise ValueError(
                    "capacity kwargs only apply when SyncServer builds the "
                    f"resident server itself (got {sorted(caps)})"
                )
            self._own_resident = False
        self.resident = resident
        self.family = resident.family
        self.n_docs = resident.n_docs
        self.cid = cid if cid is not None else resident._cid
        if self.family not in ("map", "counter") and self.cid is None:
            raise ValueError(
                f"{self.family} SyncServer needs the served container id "
                "(cid=), same contract as ResidentServer.ingest"
            )
        self._lock = named_rlock("sync.server")
        self._wakeup = threading.Condition(self._lock)
        self._oracle = self._seed_oracle()
        # newest epoch the ORACLE reflects (pulls/acks key on this; the
        # resident's own clock may run ahead mid-batch)
        self._committed_epoch = resident.epoch
        # per-doc oracle head VV, cached per committed epoch (rebuilt
        # lazily, invalidated per dirty doc in _commit_batch) — the
        # oracle pull path stops rebuilding from_vv/to_vv objects per
        # pull, so the host-fallback line in the read A/B is honest
        self._head_vv: Dict[int, object] = {}
        # batched device read plane: pulls coalesce into one export
        # launch; the oracle above is
        # demoted to the differential-fuzz oracle + typed degradation
        # fallback.  read_batch=False keeps every pull on the oracle
        # (the bench A/B's host line).
        if read_batch:
            from .readbatch import ReadBatcher

            self._readbatch = ReadBatcher(self)
        else:
            self._readbatch = None
        self._sessions: Dict[str, Session] = {}
        self._next_peer = 1
        self.session_ttl = session_ttl
        self.presence = PresencePlane(self, ttl_s=session_ttl)
        self._pipe = (
            resident.pipeline(cid=self.cid, coalesce=coalesce, depth=depth)
            if pipeline else None
        )
        self._fanin = FanIn(
            self._commit_batch, max_queue=max_queue, family=self.family
        )
        self._rounds = 0
        self._unsub_epochs = resident.subscribe_epochs(self._on_epoch)
        self._closed = False

    @classmethod
    def over(cls, resident, cid=None, **kw) -> "SyncServer":
        """Front an existing ResidentServer (typically the one
        ``persist.recover_server`` returned).  The oracle seeds from
        the resident's mirror anchor + journal tail, so recovered
        history is servable immediately — as shallow docs, which is
        what makes the first-sync snapshot path in ``Session.pull``
        load-bearing after a reopen."""
        return cls(resident=resident, cid=cid, **kw)

    def _seed_oracle(self):
        """Per-doc LoroDoc mirrors at the resident's current state —
        ``ResidentServer.seed_mirror_engine()``, the same anchor+journal
        replay the degradation path uses, reused as the delta-export
        oracle."""
        srv = self.resident
        if not (srv._host_fallback
                and (srv._history_complete or srv._anchor is not None)):
            raise SyncError(
                "SyncServer needs a resident server with a host-mirror "
                "journal (host_fallback=True; pre-v3 restores lack one) — "
                "the per-doc oracle that serves deltas is seeded from it"
            )
        return srv.seed_mirror_engine()

    def oracle_doc(self, di: int):
        """The per-doc oracle LoroDoc (read-only by contract: mutating
        it diverges pulls from the resident state)."""
        return self._oracle.docs[di]

    # -- epoch-commit hook (ResidentServer.subscribe_epochs) -----------
    def _on_epoch(self, epoch: int) -> None:
        # fires on the committing thread BEFORE pipeline futures
        # resolve; lock-free on purpose (a slow subscriber here would
        # sit inside the resident ingest path).  Session fan-out itself
        # rides _commit_batch — every served round flows through the
        # fan-in, so this hook's job is the observability watermark
        # (and it is the subscription point external consumers, e.g. a
        # future WAL-shipping follower, attach to).
        obs.gauge(
            "sync.committed_epoch",
            "newest resident-visible epoch (epoch-commit hook)",
        ).set(epoch, family=self.family)

    # -- sessions ------------------------------------------------------
    def connect(self, sid: Optional[str] = None, subscribe: bool = True,
                register_replica: bool = True) -> Session:
        """Open a session.  ``register_replica=True`` (default) enters
        the session into every doc's replica set, so its pull-acks
        drive the compaction floors — and an abandoned session pins
        them until TTL expiry drops it (the documented trade)."""
        with self._lock:
            if self._closed:
                raise SyncError("sync server is closed")
            peer = self._next_peer
            self._next_peer += 1
            if sid is None:
                sid = f"s{peer}"
            if sid in self._sessions:
                raise ValueError(f"session id {sid!r} already connected")
            s = Session(self, sid, peer, subscribe=subscribe)
            s._registered = register_replica
            self._sessions[sid] = s
            if register_replica:
                for di in range(self.n_docs):
                    self.resident.register_replica(di, sid)
            obs.gauge(
                "sync.sessions", "connected sessions"
            ).set(len(self._sessions), family=self.family)
        obs.counter("sync.sessions_opened_total").inc(family=self.family)
        return s

    def disconnect(self, session: Session) -> None:
        """Close a session: drop its replica registrations (so it stops
        pinning compaction floors) and fan out its presence departure.
        Idempotent."""
        with self._lock:
            if session.closed:
                return
            session.closed = True
            self._sessions.pop(session.sid, None)
            if session._registered:
                for di in range(self.n_docs):
                    self.resident.drop_replica(di, session.sid)
            obs.gauge(
                "sync.sessions", "connected sessions"
            ).set(len(self._sessions), family=self.family)
            self._wakeup.notify_all()  # unblock its poll()ers (typed)
        self.presence.drop_peer(session.peer)
        obs.counter("sync.sessions_closed_total").inc(family=self.family)

    def sessions(self) -> List[Session]:
        with self._lock:
            return list(self._sessions.values())

    def expire_sessions(self, ttl: Optional[float] = None) -> List[str]:
        """Disconnect sessions idle longer than ``ttl`` (default: the
        server's ``session_ttl``).  Runs opportunistically after every
        fan-in batch; call it from a housekeeping loop too if traffic
        is sparse.  Returns the expired session ids."""
        ttl = self.session_ttl if ttl is None else ttl
        if ttl is None:
            return []
        cutoff = time.monotonic() - ttl
        with self._lock:
            stale = [
                s for s in self._sessions.values()
                if s.last_seen < cutoff and s._polling == 0
            ]
        out = []
        for s in stale:
            obs.counter(
                "sync.sessions_expired_total",
                "sessions dropped by TTL idleness expiry",
            ).inc(family=self.family)
            self.disconnect(s)
            out.append(s.sid)
        if out:
            self.presence.expire()
        return out

    # -- push path -----------------------------------------------------
    def _push(self, session: Session, di: int, data: bytes) -> PushTicket:
        # one armed fault covers every action: raise/delay fire here,
        # truncate/bitflip corrupt the wire bytes (-> typed reject)
        data = faultinject.mangle("sync_push", bytes(data), doc=di)
        if not (0 <= di < self.n_docs):
            raise ValueError(f"doc index {di} out of range [0, {self.n_docs})")
        from ..doc import strip_envelope

        try:
            payload = strip_envelope(bytes(data))
        except (DecodeError,) + _DATA_ERRORS as e:
            obs.counter(
                "sync.push_rejects_total",
                "pushes rejected typed (bad envelope / undecodable payload)",
            ).inc(family=self.family, reason="envelope")
            raise PushRejected(
                f"doc {di}: push is not a valid updates blob: "
                f"{type(e).__name__}: {e}"
            ) from e
        tk = PushTicket(trace_id=tracing.new_trace_id("p"))
        with self._lock:
            session._touch()
        obs.counter("sync.pushes_total").inc(family=self.family)
        flight.record("sync.push", family=self.family, doc=di,
                      trace=tk.trace_id, bytes=len(data))
        self._fanin.submit(di, payload, tk, session)
        return tk

    def _commit_batch(self, items) -> None:
        """Fan-in worker entry: pack one drained batch into ingest
        rounds, commit them through the pipeline (or coalesced ingest),
        honor the durable watermark, apply to the oracle, resolve
        tickets, fan out delta notifications."""
        from ..codec.binary import decode_changes

        rounds: List[list] = []        # per-doc payload lists
        metas: List[dict] = []         # di -> (ticket, changes, session)
        # tentative per-doc frontier: oracle head + every change this
        # batch already accepted for the doc (the causality gate below)
        tentative: Dict[int, object] = {}
        for di, payload, tk, sess in items:
            try:
                chs = decode_changes(bytes(payload))
            except _DATA_ERRORS as e:
                # poison push: fail ITS ticket typed; the resident
                # fleet never sees the payload, nothing half-applies
                tk._fail(PushRejected(
                    f"doc {di}: push payload does not decode: "
                    f"{type(e).__name__}: {e}"
                ))
                obs.counter(
                    "sync.push_rejects_total",
                    "pushes rejected typed (bad envelope / undecodable "
                    "payload)",
                ).inc(family=self.family, reason="decode")
                continue
            # causality gate BEFORE any plane applies it: a push whose
            # deps the server does not hold (a client pushing over a
            # stale export mark) would apply on the device columnar
            # path but not on the oracle — reject it typed here so the
            # two planes can never diverge
            vvt = tentative.get(di)
            if vvt is None:
                with self._lock:
                    vvt = tentative[di] = self._oracle.docs[di].oplog_vv()
            gap = None
            for ch in chs:
                if ch.ctr_start > vvt.get(ch.peer):
                    gap = f"peer {ch.peer} counter {vvt.get(ch.peer)}" \
                          f"..{ch.ctr_start} missing"
                    break
                missing = [d for d in ch.deps if not vvt.includes(d)]
                if missing:
                    gap = f"deps {missing} not held"
                    break
                vvt.extend_to_include(ch.id_span())
            if gap is not None:
                tk._fail(PushRejected(
                    f"doc {di}: push depends on history the server does "
                    f"not hold ({gap}) — re-export from a frontier the "
                    "server has (pull first, or resync)"
                ))
                obs.counter(
                    "sync.push_rejects_total",
                    "pushes rejected typed (bad envelope / undecodable "
                    "payload)",
                ).inc(family=self.family, reason="causality")
                continue
            for r, m in zip(rounds, metas):
                if r[di] is None:
                    r[di] = payload
                    m[di] = (tk, chs, sess)
                    break
            else:
                rounds.append([None] * self.n_docs)
                metas.append({di: (tk, chs, sess)})
                rounds[-1][di] = payload
        if not rounds:
            return
        self._rounds += len(rounds)
        if self._pipe is not None and not self._pipe.closed:
            # each round rides the trace of its FIRST push (the round
            # leader) into the pipeline and the WAL stamp
            prs = [
                self._pipe.submit(list(r), trace=next(
                    (tk.trace_id for tk, _c, _s in m.values()), None
                ))
                for r, m in zip(rounds, metas)
            ]
            epochs = [pr.epoch() for pr in prs]
            # attribution: fold the round's stage-boundary marks into
            # every push ticket the round carried
            for pr, m in zip(prs, metas):
                marks = list(pr.marks)
                for tk, _chs, _sess in m.values():
                    tk.marks.extend(marks)
        else:
            with tracing.ambient(next(
                (tk.trace_id for m in metas
                 for tk, _c, _s in m.values() if tk.trace_id), None
            )):
                epochs = self.resident.ingest_coalesced(
                    [list(r) for r in rounds], self.cid
                )
            t_commit = time.perf_counter()
            for m in metas:
                for tk, _chs, _sess in m.values():
                    tk.mark("commit", t_commit)
        # durable watermark: a resolved ticket is an ACK — it must
        # never outrun the fsync covering its round (group mode defers
        # them; pipeline groups flush at commit, serial singles do not)
        srv = self.resident
        if srv._durable is not None:
            if srv.durable_epoch < epochs[-1]:
                srv.flush_durable()
            t_fsync = time.perf_counter()
            for m in metas:
                for tk, _chs, _sess in m.values():
                    tk.mark("fsync", t_fsync)
        p2v = obs.histogram(
            "sync.push_to_visible_seconds",
            "push submit -> committed + oracle-visible + ticket resolved",
        )
        stage_h = obs.histogram(
            "trace.push_stage_seconds",
            "per-stage push latency attribution (stages telescope to "
            "sync.push_to_visible_seconds)",
        )
        dirty: Dict[int, int] = {}
        resolved: List[tuple] = []
        with self._lock:
            for m, ep in zip(metas, epochs):
                for di, (tk, chs, sess) in m.items():
                    try:
                        # mirror HostEngine.apply per doc: seen-cid
                        # scoping + direct change import
                        for ch in chs:
                            for op in ch.ops:
                                self._oracle._seen_cids[di].setdefault(
                                    op.container
                                )
                        self._oracle.docs[di]._import_changes(
                            list(chs), origin="sync"
                        )
                    except Exception as e:  # noqa: BLE001 — typed reject: the ticket fails PushRejected and the counter below is the reseed signal
                        # should be unreachable: the causality gate
                        # above rejects dep-gap pushes before ANY plane
                        # applies them.  If something still slips
                        # through, fail the ticket typed and count it —
                        # the counter alerting is the signal the oracle
                        # needs reseeding (close + SyncServer.over)
                        tk._fail(PushRejected(
                            f"doc {di}: oracle apply failed: "
                            f"{type(e).__name__}: {e}"
                        ))
                        obs.counter(
                            "sync.oracle_apply_errors_total",
                            "committed pushes the oracle could not apply "
                            "(client protocol violation)",
                        ).inc(family=self.family)
                        continue
                    # read plane: feed the device change-span index the
                    # SAME accepted changes, BEFORE the committed-epoch
                    # bump below — the window worker's epoch snapshot
                    # relies on feed-then-bump (readbatch._process_device)
                    self._head_vv.pop(di, None)
                    if self._readbatch is not None:
                        self._readbatch.plane.note_changes(di, chs)
                    # the pusher holds its own ops: advance its pull
                    # frontier past them so pulls don't echo them back
                    if sess is not None and not sess.closed:
                        vv = sess._vv.get(di)
                        if vv is None:
                            from ..core.version import VersionVector

                            vv = sess._vv[di] = VersionVector()
                        for ch in chs:
                            vv.extend_to_include(ch.id_span())
                    dirty[di] = ep
                    resolved.append((tk, ep))
            if epochs and epochs[-1] > self._committed_epoch:
                self._committed_epoch = epochs[-1]
            self._oracle.epoch = self._committed_epoch
        now = time.perf_counter()
        for tk, ep in resolved:
            if not tk.done:
                # the fanout mark and the p2v observation share `now`,
                # so breakdown() stages sum EXACTLY to the histogram's
                # end-to-end sample (the chaos attribution invariant)
                tk.mark("fanout", now)
                tk._resolve(ep)
                p2v.observe(now - tk.t0, family=self.family,
                            exemplar=tk.trace_id)
                prev = tk.t0
                for name, t in tk.marks:
                    stage_h.observe(t - prev, family=self.family,
                                    stage=name, exemplar=tk.trace_id)
                    prev = t
        if epochs:
            flight.record("sync.commit", family=self.family,
                          epoch=epochs[-1], rounds=len(rounds),
                          pushes=len(resolved))
        # per-doc push heat: one tick per resolved push, fed to the rebalancer accountant
        for m in metas:
            for di in m:
                heat_acct.tick_doc(di, "push")
        self._fan_out_deltas(dirty)
        self.expire_sessions()

    def _fan_out_deltas(self, dirty: Dict[int, int]) -> None:
        if not dirty:
            return
        with self._lock:
            targets = [
                s for s in self._sessions.values()
                if s.subscribed and not s.closed
            ]
        n = 0
        for s in targets:
            # a stalled session delays only its own delivery slot
            faultinject.check("session_stall")
            with self._lock:
                if not s.closed:
                    for di, ep in dirty.items():
                        s._mark_dirty(di, ep)
                    n += 1
        with self._lock:
            self._wakeup.notify_all()
        obs.counter(
            "sync.fanout_notifications_total",
            "delta notifications delivered (per receiving session)",
        ).inc(n, family=self.family)

    def _ack(self, session: Session, di: int) -> None:
        """Pull-time ack into the resident compaction floors (caller
        holds the lock)."""
        self._ack_at(session, di, self._committed_epoch)

    def _ack_at(self, session: Session, di: int, epoch: int) -> None:
        """Ack a specific covered epoch (batched device pulls ack the
        window's snapshot epoch, which may trail the live committed
        epoch; resident.ack is monotone either way)."""
        if session._registered:
            self.resident.ack(di, session.sid, epoch)

    # -- pull serving (oracle path + device routing) --------------------
    def _oracle_head_vv(self, di: int):
        """The oracle's head VV for doc ``di`` (cached copy) — caller
        holds the lock.  Invalidated per dirty doc at commit."""
        vv = self._head_vv.get(di)
        if vv is None:
            vv = self._head_vv[di] = self._oracle.docs[di].oplog_vv()
        return vv.copy()

    def _oracle_pull(self, di: int, from_vv, to_frontiers):
        """Serve one pull off the per-doc oracle (caller holds the
        lock).  Returns ``(data, new_vv, first_sync)``; raises typed
        ``StaleFrontier`` below a shallow root.  The ONE oracle export
        rule — Session.pull's host path and the read batcher's
        degraded-window fallback both route here."""
        from ..doc import ExportMode

        d = self._oracle.docs[di]
        first_sync = False
        if d.is_shallow() and not (d.shallow_since_vv() <= from_vv):
            if len(from_vv) == 0:
                # documented first-sync path: full snapshot (the
                # shallow base rides along; a fresh doc imports it)
                first_sync = True
                data = d.export(ExportMode.Snapshot)
                new_vv = self._oracle_head_vv(di)
                obs.counter(
                    "sync.first_sync_snapshots_total",
                    "pulls served as snapshots (client below the "
                    "oracle's shallow root)",
                ).inc(family=self.family)
            else:
                raise StaleFrontier(
                    f"doc {di}: client frontier {from_vv.to_json()} is "
                    "below the server oracle's shallow root "
                    f"{d.shallow_since_vv().to_json()} — history there "
                    "was trimmed; resync from a fresh doc (empty "
                    "frontier pulls take the first-sync snapshot path)"
                )
        elif to_frontiers is not None:
            to_vv = d.oplog.dag.frontiers_to_vv(to_frontiers)
            data = d.export(ExportMode.UpdatesInRange(from_vv, to_vv))
            new_vv = from_vv.copy()
            for peer, end in to_vv.items():
                if end > new_vv.get(peer):
                    new_vv.set_end(peer, end)
        else:
            data = d.export(ExportMode.Updates(from_vv))
            new_vv = self._oracle_head_vv(di)
        return data, new_vv, first_sync

    def _route_device(self, di: int, from_vv) -> bool:
        """Whether this pull is batchable onto the device read plane
        (caller holds the lock).  Oracle-only: bounded pulls (checked
        by the caller), shallow first-sync / StaleFrontier cases, and
        frontiers below the index floor."""
        rb = self._readbatch
        if rb is None or rb.closed:
            return False
        d = self._oracle.docs[di]
        if d.is_shallow() and not (d.shallow_since_vv() <= from_vv):
            return False
        return rb.plane.covers(di, from_vv)

    # -- reads (flush fan-in, then the resident batch) ------------------
    def flush(self) -> None:
        """Block until every accepted push is committed, oracle-visible
        and its ticket resolved."""
        self._fanin.flush()

    def _read(self, name: str, *args):
        self.flush()
        return getattr(self.resident, name)(*args)

    def texts(self):
        return self._read("texts")

    def richtexts(self):
        return self._read("richtexts")

    def values(self):
        return self._read("values")

    def value_maps(self):
        return self._read("value_maps")

    def root_value_maps(self, name: str):
        return self._read("root_value_maps", name)

    def parent_maps(self):
        return self._read("parent_maps")

    def children_maps(self):
        return self._read("children_maps")

    def value_lists(self):
        return self._read("value_lists")

    @property
    def epoch(self) -> int:
        """Newest oracle-visible epoch (what pulls/acks cover)."""
        return self._committed_epoch

    # -- compaction (resident rows + read-plane index retention) --------
    def compact(self) -> int:
        """Housekeeping pass: flush the fan-in, reclaim resident rows
        under the replica ack floors (``ResidentServer.compact``), and
        prune the device change-span index below the connected
        sessions' pull frontiers.
        Returns resident rows reclaimed."""
        self.flush()
        n = self.resident.compact()
        self._compact_read_plane()
        return n

    def _compact_read_plane(self) -> int:
        """Advance the read-plane index floors to the pointwise MEET of
        every registered session's pull frontier per doc and drop the
        rows below it: every connected client already holds them, so
        only a NEW (or unregistered) client could need them — and its
        below-floor frontier re-routes to the oracle through the
        existing ``covers`` path.  Docs some session never pulled keep
        their floor (an empty frontier meets everything to zero)."""
        rb = self._readbatch
        if rb is None or rb.closed:
            return 0
        with self._lock:
            sessions = [
                s for s in self._sessions.values()
                if s._registered and not s.closed
            ]
            if not sessions:
                return 0
            floors: Dict[int, object] = {}
            for di in range(self.n_docs):
                vvs = [s._vv.get(di) for s in sessions]
                if any(v is None or not len(v) for v in vvs):
                    continue
                floor = vvs[0].copy()
                for v in vvs[1:]:
                    floor = floor.meet(v)
                if len(floor):
                    floors[di] = floor
        pruned = 0
        with rb.plane._lock:
            for di, floor in floors.items():
                pruned += rb.plane.index.prune_below(di, floor)
        return pruned

    # -- lifecycle -----------------------------------------------------
    def report(self) -> dict:
        """Compact outcome dict (the bench ``sync`` sidecar core).
        Fronting a tiered resident (hot_slots=) adds the residency report: pushes/pulls on warm/cold docs
        revive them transparently — a push's ticket simply resolves
        after the revived round commits — so the hit rate here is the
        serving-path cache behavior clients actually saw."""
        with self._lock:
            n_sessions = len(self._sessions)
        out = self._fanin.report()
        out.update(
            sessions=n_sessions,
            rounds=self._rounds,
            committed_epoch=self._committed_epoch,
            pipeline=self._pipe is not None,
        )
        if self._readbatch is not None:
            out["readbatch"] = self._readbatch.report()
        res = getattr(self.resident, "residency", None)
        if res is not None:
            out["residency"] = res.report()
        return out

    def warm_read_plane(self, max_window: Optional[int] = None,
                        max_peers: int = 4) -> int:
        """Warm the read plane's selection shapes (one per window-size
        bucket up to ``max_window``; ``max_peers`` bounds the
        frontier-width bucket) so first-pull windows never bank a
        first-launch cost as serving latency; returns the shape count,
        0 when the read plane is disabled."""
        if self._readbatch is None:
            return 0
        return self._readbatch.warmup(max_window, max_peers)

    def close(self) -> None:
        """Drain the fan-in, close every session, detach from the
        resident server (and close it when this SyncServer built it —
        durable WAL release included)."""
        err = None
        try:
            self._fanin.close()
        except RuntimeError as e:
            err = e
        if self._readbatch is not None:
            # after the fan-in drain (late pushes committed) and
            # WITHOUT the server lock (a degraded window's oracle
            # fallback needs it): queued pulls serve, then the worker
            # stops and Session.pull routes oracle-only
            self._readbatch.close()
        with self._lock:
            self._closed = True
            sessions = list(self._sessions.values())
        for s in sessions:
            self.disconnect(s)
        try:
            self._unsub_epochs()
        except ValueError:
            pass
        if self._own_resident:
            self.resident.close()
        elif self._pipe is not None and not self._pipe.closed:
            self._pipe.close()
        if err is not None:
            raise err

    def __enter__(self) -> "SyncServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
