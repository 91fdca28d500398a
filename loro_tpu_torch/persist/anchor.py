"""Bounded-replay recovery + the shallow-base host-mirror oracle.

Two problems had the same root cause (ROADMAP open item): the
ResidentServer round journal grew for the server's life because BOTH
consumers needed history since birth — ``recover()`` replayed every
round onto a fresh device batch, and the HOST-MIRROR degradation path
seeded per-doc LoroDoc replicas from round zero (folded checkpoint
state cannot seed a replica).

The fix is an *anchor*: at every checkpoint, the journal rounds are
folded into per-doc **shallow snapshots** (``codec/snapshot.py`` state
export via ``ExportMode.StateOnly`` — state at the doc's head, history
trimmed below it, the reference's shallow-snapshot floor).  A fresh
LoroDoc imports that blob and keeps integrating newer rounds through
the normal backfill machinery, so the mirror no longer needs history
below the anchor — and the journal can be trimmed to rounds SINCE the
checkpoint (Eg-walker's principle: merge cost proportional to
concurrent work, not total history; arxiv 2409.14252).

``recover_server(durable_dir)`` is the crash path: restore the newest
checkpoint that loads clean (falling DOWN the ladder past corrupt
rungs), then replay only the WAL rounds after its epoch.  With no
valid rung at all it rebuilds from the WAL meta record and replays
from birth — strictly the old behavior, now the worst case instead of
the only case.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from ..codec.binary import Reader, Writer
from ..device import DeviceLike, resolve_device
from ..errors import CodecDecodeError, DecodeError, PersistError
from ..obs import metrics as obs
from .wal import DurableLog, read_cid_opt, write_cid_opt

ANCHOR_VERSION = 2


class MirrorAnchor:
    """Per-doc shallow snapshot anchors at one journal epoch.

    ``advance(rounds, cid)`` folds journal rounds (epoch-ascending,
    frozen wire bytes) newer than the anchor into the per-doc blobs;
    ``seed_engine()`` builds a ``hostpath.HostEngine`` whose docs start
    from the anchors instead of from birth.

    ``deep=True`` anchors fold FULL snapshots (history included)
    instead of StateOnly blobs: the seeded mirror docs can then export
    updates since birth — the capability live doc migration between
    shards needs (docs/SHARDING.md) — at the cost of history-sized
    instead of state-sized anchor blobs."""

    def __init__(self, family: str, n_docs: int, deep: bool = False):
        self.family = family
        self.n_docs = n_docs
        self.deep = deep
        self.epoch = 0
        self.cid = None
        # per-doc StateOnly blob (b"" = doc still empty at the anchor)
        self.doc_blobs: List[bytes] = [b""] * n_docs
        # per-doc first-seen container ids (the device batches scope
        # map/counter reads by the cids in that doc's ops; the state
        # blob alone cannot reproduce first-seen order)
        self.seen_cids: List[list] = [[] for _ in range(n_docs)]

    # -- mirror seeding ------------------------------------------------
    def seed_engine(self):
        """HostEngine whose docs imported the anchor blobs.  Reads are
        byte-identical to a from-birth mirror by the shallow-snapshot
        contract (state at the anchor head, later rounds backfill)."""
        from ..resilience.hostpath import HostEngine

        eng = HostEngine(self.family, self.n_docs)
        eng._cid = self.cid
        for i, blob in enumerate(self.doc_blobs):
            if blob:
                eng.docs[i].import_(blob, origin="persist-anchor")
            eng._seen_cids[i] = {c: None for c in self.seen_cids[i]}
        return eng

    def advance(self, rounds, cid=None) -> None:
        """Fold journal rounds (``(epoch, frozen_updates, cid)``) with
        epoch > self.epoch into fresh anchors.  Only TOUCHED docs (a
        non-None entry in some folded round) are imported and
        re-exported — untouched docs keep their blobs, so a checkpoint
        costs O(active docs), not O(fleet state).  Re-exporting keeps
        the anchor state-sized: fold docs never accumulate history
        across checkpoints."""
        from ..doc import ExportMode
        from ..resilience.hostpath import HostEngine

        todo = [r for r in rounds if r[0] > self.epoch]
        if cid is not None:
            self.cid = cid
        if not todo:
            return
        touched = {
            di
            for _e, ups, _c in todo if ups is not None
            for di, u in enumerate(ups) if u is not None
        }
        eng = HostEngine(self.family, self.n_docs)
        eng._cid = self.cid
        for i in touched:
            if self.doc_blobs[i]:
                eng.docs[i].import_(self.doc_blobs[i], origin="persist-anchor")
            eng._seen_cids[i] = {c: None for c in self.seen_cids[i]}
        for epoch, ups, c in todo:
            eng.apply(ups, c)
            self.epoch = epoch
        if eng._cid is not None:
            self.cid = eng._cid
        for i in touched:
            d = eng.docs[i]
            if not len(d.oplog_vv()):
                self.doc_blobs[i] = b""
            elif self.deep:
                self.doc_blobs[i] = d.export(ExportMode.Snapshot)
            else:
                self.doc_blobs[i] = d.export(ExportMode.StateOnly)
            self.seen_cids[i] = list(eng._seen_cids[i])

    # -- wire ----------------------------------------------------------
    def encode(self) -> bytes:
        w = Writer()
        # non-deep anchors stay on the v1 layout byte-for-byte; the
        # flags byte exists only in v2 (deep) blobs.  Literal layout
        # versions on purpose: a future ANCHOR_VERSION bump must not
        # silently re-tag these bytes
        w.u8(2 if self.deep else 1)
        if self.deep:
            w.u8(1)
        w.str_(self.family)
        w.varint(self.n_docs)
        w.varint(self.epoch)
        write_cid_opt(w, self.cid)
        for blob in self.doc_blobs:
            w.bytes_(blob)
        for cids in self.seen_cids:
            w.varint(len(cids))
            for c in cids:
                write_cid_opt(w, c)
        return bytes(w.buf)

    @classmethod
    def decode(cls, data: bytes) -> "MirrorAnchor":
        try:
            r = Reader(data)
            ver = r.u8()
            if ver > ANCHOR_VERSION:
                raise CodecDecodeError(f"mirror anchor v{ver} too new")
            deep = bool(r.u8() & 1) if ver >= 2 else False
            a = cls(r.str_(), r.varint(), deep=deep)
            a.epoch = r.varint()
            a.cid = read_cid_opt(r)
            a.doc_blobs = [r.bytes_() for _ in range(a.n_docs)]
            a.seen_cids = [
                [read_cid_opt(r) for _ in range(r.varint())]
                for _ in range(a.n_docs)
            ]
            return a
        except CodecDecodeError:
            raise
        except (IndexError, ValueError, UnicodeDecodeError) as e:
            raise CodecDecodeError(f"malformed mirror anchor: {e}") from None


# ---------------------------------------------------------------------------
# recovery
# ---------------------------------------------------------------------------


@dataclass
class RecoveryReport:
    """What recovery actually did (tests assert bounded replay on it;
    ``server.last_recovery`` keeps it)."""

    checkpoint_epoch: int = 0          # 0 = no valid rung, cold replay
    checkpoint_name: str = ""
    checkpoints_skipped: int = 0       # corrupt rungs fallen past
    rounds_replayed: int = 0
    recovered_epoch: int = 0
    cold: bool = False                 # rebuilt from WAL meta, no rung


def recover_server(durable_dir: str, device: DeviceLike = "cuda", fsync: bool = True):
    """Reopen a durable directory after a crash: newest valid
    checkpoint + bounded WAL replay.  Returns a live ResidentServer
    (durable journaling re-attached, ``last_recovery`` holding the
    RecoveryReport).

    Raises ``PersistError`` if the directory has no WAL at all, and
    typed ``DecodeError`` if the WAL itself is corrupt beyond the
    torn-tail contract.  ``device`` defaults to the card and raises
    DeviceUnavailable without one, before the directory is opened."""
    from ..parallel.server import ResidentServer

    device = resolve_device(device)
    log = DurableLog(durable_dir, fsync=fsync)
    if log.meta is None and not log.checkpoints.list():
        log.close()
        raise PersistError(
            f"{durable_dir}: no WAL meta and no checkpoints — nothing to "
            "recover (a fresh server writes the meta at construction; "
            "this directory never held one, or died before the write)"
        )
    report = RecoveryReport()

    def _skip(info, err):
        report.checkpoints_skipped += 1

    try:
        srv = None
        for info, blob in log.checkpoints.iter_valid(on_skip=_skip):
            try:
                srv = ResidentServer.restore(blob, device=device)
            except DecodeError:
                # crc-clean rung whose server state won't decode: fall
                # further down the ladder like any other corrupt rung
                _skip(info, None)
                obs.counter(
                    "persist.ckpt_fallbacks_total",
                    "corrupt checkpoint rungs skipped during recovery",
                ).inc()
                continue
            report.checkpoint_epoch = info.epoch
            report.checkpoint_name = info.name
            break
        if srv is None:
            # cold path: every rung corrupt (or none existed) — rebuild
            # from the WAL meta record and replay from birth
            meta = log.meta
            if meta is None:
                raise DecodeError(
                    f"{durable_dir}: every checkpoint rung is corrupt and "
                    "the WAL has no meta record — unrecoverable"
                )
            if log.wal.pruned_below > 0:
                # rounds at/under this epoch were DELETED at checkpoint
                # time: a from-birth replay would silently fabricate a
                # truncated history — typed refusal, never garbage
                raise DecodeError(
                    f"{durable_dir}: every checkpoint rung is corrupt and "
                    f"the WAL was pruned below epoch "
                    f"{log.wal.pruned_below} — history incomplete, "
                    "unrecoverable"
                )
            report.cold = True
            srv = ResidentServer(
                meta.family, meta.n_docs, device=device,
                auto_grow=meta.auto_grow, host_fallback=meta.host_fallback,
                auto_checkpoint=False,
                mirror_anchor="deep" if meta.deep_anchor else True,
                **meta.caps,
            )
        # bounded replay: only rounds after the restored epoch
        tail = log.wal.rounds_after(report.checkpoint_epoch)
        srv._replay_journal_tail(tail)
        if log.meta is None and srv._caps is not None:
            # ladder-only recovery (WAL lost/empty): re-seed the meta
            # record from the v3 checkpoint's caps so a LATER cold
            # recovery of this directory stays possible
            from .wal import WalMeta

            log.ensure_meta(WalMeta(
                family=srv.family, n_docs=srv.n_docs,
                caps=dict(srv._caps), auto_grow=srv._auto_grow,
                host_fallback=srv._host_fallback,
            ))
    except BaseException:
        log.close()  # never leak the active segment handle on failure
        raise
    report.rounds_replayed = len(tail)
    report.recovered_epoch = srv.epoch
    if report.checkpoint_name:
        # tiered residency (parallel/residency.py): the restored rung
        # carries every doc's anchor blob, so it becomes the backing
        # rung for the docs that were cold at checkpoint time — their
        # blobs drop out of RAM again unless the WAL replay already
        # revived them.  No-op for plain servers.
        hook = getattr(srv.batch, "note_restored_rung", None)
        if hook is not None:
            srv.attach_durable(log)  # the hook re-reads/writes the dir
            hook(report.checkpoint_name)
    obs.counter(
        "persist.recovery_rounds_replayed_total",
        "WAL rounds replayed by recover_server",
    ).inc(len(tail))
    obs.counter("persist.recoveries_total").inc(
        outcome="cold" if report.cold else "checkpoint"
    )
    srv.attach_durable(log)
    srv.last_recovery = report
    return srv


def open_server(durable_dir: str, family: Optional[str] = None,
                n_docs: Optional[int] = None, device: DeviceLike = "cuda", fsync: bool = True,
                **kw):
    """Open-or-create: recover when the directory holds durable state
    (a WAL meta/rounds or a checkpoint ladder), else build a fresh
    durable server (``family``/``n_docs`` required then).  A WAL that
    died before its meta record — bare segment headers, no rounds, no
    rungs — counts as empty, so the directory never dead-ends.  The
    convenience entry point examples/ and the soaks use."""
    device = resolve_device(device)
    probe = DurableLog(durable_dir, fsync=fsync)
    held = probe.in_use() or probe.meta is not None
    probe.close()
    if held:
        return recover_server(durable_dir, device=device, fsync=fsync)
    if family is None or n_docs is None:
        raise PersistError(
            f"{durable_dir}: empty durable dir — pass family/n_docs to "
            "create a fresh server"
        )
    from ..parallel.server import ResidentServer

    return ResidentServer(
        family, n_docs, device=device, durable_dir=durable_dir,
        durable_fsync=fsync, **kw,
    )
