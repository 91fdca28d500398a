"""Segmented append-only write-ahead log of resident ingest rounds.

The ResidentServer round journal is the CRDT oplog of the fleet path,
compactly encoded — but it lived only in RAM, so a process crash lost
every round since birth.  This WAL is the durable form: one record per
APPLIED round, crc32-framed in the codec/binary.py Writer/Reader
envelope family, segment files rotated at every checkpoint so segments
at/under the checkpoint epoch can be deleted wholesale.

Reference shape: loro's L1 ChangeStore journals block-encoded changes
over a KV store (SURVEY §L1); the write-optimized-delta + periodic-
merge split follows the differential-store literature (arxiv
1109.6885) — the WAL is the delta store, checkpoints are the merged
read-optimized store.

Directory layout (under ``<durable_dir>/wal/``)::

    seg-00000001.log
    seg-00000002.log      <- rotated at a checkpoint
    ...

Segment file = 5-byte header ``"LTWL" u8:version`` then frames::

    u32le payload_len | u32le crc32(payload) | payload

Frame payload = ``u8 rtype`` + body (codec/binary Writer primitives):

- ``R_META``  — ``u8 meta_ver, str family, varint n_docs, u8 flags
  (bit0 auto_grow, bit1 host_fallback, bit2 group-commit fsync mode),
  varint n_caps, (str, varint)*``
  Construction caps: cold recovery (no valid checkpoint) rebuilds the
  server from this record.  Written as the FIRST record of EVERY
  segment so pruning old segments never loses it.
- ``R_ROUND`` — ``varint epoch, cid_opt, varint n_docs,
  (u8 present [, bytes_ update])*``.  Updates are the journal's frozen
  wire bytes (encode_changes output or the client payload as-is).
- ``R_CKPT``  — ``varint epoch, str filename``: marker that a
  checkpoint blob landed (inspect shows the ladder inline).

``cid_opt``: ``u8 0`` = None; ``u8 1, u8 ctype, str name`` = root;
``u8 2, u8 ctype, u64le peer, zigzag counter`` = normal.

Torn-tail policy (the crash contract): a bad frame — short header,
length past EOF, crc mismatch, malformed payload — in the NEWEST
segment is a torn tail: scanning stops there, and opening for append
truncates the file back to the last good frame (counted in
``persist.wal_torn_tail_truncations_total``).  The same damage in an
OLDER segment cannot be a torn write (later segments exist, so the
file was complete once) and raises a typed ``CodecDecodeError``.

Fault sites (resilience/faultinject.py): ``wal_write`` fires
``check()`` before each append (raise/delay); ``wal_torn_tail`` runs
the frame bytes through ``mangle()`` on their way to disk, so a
truncate fault writes a genuinely torn frame for reopen tests.
"""
from __future__ import annotations

import os
import struct
import time as _time
import zlib
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

from ..codec.binary import Reader, Writer
from ..core.ids import ContainerID, ContainerType
from ..errors import CodecDecodeError, PersistError
from ..obs import flight
from ..obs import metrics as obs
from ..resilience import faultinject

faultinject.register_site(
    "wal_write", "persist.wal append: raise/delay before the frame "
    "reaches disk (durability-path failures)")
faultinject.register_site(
    "wal_torn_tail", "persist.wal append: mangle the frame bytes on "
    "their way to disk (a genuinely torn write for the reopen-"
    "tolerance tests)")

SEG_MAGIC = b"LTWL"
SEG_VERSION = 1
META_VERSION = 1

R_META = 0
R_ROUND = 1
R_CKPT = 2
R_PRUNE = 3  # round-bearing segments were deleted below this epoch

_FRAME_HDR = 8  # u32le len + u32le crc
_MAX_FRAME = 1 << 31  # sanity bound on a declared payload length

# byte-scale buckets for the append-size histogram (the default obs
# buckets are seconds-scale)
_BYTE_BUCKETS = (64, 256, 1024, 4096, 16384, 65536, 262144,
                 1 << 20, 4 << 20, 16 << 20)


def fsync_dir(path: str) -> None:
    """fsync a DIRECTORY so file creations/renames/unlinks inside it
    survive power loss (file-content fsync alone does not commit the
    directory entry).  Best-effort on platforms without O_DIRECTORY
    semantics."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


# ---------------------------------------------------------------------------
# standalone ContainerID codec (the binary.py cid codec needs the
# payload-level peer dictionary; WAL records are self-contained)
# ---------------------------------------------------------------------------


def write_caps(w: Writer, caps: Dict[str, int]) -> None:
    """Construction-caps table (sorted ``str key, varint value``) —
    THE one encoder: WAL meta and the v3 server checkpoint both ride
    it, so the layouts cannot drift."""
    w.varint(len(caps))
    for k in sorted(caps):
        w.str_(k)
        w.varint(int(caps[k]))


def read_caps(r: Reader) -> Dict[str, int]:
    return {r.str_(): r.varint() for _ in range(r.varint())}


def write_cid_opt(w: Writer, cid: Optional[ContainerID]) -> None:
    if cid is None:
        w.u8(0)
    elif cid.is_root:
        w.u8(1)
        w.u8(int(cid.ctype))
        w.str_(cid.name)
    else:
        w.u8(2)
        w.u8(int(cid.ctype))
        w.u64le(cid.peer)
        w.zigzag(cid.counter)


def read_cid_opt(r: Reader) -> Optional[ContainerID]:
    tag = r.u8()
    if tag == 0:
        return None
    ctype = ContainerType(r.u8())
    if tag == 1:
        return ContainerID.root(r.str_(), ctype)
    if tag == 2:
        return ContainerID.normal(r.u64le(), r.zigzag(), ctype)
    raise ValueError(f"bad cid tag {tag}")


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------


@dataclass
class WalMeta:
    """Construction parameters of the owning server — enough for cold
    recovery to rebuild it without any checkpoint.  ``fsync_mode``
    records the durability mode the log was CREATED with ("per_round"
    or "group" — docs/PERSISTENCE.md "group commit"); it is
    informational (inspect shows it) and excluded from the reopen
    mismatch check, so a directory can be reopened under either mode."""

    family: str
    n_docs: int
    caps: Dict[str, int] = field(default_factory=dict)
    auto_grow: bool = True
    host_fallback: bool = True
    fsync_mode: str = "per_round"
    # deep (history-complete) mirror anchor — sharded fleets set it so
    # a cold recovery rebuilds a migration-capable server; like
    # fsync_mode it is informational for the reopen mismatch check
    deep_anchor: bool = False

    def compatible(self, other: "WalMeta") -> bool:
        """Same server shape (the refusal check ignores fsync_mode)."""
        return (
            self.family == other.family
            and self.n_docs == other.n_docs
            and self.caps == other.caps
            and self.auto_grow == other.auto_grow
            and self.host_fallback == other.host_fallback
        )

    def encode(self) -> bytes:
        w = Writer()
        w.u8(R_META)
        w.u8(META_VERSION)
        w.str_(self.family)
        w.varint(self.n_docs)
        w.u8(
            (1 if self.auto_grow else 0)
            | (2 if self.host_fallback else 0)
            | (4 if self.fsync_mode == "group" else 0)
            | (8 if self.deep_anchor else 0)
        )
        write_caps(w, self.caps)
        return bytes(w.buf)

    @classmethod
    def decode(cls, r: Reader) -> "WalMeta":
        ver = r.u8()
        if ver > META_VERSION:
            raise CodecDecodeError(f"WAL meta v{ver} newer than supported")
        family = r.str_()
        n_docs = r.varint()
        flags = r.u8()
        caps = read_caps(r)
        return cls(
            family, n_docs, caps, bool(flags & 1), bool(flags & 2),
            "group" if flags & 4 else "per_round", bool(flags & 8),
        )


@dataclass
class WalRecord:
    """One decoded frame (``rtype`` selects which fields are set).
    ``trace``/``stamp_us`` are the request-tracing stamps round records
    optionally carry (docs/OBSERVABILITY.md "Request tracing"): the
    trace id of the request that committed the round and the leader's
    wall clock at journal time in microseconds — what a follower's
    apply loop turns into measured replication-lag attribution."""

    rtype: int
    epoch: int = 0
    cid: Optional[ContainerID] = None
    updates: Optional[List[Optional[bytes]]] = None
    meta: Optional[WalMeta] = None
    ckpt_name: str = ""
    trace: Optional[str] = None
    stamp_us: int = 0


def _encode_round(epoch: int, cid, updates, trace: Optional[str] = None,
                  stamp_us: int = 0) -> bytes:
    w = Writer()
    w.u8(R_ROUND)
    w.varint(epoch)
    write_cid_opt(w, cid)
    w.varint(len(updates))
    for u in updates:
        if u is None:
            w.u8(0)
        else:
            w.u8(1)
            w.bytes_(bytes(u))
    # trailing trace stamps: flags byte + optional fields.  Readers
    # that predate them stop after the updates (frame length delimits
    # the payload), and the decoder below checks eof() first — both
    # directions stay compatible without a record-version bump.
    if trace is not None or stamp_us:
        flags = (1 if trace is not None else 0) | (2 if stamp_us else 0)
        w.u8(flags)
        if trace is not None:
            w.str_(trace)
        if stamp_us:
            w.u64le(stamp_us)
    return bytes(w.buf)


def _decode_payload(payload: bytes) -> WalRecord:
    try:
        r = Reader(payload)
        rtype = r.u8()
        if rtype == R_META:
            return WalRecord(R_META, meta=WalMeta.decode(r))
        if rtype == R_ROUND:
            epoch = r.varint()
            cid = read_cid_opt(r)
            ups: List[Optional[bytes]] = []
            for _ in range(r.varint()):
                ups.append(r.bytes_() if r.u8() else None)
            trace: Optional[str] = None
            stamp_us = 0
            if not r.eof():
                flags = r.u8()
                if flags & 1:
                    trace = r.str_()
                if flags & 2:
                    stamp_us = r.u64le()
            return WalRecord(R_ROUND, epoch=epoch, cid=cid, updates=ups,
                             trace=trace, stamp_us=stamp_us)
        if rtype == R_CKPT:
            return WalRecord(R_CKPT, epoch=r.varint(), ckpt_name=r.str_())
        if rtype == R_PRUNE:
            return WalRecord(R_PRUNE, epoch=r.varint())
        raise ValueError(f"unknown WAL record type {rtype}")
    except CodecDecodeError:
        raise
    except (IndexError, ValueError, UnicodeDecodeError, struct.error) as e:
        raise CodecDecodeError(f"malformed WAL record: {e}") from None


# ---------------------------------------------------------------------------
# segment scanning
# ---------------------------------------------------------------------------


@dataclass
class SegmentInfo:
    """Scan result for one segment file (inspect + recovery both use
    it)."""

    path: str
    index: int
    size: int = 0
    good_bytes: int = 0       # offset just past the last valid frame
    n_records: int = 0
    min_epoch: Optional[int] = None
    max_epoch: Optional[int] = None
    torn: bool = False        # bad frame found at good_bytes
    error: str = ""


def _seg_index(name: str) -> int:
    return int(name[len("seg-"):-len(".log")])


def _seg_name(index: int) -> str:
    return f"seg-{index:08d}.log"


def _scan_segment(path: str, index: int, collect=None) -> SegmentInfo:
    """Walk one segment's frames; stop at the first bad frame (torn).
    ``collect(offset, record)`` is called per valid record when given.
    A bad segment HEADER is never a torn tail — it raises typed."""
    info = SegmentInfo(path=path, index=index)
    with open(path, "rb") as f:
        data = f.read()
    info.size = len(data)
    if len(data) < 5 or data[:4] != SEG_MAGIC:
        raise CodecDecodeError(f"{os.path.basename(path)}: not a WAL segment")
    if data[4] > SEG_VERSION:
        raise CodecDecodeError(
            f"{os.path.basename(path)}: WAL segment v{data[4]} too new"
        )
    off = 5
    while off < len(data):
        if off + _FRAME_HDR > len(data):
            info.torn, info.error = True, "short frame header"
            break
        ln, crc = struct.unpack_from("<II", data, off)
        if ln > _MAX_FRAME or off + _FRAME_HDR + ln > len(data):
            info.torn, info.error = True, "frame length past EOF"
            break
        payload = data[off + _FRAME_HDR: off + _FRAME_HDR + ln]
        if zlib.crc32(payload) != crc:
            info.torn, info.error = True, "frame crc mismatch"
            break
        try:
            rec = _decode_payload(payload)
        except CodecDecodeError as e:
            info.torn, info.error = True, str(e)
            break
        if rec.rtype == R_ROUND:
            info.min_epoch = rec.epoch if info.min_epoch is None else info.min_epoch
            info.max_epoch = rec.epoch
        if collect is not None:
            collect(off, rec)
        info.n_records += 1
        off += _FRAME_HDR + ln
    info.good_bytes = off  # torn: offset of the bad frame (= truncate point)
    return info


# ---------------------------------------------------------------------------
# the log
# ---------------------------------------------------------------------------


class WriteAheadLog:
    """Append-only segmented log under ``<dir>`` (one server per
    directory).  Opening an existing directory scans every segment:
    torn tails on the newest segment are truncated away (counted),
    corruption in older segments raises typed ``CodecDecodeError``.

    ``fsync`` selects the durability mode: ``True`` fsyncs every frame
    before the append returns (per-round commit), ``"group"`` defers
    the fsync to an explicit ``sync()`` — the group-commit flush point
    (docs/PERSISTENCE.md): appends stay buffered-to-OS until the owner
    syncs a whole window, amortizing the fsync across rounds; a crash
    loses at most the unsynced tail (the torn-tail reopen contract
    already covers partially-flushed frames).  ``False`` never fsyncs
    (tests only).
    """

    def __init__(self, dir: str, fsync=True):
        self.dir = dir
        if fsync is True:
            self.fsync_mode = "per_round"
        elif fsync is False:
            self.fsync_mode = "off"
        elif fsync in ("per_round", "group", "off"):
            self.fsync_mode = fsync
        else:
            raise PersistError(f"unknown WAL fsync mode {fsync!r}")
        # segment-creation/rotation fsyncs stay on in group mode (rare,
        # and a lost directory entry would orphan the whole segment)
        self.fsync = self.fsync_mode != "off"
        self._unsynced = 0  # appends since the last fsync (group mode)
        os.makedirs(dir, exist_ok=True)
        self._f = None  # active segment file handle
        self._active: Optional[SegmentInfo] = None
        # replication hooks (loro_tpu/replication/, docs/REPLICATION.md):
        # ``fence`` fires before EVERY append — a deposed leader raises
        # typed FencedLeader there, before any bytes reach the segment;
        # ``retention_floor`` pins prune_below at the registered
        # followers' acked epochs; ``publish_visibility`` mirrors the
        # fsync watermark to ``.visible`` so cross-process followers can
        # honor the durable-tail protocol without this object.
        self.fence = None
        self.retention_floor = None
        self.publish_visibility = False
        # fsync watermark on the ACTIVE segment: bytes at/under it are
        # known durable (the ship-visibility bound).  Sealed segments
        # are fully visible — rotation fsyncs them closed.
        self._synced_bytes = 0
        self.meta: Optional[WalMeta] = None
        # newest R_PRUNE floor: rounds at/under it were DELETED from
        # the log, so a from-birth cold replay is no longer possible
        self.pruned_below = 0
        self._segments: List[SegmentInfo] = self._scan_all()
        self._open_active()

    # -- open / scan ---------------------------------------------------
    def _scan_all(self) -> List[SegmentInfo]:
        names = sorted(
            n for n in os.listdir(self.dir)
            if n.startswith("seg-") and n.endswith(".log")
        )
        # drop headerless TRAILING segments first (crash between
        # segment creation and the header write): the survivor then
        # becomes the tail, and a torn frame on IT is a legitimate
        # torn tail, not mid-log corruption
        while names and os.path.getsize(os.path.join(self.dir, names[-1])) < 5:
            os.unlink(os.path.join(self.dir, names.pop()))
            obs.counter(
                "persist.wal_torn_tail_truncations_total",
                "torn WAL tails truncated on reopen",
            ).inc()
        infos: List[SegmentInfo] = []
        for i, name in enumerate(names):
            is_last = i == len(names) - 1
            path = os.path.join(self.dir, name)

            def keep_meta(off, rec):
                if rec.rtype == R_META and self.meta is None:
                    self.meta = rec.meta
                elif rec.rtype == R_PRUNE:
                    self.pruned_below = max(self.pruned_below, rec.epoch)

            info = _scan_segment(path, _seg_index(name), keep_meta)
            if info.torn and not is_last:
                raise CodecDecodeError(
                    f"{name}: corrupt frame in a non-tail WAL segment "
                    f"({info.error}) — not a torn tail (later segments exist)"
                )
            infos.append(info)
        return infos

    def _open_active(self) -> None:
        if not self._segments:
            self._start_segment(1)
            return
        last = self._segments[-1]
        if last.torn:
            # torn tail: truncate back to the last good frame so the
            # next append starts on a clean boundary
            with open(last.path, "r+b") as f:
                f.truncate(last.good_bytes)
            last.size = last.good_bytes
            last.torn = False
            obs.counter(
                "persist.wal_torn_tail_truncations_total",
                "torn WAL tails truncated on reopen",
            ).inc()
        self._f = open(last.path, "ab")
        self._active = last
        # everything that survived the reopen scan is on disk already
        self._synced_bytes = last.good_bytes

    def _start_segment(self, index: int) -> None:
        path = os.path.join(self.dir, _seg_name(index))
        self._f = open(path, "wb")
        self._f.write(SEG_MAGIC + bytes([SEG_VERSION]))
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
            fsync_dir(self.dir)  # commit the new directory entry too
        info = SegmentInfo(path=path, index=index, size=5, good_bytes=5)
        self._segments.append(info)
        self._active = info
        self._synced_bytes = 5
        obs.counter("persist.wal_segments_total").inc()
        # every segment is self-describing: re-write the meta record
        # (and the prune floor, when history was ever dropped) so
        # pruning any prefix of segments never loses what cold
        # recovery needs to rebuild — or to refuse honestly
        if self.meta is not None:
            self._append(self.meta.encode(), rtype="meta")
        if self.pruned_below:
            w = Writer()
            w.u8(R_PRUNE)
            w.varint(self.pruned_below)
            self._append(bytes(w.buf), rtype="prune")
        # control records never ride the group-commit window: the old
        # segment (holding the previous meta copy) may be pruned right
        # after this rotation, so the fresh copy must hit disk first
        self.sync()

    # -- appends -------------------------------------------------------
    def _append(self, payload: bytes, rtype: str) -> None:
        if self._f is None:
            raise PersistError("WAL is closed")
        if self.fence is not None:
            # leader fencing (docs/REPLICATION.md): a promoted follower
            # holds a newer leader token, so this append must fail-stop
            # typed BEFORE any bytes land — never a partial record
            self.fence()
        faultinject.check("wal_write", rtype=rtype)
        frame = (
            struct.pack("<II", len(payload), zlib.crc32(payload)) + payload
        )
        # a truncate/bitflip fault here writes a genuinely damaged
        # frame — the reopen path must cope with it (torn-tail tests)
        frame = faultinject.mangle("wal_torn_tail", frame)
        self._f.write(frame)
        self._f.flush()
        if self.fsync_mode == "per_round":
            self._fsync_active()
        elif self.fsync_mode == "group":
            self._unsynced += 1
        obs.histogram(
            "persist.wal_append_bytes", "WAL frame payload sizes",
            buckets=_BYTE_BUCKETS,
        ).observe(len(payload))
        obs.counter("persist.wal_records_total").inc(rtype=rtype)
        a = self._active
        a.size = a.good_bytes = a.good_bytes + _FRAME_HDR + len(payload)
        a.n_records += 1
        if self.fsync_mode == "per_round":
            # the frame was fsync'd above: the whole segment is visible
            self._synced_bytes = a.good_bytes
            self._publish_visibility()
        elif self.fsync_mode == "off":
            # tests: no fsync anywhere — durability is disclaimed, so
            # visibility = appended bytes.  Publish the marker too:
            # an in-process follower (visible_extent) and a
            # cross-process one (.visible) must see the SAME tail for
            # the same log, whichever process they run in
            self._synced_bytes = a.good_bytes
            self._publish_visibility()

    def _fsync_active(self) -> None:
        """fsync the active segment handle (timed + counted: the
        bench A/B and the count-based perf guard compare fsyncs/round
        across commit modes)."""
        t0 = _time.perf_counter()
        with obs.histogram(
            "persist.wal_fsync_seconds", "WAL fsync wall time"
        ).time():
            os.fsync(self._f.fileno())
        obs.counter(
            "persist.wal_fsyncs_total", "WAL data fsyncs issued"
        ).inc(mode=self.fsync_mode)
        flight.record(
            "wal.fsync", mode=self.fsync_mode,
            ms=round((_time.perf_counter() - t0) * 1e3, 3),
        )

    def sync(self) -> int:
        """Group-commit flush point: fsync the active segment if any
        appends are pending; returns how many appends the fsync covered
        (0 = nothing pending).  No-op in per-round mode (every append
        already synced) and off mode."""
        if self.fsync_mode != "group" or not self._unsynced:
            return 0
        if self._f is None:
            raise PersistError("WAL is closed")
        n, self._unsynced = self._unsynced, 0
        self._fsync_active()
        self._synced_bytes = self._active.good_bytes
        self._publish_visibility()
        obs.histogram(
            "persist.wal_group_commit_rounds", "appends per group fsync",
            buckets=(1, 2, 4, 8, 16, 32, 64, 128),
        ).observe(n)
        return n

    def write_meta(self, meta: WalMeta) -> None:
        """Record construction caps (once per log; re-emitted at every
        rotation).  A log that already carries a DIFFERENT meta belongs
        to another server — cold recovery would rebuild the wrong shape
        from it, so the mismatch is refused, never silently inherited.
        (``fsync_mode`` is excluded: reopening under a different
        durability mode is legitimate — see WalMeta.compatible.)"""
        if self.meta is not None:
            if not self.meta.compatible(meta):
                raise PersistError(
                    f"{self.dir}: WAL meta mismatch — log was created for "
                    f"{self.meta.family}/{self.meta.n_docs} docs, this "
                    f"server is {meta.family}/{meta.n_docs}; use a fresh "
                    "directory (or recover_server for the original)"
                )
            return
        self.meta = meta
        self._append(meta.encode(), rtype="meta")
        # control records never ride the group-commit window: a meta
        # lost from the OS buffer would make the directory scan as
        # empty and let open_server silently build a fresh server over
        # it (the rotation/prune paths sync their copies the same way)
        self.sync()

    def append_round(self, epoch: int, cid, updates,
                     trace: Optional[str] = None,
                     stamp_us: int = 0) -> None:
        """Journal one applied round (``updates``: per-doc frozen wire
        bytes, None = no update for that doc).  ``trace``/``stamp_us``
        optionally stamp the record with the committing request's trace
        id and the leader wall clock (replication-lag attribution —
        docs/OBSERVABILITY.md)."""
        self._append(
            _encode_round(epoch, cid, updates, trace, stamp_us),
            rtype="round",
        )
        a = self._active
        a.min_epoch = epoch if a.min_epoch is None else a.min_epoch
        a.max_epoch = epoch

    def append_ckpt_marker(self, epoch: int, name: str) -> None:
        w = Writer()
        w.u8(R_CKPT)
        w.varint(epoch)
        w.str_(name)
        self._append(bytes(w.buf), rtype="ckpt")

    # -- rotation / pruning -------------------------------------------
    def rotate(self) -> None:
        """Close the active segment and start the next one (called at
        every checkpoint, so older segments become prunable units).
        Pending group-commit appends are fsynced first — a rotated-away
        segment can never be synced again, and silently dropping its
        tail would lose journaled rounds the owner believes durable."""
        self.sync()
        if self._f is not None:
            self._f.close()
        self._start_segment(self._active.index + 1 if self._active else 1)

    def prune_below(self, epoch: int) -> int:
        """Delete non-active segments whose every round is at/under
        ``epoch`` (covered by a checkpoint).  Returns segments
        removed.  When a ROUND-bearing segment goes, an ``R_PRUNE``
        marker lands in the active segment first: cold recovery must
        be able to tell "no rounds ever" from "rounds were deleted"
        (silently replaying a truncated history would fabricate
        state).  With a ``retention_floor`` installed (replication:
        registered followers' acked epochs), the prune point is
        clamped to it — a lagging follower pins the segments it still
        needs (docs/REPLICATION.md "retention")."""
        floor = None
        if self.retention_floor is not None:
            floor = self.retention_floor()
            if floor is not None and floor < epoch:
                obs.gauge(
                    "repl.retention_pinned_floor",
                    "WAL prune epoch pinned by follower acks",
                ).set(floor)
                epoch = floor
        # With a live follower pin, pruning must only ever remove a
        # contiguous PREFIX of the stream, and marker-only segments
        # (max_epoch None: ckpt/prune markers, or freshly rotated and
        # empty) go only when a round-bearing segment that is itself
        # under the clamped floor follows them — an acked epoch maps to
        # round positions, never to marker positions, so a floating
        # marker-only segment may still be ahead of the follower's
        # shipped copy.  Pruning one would punch a hole in the shipped
        # stream and orphan the follower typed (StaleFollower) even
        # though it was fresh and pinned — the epoch-0 auto-checkpoint
        # right after a follower attaches hits exactly this (chaos
        # seed 4, docs/RESILIENCE.md "Chaos plane").
        pinned = floor is not None
        doomed: List[SegmentInfo] = []
        pending: List[SegmentInfo] = []
        for info in self._segments:
            if info is self._active:
                break
            if info.max_epoch is None:
                if pinned:
                    pending.append(info)
                else:
                    doomed.append(info)
            elif info.max_epoch <= epoch:
                doomed.extend(pending)
                pending = []
                doomed.append(info)
            else:
                break
        if any(info.max_epoch is not None for info in doomed):
            floor = max(info.max_epoch for info in doomed
                        if info.max_epoch is not None)
            w = Writer()
            w.u8(R_PRUNE)
            w.varint(floor)
            self._append(bytes(w.buf), rtype="prune")
            # the marker must be durable BEFORE the segments vanish: a
            # crash in between must read "rounds were deleted", never
            # silently replay a truncated history (group mode defers
            # data fsyncs — control records don't get to)
            self.sync()
            self.pruned_below = max(self.pruned_below, floor)
        removed = 0
        keep: List[SegmentInfo] = []
        for info in self._segments:
            if info in doomed:
                os.unlink(info.path)
                removed += 1
            else:
                keep.append(info)
        self._segments = keep
        if removed:
            obs.counter("persist.wal_segments_pruned_total").inc(removed)
        return removed

    # -- reads ---------------------------------------------------------
    def records(self) -> Iterator[WalRecord]:
        """Replay every record across segments in order.  The active
        handle is flushed first so a same-process reader sees its own
        appends."""
        if self._f is not None:
            self._f.flush()
        for info in list(self._segments):
            recs: List[WalRecord] = []
            _scan_segment(info.path, info.index, lambda off, r: recs.append(r))
            for rec in recs:
                yield rec

    def rounds_after(self, epoch: int, doc: Optional[int] = None
                     ) -> List[Tuple[int, Optional[ContainerID], List[Optional[bytes]]]]:
        """Round records with epoch > ``epoch``; ``doc=`` narrows to
        rounds carrying an update for that doc index — the
        one-doc-scoped bounded replay the tiered cold tier uses
        (parallel/residency.py revives a cold doc from its backing
        checkpoint rung plus exactly these rounds)."""
        return [
            (r.epoch, r.cid, r.updates)
            for r in self.records()
            if r.rtype == R_ROUND and r.epoch > epoch
            and (doc is None
                 or (doc < len(r.updates) and r.updates[doc] is not None))
        ]

    def segments(self) -> List[SegmentInfo]:
        return list(self._segments)

    # -- ship visibility (loro_tpu/replication/) -----------------------
    def visible_extent(self) -> List[Tuple[int, str, int]]:
        """``(index, path, visible_bytes)`` per segment — the bytes a
        WAL shipper may stream to a follower.  Sealed segments are
        fully visible (rotation fsyncs them closed); the ACTIVE segment
        is visible only up to the fsync watermark, so a follower can
        never apply a round the leader has not made durable (the
        group-commit tail protocol, docs/REPLICATION.md)."""
        out: List[Tuple[int, str, int]] = []
        for info in self._segments:
            vis = self._synced_bytes if info is self._active else info.good_bytes
            out.append((info.index, info.path, vis))
        return out

    def _publish_visibility(self) -> None:
        """Mirror the fsync watermark to ``<dir>/.visible`` (atomic
        replace, deliberately un-fsynced: it only ever UNDERSTATES what
        is durable, which is the safe direction) so a follower in
        another process can honor the tail protocol.  Off by default —
        ``replication.enable()`` turns it on; non-replicated servers
        never pay the extra write."""
        if not self.publish_visibility or self._active is None:
            return
        import json

        path = os.path.join(self.dir, ".visible")
        tmp = path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump({"seg": self._active.index,
                           "off": self._synced_bytes}, f)
            os.replace(tmp, path)
        except OSError:
            pass  # advisory only; the in-process extent stays exact

    def close(self) -> None:
        if self._f is not None:
            self.sync()  # group mode: never strand a buffered tail
            self._f.close()
            self._f = None


class DurableLog:
    """The per-server durable directory: ``wal/`` (this module) +
    ``ckpt/`` (checkpoints.CheckpointManager), coordinated so a
    checkpoint atomically (a) lands the blob on the ladder, (b) marks
    the WAL, (c) rotates the segment and (d) prunes segments fully
    covered by the checkpoint."""

    def __init__(self, dir: str, fsync=True, keep_recent: int = 3):
        from .checkpoints import CheckpointManager

        self.dir = dir
        os.makedirs(dir, exist_ok=True)
        self.wal = WriteAheadLog(os.path.join(dir, "wal"), fsync=fsync)
        self.checkpoints = CheckpointManager(
            os.path.join(dir, "ckpt"), keep_recent=keep_recent
        )

    @property
    def meta(self) -> Optional[WalMeta]:
        return self.wal.meta

    @property
    def fsync_mode(self) -> str:
        return self.wal.fsync_mode

    def sync(self) -> int:
        """Group-commit flush point (see WriteAheadLog.sync)."""
        return self.wal.sync()

    def ensure_meta(self, meta: WalMeta) -> None:
        self.wal.write_meta(meta)

    def in_use(self) -> bool:
        """True when the directory already holds durable state — round
        records OR checkpoint rungs.  Both matter: a checkpoint prunes
        every round-bearing segment, so a rounds-only check would let
        a fresh server silently reuse (and strand) a live directory."""
        return any(
            s.max_epoch is not None for s in self.wal.segments()
        ) or bool(self.checkpoints.list())

    def append_round(self, epoch: int, cid, updates,
                     trace: Optional[str] = None,
                     stamp_us: int = 0) -> None:
        self.wal.append_round(epoch, cid, updates, trace, stamp_us)

    def record_checkpoint(self, epoch: int, blob: bytes) -> str:
        name = self.checkpoints.save(epoch, blob)
        self.wal.append_ckpt_marker(epoch, name)
        self.wal.rotate()
        # prune only below the OLDEST retained rung: a corrupt newest
        # rung falls DOWN the ladder, and the fallback must still find
        # the rounds between that older rung and now in the WAL
        rungs = self.checkpoints.list()
        if rungs:
            self.wal.prune_below(min(c.epoch for c in rungs))
        return name

    def close(self) -> None:
        self.wal.close()
