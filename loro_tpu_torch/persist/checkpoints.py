"""Checkpoint ladder: a retention-managed directory of ResidentServer
checkpoint blobs.

A checkpoint is the read-optimized merge of everything the WAL
journaled up to its epoch (the differential-store split: WAL = write-
optimized delta, checkpoint = merged store).  Recovery restores the
NEWEST valid blob and replays only WAL rounds after its epoch; a
corrupt newest blob falls back DOWN the ladder (recovery cost grows by
the extra rounds to replay, but never to rounds-since-birth while any
rung is valid).

File format (``<dir>/ck-<epoch:012d>-<seq:04d>.ltck``)::

    "LTCK" | u8 version | varint epoch | u32le crc32(blob) | blob

The blob itself is the ``ResidentServer.checkpoint()`` LTKV store
(docs/ENCODING.md).  ``load`` verifies magic/version/crc and raises
typed ``DecodeError`` on any mismatch — recovery treats that as "this
rung is gone", never as untyped garbage.

Retention ladder: the newest ``keep_recent`` blobs are always kept;
older blobs are thinned to a geometric spacing (each surviving older
rung covers at least twice the epoch span of the one above it), capped
at ``keep_total``.  The ladder therefore spans a long history with
O(log) rungs — deep fallback stays possible without unbounded disk.

Fault site: ``ckpt_corrupt`` runs the framed bytes through
``faultinject.mangle`` on their way to disk, so a bitflip/truncate
fault produces a genuinely corrupt rung for fallback tests.
"""
from __future__ import annotations

import os
import re
import struct
import zlib
from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..codec.binary import Reader, Writer
from ..errors import CodecDecodeError, DecodeError
from ..obs import metrics as obs
from ..resilience import faultinject

faultinject.register_site(
    "ckpt_corrupt", "persist.checkpoints save: mangle the framed rung "
    "blob (recovery must fall back down the ladder)")

CKPT_MAGIC = b"LTCK"
CKPT_VERSION = 1

# widths are zero-padded minimums, not caps: a long-lived server can
# pass 10^4 checkpoints (or 10^12 epochs) and the rungs must stay
# visible to list()/recovery/retention
_NAME_RE = re.compile(r"^ck-(\d{12,})-(\d{4,})\.ltck$")


@dataclass
class CheckpointInfo:
    path: str
    name: str
    epoch: int
    seq: int
    size: int


class CheckpointManager:
    """Save/list/load checkpoint blobs with ladder retention."""

    def __init__(self, dir: str, keep_recent: int = 3, keep_total: int = 8):
        self.dir = dir
        self.keep_recent = max(1, keep_recent)
        self.keep_total = max(self.keep_recent, keep_total)
        os.makedirs(dir, exist_ok=True)

    # -- listing -------------------------------------------------------
    def list(self) -> List[CheckpointInfo]:
        """All rungs, NEWEST first (epoch desc, then seq desc)."""
        out: List[CheckpointInfo] = []
        for name in os.listdir(self.dir):
            m = _NAME_RE.match(name)
            if not m:
                continue
            path = os.path.join(self.dir, name)
            out.append(CheckpointInfo(
                path=path, name=name, epoch=int(m.group(1)),
                seq=int(m.group(2)), size=os.path.getsize(path),
            ))
        out.sort(key=lambda c: (c.epoch, c.seq), reverse=True)
        return out

    # -- save ----------------------------------------------------------
    def save(self, epoch: int, blob: bytes) -> str:
        """Frame + write one blob; apply ladder retention.  Returns the
        file name."""
        seq = max((c.seq for c in self.list()), default=0) + 1
        name = f"ck-{epoch:012d}-{seq:04d}.ltck"
        w = Writer()
        w.buf += CKPT_MAGIC
        w.u8(CKPT_VERSION)
        w.varint(epoch)
        w.u32le(zlib.crc32(blob))
        framed = bytes(w.buf) + blob
        framed = faultinject.mangle("ckpt_corrupt", framed)
        path = os.path.join(self.dir, name)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(framed)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        # commit the rename itself: record_checkpoint prunes the WAL
        # segments this rung covers right after, so a rename that the
        # fs journal hasn't landed would be the ONLY copy of history
        from .wal import fsync_dir

        fsync_dir(self.dir)
        obs.counter("persist.checkpoints_total").inc()
        obs.gauge(
            "persist.checkpoint_epoch", "epoch of the newest checkpoint"
        ).set(epoch)
        self.prune()
        return name

    # -- load ----------------------------------------------------------
    def load(self, info: CheckpointInfo) -> bytes:
        """Verified blob bytes; typed DecodeError on any damage."""
        with open(info.path, "rb") as f:
            data = f.read()
        if len(data) < 5 or data[:4] != CKPT_MAGIC:
            raise CodecDecodeError(f"{info.name}: not a checkpoint file")
        if data[4] > CKPT_VERSION:
            raise CodecDecodeError(f"{info.name}: checkpoint v{data[4]} too new")
        try:
            r = Reader(data)
            r.i = 5
            epoch = r.varint()
            crc = r.u32le()
            blob = data[r.i:]
        except (IndexError, ValueError, struct.error) as e:
            raise CodecDecodeError(f"{info.name}: malformed header: {e}") from None
        if epoch != info.epoch:
            raise CodecDecodeError(
                f"{info.name}: header epoch {epoch} != filename epoch {info.epoch}"
            )
        if zlib.crc32(blob) != crc:
            raise CodecDecodeError(f"{info.name}: checkpoint crc mismatch")
        return blob

    def iter_valid(self, on_skip=None):
        """Yield ``(info, blob)`` down the ladder, skipping rungs that
        fail crc/decode (each skip ticks the fallback counter and
        ``on_skip(info, error)`` when given).  The ONE ladder walk —
        recovery and load_newest both ride it so fallback semantics
        cannot drift."""
        for info in self.list():
            try:
                blob = self.load(info)
            except DecodeError as e:
                obs.counter(
                    "persist.ckpt_fallbacks_total",
                    "corrupt checkpoint rungs skipped during recovery",
                ).inc()
                if on_skip is not None:
                    on_skip(info, e)
                continue
            yield info, blob

    def load_newest(self) -> Optional[Tuple[CheckpointInfo, bytes]]:
        """Newest rung that loads clean, walking DOWN the ladder past
        corrupt blobs (each fallback counted)."""
        return next(self.iter_valid(), None)

    # -- retention -----------------------------------------------------
    def prune(self) -> int:
        """Apply the ladder: keep the newest ``keep_recent``; thin the
        rest to geometric epoch spacing; cap at ``keep_total``."""
        rungs = self.list()
        keep = rungs[: self.keep_recent]
        older = rungs[self.keep_recent:]
        if keep and older:
            newest_epoch = keep[0].epoch
            # each surviving older rung must be at least 2x the age of
            # the previously kept one (age = epoch distance from newest)
            min_age = max(1, newest_epoch - keep[-1].epoch) * 2
            for c in older:
                age = newest_epoch - c.epoch
                if age >= min_age and len(keep) < self.keep_total:
                    keep.append(c)
                    min_age = age * 2
        removed = 0
        keep_paths = {c.path for c in keep}
        for c in rungs:
            if c.path not in keep_paths:
                os.unlink(c.path)
                removed += 1
        return removed
