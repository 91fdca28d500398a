"""Leader-side WAL shipper: visibility-gated byte streams per segment.

The WAL is already a total order of ingest rounds; shipping it is a
pure file-level protocol — sealed segments stream whole, the open
segment streams up to the **durable watermark** (the fsync'd byte
offset), so a follower can never apply a round the leader has not made
durable (the "tail protocol").  Three visibility
sources, strongest first:

- a live leader object (``leader=``): ``WriteAheadLog.visible_extent``
  — exact, in-process;
- the ``.visible`` marker the leader publishes after each fsync
  (``replication.enable()`` turns it on): cross-process followers of a
  leader in another process.  Sealed segments (index below the
  marker's) are fully visible — rotation fsyncs them closed;
- ``final=True`` (the promotion drain, leader dead): whole files —
  every complete frame on disk is fair game, torn tails are the
  follower's truncate-on-apply problem, exactly the WAL reopen
  contract.

Checkpoint rungs ship as whole files (their writes are atomic
renames).  Fault site ``repl_ship``: ``check`` fires before every
read (raise/delay = a mid-ship crash; the follower resumes from its
acked offset), ``mangle`` corrupts the streamed bytes (truncate /
bitflip = a genuinely torn shipped tail at the follower).
"""
from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

from ..obs import metrics as obs
from ..persist.wal import _seg_index
from ..resilience import faultinject

faultinject.register_site(
    "repl_ship", "WalShipper.read: every shipped byte crosses it — "
    "raise/delay = a mid-ship crash; truncate/bitflip = a torn shipped "
    "tail the follower truncates like a WAL reopen")


class WalShipper:
    """Byte-stream source over one durable directory.

    ``leader=`` is the live durable ResidentServer when shipping
    in-process (exact visibility); None uses the ``.visible`` marker,
    or — with ``final=True`` — whole files (dead-leader drain)."""

    def __init__(self, source_dir: str, leader=None):
        self.source_dir = source_dir
        self.wal_dir = os.path.join(source_dir, "wal")
        self.ckpt_dir = os.path.join(source_dir, "ckpt")
        self.leader = leader
        self.final = False  # promotion drain: whole-file visibility

    # -- visibility ----------------------------------------------------
    def _source_segments(self) -> List[Tuple[int, str]]:
        if not os.path.isdir(self.wal_dir):
            return []
        out = []
        for name in sorted(os.listdir(self.wal_dir)):
            if name.startswith("seg-") and name.endswith(".log"):
                out.append((_seg_index(name),
                            os.path.join(self.wal_dir, name)))
        return out

    def extent(self) -> List[Tuple[int, str, int]]:
        """``(index, path, visible_bytes)`` per source segment."""
        lead = self.leader
        log = getattr(lead, "_durable", None) if lead is not None else None
        if not self.final and log is not None:
            return log.wal.visible_extent()
        segs = self._source_segments()
        if self.final:
            return [(i, p, os.path.getsize(p)) for i, p in segs]
        marker = self._read_marker()
        out: List[Tuple[int, str, int]] = []
        max_idx = segs[-1][0] if segs else 0
        for i, p in segs:
            if i < max_idx:
                vis = os.path.getsize(p)  # sealed: rotation fsync'd it
            elif marker is not None and marker.get("seg") == i:
                vis = int(marker.get("off", 0))
            else:
                # active segment with no (or stale) marker: nothing of
                # it is provably durable — ship none of it yet
                vis = 0
            out.append((i, p, vis))
        return out

    def _read_marker(self) -> Optional[dict]:
        path = os.path.join(self.wal_dir, ".visible")
        try:
            with open(path, "r") as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    # -- byte reads ----------------------------------------------------
    def read(self, path: str, offset: int, length: int) -> bytes:
        """``length`` bytes of ``path`` from ``offset`` — the one choke
        point every shipped byte crosses (the ``repl_ship`` site)."""
        faultinject.check("repl_ship", rtype="segment")
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read(length)
        data = faultinject.mangle("repl_ship", data)
        obs.counter(
            "repl.shipped_bytes_total", "WAL bytes streamed to followers"
        ).inc(len(data))
        return data

    def ckpt_files(self) -> List[Tuple[str, str]]:
        """``(name, path)`` of every checkpoint rung currently on the
        source ladder (atomic-rename files: whole-file visibility)."""
        if not os.path.isdir(self.ckpt_dir):
            return []
        return [
            (n, os.path.join(self.ckpt_dir, n))
            for n in sorted(os.listdir(self.ckpt_dir))
            if n.endswith(".ltck")
        ]

    def extra_files(self) -> List[Tuple[str, str]]:
        """Sidecar manifests worth mirroring (``residency.json`` for
        tiered leaders) — best-effort, whole-file."""
        out = []
        for n in ("residency.json",):
            p = os.path.join(self.source_dir, n)
            if os.path.isfile(p):
                out.append((n, p))
        return out
