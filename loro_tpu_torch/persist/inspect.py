"""One-screen dump of a durable directory.

Usage::

    python -m loro_tpu_torch.persist.inspect <durable_dir>

Shows the WAL meta, every segment (records, epoch range, crc/torn
status), every checkpoint rung (epoch, size, crc status) and the
recovery preview (which rung would restore, how many rounds replay).
A sharded fleet directory (``sharding.json`` manifest +
``shard-NN/`` sub-dirs, docs/SHARDING.md) prints one screen per
shard plus the fleet-wide minimum durable watermark.  Read-only:
never truncates a torn tail, never prunes.
"""
from __future__ import annotations

import json
import os
import sys
from typing import List, Optional

from ..errors import DecodeError
from .checkpoints import CheckpointManager
from .wal import R_ROUND, SegmentInfo, _scan_segment, _seg_index


def _human(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024.0
    return f"{n}B"


def _emap_to_global(bps, e: int) -> int:
    """Manifest epoch-map interpolation: shard-local epoch → fleet
    global, through the REAL `_EpochMap` (parallel/placement.py is
    torch-free on purpose so this tool can import it)."""
    from ..parallel.placement import _EpochMap

    return _EpochMap.decode(bps).to_global(e)


def _inspect_sharded(durable_dir: str, manifest: dict, out) -> int:
    """Multi-shard report: one screen per shard + the fleet-wide min
    durable watermark — the min over shards of each shard's durable
    floor (newest journaled round, or newest valid checkpoint rung
    when the WAL was legitimately pruned by it), translated to the
    GLOBAL clock through the manifest's epoch maps (shard clocks tick
    faster than fleet rounds — delete rounds, poison isolation).  A
    shard with neither rounds nor rungs while its siblings have some
    pins the floor to 0: lockstep clocks journal every fleet round to
    every shard, so a bare directory next to full ones means that
    shard lost its durable state."""
    p = lambda s="": print(s, file=out)  # noqa: E731
    n_shards = int(manifest.get("shards", 0))
    placement = manifest.get("shard_of", [])
    emaps = manifest.get("emaps") or [[[0, 0]]] * n_shards
    p(f"sharded fleet: {durable_dir}")
    p(f"manifest: family={manifest.get('family')} "
      f"n_docs={manifest.get('n_docs')} shards={n_shards} "
      f"global_epoch={manifest.get('global_epoch')}")
    rc = 0
    marks: List[tuple] = []  # (shard, shard-local floor or None)
    for s in range(n_shards):
        sub = os.path.join(durable_dir, f"shard-{s:02d}")
        docs = [g for g, sh in enumerate(placement) if sh == s]
        p()
        p(f"--- shard-{s:02d} ({len(docs)} doc(s): "
          f"{','.join(map(str, docs[:8]))}"
          f"{',...' if len(docs) > 8 else ''}) ---")
        if not os.path.isdir(sub):
            p("  MISSING (manifest names it, directory absent)")
            rc = 1
            marks.append((s, None))
            continue
        stats: dict = {}
        rc = max(rc, inspect_dir(sub, out=out, _stats=stats))
        floors = [e for e in (stats.get("newest_round_epoch"),
                              stats.get("newest_ckpt_epoch"))
                  if e is not None]
        marks.append((s, max(floors) if floors else None))
    p()
    known = [(s, e) for s, e in marks if e is not None]
    if not known:
        p("fleet-wide min durable watermark: (nothing journaled yet)")
    elif len(known) < len(marks):
        bare = ", ".join(f"shard-{s:02d}" for s, e in marks if e is None)
        p(f"fleet-wide min durable watermark: global epoch 0 — {bare} "
          "holds NO rounds and NO rungs while siblings do "
          "(lost/missing durable state?)")
        rc = 1
    else:
        s_min, g_min, e_min = min(
            ((s, _emap_to_global(emaps[s] if s < len(emaps) else [[0, 0]],
                                 e), e)
             for s, e in known),
            key=lambda x: x[1],
        )
        p(f"fleet-wide min durable watermark: global epoch {g_min} "
          f"(shard-{s_min:02d} local e{e_min})")
    return rc


def inspect_dir(durable_dir: str, out=None, _stats: Optional[dict] = None) -> int:
    """Print the report; returns a process exit code (0 clean, 1 if
    any segment is torn/corrupt or any rung fails its crc).  A
    sharded fleet dir recurses into its shards.  ``_stats`` (internal)
    receives facts the sharded summary needs from the single scan —
    currently ``newest_round_epoch`` — so the fleet report never
    re-reads segments."""
    out = out or sys.stdout
    p = lambda s="": print(s, file=out)  # noqa: E731
    manifest_path = os.path.join(durable_dir, "sharding.json")
    if os.path.isfile(manifest_path):
        try:
            with open(manifest_path, "r") as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            p(f"sharded fleet: {durable_dir}")
            p(f"  sharding.json UNREADABLE ({e})")
            return 1
        return _inspect_sharded(durable_dir, manifest, out)
    rc = 0
    wal_dir = os.path.join(durable_dir, "wal")
    p(f"persist dir: {durable_dir}")

    # -- WAL segments (ONE read-only scan: no truncation; the per-
    # segment record lists feed every count below) ---------------------
    segs: List[SegmentInfo] = []
    seg_recs: List[list] = []
    meta = None
    if os.path.isdir(wal_dir):
        names = sorted(
            n for n in os.listdir(wal_dir)
            if n.startswith("seg-") and n.endswith(".log")
        )
        for name in names:
            path = os.path.join(wal_dir, name)
            try:
                recs = []
                info = _scan_segment(
                    path, _seg_index(name), lambda off, r: recs.append(r)
                )
                for r in recs:
                    if r.rtype == 0 and meta is None:  # R_META
                        meta = r.meta
                segs.append(info)
                seg_recs.append(recs)
            except DecodeError as e:
                p(f"  {name}: UNREADABLE ({e})")
                rc = 1
    if meta is not None:
        caps = " ".join(f"{k}={v}" for k, v in sorted(meta.caps.items()))
        p(f"meta: family={meta.family} n_docs={meta.n_docs} "
          f"auto_grow={meta.auto_grow} host_fallback={meta.host_fallback} "
          f"fsync={meta.fsync_mode}"
          + (" deep_anchor=True" if meta.deep_anchor else "")
          + (f" {caps}" if caps else ""))
    else:
        p("meta: (none)")
    p(f"wal segments: {len(segs)}")
    rounds = [r for recs in seg_recs for r in recs if r.rtype == R_ROUND]
    if _stats is not None:
        _stats["newest_round_epoch"] = max(
            (r.epoch for r in rounds), default=None
        )
    for s in segs:
        span = ("-" if s.min_epoch is None
                else f"e{s.min_epoch}..e{s.max_epoch}")
        status = "ok"
        if s.torn:
            status = f"TORN at +{s.good_bytes} ({s.error})"
            rc = 1
        p(f"  {os.path.basename(s.path)}  {_human(s.size):>8}  "
          f"{s.n_records:>4} recs  {span:>12}  {status}")
    p(f"rounds journaled: {len(rounds)}")

    # -- checkpoint ladder (no CheckpointManager before the isdir
    # check: its constructor mkdirs, and this tool is READ-ONLY) ------
    ckpt_dir = os.path.join(durable_dir, "ckpt")
    mgr = CheckpointManager(ckpt_dir) if os.path.isdir(ckpt_dir) else None
    rungs = mgr.list() if mgr is not None else []
    p(f"checkpoint ladder: {len(rungs)} rung(s)")
    newest_valid = None
    for info in rungs:
        try:
            mgr.load(info)
            status = "crc ok"
            if newest_valid is None:
                newest_valid = info
        except DecodeError as e:
            status = f"CORRUPT ({e})"
            rc = 1
        p(f"  {info.name}  {_human(info.size):>8}  epoch {info.epoch}  {status}")
    if _stats is not None:
        _stats["newest_ckpt_epoch"] = (
            newest_valid.epoch if newest_valid is not None else None
        )

    # -- tiered residency (parallel/residency.py, docs/RESIDENCY.md) ---
    res_path = os.path.join(durable_dir, "residency.json")
    if os.path.isfile(res_path):
        try:
            with open(res_path, "r") as f:
                res = json.load(f)
        except (OSError, ValueError) as e:
            p(f"residency: residency.json UNREADABLE ({e})")
            rc = 1
        else:
            hot = res.get("hot", {})
            warm = res.get("warm", [])
            cold = res.get("cold", {})
            p(f"residency: hot_slots={res.get('hot_slots')}  "
              f"hot={len(hot)} warm={len(warm)} cold={len(cold)}")
            if hot:
                pairs = ", ".join(
                    f"doc {d}→slot {s}" for d, s in sorted(
                        hot.items(), key=lambda kv: int(kv[0])
                    )[:8]
                )
                p(f"  hot: {pairs}{', ...' if len(hot) > 8 else ''}")
            rung_names = {r.name for r in rungs}
            for d, rung in sorted(cold.items(), key=lambda kv: int(kv[0])):
                ok = rung in rung_names
                p(f"  cold doc {d}: backed by {rung}"
                  + ("" if ok else "  MISSING RUNG"))
                if not ok:
                    rc = 1

    # -- replication (loro_tpu/replication/, docs/REPLICATION.md) ------
    rep_path = os.path.join(durable_dir, "replication.json")
    if os.path.isfile(rep_path):
        try:
            with open(rep_path, "r") as f:
                rep = json.load(f)
        except (OSError, ValueError) as e:
            p(f"replication: replication.json UNREADABLE ({e})")
            rc = 1
        else:
            p(f"replication: leader_token={rep.get('leader_token')} "
              f"held_by={rep.get('leader_id')!r}")
            newest = _stats.get("newest_round_epoch") if _stats else None
            if newest is None:
                newest = max((r.epoch for r in rounds), default=None)
            floors = []
            import time as _t

            now = _t.time()  # tpulint: disable=LT-TIME(read-only CLI report of wall-clock last-seen stamps; no fake-clock test drives it)
            for fid, f in sorted(rep.get("followers", {}).items()):
                acked = int(f.get("acked_epoch", 0))
                lag = (newest - acked) if newest is not None else 0
                age = now - float(f.get("last_seen", now))
                floors.append(acked)
                p(f"  follower {fid}: acked e{acked}  "
                  f"lag {max(0, lag)} round(s)  "
                  f"last seen {age:.0f}s ago")
            if floors:
                p(f"  pinned prune floor: e{min(floors)} "
                  "(WAL segments above it are retained for followers)")
            else:
                p("  no registered followers (nothing pinned)")

    # -- recovery preview ----------------------------------------------
    if newest_valid is not None:
        tail = sum(
            1 for s in segs
            if s.max_epoch is not None and s.max_epoch > newest_valid.epoch
        )
        replay = sum(1 for r in rounds if r.epoch > newest_valid.epoch)
        p(f"recovery: restore {newest_valid.name} (epoch "
          f"{newest_valid.epoch}) + replay {replay} round(s) "
          f"from {tail} segment(s)")
    elif rounds or meta is not None:
        p(f"recovery: COLD — no valid rung; replay all {len(rounds)} "
          "round(s) from the WAL meta")
    else:
        p("recovery: nothing to recover")
    return rc


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1 or argv[0] in ("-h", "--help"):
        print(__doc__.strip(), file=sys.stderr)
        return 2
    if not os.path.isdir(argv[0]):
        print(f"not a directory: {argv[0]}", file=sys.stderr)
        return 2
    return inspect_dir(argv[0])


if __name__ == "__main__":
    sys.exit(main())
