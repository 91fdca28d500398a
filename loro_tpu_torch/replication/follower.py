"""Hot-standby followers: a rolling ``recover_server`` over shipped WAL
(the port of loro_tpu/replication/follower.py).

A follower owns a full durable-directory REPLICA of its leader —
checkpoint rungs plus visibility-gated WAL segment bytes, streamed by
``shipper.WalShipper`` — and keeps a live ResidentServer continuously
applying the shipped rounds (the exact ``_replay_journal_tail``
machinery crash recovery uses, run incrementally instead of once).
The follower therefore has everything recovery would need at every
instant: device batch state, the in-memory journal tail, mirror
anchors folded at every shipped checkpoint marker, and a WAL copy
whose torn tails truncate exactly like a reopen.

Lifecycle:

- ``Follower(source_dir, follower_dir, leader=...)`` bootstraps:
  ship rungs + visible segments, ``persist.recover_server`` the copy,
  then DETACH the copy's append handle — while following, the ship
  path owns the files and the resident refuses ``ingest()`` typed
  (a follower is read-only; pushes get ``NotLeader`` at the sync
  front).
- ``catch_up()`` ships new bytes, applies complete frames past the
  acked offsets (round records through the replay path; checkpoint
  markers fold the anchor and trim the journal via
  ``resident.checkpoint()``; prune markers above the applied epoch
  raise typed ``StaleFollower``), feeds the read-only sync front, and
  acks the applied epoch into the leader's ``replication.json`` (the
  WAL retention pin).
- ``promote()`` fences the old leader (token bump — checked at its
  every WAL append), drains the remaining tail with dead-leader
  visibility, reopens the WAL copy for append and flips the follower
  writable.  Loses nothing at or below the leader's acked watermark.

``ShardedFollower`` runs one Follower per ``shard-NN/`` stream and
tracks ``sharding.json`` (snapshot BEFORE each ship pass, so placement
never gets ahead of applied rounds — a mid-stream migration becomes
visible exactly when its round has applied).

Fault sites: ``repl_ship`` (shipper reads), ``repl_apply`` (before
each applied round), ``repl_promote`` (promotion entry).

Device rule of the port: a follower's resident runs on one device
(``device=``, default the card, ``DeviceUnavailable`` without one; tests
pass ``"cpu"``) where the JAX package's takes ``mesh=``, and a
``ShardedFollower`` takes a device list (``devices=``) carved one slice
a shard.  A real device failure is never hidden: a failed round's
``DeviceFailure`` reaches the caller of ``catch_up()`` / ``promote()``
typed with ``applied_epoch`` where it was, and a checkpoint boundary
is skipped only on a degraded follower (an armed fault), where the JAX
package skips it on any ``ResilienceError``.
"""
from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from ..analysis.lockwitness import named_rlock
from ..device import DeviceLike, resolve_device
from ..obs import flight
from ..errors import (
    FencedLeader,
    ReplicationError,
    ResilienceError,
    StaleFollower,
)
from ..obs import metrics as obs
from ..persist.wal import (
    R_CKPT,
    R_META,
    R_PRUNE,
    R_ROUND,
    _scan_segment,
    _seg_index,
    _seg_name,
)
from ..resilience import faultinject

faultinject.register_site(
    "repl_apply", "Follower apply loop: fires before each shipped "
    "round applies to the follower batch")
faultinject.register_site(
    "repl_promote", "Follower.promote entry: fires before the fencing "
    "token bump (a retried promote starts clean)")
from .manifest import DEFAULT_STALE_AFTER_S, ReplicationManifest
from .shipper import WalShipper


def _install_fence(srv, man: ReplicationManifest, token: int) -> None:
    """Arm the WAL append fence: any append after a newer token exists
    fail-stops typed ``FencedLeader`` before a byte lands."""

    def fence():
        cur, holder = man.leader()
        if cur > token:
            obs.counter(
                "repl.fenced_appends_total",
                "WAL appends refused on a fenced (deposed) leader",
            ).inc()
            raise FencedLeader(
                f"leader token {token} superseded by {cur} (held by "
                f"{holder!r}) — this leader is fenced and must fail-stop"
            )

    srv._durable.wal.fence = fence


def enable(leader, leader_id: str = "leader",
           stale_after: float = DEFAULT_STALE_AFTER_S, clock=None):
    """Make a durable leader replicable: claim the leader token in its
    ``replication.json``, install the append fence, publish the fsync
    visibility marker (cross-process followers), and pin WAL segment
    pruning at the registered followers' acked epochs.  A sharded
    leader enables every shard (per-shard manifests); returns the
    manifest (or the per-shard list)."""
    shards = getattr(leader, "shards", None)
    if shards is not None:
        return [enable(s, leader_id=leader_id, stale_after=stale_after,
                       clock=clock) for s in shards]
    log = leader._durable
    if log is None:
        raise ReplicationError(
            "replication needs a durable leader (durable_dir=) — the "
            "WAL is the shipped stream"
        )
    man = ReplicationManifest(log.dir, clock=clock, stale_after=stale_after)
    token = man.claim_leader(leader_id)
    _install_fence(leader, man, token)
    log.wal.retention_floor = man.pinned_floor
    log.wal.publish_visibility = True
    log.wal._publish_visibility()
    return man


class Follower:
    """One leader-directory → follower-directory replication stream
    with a live, read-only ResidentServer applying it.

    ``leader=`` the live leader ResidentServer when in-process (exact
    durable-watermark visibility); omit for a leader in another
    process (the ``.visible`` marker gates the tail).  ``sync_server=``
    attaches a ``ReadOnlySyncServer`` (pull/poll/presence; push raises
    ``NotLeader``) fed from the applied rounds, created as soon as the
    served container id is known.  ``device=`` is the follower
    resident's device (default the card)."""

    def __init__(self, source_dir: str, follower_dir: str,
                 follower_id: str = "follower", leader=None,
                 device: DeviceLike = "cuda",
                 sync_server: bool = True, clock=None,
                 stale_after: float = DEFAULT_STALE_AFTER_S, **sync_kw):
        # resolved before a file is shipped: DeviceUnavailable without
        # a card, and nothing is written for a follower that cannot run
        device = resolve_device(device)
        self._lock = named_rlock("repl.follower")
        self.source_dir = source_dir
        self.follower_dir = follower_dir
        self.follower_id = follower_id
        self._device = device
        self._clock = time.time if clock is None else clock
        self.shipper = WalShipper(source_dir, leader=leader)
        self._src_manifest = ReplicationManifest(
            source_dir, clock=clock, stale_after=stale_after
        )
        self._stale_after = stale_after
        self.wal_dir = os.path.join(follower_dir, "wal")
        self.ckpt_dir = os.path.join(follower_dir, "ckpt")
        os.makedirs(self.wal_dir, exist_ok=True)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self._want_sync = sync_server
        self._sync_kw = dict(sync_kw)
        self.sync = None
        self.promoted = False
        self.rounds_applied = 0
        self.torn_tails = 0
        self.ckpts_applied = 0
        self.catch_ups = 0
        self.leader_epoch_seen = 0
        # replication-lag attribution: shipped round records carry the
        # leader's wall-clock stamp + trace id; each apply measures
        # leader-commit -> follower-apply lag and keeps a bounded sample
        # window (``lag_samples()``)
        self._lag_samples: deque = deque(maxlen=256)
        # segment indexes whose full SEALED extent we hold (sealed at
        # source = rotation fsync'd it closed, and we shipped to its
        # size).  The continuity check below needs it: a source segment
        # that vanishes (pruned after the staleness cutoff dropped our
        # retention pin) while our copy was still partial is LOST
        # history — resuming over the hole must fail typed, never
        # fabricate a truncated replay.
        self._complete_segs: set = set()
        # bootstrap: ship, recover the copy, detach its append handle
        self._ship_files()
        from ..persist import recover_server

        self.resident = recover_server(follower_dir, device=device, fsync=False)
        # a tiered leader's tier map rides its rungs, so the recovered
        # copy can hold cold docs — whose every exit (read, oracle
        # seeding, the shipped-checkpoint rehydrate) needs the durable
        # log this follower is about to detach.  Flatten them warm
        # while the log is still attached; nothing re-demotes until
        # promotion re-attaches it.
        batch = getattr(self.resident, "batch", None)
        if hasattr(batch, "flatten_cold"):
            batch.flatten_cold()
        log = self.resident._durable
        self.resident._durable = None
        # while following, the ship path owns the WAL files and writes
        # land ONLY via promotion — ingest on the follower raises typed
        self.resident._durable_closed = True
        log.close()
        self._applied_off: Dict[int, int] = self._local_offsets()
        self.applied_epoch = self.resident.epoch
        self.leader_epoch_seen = self.applied_epoch
        self._ensure_sync()
        self._ack()

    # -- shipping ------------------------------------------------------
    def _local_offsets(self) -> Dict[int, int]:
        out: Dict[int, int] = {}
        for name in os.listdir(self.wal_dir):
            if name.startswith("seg-") and name.endswith(".log"):
                out[_seg_index(name)] = os.path.getsize(
                    os.path.join(self.wal_dir, name)
                )
        return out

    def _ship_files(self) -> int:
        """Stream new rung files and visible segment bytes into the
        follower directory; mirror leader-side segment pruning for
        fully-applied local segments.  Returns bytes shipped."""
        shipped = 0
        for name, path in self.shipper.ckpt_files():
            dst = os.path.join(self.ckpt_dir, name)
            if os.path.exists(dst):
                continue
            try:
                data = self.shipper.read(path, 0, os.path.getsize(path))
            except OSError:
                continue  # rung pruned mid-listing: the next pass settles
            tmp = dst + ".tmp"
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, dst)
            shipped += len(data)
        extent = self.shipper.extent()
        max_idx = max((i for i, _p, _v in extent), default=None)
        for idx, spath, vis in extent:
            dst = os.path.join(self.wal_dir, _seg_name(idx))
            have = os.path.getsize(dst) if os.path.exists(dst) else 0
            if vis > have:
                try:
                    data = self.shipper.read(spath, have, vis - have)
                except OSError:
                    continue  # segment pruned mid-pass: next pass (or
                    #           the continuity scan) settles it
                with open(dst, "ab") as f:
                    f.write(data)
                shipped += len(data)
                # advance by what the read actually RETURNED — a short
                # read (source torn/truncated, a mangle fault) must not
                # mark a partial copy complete below
                have += len(data)
            if have >= vis and (idx != max_idx or self.shipper.final):
                # sealed at source (or dead-leader drain: whole files
                # are the truth): our copy is complete
                self._complete_segs.add(idx)
        self._check_continuity(extent)
        # local copies of segments the leader pruned: drop the ones the
        # apply loop has fully consumed (bounded follower disk)
        src_idx = {i for i, _p, _v in extent}
        applied_off = getattr(self, "_applied_off", None)
        if src_idx:
            newest = max(src_idx)
            for name in list(os.listdir(self.wal_dir)):
                if not (name.startswith("seg-") and name.endswith(".log")):
                    continue
                idx = _seg_index(name)
                path = os.path.join(self.wal_dir, name)
                if idx in src_idx or idx >= newest:
                    continue
                if applied_off is None:
                    # bootstrap: applied offsets are not built yet
                    # (recovery is rung-based) and the unguarded pop
                    # below would AttributeError __init__ into a
                    # permanent crash loop.  Settle only the 0-byte
                    # artifact of a crashed pass (segment file created
                    # but never written — nothing to lose, and the
                    # recover_server magic check would refuse it);
                    # segments with content wait for real offsets
                    if os.path.getsize(path) == 0:
                        os.unlink(path)
                    continue
                if applied_off.get(idx, 0) >= os.path.getsize(path):
                    os.unlink(path)
                    applied_off.pop(idx, None)
        for name, path in self.shipper.extra_files():
            try:
                data = self.shipper.read(path, 0, os.path.getsize(path))
            except OSError:
                continue
            tmp = os.path.join(self.follower_dir, name + ".tmp")
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, os.path.join(self.follower_dir, name))
        return shipped

    def _check_continuity(self, extent) -> None:
        """The ship-scan staleness gate: every segment index between
        our oldest local copy and the source's oldest surviving segment
        must be held complete OR fully applied locally.  A hole means
        the leader pruned history we never finished shipping (our
        retention pin was dropped by the staleness cutoff) — fail typed
        ``StaleFollower`` before a single round past the hole can
        apply; re-bootstrap from a fresh directory instead (the shipped
        checkpoint rung covers the pruned rounds there).

        This scan is the EARLY, legible half of a two-part gate; the
        exact backstop is the ``R_PRUNE`` marker every segment re-emits
        (``_apply_new`` raises typed when the prune floor is above our
        applied epoch).  Hence two accepting cases besides a complete
        copy: bootstrap (``_applied_off`` not built yet — recovery is
        rung-based, and the shipped rung covers everything the source
        ever pruned), and a local copy every byte of which has applied
        (anything pruned past it sits under the source's prune floor,
        which the apply-time gate checks against our applied epoch) —
        a restarted follower or one whose caught-up active segment was
        sealed-and-pruned in one leader checkpoint must not be forced
        into a needless re-bootstrap."""
        if not extent:
            return
        applied = getattr(self, "_applied_off", None)
        if applied is None:
            return  # bootstrap: recover_server + shipped rungs decide
        lo = min(i for i, _p, _v in extent)
        have = self._local_offsets()
        for i in range(min(have, default=lo), lo):
            if i in have and (
                i in self._complete_segs
                or applied.get(i, 0) >= have[i]
            ):
                continue
            obs.counter(
                "repl.stale_resumes_total",
                "followers that resumed past pruned WAL history "
                "(typed StaleFollower at the ship scan)",
            ).inc()
            raise StaleFollower(
                f"{self.follower_id}: WAL segment {i} was pruned at the "
                f"source before this follower finished shipping it "
                f"(oldest surviving source segment is {lo}) — the "
                "retention pin was dropped by the staleness cutoff; "
                "re-bootstrap from a fresh directory"
            )

    def _scan_new(self) -> List[Tuple[int, int, object]]:
        """Complete frames past the applied offsets across local
        segments, in order: ``(seg_index, frame_end_offset, record)``.
        A torn frame truncates the local copy back to the last good
        boundary (the WAL reopen contract) — the next ship pass
        re-streams clean bytes from the source."""
        out: List[Tuple[int, int, object]] = []
        names = sorted(
            n for n in os.listdir(self.wal_dir)
            if n.startswith("seg-") and n.endswith(".log")
        )
        for name in names:
            idx = _seg_index(name)
            path = os.path.join(self.wal_dir, name)
            floor = max(self._applied_off.get(idx, 5), 5)
            if os.path.getsize(path) <= floor:
                continue
            recs: List[Tuple[int, object]] = []
            info = _scan_segment(path, idx,
                                 lambda off, r: recs.append((off, r)))
            if info.torn:
                with open(path, "r+b") as f:
                    f.truncate(info.good_bytes)
                self.torn_tails += 1
                obs.counter(
                    "repl.torn_shipped_tails_total",
                    "torn shipped tails truncated at the follower "
                    "(the WAL reopen contract)",
                ).inc()
            ends = [off for off, _r in recs[1:]] + [info.good_bytes]
            for (off, rec), end in zip(recs, ends):
                if off >= floor:
                    out.append((idx, end, rec))
        return out

    # -- applying ------------------------------------------------------
    def _apply_new(self) -> int:
        """Apply every newly complete shipped record in order; returns
        rounds applied.  Caller holds the follower lock."""
        applied = 0
        srv = self.resident
        for idx, end, rec in self._scan_new():
            if rec.rtype == R_ROUND:
                if rec.epoch > self.applied_epoch:
                    faultinject.check("repl_apply", rtype="round")
                    srv._replay_journal_tail(
                        [(rec.epoch, rec.cid, list(rec.updates))]
                    )
                    self.applied_epoch = srv.epoch
                    applied += 1
                    self.rounds_applied += 1
                    if rec.stamp_us:
                        # measured leader-commit -> follower-apply lag:
                        # the shipped wall stamp against our clock (same
                        # machine or NTP-close hosts; negative skew
                        # clamps to 0 — lag is never negative)
                        lag_s = max(
                            0.0, self._clock() - rec.stamp_us * 1e-6
                        )
                        self._lag_samples.append(
                            (rec.epoch, rec.trace, lag_s * 1e3)
                        )
                        obs.histogram(
                            "repl.apply_lag_seconds",
                            "leader WAL-stamp -> follower apply "
                            "(measured replication lag attribution)",
                        ).observe(lag_s, follower=self.follower_id,
                                  exemplar=rec.trace)
                        flight.record(
                            "repl.apply", epoch=rec.epoch,
                            trace=rec.trace,
                            lag_ms=round(lag_s * 1e3, 3),
                        )
                    if self.sync is not None:
                        self.sync._apply_replicated(
                            self.applied_epoch, rec.cid, rec.updates
                        )
            elif rec.rtype == R_CKPT:
                self._on_ckpt(rec)
            elif rec.rtype == R_PRUNE:
                if rec.epoch > self.applied_epoch:
                    obs.counter(
                        "repl.stale_resumes_total",
                        "followers that resumed past pruned WAL "
                        "history (typed StaleFollower at the ship "
                        "scan)",
                    ).inc()
                    raise StaleFollower(
                        f"{self.follower_id}: leader pruned WAL history "
                        f"below epoch {rec.epoch} but this follower only "
                        f"applied epoch {self.applied_epoch} — the "
                        "retention pin was dropped (staleness cutoff); "
                        "re-bootstrap from a fresh directory"
                    )
            elif rec.rtype == R_META:
                pass
            self._applied_off[idx] = max(
                self._applied_off.get(idx, 5), end
            )
        if applied:
            obs.counter(
                "repl.applied_rounds_total",
                "shipped WAL rounds applied by followers",
            ).inc(applied)
        obs.gauge(
            "repl.applied_epoch", "newest epoch the follower applied"
        ).set(self.applied_epoch, follower=self.follower_id)
        return applied

    def _on_ckpt(self, rec) -> None:
        """Replicate the leader's checkpoint boundary: fold the mirror
        anchor, trim the journal tail, re-seed the bounded-recover base
        — ``resident.checkpoint()`` with no durable log attached does
        exactly that (the rung FILE itself arrives via shipping).  Only
        a degraded follower (an armed fault degraded its resident)
        skips the boundary; any other failure, a real device failure
        among them, reaches the caller typed."""
        srv = self.resident
        try:
            srv.checkpoint()
        except ResilienceError:
            if not srv.degraded:
                raise
            # degraded follower: the anchor fold needs device state;
            # keep applying on the mirror, checkpoint again post-recover
            return
        self.ckpts_applied += 1
        obs.counter(
            "repl.ckpts_applied_total",
            "leader checkpoint boundaries replicated on followers",
        ).inc()

    def _ensure_sync(self) -> None:
        if not self._want_sync or self.sync is not None:
            return
        srv = self.resident
        if srv.family not in ("map", "counter") and srv._cid is None:
            return  # no round shipped yet: the cid is not known
        from .readonly import ReadOnlySyncServer

        self.sync = ReadOnlySyncServer.over(
            srv, leader_id=self._leader_id_hint(), **self._sync_kw
        )

    def _leader_id_hint(self) -> Optional[str]:
        try:
            return self._src_manifest.leader()[1]
        except ReplicationError:
            return None

    def _ack(self) -> None:
        try:
            self._src_manifest.ack_follower(
                self.follower_id, self.applied_epoch
            )
        except OSError:
            pass  # source gone (dead leader): nothing left to pin

    # -- public surface ------------------------------------------------
    def catch_up(self) -> dict:
        """One ship+apply pass; returns the report dict.  Safe to call
        from a polling loop at any cadence."""
        with self._lock:
            if self.promoted:
                return self.report()
            shipped = self._ship_files()
            applied = self._apply_new()
            self._ensure_sync()
            self.catch_ups += 1
            lead = self.shipper.leader
            if lead is not None:
                self.leader_epoch_seen = max(
                    self.leader_epoch_seen, lead.durable_epoch
                )
            self.leader_epoch_seen = max(
                self.leader_epoch_seen, self.applied_epoch
            )
            self._ack()
            obs.gauge(
                "repl.lag_epochs",
                "epochs the follower trails the leader's durable "
                "watermark",
            ).set(self.lag_epochs, follower=self.follower_id)
            return dict(self.report(), shipped_bytes=shipped,
                        rounds=applied)

    @property
    def lag_epochs(self) -> int:
        return max(0, self.leader_epoch_seen - self.applied_epoch)

    def warm_read_plane(self, max_window: Optional[int] = None,
                        max_peers: int = 4) -> int:
        """Pre-compile the read-only sync front's selection shapes
        (``SyncServer.warm_read_plane``); 0 when no front is attached
        yet."""
        with self._lock:
            if self.sync is None:
                return 0
            return self.sync.warm_read_plane(max_window, max_peers)

    def lag_samples(self) -> List[Tuple[int, Optional[str], float]]:
        """Recent ``(epoch, trace_id, lag_ms)`` apply-lag attributions
        (bounded window; empty before the first stamped round applies
        — e.g. a leader that predates round stamping).  Snapshotted
        under the follower lock: catch_up() appends concurrently (the
        lock is reentrant, so catch_up's own report() call is fine)."""
        with self._lock:
            return list(self._lag_samples)

    def report(self) -> dict:
        out = {
            "follower_id": self.follower_id,
            "applied_epoch": self.applied_epoch,
            "leader_epoch_seen": self.leader_epoch_seen,
            "lag_epochs": self.lag_epochs,
            "rounds_applied": self.rounds_applied,
            "ckpts_applied": self.ckpts_applied,
            "torn_tails": self.torn_tails,
            "catch_ups": self.catch_ups,
            "promoted": self.promoted,
        }
        lags = sorted(ms for _e, _t, ms in self.lag_samples())
        if lags:
            out["apply_lag_ms_p50"] = round(lags[len(lags) // 2], 3)
            out["apply_lag_ms_max"] = round(lags[-1], 3)
        return out

    def promote(self, leader_id: Optional[str] = None,
                fsync=True) -> "object":
        """Fail the leader over to this follower: bump the leader token
        (fencing every older holder at its next append), drain the
        shipped tail with dead-leader visibility (torn tail truncated,
        the reopen contract), reopen the WAL copy for append, and flip
        the follower writable.  Returns the now-writable
        ResidentServer.  Idempotent once promoted."""
        with self._lock:
            if self.promoted:
                return self.resident
            faultinject.check("repl_promote")
            leader_id = leader_id or self.follower_id
            token = self._src_manifest.bump_token(leader_id)
            self.shipper.final = True
            self.shipper.leader = None
            self._ship_files()
            self._apply_new()
            from ..persist import DurableLog

            log = DurableLog(self.follower_dir, fsync=fsync)
            srv = self.resident
            srv.attach_durable(log)
            own = ReplicationManifest(
                self.follower_dir, clock=self._clock,
                stale_after=self._stale_after,
            )
            own.claim_leader(leader_id, token=token)
            _install_fence(srv, own, token)
            log.wal.retention_floor = own.pinned_floor
            log.wal.publish_visibility = True
            log.wal._publish_visibility()
            if self.sync is not None:
                self.sync._promote_writable()
            self.promoted = True
            obs.counter(
                "repl.followers_promoted_total",
                "followers flipped writable by promote()",
            ).inc()
            return srv

    def close(self) -> None:
        with self._lock:
            if self.sync is not None:
                self.sync.close()
            self.resident.close()

    def __enter__(self) -> "Follower":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ShardedFollower:
    """Follower fleet for a ``ShardedResidentServer`` durable dir: one
    per-shard WAL stream (``shard-NN/``), placement tracked from
    ``sharding.json`` — snapshotted BEFORE each ship pass so reads
    never route through a placement whose migration round has not
    applied yet.  ``durable_epoch``-style watermarks aggregate min-
    over-shards; lag is max-over-shards.  ``devices=`` is the device
    mesh or list whose rows are carved one slice a shard (default every
    visible card; a list may name one device twice), each shard's
    follower on the lead device of its slice."""

    def __init__(self, source_dir: str, follower_dir: str,
                 follower_id: str = "follower", leader=None,
                 devices=None, clock=None,
                 stale_after: float = DEFAULT_STALE_AFTER_S):
        from ..parallel.mesh import make_mesh, shard_meshes
        from ..parallel.placement import ShardPlacement
        from ..parallel.sharded import load_manifest

        devices = make_mesh(devices)  # DeviceUnavailable without a card
        manifest = load_manifest(source_dir)
        if manifest is None:
            raise ReplicationError(
                f"{source_dir}: no sharding.json — use Follower for "
                "single-server dirs"
            )
        self.source_dir = source_dir
        self.follower_dir = follower_dir
        self.follower_id = follower_id
        os.makedirs(follower_dir, exist_ok=True)
        self.manifest = manifest
        self.n_shards = int(manifest["shards"])
        self.n_docs = int(manifest["n_docs"])
        self.family = manifest["family"]
        self.devices = devices
        self.shard_devices = shard_meshes(self.devices, self.n_shards)
        self.placement = ShardPlacement.from_manifest(manifest)
        leader_shards = getattr(leader, "shards", None)
        self.shards: List[Follower] = []
        for s in range(self.n_shards):
            self.shards.append(Follower(
                os.path.join(source_dir, f"shard-{s:02d}"),
                os.path.join(follower_dir, f"shard-{s:02d}"),
                follower_id=follower_id,
                leader=leader_shards[s] if leader_shards else None,
                device=self.shard_devices[s].lead, sync_server=False, clock=clock,
                stale_after=stale_after,
            ))
        self.promoted = False
        self._write_local_manifest()

    def _write_local_manifest(self) -> None:
        path = os.path.join(self.follower_dir, "sharding.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.manifest, f)
        os.replace(tmp, path)

    def catch_up(self) -> dict:
        from ..parallel.placement import ShardPlacement
        from ..parallel.sharded import load_manifest

        # snapshot FIRST: every placement this manifest names had its
        # migration round made durable before the manifest write, so
        # the ship pass below always applies at least that far
        man = load_manifest(self.source_dir)
        reports = [f.catch_up() for f in self.shards]
        if man is not None:
            self.manifest = man
            self.placement = ShardPlacement.from_manifest(man)
            self._write_local_manifest()
        return {
            "applied_epoch": self.applied_epoch,
            "lag_epochs": self.lag_epochs,
            "shards": reports,
        }

    def _emap(self, s: int):
        from ..parallel.placement import _EpochMap

        emaps = self.manifest.get("emaps") or [[[0, 0]]] * self.n_shards
        return _EpochMap.decode(emaps[s] if s < len(emaps) else [[0, 0]])

    @property
    def applied_epoch(self) -> int:
        """Fleet-global applied watermark: min over shards of the
        shard-local applied epoch translated through the manifest's
        epoch maps."""
        return min(
            self._emap(s).to_global(f.applied_epoch)
            for s, f in enumerate(self.shards)
        )

    @property
    def lag_epochs(self) -> int:
        g = int(self.manifest.get("global_epoch", 0))
        return max(0, g - self.applied_epoch)

    # -- reads (placement-merged, same shape as the sharded server) ----
    def _read(self, name: str, *args):
        outs = [getattr(f.resident, name)(*args) for f in self.shards]
        merged = [None] * self.n_docs
        for g in range(self.n_docs):
            s, l = self.placement.place(g)
            merged[g] = outs[s][l]
        return merged

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

    def report(self) -> dict:
        return {
            "follower_id": self.follower_id,
            "applied_epoch": self.applied_epoch,
            "lag_epochs": self.lag_epochs,
            "promoted": self.promoted,
            "shards": [f.report() for f in self.shards],
        }

    def promote(self, leader_id: Optional[str] = None, fsync=True):
        """Promote every shard, then reassemble the writable fleet
        through the recovered-manifest path
        (``ShardedResidentServer._assemble``).  Returns the writable
        ShardedResidentServer."""
        from ..parallel.sharded import ShardedResidentServer

        leader_id = leader_id or self.follower_id
        for f in self.shards:
            f.promote(leader_id=leader_id, fsync=fsync)
        fleet = ShardedResidentServer._assemble(
            self.manifest, [f.resident for f in self.shards],
            self.devices, self.shard_devices, durable_dir=self.follower_dir,
        )
        fleet._write_manifest()
        self.promoted = True
        return fleet

    def close(self) -> None:
        for f in self.shards:
            f.close()

    def __enter__(self) -> "ShardedFollower":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
