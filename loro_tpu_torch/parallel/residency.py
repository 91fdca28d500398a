"""Tiered doc residency: an HBM hot set over a host-warm, disk-cold
fleet (docs/RESIDENCY.md).

A plain ResidentServer pins EVERY doc it owns into device batch rows
for its whole life, so capacity is HBM-bound and ingest/rank cost
scales with the resident set, not the *active* set.  Real traces are
heavily skewed (the run-locality the Eg-walker paper exploits,
PAPERS.md), so a small hot set captures almost all traffic — the
delta/main-store split of "Fast Updates on Read-Optimized Databases
Using Multi-Core CPUs" (PAPERS.md) applied to the resident fleet: the
device batch is the in-memory delta the hot traffic folds into, the
mirror-anchor + WAL/checkpoint plane (persist/) is the merged main store,
and the persistence ladder turns from crash insurance into the serving
memory hierarchy.

Three tiers per doc:

- **hot**  — the doc occupies a slot in a ``hot_slots``-wide device
  batch; ingest and reads ride the ordinary device path.
- **warm** — the doc's rows are released; its state lives host-side as
  a live ``LoroDoc`` mirror (built from the deep mirror anchor + the
  journal tail — the exact replay ``seed_mirror_engine`` uses).  Reads
  are answered from the mirror; the next ingest touch revives it.
- **cold** — durable servers only: the mirror AND the in-memory anchor
  blob are dropped; the doc's state is exactly one checkpoint rung in
  the persist ladder plus the WAL rounds after it (the
  ``recover_server`` replay, scoped to one doc).  First touch revives
  it through that bounded replay.

Mechanism (all five resident families):

- **evict** = build the warm mirror (anchor + journal replay — every
  fallible step happens FIRST, so an injected ``evict_flush`` fault
  leaves the doc hot with no torn tier state), then
  ``release_doc(slot)`` on the device batch and recycle the slot.
  Eviction only ever picks JOURNAL-STABLE docs (their last touching
  round is journaled, hence its device work committed), so a release
  can never race a staged or in-flight coalesced group.
- **revive** = re-export the doc's full history from its mirror (deep
  anchors keep history exportable, as live migration needs) and
  land it in a free slot through one ordinary batch append; inside a
  coalesced group the landing rides the SAME deferred scatter, ordered
  before the touching round's rows.  A ``revive_replay`` fault fails
  only the triggering round with a typed ``ResidencyError`` — the doc
  stays warm/cold, the server stays healthy.

``TieredBatch`` presents the full doc-space batch surface
(append/coalesce/compact/reads/export_state) to an UNCHANGED
ResidentServer, so the journal, WAL, acks, degradation, pipeline,
SyncServer and sharded planes all compose without knowing about tiers:
``ResidentServer(family, n, hot_slots=K)`` (or the
``TieredResidentServer`` convenience wrapper) is the only opt-in.
Promotion/demotion policy is clock-LRU over per-doc touch counters
with an injected clock (LT-TIME); all tier state sits behind the named
``residency.plan`` lock (analysis/lockorder.py: above ``fleet.dev``,
below ``pipeline.queue``).
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from ..analysis.lockwitness import named_rlock
from ..device import DeviceLike
from ..errors import LoroError, ResidencyError
from ..obs import heat as heat_acct
from ..obs import metrics as obs
from ..resilience import faultinject
from .server import _FAMILIES, ResidentServer

faultinject.register_site(
    "evict_flush", "TieredBatch eviction: fires after the warm mirror "
    "is built, before any tier state mutates (failure leaves the doc "
    "HOT, typed ResidencyError)")
faultinject.register_site(
    "revive_replay", "TieredBatch revive: fires after the history "
    "export, before the slot landing (fails only the triggering "
    "round/ticket, typed ResidencyError)")

TIER_HOT = "hot"
TIER_WARM = "warm"
TIER_COLD = "cold"

MANIFEST_NAME = "residency.json"
MANIFEST_VERSION = 1

# revive-latency buckets: ms-scale (the default obs buckets are fine,
# but the report percentiles come from the instance list below so the
# bench sidecar reflects THIS server, not the process)
_REVIVE_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0)


def _pct(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[i]


class ResidencyManager:
    """Tier state + promotion/demotion policy for one TieredBatch.

    Owns the per-doc tier map, the slot free-list, the clock-LRU touch
    bookkeeping (``clock`` is injectable — fake-clock tests control
    eviction order without sleeping), and the counters the
    ``residency.*`` obs family and the bench ``tier`` sidecar report.
    Mechanism (device releases, mirror builds, rung loads) lives in the
    owning ``TieredBatch``; every mutation happens under the shared
    ``residency.plan`` lock.
    """

    def __init__(self, family: str, n_docs: int, hot_slots: int,
                 clock=None):
        self.family = family
        self.n_docs = n_docs
        self.hot_slots = hot_slots
        self.clock = clock if clock is not None else time.monotonic
        self._plan_lock = named_rlock("residency.plan")
        self.slot_of: Dict[int, int] = {}
        self.doc_of: Dict[int, int] = {}
        self.free: deque = deque(range(hot_slots))
        # cold tier: doc -> backing checkpoint rung name ("" = restored
        # cold, rung not yet known — treated warm until note_restored_rung)
        self.cold: Dict[int, str] = {}
        # warm tier mirrors: doc -> (LoroDoc, first-seen cid dict)
        self.mirrors: Dict[int, Tuple[object, Dict]] = {}
        self.last_touch_t: List[float] = [0.0] * n_docs
        self.last_touch_seq: List[int] = [0] * n_docs
        self.touch_count: List[int] = [0] * n_docs
        # optional warm budget: after each checkpoint, warm docs beyond
        # it demote to cold LRU-first (durable servers only)
        self.warm_slots: Optional[int] = None
        # report counters (instance-local; the obs registry is global)
        self.hits = 0
        self.misses = 0
        self.promotions = 0
        self.evictions = 0
        self.demotions = 0
        self.cold_revives = 0
        self.revive_s: List[float] = []
        self._set_gauges()

    # -- tier queries ---------------------------------------------------
    def tier_of(self, di: int) -> str:
        with self._plan_lock:
            if di in self.slot_of:
                return TIER_HOT
            if di in self.cold:
                return TIER_COLD
            return TIER_WARM

    def tiers(self) -> Dict[str, List[int]]:
        """Doc indexes per tier (a snapshot, for inspect/manifest)."""
        with self._plan_lock:
            hot = sorted(self.slot_of)
            cold = sorted(self.cold)
            known = set(hot) | set(cold)
            warm = [d for d in range(self.n_docs) if d not in known]
            return {TIER_HOT: hot, TIER_WARM: warm, TIER_COLD: cold}

    def counts(self) -> Dict[str, int]:
        with self._plan_lock:
            hot = len(self.slot_of)
            cold = len(self.cold)
            return {
                TIER_HOT: hot,
                TIER_COLD: cold,
                TIER_WARM: self.n_docs - hot - cold,
            }

    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return (self.hits / n) if n else 1.0

    def _set_gauges(self) -> None:
        g = obs.gauge("residency.docs", "docs per residency tier")
        c = self.counts()
        for tier, n in c.items():
            g.set(n, family=self.family, tier=tier)

    # -- policy ---------------------------------------------------------
    def pick_victim(self, safe_seq: int) -> Optional[int]:
        """LRU victim among hot docs whose last touching round is
        journaled (``last_touch_seq <= safe_seq``): journaled means the
        round's device work is committed, so releasing the slot cannot
        race a staged or in-flight coalesced group.  None when no hot
        doc is evictable."""
        best, best_t = None, None
        for di in self.slot_of:
            if self.last_touch_seq[di] > safe_seq:
                continue
            t = self.last_touch_t[di]
            if best_t is None or t < best_t:
                best, best_t = di, t
        return best

    # -- reporting ------------------------------------------------------
    def report(self) -> dict:
        """Compact outcome dict (the bench ``tier`` sidecar core)."""
        with self._plan_lock:
            rs = sorted(self.revive_s)
            out = {
                "hot_slots": self.hot_slots,
                "docs": self.n_docs,
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": round(self.hit_rate(), 4),
                "promotions": self.promotions,
                "evictions": self.evictions,
                "demotions": self.demotions,
                "cold_revives": self.cold_revives,
                "revive_ms_p50": round(_pct(rs, 0.50) * 1e3, 3),
                "revive_ms_p99": round(_pct(rs, 0.99) * 1e3, 3),
            }
            out.update(self.counts())
            return out


class TieredBatch:
    """Doc-space virtual batch over a ``hot_slots``-wide device batch.

    Presents the resident-batch surface in DOC space (``n_docs`` wide)
    while the real device arrays are ``hot_slots`` wide: appends
    revive/evict through the ResidencyManager and route per-doc entries
    to slots; reads merge device rows (hot) with host mirrors
    (warm/cold); ``compact``/coalesce/``export_state`` translate.  The
    owning ResidentServer journals doc-space rounds against
    ``self.epoch`` (the inner batch clock — revive landings tick it
    too, so visible epochs may skip; every consumer already tolerates
    that via the epoch-offset machinery).

    ``bind(server)`` attaches the owning server — the anchor + journal
    it maintains ARE the warm/cold source of truth; this class never
    duplicates per-round host work on the hot path (within-10%-of-
    untiered is an acceptance gate)."""

    def __init__(self, family: str, n_docs: int, hot_slots: int, device,
                 auto_grow: bool, caps: dict, clock=None):
        if family not in _FAMILIES:
            raise ValueError(
                f"unknown family {family!r} (one of {sorted(_FAMILIES)})"
            )
        hot_slots = int(hot_slots)
        if hot_slots < 1:
            raise ResidencyError(
                f"hot_slots={hot_slots} invalid: need at least one device slot"
            )
        self.family = family
        self.n_docs = n_docs
        self.d = n_docs  # doc-space width (virtual)
        self.hot_slots = hot_slots
        self.inner = _FAMILIES[family][1](hot_slots, device, auto_grow, caps)
        self.mgr = ResidencyManager(family, n_docs, hot_slots, clock=clock)
        self._plan_lock = self.mgr._plan_lock
        self._server: Optional[ResidentServer] = None
        # journal-safety clock: every completed client append gets a
        # sequence number; the server's journaling hook pops them FIFO,
        # so ``_safe_seq`` = newest append whose round is journaled
        # (hence device-committed) — the eviction eligibility floor
        self._append_seq = 0
        self._safe_seq = 0
        self._pending_journal: deque = deque()
        self._plan_cv = threading.Condition(self._plan_lock)
        # first append seq of the OPEN coalesce group (pending rounds at
        # or below it belong to prior groups and will journal without
        # us — the slot acquirer may wait on them; pending rounds above
        # it are OURS and journal only after we finish: waiting on them
        # would deadlock, so the acquirer fails typed instead)
        self._group_start_seq = 0
        self._coalesce_open = False
        # single-entry decoded-rung cache for cold loads (name, anchor)
        self._rung_cache: Optional[Tuple[str, object]] = None
        # cold docs restored from a checkpoint, pending the rung name
        # (persist.recover_server calls note_restored_rung)
        self._restored_cold: Dict[int, str] = {}
        if hasattr(self.inner, "append_payloads"):
            # instance attr on purpose: ResidentServer routes payload
            # rounds by hasattr(batch, "append_payloads") — counter has
            # no native payload path and must keep reading False
            self.append_payloads = self._append_payloads_impl

    def bind(self, server: ResidentServer) -> None:
        self._server = server

    @property
    def device_batch(self):
        """The real device batch (the draining sync and debugging reach
        its tensors and its device lock through this)."""
        return self.inner

    @property
    def epoch(self) -> int:
        return self.inner.epoch

    # -- journal-safety hooks (called by the owning server) -------------
    def note_journaled(self) -> None:
        """One client round reached the in-memory journal (and the WAL
        when durable).  Journaled implies its device work committed —
        appends happen strictly before journaling on every path — so
        the popped append seq becomes the eviction-eligibility floor
        (and a slot acquirer waiting for victims wakes up)."""
        with self._plan_cv:
            if self._pending_journal:
                self._safe_seq = max(
                    self._safe_seq, self._pending_journal.popleft()
                )
            self._plan_cv.notify_all()

    # -- appends (doc space) --------------------------------------------
    def append_changes(self, per_doc_updates: Sequence, cid=None) -> None:
        self._append(per_doc_updates, cid, payloads=False)

    def _append_payloads_impl(self, per_doc_updates: Sequence, cid=None) -> None:
        self._append(per_doc_updates, cid, payloads=True)

    def _inner_append(self, slot_updates, cid, payloads: bool) -> None:
        inner = self.inner
        if payloads and not hasattr(inner, "append_payloads"):
            from ..codec.binary import decode_changes

            slot_updates = [
                decode_changes(bytes(u)) if isinstance(u, (bytes, bytearray))
                else u
                for u in slot_updates
            ]
            payloads = False
        if self.family in ("map", "counter"):
            if payloads:
                inner.append_payloads(slot_updates)
            else:
                inner.append_changes(slot_updates)
        else:
            if payloads:
                inner.append_payloads(slot_updates, cid)
            else:
                inner.append_changes(slot_updates, cid)

    def _append(self, per_doc_updates: Sequence, cid, payloads: bool) -> None:
        per_doc_updates = list(per_doc_updates)
        if len(per_doc_updates) > self.n_docs:
            raise ValueError(
                f"round has {len(per_doc_updates)} entries for "
                f"{self.n_docs} docs"
            )
        mgr = self.mgr
        with self._plan_lock:
            if not self._coalesce_open:
                # serial append: it commits (and journals) before the
                # next one, so nothing older can still be in flight
                self._group_start_seq = self._append_seq
            touched = [
                di for di, u in enumerate(per_doc_updates) if u is not None
            ]
            # pending-protect every touched doc BEFORE any promotion:
            # a promotion later in this round must never evict a doc
            # this round also touches (its rows would be staged, not
            # committed)
            next_seq = self._append_seq + 1
            for di in touched:
                mgr.last_touch_seq[di] = next_seq
            for di in touched:
                self._ensure_hot(di, cid)
            slot_updates: List = [None] * self.hot_slots
            for di in touched:
                slot_updates[mgr.slot_of[di]] = per_doc_updates[di]
            self._inner_append(slot_updates, cid, payloads)
            self._append_seq = next_seq
            self._pending_journal.append(next_seq)
            now = mgr.clock()
            for di in touched:
                mgr.last_touch_t[di] = now
                mgr.touch_count[di] += 1
                heat_acct.tick_doc(di, "touch")

    # -- promotion / revive ---------------------------------------------
    def _ensure_hot(self, di: int, cid) -> None:
        mgr = self.mgr
        if di in mgr.slot_of:
            mgr.hits += 1
            obs.counter(
                "residency.touch_total", "ingest touches by tier outcome"
            ).inc(family=self.family, outcome="hit")
            return
        mgr.misses += 1
        obs.counter(
            "residency.touch_total", "ingest touches by tier outcome"
        ).inc(family=self.family, outcome="miss")
        heat_acct.tick_revive()
        was_cold = di in mgr.cold
        t0 = mgr.clock()
        try:
            doc, _seen = self._mirror(di)
            payload = self._export_history(doc)
            faultinject.check("revive_replay", doc=di)
        except LoroError:
            raise
        except Exception as e:
            raise ResidencyError(
                f"doc {di}: revive failed before landing "
                f"({type(e).__name__}: {e}) — the doc stays "
                f"{mgr.tier_of(di)}, only this round is lost"
            ) from e
        slot = self._acquire_slot(di)
        if payload is not None:
            landing: List = [None] * self.hot_slots
            landing[slot] = payload
            try:
                self._inner_append(landing, cid, payloads=True)
            except BaseException:
                # the landing never committed host-atomically (staged-
                # before-validation contract) — hand the slot back and
                # surface; a real device failure degrades the whole
                # round at the server layer as usual
                mgr.free.appendleft(slot)
                raise
        if was_cold:
            # cold exit: the doc's anchor blob must become authoritative
            # again BEFORE the cold entry drops (the eviction/mirror
            # paths rebuild from anchor + journal)
            self._rehydrate_doc_locked(di)
        mgr.slot_of[di] = slot
        mgr.doc_of[slot] = di
        mgr.mirrors.pop(di, None)
        mgr.cold.pop(di, None)
        self._restored_cold.pop(di, None)
        mgr.promotions += 1
        if was_cold:
            mgr.cold_revives += 1
        dt = mgr.clock() - t0
        mgr.revive_s.append(dt)
        obs.histogram(
            "residency.revive_seconds",
            "warm/cold doc revive wall time (mirror + landing)",
            buckets=_REVIVE_BUCKETS,
        ).observe(dt, family=self.family, tier=TIER_COLD if was_cold else TIER_WARM)
        obs.counter("residency.promotions_total").inc(family=self.family)
        mgr._set_gauges()

    def _acquire_slot(self, for_doc: int) -> int:
        """A free slot, evicting the LRU journal-stable hot doc if
        needed.  When every hot doc is pinned by a PRIOR group still in
        flight, wait for its journal notifications (the condition is
        transient — this is the pipeline's natural backpressure when
        the hot budget is tight); when the pinning rounds are our own
        group's, no wait can help — the group genuinely needs more
        co-resident docs than hot_slots — so fail typed."""
        mgr = self.mgr
        stalls = 0
        while True:
            if mgr.free:
                return mgr.free.popleft()
            victim = mgr.pick_victim(self._safe_seq)
            if victim is not None:
                self._evict(victim)
                return mgr.free.popleft()
            prior_pending = bool(
                self._pending_journal
                and self._pending_journal[0] <= self._group_start_seq
            )
            if not prior_pending:
                raise ResidencyError(
                    f"doc {for_doc}: no free device slot and no "
                    f"evictable hot doc — this group needs more "
                    f"co-resident docs than hot_slots={self.hot_slots} "
                    "can hold; raise hot_slots or split the round"
                )
            # a prior group's commit will journal and wake us; the
            # bounded wait guards against a commit that died without
            # ever notifying (the pipeline fails typed around us)
            if not self._plan_cv.wait(timeout=0.05):
                stalls += 1
                if stalls >= 600:  # ~30s of genuine silence
                    raise ResidencyError(
                        f"doc {for_doc}: stalled waiting for the "
                        "in-flight group's journal notifications — "
                        "commit thread dead? (pipeline failure)"
                    )

    def _evict(self, di: int) -> None:
        """Hot -> warm.  Every fallible step (mirror build, the
        ``evict_flush`` fault site) runs BEFORE any tier mutation, so a
        failure leaves the doc hot with no torn state."""
        mgr = self.mgr
        try:
            self._mirror(di)  # builds + caches the warm mirror
            faultinject.check("evict_flush", doc=di)
        except LoroError:
            raise
        except Exception as e:
            raise ResidencyError(
                f"doc {di}: evict failed before the slot release "
                f"({type(e).__name__}: {e}) — the doc stays hot"
            ) from e
        slot = mgr.slot_of.pop(di)
        del mgr.doc_of[slot]
        self.inner.release_doc(slot)
        mgr.free.append(slot)
        mgr.evictions += 1
        obs.counter("residency.evictions_total").inc(family=self.family)
        mgr._set_gauges()

    # -- warm/cold mirrors ----------------------------------------------
    def _srv(self) -> ResidentServer:
        if self._server is None:
            raise ResidencyError(
                "TieredBatch is not bound to a ResidentServer — the "
                "anchor/journal plane is the warm-tier source of truth"
            )
        return self._server

    def _mirror(self, di: int):
        """The doc's live host mirror: cached warm mirror, else built
        from its base (anchor blob, or the backing checkpoint rung for
        cold docs) plus the journal/WAL rounds after the base epoch —
        ``recover_server``'s bounded replay scoped to one doc."""
        mgr = self.mgr
        ent = mgr.mirrors.get(di)
        if ent is not None:
            return ent
        srv = self._srv()
        if di in mgr.cold and mgr.cold[di]:
            blob, seen_cids, base_epoch = self._cold_base(di)
            tail = self._wal_tail(di, base_epoch)
        else:
            anchor = srv._anchor
            blob = anchor.doc_blobs[di]
            seen_cids = list(anchor.seen_cids[di])
            base_epoch = anchor.epoch
            tail = [
                (e, ups[di] if di < len(ups) else None)
                for e, ups, _c in srv._history
                if e > base_epoch
            ]
        ent = self._replay_doc(di, blob, seen_cids, tail)
        mgr.mirrors[di] = ent
        return ent

    @staticmethod
    def _replay_doc(di: int, blob: bytes, seen_cids, tail):
        """THE one doc-mirror replay: seed a LoroDoc from its base blob
        and fold the tail rounds, tracking first-seen container ids.
        Shared by the warm-mirror build and cold-blob rehydration so
        the two can never drift.  Returns ``(doc, seen)``."""
        from ..codec.binary import decode_changes
        from ..doc import LoroDoc

        doc = LoroDoc(peer=(1 << 40) + di)
        if blob:
            doc.import_(blob, origin="residency-anchor")
        seen: Dict = {c: None for c in seen_cids}
        for _e, u in tail:
            if u is None:
                continue
            chs = (
                decode_changes(bytes(u))
                if isinstance(u, (bytes, bytearray)) else list(u)
            )
            for ch in chs:
                for op in ch.ops:
                    seen.setdefault(op.container)
            doc._import_changes(chs, origin="residency")
        return doc, seen

    def _export_history(self, doc) -> Optional[bytes]:
        """Full-history payload for the revive landing (None = empty
        doc, nothing to land — the slot alone suffices)."""
        from ..doc import strip_envelope

        if not len(doc.oplog_vv()):
            return None
        return strip_envelope(doc.export_updates())

    def _wal_tail(self, di: int, after_epoch: int):
        """The doc's WAL rounds after ``after_epoch`` (cold revive /
        rehydration: rounds between the backing rung and now)."""
        srv = self._srv()
        if srv._durable is None:
            raise ResidencyError(
                f"doc {di}: cold with no durable log attached — "
                "cold state needs the WAL to replay from"
            )
        return [
            (e, ups[di] if di < len(ups) else None)
            for e, _c, ups in srv._durable.wal.rounds_after(
                after_epoch, doc=di
            )
        ]

    def _cold_base(self, di: int):
        """(blob, seen_cids, epoch) of the doc at its backing rung."""
        anchor = self._load_rung_anchor(self.mgr.cold[di])
        if anchor.n_docs <= di:
            raise ResidencyError(
                f"doc {di}: backing rung anchor is {anchor.n_docs} docs wide"
            )
        return anchor.doc_blobs[di], list(anchor.seen_cids[di]), anchor.epoch

    def _load_rung_anchor(self, name: str):
        """Decode the mirror anchor out of a checkpoint rung (cached —
        one decode serves every cold doc backed by the same rung)."""
        if self._rung_cache is not None and self._rung_cache[0] == name:
            return self._rung_cache[1]
        from ..persist import MirrorAnchor
        from ..storage import MemKvStore

        srv = self._srv()
        if srv._durable is None:
            raise ResidencyError(
                f"cold backing rung {name!r} unreachable: no durable log"
            )
        mgr = srv._durable.checkpoints
        info = next((c for c in mgr.list() if c.name == name), None)
        if info is None:
            raise ResidencyError(
                f"cold backing rung {name!r} is gone from the ladder — "
                "the retention policy must never prune the newest rung"
            )
        blob = mgr.load(info)  # typed DecodeError on damage
        kv = MemKvStore()
        kv.import_all(blob)
        anchor_b = kv.get(b"anchor")
        if anchor_b is None:
            raise ResidencyError(
                f"cold backing rung {name!r} holds no mirror anchor"
            )
        anchor = MirrorAnchor.decode(anchor_b)
        self._rung_cache = (name, anchor)
        return anchor

    # -- anchor rehydration / demotion (checkpoint integration) ---------
    def rehydrate_anchor(self) -> None:
        """Put every cold doc's blob back into the server's in-memory
        anchor (transiently RAM-resident): checkpoint() folds and
        re-encodes the anchor, and the degradation / sync-oracle
        seeding paths need every doc readable.  Rounds between the
        backing rung and the anchor epoch (possible after a ladder
        fallback) are replayed and re-exported deep."""
        with self._plan_lock:
            for di in list(self.mgr.cold):
                self._rehydrate_doc_locked(di)

    def _rehydrate_doc_locked(self, di: int) -> None:
        """Restore one cold doc's anchor blob (state exactly at the
        anchor epoch) from its backing rung + the WAL rounds up to the
        anchor epoch.  The invariant every other path relies on: a
        NON-cold doc's anchor blob is authoritative — so every
        cold-tier EXIT (read, touch, rehydration) must run this before
        the cold entry is dropped."""
        anchor = self._srv()._anchor
        if anchor.doc_blobs[di]:
            return  # already present
        blob, seen_cids, base_epoch = self._cold_base(di)
        tail = [
            (e, u) for e, u in self._wal_tail(di, base_epoch)
            if e <= anchor.epoch and u is not None
        ]
        if tail:
            from ..doc import ExportMode

            doc, seen = self._replay_doc(di, blob, seen_cids, tail)
            blob = doc.export(ExportMode.Snapshot)
            seen_cids = list(seen)
        anchor.doc_blobs[di] = blob
        anchor.seen_cids[di] = list(seen_cids)

    def after_checkpoint(self, rung_name: Optional[str]) -> None:
        """Checkpoint landed: re-back every cold doc onto the fresh
        rung (it carries every doc's rehydrated blob) and drop their
        anchor blobs again; then run the warm-budget demotion policy
        and refresh the residency manifest.  ``rung_name`` is None for
        non-durable checkpoints — no cold tier to maintain."""
        with self._plan_lock:
            mgr = self.mgr
            srv = self._server
            if rung_name:
                anchor = self._srv()._anchor
                for di in list(mgr.cold):
                    mgr.cold[di] = rung_name
                    anchor.doc_blobs[di] = b""
                self._rung_cache = None
                budget = mgr.warm_slots
                if budget is not None:
                    tiers = mgr.tiers()
                    warm = sorted(
                        tiers[TIER_WARM], key=lambda d: mgr.last_touch_t[d]
                    )
                    for di in warm[: max(0, len(warm) - budget)]:
                        self._demote_locked(di, rung_name)
            if srv is not None and srv._durable is not None:
                self._write_manifest()

    def demote(self, di: int) -> None:
        """Warm -> cold (durable servers with at least one checkpoint
        rung): drop the live mirror AND the in-memory anchor blob; the
        doc's state becomes its backing rung + the WAL tail."""
        with self._plan_lock:
            if di in self.mgr.slot_of:
                raise ResidencyError(
                    f"doc {di} is hot — it must be evicted before it "
                    "can demote to cold"
                )
            if di in self.mgr.cold and self.mgr.cold[di]:
                return
            srv = self._srv()
            if srv._durable is None:
                raise ResidencyError(
                    "cold tier needs a durable server (durable_dir=): "
                    "cold state lives on the checkpoint ladder + WAL"
                )
            newest = srv._durable.checkpoints.load_newest()
            if newest is None:
                raise ResidencyError(
                    f"doc {di}: no valid checkpoint rung to back cold "
                    "state — checkpoint() first"
                )
            self._demote_locked(di, newest[0].name)
            self._write_manifest()

    def _demote_locked(self, di: int, rung_name: str) -> None:
        mgr = self.mgr
        mgr.cold[di] = rung_name
        mgr.mirrors.pop(di, None)
        self._restored_cold.pop(di, None)
        srv = self._server
        if srv is not None and srv._anchor is not None:
            srv._anchor.doc_blobs[di] = b""
        mgr.demotions += 1
        obs.counter("residency.demotions_total").inc(family=self.family)
        mgr._set_gauges()

    def flatten_cold(self) -> int:
        """Lift every cold doc back to the warm tier, rehydrating its
        anchor blob from the backing rung + WAL tail first.  The
        follower bootstrap runs this while the recovered server still
        holds its durable log: a following replica detaches
        ``_durable`` (the ship path owns the WAL files), which makes
        every cold-tier exit — reads, oracle seeding, the shipped-
        checkpoint rehydrate — unreachable.  Nothing re-demotes while
        following (``checkpoint()`` without a durable log skips the
        demotion policy), so the flatten holds until promotion
        re-attaches the log.  Returns the number of docs lifted."""
        with self._plan_lock:
            cold = sorted(self.mgr.cold)
            for di in cold:
                self._rehydrate_doc_locked(di)
                del self.mgr.cold[di]
            if cold:
                self._rung_cache = None
                self.mgr._set_gauges()
                obs.counter(
                    "residency.cold_flattens_total",
                    "cold docs lifted warm with their rung state folded "
                    "into the anchor (follower bootstrap)",
                ).inc(len(cold), family=self.family)
            return len(cold)

    def note_restored_rung(self, rung_name: str) -> None:
        """Recovery restored this batch from ``rung_name``: re-demote
        the docs that were cold at checkpoint time (their blobs are in
        the restored anchor; the rung now backs them), unless the WAL
        replay already revived them."""
        with self._plan_lock:
            for di in list(self._restored_cold):
                if di not in self.mgr.slot_of:
                    self._demote_locked(di, rung_name)
            self._restored_cold = {}
            srv = self._server
            if srv is not None and srv._durable is not None:
                self._write_manifest()

    def _write_manifest(self) -> None:
        """Atomic ``residency.json`` next to the WAL/ladder: the
        operator's (and persist.inspect's) view of per-tier occupancy
        and which rung backs each cold doc.  Advisory — recovery
        rebuilds tier state from the checkpoint blob itself."""
        srv = self._server
        if srv is None or srv._durable is None:
            return
        tiers = self.mgr.tiers()
        path = os.path.join(srv._durable.dir, MANIFEST_NAME)
        data = {
            "version": MANIFEST_VERSION,
            "family": self.family,
            "n_docs": self.n_docs,
            "hot_slots": self.hot_slots,
            "hot": {str(d): self.mgr.slot_of[d] for d in tiers[TIER_HOT]},
            "warm": tiers[TIER_WARM],
            "cold": {str(d): self.mgr.cold[d] for d in tiers[TIER_COLD]},
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    # -- coalesced ingest (straight passthrough: landings ride the
    # inner deferral; releases only ever touch journal-stable slots) ---
    def begin_coalesce(self) -> None:
        with self._plan_lock:
            self._group_start_seq = self._append_seq
            self._coalesce_open = True
        self.inner.begin_coalesce()

    def detach_coalesce(self):
        with self._plan_lock:
            self._coalesce_open = False
        return self.inner.detach_coalesce()

    def commit_detached(self, d) -> None:
        self.inner.commit_detached(d)

    def flush_coalesce(self) -> None:
        # through detach on purpose: the group-boundary flag must reset
        # on the abort path too (ingest_stage flushes then re-raises)
        self.commit_detached(self.detach_coalesce())

    # -- compaction -----------------------------------------------------
    def compact(self, stable_epochs: Sequence[Optional[int]]) -> int:
        """Doc-space floors -> slot-space floors for the hot set (warm
        and cold docs hold no device rows)."""
        floors: List[Optional[int]] = [None] * self.hot_slots
        with self._plan_lock:
            for di, e in enumerate(stable_epochs):
                if e is None:
                    continue
                slot = self.mgr.slot_of.get(di)
                if slot is not None:
                    floors[slot] = e
        if all(f is None for f in floors):
            return 0
        return self.inner.compact(floors)

    # -- read plane (docs/SYNC.md) --------------------------------------
    def export_select(self, index, requests, sup=None):
        """Batched read-plane selection over the TIERED fleet: the
        change-span index is tier-blind (fed from the sync commit
        path, never from device rows), so a batched pull serves warm
        and cold docs without touching tier state — NO revive, no slot
        landing, no mirror build.  The launch still routes through the
        inner hot-set batch's device lock/supervisor (the one device
        queue)."""
        from .fleet import _batch_export_select

        return _batch_export_select(
            self.inner, self.family, index, requests, sup
        )

    # -- reads (hot from device, warm/cold from mirrors) ----------------
    _EMPTY_READS = {
        "texts": "", "richtexts": [], "values": [], "value_lists": [],
        "value_maps": {}, "root_value_maps": {}, "parent_maps": {},
        "children_maps": {},
    }

    def _read_merge(self, name: str, *args):
        with self._plan_lock:
            inner_out = getattr(self.inner, name)(*args)
            out = []
            for di in range(self.n_docs):
                slot = self.mgr.slot_of.get(di)
                if slot is not None:
                    out.append(inner_out[slot])
                else:
                    out.append(self._mirror_read(di, name, *args))
            return out

    def _mirror_read(self, di: int, name: str, *args):
        from ..resilience.hostpath import HostEngine

        doc, seen = self._mirror(di)
        if di in self.mgr.cold:
            # reading a cold doc materialized its mirror: it is warm
            # now — restore its anchor blob first (cold-exit invariant)
            self._rehydrate_doc_locked(di)
            self.mgr.cold.pop(di, None)
            self.mgr._set_gauges()
        if not len(doc.oplog_vv()):
            empty = self._EMPTY_READS[name]
            return empty.copy() if hasattr(empty, "copy") else empty
        eng = HostEngine(self.family, 1)
        eng.docs[0] = doc
        eng._seen_cids[0] = seen
        eng._cid = self._server._cid if self._server is not None else None
        return getattr(eng, name)(*args)[0]

    def texts(self, use_solver: bool = False) -> List[str]:
        return self._read_merge("texts", use_solver)

    def richtexts(self) -> List[list]:
        return self._read_merge("richtexts")

    def values(self, use_solver: bool = False) -> List[list]:
        return self._read_merge("values", use_solver)

    def value_lists(self) -> List[list]:
        return self._read_merge("value_lists")

    def value_maps(self):
        return self._read_merge("value_maps")

    def root_value_maps(self, name: str):
        return self._read_merge("root_value_maps", name)

    def parent_maps(self) -> List[dict]:
        return self._read_merge("parent_maps")

    def children_maps(self) -> List[dict]:
        return self._read_merge("children_maps")

    # -- checkpoint/resume ----------------------------------------------
    STATE_VERSION = 1

    def export_state(self) -> bytes:
        """Inner batch state + the tier map as one LTKV store.  Warm
        mirrors are NOT serialized — they are derivable from the
        server's anchor + journal, which the server checkpoint already
        carries."""
        from ..codec.binary import Writer
        from ..storage import MemKvStore

        kv = MemKvStore()
        with self._plan_lock:
            w = Writer()
            w.u8(self.STATE_VERSION)
            w.str_(self.family)
            w.varint(self.n_docs)
            w.varint(self.hot_slots)
            w.varint(len(self.mgr.slot_of))
            for di in sorted(self.mgr.slot_of):
                w.varint(di)
                w.varint(self.mgr.slot_of[di])
            cold = {
                di: name for di, name in self.mgr.cold.items() if name
            }
            w.varint(len(cold))
            for di in sorted(cold):
                w.varint(di)
                w.str_(cold[di])
            kv.set(b"tiered", bytes(w.buf))
            kv.set(b"inner", self.inner.export_state())
        return kv.export_all()

    @classmethod
    def import_state(cls, data: bytes, device: DeviceLike = "cuda") -> "TieredBatch":
        from ..codec.binary import Reader
        from ..errors import DecodeError
        from ..storage import MemKvStore

        kv = MemKvStore()
        kv.import_all(data)
        meta_b, inner_b = kv.get(b"tiered"), kv.get(b"inner")
        if meta_b is None or inner_b is None:
            raise DecodeError("TieredBatch state: missing sections")
        try:
            r = Reader(meta_b)
            version = r.u8()
            if version > cls.STATE_VERSION:
                raise DecodeError(f"TieredBatch state v{version} too new")
            family = r.str_()
            n_docs = r.varint()
            hot_slots = r.varint()
            slot_of = {r.varint(): r.varint() for _ in range(r.varint())}
            restored_cold = {r.varint(): r.str_() for _ in range(r.varint())}
        except (IndexError, ValueError, UnicodeDecodeError) as e:
            raise DecodeError(f"TieredBatch state: malformed ({e})") from None
        if family not in _FAMILIES:
            raise DecodeError(f"TieredBatch state: unknown family {family!r}")
        if any(s >= hot_slots for s in slot_of.values()) or any(
            d >= n_docs for d in slot_of
        ):
            raise DecodeError("TieredBatch state: slot map out of range")
        if len(set(slot_of.values())) != len(slot_of):
            raise DecodeError("TieredBatch state: duplicate slot assignment")
        if any(d >= n_docs for d in restored_cold):
            raise DecodeError("TieredBatch state: cold map out of range")
        obj = cls.__new__(cls)
        obj.family = family
        obj.n_docs = n_docs
        obj.d = n_docs
        obj.hot_slots = hot_slots
        obj.inner = _FAMILIES[family][0].import_state(inner_b, device=device)
        obj.mgr = ResidencyManager(family, n_docs, hot_slots)
        obj._plan_lock = obj.mgr._plan_lock
        obj._server = None
        obj._append_seq = 0
        obj._safe_seq = 0
        obj._pending_journal = deque()
        obj._plan_cv = threading.Condition(obj._plan_lock)
        obj._group_start_seq = 0
        obj._coalesce_open = False
        obj._rung_cache = None
        # restored cold docs keep their blobs (the restoring checkpoint
        # carries every doc) until recovery names the rung that backs
        # them (note_restored_rung) — a bare restore() leaves them warm
        obj._restored_cold = {
            di: name for di, name in restored_cold.items()
            if di not in slot_of
        }
        obj.mgr.slot_of = dict(slot_of)
        obj.mgr.doc_of = {s: d for d, s in slot_of.items()}
        obj.mgr.free = deque(
            s for s in range(hot_slots) if s not in obj.mgr.doc_of
        )
        obj.mgr._set_gauges()
        if hasattr(obj.inner, "append_payloads"):
            obj.append_payloads = obj._append_payloads_impl
        return obj

    # -- reporting -------------------------------------------------------
    def report(self) -> dict:
        return self.mgr.report()


class TieredResidentServer(ResidentServer):
    """Convenience wrapper: ``TieredResidentServer(family, n_docs,
    hot_slots=K, ...)`` is exactly ``ResidentServer(family, n_docs,
    hot_slots=K, ...)`` — a doc-space server whose device batch holds
    only the K-doc hot set, with warm/cold tiers behind it
    (docs/RESIDENCY.md)."""

    def __init__(self, family: str, n_docs: int, hot_slots: int,
                 device: DeviceLike = "cuda", **kw):
        super().__init__(family, n_docs, device=device, hot_slots=hot_slots, **kw)
