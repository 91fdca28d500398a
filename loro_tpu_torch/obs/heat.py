"""EWMA heat accounting for the serving hot paths (docs/OBSERVABILITY.md
"Health & heat").

The metrics registry answers "how much, ever"; this module answers
"how hot is doc 37 *right now*" — the windowed signal the ROADMAP
elastic-resharding rebalancer feeds on.  One process-global
``HeatAccountant`` holds exponentially-decayed event counts:

- **per doc**: ``push`` (SyncServer commit hook), ``pull``
  (``Session.pull``) and ``touch`` (TieredBatch ingest touches);
- **per shard**: ``ingest`` rounds, ``launch``es and ``degradation``
  commits (ShardedResidentServer);
- **revive pressure**: tier misses that forced a warm/cold revive
  (ResidencyManager ``_ensure_hot``).

Each tick decays the key's running sum by ``2 ** (-dt / half_life)``
and adds the event weight, so a key's *heat* is roughly "events in the
last half-life" and ``heat * ln2 / half_life`` estimates the current
events/second rate.  ``report()`` derives the three rebalancer inputs:
the top-K hot docs, the per-shard **skew ratio** (hottest shard's
ingest heat over the uniform share — 1.0 = perfectly balanced) and the
revive rate.

Hot-path contract: ``tick_*`` is called from serving paths while their
locks are held (``sync.server``, ``residency.plan``,
``sharded.route``), so the accountant's ``obs.health`` lock is a
near-leaf in analysis/lockorder.py and nothing is called while holding
it.  The disabled path (``disable()``) is one attribute check — zero
allocations, the count guard in tests/test_health.py.  Memory is
bounded: at most ``max_docs`` tracked docs (the coldest half is pruned
when the cap is hit).
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Optional

from ..analysis.lockwitness import named_lock

DEFAULT_HALF_LIFE_S = 30.0
DEFAULT_TOP_K = 8
MAX_TRACKED_DOCS = 8192

DOC_KINDS = ("push", "pull", "touch")
SHARD_KINDS = ("ingest", "launch", "degradation")

_LN2 = math.log(2.0)

# per-key row layout: [last_update_t, *per-kind decayed sums]
_T = 0


class HeatAccountant:
    """Decayed per-doc / per-shard event heat with an injected clock."""

    def __init__(self, clock=time.monotonic,
                 half_life_s: float = DEFAULT_HALF_LIFE_S,
                 top_k: int = DEFAULT_TOP_K,
                 max_docs: int = MAX_TRACKED_DOCS):
        if half_life_s <= 0:
            raise ValueError(f"half_life_s must be positive, got {half_life_s}")
        self._clock = clock
        self.half_life_s = float(half_life_s)
        self.top_k = int(top_k)
        self.max_docs = max(1, int(max_docs))
        self._on = True
        self._lock = named_lock("obs.health")
        self._docs: Dict[int, list] = {}    # di -> [t, push, pull, touch]
        self._shards: Dict[int, list] = {}  # s -> [t, ingest, launch, degr]
        self._n_shards = 0
        self._revive = [0.0, 0.0]           # [t, decayed sum]

    # -- switches -------------------------------------------------------
    @property
    def on(self) -> bool:
        return self._on

    def enable(self) -> None:
        self._on = True

    def disable(self) -> None:
        self._on = False

    def reset(self) -> None:
        with self._lock:
            self._docs.clear()
            self._shards.clear()
            self._n_shards = 0
            self._revive = [0.0, 0.0]

    # -- the hot path ---------------------------------------------------
    def _decay_row(self, row: list, now: float) -> None:
        dt = now - row[_T]
        if dt > 0.0:
            f = 2.0 ** (-dt / self.half_life_s)
            for i in range(1, len(row)):
                row[i] *= f
        row[_T] = now

    def tick_doc(self, di: int, kind: str, n: float = 1.0) -> None:
        """One doc-level serving event (``push``/``pull``/``touch``)."""
        if not self._on:
            return
        idx = 1 + DOC_KINDS.index(kind)
        now = self._clock()
        with self._lock:
            row = self._docs.get(di)
            if row is None:
                if len(self._docs) >= self.max_docs:
                    self._prune(now)
                row = self._docs[di] = [now, 0.0, 0.0, 0.0]
            self._decay_row(row, now)
            row[idx] += n

    def tick_shard(self, shard: int, kind: str, n: float = 1.0,
                   of: Optional[int] = None) -> None:
        """One shard-level event (``ingest``/``launch``/``degradation``).
        ``of`` teaches the accountant the total shard count so idle
        shards weigh into the skew ratio."""
        if not self._on:
            return
        idx = 1 + SHARD_KINDS.index(kind)
        now = self._clock()
        with self._lock:
            if of is not None and of > self._n_shards:
                self._n_shards = int(of)
            row = self._shards.get(shard)
            if row is None:
                row = self._shards[shard] = [now, 0.0, 0.0, 0.0]
            self._decay_row(row, now)
            row[idx] += n

    def tick_revive(self, n: float = 1.0) -> None:
        """One tier miss that forced a revive (warm/cold -> hot)."""
        if not self._on:
            return
        now = self._clock()
        with self._lock:
            row = self._revive
            dt = now - row[0]
            if dt > 0.0:
                row[1] *= 2.0 ** (-dt / self.half_life_s)
            row[0] = now
            row[1] += n

    def _prune(self, now: float) -> None:
        """Drop the coldest half of the tracked docs (caller holds the
        lock) — the cap is a memory bound, not an accuracy contract."""
        for row in self._docs.values():
            self._decay_row(row, now)
        ranked = sorted(
            self._docs.items(), key=lambda kv: sum(kv[1][1:]), reverse=True
        )
        self._docs = dict(ranked[: self.max_docs // 2])

    # -- reads ----------------------------------------------------------
    def _rate(self, heat: float) -> float:
        return heat * _LN2 / self.half_life_s

    def doc_heat(self, di: int) -> float:
        """Current total heat (decayed event count) for one doc."""
        now = self._clock()
        with self._lock:
            row = self._docs.get(di)
            if row is None:
                return 0.0
            self._decay_row(row, now)
            return sum(row[1:])

    def skew_ratio(self) -> Optional[float]:
        """Hottest shard's ingest heat over the uniform share (1.0 =
        balanced; None until any shard event was seen)."""
        now = self._clock()
        with self._lock:
            return self._skew_locked(now)

    def _skew_locked(self, now: float) -> Optional[float]:
        n = max(self._n_shards, len(self._shards))
        if not n or not self._shards:
            return None
        for row in self._shards.values():
            self._decay_row(row, now)
        totals = [row[1] for row in self._shards.values()]
        total = sum(totals)
        if total <= 0.0:
            return 1.0
        return round(max(totals) / (total / n), 4)

    def report(self) -> dict:
        """The rebalancer feed: top-K hot docs, per-shard heat + skew
        ratio vs uniform, revive pressure."""
        now = self._clock()
        with self._lock:
            for row in self._docs.values():
                self._decay_row(row, now)
            ranked = sorted(
                self._docs.items(), key=lambda kv: sum(kv[1][1:]),
                reverse=True,
            )
            top: List[dict] = []
            for di, row in ranked[: self.top_k]:
                heat = sum(row[1:])
                if heat <= 1e-9:
                    break
                top.append({
                    "doc": di,
                    "heat": round(heat, 4),
                    "per_s": round(self._rate(heat), 4),
                    "push": round(row[1], 4),
                    "pull": round(row[2], 4),
                    "touch": round(row[3], 4),
                })
            shards = {}
            for s in sorted(self._shards):
                row = self._shards[s]
                self._decay_row(row, now)
                shards[s] = {
                    "ingest": round(row[1], 4),
                    "launch": round(row[2], 4),
                    "degradation": round(row[3], 4),
                }
            skew = self._skew_locked(now)
            rrow = self._revive
            dt = now - rrow[0]
            revive_heat = rrow[1] * (
                2.0 ** (-dt / self.half_life_s) if dt > 0.0 else 1.0
            )
            return {
                "half_life_s": self.half_life_s,
                "tracked_docs": len(self._docs),
                "docs_top": top,
                "shards": shards,
                "n_shards": max(self._n_shards, len(self._shards)),
                "skew_ratio": skew,
                "revive_heat": round(revive_heat, 4),
                "revive_per_s": round(self._rate(revive_heat), 4),
            }


# -- module-level default accountant -----------------------------------
_default = HeatAccountant()


def accountant() -> HeatAccountant:
    return _default


def tick_doc(di: int, kind: str, n: float = 1.0) -> None:
    a = _default
    if a._on:
        a.tick_doc(di, kind, n)


def tick_shard(shard: int, kind: str, n: float = 1.0,
               of: Optional[int] = None) -> None:
    a = _default
    if a._on:
        a.tick_shard(shard, kind, n, of=of)


def tick_revive(n: float = 1.0) -> None:
    a = _default
    if a._on:
        a.tick_revive(n)


def report() -> dict:
    return _default.report()


def enable() -> None:
    _default.enable()


def disable() -> None:
    _default.disable()


def reset() -> None:
    _default.reset()
