"""Pure-host placement + epoch-translation primitives of the sharded
resident fleet (docs/SHARDING.md).

Split from ``parallel/sharded.py`` so consumers that must stay off the
torch import graph — ``persist.inspect`` translates the fleet durable
watermark with the REAL `_EpochMap`, not a hand-kept mirror — can
import them directly.  Nothing here touches a device.
"""
from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence, Tuple

from ..errors import ShardingError


def rendezvous_shard(key: str, n_shards: int) -> int:
    """Highest-random-weight (rendezvous) shard for ``key``: the shard
    whose keyed digest of ``key`` is largest.  Deterministic across
    runs and processes (blake2b, never Python's seeded hash()), and
    resize-stable: adding shard N changes a doc's placement only if
    shard N wins it — docs never move between surviving shards."""
    best, best_w = 0, b""
    for s in range(n_shards):
        w = hashlib.blake2b(
            f"{key}|{s}".encode("utf-8"), digest_size=8
        ).digest()
        if w > best_w:
            best, best_w = s, w
    return best


class ShardPlacement:
    """Doc→(shard, local slot) assignment for a sharded fleet.

    Slots are assigned in global-doc order within each shard; every
    shard is built ``spare_slots`` wider than its placed docs so live
    migration has somewhere to land (a migrated-away slot is RETIRED —
    its device rows keep the doc's pre-move state and are simply never
    read again — so each shard accepts at most ``spare_slots`` inbound
    moves over the server's life)."""

    def __init__(self, n_docs: int, n_shards: int,
                 keys: Optional[Sequence[str]] = None,
                 spare_slots: int = 1):
        if keys is not None and len(keys) != n_docs:
            raise ValueError(
                f"doc_keys has {len(keys)} entries for {n_docs} docs"
            )
        self.n_docs = n_docs
        self.n_shards = n_shards
        self.spare_slots = max(0, int(spare_slots))
        self.keys = (
            [str(k) for k in keys] if keys is not None
            else [str(i) for i in range(n_docs)]
        )
        self.shard_of = [rendezvous_shard(k, n_shards) for k in self.keys]
        counts = [0] * n_shards
        self.slot_of: List[int] = []
        for s in self.shard_of:
            self.slot_of.append(counts[s])
            counts[s] += 1
        self.widths = [c + self.spare_slots for c in counts]
        # unclaimed migration slots per shard, FIFO
        self.free = [
            list(range(counts[s], self.widths[s])) for s in range(n_shards)
        ]

    @classmethod
    def from_manifest(cls, m: dict) -> "ShardPlacement":
        p = cls.__new__(cls)
        p.n_docs = int(m["n_docs"])
        p.n_shards = int(m["shards"])
        p.spare_slots = int(m.get("spare_slots", 0))
        p.keys = [str(k) for k in m["keys"]]
        p.shard_of = [int(s) for s in m["shard_of"]]
        p.slot_of = [int(s) for s in m["slot_of"]]
        p.widths = [int(w) for w in m["widths"]]
        p.free = [[int(x) for x in f] for f in m["free"]]
        if not (len(p.keys) == len(p.shard_of) == len(p.slot_of) == p.n_docs
                and len(p.widths) == len(p.free) == p.n_shards):
            raise ShardingError("shard manifest: inconsistent placement")
        return p

    def place(self, di: int) -> Tuple[int, int]:
        return self.shard_of[di], self.slot_of[di]

    def docs_of(self, shard: int) -> List[int]:
        return [g for g, s in enumerate(self.shard_of) if s == shard]

    def move(self, di: int, to_shard: int) -> int:
        """Claim a spare slot on ``to_shard`` for ``di`` and flip the
        assignment; the old slot is retired.  Returns the new local
        slot; raises typed when the target has none left."""
        if not self.free[to_shard]:
            raise ShardingError(
                f"shard {to_shard} has no free migration slot left "
                f"(built with spare_slots={self.spare_slots}; rebuild "
                "the fleet with more headroom to keep migrating into it)"
            )
        slot = self.free[to_shard].pop(0)
        self.shard_of[di] = to_shard
        self.slot_of[di] = slot
        return slot


class _EpochMap:
    """Global-round → shard-visible-epoch translation (and back).

    Identity while the clocks run in lockstep; a breakpoint ``(g, e)``
    is recorded whenever a shard's clock skews (per-doc poison
    isolation journals one shard round per doc; a durable reopen can
    recover shards at different epochs).  Interpolation between
    breakpoints is clamped by the NEXT breakpoint so translated ack
    epochs never lead the true shard epoch (a floor that led could
    reclaim a tombstone a replica still references)."""

    def __init__(self, g: int = 0, e: int = 0):
        self._bp: List[Tuple[int, int]] = [(g, e)]

    def note(self, g: int, e: int) -> None:
        g0, e0 = self._bp[-1]
        if e - e0 != g - g0:
            self._bp.append((g, e))

    def to_shard(self, g: int) -> int:
        bp = self._bp
        if g <= bp[0][0]:  # below the first breakpoint: extrapolate down
            g0, e0 = bp[0]
            return max(0, e0 - (g0 - g))
        out = 0
        for i, (g0, e0) in enumerate(bp):
            if g0 > g:
                break
            out = e0 + (g - g0)
            if i + 1 < len(bp):
                out = min(out, bp[i + 1][1])
        return max(0, out)

    def to_global(self, e: int) -> int:
        out = 0
        for i, (g0, e0) in enumerate(self._bp):
            if e0 > e:
                break
            out = g0 + (e - e0)
            if i + 1 < len(self._bp):
                out = min(out, self._bp[i + 1][0])
        return max(0, out)

    def encode(self) -> List[List[int]]:
        return [[g, e] for g, e in self._bp]

    @classmethod
    def decode(cls, bps) -> "_EpochMap":
        m = cls.__new__(cls)
        m._bp = [(int(g), int(e)) for g, e in bps] or [(0, 0)]
        return m
