"""LWW-Map container state.

reference: crates/loro-internal/src/state/map_state.rs +
MapDiffCalculator (diff_calc.rs:488-616): per key, the winner is the op
with max (lamport, peer).  Deleted keys keep a tombstone entry so later
LWW comparisons stay correct.  The batched device equivalent is a
scatter-max over (doc, container, key) slots (ops/lww.py).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from ..core.change import MapSet, Op
from ..core.ids import ContainerID, PeerID
from ..event import Diff, MapDiff
from .base import ContainerState


class MapEntry:
    __slots__ = ("value", "lamport", "peer", "counter", "deleted")

    def __init__(self, value: Any, lamport: int, peer: PeerID, counter: int, deleted: bool):
        self.value = value
        self.lamport = lamport
        self.peer = peer
        self.counter = counter
        self.deleted = deleted

    @property
    def ord(self) -> Tuple[int, PeerID]:
        return (self.lamport, self.peer)


class MapState(ContainerState):
    def __init__(self, cid: ContainerID):
        super().__init__(cid)
        self.entries: Dict[str, MapEntry] = {}

    def apply_op(self, op: Op, peer: int, lamport: int, record: bool = True) -> Optional[Diff]:
        c = op.content
        assert isinstance(c, MapSet)
        cur = self.entries.get(c.key)
        if cur is not None and cur.ord >= (lamport, peer):
            return None  # LWW: existing entry wins
        self.entries[c.key] = MapEntry(c.value, lamport, peer, op.counter, c.deleted)
        d = MapDiff()
        if c.deleted:
            if cur is None or cur.deleted:
                return None  # no observable change
            d.deleted.add(c.key)
        else:
            d.updated[c.key] = c.value
        return d

    def get_value(self) -> Dict[str, Any]:
        return {k: e.value for k, e in self.entries.items() if not e.deleted}

    def get_entry(self, key: str) -> Optional[MapEntry]:
        e = self.entries.get(key)
        return e if e is not None and not e.deleted else None

    def to_diff(self) -> Diff:
        d = MapDiff()
        for k, e in self.entries.items():
            if not e.deleted:
                d.updated[k] = e.value
        return d
