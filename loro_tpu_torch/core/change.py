"""Op and Change model: the port's copy of loro_tpu/core/change.py.

Sequence (Text/List/MovableList) inserts carry the Fugue tree placement
`(parent_id, side)` computed at the source replica, so a batch of
inserts is placed by sorting `(parent, side, peer, counter)` keys on the
device (ops/fugue_batch.py), with no sequential origin scan.

Each op consumes a contiguous counter range of its change: a SeqInsert
of n items consumes n counters (one id per element, a run), every other
op one counter.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple, Union

from .ids import ID, ContainerID, Counter, IdSpan, Lamport, PeerID, TreeID
from .version import Frontiers


class Side(enum.IntEnum):
    Left = 0
    Right = 1


@dataclass(frozen=True)
class StyleAnchor:
    """A rich-text style anchor element (the start or end of a mark)."""

    key: str
    value: Any
    is_start: bool
    # whether text inserted at the boundary inherits the style
    info: int = 0


@dataclass(frozen=True)
class MapSet:
    key: str
    value: Any  # None with deleted=True encodes a key deletion
    deleted: bool = False


@dataclass(frozen=True)
class SeqInsert:
    """Insert `len(content)` elements as a Fugue run.

    parent=None means the root (beginning of the sequence); side is the
    Fugue child side relative to parent.  Element j of the run has id
    (peer, op counter + j); for j > 0 its parent is element j - 1, on
    the right."""

    parent: Optional[ID]
    side: Side
    content: Union[str, Tuple[Any, ...], StyleAnchor]

    def n_elems(self) -> int:
        if isinstance(self.content, StyleAnchor):
            return 1
        return len(self.content)


@dataclass(frozen=True)
class SeqDelete:
    """Tombstone the elements in `spans` (ids of elements, not positions)."""

    spans: Tuple[IdSpan, ...]


@dataclass(frozen=True)
class TreeMove:
    """Create, move or delete a tree node (parent None = a root child)."""

    target: TreeID
    parent: Optional[TreeID]
    position: Optional[bytes]  # fractional index among siblings
    is_create: bool = False
    is_delete: bool = False


@dataclass(frozen=True)
class CounterIncr:
    delta: float


@dataclass(frozen=True)
class MovableSet:
    elem: ID  # element id (id of the insert op element)
    value: Any


@dataclass(frozen=True)
class MovableMove:
    """Move element `elem` to a new Fugue position (this op's id becomes
    the new position element's id)."""

    elem: ID
    parent: Optional[ID]
    side: Side


@dataclass(frozen=True)
class UnknownContent:
    """Forward-compatibility payload of an unknown container kind."""

    kind: int
    data: bytes


OpContent = Union[MapSet, SeqInsert, SeqDelete, TreeMove, CounterIncr, MovableSet, MovableMove, UnknownContent]


@dataclass(frozen=True)
class Op:
    """One operation inside a change; `counter` is absolute (peer-wide)."""

    counter: Counter
    container: ContainerID
    content: OpContent

    def atom_len(self) -> int:
        c = self.content
        if isinstance(c, SeqInsert):
            return c.n_elems()
        return 1

    @property
    def ctr_end(self) -> Counter:
        return self.counter + self.atom_len()


@dataclass
class Change:
    """A batch of causally contiguous ops by one peer."""

    id: ID  # (peer, first counter)
    lamport: Lamport
    deps: Frontiers
    ops: List[Op]
    timestamp: int = 0
    message: Optional[str] = None

    @property
    def peer(self) -> PeerID:
        return self.id.peer

    @property
    def ctr_start(self) -> Counter:
        return self.id.counter

    @property
    def ctr_end(self) -> Counter:
        return self.ops[-1].ctr_end if self.ops else self.id.counter

    def atom_len(self) -> int:
        return self.ctr_end - self.ctr_start

    @property
    def lamport_end(self) -> Lamport:
        return self.lamport + self.atom_len()

    def id_span(self) -> IdSpan:
        return IdSpan(self.peer, self.ctr_start, self.ctr_end)

    def last_id(self) -> ID:
        return ID(self.peer, self.ctr_end - 1)

    def can_merge_right(self, other: "Change", merge_interval_s: int) -> bool:
        """Whether `other` can be merged onto self as one run: same peer,
        contiguous counters, depending on self only, close timestamps,
        equal commit messages."""
        return (
            other.peer == self.peer
            and other.ctr_start == self.ctr_end
            and other.lamport == self.lamport_end
            and len(other.deps) == 1
            and next(iter(other.deps)) == self.last_id()
            and abs(other.timestamp - self.timestamp) <= merge_interval_s
            and other.message == self.message
        )


class _RunCont:
    """Sentinel parent meaning "the previous counter of the same peer":
    the implicit right-spine parent of a run's continuation.  In the JAX
    package it lives in loro_tpu/oplog/oplog.py, beside the run slicing
    that produces it; the port's oplog/oplog.py takes it from here (the
    decoder needs it too)."""

    def __repr__(self) -> str:
        return "<run-cont>"


_RUN_CONT = _RunCont()
