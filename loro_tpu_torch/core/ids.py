"""Primitive identifier types: the port's copy of loro_tpu/core/ids.py
(op ids, id spans, tree node ids, container kinds and container ids).
Host-side these are light Python values; on the device ids are split
into (peer rank, counter) int32 columns or uint32 peer halves.
"""
from __future__ import annotations

import enum
from typing import NamedTuple, Optional, Tuple

PeerID = int  # u64 semantics; a Python int holds it
Counter = int  # i32 semantics
Lamport = int  # u32 semantics


class ID(NamedTuple):
    """An op id: (peer, counter)."""

    peer: PeerID
    counter: Counter

    def inc(self, delta: int) -> "ID":
        return ID(self.peer, self.counter + delta)

    def __str__(self) -> str:  # "12@7": counter 12 of peer 7
        return f"{self.counter}@{self.peer}"

    @staticmethod
    def parse(s: str) -> "ID":
        c, p = s.split("@")
        return ID(int(p), int(c))


class IdLp(NamedTuple):
    """Lamport-keyed id, the LWW order."""

    lamport: Lamport
    peer: PeerID

    def __str__(self) -> str:
        return f"L{self.lamport}@{self.peer}"


class IdFull(NamedTuple):
    """Id with both counter and lamport."""

    peer: PeerID
    counter: Counter
    lamport: Lamport

    @property
    def id(self) -> ID:
        return ID(self.peer, self.counter)

    @property
    def idlp(self) -> IdLp:
        return IdLp(self.lamport, self.peer)


class IdSpan(NamedTuple):
    """A contiguous counter span on one peer: [start, end)."""

    peer: PeerID
    start: Counter
    end: Counter

    def __len__(self) -> int:
        return max(0, self.end - self.start)

    def contains(self, id: ID) -> bool:
        return id.peer == self.peer and self.start <= id.counter < self.end


class ContainerType(enum.IntEnum):
    """The seven container kinds; the wire carries the value."""

    Map = 0
    List = 1
    Text = 2
    Tree = 3
    MovableList = 4
    Counter = 5
    Unknown = 6

    @staticmethod
    def from_name(name: str) -> "ContainerType":
        return ContainerType[name]


class ContainerID:
    """Root(name, type) or Normal(peer, counter, type): hashable, equal
    when kind, name, peer and counter are, and totally ordered (roots
    before normals) so it can key dictionaries and sort deterministically."""

    __slots__ = ("name", "peer", "counter", "ctype", "_hash")

    def __init__(self, ctype: ContainerType, name: Optional[str] = None, peer: Optional[PeerID] = None,
                 counter: Optional[Counter] = None):
        self.ctype = ContainerType(ctype)
        self.name = name
        self.peer = peer
        self.counter = counter
        if (name is None) == (peer is None):
            raise ValueError("ContainerID is either Root(name) or Normal(peer, counter)")
        self._hash = hash((self.ctype, name, peer, counter))

    @staticmethod
    def root(name: str, ctype: ContainerType) -> "ContainerID":
        return ContainerID(ctype, name=name)

    @staticmethod
    def normal(peer: PeerID, counter: Counter, ctype: ContainerType) -> "ContainerID":
        return ContainerID(ctype, peer=peer, counter=counter)

    @property
    def is_root(self) -> bool:
        return self.name is not None

    def __hash__(self) -> int:
        return self._hash

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, ContainerID)
            and self.ctype == other.ctype
            and self.name == other.name
            and self.peer == other.peer
            and self.counter == other.counter
        )

    def _key(self) -> Tuple:
        if self.is_root:
            return (0, self.name, int(self.ctype))
        return (1, self.peer, self.counter, int(self.ctype))

    def __lt__(self, other: "ContainerID") -> bool:
        return self._key() < other._key()

    def __repr__(self) -> str:
        if self.is_root:
            return f"cid:root-{self.name}:{self.ctype.name}"
        return f"cid:{self.counter}@{self.peer}:{self.ctype.name}"

    __str__ = __repr__

    @staticmethod
    def parse(s: str) -> "ContainerID":
        """Parse the `cid:` string form that repr writes."""
        if not s.startswith("cid:"):
            raise ValueError(f"not a container id: {s!r}")
        body, _, tname = s[4:].rpartition(":")
        ctype = ContainerType.from_name(tname)
        if body.startswith("root-"):
            return ContainerID.root(body[5:], ctype)
        c, _, p = body.partition("@")
        return ContainerID.normal(int(p), int(c), ctype)


class TreeID(NamedTuple):
    """Node id in a movable tree."""

    peer: PeerID
    counter: Counter

    @property
    def id(self) -> ID:
        return ID(self.peer, self.counter)

    def __str__(self) -> str:
        return f"{self.counter}@{self.peer}"

    @staticmethod
    def parse(s: str) -> "TreeID":
        c, p = s.split("@")
        return TreeID(int(p), int(c))


# Reserved root-name namespace for mergeable child containers
# (MapHandler.ensure_mergeable_*): the name deterministically encodes
# (parent cid, key, type), so concurrent creation on different replicas
# yields the SAME container and edits merge.  The \x00 prefix keeps user
# root names from colliding.
MERGEABLE_PREFIX = "\x00m:"


def mergeable_root_name(parent_cid: "ContainerID", key: str, ctype: "ContainerType") -> str:
    return f"{MERGEABLE_PREFIX}{parent_cid}\x00{key}\x00{int(ctype)}"


def is_internal_root_name(name: str) -> bool:
    return name.startswith(MERGEABLE_PREFIX)


def parse_mergeable_root_name(name: str):
    """(parent ContainerID, key) of a mergeable root name, or None."""
    if not name.startswith(MERGEABLE_PREFIX):
        return None
    body = name[len(MERGEABLE_PREFIX):]
    try:
        # rsplit: the parent cid string may itself embed \x00 (nested
        # mergeable containers)
        parent_s, key, _t = body.rsplit("\x00", 2)
        return ContainerID.parse(parent_s), key
    except (ValueError, KeyError):
        return None
