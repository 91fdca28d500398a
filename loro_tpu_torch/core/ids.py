"""Container identifiers: the subset of loro_tpu/core/ids.py that the
port's codec reads (ContainerType, ContainerID)."""
from __future__ import annotations

import enum
from typing import Optional


class ContainerType(enum.IntEnum):
    """The seven container kinds; the wire carries the value."""

    Map = 0
    List = 1
    Text = 2
    Tree = 3
    MovableList = 4
    Counter = 5
    Unknown = 6


class ContainerID:
    """Root(name, type) or Normal(peer, counter, type): hashable, equal
    when kind, name, peer and counter are."""

    __slots__ = ("name", "peer", "counter", "ctype", "_hash")

    def __init__(self, ctype: ContainerType, name: Optional[str] = None, peer: Optional[int] = None,
                 counter: Optional[int] = None):
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
    def normal(peer: int, counter: int, ctype: ContainerType) -> "ContainerID":
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

    def __repr__(self) -> str:
        if self.is_root:
            return f"cid:root-{self.name}:{self.ctype.name}"
        return f"cid:{self.counter}@{self.peer}:{self.ctype.name}"
