"""Frontiers: the port's copy of the one class of loro_tpu/core/version.py
that decoding needs (a change's deps).  The version-vector machinery
stays in the JAX package until a slice needs it."""
from __future__ import annotations

from typing import Iterable, Iterator, Tuple

from .ids import ID


class Frontiers:
    """A minimal set of DAG head ids, held as a sorted tuple (hashable;
    duplicates dropped)."""

    __slots__ = ("_ids",)

    def __init__(self, ids: Iterable[ID] = ()):
        self._ids: Tuple[ID, ...] = tuple(sorted(set(ids)))

    @staticmethod
    def from_id(id: ID) -> "Frontiers":
        return Frontiers((id,))

    def as_ids(self) -> Tuple[ID, ...]:
        return self._ids

    def is_empty(self) -> bool:
        return not self._ids

    def __len__(self) -> int:
        return len(self._ids)

    def __iter__(self) -> Iterator[ID]:
        return iter(self._ids)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Frontiers) and self._ids == other._ids

    def __hash__(self) -> int:
        return hash(self._ids)

    def __repr__(self) -> str:
        return f"Frontiers[{', '.join(map(str, self._ids))}]"
