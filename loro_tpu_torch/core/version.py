"""Version types, the port's copy of loro_tpu/core/version.py:
VersionVector (with its wire form and varint helpers), Frontiers and
VersionRange.

A VersionVector maps peer -> next-expected counter (the number of known
ops); Frontiers are the DAG heads (a change's deps); a VersionRange
maps peers to counter ranges (the pending report of an import).
"""
from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Optional, Tuple

from .ids import ID, Counter, IdSpan, PeerID


class VersionVector:
    """peer -> end counter (exclusive).  Ops (peer, 0..end) are included."""

    __slots__ = ("_m",)

    def __init__(self, m: Optional[Dict[PeerID, Counter]] = None):
        self._m: Dict[PeerID, Counter] = dict(m) if m else {}

    # -- access -------------------------------------------------------
    def get(self, peer: PeerID) -> Counter:
        return self._m.get(peer, 0)

    def includes(self, id: ID) -> bool:
        return id.counter < self._m.get(id.peer, 0)

    def includes_span(self, span: IdSpan) -> bool:
        return span.end <= self._m.get(span.peer, 0)

    def items(self) -> Iterable[Tuple[PeerID, Counter]]:
        return self._m.items()

    def peers(self) -> Iterable[PeerID]:
        return self._m.keys()

    def __len__(self) -> int:
        return len(self._m)

    def __iter__(self) -> Iterator[PeerID]:
        return iter(self._m)

    def total_ops(self) -> int:
        return sum(self._m.values())

    # -- mutation -----------------------------------------------------
    def set_end(self, peer: PeerID, end: Counter) -> None:
        if end <= 0:
            self._m.pop(peer, None)
        else:
            self._m[peer] = end

    def extend_to_include(self, span: IdSpan) -> None:
        if span.end > self._m.get(span.peer, 0):
            self._m[span.peer] = span.end

    def merge(self, other: "VersionVector") -> None:
        for p, c in other._m.items():
            if c > self._m.get(p, 0):
                self._m[p] = c

    # -- algebra ------------------------------------------------------
    def copy(self) -> "VersionVector":
        return VersionVector(self._m)

    def meet(self, other: "VersionVector") -> "VersionVector":
        """Greatest lower bound (pointwise min)."""
        out = {}
        for p, c in self._m.items():
            oc = other._m.get(p, 0)
            if min(c, oc) > 0:
                out[p] = min(c, oc)
        return VersionVector(out)

    def join(self, other: "VersionVector") -> "VersionVector":
        out = dict(self._m)
        for p, c in other._m.items():
            if c > out.get(p, 0):
                out[p] = c
        return VersionVector(out)

    def __le__(self, other: "VersionVector") -> bool:
        return all(c <= other._m.get(p, 0) for p, c in self._m.items())

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, VersionVector):
            return NotImplemented
        a = {p: c for p, c in self._m.items() if c > 0}
        b = {p: c for p, c in other._m.items() if c > 0}
        return a == b

    def __hash__(self):  # pragma: no cover - VVs are not dict keys normally
        return hash(tuple(sorted((p, c) for p, c in self._m.items() if c > 0)))

    def diff_spans(self, other: "VersionVector") -> List[IdSpan]:
        """Spans present in self but not in other (self \\ other)."""
        out = []
        for p, c in self._m.items():
            oc = other._m.get(p, 0)
            if c > oc:
                out.append(IdSpan(p, oc, c))
        return sorted(out)

    def sub_vv(self, other: "VersionVector") -> List[IdSpan]:
        return self.diff_spans(other)

    def __repr__(self) -> str:
        inner = ", ".join(f"{p}:{c}" for p, c in sorted(self._m.items()))
        return f"VV{{{inner}}}"

    def to_json(self) -> Dict[str, int]:
        return {str(p): c for p, c in sorted(self._m.items())}

    @staticmethod
    def from_json(d: Dict[str, int]) -> "VersionVector":
        return VersionVector({int(p): c for p, c in d.items()})

    def encode(self) -> bytes:
        """Compact binary form (reference: VersionVector::encode)."""
        return _encode_u64_varint_pairs(
            sorted((p, c) for p, c in self._m.items() if c > 0)
        )

    @staticmethod
    def decode(data: bytes) -> "VersionVector":
        """Raises ValueError on malformed/truncated input (wire API)."""
        return VersionVector(dict(_decode_u64_varint_pairs(data)))


def _encode_u64_varint_pairs(pairs) -> bytes:
    """Shared wire shape for VersionVector and Frontiers: varint count,
    then per entry u64-LE + varint."""
    import struct

    out = bytearray()
    pairs = list(pairs)
    _uvarint(out, len(pairs))
    for a, b in pairs:
        out += struct.pack("<Q", a)
        _uvarint(out, b)
    return bytes(out)


def _decode_u64_varint_pairs(data: bytes):
    """Inverse of _encode_u64_varint_pairs; raises ValueError on
    malformed/truncated input."""
    import struct

    try:
        pos = [0]
        n = _read_uvarint(data, pos)
        if n > len(data):
            raise ValueError("count exceeds payload")
        out = []
        for _ in range(n):
            (a,) = struct.unpack_from("<Q", data, pos[0])
            pos[0] += 8
            out.append((a, _read_uvarint(data, pos)))
        return out
    except (IndexError, struct.error) as e:
        raise ValueError(f"malformed pair blob: {e}") from e


def _uvarint(out: bytearray, v: int) -> None:
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | 0x80 if v else b)
        if not v:
            return


def _read_uvarint(data: bytes, pos: List[int]) -> int:
    v = 0
    shift = 0
    while True:
        b = data[pos[0]]
        pos[0] += 1
        v |= (b & 0x7F) << shift
        if not (b & 0x80):
            return v
        shift += 7
        if shift > 70:
            raise ValueError("varint overflow")


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

    def to_json(self) -> List[str]:
        return [str(i) for i in self._ids]

    @staticmethod
    def from_json(v: List[str]) -> "Frontiers":
        return Frontiers(ID.parse(s) for s in v)

    def encode(self) -> bytes:
        """Compact binary form: varint count + (u64 peer, varint ctr)."""
        return _encode_u64_varint_pairs((i.peer, i.counter) for i in self._ids)

    @staticmethod
    def decode(data: bytes) -> "Frontiers":
        """Raises ValueError on malformed input."""
        return Frontiers(ID(p, c) for p, c in _decode_u64_varint_pairs(data))


class VersionRange:
    """peer -> (start, end) counter ranges, the pending report of
    ImportStatus."""

    __slots__ = ("_m",)

    def __init__(self, m: Optional[Dict[PeerID, Tuple[Counter, Counter]]] = None):
        self._m: Dict[PeerID, Tuple[Counter, Counter]] = dict(m) if m else {}

    def is_empty(self) -> bool:
        return not self._m

    def extend_to_include(self, span: IdSpan) -> None:
        if span.peer in self._m:
            s, e = self._m[span.peer]
            self._m[span.peer] = (min(s, span.start), max(e, span.end))
        else:
            self._m[span.peer] = (span.start, span.end)

    def items(self) -> Iterable[Tuple[PeerID, Tuple[Counter, Counter]]]:
        return self._m.items()

    def __eq__(self, other):
        return isinstance(other, VersionRange) and self._m == other._m

    def __repr__(self):
        inner = ", ".join(f"{p}:[{s},{e})" for p, (s, e) in sorted(self._m.items()))
        return f"VersionRange{{{inner}}}"
