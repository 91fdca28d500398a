"""Events, diffs and the Delta algebra.

reference: crates/loro-internal/src/event.rs (+ the loro-delta crate).
Diffs are the currency of the whole framework: container states emit
them on merge, subscribers receive them, undo inverts them, checkout
produces them.  Sequence diffs are Quill-style deltas with O(n) compose
(the reference uses a B-tree DeltaRope for O(log n); host diffs here are
small — bulk merge work happens on device).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

from .core.ids import ContainerID, TreeID
from .core.version import Frontiers


class EventTriggerKind(enum.Enum):
    Local = "local"
    Import = "import"
    Checkout = "checkout"


# ---------------------------------------------------------------------------
# Delta (retain / insert / delete runs)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Retain:
    n: int
    attributes: Optional[dict] = None


@dataclass(frozen=True)
class Insert:
    # str for text, tuple of values for lists
    value: Union[str, Tuple[Any, ...]]
    attributes: Optional[dict] = None

    def __len__(self) -> int:
        return len(self.value)


@dataclass(frozen=True)
class Delete:
    n: int


DeltaItem = Union[Retain, Insert, Delete]


def _concat(a: Union[str, Tuple], b: Union[str, Tuple]):
    return a + b


class Delta:
    """A list of delta items with normalization and compose."""

    __slots__ = ("items",)

    def __init__(self, items: Optional[Sequence[DeltaItem]] = None):
        self.items: List[DeltaItem] = []
        if items:
            for it in items:
                self.push(it)

    # -- builders -----------------------------------------------------
    def retain(self, n: int, attributes: Optional[dict] = None) -> "Delta":
        if n > 0:
            self.push(Retain(n, attributes))
        return self

    def insert(self, value, attributes: Optional[dict] = None) -> "Delta":
        if len(value) > 0:
            self.push(Insert(value, attributes))
        return self

    def delete(self, n: int) -> "Delta":
        if n > 0:
            self.push(Delete(n))
        return self

    def push(self, it: DeltaItem) -> None:
        if isinstance(it, Retain) and it.n == 0:
            return
        if isinstance(it, Insert) and len(it.value) == 0:
            return
        if isinstance(it, Delete) and it.n == 0:
            return
        if self.items:
            last = self.items[-1]
            if isinstance(last, Retain) and isinstance(it, Retain) and last.attributes == it.attributes:
                self.items[-1] = Retain(last.n + it.n, last.attributes)
                return
            if (
                isinstance(last, Insert)
                and isinstance(it, Insert)
                and last.attributes == it.attributes
                and type(last.value) is type(it.value)
            ):
                self.items[-1] = Insert(_concat(last.value, it.value), last.attributes)
                return
            if isinstance(last, Delete) and isinstance(it, Delete):
                self.items[-1] = Delete(last.n + it.n)
                return
        self.items.append(it)

    def chop(self) -> "Delta":
        """Drop a trailing attribute-less retain."""
        while self.items and isinstance(self.items[-1], Retain) and self.items[-1].attributes is None:
            self.items.pop()
        return self

    def is_empty(self) -> bool:
        return not self.items

    # -- application --------------------------------------------------
    def apply_to_text(self, s: str) -> str:
        out: List[str] = []
        i = 0
        for it in self.items:
            if isinstance(it, Retain):
                out.append(s[i : i + it.n])
                i += it.n
            elif isinstance(it, Insert):
                out.append(it.value)  # type: ignore[arg-type]
            else:
                i += it.n
        out.append(s[i:])
        return "".join(out)

    def apply_to_list(self, xs: List[Any]) -> List[Any]:
        out: List[Any] = []
        i = 0
        for it in self.items:
            if isinstance(it, Retain):
                out.extend(xs[i : i + it.n])
                i += it.n
            elif isinstance(it, Insert):
                out.extend(it.value)
            else:
                i += it.n
        out.extend(xs[i:])
        return out

    # -- algebra ------------------------------------------------------
    def compose(self, other: "Delta") -> "Delta":
        """self then other, as one delta (standard Quill compose)."""
        out = Delta()
        a = _Cursor(self.items)
        b = _Cursor(other.items)
        while a.has() or b.has():
            if b.peek_type() is Insert:
                out.push(b.take_insert())
                continue
            if not a.has():
                it = b.take(b.remaining())
                out.push(it)
                continue
            if not b.has():
                out.push(a.take(a.remaining()))
                continue
            if a.peek_type() is Delete:
                out.push(a.take(a.remaining()))
                continue
            n = min(a.remaining(), b.remaining())
            ai = a.take(n)
            bi = b.take(n)
            if isinstance(bi, Delete):
                if isinstance(ai, Retain):
                    out.push(Delete(n))
                # insert+delete annihilate
            else:  # bi is Retain
                battr = bi.attributes
                if isinstance(ai, Insert):
                    out.push(Insert(ai.value, _merge_attr(ai.attributes, battr)))
                else:
                    out.push(Retain(n, _merge_attr(ai.attributes, battr)))
        return out.chop()

    def transform(self, other: "Delta", priority_left: bool) -> "Delta":
        """Transform `other` against self (OT; used by undo's remote-op
        transform, reference undo.rs DiffBatch::transform)."""
        out = Delta()
        a = _Cursor(self.items)
        b = _Cursor(other.items)
        while a.has() or b.has():
            if a.peek_type() is Insert and (priority_left or b.peek_type() is not Insert):
                out.retain(len(a.take_insert().value))
                continue
            if b.peek_type() is Insert:
                out.push(b.take_insert())
                continue
            if not a.has():
                out.push(b.take(b.remaining()))
                continue
            if not b.has():
                break
            n = min(a.remaining(), b.remaining())
            ai = a.take(n)
            bi = b.take(n)
            if isinstance(ai, Delete):
                continue  # ai deleted the region `bi` acted on
            if isinstance(bi, Delete):
                out.push(Delete(n))
            else:
                out.push(Retain(n, bi.attributes))
        return out.chop()

    def insert_len(self) -> int:
        return sum(len(it.value) for it in self.items if isinstance(it, Insert))

    def delete_len(self) -> int:
        return sum(it.n for it in self.items if isinstance(it, Delete))

    def __eq__(self, other) -> bool:
        return isinstance(other, Delta) and self.items == other.items

    def __repr__(self) -> str:
        return f"Delta({self.items!r})"

    def to_json(self) -> List[dict]:
        out = []
        for it in self.items:
            if isinstance(it, Retain):
                d: dict = {"retain": it.n}
                if it.attributes is not None:
                    d["attributes"] = it.attributes
            elif isinstance(it, Insert):
                d = {"insert": it.value if isinstance(it.value, str) else list(it.value)}
                if it.attributes is not None:
                    d["attributes"] = it.attributes
            else:
                d = {"delete": it.n}
            out.append(d)
        return out


def _merge_attr(a: Optional[dict], b: Optional[dict]) -> Optional[dict]:
    if a is None:
        return b
    if b is None:
        return a
    out = dict(a)
    out.update(b)
    return out or None


class _Cursor:
    """Iterates delta items with partial consumption."""

    __slots__ = ("items", "i", "off")

    def __init__(self, items: List[DeltaItem]):
        self.items = items
        self.i = 0
        self.off = 0

    def has(self) -> bool:
        return self.i < len(self.items)

    def peek_type(self):
        return type(self.items[self.i]) if self.has() else None

    def remaining(self) -> int:
        it = self.items[self.i]
        if isinstance(it, Insert):
            return len(it.value) - self.off
        return it.n - self.off

    def take(self, n: int) -> DeltaItem:
        it = self.items[self.i]
        if isinstance(it, Insert):
            v = it.value[self.off : self.off + n]
            self._adv(n, len(it.value))
            return Insert(v, it.attributes)
        if isinstance(it, Retain):
            self._adv(n, it.n)
            return Retain(n, it.attributes)
        self._adv(n, it.n)
        return Delete(n)

    def take_insert(self) -> Insert:
        it = self.items[self.i]
        assert isinstance(it, Insert)
        v = it.value[self.off :]
        self.i += 1
        self.off = 0
        return Insert(v, it.attributes)

    def _adv(self, n: int, total: int) -> None:
        self.off += n
        if self.off >= total:
            self.i += 1
            self.off = 0


# ---------------------------------------------------------------------------
# Container diffs
# ---------------------------------------------------------------------------


@dataclass
class MapDiff:
    """key -> new value (None + key in `deleted` means removal)."""

    updated: Dict[str, Any] = field(default_factory=dict)
    deleted: set = field(default_factory=set)

    def compose(self, other: "MapDiff") -> "MapDiff":
        out = MapDiff(dict(self.updated), set(self.deleted))
        for k, v in other.updated.items():
            out.updated[k] = v
            out.deleted.discard(k)
        for k in other.deleted:
            out.updated.pop(k, None)
            out.deleted.add(k)
        return out

    def is_empty(self) -> bool:
        return not self.updated and not self.deleted


class TreeDiffAction(enum.Enum):
    Create = "create"
    Move = "move"
    Delete = "delete"


@dataclass(frozen=True)
class TreeDiffItem:
    target: TreeID
    action: TreeDiffAction
    parent: Optional[TreeID] = None  # None = root (for Create/Move)
    index: int = 0
    position: Optional[bytes] = None  # fractional index
    # where the node came from, for Move/Delete consumers (reference:
    # TreeExternalDiff::Move { old_parent, old_index })
    old_parent: Optional[TreeID] = None
    old_index: Optional[int] = None


@dataclass
class TreeDiff:
    items: List[TreeDiffItem] = field(default_factory=list)

    def compose(self, other: "TreeDiff") -> "TreeDiff":
        return TreeDiff(self.items + other.items)

    def is_empty(self) -> bool:
        return not self.items


@dataclass
class CounterDiff:
    delta: float = 0.0

    def compose(self, other: "CounterDiff") -> "CounterDiff":
        return CounterDiff(self.delta + other.delta)

    def is_empty(self) -> bool:
        return self.delta == 0.0


Diff = Union[Delta, MapDiff, TreeDiff, CounterDiff]


def compose_diff(a: Optional[Diff], b: Diff) -> Diff:
    if a is None:
        return b
    return a.compose(b)  # type: ignore[union-attr]


# ---------------------------------------------------------------------------
# Doc-level events
# ---------------------------------------------------------------------------


@dataclass
class ContainerDiff:
    id: ContainerID
    path: Tuple[Union[str, int], ...]  # key / index path from root
    diff: Diff


@dataclass
class DocDiff:
    """reference: event.rs DocDiff."""

    origin: str
    by: EventTriggerKind
    from_frontiers: Frontiers
    to_frontiers: Frontiers
    diffs: List[ContainerDiff] = field(default_factory=list)


Subscriber = Callable[[DocDiff], None]


class Observer:
    """Subscription registry (reference: subscription.rs)."""

    def __init__(self) -> None:
        self._root: Dict[int, Subscriber] = {}
        self._by_container: Dict[ContainerID, Dict[int, Subscriber]] = {}
        self._next = 0

    def subscribe_root(self, cb: Subscriber) -> Callable[[], None]:
        sid = self._next
        self._next += 1
        self._root[sid] = cb

        def unsub() -> None:
            self._root.pop(sid, None)

        return unsub

    def subscribe(self, cid: ContainerID, cb: Subscriber) -> Callable[[], None]:
        sid = self._next
        self._next += 1
        self._by_container.setdefault(cid, {})[sid] = cb

        def unsub() -> None:
            subs = self._by_container.get(cid)
            if subs:
                subs.pop(sid, None)
                if not subs:
                    self._by_container.pop(cid, None)

        return unsub

    def has_subscribers(self) -> bool:
        return bool(self._root) or bool(self._by_container)

    def emit(self, ev: DocDiff) -> None:
        for cb in list(self._root.values()):
            cb(ev)
        if not self._by_container:
            return
        for cd in ev.diffs:
            subs = self._by_container.get(cd.id)
            if subs:
                scoped = DocDiff(ev.origin, ev.by, ev.from_frontiers, ev.to_frontiers, [cd])
                for cb in list(subs.values()):
                    cb(scoped)
