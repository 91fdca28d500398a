"""Plain Fugue reference for the text cells.

A document is the generator's event log (one row an applied patch, in
apply order; peers as ranks) and the 64-bit peer id of each rank.  Its
elements are the inserts; an element's Fugue parent and side come from
the log, and siblings are ordered by (peer id, counter), the merge rule
every replica applies, so every replica that has the same ops has the
same text.  The text is an in-order walk: left subtrees, the element,
right subtrees, with deleted elements left out.

``sibling="arrival"`` orders siblings by apply order instead: the text
a replica would show that applied concurrent inserts as they reached
it, which breaks convergence.  It is the control of the comparison.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np


class Elements(NamedTuple):
    """The inserts of an event log, in apply order."""

    peer: np.ndarray  # int32 peer rank
    counter: np.ndarray  # int32
    parent: np.ndarray  # int64 index of the parent element, -1 = the root
    side: np.ndarray  # int32, 0 left, 1 right
    char: np.ndarray  # int32 codepoint
    deleted: np.ndarray  # bool


def elements(events: Dict[str, np.ndarray]) -> Elements:
    ins = events["insert"].astype(bool)
    peer = events["peer"][ins]
    counter = events["counter"][ins]
    key = (peer.astype(np.int64) << 32) | counter.astype(np.int64)
    order = np.argsort(key, kind="stable")
    sorted_key = key[order]

    def find(p: np.ndarray, c: np.ndarray) -> np.ndarray:
        want = (p.astype(np.int64) << 32) | c.astype(np.int64)
        at = np.searchsorted(sorted_key, want)
        at = np.minimum(at, len(sorted_key) - 1)
        if not np.array_equal(sorted_key[at], want):
            raise ValueError("the event log names an element it never inserted")
        return order[at]

    rp, rc = events["ref_peer"][ins], events["ref_counter"][ins]
    parent = np.full(len(peer), -1, np.int64)
    has = rp >= 0
    parent[has] = find(rp[has], rc[has])
    dels = ~ins
    deleted = np.zeros(len(peer), bool)
    if dels.any():
        deleted[find(events["ref_peer"][dels], events["ref_counter"][dels])] = True
    return Elements(peer, counter, parent, events["side"][ins].astype(np.int32), events["char"][ins], deleted)


def traversal(el: Elements, peer_ids: Sequence[int], sibling: str = "peer") -> np.ndarray:
    """Element indexes in document order (tombstones included)."""
    n = len(el.peer)
    if sibling == "peer":
        pid = np.asarray(peer_ids, np.uint64)[el.peer]
        # lexsort: last key is primary -> (parent, side, peer id, counter)
        order = np.lexsort((el.counter, pid, el.side, el.parent))
    elif sibling == "arrival":
        order = np.lexsort((np.arange(n), el.side, el.parent))
    else:
        raise ValueError(f"sibling must be 'peer' or 'arrival', got {sibling!r}")
    par = el.parent[order].tolist()
    sd = el.side[order].tolist()
    lch: List[Optional[list]] = [None] * n
    rch: List[Optional[list]] = [None] * n
    roots: List[int] = []
    for e, p, s in zip(order.tolist(), par, sd):
        if p < 0:
            roots.append(e)
            continue
        kids = lch if s == 0 else rch
        if kids[p] is None:
            kids[p] = []
        kids[p].append(e)
    out: List[int] = []
    stack = list(reversed(roots))
    while stack:
        x = stack.pop()
        if x < 0:
            out.append(~x)
            continue
        r, l = rch[x], lch[x]
        if r:
            stack.extend(reversed(r))
        stack.append(~x)
        if l:
            stack.extend(reversed(l))
    return np.asarray(out, np.int64)


def text_at(el: Elements, order: np.ndarray) -> str:
    """The text: the walk's elements that no delete removed."""
    keep = order[~el.deleted[order]]
    return el.char[keep].astype("<u4").tobytes().decode("utf-32-le")


class TextReference:
    """Reference texts of the documents of one run, cached by (base,
    peer ids' order) so that documents sharing both share one walk."""

    def __init__(self, bases: Sequence[Dict[str, np.ndarray]], sibling: str = "peer"):
        self._events = list(bases)
        self._elements: Dict[int, Elements] = {}
        self._orders: Dict[tuple, np.ndarray] = {}
        self.sibling = sibling

    def text(self, base: int, peer_ids: Sequence[int]) -> str:
        el = self._elements.get(base)
        if el is None:
            el = self._elements[base] = elements(self._events[base])
        rank_order = tuple(np.argsort(np.asarray(peer_ids, np.uint64), kind="stable").tolist())
        order = self._orders.get((base, rank_order))
        if order is None:
            order = self._orders[(base, rank_order)] = traversal(el, peer_ids, self.sibling)
        return text_at(el, order)
