"""Order-statistic treap over sequence elements.

Host-side replacement for the reference's `generic-btree` rope
(crates/generic-btree): O(log n) insert-after, rank and k-th-visible
queries over elements that each carry a total width (1) and a visible
width (0 when tombstoned / zero-width anchor).

Nodes are intrusive: any object with the `TreapNode` slots mixed in can
live in the tree (SeqElem uses this).  Priorities come from a
deterministic xorshift of an insertion tick so behavior reproduces
across runs.
"""
from __future__ import annotations

from typing import Iterator, Optional


class TreapNode:
    __slots__ = ("tl", "tr", "tp", "tpri", "tcount", "tvis", "vis_w")

    def init_treap(self, vis_w: int) -> None:
        self.tl: Optional[TreapNode] = None
        self.tr: Optional[TreapNode] = None
        self.tp: Optional[TreapNode] = None
        self.tpri: int = 0
        self.vis_w: int = vis_w  # this node's own visible width
        self.tcount: int = 1  # subtree node count
        self.tvis: int = vis_w  # subtree visible width


def _cnt(n: Optional[TreapNode]) -> int:
    return n.tcount if n is not None else 0


def _vis(n: Optional[TreapNode]) -> int:
    return n.tvis if n is not None else 0


class Treap:
    """Sequence of TreapNodes in insertion order with rank/select."""

    __slots__ = ("root", "_tick")

    def __init__(self) -> None:
        self.root: Optional[TreapNode] = None
        self._tick = 0x9E3779B97F4A7C15

    # deterministic pseudo-random priority (splitmix64)
    def _next_pri(self) -> int:
        self._tick = (self._tick + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
        z = self._tick
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        return z ^ (z >> 31)

    # -- internal maintenance ----------------------------------------
    @staticmethod
    def _pull(n: TreapNode) -> None:
        # hot path: inlined child reads (called ~20x per insert)
        l = n.tl
        r = n.tr
        if l is not None:
            if r is not None:
                n.tcount = 1 + l.tcount + r.tcount
                n.tvis = n.vis_w + l.tvis + r.tvis
            else:
                n.tcount = 1 + l.tcount
                n.tvis = n.vis_w + l.tvis
        elif r is not None:
            n.tcount = 1 + r.tcount
            n.tvis = n.vis_w + r.tvis
        else:
            n.tcount = 1
            n.tvis = n.vis_w

    def _rot_up(self, n: TreapNode) -> None:
        """Rotate n above its parent."""
        p = n.tp
        g = p.tp
        if p.tl is n:
            p.tl = n.tr
            if n.tr is not None:
                n.tr.tp = p
            n.tr = p
        else:
            p.tr = n.tl
            if n.tl is not None:
                n.tl.tp = p
            n.tl = p
        p.tp = n
        n.tp = g
        if g is None:
            self.root = n
        elif g.tl is p:
            g.tl = n
        else:
            g.tr = n
        self._pull(p)
        self._pull(n)

    def _bubble(self, n: TreapNode) -> None:
        while n.tp is not None and n.tp.tpri < n.tpri:
            self._rot_up(n)
        # fix sizes up the remaining path
        p = n.tp
        while p is not None:
            self._pull(p)
            p = p.tp

    # -- public api ---------------------------------------------------
    def insert_after(self, after: Optional[TreapNode], n: TreapNode) -> None:
        """Insert n immediately after `after` (None = at the beginning)."""
        n.tpri = self._next_pri()
        n.tl = n.tr = None
        if self.root is None:
            n.tp = None
            self.root = n
            self._pull(n)
            return
        if after is None:
            cur = self.root
            while cur.tl is not None:
                cur = cur.tl
            cur.tl = n
            n.tp = cur
        elif after.tr is None:
            after.tr = n
            n.tp = after
        else:
            cur = after.tr
            while cur.tl is not None:
                cur = cur.tl
            cur.tl = n
            n.tp = cur
        self._pull(n)
        self._bubble(n)

    def set_visible(self, n: TreapNode, vis_w: int) -> None:
        if n.vis_w == vis_w:
            return
        n.vis_w = vis_w
        cur: Optional[TreapNode] = n
        while cur is not None:
            self._pull(cur)
            cur = cur.tp

    def visible_rank(self, n: TreapNode) -> int:
        """Number of visible width units strictly before n."""
        r = _vis(n.tl)
        cur = n
        while cur.tp is not None:
            p = cur.tp
            if p.tr is cur:
                r += _vis(p.tl) + p.vis_w
            cur = p
        return r

    def total_rank(self, n: TreapNode) -> int:
        r = _cnt(n.tl)
        cur = n
        while cur.tp is not None:
            p = cur.tp
            if p.tr is cur:
                r += _cnt(p.tl) + 1
            cur = p
        return r

    def find_visible(self, k: int) -> Optional[TreapNode]:
        """The visible node covering visible index k (0-based)."""
        cur = self.root
        if cur is None or k < 0 or k >= cur.tvis:
            return None
        while True:
            lv = _vis(cur.tl)
            if k < lv:
                cur = cur.tl
            elif k < lv + cur.vis_w:
                return cur
            else:
                k -= lv + cur.vis_w
                cur = cur.tr

    @property
    def visible_len(self) -> int:
        return _vis(self.root)

    @property
    def total_len(self) -> int:
        return _cnt(self.root)

    @staticmethod
    def successor(n: TreapNode) -> Optional[TreapNode]:
        if n.tr is not None:
            cur = n.tr
            while cur.tl is not None:
                cur = cur.tl
            return cur
        cur = n
        while cur.tp is not None and cur.tp.tr is cur:
            cur = cur.tp
        return cur.tp

    @staticmethod
    def predecessor(n: TreapNode) -> Optional[TreapNode]:
        if n.tl is not None:
            cur = n.tl
            while cur.tr is not None:
                cur = cur.tr
            return cur
        cur = n
        while cur.tp is not None and cur.tp.tl is cur:
            cur = cur.tp
        return cur.tp

    def first(self) -> Optional[TreapNode]:
        cur = self.root
        while cur is not None and cur.tl is not None:
            cur = cur.tl
        return cur

    def __iter__(self) -> Iterator[TreapNode]:
        n = self.first()
        while n is not None:
            yield n
            n = self.successor(n)
