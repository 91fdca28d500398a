"""FugueSeq: the shared sequence CRDT for Text / List / MovableList.

Mirrors the role of the reference's Fugue tracker
(crates/loro-internal/src/container/richtext/tracker.rs +
tracker/crdt_rope.rs) but with a different, device-first formulation:

* Ops ship the Fugue **tree placement** `(parent, side)` decided at the
  source replica (see core/change.py).  Integration is then pure tree
  insertion with deterministic sibling order `(peer, counter)` — no
  origin-scan — so a batch of inserts integrates on device by sorting
  `(parent, side, peer, counter)` keys + list ranking
  (ops/fugue_batch.py).  This host class is the sequential
  engine and the differential oracle for those kernels.

* Local placement rule (Fugue, Weidner & Kleppmann "The Art of the
  Fugue"): inserting after visible element `a`:
    - `a` has no right children  -> (a, Right)
    - else                       -> (succ(a), Left)
  where succ(a) is a's immediate tree-traversal successor (tombstones
  included).  succ(a) necessarily has no left children yet, so the new
  element lands exactly at the intended position; concurrent same-spot
  inserts become siblings ordered by id.

Order maintenance is an order-statistic treap (utils/treap.py), the
analog of the reference's generic-btree rope.
"""
from __future__ import annotations

import bisect
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from ..core.change import Side, StyleAnchor
from ..core.ids import ID, Counter, IdSpan, PeerID
from ..utils.treap import Treap, TreapNode

ROOT = None  # fugue-parent sentinel for root children


def visible_at(e: "SeqElem", v) -> bool:
    """Element visibility at version v: inserted (id in v) and not
    deleted by any delete-op in v.  THE visibility predicate — all
    version-filtered walks (diffs, styled diffs) must share it."""
    return v.includes(e.id) and not any(v.includes(x) for x in e.deleted_by)


class SeqElem(TreapNode):
    """One sequence element (char / list value / anchor / position)."""

    __slots__ = (
        "peer",
        "counter",
        "content",
        "deleted",
        "deleted_by",  # List[ID] of delete-op atoms (for version diffs)
        "fparent",  # Optional[SeqElem]; None = root child
        "fside",  # Side
        "l_children",  # List[SeqElem] sorted by (peer, counter)
        "r_children",
        "lamport",
    )

    def __init__(
        self,
        peer: PeerID,
        counter: Counter,
        content: Any,
        fparent: Optional["SeqElem"],
        fside: Side,
        lamport: int = 0,
    ):
        self.peer = peer
        self.counter = counter
        self.content = content
        self.deleted = False
        self.deleted_by: List[ID] = []
        self.fparent = fparent
        self.fside = fside
        self.l_children: List[SeqElem] = []
        self.r_children: List[SeqElem] = []
        self.lamport = lamport
        is_anchor = isinstance(content, StyleAnchor)
        self.init_treap(0 if is_anchor else 1)

    @property
    def id(self) -> ID:
        return ID(self.peer, self.counter)

    @property
    def sib_key(self) -> Tuple[PeerID, Counter]:
        return (self.peer, self.counter)

    @property
    def is_anchor(self) -> bool:
        return isinstance(self.content, StyleAnchor)

    def base_width(self) -> int:
        return 0 if self.is_anchor else 1

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<{self.counter}@{self.peer} {self.content!r}{' DEL' if self.deleted else ''}>"


class FugueSeq:
    """The sequence CRDT.  All mutation goes through local_* (source
    replica) or integrate_* (both local apply and remote merge)."""

    def __init__(self) -> None:
        self.treap = Treap()
        self.by_id: Dict[Tuple[PeerID, Counter], SeqElem] = {}
        self.root_children: List[SeqElem] = []  # sorted by sib_key; side=Right
        # delete-op id -> elements it tombstoned (inverse of deleted_by;
        # lets version diffs find visibility flips by id range)
        self.deleter_index: Dict[Tuple[PeerID, Counter], List[SeqElem]] = {}

    # ------------------------------------------------------------------
    # tree navigation
    # ------------------------------------------------------------------
    @staticmethod
    def _subtree_last(x: SeqElem) -> SeqElem:
        while x.r_children:
            x = x.r_children[-1]
        return x

    @staticmethod
    def _subtree_first(x: SeqElem) -> SeqElem:
        while x.l_children:
            x = x.l_children[0]
        return x

    # ------------------------------------------------------------------
    # local placement (source replica)
    # ------------------------------------------------------------------
    def placement_for_visible_pos(self, k: int) -> Tuple[Optional[ID], Side]:
        """Compute the Fugue (parent, side) for a local insert at visible
        position k (0..visible_len)."""
        if k == 0:
            f = self.treap.first()
            if f is None:
                return None, Side.Right
            return f.id, Side.Left  # type: ignore[union-attr]
        a = self.treap.find_visible(k - 1)
        assert a is not None, f"insert pos {k} out of range"
        return self._placement_after(a)

    def _placement_after(self, a: SeqElem) -> Tuple[Optional[ID], Side]:
        if not a.r_children:
            return a.id, Side.Right
        succ = Treap.successor(a)
        assert succ is not None and not succ.l_children  # immediate successor
        return succ.id, Side.Left  # type: ignore[union-attr]

    def placement_after_elem(self, elem_id: ID) -> Tuple[Optional[ID], Side]:
        """Placement immediately after a known element (used by
        MovableList move and style-anchor insertion)."""
        return self._placement_after(self.by_id[(elem_id.peer, elem_id.counter)])

    # ------------------------------------------------------------------
    # integration (local + remote)
    # ------------------------------------------------------------------
    def integrate_insert(
        self,
        peer: PeerID,
        counter: Counter,
        parent: Optional[ID],
        side: Side,
        contents: Sequence[Any],
        lamport: int = 0,
        compute_pos: bool = True,
    ) -> Tuple[int, List[SeqElem]]:
        """Insert a run of elements with ids (peer, counter+j).  Element 0
        is placed per (parent, side); element j>0 chains as Right child of
        element j-1 (RLE right-spine, like the reference's FugueSpan runs).
        Returns (visible position of first element — -1 when
        compute_pos=False — and the created elems)."""
        first = SeqElem(peer, counter, contents[0], None, side, lamport)
        self._place(first, parent, side)
        elems = [first]
        prev = first
        for j in range(1, len(contents)):
            e = SeqElem(peer, counter + j, contents[j], prev, Side.Right, lamport + j)
            # prev was just created: appending keeps (peer,counter) order
            prev.r_children.append(e)
            self.treap.insert_after(prev, e)
            self.by_id[(peer, counter + j)] = e
            elems.append(e)
            prev = e
        pos = self.treap.visible_rank(first) if compute_pos else -1
        return pos, elems

    def _place(self, n: SeqElem, parent: Optional[ID], side: Side) -> None:
        """Fugue tree insertion with sibling order (peer, counter)."""
        if parent is None:
            sibs = self.root_children
            parent_elem = None
        else:
            parent_elem = self.by_id[(parent.peer, parent.counter)]
            sibs = parent_elem.r_children if side == Side.Right else parent_elem.l_children
        n.fparent = parent_elem
        n.fside = side
        i = bisect.bisect_left(sibs, n.sib_key, key=lambda e: e.sib_key)
        sibs.insert(i, n)
        if side == Side.Right:
            if i == 0:
                pred = parent_elem  # may be None (root): insert at beginning
                if parent is None:
                    # root children: first sibling -> very beginning unless
                    # there are smaller siblings (i==0 means none)
                    pred = None
            else:
                pred = self._subtree_last(sibs[i - 1])
            self.treap.insert_after(pred, n)
        else:
            if i > 0:
                pred = self._subtree_last(sibs[i - 1])
                self.treap.insert_after(pred, n)
            else:
                # new leftmost of parent's subtree: before old subtree-first
                assert parent_elem is not None
                old_first = parent_elem
                # subtree-first along remaining l_children (excluding n)
                cur = parent_elem
                while True:
                    lc = [c for c in cur.l_children if c is not n]
                    if not lc:
                        break
                    cur = lc[0]
                old_first = cur
                pred = Treap.predecessor(old_first)
                self.treap.insert_after(pred, n)
        self.by_id[(n.peer, n.counter)] = n

    def integrate_delete(
        self, spans: Iterable[IdSpan], deleter: Optional[ID] = None, compute_pos: bool = True
    ) -> List[Tuple[int, int]]:
        """Tombstone elements by id.  Returns visible (pos, len) ranges
        that disappeared (merged, descending-safe order of single units;
        empty when compute_pos=False).  `deleter` (the delete op's id)
        is recorded per element so version diffs can evaluate visibility
        at any vv."""
        removed: List[Tuple[int, int]] = []
        for span in spans:
            for c in range(span.start, span.end):
                e = self.by_id.get((span.peer, c))
                if e is None:
                    continue
                if deleter is not None:
                    e.deleted_by.append(deleter)
                    self.deleter_index.setdefault(
                        (deleter.peer, deleter.counter), []
                    ).append(e)
                if e.deleted:
                    continue
                if compute_pos:
                    pos = self.treap.visible_rank(e)
                    if e.vis_w:
                        removed.append((pos, 1))
                e.deleted = True
                self.treap.set_visible(e, 0)
        return _merge_removed(removed)

    def delta_between(self, va, vb, as_text: bool, vc=None):
        """Exact delta turning the visible sequence at version `va` into
        the one at `vb` (both must be within this seq's history).
        Element visibility at V: inserted (id in V) and not deleted by
        any delete-op in V.

        When `vc` — the version this structure's treap CURRENTLY
        reflects — is given, the scan is O(delta): only elements whose
        visibility can differ among {va, vb, vc} (derived from the
        per-peer counter ranges of the symmetric differences va^vc and
        vb^vc, resolved through by_id / deleter_index) are evaluated;
        every other element has vis_va == vis_vb == its live treap
        width, so the retain gaps between affected elements come from
        visible-rank arithmetic instead of a full walk.  Reference
        extracts diffs by walking only changed subtrees
        (crates/loro-internal/src/container/richtext/tracker/
        crdt_rope.rs:383-451); this is the rank-query analog.
        """
        from ..event import Delta

        d = Delta()
        if vc is None:
            for e in self.all_elems():
                if e.is_anchor:
                    continue
                in_a = visible_at(e, va)
                in_b = visible_at(e, vb)
                if in_a and in_b:
                    d.retain(1)
                elif in_a:
                    d.delete(1)
                elif in_b:
                    d.insert(e.content if as_text else (e.content,))
            return d.chop()

        cand: Dict[int, SeqElem] = {}
        for hi, lo in ((va, vc), (vc, va), (vb, vc), (vc, vb)):
            for span in hi.diff_spans(lo):
                for c in range(span.start, span.end):
                    e = self.by_id.get((span.peer, c))
                    if e is not None and not e.is_anchor:
                        cand[id(e)] = e
                    hit = self.deleter_index.get((span.peer, c))
                    if hit:
                        for e2 in hit:
                            if not e2.is_anchor:
                                cand[id(e2)] = e2
        elems = sorted(cand.values(), key=self.treap.total_rank)
        pending = 0  # retains accumulated since the last emitted op
        prev = 0  # live-visible rank consumed so far
        for e in elems:
            r = self.treap.visible_rank(e)
            pending += r - prev
            prev = r + e.vis_w  # skip e's own live width; handled below
            in_a = visible_at(e, va)
            in_b = visible_at(e, vb)
            if in_a and in_b:
                pending += 1
            elif in_a:
                if pending:
                    d.retain(pending)
                    pending = 0
                d.delete(1)
            elif in_b:
                if pending:
                    d.retain(pending)
                    pending = 0
                d.insert(e.content if as_text else (e.content,))
        return d.chop()

    def set_visible(self, elem: SeqElem, vis_w: int) -> None:
        """Directly control an element's visible width (MovableList uses
        this for slot-winner bookkeeping)."""
        self.treap.set_visible(elem, vis_w)

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------
    @property
    def visible_len(self) -> int:
        return self.treap.visible_len

    @property
    def total_len(self) -> int:
        return self.treap.total_len

    def visible_elems(self) -> Iterable[SeqElem]:
        for e in self.treap:
            if e.vis_w:
                yield e

    def all_elems(self) -> Iterable[SeqElem]:
        return iter(self.treap)

    def elem_at(self, k: int) -> Optional[SeqElem]:
        n = self.treap.find_visible(k)
        return n  # type: ignore[return-value]

    def id_range_of_visible(self, k: int, length: int) -> List[IdSpan]:
        """Ids of the visible elements in [k, k+length) as RLE spans —
        the payload of a SeqDelete op."""
        spans: List[IdSpan] = []
        e = self.treap.find_visible(k)
        n = 0
        while e is not None and n < length:
            if e.vis_w:
                if spans and spans[-1].peer == e.peer and spans[-1].end == e.counter:
                    spans[-1] = IdSpan(e.peer, spans[-1].start, e.counter + 1)
                else:
                    spans.append(IdSpan(e.peer, e.counter, e.counter + 1))
                n += 1
            e = Treap.successor(e)  # type: ignore[assignment]
        return spans

    def check_invariants(self) -> None:
        """Slow structural self-check (fuzzer oracle; reference:
        check_state_correctness_slow).  Raises AssertionError on any
        violated invariant."""
        n_total = 0
        n_vis = 0
        for e in self.all_elems():
            n_total += 1
            if e.vis_w:
                n_vis += 1
            assert self.by_id.get((e.peer, e.counter)) is e, "by_id out of sync"
            for side_list, side in ((e.l_children, Side.Left), (e.r_children, Side.Right)):
                keys = [c.sib_key for c in side_list]
                assert keys == sorted(keys), "children unsorted"
                for c in side_list:
                    assert c.fparent is e and c.fside == side, "child link broken"
            if e.deleted or e.is_anchor:
                assert e.vis_w == 0, "tombstone/anchor with visible width"
        assert n_total == self.treap.total_len, "treap count out of sync"
        assert n_vis == self.treap.visible_len, "treap visible count out of sync"
        rk = [c.sib_key for c in self.root_children]
        assert rk == sorted(rk), "root children unsorted"
        # rank/select agreement on a few positions
        for k in range(0, n_vis, max(1, n_vis // 7)):
            e = self.treap.find_visible(k)
            assert e is not None and self.treap.visible_rank(e) == k, "rank/select mismatch"

    def visible_index_of(self, elem_id: ID) -> Optional[int]:
        e = self.by_id.get((elem_id.peer, elem_id.counter))
        if e is None or not e.vis_w:
            return None
        return self.treap.visible_rank(e)


def _merge_removed(removed: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merge unit removals into ranges.  Successive deletions at the same
    visible position (forward sweep) collapse into one range."""
    out: List[Tuple[int, int]] = []
    for pos, ln in removed:
        if out and out[-1][0] == pos:
            out[-1] = (pos, out[-1][1] + ln)
        else:
            out.append((pos, ln))
    return out
