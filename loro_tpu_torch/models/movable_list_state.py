"""MovableList container state.

reference: crates/loro-internal/src/state/movable_list_state.rs +
MovableListDiffCalculator (diff_calc.rs:1669-2020).  Model: the Fugue
sequence holds *position slots*; each element owns the set of slots
created for it (its insert op + every move op).  Per element:

- winning slot  = slot with max (lamport, peer)  (last move wins)
- winning value = set op with max (lamport, peer) (or creation value)
- element is visible iff its winning slot is not tombstoned — so a move
  that is newer (LWW) than a concurrent delete revives the element at
  the destination, matching the reference's move/delete resolution.

Device equivalent: two scatter-max passes (slot winner, value winner)
over (doc, elem) keys + the shared Fugue order kernel for slot order.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ..core.change import MovableMove, MovableSet, Op, SeqDelete, SeqInsert
from ..core.ids import ContainerID, ID
from ..event import Delta, Diff
from .base import ContainerState
from .list_state import _resolve_run_cont
from .seq_crdt import FugueSeq, SeqElem


class ElemEntry:
    __slots__ = ("value", "value_key", "pos_key", "slot", "deleted", "slots", "sets")

    def __init__(self, value: Any, value_key: Tuple[int, int], pos_key: Tuple[int, int], slot: ID):
        self.value = value
        self.value_key = value_key  # (lamport, peer) of winning set
        self.pos_key = pos_key  # (lamport, peer) of winning slot
        self.slot = slot  # winning slot id
        self.deleted = False
        # full histories for version-diff evaluation:
        self.slots: List[ID] = [slot]  # every position slot ever created
        self.sets: List[Tuple[int, int, ID, Any]] = []  # (lamport, peer, op id, value)


class MovableListState(ContainerState):
    def __init__(self, cid: ContainerID):
        super().__init__(cid)
        self.seq = FugueSeq()  # slots; content = elem ID
        self.elems: Dict[ID, ElemEntry] = {}

    # ------------------------------------------------------------------
    def apply_op(self, op: Op, peer: int, lamport: int, record: bool = True) -> Optional[Diff]:
        c = op.content
        if isinstance(c, SeqInsert):
            return self._apply_insert(op, c, peer, lamport, record)
        if isinstance(c, SeqDelete):
            return self._apply_delete(c, record, ID(peer, op.counter))
        if isinstance(c, MovableSet):
            return self._apply_set(c, peer, lamport, record, ID(peer, op.counter))
        assert isinstance(c, MovableMove)
        return self._apply_move(op, c, peer, lamport, record)

    def _apply_insert(
        self, op: Op, c: SeqInsert, peer: int, lamport: int, record: bool
    ) -> Optional[Diff]:
        parent = _resolve_run_cont(c.parent, peer, op.counter)
        elem_ids = [ID(peer, op.counter + j) for j in range(len(c.content))]
        pos, slots = self.seq.integrate_insert(
            peer, op.counter, parent, c.side, elem_ids, lamport, compute_pos=record
        )
        for j, (eid, v) in enumerate(zip(elem_ids, c.content)):
            key = (lamport + j, peer)
            entry = ElemEntry(v, key, key, eid)
            entry.sets.append((lamport + j, peer, eid, v))  # creation value
            self.elems[eid] = entry
        if not record:
            return None
        return Delta().retain(pos).insert(tuple(c.content))

    def _apply_delete(self, c: SeqDelete, record: bool, op_id: ID) -> Optional[Diff]:
        out = Delta()
        changed = False
        for span in c.spans:
            for ctr in range(span.start, span.end):
                slot = self.seq.by_id.get((span.peer, ctr))
                if slot is None:
                    continue
                # record the deleter even on already-dead slots so
                # version diffs can evaluate visibility at any vv
                slot.deleted_by.append(op_id)
                if slot.deleted:
                    continue
                was_visible = slot.vis_w > 0
                pos = self.seq.treap.visible_rank(slot) if (record and was_visible) else 0
                slot.deleted = True
                self.seq.set_visible(slot, 0)
                eid: ID = slot.content
                entry = self.elems.get(eid)
                if entry is not None and entry.slot == ID(span.peer, ctr):
                    entry.deleted = True
                if record and was_visible:
                    out = out.compose(Delta().retain(pos).delete(1))
                    changed = True
        return out if changed else None

    def _apply_set(
        self, c: MovableSet, peer: int, lamport: int, record: bool, op_id: ID
    ) -> Optional[Diff]:
        entry = self.elems.get(c.elem)
        if entry is None:
            return None  # element unknown (trimmed history)
        entry.sets.append((lamport, peer, op_id, c.value))
        if entry.value_key >= (lamport, peer):
            return None
        entry.value = c.value
        entry.value_key = (lamport, peer)
        if not record or entry.deleted:
            return None
        pos = self.seq.visible_index_of(entry.slot)
        if pos is None:
            return None
        return Delta().retain(pos).delete(1).compose(Delta().retain(pos).insert((c.value,)))

    def _apply_move(
        self, op: Op, c: MovableMove, peer: int, lamport: int, record: bool
    ) -> Optional[Diff]:
        entry = self.elems.get(c.elem)
        parent = _resolve_run_cont(c.parent, peer, op.counter)
        _, slots = self.seq.integrate_insert(
            peer, op.counter, parent, c.side, [c.elem], lamport, compute_pos=False
        )
        new_slot = slots[0]
        # hide immediately: event positions below must be computed on a
        # state that does NOT yet contain the destination slot (the diff
        # is delete-then-insert; the winner case re-shows it)
        self.seq.set_visible(new_slot, 0)
        if entry is None:
            return None  # unknown element (trimmed history)
        entry.slots.append(ID(peer, op.counter))
        new_key = (lamport, peer)
        if new_key <= entry.pos_key:
            return None  # stale move: slot stays invisible
        d = Delta()
        # hide old winning slot
        old = self.seq.by_id.get((entry.slot.peer, entry.slot.counter))
        was_visible = old is not None and old.vis_w > 0
        if was_visible:
            if record:
                old_pos = self.seq.treap.visible_rank(old)
                d = d.compose(Delta().retain(old_pos).delete(1))
            self.seq.set_visible(old, 0)
        entry.pos_key = new_key
        entry.slot = ID(peer, op.counter)
        revived = entry.deleted and not new_slot.deleted
        entry.deleted = new_slot.deleted
        if not new_slot.deleted:
            # the new slot becomes visible (move destination)
            self.seq.set_visible(new_slot, 1)
            if record:
                new_pos = self.seq.treap.visible_rank(new_slot)
                d = d.compose(Delta().retain(new_pos).insert((entry.value,)))
        if not record:
            return None
        return d if (was_visible or revived or not new_slot.deleted) else None

    # -- version diffs -------------------------------------------------
    def _winner_at(self, elem_id: ID, v, cache: Dict[ID, Optional[SeqElem]]) -> Optional[SeqElem]:
        """LWW-winning slot of an element within version v (memoized per
        diff so an element moved M times costs O(M) once, not per slot)."""
        if elem_id in cache:
            return cache[elem_id]
        entry = self.elems.get(elem_id)
        best = None
        if entry is not None:
            for sid in entry.slots:
                if not v.includes(sid):
                    continue
                se = self.seq.by_id.get((sid.peer, sid.counter))
                if se is None:
                    continue
                k = (se.lamport, se.peer)
                if best is None or k > best[0]:
                    best = (k, se)
        win = best[1] if best is not None else None
        cache[elem_id] = win
        return win

    def _slot_visible_at(self, slot: SeqElem, v, cache: Dict[ID, Optional[SeqElem]]) -> bool:
        """Slot shows the element at version v iff it exists, isn't
        deleted, and is the LWW winner among the element's slots in v."""
        if not v.includes(slot.id) or any(v.includes(x) for x in slot.deleted_by):
            return False
        return self._winner_at(slot.content, v, cache) is slot

    def _value_at(self, elem_id: ID, v) -> Any:
        entry = self.elems.get(elem_id)
        best = None
        if entry is not None:
            for lam, peer, oid, val in entry.sets:
                if v.includes(oid) and (best is None or (lam, peer) > best[0]):
                    best = ((lam, peer), val)
        return best[1] if best else None

    def delta_between(self, va, vb) -> Delta:
        """Exact delta turning the list at va into the list at vb
        (element/slot identity aware; value changes become replace)."""
        d = Delta()
        cache_a: Dict[ID, Optional[SeqElem]] = {}
        cache_b: Dict[ID, Optional[SeqElem]] = {}
        for slot in self.seq.all_elems():
            a_vis = self._slot_visible_at(slot, va, cache_a)
            b_vis = self._slot_visible_at(slot, vb, cache_b)
            if a_vis and b_vis:
                a_val = self._value_at(slot.content, va)
                b_val = self._value_at(slot.content, vb)
                if a_val == b_val:
                    d.retain(1)
                else:
                    d.delete(1)
                    d.insert((b_val,))
            elif a_vis:
                d.delete(1)
            elif b_vis:
                d.insert((self._value_at(slot.content, vb),))
        return d.chop()

    # -- queries ------------------------------------------------------
    def get_value(self) -> List[Any]:
        out = []
        for slot in self.seq.visible_elems():
            entry = self.elems.get(slot.content)
            out.append(entry.value if entry is not None else None)
        return out

    def __len__(self) -> int:
        return self.seq.visible_len

    def get(self, index: int) -> Any:
        slot = self.seq.elem_at(index)
        if slot is None:
            return None
        entry = self.elems.get(slot.content)
        return entry.value if entry is not None else None

    def elem_id_at(self, index: int) -> Optional[ID]:
        slot = self.seq.elem_at(index)
        return slot.content if slot is not None else None

    def slot_id_at(self, index: int) -> Optional[ID]:
        slot = self.seq.elem_at(index)
        return slot.id if slot is not None else None

    def to_diff(self) -> Diff:
        v = tuple(self.get_value())
        d = Delta()
        if v:
            d.insert(v)
        return d
