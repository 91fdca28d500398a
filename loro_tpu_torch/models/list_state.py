"""List container state over FugueSeq.

reference: crates/loro-internal/src/state/list_state.rs (state) +
ListDiffCalculator (diff_calc.rs:620-867, merge).  Values are arbitrary
LoroValues; child containers appear as ContainerID values.
"""
from __future__ import annotations

from typing import Any, List, Optional

from ..core.change import Op, SeqDelete, SeqInsert
from ..core.ids import ContainerID, ID
from ..event import Delta, Diff
from .base import ContainerState
from .seq_crdt import FugueSeq


class ListState(ContainerState):
    def __init__(self, cid: ContainerID):
        super().__init__(cid)
        self.seq = FugueSeq()

    def apply_op(self, op: Op, peer: int, lamport: int, record: bool = True) -> Optional[Diff]:
        c = op.content
        if isinstance(c, SeqInsert):
            parent = _resolve_run_cont(c.parent, peer, op.counter)
            pos, _ = self.seq.integrate_insert(
                peer, op.counter, parent, c.side, list(c.content), lamport, compute_pos=record
            )
            if not record:
                return None
            return Delta().retain(pos).insert(tuple(c.content))
        assert isinstance(c, SeqDelete)
        removed = self.seq.integrate_delete(
            c.spans, deleter=ID(peer, op.counter), compute_pos=record
        )
        if not removed:
            return None
        # each removal's position is relative to the state after the
        # previous removals — compose folds them into one delta
        out = Delta()
        for pos, ln in removed:
            out = out.compose(Delta().retain(pos).delete(ln))
        return out

    def get_value(self) -> List[Any]:
        return [e.content for e in self.seq.visible_elems()]

    def __len__(self) -> int:
        return self.seq.visible_len

    def get(self, index: int) -> Any:
        e = self.seq.elem_at(index)
        return e.content if e is not None else None

    def elem_id_at(self, index: int) -> Optional[ID]:
        e = self.seq.elem_at(index)
        return e.id if e is not None else None

    def to_diff(self) -> Diff:
        v = tuple(self.get_value())
        d = Delta()
        if v:
            d.insert(v)
        return d


def _resolve_run_cont(parent, peer: int, counter: int):
    """Resolve the run-continuation sentinel left by change slicing: the
    implicit parent of a sliced run's first element is the previous
    element of the same peer (see oplog.oplog._slice_run)."""
    from ..oplog.oplog import _RunCont

    if isinstance(parent, _RunCont):
        return ID(peer, counter - 1)
    return parent
