"""Counter container state (reference: state/counter_state.rs).

A counter is a PN-counter specialization: the value is the sum of all
increment deltas, which is order-independent — the device equivalent is
a segment-sum over (doc, container) slots (ops/lww.py)."""
from __future__ import annotations

from typing import Optional

from ..core.change import CounterIncr, Op
from ..core.ids import ContainerID
from ..event import CounterDiff, Diff
from .base import ContainerState


class CounterState(ContainerState):
    def __init__(self, cid: ContainerID):
        super().__init__(cid)
        self.value: float = 0.0

    def apply_op(self, op: Op, peer: int, lamport: int, record: bool = True) -> Optional[Diff]:
        c = op.content
        assert isinstance(c, CounterIncr)
        self.value += c.delta
        return CounterDiff(c.delta)

    def get_value(self) -> float:
        return self.value

    def to_diff(self) -> Diff:
        return CounterDiff(self.value)
