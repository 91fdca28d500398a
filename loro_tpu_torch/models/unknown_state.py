"""Unknown container state: forward-compat passthrough that retains ops
without interpreting them (reference: state/unknown_state.rs)."""
from __future__ import annotations

from typing import List, Optional

from ..core.change import Op
from ..core.ids import ContainerID
from ..event import Diff, MapDiff
from .base import ContainerState


class UnknownState(ContainerState):
    def __init__(self, cid: ContainerID):
        super().__init__(cid)
        self.ops: List[Op] = []

    def apply_op(self, op: Op, peer: int, lamport: int, record: bool = True) -> Optional[Diff]:
        self.ops.append(op)
        return None

    def get_value(self) -> None:
        return None

    def to_diff(self) -> Diff:
        return MapDiff()
