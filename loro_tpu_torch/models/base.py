"""ContainerState interface — the gating boundary of the framework.

reference: crates/loro-internal/src/state.rs:238-277 (`ContainerState`
trait).  Device merge kernels produce diffs/states behind this same
boundary: a container state can be host-materialized (these classes) or
batch-resident on device (parallel/fleet.py), with identical
observable behavior.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Optional, TYPE_CHECKING

from ..core.change import Op
from ..core.ids import ContainerID
from ..event import Diff

if TYPE_CHECKING:  # pragma: no cover
    from ..core.change import Change


class ContainerState(ABC):
    """Materialized state of one container.

    `materialized` is False for states that exist only because a handler
    READ them (reads must not make containers spring into existence in
    doc values — reference: should_avoid_initialize_new_container_
    accidentally); it flips True when an op applies or a snapshot
    hydrates the state."""

    materialized = False

    def __init__(self, cid: ContainerID):
        self.cid = cid

    @abstractmethod
    def apply_op(self, op: Op, peer: int, lamport: int, record: bool = True) -> Optional[Diff]:
        """Integrate one op (local or remote, causally ordered) and return
        the event diff it produced (None if no observable change).
        `peer` is the authoring peer; `lamport` is the lamport of the
        op's first atom.  With record=False the integration happens but
        no diff is built (positions/rank queries skipped — the fast
        path when nothing consumes events)."""

    @abstractmethod
    def get_value(self) -> Any:
        """Shallow value (child containers appear as ContainerID)."""

    @abstractmethod
    def to_diff(self) -> Diff:
        """Diff from empty to the current state (for initial subscription
        snapshots and checkout events)."""

    def is_empty_state(self) -> bool:
        v = self.get_value()
        return not v
