"""Transaction: collects local ops, applies them to state immediately,
and packs them into one Change on commit.

reference: crates/loro-internal/src/txn.rs (single active txn per doc,
contiguous (peer, counter, lamport) assignment, txn.rs:548-650).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, TYPE_CHECKING

from .core.change import Change, MapSet, MovableSet, Op, OpContent, SeqInsert, TreeMove
from .core.ids import ContainerID, ID, TreeID
from .core.version import Frontiers
from .event import Diff
from .models.handlers import _ChildMarker, _TreeTargetMarker

if TYPE_CHECKING:  # pragma: no cover
    from .doc import LoroDoc


class Transaction:
    def __init__(self, doc: "LoroDoc", origin: str = ""):
        self.doc = doc
        self.origin = origin
        self.peer = doc.peer
        self.start_counter = doc.oplog.next_counter(doc.peer)
        self.next_counter = self.start_counter
        self.start_lamport = doc.oplog.next_lamport
        # detached-editable docs branch from the *state* version, not the
        # oplog head (reference: editable_detached_mode forks history)
        self.deps: Frontiers = (
            doc.state.frontiers if doc.is_detached() else doc.oplog.frontiers
        )
        self.start_frontiers: Frontiers = doc.state.frontiers
        self.ops: List[Op] = []
        self.diffs: Dict[ContainerID, List[Diff]] = {}
        self.message: Optional[str] = None
        # pre-commit subscribers may override (reference: ChangeModifier
        # sets commit message and timestamp)
        self.timestamp_override: Optional[int] = None

    # ------------------------------------------------------------------
    def apply(self, cid: ContainerID, content: OpContent) -> int:
        """Allocate ids for one op, apply it to state, buffer for commit.
        Returns the op's first counter (callers use it to derive child
        container ids / tree node ids)."""
        counter = self.next_counter
        content = self._resolve_markers(content, counter)
        op = Op(counter, cid, content)
        lamport = self.start_lamport + (counter - self.start_counter)
        self.doc.state._register_children(op, self.peer)
        st = self.doc.state.get_or_create(cid)
        st.materialized = True
        record = self.doc.observer.has_subscribers()
        d = st.apply_op(op, self.peer, lamport, record=record)
        # diff objects are only kept when someone will consume them
        # (reference skips event building with no subscribers)
        if d is not None and record:
            self.diffs.setdefault(cid, []).append(d)
        self.ops.append(op)
        self.next_counter += op.atom_len()
        return counter

    def is_empty(self) -> bool:
        return not self.ops

    def atom_len(self) -> int:
        return sum(op.ctr_end - op.counter for op in self.ops)

    def _resolve_markers(self, content: OpContent, counter: int) -> OpContent:
        """Replace handler-side child/tree markers with real ids — the
        child container id / tree node id is the op's own (peer, counter)."""
        if isinstance(content, MapSet) and isinstance(content.value, _ChildMarker):
            cid = ContainerID.normal(self.peer, counter, content.value.ctype)
            content.value.cid = cid
            return MapSet(content.key, cid, content.deleted)
        if isinstance(content, MovableSet) and isinstance(content.value, _ChildMarker):
            cid = ContainerID.normal(self.peer, counter, content.value.ctype)
            content.value.cid = cid
            return MovableSet(content.elem, cid)
        if isinstance(content, SeqInsert) and isinstance(content.content, tuple):
            if any(isinstance(v, _ChildMarker) for v in content.content):
                vals = []
                for j, v in enumerate(content.content):
                    if isinstance(v, _ChildMarker):
                        cid = ContainerID.normal(self.peer, counter + j, v.ctype)
                        v.cid = cid
                        vals.append(cid)
                    else:
                        vals.append(v)
                return SeqInsert(content.parent, content.side, tuple(vals))
        if isinstance(content, TreeMove) and isinstance(content.target, _TreeTargetMarker):
            return TreeMove(
                TreeID(self.peer, counter),
                content.parent,
                content.position,
                content.is_create,
                content.is_delete,
            )
        return content

    # ------------------------------------------------------------------
    def build_change(self) -> Optional[Change]:
        if not self.ops:
            return None
        if self.timestamp_override is not None:
            ts = self.timestamp_override
        else:
            # op timestamps are WIRE DATA (record_timestamp), not logic
            ts = int(time.time()) if self.doc.config.record_timestamp else 0
        return Change(
            id=ID(self.peer, self.start_counter),
            lamport=self.start_lamport,
            deps=self.deps,
            ops=self.ops,
            timestamp=ts,
            message=self.message,
        )
