"""Stable cursors: positions that survive concurrent edits.

reference: crates/loro-internal/src/cursor.rs — a cursor stores the id
of the element it's anchored to (or a container end), and is resolved
against the *current* state at query time; if the element was deleted
the nearest surviving neighbor is used.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional

from .core.ids import ContainerID, ContainerType, ID
from .doc import LoroDoc, LoroError


class CursorSide(enum.IntEnum):
    Left = -1
    Middle = 0
    Right = 1


@dataclass(frozen=True)
class Cursor:
    container: ContainerID
    id: Optional[ID]  # None = container start/end depending on side
    side: CursorSide = CursorSide.Middle
    origin_pos: int = 0  # position when created (drift diagnostics)


@dataclass
class AbsolutePosition:
    pos: int
    side: CursorSide
    # True when the anchor element is gone and the cursor should be
    # re-created at `pos` (reference: cursor update hint)
    update_needed: bool = False


def get_cursor(doc: LoroDoc, container, pos: int, side: CursorSide = CursorSide.Middle) -> Cursor:
    """Create a stable cursor at visible position `pos`."""
    cid = container.id if hasattr(container, "id") else container
    st = doc.state.get_or_create(cid)
    seq = getattr(st, "seq", None)
    if seq is None:
        raise LoroError(f"{cid} does not support cursors")
    if pos >= seq.visible_len:
        return Cursor(cid, None, CursorSide.Right, pos)
    elem = seq.elem_at(pos)
    assert elem is not None
    # MovableList sequence elements are position *slots* whose content is
    # the stable element id — anchor to that so the cursor follows moves
    anchor = elem.content if cid.ctype == ContainerType.MovableList else elem.id
    return Cursor(cid, anchor, side, pos)


def get_cursor_pos(doc: LoroDoc, cursor: Cursor) -> AbsolutePosition:
    """Resolve a cursor against the current state."""
    st = doc.state.get_or_create(cursor.container)
    seq = getattr(st, "seq", None)
    if seq is None:
        raise LoroError(f"{cursor.container} does not support cursors")
    if cursor.id is None:
        return AbsolutePosition(seq.visible_len, cursor.side)
    if cursor.container.ctype == ContainerType.MovableList:
        entry = st.elems.get(cursor.id)  # type: ignore[union-attr]
        if entry is not None and not entry.deleted:
            idx = seq.visible_index_of(entry.slot)
            if idx is not None:
                return AbsolutePosition(idx, cursor.side)
        return AbsolutePosition(min(cursor.origin_pos, seq.visible_len), cursor.side, True)
    elem = seq.by_id.get((cursor.id.peer, cursor.id.counter))
    if elem is None:
        return AbsolutePosition(min(cursor.origin_pos, seq.visible_len), cursor.side, True)
    if elem.vis_w:
        return AbsolutePosition(seq.treap.visible_rank(elem), cursor.side)
    # anchor tombstoned: walk to the nearest visible successor
    from .utils.treap import Treap

    cur = Treap.successor(elem)
    while cur is not None and not cur.vis_w:
        cur = Treap.successor(cur)
    if cur is not None:
        return AbsolutePosition(seq.treap.visible_rank(cur), cursor.side, True)
    return AbsolutePosition(seq.visible_len, cursor.side, True)
