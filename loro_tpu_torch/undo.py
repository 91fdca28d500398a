"""UndoManager: undo/redo of local edits with OT against concurrent
remote edits.

reference: crates/loro-internal/src/undo.rs — local commit spans are
recorded on a stack; undo computes the inverse DiffBatch between the
span's end and start versions (history replay) and transforms it
through everything that has been applied since (remote imports and
later local edits), then applies it as *new* ops; redo mirrors.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .core.ids import ContainerID
from .core.version import Frontiers
from .doc import LoroDoc
from .event import CounterDiff, Delta, DocDiff, EventTriggerKind, MapDiff, TreeDiff

UNDO_ORIGIN = "undo"
REDO_ORIGIN = "redo"


@dataclass
class UndoItem:
    from_f: Frontiers
    to_f: Frontiers
    # diffs applied after this item, per container (for transform)
    post: Dict[ContainerID, Any] = field(default_factory=dict)
    # user meta captured by the on_push callback (reference:
    # UndoItemMeta{value, cursors})
    meta: Any = None


def _transform_batch(
    batch: Dict[ContainerID, Any], post: Dict[ContainerID, Any]
) -> Dict[ContainerID, Any]:
    """Transform an inverse DiffBatch through later diffs: sequence
    deltas are OT-transformed; map keys touched later are dropped (the
    later write wins, an undo must not clobber it); tree items whose
    target was touched later are dropped (reference DiffBatch::transform
    semantics, undo.rs:63-70)."""
    out: Dict[ContainerID, Any] = {}
    for cid, d in batch.items():
        p = post.get(cid)
        if p is None:
            out[cid] = d
            continue
        if isinstance(d, Delta) and isinstance(p, Delta):
            t = p.transform(d, priority_left=True)
            if not t.is_empty():
                out[cid] = t
        elif isinstance(d, MapDiff) and isinstance(p, MapDiff):
            touched = set(p.updated) | set(p.deleted)
            t = MapDiff(
                {k: v for k, v in d.updated.items() if k not in touched},
                {k for k in d.deleted if k not in touched},
            )
            if not t.is_empty():
                out[cid] = t
        elif isinstance(d, TreeDiff) and isinstance(p, TreeDiff):
            touched = {it.target for it in p.items}
            t = TreeDiff([it for it in d.items if it.target not in touched])
            if not t.is_empty():
                out[cid] = t
        elif isinstance(d, CounterDiff):
            out[cid] = d  # sums commute
    return out


class UndoManager:
    def __init__(
        self,
        doc: LoroDoc,
        max_stack: int = 100,
        merge_interval_ms: int = 0,
        exclude_origin_prefixes: Optional[List[str]] = None,
    ):
        """merge_interval_ms: consecutive local commits closer than this
        merge into one undo step (reference: UndoManager merge
        interval); group_start()/group_end() group explicitly;
        exclude_origin_prefixes: local commits whose origin starts with
        any prefix are not recorded as undo steps (reference:
        excludeOriginPrefixes).  Exclusion takes precedence over
        grouping: an excluded commit inside a group splits it (an undo
        span must never extend across work that must not be undone —
        the inverse diff would revert it)."""
        self.doc = doc
        self.max_stack = max_stack
        self.merge_interval_ms = merge_interval_ms
        self.exclude_origin_prefixes = list(exclude_origin_prefixes or [])
        self.undo_stack: List[UndoItem] = []
        self.redo_stack: List[UndoItem] = []
        self._unsub = doc.subscribe_root(self._on_event)
        self._grouping = False
        self._group_fresh = False
        self._last_push_ms = 0.0

    def close(self) -> None:
        self._unsub()

    # -- introspection (reference: UndoManager counts / peek) ----------
    def undo_count(self) -> int:
        return len(self.undo_stack)

    def redo_count(self) -> int:
        return len(self.redo_stack)

    def set_max_undo_steps(self, n: int) -> None:
        self.max_stack = n
        while len(self.undo_stack) > n:
            self.undo_stack.pop(0)

    def add_exclude_origin_prefix(self, prefix: str) -> None:
        """Commits whose origin starts with `prefix` neither push undo
        items nor clear the redo stack (reference:
        UndoManager::add_exclude_origin_prefix)."""
        self.exclude_origin_prefixes.append(prefix)

    def set_on_push(self, cb) -> None:
        """Called with (is_undo: bool, span frontiers) when a stack item
        is pushed; its return value (if any) is stored as the item's
        meta, readable via top_undo_meta/top_redo_meta (reference:
        OnPush returning UndoItemMeta — used to capture cursors/meta)."""
        self._on_push = cb

    def set_on_pop(self, cb) -> None:
        self._on_pop = cb

    def set_merge_interval(self, interval_ms: int) -> None:
        """reference: UndoManager::set_merge_interval (0 = no merge)."""
        self.merge_interval_ms = interval_ms

    @property
    def peer(self) -> int:
        """reference: UndoManager::peer."""
        return self.doc.peer

    def clear(self) -> None:
        """Drop both stacks (reference: UndoManager::clear)."""
        self.undo_stack.clear()
        self.redo_stack.clear()

    def record_new_checkpoint(self) -> None:
        """Commit pending work and force the next local commit to open
        a new undo item even inside the merge interval / a group
        (reference: UndoManager::record_new_checkpoint)."""
        self.doc._barrier()
        self._last_push_ms = float("-inf")
        self._group_fresh = True

    def _top_meta(self, stack: List[UndoItem]):
        return stack[-1].meta if stack else None

    def top_undo_meta(self):
        return self._top_meta(self.undo_stack)

    def top_redo_meta(self):
        return self._top_meta(self.redo_stack)

    def top_undo_value(self):
        m = self.top_undo_meta()
        return m.get("value") if isinstance(m, dict) else m

    def top_redo_value(self):
        m = self.top_redo_meta()
        return m.get("value") if isinstance(m, dict) else m

    # -- grouping (reference: undo group_start/group_end) --------------
    def group_start(self) -> None:
        self.doc._barrier()
        self._grouping = True
        self._group_fresh = True  # first in-group commit opens a new item

    def group_end(self) -> None:
        self.doc._barrier()
        self._grouping = False

    # ------------------------------------------------------------------
    def _on_event(self, ev: DocDiff) -> None:
        if ev.by == EventTriggerKind.Checkout:
            return
        if ev.by == EventTriggerKind.Local:
            # local history is linear: stack discipline alone keeps
            # inverse diffs applicable (later items are undone first),
            # so local diffs never fold into `post` — only remote
            # concurrency transforms the stacks (reference undo.rs).
            if ev.origin == UNDO_ORIGIN:
                self.redo_stack.append(UndoItem(ev.from_frontiers, ev.to_frontiers))
                cb = getattr(self, "_on_push", None)
                if cb is not None:
                    self.redo_stack[-1].meta = cb(False, (ev.from_frontiers, ev.to_frontiers))
            elif ev.origin == REDO_ORIGIN:
                self.undo_stack.append(UndoItem(ev.from_frontiers, ev.to_frontiers))
                cb = getattr(self, "_on_push", None)
                if cb is not None:
                    self.undo_stack[-1].meta = cb(True, (ev.from_frontiers, ev.to_frontiers))
            elif any(ev.origin.startswith(p) for p in self.exclude_origin_prefixes):
                # excluded local work behaves like remote concurrency:
                # it must transform the stacks, not become a step
                self._fold_post({cd.id: cd.diff for cd in ev.diffs})
            else:
                import time as _time

                now = _time.monotonic() * 1000
                if self._grouping:
                    want_merge = not self._group_fresh
                    self._group_fresh = False
                else:
                    want_merge = bool(
                        self.merge_interval_ms
                        and now - self._last_push_ms < self.merge_interval_ms
                    )
                mergeable = want_merge and self.undo_stack and not self.undo_stack[-1].post
                if mergeable:
                    # extend the top item's span to cover this commit
                    top = self.undo_stack[-1]
                    self.undo_stack[-1] = UndoItem(
                        top.from_f, ev.to_frontiers, top.post, top.meta
                    )
                else:
                    self.undo_stack.append(UndoItem(ev.from_frontiers, ev.to_frontiers))
                    if len(self.undo_stack) > self.max_stack:
                        self.undo_stack.pop(0)
                    cb = getattr(self, "_on_push", None)
                    if cb is not None:
                        self.undo_stack[-1].meta = cb(True, (ev.from_frontiers, ev.to_frontiers))
                self._last_push_ms = now
                self.redo_stack.clear()
            return
        # remote import: transform both stacks
        self._fold_post({cd.id: cd.diff for cd in ev.diffs})

    def _fold_post(self, ev_batch: Dict[ContainerID, Any]) -> None:
        from .event import compose_diff

        for stack in (self.undo_stack, self.redo_stack):
            for it in stack:
                for cid, d in ev_batch.items():
                    it.post[cid] = compose_diff(it.post.get(cid), d)

    # ------------------------------------------------------------------
    def can_undo(self) -> bool:
        return bool(self.undo_stack)

    def can_redo(self) -> bool:
        return bool(self.redo_stack)

    def undo(self) -> bool:
        return self._pop_apply(self.undo_stack, UNDO_ORIGIN)

    def redo(self) -> bool:
        return self._pop_apply(self.redo_stack, REDO_ORIGIN)

    def _pop_apply(self, stack: List[UndoItem], origin: str) -> bool:
        self.doc._barrier()
        if not stack:
            return False
        item = stack.pop()
        cb = getattr(self, "_on_pop", None)
        if cb is not None:
            # reference OnPop receives the popped item's meta (cursor
            # restore); legacy 2-arg callbacks keep working
            import inspect

            try:
                takes_meta = len(inspect.signature(cb).parameters) >= 3
            except (TypeError, ValueError):
                takes_meta = False
            if takes_meta:
                cb(stack is self.undo_stack, (item.from_f, item.to_f), item.meta)
            else:
                cb(stack is self.undo_stack, (item.from_f, item.to_f))
        inv = self.doc.diff(item.to_f, item.from_f)  # inverse of the span
        inv = _transform_batch(inv, item.post)
        if not inv:
            return True  # fully cancelled by later edits; still consumed
        self.doc.apply_diff(inv, origin=origin)
        return True
