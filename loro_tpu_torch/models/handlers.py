"""Typed container handlers — the user-facing mutation API.

reference: crates/loro-internal/src/handler.rs (TextHandler, MapHandler,
ListHandler, MovableListHandler, TreeHandler + loro/src counter.rs) and
handler/text_update.rs (diff-based `update`).
"""
from __future__ import annotations

import difflib
from typing import Any, List, Optional, TYPE_CHECKING

from ..core.change import (
    CounterIncr,
    MapSet,
    MovableMove,
    MovableSet,
    SeqDelete,
    SeqInsert,
    Side,
    StyleAnchor,
    TreeMove,
)
from ..core.ids import ContainerID, ContainerType, ID, TreeID
from ..errors import LoroError
from ..utils.fractional_index import key_between
from ..core.value import validate_value

if TYPE_CHECKING:  # pragma: no cover
    from ..doc import LoroDoc


class Handler:
    CT: ContainerType

    def __init__(self, doc: "LoroDoc", cid: ContainerID):
        assert cid.ctype == self.CT, f"{cid} is not a {self.CT.name}"
        self.doc = doc
        self.cid = cid

    @property
    def id(self) -> ContainerID:
        return self.cid

    @property
    def _state(self):
        return self.doc.state.get_or_create(self.cid)

    def _apply(self, content) -> int:
        return self.doc._txn_apply(self.cid, content)

    def get_value(self):
        return self._state.get_value()

    def get_deep_value(self):
        return self.doc.state._deep(self._state)

    def is_attached(self) -> bool:
        return True

    def get_type(self) -> ContainerType:
        """reference: Handler::get_type / ContainerTrait."""
        return self.cid.ctype

    def is_deleted(self) -> bool:
        """True when this container is no longer reachable from a root
        (its parent entry was overwritten/deleted, its list slot removed,
        or its tree node trashed); reference: ContainerTrait::is_deleted."""
        return not self.doc.state.is_alive(self.cid)

    def get_cursor(self, pos: int, side=None):
        """Stable cursor at pos (reference: Handler::get_cursor)."""
        from ..cursor import get_cursor as _get_cursor

        if side is None:
            return _get_cursor(self.doc, self, pos)
        return _get_cursor(self.doc, self, pos, side)

    def _child_handler(self, cid: ContainerID) -> "Handler":
        return make_handler(self.doc, cid)

    def subscribe(self, cb):
        return self.doc.subscribe(self.cid, cb)


class TextHandler(Handler):
    CT = ContainerType.Text

    # -- reads --------------------------------------------------------
    def to_string(self) -> str:
        return self._state.get_value()

    def get_richtext_value(self) -> List[dict]:
        return self._state.get_richtext_value()

    def __len__(self) -> int:
        return len(self._state)

    @property
    def length(self) -> int:
        return len(self._state)

    def char_at(self, pos: int) -> str:
        e = self._state.seq.elem_at(pos)
        if e is None:
            raise IndexError(pos)
        return e.content

    def slice(self, start: int, end: int) -> str:
        return self.to_string()[start:end]

    # -- utf16 index space (JS interop; reference tracks unicode/utf16/
    # utf8/entity lengths per rope node) ------------------------------
    @staticmethod
    def _w16(ch: str) -> int:
        return 1 + (ord(ch) > 0xFFFF)

    @staticmethod
    def _w8(ch: str) -> int:
        return len(ch.encode())

    def _width_len(self, width) -> int:
        return sum(width(e.content) for e in self._state.seq.visible_elems())

    def _offset_to_unicode(self, off: int, width, space: str) -> int:
        """Convert a unit offset in a variable-width index space to a
        codepoint position.  Offsets landing inside a unit (surrogate
        pair / multi-byte codepoint) are rejected — the reference errors
        on non-boundary indices rather than silently snapping (a JS
        peer's bug must not become data loss)."""
        acc = 0
        for i, e in enumerate(self._state.seq.visible_elems()):
            if acc == off:
                return i
            if acc > off:
                raise IndexError(f"{space} pos {off} is inside a unit boundary")
            acc += width(e.content)
        if acc < off:
            raise IndexError(f"{space} pos {off} > len {acc}")
        if acc > off:
            raise IndexError(f"{space} pos {off} is inside a unit boundary")
        return len(self._state)

    def len_utf16(self) -> int:
        return self._width_len(self._w16)

    def utf16_to_unicode(self, u16: int) -> int:
        return self._offset_to_unicode(u16, self._w16, "utf16")

    def unicode_to_utf16(self, pos: int) -> int:
        acc = 0
        for i, e in enumerate(self._state.seq.visible_elems()):
            if i >= pos:
                return acc
            acc += self._w16(e.content)
        if pos > len(self._state):
            raise IndexError(pos)
        return acc

    def insert_utf16(self, u16_pos: int, s: str) -> None:
        self.insert(self.utf16_to_unicode(u16_pos), s)

    def delete_utf16(self, u16_pos: int, u16_len: int) -> None:
        start = self.utf16_to_unicode(u16_pos)
        end = self.utf16_to_unicode(u16_pos + u16_len)
        self.delete(start, end - start)

    # -- writes -------------------------------------------------------
    def insert(self, pos: int, s: str) -> None:
        if not s:
            return
        st = self._state
        if pos > len(st):
            raise IndexError(f"insert pos {pos} > len {len(st)}")
        if st.n_anchors:
            parent, side = self._placement_with_expand(pos)
        else:
            parent, side = st.seq.placement_for_visible_pos(pos)
        self._apply(SeqInsert(parent, side, s))

    def _placement_with_expand(self, pos: int):
        """Anchor-aware placement: text typed at a mark boundary inherits
        the style iff the style's expand behavior says so (reference:
        ExpandType — "after" (default) grows past the end anchor,
        "none"/"before" does not; "before"/"both" grow before the start
        anchor).  Implemented by choosing which boundary anchors the new
        text lands after."""
        from ..utils.treap import Treap

        st = self._state
        styles = self.doc.config.text_style_config
        if pos == 0:
            a = None
            cur = st.seq.treap.first()
        else:
            a = st.seq.elem_at(pos - 1)
            assert a is not None
            cur = Treap.successor(a)
        # walk the invisible window (tombstoned chars + anchors) after the
        # left neighbor: tombstones are style-neutral and stepped over so
        # anchors beyond them still govern placement (deleting a char at
        # a mark boundary must not change expand behavior)
        while cur is not None and cur.vis_w == 0:
            if getattr(cur, "is_anchor", False) and not cur.deleted:
                anch: StyleAnchor = cur.content
                exp = styles.get(anch.key, self.doc.config.default_text_style)
                if anch.is_start:
                    # range starts here: typing before it inherits only
                    # for expand "before"/"both" -> step inside
                    advance = exp in ("before", "both")
                else:
                    # range ends here: typing after inherits for
                    # "after"/"both" -> stay inside (before the anchor)
                    advance = exp in ("none", "before")
                if not advance:
                    break
            a = cur
            cur = Treap.successor(cur)
        if a is None:
            f = st.seq.treap.first()
            if f is None:
                return None, Side.Right
            return f.id, Side.Left
        return st.seq._placement_after(a)

    def delete(self, pos: int, length: int) -> None:
        if length <= 0:
            return
        if pos + length > len(self._state):
            raise IndexError(f"delete [{pos},{pos+length}) > len {len(self._state)}")
        spans = self._state.seq.id_range_of_visible(pos, length)
        self._apply(SeqDelete(tuple(spans)))

    def push(self, s: str) -> None:
        self.insert(len(self._state), s)

    def mark(self, start: int, end: int, key: str, value: Any) -> None:
        """Style [start, end) with key=value.  Emits a start anchor at
        `start` and an end anchor after `end-1` as two consecutive ops
        (ids (p,c) and (p,c+1) — the pairing invariant TextState relies
        on)."""
        if end <= start:
            return
        st = self._state
        if end > len(st):
            raise IndexError(f"mark [{start},{end}) > len {len(st)}")
        parent, side = st.seq.placement_for_visible_pos(start)
        c1 = self._apply(SeqInsert(parent, side, StyleAnchor(key, value, True)))
        last_char = st.seq.elem_at(end - 1)
        assert last_char is not None
        parent2, side2 = st.seq.placement_after_elem(last_char.id)
        self._apply(SeqInsert(parent2, side2, StyleAnchor(key, value, False)))

    def unmark(self, start: int, end: int, key: str) -> None:
        self.mark(start, end, key, None)

    def splice(self, pos: int, length: int, replacement: str = "") -> str:
        """Delete [pos, pos+length) and insert `replacement` there;
        returns the removed text (reference: Text::splice)."""
        removed = self.to_string()[pos : pos + length]
        if length:
            self.delete(pos, length)
        if replacement:
            self.insert(pos, replacement)
        return removed

    def is_empty(self) -> bool:
        return len(self._state) == 0

    def update(self, new_text: str) -> None:
        """Minimal-diff update (reference: handler/text_update.rs Myers)."""
        old = self.to_string()
        if old == new_text:
            return
        sm = difflib.SequenceMatcher(a=old, b=new_text, autojunk=False)
        # apply right-to-left so positions stay valid
        ops = [op for op in sm.get_opcodes() if op[0] != "equal"]
        for tag, i1, i2, j1, j2 in reversed(ops):
            if tag in ("replace", "delete"):
                self.delete(i1, i2 - i1)
            if tag in ("replace", "insert"):
                self.insert(i1, new_text[j1:j2])

    def update_by_line(self, new_text: str) -> None:
        """Line-granular minimal-diff update (reference:
        Text::update_by_line) — cheaper than char-level Myers on large
        texts and keeps whole-line edits as single splices."""
        old_lines = self.to_string().splitlines(keepends=True)
        new_lines = new_text.splitlines(keepends=True)
        if old_lines == new_lines:
            return
        starts = [0]
        for ln in old_lines:
            starts.append(starts[-1] + len(ln))
        sm = difflib.SequenceMatcher(a=old_lines, b=new_lines, autojunk=False)
        ops = [op for op in sm.get_opcodes() if op[0] != "equal"]
        for tag, i1, i2, j1, j2 in reversed(ops):
            if tag in ("replace", "delete"):
                self.delete(starts[i1], starts[i2] - starts[i1])
            if tag in ("replace", "insert"):
                self.insert(starts[i1], "".join(new_lines[j1:j2]))

    # -- quill-style deltas (reference: Text::to_delta / apply_delta /
    # slice_delta) ----------------------------------------------------
    def to_delta(self) -> List[dict]:
        """Styled segments as quill-style ops: [{"insert": str,
        "attributes": {...}?}, ...]."""
        out = []
        for seg in self.get_richtext_value():
            item = {"insert": seg["insert"]}
            if seg.get("attributes"):
                item["attributes"] = dict(seg["attributes"])
            out.append(item)
        return out

    def slice_delta(self, start: int, end: int) -> List[dict]:
        """to_delta() restricted to the unicode range [start, end)."""
        out: List[dict] = []
        pos = 0
        for seg in self.to_delta():
            s = seg["insert"]
            seg_start, seg_end = pos, pos + len(s)
            pos = seg_end
            lo, hi = max(seg_start, start), min(seg_end, end)
            if lo >= hi:
                continue
            item = {"insert": s[lo - seg_start : hi - seg_start]}
            if seg.get("attributes"):
                item["attributes"] = dict(seg["attributes"])
            out.append(item)
        return out

    def apply_delta(self, items: List[dict]) -> None:
        """Apply a quill-style delta: [{"retain": n, "attributes"?},
        {"insert": s, "attributes"?}, {"delete": n}] (reference:
        Text::apply_delta)."""
        pos = 0
        for it in items:
            if "retain" in it:
                n = it["retain"]
                attrs = it.get("attributes") or {}
                for k, v in attrs.items():
                    if v is None:
                        self.unmark(pos, pos + n, k)
                    else:
                        self.mark(pos, pos + n, k, v)
                pos += n
            elif "insert" in it:
                s = it["insert"]
                self.insert(pos, s)
                # the delta's attributes are authoritative for inserted
                # text: neutralize styles inherited from surrounding
                # anchor pairs too (same contract as doc.apply_diff)
                st = self._state
                elem = st.seq.elem_at(pos)
                inherited = (
                    st._styles_at_elem(elem)
                    if (st.n_anchors and elem is not None)
                    else {}
                )
                target = {
                    k: v for k, v in (it.get("attributes") or {}).items() if v is not None
                }
                for k in set(inherited) | set(target):
                    tv = target.get(k)
                    if tv is None:
                        self.unmark(pos, pos + len(s), k)
                    elif inherited.get(k) != tv:
                        self.mark(pos, pos + len(s), k, tv)
                pos += len(s)
            elif "delete" in it:
                self.delete(pos, it["delete"])

    # -- utf8 index space (reference tracks unicode/utf16/utf8 lengths
    # per rope node) ---------------------------------------------------
    def len_utf8(self) -> int:
        return self._width_len(self._w8)

    def utf8_to_unicode(self, b: int) -> int:
        return self._offset_to_unicode(b, self._w8, "utf8")

    def insert_utf8(self, b_pos: int, s: str) -> None:
        self.insert(self.utf8_to_unicode(b_pos), s)

    def delete_utf8(self, b_pos: int, b_len: int) -> None:
        start = self.utf8_to_unicode(b_pos)
        end = self.utf8_to_unicode(b_pos + b_len)
        self.delete(start, end - start)

    def mark_utf8(self, b_start: int, b_end: int, key: str, value: Any) -> None:
        self.mark(self.utf8_to_unicode(b_start), self.utf8_to_unicode(b_end), key, value)

    # -- utf16 mark/slice/splice (JS interop) -------------------------
    def mark_utf16(self, u_start: int, u_end: int, key: str, value: Any) -> None:
        self.mark(self.utf16_to_unicode(u_start), self.utf16_to_unicode(u_end), key, value)

    def unmark_utf16(self, u_start: int, u_end: int, key: str) -> None:
        self.mark_utf16(u_start, u_end, key, None)

    def slice_utf16(self, u_start: int, u_end: int) -> str:
        return self.slice(self.utf16_to_unicode(u_start), self.utf16_to_unicode(u_end))

    def splice_utf16(self, u_pos: int, u_len: int, replacement: str = "") -> str:
        start = self.utf16_to_unicode(u_pos)
        end = self.utf16_to_unicode(u_pos + u_len)
        return self.splice(start, end - start, replacement)

    def get_id_at(self, pos: int) -> Optional[ID]:
        """Op id of the character at unicode position `pos` (reference:
        Text::get_id_at / get_editor_at_unicode_pos)."""
        e = self._state.seq.elem_at(pos)
        return e.id if e is not None else None

    def get_editor_at_unicode_pos(self, pos: int) -> Optional[int]:
        e = self._state.seq.elem_at(pos)
        return e.peer if e is not None else None

    @property
    def len_unicode(self) -> int:
        """reference: LoroText::len_unicode."""
        return len(self)

    def push_str(self, s: str) -> None:
        """reference: LoroText::push_str."""
        self.push(s)

    def convert_pos(self, index: int, from_type: str, to_type: str) -> Optional[int]:
        """Convert a position between coordinate systems ("unicode",
        "utf16", "bytes", "event"); None when out of bounds (reference:
        LoroText::convert_pos / cursor::PosType — Event == Unicode
        without the wasm feature)."""

        def norm(t: str) -> str:
            t = t.lower()
            if t == "event":
                return "unicode"
            if t not in ("unicode", "utf16", "bytes"):
                raise LoroError(f"unsupported position type {t!r}")
            return t

        from_type, to_type = norm(from_type), norm(to_type)
        if index < 0:
            return None
        try:
            if from_type == "unicode":
                uni = index
            elif from_type == "utf16":
                uni = self.utf16_to_unicode(index)
            else:
                uni = self.utf8_to_unicode(index)
            if uni > len(self):
                return None
            if to_type == "unicode":
                return uni
            if to_type == "utf16":
                return self.unicode_to_utf16(uni)
            return len(self.slice(0, uni).encode("utf-8"))
        except (IndexError, ValueError):
            return None


class ListHandler(Handler):
    CT = ContainerType.List

    def __len__(self) -> int:
        return len(self._state)

    @property
    def length(self) -> int:
        return len(self._state)

    def get(self, index: int):
        v = self._state.get(index)
        if isinstance(v, ContainerID):
            return self._child_handler(v)
        return v

    def insert(self, pos: int, *values: Any) -> None:
        if not values:
            return
        if pos > len(self._state):
            raise IndexError(f"insert pos {pos} > len {len(self._state)}")
        for v in values:
            validate_value(v)
        parent, side = self._state.seq.placement_for_visible_pos(pos)
        self._apply(SeqInsert(parent, side, tuple(values)))

    def push(self, *values: Any) -> None:
        self.insert(len(self._state), *values)

    def delete(self, pos: int, length: int) -> None:
        if length <= 0:
            return
        if pos + length > len(self._state):
            raise IndexError(f"delete [{pos},{pos+length}) > len {len(self._state)}")
        spans = self._state.seq.id_range_of_visible(pos, length)
        self._apply(SeqDelete(tuple(spans)))

    def insert_container(self, pos: int, ctype: ContainerType) -> Handler:
        parent, side = self._state.seq.placement_for_visible_pos(pos)
        # op counter == element id == child container id
        marker = _ChildMarker(ctype)
        counter = self._apply(SeqInsert(parent, side, (marker,)))
        cid = marker.cid
        assert cid is not None
        return self._child_handler(cid)

    def push_container(self, ctype: ContainerType) -> Handler:
        return self.insert_container(len(self._state), ctype)

    def pop(self):
        """Remove and return the last value (reference: List::pop)."""
        n = len(self._state)
        if n == 0:
            return None
        v = self._state.get(n - 1)
        self.delete(n - 1, 1)
        return v

    def clear(self) -> None:
        if len(self._state):
            self.delete(0, len(self._state))

    def is_empty(self) -> bool:
        return len(self._state) == 0

    def to_vec(self) -> List[Any]:
        return self.get_value()

    def get_id_at(self, pos: int) -> Optional[ID]:
        """Op id of the element at `pos` (reference: LoroList::get_id_at)."""
        e = self._state.seq.elem_at(pos)
        return e.id if e is not None else None

    def get_creator_at(self, pos: int) -> Optional[int]:
        """Peer that inserted the element at `pos` (reference:
        LoroList::get_creator_at semantics via the op id)."""
        e = self._state.seq.elem_at(pos)
        return e.peer if e is not None else None

    def __iter__(self):
        for i in range(len(self)):
            yield self.get(i)


class _ChildMarker:
    """Placeholder replaced by the real child ContainerID at txn apply
    time (the id needs the op counter, which only the txn knows)."""

    __slots__ = ("ctype", "cid")

    def __init__(self, ctype: ContainerType):
        self.ctype = ctype
        self.cid: Optional[ContainerID] = None


class MapHandler(Handler):
    CT = ContainerType.Map

    def get(self, key: str):
        entry = self._state.get_entry(key)
        if entry is None:
            return None
        if isinstance(entry.value, ContainerID):
            return self._child_handler(entry.value)
        return entry.value

    def set(self, key: str, value: Any) -> None:
        validate_value(value)
        self._apply(MapSet(key, value))

    def delete(self, key: str) -> None:
        self._apply(MapSet(key, None, deleted=True))

    def keys(self) -> List[str]:
        return sorted(self._state.get_value().keys())

    def values(self) -> List[Any]:
        v = self._state.get_value()
        return [v[k] for k in sorted(v)]

    def __len__(self) -> int:
        return len(self._state.get_value())

    def __contains__(self, key: str) -> bool:
        return self._state.get_entry(key) is not None

    def set_container(self, key: str, ctype: ContainerType) -> Handler:
        marker = _ChildMarker(ctype)
        self._apply(MapSet(key, marker))
        assert marker.cid is not None
        return self._child_handler(marker.cid)

    # -- mergeable child containers (reference: ensure_mergeable_*,
    # state/mergeable.rs) ---------------------------------------------
    def _ensure_mergeable(self, key: str, ctype: ContainerType) -> Handler:
        """Child container with a DETERMINISTIC id derived from
        (this map, key, type): concurrent first creation on different
        replicas yields the same container, so their edits merge
        instead of forking (unlike set_container, whose op-id child
        forks under concurrency).  Raises LoroError if the key already
        holds a non-mergeable value (the existing value is kept)."""
        from ..core.ids import mergeable_root_name

        cid = ContainerID.root(mergeable_root_name(self.cid, key, ctype), ctype)
        cur = self._state.entries.get(key)
        if cur is not None and not cur.deleted:
            if cur.value == cid:
                return self._child_handler(cid)
            from ..errors import LoroError

            raise LoroError(
                f"map key {key!r} already holds a non-mergeable value"
            )
        self._apply(MapSet(key, cid))
        return self._child_handler(cid)

    def ensure_mergeable_text(self, key: str):
        return self._ensure_mergeable(key, ContainerType.Text)

    def ensure_mergeable_map(self, key: str):
        return self._ensure_mergeable(key, ContainerType.Map)

    def ensure_mergeable_list(self, key: str):
        return self._ensure_mergeable(key, ContainerType.List)

    def ensure_mergeable_movable_list(self, key: str):
        return self._ensure_mergeable(key, ContainerType.MovableList)

    def ensure_mergeable_tree(self, key: str):
        return self._ensure_mergeable(key, ContainerType.Tree)

    def ensure_mergeable_counter(self, key: str):
        return self._ensure_mergeable(key, ContainerType.Counter)

    def clear(self) -> None:
        for k in self.keys():
            self.delete(k)

    def is_empty(self) -> bool:
        return len(self._state.get_value()) == 0

    def get_last_editor(self, key: str) -> Optional[int]:
        """Peer of the winning (LWW) write to `key`, including deletes;
        None for never-written keys (reference: LoroMap::get_last_editor)."""
        e = self._state.entries.get(key)
        return e.peer if e is not None else None

    def keys_iter(self):
        return iter(self.keys())

    def __iter__(self):
        return iter(self.keys())

    def get_or_create_container(self, key: str, ctype: ContainerType) -> Handler:
        """Existing child or a fresh one (reference: get_or_create)."""
        entry = self._state.get_entry(key)
        if entry is not None and isinstance(entry.value, ContainerID):
            if entry.value.ctype == ctype:
                return self._child_handler(entry.value)
        return self.set_container(key, ctype)


class MovableListHandler(Handler):
    CT = ContainerType.MovableList

    def __len__(self) -> int:
        return len(self._state)

    @property
    def length(self) -> int:
        return len(self._state)

    def get(self, index: int):
        v = self._state.get(index)
        if isinstance(v, ContainerID):
            return self._child_handler(v)
        return v

    def insert(self, pos: int, *values: Any) -> None:
        if not values:
            return
        if pos > len(self._state):
            raise IndexError(f"insert pos {pos} > len {len(self._state)}")
        for v in values:
            validate_value(v)
        parent, side = self._state.seq.placement_for_visible_pos(pos)
        self._apply(SeqInsert(parent, side, tuple(values)))

    def push(self, *values: Any) -> None:
        self.insert(len(self._state), *values)

    def delete(self, pos: int, length: int) -> None:
        if length <= 0:
            return
        if pos + length > len(self._state):
            raise IndexError(f"delete [{pos},{pos+length}) > len {len(self._state)}")
        st = self._state
        spans = []
        for i in range(pos, pos + length):
            sid = st.slot_id_at(i)
            assert sid is not None
            spans.append(sid)
        from ..core.ids import IdSpan

        rle = []
        for sid in spans:
            if rle and rle[-1].peer == sid.peer and rle[-1].end == sid.counter:
                rle[-1] = IdSpan(sid.peer, rle[-1].start, sid.counter + 1)
            else:
                rle.append(IdSpan(sid.peer, sid.counter, sid.counter + 1))
        self._apply(SeqDelete(tuple(rle)))

    def set(self, pos: int, value: Any) -> None:
        validate_value(value)
        eid = self._state.elem_id_at(pos)
        if eid is None:
            raise IndexError(pos)
        self._apply(MovableSet(eid, value))

    def move(self, from_pos: int, to_pos: int) -> None:
        """Move the element at from_pos so it ends up at to_pos
        (reference: MovableListHandler::mov)."""
        if from_pos == to_pos:
            return
        st = self._state
        eid = st.elem_id_at(from_pos)
        if eid is None:
            raise IndexError(from_pos)
        # placement computed against the list *without* the moved element:
        # target index in the post-move list maps to a boundary in the
        # current list skipping the source slot
        anchor = to_pos if to_pos < from_pos else to_pos + 1
        parent, side = st.seq.placement_for_visible_pos(anchor)
        self._apply(MovableMove(eid, parent, side))

    def to_vec(self) -> List[Any]:
        return self.get_value()

    def mov(self, from_pos: int, to_pos: int) -> None:
        self.move(from_pos, to_pos)

    def push_container(self, ctype: ContainerType) -> Handler:
        return self.insert_container(len(self._state), ctype)

    # -- element attribution (reference: MovableList::get_creator_at /
    # get_last_editor_at / get_last_mover_at) -------------------------
    def _entry_at(self, pos: int):
        slot = self._state.seq.elem_at(pos)
        if slot is None:
            return None, None
        eid = slot.content
        return eid, self._state.elems.get(eid)

    def get_creator_at(self, pos: int) -> Optional[int]:
        eid, entry = self._entry_at(pos)
        return eid.peer if eid is not None else None

    def get_last_editor_at(self, pos: int) -> Optional[int]:
        """Peer of the winning set op (or the creator when never set)."""
        eid, entry = self._entry_at(pos)
        if entry is None:
            return eid.peer if eid is not None else None
        return entry.value_key[1]

    def get_last_mover_at(self, pos: int) -> Optional[int]:
        """Peer of the winning position slot."""
        eid, entry = self._entry_at(pos)
        if entry is None:
            return None
        return entry.slot.peer

    def set_container(self, pos: int, ctype: ContainerType) -> Handler:
        eid = self._state.elem_id_at(pos)
        if eid is None:
            raise IndexError(pos)
        marker = _ChildMarker(ctype)
        self._apply(MovableSet(eid, marker))
        assert marker.cid is not None
        return self._child_handler(marker.cid)

    def insert_container(self, pos: int, ctype: ContainerType) -> Handler:
        parent, side = self._state.seq.placement_for_visible_pos(pos)
        marker = _ChildMarker(ctype)
        self._apply(SeqInsert(parent, side, (marker,)))
        assert marker.cid is not None
        return self._child_handler(marker.cid)

    def pop(self):
        n = len(self._state)
        if n == 0:
            return None
        v = self._state.get(n - 1)
        self.delete(n - 1, 1)
        return v

    def clear(self) -> None:
        if len(self._state):
            self.delete(0, len(self._state))

    def is_empty(self) -> bool:
        return len(self._state) == 0


class TreeHandler(Handler):
    CT = ContainerType.Tree

    def create(self, parent: Optional[TreeID] = None, index: Optional[int] = None) -> TreeID:
        pos = self._position_for(parent, index)
        marker = _TreeTargetMarker()
        counter = self._apply(TreeMove(marker, parent, pos, is_create=True))  # type: ignore[arg-type]
        return TreeID(self.doc.peer, counter)

    def move(self, target: TreeID, parent: Optional[TreeID], index: Optional[int] = None) -> None:
        if parent is not None and not self._state.contains(parent):
            raise ValueError(f"parent {parent} not in tree")
        pos = self._position_for(parent, index, moving=target)
        self._apply(TreeMove(target, parent, pos))

    def mov_to_root(self, target: TreeID) -> None:
        self.move(target, None)

    def delete(self, target: TreeID) -> None:
        self._apply(TreeMove(target, None, None, is_delete=True))

    def _position_for(
        self, parent: Optional[TreeID], index: Optional[int], moving: Optional[TreeID] = None
    ) -> Optional[bytes]:
        if not self.doc.config.fractional_index_enabled:
            return None
        key = self._position_key(parent, index, moving)
        jitter = self.doc.config.fractional_index_jitter
        if jitter:
            import random as _random

            key += bytes(_random.getrandbits(8) for _ in range(jitter))
        return key

    def _position_key(
        self, parent: Optional[TreeID], index: Optional[int], moving: Optional[TreeID] = None
    ) -> bytes:
        sibs = [t for t in self._state.children_of(parent) if t != moving]
        positions = [self._state.nodes[t].position for t in sibs]
        if index is None or index >= len(sibs):
            lo = positions[-1] if positions else None
            return key_between(lo, None)
        hi = positions[index]
        lo = positions[index - 1] if index > 0 else None
        if lo is not None and hi is not None and lo >= hi:
            # degenerate duplicate keys (concurrent same-position): nudge
            return key_between(lo, None)
        return key_between(lo, hi)

    # -- reads --------------------------------------------------------
    # reference aliases / sibling-relative moves ----------------------
    def create_at(self, parent: Optional[TreeID] = None, index: int = 0) -> TreeID:
        return self.create(parent, index)

    def mov(self, target: TreeID, parent: Optional[TreeID], index: Optional[int] = None) -> None:
        self.move(target, parent, index)

    def mov_to(self, target: TreeID, parent: Optional[TreeID], index: int) -> None:
        self.move(target, parent, index)

    def mov_after(self, target: TreeID, after: TreeID) -> None:
        """Place `target` as the next sibling after `after`."""
        p = self._state.parent_of(after)
        sibs = [t for t in self._state.children_of(p) if t != target]
        self.move(target, p, sibs.index(after) + 1)

    def mov_before(self, target: TreeID, before: TreeID) -> None:
        p = self._state.parent_of(before)
        sibs = [t for t in self._state.children_of(p) if t != target]
        self.move(target, p, sibs.index(before))

    def children_num(self, parent: Optional[TreeID] = None) -> int:
        return len(self._state.children_of(parent))

    def is_node_deleted(self, target: TreeID) -> bool:
        """True when the node exists but is trash-reachable (reference:
        Tree::is_node_deleted; unknown nodes raise)."""
        if target not in self._state.nodes:
            raise ValueError(f"unknown tree node {target}")
        return self._state._is_deleted(target)

    def enable_fractional_index(self, jitter: int = 0) -> None:
        """Generate fractional indexes on create/move (on by default;
        reference: Tree::enable_fractional_index).  With jitter > 0,
        keys get that many random suffix bytes so concurrent peers
        inserting into the same gap rarely collide."""
        self.doc.config.fractional_index_enabled = True
        self.doc.config.fractional_index_jitter = jitter

    def disable_fractional_index(self) -> None:
        """New moves ship no position: sibling order falls back to the
        move-key tiebreak (reference: Tree::disable_fractional_index)."""
        self.doc.config.fractional_index_enabled = False

    def is_fractional_index_enabled(self) -> bool:
        return self.doc.config.fractional_index_enabled

    def contains(self, target: TreeID) -> bool:
        return self._state.contains(target)

    def children(self, parent: Optional[TreeID] = None) -> List[TreeID]:
        return self._state.children_of(parent)

    def roots(self) -> List[TreeID]:
        return self._state.roots()

    def parent(self, target: TreeID) -> Optional[TreeID]:
        return self._state.parent_of(target)

    def get_meta(self, target: TreeID) -> MapHandler:
        if not self._state.contains(target) and target not in self._state.nodes:
            raise ValueError(f"{target} not in tree")
        return self._child_handler(self._state.meta_cid(target))  # type: ignore[return-value]

    def nodes(self) -> List[TreeID]:
        return [t for t in self._state.nodes if self._state.contains(t)]

    def fractional_index(self, target: TreeID) -> Optional[bytes]:
        n = self._state.nodes.get(target)
        return n.position if n else None

    def get_last_move_id(self, target: TreeID) -> Optional[ID]:
        """Op id of the effective (winning) move of `target`; None for
        unknown nodes (reference: LoroTree::get_last_move_id)."""
        n = self._state.nodes.get(target)
        if n is None:
            return None
        _lamport, peer, counter = n.move_key
        return ID(peer, counter)

    def get_nodes(self, with_deleted: bool = False) -> List[dict]:
        """Flat node records {id, parent, index, fractional_index}
        (reference: LoroTree::get_nodes; deleted nodes get parent=None,
        index=None)."""
        st = self._state
        out = []
        for t in st.nodes:
            alive = st.contains(t)
            if not alive and not with_deleted:
                continue
            out.append(
                {
                    "id": t,
                    "parent": st.parent_of(t) if alive else None,
                    "index": st.index_of(t) if alive else None,
                    "fractional_index": st.nodes[t].position,
                    "deleted": not alive,
                }
            )
        return out

    def get_value_with_meta(self) -> List[dict]:
        """Hierarchy values with each node's meta map resolved
        (reference: LoroTree::get_value_with_meta == deep value)."""
        return self.get_deep_value()


class _TreeTargetMarker:
    """Placeholder for a tree-create target (id = the op's own id)."""

    __slots__ = ()


class CounterHandler(Handler):
    CT = ContainerType.Counter

    def increment(self, delta: float = 1.0) -> None:
        self._apply(CounterIncr(float(delta)))

    def decrement(self, delta: float = 1.0) -> None:
        self._apply(CounterIncr(-float(delta)))

    @property
    def value(self) -> float:
        return self._state.get_value()


_HANDLER_BY_TYPE = {
    ContainerType.Text: TextHandler,
    ContainerType.List: ListHandler,
    ContainerType.Map: MapHandler,
    ContainerType.MovableList: MovableListHandler,
    ContainerType.Tree: TreeHandler,
    ContainerType.Counter: CounterHandler,
}


def make_handler(doc: "LoroDoc", cid: ContainerID) -> Handler:
    return _HANDLER_BY_TYPE[cid.ctype](doc, cid)
