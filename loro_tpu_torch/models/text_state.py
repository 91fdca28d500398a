"""Rich-text container state over FugueSeq.

reference: crates/loro-internal/src/state/richtext_state.rs +
container/richtext/ (Fugue tracker, style_range_map).  Characters and
Peritext-style anchors live in one Fugue sequence; a style anchor pair
(start at id (p,c), end at id (p,c+1) — handler invariant) spans the
elements between them, and per style key the winning pair covering a
char is the one with max (lamport, peer).  Unmark = a pair with value
None.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ..core.change import Op, SeqDelete, SeqInsert, StyleAnchor
from ..core.ids import ContainerID, ID
from ..event import Delta, Diff
from .base import ContainerState
from .list_state import _resolve_run_cont
from .seq_crdt import FugueSeq, SeqElem


class TextState(ContainerState):
    def __init__(self, cid: ContainerID):
        super().__init__(cid)
        self.seq = FugueSeq()
        self.n_anchors = 0  # fast path: style scans skipped when 0

    # -- op application ----------------------------------------------
    def apply_op(self, op: Op, peer: int, lamport: int, record: bool = True) -> Optional[Diff]:
        c = op.content
        if isinstance(c, SeqInsert):
            parent = _resolve_run_cont(c.parent, peer, op.counter)
            if isinstance(c.content, StyleAnchor):
                self.seq.integrate_insert(
                    peer, op.counter, parent, c.side, [c.content], lamport, compute_pos=False
                )
                self.n_anchors += 1
                # anchors are invisible; the style change event is the
                # attribute delta over the covered visible range
                return self._style_event_for_anchor(peer, op.counter) if record else None
            pos, _ = self.seq.integrate_insert(
                peer, op.counter, parent, c.side, c.content, lamport, compute_pos=record
            )
            if not record:
                return None
            attrs = (
                self._styles_at_elem(self.seq.by_id[(peer, op.counter)]) if self.n_anchors else {}
            )
            return Delta().retain(pos).insert(c.content, attrs or None)
        assert isinstance(c, SeqDelete)
        removed = self.seq.integrate_delete(
            c.spans, deleter=ID(peer, op.counter), compute_pos=record
        )
        if not removed:
            return None
        out = Delta()
        for pos, ln in removed:
            out = out.compose(Delta().retain(pos).delete(ln))
        return out

    # -- queries ------------------------------------------------------
    def get_value(self) -> str:
        return "".join(e.content for e in self.seq.visible_elems())

    def __len__(self) -> int:
        return self.seq.visible_len

    def _iter_char_attrs(self, anchor_live, char_live):
        """Single shared anchor walk (pairing via the (peer, counter+1)
        invariant): yields (elem, attrs) for every char passing
        `char_live`, with `anchor_live` filtering which anchors count.
        Backs both the live render and version-filtered diffs."""
        active: Dict[str, list] = {}
        for e in self.seq.all_elems():
            if isinstance(e.content, StyleAnchor):
                if not anchor_live(e):
                    continue
                a: StyleAnchor = e.content
                if a.is_start:
                    active.setdefault(a.key, []).append((e.lamport, e.peer, a.value, e.counter))
                else:
                    lst = active.get(a.key)
                    if lst:
                        # remove the entry whose start anchor is (peer, counter-1)
                        for i, ent in enumerate(lst):
                            if ent[1] == e.peer and ent[3] == e.counter - 1:
                                lst.pop(i)
                                break
                continue
            if char_live(e):
                yield e, _resolve_attrs(active)

    def get_richtext_value(self) -> List[dict]:
        """Quill-style segments [{insert, attributes?}] with resolved
        styles (reference: richtext_state get_richtext_value)."""
        segs: List[dict] = []
        for e, attrs in self._iter_char_attrs(
            lambda a: not a.deleted, lambda c: bool(c.vis_w)
        ):
            attrs = attrs or None
            if segs and segs[-1].get("attributes") == attrs:
                segs[-1]["insert"] += e.content
            else:
                seg: dict = {"insert": e.content}
                if attrs:
                    seg["attributes"] = attrs
                segs.append(seg)
        return segs

    def _styles_at_elem(self, elem: SeqElem) -> Dict[str, Any]:
        """Resolved style attributes covering `elem` (scan; fine for host
        path — bulk style resolution is a device kernel)."""
        active: Dict[str, List[Tuple[int, int, Any, int]]] = {}
        for e in self.seq.all_elems():
            if e is elem:
                break
            if isinstance(e.content, StyleAnchor) and not e.deleted:
                a: StyleAnchor = e.content
                if a.is_start:
                    active.setdefault(a.key, []).append((e.lamport, e.peer, a.value, e.counter))
                else:
                    lst = active.get(a.key)
                    if lst:
                        for i, ent in enumerate(lst):
                            if ent[1] == e.peer and ent[3] == e.counter - 1:
                                lst.pop(i)
                                break
        return _resolve_attrs(active)

    def _style_event_for_anchor(self, peer: int, counter: int) -> Optional[Diff]:
        """Attribute-retain delta for the range covered by the anchor pair
        whose start or end is (peer, counter)."""
        e = self.seq.by_id.get((peer, counter))
        if e is None or not isinstance(e.content, StyleAnchor):
            return None
        a: StyleAnchor = e.content
        if a.is_start:
            start_e = e
            end_e = self.seq.by_id.get((peer, counter + 1))
        else:
            end_e = e
            start_e = self.seq.by_id.get((peer, counter - 1))
        if start_e is None or end_e is None:
            return None  # pair incomplete (end arrives next op)
        s = self.seq.treap.visible_rank(start_e)
        t = self.seq.treap.visible_rank(end_e)
        if t <= s:
            return None
        return Delta().retain(s).retain(t - s, {a.key: a.value})

    def to_diff(self) -> Diff:
        d = Delta()
        for seg in self.get_richtext_value():
            d.insert(seg["insert"], seg.get("attributes"))
        return d

    # -- style-aware version diffs -------------------------------------
    def _attrs_stream_at(self, v):
        """(elem, attrs) for every char VISIBLE at version v — the
        shared walk with version-filtered liveness predicates."""

        from .seq_crdt import visible_at

        def live(e):
            return visible_at(e, v)

        return self._iter_char_attrs(live, live)

    def styled_delta_between(self, va, vb) -> Delta:
        """Exact element-identity delta INCLUDING attribute changes:
        chars kept in both versions whose resolved styles differ emit
        attribute retains ({key: new-or-None}); inserts carry their
        vb-side attributes."""
        a_attrs = {(e.peer, e.counter): attrs for e, attrs in self._attrs_stream_at(va)}
        b_attrs = {(e.peer, e.counter): attrs for e, attrs in self._attrs_stream_at(vb)}
        d = Delta()
        for e in self.seq.all_elems():
            if isinstance(e.content, StyleAnchor):
                continue
            key = (e.peer, e.counter)
            in_a = key in a_attrs
            in_b = key in b_attrs
            if in_a and in_b:
                aa = a_attrs[key]
                bb = b_attrs[key]
                if aa == bb:
                    d.retain(1)
                else:
                    change = {k: bb.get(k) for k in set(aa) | set(bb) if aa.get(k) != bb.get(k)}
                    d.retain(1, change)
            elif in_a:
                d.delete(1)
            elif in_b:
                d.insert(e.content, b_attrs[key] or None)
        return d.chop()


def _resolve_attrs(active: Dict[str, List[Tuple]]) -> Dict[str, Any]:
    """Per key: LWW winner among active pairs; None value = unstyled."""
    out: Dict[str, Any] = {}
    for k, lst in active.items():
        if not lst:
            continue
        win = max(lst, key=lambda t: (t[0], t[1]))
        if win[2] is not None:
            out[k] = win[2]
    return out
