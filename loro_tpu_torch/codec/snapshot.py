"""Snapshot codecs: fast snapshot + shallow snapshot + state-only.

reference: crates/loro-internal/src/encoding/fast_snapshot.rs (layout
[oplog][state][shallow-root-state]; import installs bytes directly, no
replay) and encoding/shallow_snapshot.rs (history trimmed before chosen
frontiers, frozen root state kept).

Container states serialize to compact tables: sequences dump their
element table in traversal order (rebuild is pure insert-after, no
Fugue logic), maps/trees/counters dump their entry/move tables.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ..core.change import Side, StyleAnchor
from ..core.ids import ContainerID, ContainerType, ID, TreeID
from ..models.counter_state import CounterState
from ..models.list_state import ListState
from ..models.map_state import MapEntry, MapState
from ..models.movable_list_state import ElemEntry, MovableListState
from ..models.seq_crdt import FugueSeq, SeqElem
from ..models.text_state import TextState
from ..models.tree_state import TreeState
from ..models.unknown_state import UnknownState
from .binary import Reader, Writer, _Dicts, _read_cid, _read_value, _write_cid, _write_value

S_MAP, S_SEQ, S_MOVABLE, S_TREE, S_COUNTER, S_UNKNOWN = range(6)

# bump on any incompatible state-table layout change (v2: per-element
# deleted_by records; v3: movable-list slot/set histories; v4:
# per-container byte-length table for lazy hydration)
STATE_FORMAT = 4

# element content tags for sequence states
E_CHAR, E_VALUE, E_ANCHOR, E_ELEMREF = range(4)


# ---------------------------------------------------------------------------
# per-container state encoding
# ---------------------------------------------------------------------------


def _write_seq(w: Writer, d: _Dicts, seq: FugueSeq) -> None:
    """Element table in traversal order.  parent refs use traversal
    indexes (parents always exist in the table)."""
    elems = list(seq.all_elems())
    index: Dict[Tuple[int, int], int] = {(e.peer, e.counter): i for i, e in enumerate(elems)}
    w.varint(len(elems))
    for e in elems:
        w.varint(d.peer(e.peer))
        w.zigzag(e.counter)
        w.varint(e.lamport)
        if e.fparent is None:
            w.varint(0)
        else:
            w.varint(index[(e.fparent.peer, e.fparent.counter)] + 1)
        # bit2: invisible though not deleted (movable-list stale slots)
        flags = int(e.fside) | (2 if e.deleted else 0) | (4 if e.vis_w == 0 else 0)
        w.u8(flags)
        # deletion records (version-diff visibility evaluation)
        w.varint(len(e.deleted_by))
        for did in e.deleted_by:
            w.varint(d.peer(did.peer))
            w.zigzag(did.counter)
        c = e.content
        if isinstance(c, StyleAnchor):
            w.u8(E_ANCHOR)
            w.varint(d.key(c.key))
            _write_value(w, d, c.value)
            w.u8(1 if c.is_start else 0)
            w.varint(c.info)
        elif isinstance(c, str):
            w.u8(E_CHAR)
            w.str_(c)
        elif isinstance(c, ID):
            w.u8(E_ELEMREF)
            w.varint(d.peer(c.peer))
            w.zigzag(c.counter)
        else:
            w.u8(E_VALUE)
            _write_value(w, d, c)


def _read_seq(r: Reader, peers: List[int], keys: List[str], cids: List[ContainerID]) -> FugueSeq:
    seq = FugueSeq()
    n = r.varint()
    elems: List[SeqElem] = []
    prefs: List[int] = []
    prev: Optional[SeqElem] = None
    for _ in range(n):
        peer = peers[r.varint()]
        counter = r.zigzag()
        lamport = r.varint()
        pref = r.varint()
        flags = r.u8()
        deleted_by = [ID(peers[r.varint()], r.zigzag()) for _ in range(r.varint())]
        tag = r.u8()
        if tag == E_ANCHOR:
            key = keys[r.varint()]
            value = _read_value(r, cids)
            is_start = bool(r.u8())
            info = r.varint()
            content: Any = StyleAnchor(key, value, is_start, info)
        elif tag == E_CHAR:
            content = r.str_()
        elif tag == E_ELEMREF:
            content = ID(peers[r.varint()], r.zigzag())
        else:
            content = _read_value(r, cids)
        # fparent linked in a second pass — a parent can appear *later*
        # in traversal order (L-children precede their parent)
        e = SeqElem(peer, counter, content, None, Side(flags & 1), lamport)
        e.deleted_by = deleted_by
        for x in deleted_by:
            seq.deleter_index.setdefault((x.peer, x.counter), []).append(e)
        if flags & 2:
            e.deleted = True
        invisible = bool(flags & 6) or e.is_anchor
        e.init_treap(0 if invisible else e.base_width())
        seq.treap.insert_after(prev, e)
        seq.by_id[(peer, counter)] = e
        elems.append(e)
        prefs.append(pref)
        prev = e
    for e, pref in zip(elems, prefs):
        e.fparent = elems[pref - 1] if pref else None
    # rebuild children lists (sorted by sibling key)
    for e in elems:
        if e.fparent is None:
            seq.root_children.append(e)
        elif e.fside == Side.Right:
            e.fparent.r_children.append(e)
        else:
            e.fparent.l_children.append(e)
    seq.root_children.sort(key=lambda x: x.sib_key)
    for e in elems:
        if e.l_children:
            e.l_children.sort(key=lambda x: x.sib_key)
        if e.r_children:
            e.r_children.sort(key=lambda x: x.sib_key)
    return seq


def encode_container_state(w: Writer, d: _Dicts, st) -> None:
    if isinstance(st, MapState):
        w.u8(S_MAP)
        w.varint(len(st.entries))
        for k, e in st.entries.items():
            w.varint(d.key(k))
            w.varint(e.lamport)
            w.varint(d.peer(e.peer))
            w.zigzag(e.counter)
            w.u8(1 if e.deleted else 0)
            if not e.deleted:
                _write_value(w, d, e.value)
    elif isinstance(st, (TextState, ListState)):
        w.u8(S_SEQ)
        _write_seq(w, d, st.seq)
    elif isinstance(st, MovableListState):
        w.u8(S_MOVABLE)
        _write_seq(w, d, st.seq)
        w.varint(len(st.elems))
        for eid, entry in st.elems.items():
            w.varint(d.peer(eid.peer))
            w.zigzag(eid.counter)
            _write_value(w, d, entry.value)
            w.varint(entry.value_key[0])
            w.varint(d.peer(entry.value_key[1]))
            w.varint(entry.pos_key[0])
            w.varint(d.peer(entry.pos_key[1]))
            w.varint(d.peer(entry.slot.peer))
            w.zigzag(entry.slot.counter)
            w.u8(1 if entry.deleted else 0)
            w.varint(len(entry.slots))
            for sid in entry.slots:
                w.varint(d.peer(sid.peer))
                w.zigzag(sid.counter)
            w.varint(len(entry.sets))
            for lam, sp, oid, val in entry.sets:
                w.varint(lam)
                w.varint(d.peer(sp))
                w.varint(d.peer(oid.peer))
                w.zigzag(oid.counter)
                _write_value(w, d, val)
    elif isinstance(st, TreeState):
        w.u8(S_TREE)
        w.varint(len(st.moves))
        for (lam, peer, ctr), mv in st.moves:
            w.varint(lam)
            w.varint(d.peer(peer))
            w.zigzag(ctr)
            w.varint(d.peer(mv.target.peer))
            w.zigzag(mv.target.counter)
            flags = (
                (1 if mv.is_create else 0)
                | (2 if mv.is_delete else 0)
                | (4 if mv.parent is not None else 0)
                | (8 if mv.position is not None else 0)
            )
            w.u8(flags)
            if mv.parent is not None:
                w.varint(d.peer(mv.parent.peer))
                w.zigzag(mv.parent.counter)
            if mv.position is not None:
                w.bytes_(mv.position)
    elif isinstance(st, CounterState):
        w.u8(S_COUNTER)
        w.f64(st.value)
    elif isinstance(st, UnknownState):
        w.u8(S_UNKNOWN)
        w.varint(0)
    else:  # pragma: no cover
        raise TypeError(f"cannot snapshot state {type(st)}")


def decode_container_state(
    r: Reader, cid: ContainerID, peers: List[int], keys: List[str], cids: List[ContainerID]
):
    from ..core.change import TreeMove

    tag = r.u8()
    if tag == S_MAP:
        st = MapState(cid)
        for _ in range(r.varint()):
            k = keys[r.varint()]
            lam = r.varint()
            peer = peers[r.varint()]
            ctr = r.zigzag()
            deleted = bool(r.u8())
            value = None if deleted else _read_value(r, cids)
            st.entries[k] = MapEntry(value, lam, peer, ctr, deleted)
        return st
    if tag == S_SEQ:
        st = TextState(cid) if cid.ctype == ContainerType.Text else ListState(cid)
        st.seq = _read_seq(r, peers, keys, cids)
        if isinstance(st, TextState):
            st.n_anchors = sum(1 for e in st.seq.all_elems() if e.is_anchor)
        return st
    if tag == S_MOVABLE:
        st = MovableListState(cid)
        st.seq = _read_seq(r, peers, keys, cids)
        for _ in range(r.varint()):
            eid = ID(peers[r.varint()], r.zigzag())
            value = _read_value(r, cids)
            vk = (r.varint(), peers[r.varint()])
            pk = (r.varint(), peers[r.varint()])
            slot = ID(peers[r.varint()], r.zigzag())
            entry = ElemEntry(value, vk, pk, slot)
            entry.deleted = bool(r.u8())
            entry.slots = [ID(peers[r.varint()], r.zigzag()) for _ in range(r.varint())]
            entry.sets = [
                (r.varint(), peers[r.varint()], ID(peers[r.varint()], r.zigzag()), _read_value(r, cids))
                for _ in range(r.varint())
            ]
            st.elems[eid] = entry
        return st
    if tag == S_TREE:
        st = TreeState(cid)
        for _ in range(r.varint()):
            lam = r.varint()
            peer = peers[r.varint()]
            ctr = r.zigzag()
            target = TreeID(peers[r.varint()], r.zigzag())
            flags = r.u8()
            parent = TreeID(peers[r.varint()], r.zigzag()) if flags & 4 else None
            position = r.bytes_() if flags & 8 else None
            st.moves.append(
                ((lam, peer, ctr), TreeMove(target, parent, position, bool(flags & 1), bool(flags & 2)))
            )
        st._replay_all()
        return st
    if tag == S_COUNTER:
        st = CounterState(cid)
        st.value = r.f64()
        return st
    if tag == S_UNKNOWN:
        r.varint()
        return UnknownState(cid)
    raise ValueError(f"bad state tag {tag}")


# ---------------------------------------------------------------------------
# doc-level snapshot
# ---------------------------------------------------------------------------


def encode_doc_state(doc_state, parents: Dict) -> bytes:
    """Serialize a whole DocState (tables emitted after scratch so value
    cid refs register first — same trap as binary.encode_changes)."""
    d = _Dicts()
    scratch = Writer()
    # read-created ghost states (materialized=False) must not ship: the
    # importer would hydrate them as real empty roots and diverge from
    # replicas that never read them
    items = sorted(
        (kv for kv in doc_state.states.items() if kv[1].materialized),
        key=lambda kv: kv[0]._key(),
    )
    for cid, st in items:
        d.cid(cid)
    seg_lens = []
    for cid, st in items:
        before = len(scratch.buf)
        encode_container_state(scratch, d, st)
        seg_lens.append(len(scratch.buf) - before)
    # parent links (for event paths after fast import)
    pw = Writer()
    links = [(c, p, k) for c, (p, k) in parents.items()]
    pw.varint(len(links))
    for c, p, k in links:
        pw.varint(d.cid(c))
        pw.varint(d.cid(p))
        if isinstance(k, str):
            pw.u8(0)
            pw.varint(d.key(k))
        elif isinstance(k, ID):
            pw.u8(1)
            pw.varint(d.peer(k.peer))
            pw.zigzag(k.counter)
        else:
            pw.u8(2)
    for c in d.cids:
        if not c.is_root:
            d.peer(c.peer)  # type: ignore[arg-type]

    w = Writer()
    w.u8(STATE_FORMAT)
    w.varint(len(d.peers))
    for p in d.peers:
        w.u64le(p)
    w.varint(len(d.keys))
    for k in d.keys:
        w.str_(k)
    w.varint(len(d.cids))
    for c in d.cids:
        _write_cid(w, d.peer, c)
    w.varint(len(items))
    for cid, _ in items:
        w.varint(d.cid(cid))
    # per-container byte lengths: lets the decoder hydrate containers
    # lazily (reference: container_store.rs per-container kv entries)
    for n in seg_lens:
        w.varint(n)
    w.buf += scratch.buf
    w.buf += pw.buf
    return bytes(w.buf)


def decode_doc_state(buf: bytes):
    """Returns (states, parents).  `states` is a StateTable whose
    container payloads decode on first access — importing a snapshot
    with many containers touches none of them until read (reference:
    container_store.rs lazy per-container entries).  Deferred decode
    failures surface as typed DecodeError at the read site (same
    contract as the change store's lazy blocks)."""
    from ..state import StateTable

    r = Reader(buf)
    fmt = r.u8()
    if fmt != STATE_FORMAT:
        raise ValueError(f"unsupported snapshot state format {fmt} (want {STATE_FORMAT})")
    peers = [r.u64le() for _ in range(r.varint())]
    keys = [r.str_() for _ in range(r.varint())]
    cids = [_read_cid(r, peers) for _ in range(r.varint())]
    order = [cids[r.varint()] for _ in range(r.varint())]
    seg_lens = [r.varint() for _ in range(len(order))]
    states = StateTable()
    for cid, ln in zip(order, seg_lens):
        if r.i + ln > len(buf):
            raise ValueError("truncated container state segment")
        seg = buf[r.i : r.i + ln]
        r.i += ln

        def thunk(seg=seg, cid=cid):
            rr = Reader(seg)
            return decode_container_state(rr, cid, peers, keys, cids)

        states.put_cold(cid, thunk)
    parents = {}
    for _ in range(r.varint()):
        c = cids[r.varint()]
        p = cids[r.varint()]
        t = r.u8()
        if t == 0:
            k: Any = keys[r.varint()]
        elif t == 1:
            k = ID(peers[r.varint()], r.zigzag())
        else:
            k = None
        parents[c] = (p, k)
    return states, parents
