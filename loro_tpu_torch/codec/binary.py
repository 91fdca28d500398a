"""The binary updates payload: the port's copy of loro_tpu/codec/binary.py
(its decoder and encoder).

Layout (after the doc-level envelope, which is not handled here):
  [peer table]   varint n, then n u64 LE peer ids (ops name peers by
                 their index in this table)
  [key table]    varint n, n length-prefixed utf8 strings
  [cid table]    varint n, n encoded ContainerIDs
  [change meta]  varint n_changes, then per change: peer index (varint),
                 counter (zigzag), lamport (zigzag), timestamp delta
                 (zigzag), n_deps + deps (peer index, zigzag counter),
                 message (tag + utf8), n_ops
  [ops]          per change, per op: container index varint, kind byte,
                 kind-specific payload

read_tables parses the prelude dictionaries (the native explode parses
the rest).  decode_changes decodes a whole payload, every op kind and
value tag, into Change objects (core/change.py); encode_changes is its
inverse, byte for byte what the JAX package's encode_changes writes for
the same changes.  encode_text_changes writes the same bytes for text
changes given as plain tuples (the text traces' form).
"""
from __future__ import annotations

import struct
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

from ..core.change import (
    _RUN_CONT,
    Change,
    CounterIncr,
    MapSet,
    MovableMove,
    MovableSet,
    Op,
    SeqDelete,
    SeqInsert,
    Side,
    StyleAnchor,
    TreeMove,
    UnknownContent,
    _RunCont,
)
from ..core.ids import ID, ContainerID, ContainerType, IdSpan, TreeID
from ..core.version import Frontiers
from ..errors import CodecDecodeError

# op kind tags
K_MAP_SET = 0
K_MAP_DEL = 1
K_INSERT_TEXT = 2
K_INSERT_VALUES = 3
K_INSERT_ANCHOR = 4
K_DELETE = 5
K_TREE = 6
K_COUNTER = 7
K_MSET = 8
K_MMOVE = 9
K_UNKNOWN = 10

# value tags
VNULL, VTRUE, VFALSE, VINT, VF64, VSTR, VBYTES, VLIST, VMAP, VCID = range(10)

# parent encoding of a sequence insert: none (the root), an id, or the
# previous counter of the op's own peer
PT_NONE, PT_ID, RUN_CONT_TAG = 0, 1, 2


class Writer:
    __slots__ = ("buf",)

    def __init__(self) -> None:
        self.buf = bytearray()

    def u8(self, v: int) -> None:
        self.buf.append(v & 0xFF)

    def varint(self, v: int) -> None:
        """LEB128 unsigned."""
        if v < 0:
            raise ValueError(f"varint of a negative value {v}")
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                self.buf.append(b | 0x80)
            else:
                self.buf.append(b)
                return

    def zigzag(self, v: int) -> None:
        self.varint((v << 1) ^ (v >> 63) if v >= 0 else ((-v) << 1) - 1)

    def u64le(self, v: int) -> None:
        self.buf += struct.pack("<Q", v)

    def u32le(self, v: int) -> None:
        self.buf += struct.pack("<I", v)

    def f64(self, v: float) -> None:
        self.buf += struct.pack("<d", v)

    def bytes_(self, b: bytes) -> None:
        self.varint(len(b))
        self.buf += b

    def str_(self, s: str) -> None:
        self.bytes_(s.encode())


class Reader:
    __slots__ = ("buf", "i")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.i = 0

    def u8(self) -> int:
        v = self.buf[self.i]
        self.i += 1
        return v

    def varint(self) -> int:
        v = 0
        shift = 0
        while True:
            b = self.buf[self.i]
            self.i += 1
            v |= (b & 0x7F) << shift
            if not (b & 0x80):
                return v
            shift += 7
            if shift > 70:
                raise ValueError("varint overflow")

    def zigzag(self) -> int:
        v = self.varint()
        return (v >> 1) if not (v & 1) else -((v + 1) >> 1)

    def u64le(self) -> int:
        v = struct.unpack_from("<Q", self.buf, self.i)[0]
        self.i += 8
        return v

    def u32le(self) -> int:
        v = struct.unpack_from("<I", self.buf, self.i)[0]
        self.i += 4
        return v

    def f64(self) -> float:
        v = struct.unpack_from("<d", self.buf, self.i)[0]
        self.i += 8
        return v

    def bytes_(self) -> bytes:
        n = self.varint()
        if self.i + n > len(self.buf):
            raise ValueError("truncated bytes")
        b = self.buf[self.i : self.i + n]
        self.i += n
        return bytes(b)

    def str_(self) -> str:
        return self.bytes_().decode()

    def eof(self) -> bool:
        return self.i >= len(self.buf)


class _Dicts:
    """Encoding dictionaries (the peer, key and container tables),
    indexes in first-use order."""

    def __init__(self) -> None:
        self.peers: List[int] = []
        self._peer_idx: Dict[int, int] = {}
        self.keys: List[str] = []
        self._key_idx: Dict[str, int] = {}
        self.cids: List[ContainerID] = []
        self._cid_idx: Dict[ContainerID, int] = {}

    def peer(self, p: int) -> int:
        i = self._peer_idx.get(p)
        if i is None:
            i = len(self.peers)
            self.peers.append(p)
            self._peer_idx[p] = i
        return i

    def key(self, k: str) -> int:
        i = self._key_idx.get(k)
        if i is None:
            i = len(self.keys)
            self.keys.append(k)
            self._key_idx[k] = i
        return i

    def cid(self, c: ContainerID) -> int:
        i = self._cid_idx.get(c)
        if i is None:
            i = len(self.cids)
            self.cids.append(c)
            self._cid_idx[c] = i
        return i


def _write_value(w: Writer, d: _Dicts, v: Any) -> None:
    """One tagged value, the inverse of _read_value (dict keys sorted;
    a ContainerID by its index in d's container table)."""
    if v is None:
        w.u8(VNULL)
    elif v is True:
        w.u8(VTRUE)
    elif v is False:
        w.u8(VFALSE)
    elif isinstance(v, int):
        w.u8(VINT)
        w.zigzag(v)
    elif isinstance(v, float):
        w.u8(VF64)
        w.f64(v)
    elif isinstance(v, str):
        w.u8(VSTR)
        w.str_(v)
    elif isinstance(v, bytes):
        w.u8(VBYTES)
        w.bytes_(v)
    elif isinstance(v, (list, tuple)):
        w.u8(VLIST)
        w.varint(len(v))
        for x in v:
            _write_value(w, d, x)
    elif isinstance(v, dict):
        w.u8(VMAP)
        w.varint(len(v))
        for k in sorted(v):
            w.str_(k)
            _write_value(w, d, v[k])
    elif isinstance(v, ContainerID):
        w.u8(VCID)
        w.varint(d.cid(v))
    else:
        raise TypeError(f"cannot encode value {type(v)}")


def _write_cid(w: Writer, peer_index, c: ContainerID) -> None:
    if c.is_root:
        w.u8(int(c.ctype) | 0x80)
        w.str_(c.name)
    else:
        w.u8(int(c.ctype))
        w.varint(peer_index(c.peer))
        w.zigzag(c.counter)


def _read_cid(r: Reader, peers: List[int]) -> ContainerID:
    b = r.u8()
    ctype = ContainerType(b & 0x7F)
    if b & 0x80:
        return ContainerID.root(r.str_(), ctype)
    pi = r.varint()
    if pi >= len(peers):
        raise ValueError(f"cid peer index {pi} out of table ({len(peers)} peers)")
    return ContainerID.normal(peers[pi], r.zigzag(), ctype)


def read_tables(buf: bytes):
    """Parse the payload prelude dictionaries: (peers, keys, cids,
    reader positioned after the tables).  Truncated or corrupt preludes
    raise CodecDecodeError."""
    r = Reader(buf)
    try:
        peers = [r.u64le() for _ in range(r.varint())]
        keys = [r.str_() for _ in range(r.varint())]
        cids = [_read_cid(r, peers) for _ in range(r.varint())]
    except (IndexError, struct.error, UnicodeDecodeError, ValueError, OverflowError) as e:
        raise CodecDecodeError(f"malformed payload tables ({type(e).__name__}: {e})") from e
    return peers, keys, cids, r


# ---- decoder -------------------------------------------------------------------


def _read_value(r: Reader, cids: List[ContainerID]) -> Any:
    t = r.u8()
    if t == VNULL:
        return None
    if t == VTRUE:
        return True
    if t == VFALSE:
        return False
    if t == VINT:
        return r.zigzag()
    if t == VF64:
        return r.f64()
    if t == VSTR:
        return r.str_()
    if t == VBYTES:
        return r.bytes_()
    if t == VLIST:
        return [_read_value(r, cids) for _ in range(r.varint())]
    if t == VMAP:
        return {r.str_(): _read_value(r, cids) for _ in range(r.varint())}
    if t == VCID:
        return cids[r.varint()]
    raise ValueError(f"bad value tag {t}")


def _read_parent(r: Reader, peers: List[int]):
    t = r.u8()
    if t == PT_NONE:
        return None
    if t == RUN_CONT_TAG:
        return _RUN_CONT
    return ID(peers[r.varint()], r.zigzag())


def decode_changes(buf: bytes) -> List[Change]:
    """Decode a bare (envelope-stripped) updates payload into its
    changes, every op of every container.  Truncated or bit-flipped
    input raises CodecDecodeError (a ValueError), never an IndexError
    or struct.error from the reader."""
    try:
        return _decode_changes_inner(buf)
    except CodecDecodeError:
        raise
    except (IndexError, struct.error, UnicodeDecodeError, ValueError, KeyError, OverflowError) as e:
        raise CodecDecodeError(f"malformed updates payload ({type(e).__name__}: {e})") from e


def _decode_changes_inner(buf: bytes) -> List[Change]:
    peers, keys, cids, r = read_tables(buf)
    n_changes = r.varint()
    metas = []
    prev_ts = 0
    for _ in range(n_changes):
        peer = peers[r.varint()]
        ctr = r.zigzag()
        lamport = r.zigzag()
        ts = prev_ts + r.zigzag()
        prev_ts = ts
        deps = Frontiers(ID(peers[r.varint()], r.zigzag()) for _ in range(r.varint()))
        msg = r.str_() if r.u8() else None
        n_ops = r.varint()
        metas.append((peer, ctr, lamport, ts, deps, msg, n_ops))
    out: List[Change] = []
    for peer, ctr, lamport, ts, deps, msg, n_ops in metas:
        ops: List[Op] = []
        counter = ctr
        for _ in range(n_ops):
            op = _read_op(r, peers, keys, cids, counter)
            ops.append(op)
            counter = op.ctr_end
        out.append(Change(ID(peer, ctr), lamport, deps, ops, ts, msg))
    return out


def _read_op(r: Reader, peers: List[int], keys: List[str], cids: List[ContainerID], counter: int) -> Op:
    cid = cids[r.varint()]
    kind = r.u8()
    if kind == K_MAP_SET:
        content: Any = MapSet(keys[r.varint()], _read_value(r, cids))
    elif kind == K_MAP_DEL:
        content = MapSet(keys[r.varint()], None, True)
    elif kind == K_INSERT_TEXT:
        parent = _read_parent(r, peers)
        side = Side(r.u8())
        content = SeqInsert(parent, side, r.str_())
    elif kind == K_INSERT_VALUES:
        parent = _read_parent(r, peers)
        side = Side(r.u8())
        content = SeqInsert(parent, side, tuple(_read_value(r, cids) for _ in range(r.varint())))
    elif kind == K_INSERT_ANCHOR:
        parent = _read_parent(r, peers)
        side = Side(r.u8())
        key = keys[r.varint()]
        value = _read_value(r, cids)
        is_start = bool(r.u8())
        info = r.varint()
        content = SeqInsert(parent, side, StyleAnchor(key, value, is_start, info))
    elif kind == K_DELETE:
        spans = []
        for _ in range(r.varint()):
            p = peers[r.varint()]
            s = r.zigzag()
            ln = r.varint()
            spans.append(IdSpan(p, s, s + ln))
        content = SeqDelete(tuple(spans))
    elif kind == K_TREE:
        target = TreeID(peers[r.varint()], r.zigzag())
        flags = r.u8()
        parent_t = TreeID(peers[r.varint()], r.zigzag()) if flags & 4 else None
        position = r.bytes_() if flags & 8 else None
        content = TreeMove(target, parent_t, position, bool(flags & 1), bool(flags & 2))
    elif kind == K_COUNTER:
        content = CounterIncr(r.f64())
    elif kind == K_MSET:
        content = MovableSet(ID(peers[r.varint()], r.zigzag()), _read_value(r, cids))
    elif kind == K_MMOVE:
        elem = ID(peers[r.varint()], r.zigzag())
        parent = _read_parent(r, peers)
        content = MovableMove(elem, parent, Side(r.u8()))
    elif kind == K_UNKNOWN:
        content = UnknownContent(r.varint(), r.bytes_())
    else:
        raise ValueError(f"bad op kind {kind}")
    return Op(counter, cid, content)


# ---- encoder -------------------------------------------------------------------


def encode_changes(changes: Sequence[Change]) -> bytes:
    """The payload of `changes`, every op kind and value tag: the bytes
    the JAX package's encode_changes writes.  Dictionaries are in
    first-use order: each change's peer and its deps' peers, then per op
    its container, key and the peers it names; containers that values
    name are registered while the ops are written, and the peers of
    non-root containers join the peer table before it is written."""
    d = _Dicts()
    for ch in changes:
        d.peer(ch.peer)
        for dep in ch.deps:
            d.peer(dep.peer)
        for op in ch.ops:
            d.cid(op.container)
            c = op.content
            if isinstance(c, MapSet):
                d.key(c.key)
            elif isinstance(c, SeqInsert):
                if isinstance(c.parent, ID):
                    d.peer(c.parent.peer)
                if isinstance(c.content, StyleAnchor):
                    d.key(c.content.key)
            elif isinstance(c, SeqDelete):
                for sp in c.spans:
                    d.peer(sp.peer)
            elif isinstance(c, TreeMove):
                d.peer(c.target.peer)
                if c.parent is not None:
                    d.peer(c.parent.peer)
            elif isinstance(c, (MovableSet, MovableMove)):
                d.peer(c.elem.peer)
                if isinstance(c, MovableMove) and isinstance(c.parent, ID):
                    d.peer(c.parent.peer)
    ops_w = Writer()
    for ch in changes:
        for op in ch.ops:
            _write_op(ops_w, d, op)
    for c in d.cids:
        if not c.is_root:
            d.peer(c.peer)

    w = Writer()
    w.varint(len(d.peers))
    for p in d.peers:
        w.u64le(p)
    w.varint(len(d.keys))
    for k in d.keys:
        w.str_(k)
    w.varint(len(d.cids))
    for c in d.cids:
        _write_cid(w, d.peer, c)
    w.varint(len(changes))
    prev_ts = 0
    for ch in changes:
        w.varint(d.peer(ch.peer))
        w.zigzag(ch.ctr_start)
        w.zigzag(ch.lamport)
        w.zigzag(ch.timestamp - prev_ts)
        prev_ts = ch.timestamp
        w.varint(len(ch.deps))
        for dep in ch.deps:
            w.varint(d.peer(dep.peer))
            w.zigzag(dep.counter)
        if ch.message is None:
            w.u8(0)
        else:
            w.u8(1)
            w.str_(ch.message)
        w.varint(len(ch.ops))
    w.buf += ops_w.buf
    return bytes(w.buf)


def _write_op(w: Writer, d: _Dicts, op: Op) -> None:
    c = op.content
    w.varint(d.cid(op.container))
    if isinstance(c, MapSet):
        if c.deleted:
            w.u8(K_MAP_DEL)
            w.varint(d.key(c.key))
        else:
            w.u8(K_MAP_SET)
            w.varint(d.key(c.key))
            _write_value(w, d, c.value)
    elif isinstance(c, SeqInsert):
        if isinstance(c.content, StyleAnchor):
            a = c.content
            w.u8(K_INSERT_ANCHOR)
            _write_parent(w, d, c.parent)
            w.u8(int(c.side))
            w.varint(d.key(a.key))
            _write_value(w, d, a.value)
            w.u8(1 if a.is_start else 0)
            w.varint(a.info)
        elif isinstance(c.content, str):
            w.u8(K_INSERT_TEXT)
            _write_parent(w, d, c.parent)
            w.u8(int(c.side))
            w.str_(c.content)
        else:
            w.u8(K_INSERT_VALUES)
            _write_parent(w, d, c.parent)
            w.u8(int(c.side))
            w.varint(len(c.content))
            for v in c.content:
                _write_value(w, d, v)
    elif isinstance(c, SeqDelete):
        w.u8(K_DELETE)
        w.varint(len(c.spans))
        for sp in c.spans:
            w.varint(d.peer(sp.peer))
            w.zigzag(sp.start)
            w.varint(sp.end - sp.start)
    elif isinstance(c, TreeMove):
        w.u8(K_TREE)
        w.varint(d.peer(c.target.peer))
        w.zigzag(c.target.counter)
        flags = ((1 if c.is_create else 0) | (2 if c.is_delete else 0) | (4 if c.parent is not None else 0)
                 | (8 if c.position is not None else 0))
        w.u8(flags)
        if c.parent is not None:
            w.varint(d.peer(c.parent.peer))
            w.zigzag(c.parent.counter)
        if c.position is not None:
            w.bytes_(c.position)
    elif isinstance(c, CounterIncr):
        w.u8(K_COUNTER)
        w.f64(c.delta)
    elif isinstance(c, MovableSet):
        w.u8(K_MSET)
        w.varint(d.peer(c.elem.peer))
        w.zigzag(c.elem.counter)
        _write_value(w, d, c.value)
    elif isinstance(c, MovableMove):
        w.u8(K_MMOVE)
        w.varint(d.peer(c.elem.peer))
        w.zigzag(c.elem.counter)
        _write_parent(w, d, c.parent)
        w.u8(int(c.side))
    elif isinstance(c, UnknownContent):
        w.u8(K_UNKNOWN)
        w.varint(c.kind)
        w.bytes_(c.data)
    else:
        raise TypeError(f"cannot encode op content {type(c)}")


def _write_parent(w: Writer, d: _Dicts, parent) -> None:
    """A sequence insert's parent: none (the root), the run-continuation
    tag, or an id; the inverse of _read_parent."""
    if parent is None:
        w.u8(PT_NONE)
    elif isinstance(parent, _RunCont):
        w.u8(RUN_CONT_TAG)
    else:
        w.u8(PT_ID)
        w.varint(d.peer(parent.peer))
        w.zigzag(parent.counter)


# ---- text trace encoder -------------------------------------------------------

Id = Tuple[int, int]  # (peer id, counter)


class TextInsert(NamedTuple):
    """Insert `text`, one element per codepoint, as a right spine: the
    first element's Fugue parent is `parent` (None = the root) on `side`
    (0 left, 1 right), each later one the element before it, on the
    right.  The op consumes len(text) counters."""

    parent: Optional[Id]
    side: int
    text: str


class TextDelete(NamedTuple):
    """Tombstone the elements of `spans`, (peer id, start, end) counter
    ranges.  The op consumes one counter."""

    spans: Tuple[Tuple[int, int, int], ...]


class TextChange(NamedTuple):
    """One change: ops of one peer at consecutive counters from
    `ctr_start`; `deps` are the ids it depends on, in the order they are
    written (the JAX package's Frontiers sorts them by (peer, counter))."""

    peer: int
    ctr_start: int
    lamport: int
    timestamp: int
    deps: Tuple[Id, ...]
    ops: Tuple[Union[TextInsert, TextDelete], ...]


def encode_text_changes(changes: Sequence[TextChange], cid: ContainerID) -> bytes:
    """Payload of text changes whose every op targets `cid`: encode_changes
    of the same changes as Change / SeqInsert / SeqDelete, so the bytes
    the JAX package's encode_changes writes for them."""
    out = []
    for ch in changes:
        ctr = ch.ctr_start
        ops = []
        for op in ch.ops:
            if isinstance(op, TextInsert):
                parent = None if op.parent is None else ID(*op.parent)
                ops.append(Op(ctr, cid, SeqInsert(parent, Side(op.side), op.text)))
                ctr += len(op.text)
            else:
                ops.append(Op(ctr, cid, SeqDelete(tuple(IdSpan(*sp) for sp in op.spans))))
                ctr += 1
        out.append(Change(ID(ch.peer, ch.ctr_start), ch.lamport, Frontiers(ID(*dep) for dep in ch.deps), ops,
                          timestamp=ch.timestamp))
    return encode_changes(out)
