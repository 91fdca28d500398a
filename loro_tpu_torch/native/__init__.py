"""ctypes bindings of the port's native host code: the payload codec
(seq_codec.cpp: the one-shot explode, the resident batch's delta
explode and anchor metadata, the map explode, the tree explode and the
movable-list explode, one-shot and delta) and
the resident batch's engines (order_idmap.cpp: NativeShadowOrder,
NativeIdMap).

Each library is built with g++ at its first use (``_build.library``:
``build/torch_kernels/``, keyed by the source hash) and loaded with
``ctypes.CDLL``, which releases the interpreter lock for the length of
each call, so decode threads explode payloads, and ingest threads
append to different docs' order engines, in parallel.  There is no
Python fallback: a library that cannot be built raises KernelBuildError,
and a malformed payload raises CodecDecodeError.  Every explode entry
passes its payload through ``_obs_decode``: the decode counters and the
``decode`` fault site.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np

from ..errors import CodecDecodeError
from ..obs import metrics as _obs
from ..resilience import faultinject as _fi

_fi.register_site(
    "decode", "native explode entries: truncate/bit-flip the wire bytes "
    "before the C++ parser sees them (typed CodecDecodeError -> the "
    "caller's Python-decoder fallback)")

_lib_handle: Optional[ctypes.CDLL] = None
_engines_handle: Optional[ctypes.CDLL] = None
_P = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        from .._build import library

        lib = library("seq_codec")
        lib.loro_count_seq_elements.restype = ctypes.c_longlong
        lib.loro_count_seq_elements.argtypes = [ctypes.c_char_p, ctypes.c_longlong, ctypes.c_int]
        lib.loro_set_rowtable_budget.restype = None
        lib.loro_set_rowtable_budget.argtypes = [ctypes.c_longlong]
        lib.loro_explode_seq.restype = ctypes.c_longlong
        lib.loro_explode_seq.argtypes = (
            [ctypes.c_char_p, ctypes.c_longlong, ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_longlong]
        )
        head = [ctypes.c_char_p, ctypes.c_longlong, ctypes.c_int]
        for name in ("loro_count_seq_delta_rows", "loro_count_seq_deletes"):
            getattr(lib, name).restype = ctypes.c_longlong
            getattr(lib, name).argtypes = head
        lib.loro_explode_seq_delta.restype = ctypes.c_longlong
        lib.loro_explode_seq_delta.argtypes = head + [_P] * 7 + [ctypes.c_longlong] + [_P] * 3 + [ctypes.c_longlong, _P]
        lib.loro_explode_seq_anchor_meta.restype = ctypes.c_longlong
        lib.loro_explode_seq_anchor_meta.argtypes = head + [_P] * 5 + [ctypes.c_longlong]
        lib.loro_count_map_ops.restype = ctypes.c_longlong
        lib.loro_count_map_ops.argtypes = [ctypes.c_char_p, ctypes.c_longlong]
        lib.loro_explode_map.restype = ctypes.c_longlong
        lib.loro_explode_map.argtypes = [ctypes.c_char_p, ctypes.c_longlong] + [_P] * 6 + [ctypes.c_longlong]
        lib.loro_count_tree_ops.restype = ctypes.c_longlong
        lib.loro_count_tree_ops.argtypes = head
        lib.loro_explode_tree.restype = ctypes.c_longlong
        lib.loro_explode_tree.argtypes = head + [_P] * 10 + [ctypes.c_longlong]
        lib.loro_count_movable.restype = ctypes.c_longlong
        lib.loro_count_movable.argtypes = head + [_P] * 3
        lib.loro_explode_movable.restype = ctypes.c_longlong
        lib.loro_explode_movable.argtypes = head + [_P] * 15 + [ctypes.c_longlong] * 3
        lib.loro_explode_movable_delta.restype = ctypes.c_longlong
        lib.loro_explode_movable_delta.argtypes = head + [_P] * 15 + [ctypes.c_longlong] * 3 + [_P] * 2
        _lib_handle = lib
    return _lib_handle


def _obs_decode(fn: str, payload) -> bytes:
    """Per-call decode accounting: which native explode entry ran and
    how many wire bytes it took (codec.native_decode_calls_total and
    codec.native_decode_bytes_total, by fn).  Also the fault-injection
    choke point: an armed ``decode`` fault truncates or bit-flips the
    payload here, before the C++ parser sees it; the parser answers with
    a typed CodecDecodeError, never a crash."""
    payload = _fi.mangle("decode", bytes(payload))
    _obs.counter("codec.native_decode_calls_total").inc(fn=fn)
    _obs.counter("codec.native_decode_bytes_total").inc(len(payload), fn=fn)
    return payload


def set_rowtable_budget(entries: int) -> None:
    """Caps the direct (peer, counter) -> row table at `entries` entries
    (0 restores the default: 8 entries an element, plus 2^20); past the cap the
    explode redoes the payload with the hash map.  Process-wide: for
    tests that drive the hash-map path."""
    _lib().loro_set_rowtable_budget(int(entries))


def explode_seq_payload(
    payload: bytes, target_cid_index: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The element table of one sequence container of a binary updates
    payload, in payload order: (parent row int32 (-1 = root), side
    int32, peer index int32 (into the payload's peer table), counter
    int32, deleted bool, content int32 (codepoint, or a value index for
    list inserts)).  Raises CodecDecodeError on malformed payloads and
    unresolvable parent references."""
    lib = _lib()
    payload = _obs_decode("seq", payload)
    n = lib.loro_count_seq_elements(payload, len(payload), target_cid_index)
    if n < 0:
        raise CodecDecodeError("native decode failed (malformed payload)")
    parent = np.empty(n, np.int32)
    side = np.empty(n, np.int32)
    peer = np.empty(n, np.int32)
    counter = np.empty(n, np.int32)
    deleted = np.zeros(n, np.uint8)
    content = np.empty(n, np.int32)
    wrote = lib.loro_explode_seq(
        payload, len(payload), target_cid_index,
        *[a.ctypes.data_as(ctypes.c_void_p) for a in (parent, side, peer, counter, deleted, content)], n,
    )
    if wrote != n:
        raise CodecDecodeError("native decode failed (unresolvable references or count mismatch)")
    return parent, side, peer, counter, deleted.astype(bool), content


def _ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def explode_seq_delta_payload(payload: bytes, target_cid_index: int) -> Dict[str, np.ndarray]:
    """The resident batch's incremental explode of one sequence container
    of a payload: its new rows in payload order, with parents inside the
    payload as row ordinals (-1 = the root) and parents in earlier
    payloads as -2 with their (ext_peer_idx, ext_counter) for the
    caller's id map; deletes as raw (del_peer_idx, del_start, del_end)
    spans; style anchors as rows of content -1.  Peer indexes are into
    the payload's peer table.  Raises CodecDecodeError on malformed
    payloads."""
    lib = _lib()
    payload = _obs_decode("seq_delta", payload)
    n = lib.loro_count_seq_delta_rows(payload, len(payload), target_cid_index)
    nd = lib.loro_count_seq_deletes(payload, len(payload), target_cid_index)
    if n < 0 or nd < 0:
        raise CodecDecodeError("native delta decode failed (malformed payload)")
    out = {f: np.empty(n, np.int32) for f in ("parent", "side", "peer_idx", "counter", "content", "ext_peer_idx")}
    out["ext_counter"] = np.empty(n, np.int64)
    dels = {"del_peer_idx": np.empty(nd, np.int32), "del_start": np.empty(nd, np.int64),
            "del_end": np.empty(nd, np.int64)}
    n_del = ctypes.c_longlong(0)
    wrote = lib.loro_explode_seq_delta(
        payload, len(payload), target_cid_index,
        *[_ptr(out[f]) for f in ("parent", "side", "peer_idx", "counter", "content", "ext_peer_idx", "ext_counter")],
        n, *[_ptr(a) for a in dels.values()], nd, ctypes.byref(n_del),
    )
    if wrote != n:
        raise CodecDecodeError("native delta decode failed")
    out.update({f: a[: n_del.value] for f, a in dels.items()})
    return out


def explode_seq_anchor_meta(payload: bytes, target_cid_index: int) -> Dict[str, np.ndarray]:
    """Style-anchor metadata in explode_seq_delta_payload's row numbering:
    row ordinal, wire key index, the value's byte offset into the
    payload (for decode_value_at), lamport and flags (bit 0: is_start).
    Raises CodecDecodeError on malformed payloads."""
    lib = _lib()
    payload = _obs_decode("seq_anchor", payload)
    n = lib.loro_explode_seq_anchor_meta(payload, len(payload), target_cid_index, None, None, None, None, None, 0)
    if n < 0:
        raise CodecDecodeError("native anchor decode failed (malformed payload)")
    out = {"row": np.empty(n, np.int64), "key_idx": np.empty(n, np.int32), "voffset": np.empty(n, np.int64),
           "lamport": np.empty(n, np.int32), "flags": np.empty(n, np.int32)}
    wrote = lib.loro_explode_seq_anchor_meta(payload, len(payload), target_cid_index, *map(_ptr, out.values()), n)
    if wrote != n:
        raise CodecDecodeError("native anchor decode failed")
    return out


def explode_map_payload(payload: bytes) -> dict:
    """Every map set and delete of a payload (all map containers), in
    payload order: numpy columns cid_idx and key_idx (into the payload's
    tables), lamport, peer_rank (the op's peer ranked among the sorted
    u64 ids of the payload's peer table, the LWW tie-break order, not
    the wire's), peer_u64 (uint64), value_ordinal (-1 = delete) and
    value_offset (the value's byte offset into the payload, for
    decode_value_at; -1 = delete); and the tables peers (sorted), keys
    and cids.  Raises CodecDecodeError on malformed payloads."""
    from ..codec.binary import read_tables

    lib = _lib()
    payload = _obs_decode("map", payload)
    n = lib.loro_count_map_ops(payload, len(payload))
    if n < 0:
        raise CodecDecodeError("native decode failed (malformed payload?)")
    cols = {f: np.empty(n, np.int32) for f in ("cid_idx", "key_idx", "lamport", "peer_idx", "value_ordinal")}
    cols["value_offset"] = np.empty(n, np.int64)
    wrote = lib.loro_explode_map(
        payload, len(payload),
        *[_ptr(cols[f]) for f in ("cid_idx", "key_idx", "lamport", "peer_idx", "value_ordinal", "value_offset")], n,
    )
    if wrote != n:
        raise CodecDecodeError("native decode failed (count mismatch)")
    peers_wire, keys, cids, _r = read_tables(payload)
    wire = np.asarray(peers_wire, np.uint64)
    rank_of = np.empty(len(wire), np.int32)
    rank_of[np.argsort(wire, kind="stable")] = np.arange(len(wire), dtype=np.int32)
    peer_idx = cols.pop("peer_idx")
    return {
        **cols,
        "peer_rank": rank_of[peer_idx],
        "peer_u64": wire[peer_idx],
        "peers": sorted(peers_wire),
        "keys": keys,
        "cids": cids,
    }


def explode_tree_payload(payload: bytes, target_cid_index: int) -> Dict[str, np.ndarray]:
    """Every TreeMove row of one container, in payload order, as numpy
    columns: lamport, peer_idx, counter, target_peer_idx, target_ctr,
    flags (1 create | 2 delete | 4 has a parent | 8 has a position),
    parent_peer_idx, parent_ctr (where flags & 4), pos_off and pos_len
    (the position's byte range in the payload).  Peer columns are wire
    indexes into the payload's peer table.  Raises CodecDecodeError on
    malformed payloads."""
    lib = _lib()
    payload = _obs_decode("tree", payload)
    n = lib.loro_count_tree_ops(payload, len(payload), target_cid_index)
    if n < 0:
        raise CodecDecodeError("native decode failed (malformed payload?)")
    cols = {f: np.empty(n, np.int32) for f in ("lamport", "peer_idx", "counter", "target_peer_idx", "target_ctr",
                                               "flags", "parent_peer_idx", "parent_ctr")}
    cols["pos_off"] = np.empty(n, np.int64)
    cols["pos_len"] = np.empty(n, np.int32)
    wrote = lib.loro_explode_tree(payload, len(payload), target_cid_index, *map(_ptr, cols.values()), n)
    if wrote != n:
        raise CodecDecodeError("native decode failed (count mismatch)")
    return cols


def explode_movable_payload(payload: bytes, target_cid_index: int) -> Dict[str, Dict[str, np.ndarray]]:
    """The slots, sets and delete spans of one MovableList container, in
    payload order: {"slots": parent (row, -1 = the root), side, peer_idx,
    counter, lamport, elem_peer_idx, elem_ctr; "sets": elem_peer_idx,
    elem_ctr, lamport, peer_idx, value_off (the value's byte offset, for
    decode_value_at); "dels": peer_idx, start, end}.  Inserted values
    are sets too (their creation values).  Peer columns are wire indexes
    into the payload's peer table.  Raises CodecDecodeError on malformed
    payloads and on a parent outside the payload."""
    return _explode_movable(payload, target_cid_index, delta=False)


def explode_movable_delta_payload(payload: bytes, target_cid_index: int) -> Dict[str, Dict[str, np.ndarray]]:
    """The delta form of explode_movable_payload (a resident batch's
    append): a slot whose parent is not in the payload has parent -2 and
    that parent's (wire peer index, counter) in slots["ext_peer_idx"] /
    slots["ext_counter"] (-1 on every other slot), for the batch's id
    maps to resolve.  Raises CodecDecodeError on malformed payloads."""
    return _explode_movable(payload, target_cid_index, delta=True)


def _explode_movable(payload: bytes, target_cid_index: int, delta: bool) -> Dict[str, Dict[str, np.ndarray]]:
    lib = _lib()
    payload = _obs_decode("movable_delta" if delta else "movable", payload)
    counts = [ctypes.c_longlong() for _ in range(3)]
    if lib.loro_count_movable(payload, len(payload), target_cid_index, *map(ctypes.byref, counts)) < 0:
        raise CodecDecodeError("native decode failed (malformed payload?)")
    ns, nv, nd = (c.value for c in counts)
    slots = {f: np.empty(ns, np.int32)
             for f in ("parent", "side", "peer_idx", "counter", "lamport", "elem_peer_idx", "elem_ctr")}
    sets = {f: np.empty(nv, np.int32) for f in ("elem_peer_idx", "elem_ctr", "lamport", "peer_idx")}
    sets["value_off"] = np.empty(nv, np.int64)
    dels = {"peer_idx": np.empty(nd, np.int32), "start": np.empty(nd, np.int64), "end": np.empty(nd, np.int64)}
    args = [payload, len(payload), target_cid_index,
            *[_ptr(a) for cols in (slots, sets, dels) for a in cols.values()], ns, nv, nd]
    if delta:
        ext = {"ext_peer_idx": np.empty(ns, np.int32), "ext_counter": np.empty(ns, np.int64)}
        wrote = lib.loro_explode_movable_delta(*args, *[_ptr(a) for a in ext.values()])
        slots.update(ext)
    else:
        wrote = lib.loro_explode_movable(*args)
    if wrote != ns:
        raise CodecDecodeError("native decode failed (unresolvable references or count mismatch)")
    return {"slots": slots, "sets": sets, "dels": dels}


def decode_value_at(payload: bytes, offset: int, cids):
    """Decode one tagged value at a byte offset the native code reported
    (an anchor's or a map op's value)."""
    from ..codec.binary import Reader, _read_value

    r = Reader(payload)
    r.i = offset
    return _read_value(r, cids)


def _engines() -> ctypes.CDLL:
    global _engines_handle
    if _engines_handle is None:
        from .._build import library

        lib = library("order_idmap")
        for name, res, args in (
            ("loro_order_new", _P, []),
            ("loro_order_free", None, [_P]),
            ("loro_order_nrows", ctypes.c_longlong, [_P]),
            ("loro_order_renumbers", ctypes.c_longlong, [_P]),
            ("loro_order_all_keys", None, [_P, _P]),
            ("loro_order_append", ctypes.c_longlong, [_P, ctypes.c_longlong] + [_P] * 4 + [ctypes.c_longlong, _P]),
            ("loro_idmap_new", _P, []),
            ("loro_idmap_free", None, [_P]),
            ("loro_idmap_len", ctypes.c_longlong, [_P]),
            ("loro_idmap_insert", None, [_P, ctypes.c_longlong] + [_P] * 3),
            ("loro_idmap_stage", None, [_P, ctypes.c_longlong, _P, _P, ctypes.c_int]),
            ("loro_idmap_commit", None, [_P]),
            ("loro_idmap_abort", None, [_P]),
            ("loro_idmap_lookup", None, [_P, ctypes.c_longlong] + [_P] * 3),
            ("loro_idmap_get", ctypes.c_longlong, [_P, ctypes.c_uint64, ctypes.c_longlong]),
        ):
            getattr(lib, name).restype = res
            getattr(lib, name).argtypes = args
        _engines_handle = lib
    return _engines_handle


class NativeShadowOrder:
    """C++ twin of parallel.order_maintenance.ShadowOrder: the same
    algorithm, so the keys are bit-identical (the Python engine is the
    differential oracle).  Build one with native_order()."""

    __slots__ = ("_lib", "_h")

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        self._h = lib.loro_order_new()

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.loro_order_free(h)
            self._h = None

    @property
    def renumbers(self) -> int:
        return int(self._lib.loro_order_renumbers(self._h))

    @property
    def n(self) -> int:
        return int(self._lib.loro_order_nrows(self._h))

    def append_arrays(self, parent, side, peer, ctr, base_row: int) -> Optional[np.ndarray]:
        """Place rows (parent row, side, peer, counter) at rows base_row..:
        their int64 keys, or None after a renumber (the caller re-reads
        all_keys()).  Raises ValueError unless base_row is the row count."""
        parent = np.ascontiguousarray(parent, np.int32)
        side = np.ascontiguousarray(side, np.int32)
        peer = np.ascontiguousarray(peer, np.uint64)
        ctr = np.ascontiguousarray(ctr, np.int64)
        out = np.empty(len(parent), np.int64)
        rc = self._lib.loro_order_append(
            self._h, len(parent), _ptr(parent), _ptr(side), _ptr(peer), _ptr(ctr), base_row, _ptr(out)
        )
        if rc < 0:
            raise ValueError("native order append: non-contiguous base row")
        return None if rc == 1 else out

    def all_keys(self) -> np.ndarray:
        out = np.empty(self.n, np.int64)
        self._lib.loro_order_all_keys(self._h, _ptr(out))
        return out


def native_order() -> NativeShadowOrder:
    """A new native order engine; RuntimeError if the library cannot be
    built."""
    return NativeShadowOrder(_engines())


class NativeIdMap:
    """C++ (peer, counter) -> row map of one doc with the staging contract
    of parallel.idmap.PyIdMap (stage, staged-first lookup, commit or
    abort) and its dict-like subset."""

    __slots__ = ("_lib", "_h")

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        self._h = lib.loro_idmap_new()

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.loro_idmap_free(h)
            self._h = None

    def __len__(self) -> int:
        return int(self._lib.loro_idmap_len(self._h))

    def __bool__(self) -> bool:
        return len(self) > 0

    def get(self, key, default=None):
        r = self._lib.loro_idmap_get(self._h, ctypes.c_uint64(key[0]), ctypes.c_longlong(key[1]))
        return default if r < 0 else int(r)

    def __getitem__(self, key):
        r = self.get(key)
        if r is None:
            raise KeyError(key)
        return r

    def __contains__(self, key) -> bool:
        return self.get(key) is not None

    def update(self, d) -> None:
        """Committed inserts from a {(peer, counter): row} dict."""
        if not d:
            return
        n = len(d)
        peer = np.fromiter((k[0] for k in d), np.uint64, n)
        ctr = np.fromiter((k[1] for k in d), np.int64, n)
        self.insert_arrays(peer, ctr, np.fromiter(d.values(), np.int32, n))

    def insert_arrays(self, peer, ctr, rows) -> None:
        peer = np.ascontiguousarray(peer, np.uint64)
        ctr = np.ascontiguousarray(ctr, np.int64)
        rows = np.ascontiguousarray(rows, np.int32)
        self._lib.loro_idmap_insert(self._h, len(peer), _ptr(peer), _ptr(ctr), _ptr(rows))

    def stage_base(self, peer, ctr, base_row: int) -> None:
        peer = np.ascontiguousarray(peer, np.uint64)
        ctr = np.ascontiguousarray(ctr, np.int64)
        self._lib.loro_idmap_stage(self._h, len(peer), _ptr(peer), _ptr(ctr), base_row)

    def lookup(self, peer, ctr) -> np.ndarray:
        """Staged-first batch lookup; -1 = missing."""
        peer = np.ascontiguousarray(peer, np.uint64)
        ctr = np.ascontiguousarray(ctr, np.int64)
        out = np.empty(len(peer), np.int32)
        self._lib.loro_idmap_lookup(self._h, len(peer), _ptr(peer), _ptr(ctr), _ptr(out))
        return out

    def commit(self) -> None:
        self._lib.loro_idmap_commit(self._h)

    def abort(self) -> None:
        self._lib.loro_idmap_abort(self._h)


def native_idmap() -> NativeIdMap:
    """A new native id map; RuntimeError if the library cannot be built."""
    return NativeIdMap(_engines())
