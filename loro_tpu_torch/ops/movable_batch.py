"""Batched MovableList merge, the port of loro_tpu/ops/movable_batch.py.

Semantics (the JAX package's MovableListState): the Fugue sequence holds
position slots, one for each element's creation and one for each move
of it; per element the winning slot is the one with the largest
(lamport, peer) (the last move wins) and the winning value the set with
the largest (lamport, peer) (creation values count as sets).  An
element is visible iff its winning slot is not tombstoned, so a move
newer than a concurrent delete revives the element at its destination.

Device form, over a leading doc axis ([D, S] slot and [D, K] set
tensors) where the JAX package vmaps one doc: three LWW scatter-max
passes on the slots (lamport, peer, tombstone of the winner) and three
on the sets, then the Fugue order of the slots (fugue_batch._order_core,
which launches the list-rank kernels of ops/list_rank.py on a card) and
the rank-histogram placement.  The scatters are torch code, as they are
XLA array code in the JAX package.  movable_by_key_batch is the resident
read: one sort of elements by their winning slot's standing key.

Host side: extract_movable (decoded changes) and
extract_movable_from_payload (the native explode, values left as
LazyPayloadValue cells that decode only when they win).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..codec.binary import read_tables
from ..core.change import MovableMove, MovableSet, SeqDelete, SeqInsert, _RunCont
from ..device import DeviceLike, resolve_device
from ..native import decode_value_at, explode_movable_payload
from .columnar import pack_wire_ids, peer_counter_perm, wire_peer_ranks
from .fugue_batch import _U32, SeqColumns, _on, _order_core, _place_codes, _rank_positions, _u32_tensor
from .lww import NEG, _scatter_max


class MovableCols(NamedTuple):
    """[D, S] slot rows and [D, K] set rows.

    Slots (sequence elements): seq (SeqColumns over slots, rows in
    (peer, counter) order; `content` is the slot's element index) and
    lamport int32.  Sets: set_elem int32 element index, set_lamport,
    set_peer (peer rank), set_value int32 value-dictionary index,
    set_valid bool."""

    seq: SeqColumns
    lamport: torch.Tensor
    set_elem: torch.Tensor
    set_lamport: torch.Tensor
    set_peer: torch.Tensor
    set_value: torch.Tensor
    set_valid: torch.Tensor


def _winner(idx, lamport, peer, valid, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(winner mask [D, M], idx with invalid rows at the dump slot n):
    per target in [0, n) its valid row of the largest (lamport, peer),
    by two scatter-max passes; rows tied on both are winners together."""
    i64 = torch.int64
    idx = torch.where(valid, idx.to(i64), n)
    lam = torch.where(valid, lamport, NEG).to(torch.int32)
    win_lam = _scatter_max(NEG, torch.int32, idx, lam, n)
    at_lam = valid & (lamport == win_lam.gather(1, idx))
    at_idx = torch.where(at_lam, idx, n)
    win_peer = _scatter_max(NEG, torch.int32, at_idx, torch.where(at_lam, peer, NEG).to(torch.int32), n)
    return at_lam & (peer == win_peer.gather(1, idx)), idx


def movable_merge_batch(cols: MovableCols, n_elems: int, *, device: DeviceLike = "cuda"):
    """(ordered value indexes int32 [D, S] padded with -1, count int32
    [D]): each doc's visible elements in list order, as their winning
    set's value index.

    Contract (the JAX package's): every element index (seq.content,
    set_elem) of a valid row is below n_elems; the JAX scatter drops a
    larger one into its dump slot, where torch raises on the CPU and
    asserts on a card."""
    c = _on(cols, device)
    seq = c.seq
    n = n_elems
    is_win_slot, elem = _winner(seq.content, c.lamport, seq.peer, seq.valid, n)
    # the winner's tombstone (slot ids are unique per (lamport, peer))
    win_deleted = _scatter_max(0, torch.int32, torch.where(is_win_slot, elem, n), seq.deleted.to(torch.int32), n)
    is_win_set, se = _winner(c.set_elem, c.set_lamport, c.set_peer, c.set_valid, n)
    win_value = _scatter_max(-1, torch.int32, torch.where(is_win_set, se, n),
                             torch.where(is_win_set, c.set_value, -1).to(torch.int32), n)
    visible = is_win_slot & ~seq.deleted & (win_deleted.gather(1, elem) == 0)
    rank = _order_core(seq.parent, seq.side, seq.valid)
    pos, count = _rank_positions(rank, visible)
    return _place_codes(pos, visible, win_value.gather(1, elem)), count


def movable_by_key_batch(valid, deleted, key_hi, key_lo, win_row, win_lam, val_idx, *, device: DeviceLike = "cuda"):
    """The resident read (DeviceMovableBatch): per element its move
    winner's slot row carries the standing order key and tombstone, and
    one sort of the E elements (not the S slots) realizes the list.
    (value ordinals int32 [D, E] padded with -1, counts int32 [D]).

    valid / deleted / key_hi / key_lo: [D, S] slot columns (keys uint32
    values, as in fugue_batch.materialize_by_key); win_row / win_lam:
    [D, E] move-winner fold (win_lam == NEG: never placed); val_idx:
    [D, E] value-winner fold."""
    dev = resolve_device(device)
    v, dl, wrow, wlam, vidx = (torch.as_tensor(t).to(dev) for t in (valid, deleted, win_row, win_lam, val_idx))
    kh, kl = _u32_tensor(key_hi, dev), _u32_tensor(key_lo, dev)
    row = wrow.to(torch.int64).clamp(0, v.shape[1] - 1)
    alive = (wlam > NEG) & v.gather(1, row) & ~dl.gather(1, row)
    ekh = torch.where(alive, kh.gather(1, row), _U32)
    ekl = torch.where(alive, kl.gather(1, row), _U32)
    perm = torch.sort((ekh - 2**31) * 2**32 + ekl, dim=1, stable=True).indices
    vis_s = alive.gather(1, perm)
    vis_i = vis_s.to(torch.int64)
    return _place_codes(vis_i.cumsum(1) - vis_i, vis_s, vidx.gather(1, perm)), alive.sum(1).to(torch.int32)


def extract_movable(changes, cid):
    """(MovableCols of numpy arrays for one doc, elems, values): the
    MovableList container `cid` of decoded changes in causal order.
    Slots are inserts and moves, in (peer, counter) order; elems lists
    the element ids (peer, counter) by first use, values the inserted
    and set values in op order (creation values are set rows too)."""
    peers_seen = sorted({ch.peer for ch in changes})
    peer_rank = {p: i for i, p in enumerate(peers_seen)}
    slots = []  # (parent_idx, side, peer_rank, counter, lamport, elem_idx)
    id2slot = {}
    elems = []
    elem_idx = {}
    values = []
    sets = []  # (elem_idx, lamport, peer_rank, value_idx)
    deletes = []

    def eidx(eid):
        if eid not in elem_idx:
            elem_idx[eid] = len(elems)
            elems.append(eid)
        return elem_idx[eid]

    def parent_slot(ch, op, c):
        if isinstance(c.parent, _RunCont):
            return id2slot[(ch.peer, op.counter - 1)]
        if c.parent is None:
            return -1
        return id2slot[(c.parent.peer, c.parent.counter)]

    for ch in changes:
        for op in ch.ops:
            if op.container != cid:
                continue
            c = op.content
            lam = ch.lamport + (op.counter - ch.ctr_start)
            if isinstance(c, SeqInsert):
                for j, value in enumerate(c.content):
                    if j == 0:
                        pidx, side = parent_slot(ch, op, c), int(c.side)
                    else:
                        pidx, side = len(slots) - 1, 1
                    eid = (ch.peer, op.counter + j)
                    ei = eidx(eid)
                    id2slot[eid] = len(slots)
                    slots.append((pidx, side, peer_rank[ch.peer], op.counter + j, lam + j, ei))
                    sets.append((ei, lam + j, peer_rank[ch.peer], len(values)))
                    values.append(value)
            elif isinstance(c, MovableMove):
                pidx = parent_slot(ch, op, c)
                ei = eidx((c.elem.peer, c.elem.counter))
                id2slot[(ch.peer, op.counter)] = len(slots)
                slots.append((pidx, int(c.side), peer_rank[ch.peer], op.counter, lam, ei))
            elif isinstance(c, MovableSet):
                ei = eidx((c.elem.peer, c.elem.counter))
                sets.append((ei, lam, peer_rank[ch.peer], len(values)))
                values.append(c.value)
            elif isinstance(c, SeqDelete):
                for sp in c.spans:
                    deletes.append((sp.peer, sp.start, sp.end))

    n = len(slots)
    arr = np.asarray(slots, np.int64).reshape(n, 6) if n else np.zeros((0, 6), np.int64)
    deleted = np.zeros(n, bool)
    for peer, start, end in deletes:
        for ctr in range(start, end):
            i = id2slot.get((peer, ctr))
            if i is not None:
                deleted[i] = True
    perm, _inv, parent = peer_counter_perm(arr[:, 2], arr[:, 3], arr[:, 0])
    k = len(sets)
    sarr = np.asarray(sets, np.int64).reshape(k, 4) if k else np.zeros((0, 4), np.int64)
    seq = SeqColumns(
        parent=parent.astype(np.int32),
        side=arr[perm, 1].astype(np.int32),
        peer=arr[perm, 2].astype(np.int32),
        counter=arr[perm, 3].astype(np.int32),
        deleted=deleted[perm],
        content=arr[perm, 5].astype(np.int32),  # element index
        valid=np.ones(n, bool),
    )
    cols = MovableCols(
        seq=seq,
        lamport=arr[perm, 4].astype(np.int32),
        set_elem=sarr[:, 0].astype(np.int32),
        set_lamport=sarr[:, 1].astype(np.int32),
        set_peer=sarr[:, 2].astype(np.int32),
        set_value=sarr[:, 3].astype(np.int32),
        set_valid=np.ones(k, bool),
    )
    return cols, elems, values


class LazyPayloadValue:
    """An undecoded value: payload bytes and the value's offset, decoded
    by get() only where it wins the set LWW (as the map batch's lazy
    cells)."""

    __slots__ = ("payload", "offset", "cids")

    def __init__(self, payload: bytes, offset: int, cids):
        self.payload = payload
        self.offset = offset
        self.cids = cids

    def get(self):
        return decode_value_at(self.payload, self.offset, self.cids)


def extract_movable_from_payload(payload: bytes, cid):
    """extract_movable's (MovableCols, elems, values) from a binary
    updates payload through the native movable explode, values as
    LazyPayloadValue cells and set_value their ordinals.  Delete spans
    naming slots outside the payload are dropped, as extract_movable's
    are.  Raises CodecDecodeError (a ValueError) on a malformed payload
    or a parent outside it (the caller falls back to the Python decode),
    and RuntimeError when the codec cannot be built."""
    peers_wire, _keys, cids, _r = read_tables(payload)
    if cid not in cids:
        return extract_movable([], cid)
    out = explode_movable_payload(payload, cids.index(cid))
    sl, st, dl = out["slots"], out["sets"], out["dels"]
    n = len(sl["parent"])
    k = len(st["elem_peer_idx"])
    rank_of = wire_peer_ranks(peers_wire)
    # the element dictionary over slot and set references: (wire peer
    # index, counter) packed into int64, unique + inverse
    uniq, inv = np.unique(np.concatenate([pack_wire_ids(sl["elem_peer_idx"], sl["elem_ctr"]),
                                          pack_wire_ids(st["elem_peer_idx"], st["elem_ctr"])]), return_inverse=True)
    peers_np = np.asarray(peers_wire, np.uint64)
    elems = list(zip(peers_np[uniq >> 32].tolist(), (uniq & _U32).tolist()))
    # tombstones: every id of the delete spans looked up in the sorted slot ids
    deleted = np.zeros(n, bool)
    lens = (dl["end"] - dl["start"]).astype(np.int64)
    tot = int(lens.sum()) if n else 0
    if tot:
        slot_packed = pack_wire_ids(sl["peer_idx"], sl["counter"])
        slot_order = np.argsort(slot_packed, kind="stable")
        slot_sorted = slot_packed[slot_order]
        offs = np.repeat(np.cumsum(lens) - lens, lens)
        ctr = np.arange(tot, dtype=np.int64) - offs + np.repeat(dl["start"], lens)
        span = (np.repeat(dl["peer_idx"].astype(np.int64), lens) << 32) | ctr
        pos = np.clip(np.searchsorted(slot_sorted, span), 0, n - 1)
        hit = slot_sorted[pos] == span
        deleted[slot_order[pos[hit]]] = True
    slot_rank = rank_of[sl["peer_idx"]].astype(np.int64)
    perm, _inv, parent = peer_counter_perm(slot_rank, sl["counter"], sl["parent"])
    seq = SeqColumns(
        parent=parent.astype(np.int32),
        side=sl["side"][perm].astype(np.int32),
        peer=slot_rank[perm].astype(np.int32),
        counter=sl["counter"][perm].astype(np.int32),
        deleted=deleted[perm],
        content=inv[:n][perm].astype(np.int32),
        valid=np.ones(n, bool),
    )
    values = [LazyPayloadValue(payload, off, cids) for off in st["value_off"].tolist()]
    cols = MovableCols(
        seq=seq,
        lamport=sl["lamport"][perm].astype(np.int32),
        set_elem=inv[n:].astype(np.int32),
        set_lamport=st["lamport"].astype(np.int32),
        set_peer=rank_of[st["peer_idx"]].astype(np.int32),
        set_value=np.arange(k, dtype=np.int32),
        set_valid=np.ones(k, bool),
    )
    return cols, elems, values
