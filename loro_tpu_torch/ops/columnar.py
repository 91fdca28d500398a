"""Host-side columnar extraction: binary payloads -> numpy element
tables (extract_seq_from_payload, through the native explode; or
extract_seq_container over decoded Change objects) -> padded SeqColumns
(the element-level merge) or ChainColumns (the chain-contracted merge);
and decoded changes -> map op rows (extract_map_ops, the LWW merge's
input).

Numpy only, exactly as in the JAX package (loro_tpu/ops/columnar.py):
this stage runs on the host and its output is carried to the device by
fugue_batch.seq_columns_to_torch / chain_columns_to_torch, or packed
into one uint8 row a doc (fugue_batch.pack_chain_doc_into).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..codec.binary import read_tables
from ..core.change import Change, MapSet, SeqDelete, SeqInsert, StyleAnchor, _RunCont
from ..core.ids import ContainerID
from ..native import explode_seq_payload
from .fugue_batch import ChainColumns, SeqColumns, pad_bucket, pad_rows, pad_seq_columns


@dataclass
class SeqExtract:
    """Numpy element table for one container's full history."""

    parent: np.ndarray  # i32[N], -1 root
    side: np.ndarray  # i32[N]
    peer: np.ndarray  # i32[N] peer rank
    counter: np.ndarray  # i32[N]
    deleted: np.ndarray  # bool[N]
    content: np.ndarray  # i32[N] codepoint (text) or value index
    valid: np.ndarray  # bool[N]
    peers: List[int]  # rank -> peer id dictionary (sorted)
    values: Optional[List] = None  # value dictionary for list payloads

    @property
    def n(self) -> int:
        return int(self.parent.shape[0])

    def sort_by_peer_counter(self) -> "SeqExtract":
        """Reorder rows to (peer, counter) order and remap parent indices
        — the row-order contract of the merge (sibling order then needs
        only one stable sort by (parent, side) on the device)."""
        perm, _inv, parent = peer_counter_perm(self.peer, self.counter, self.parent)
        return SeqExtract(
            parent=parent,
            side=self.side[perm],
            peer=self.peer[perm],
            counter=self.counter[perm],
            deleted=self.deleted[perm],
            content=self.content[perm],
            valid=self.valid[perm],
            peers=self.peers,
            values=self.values,
        )

    def to_seq_columns(self, pad_to: Optional[int] = None) -> SeqColumns:
        """Numpy SeqColumns of this table, padded to `pad_to` rows
        (invalid tail) when given."""
        if pad_to is not None and pad_to < self.n:
            raise ValueError(f"pad_to {pad_to} < {self.n} rows")
        cols = SeqColumns(self.parent, self.side, self.peer, self.counter, self.deleted, self.content, self.valid)
        return cols if pad_to is None else pad_seq_columns(cols, pad_to)


def peer_counter_perm(peer: np.ndarray, counter: np.ndarray, parent: np.ndarray):
    """(perm, inv, remapped_parent) ordering rows by (peer, counter);
    parent indexes are rewritten through the permutation.  Fast path: a
    causally ordered table already has counters ascending within each
    peer, so one stable argsort by peer suffices; the post-condition is
    checked and the full lexsort taken otherwise."""
    n = len(peer)
    if n == 0:
        perm = np.zeros(0, np.int64)
    else:
        perm = np.argsort(peer, kind="stable")
        if n > 1:
            ctr_s = counter[perm].astype(np.int64)
            peer_s = peer[perm].astype(np.int64)
            if not ((np.diff(ctr_s) > 0) | (np.diff(peer_s) != 0)).all():
                perm = np.lexsort((counter, peer))
    inv = np.empty(n, np.int64)
    inv[perm] = np.arange(n)
    out_parent = np.asarray(parent)[perm].astype(np.int64)
    mask = out_parent >= 0
    out_parent[mask] = inv[out_parent[mask]]
    return perm, inv, out_parent.astype(np.int32)


def extract_seq_container(changes: Sequence[Change], cid: ContainerID, as_text: bool = True) -> SeqExtract:
    """The (peer, counter)-sorted element table of container `cid` from
    decoded changes in causal order: every SeqInsert element of the
    container (style anchors skipped) and its SeqDelete tombstones;
    deletes of ids the changes never inserted are ignored.  Peers are
    ranked among the changes' peers.  content is the codepoint with
    `as_text`, else an index into `values` (the inserted values in
    order).  Raises KeyError when an insert's parent is not an element
    inserted before it (a payload that is not self-contained)."""
    peers_seen = sorted({ch.peer for ch in changes})
    peer_rank = {p: i for i, p in enumerate(peers_seen)}
    parents: List[int] = []
    sides: List[int] = []
    peers: List[int] = []
    counters: List[int] = []
    contents: List[int] = []
    values: List = []
    id2idx: Dict[Tuple[int, int], int] = {}
    deletes: List[Tuple[int, int, int]] = []  # (peer, start, end)

    for ch in changes:
        for op in ch.ops:
            if op.container != cid:
                continue
            c = op.content
            if isinstance(c, SeqInsert):
                if isinstance(c.content, StyleAnchor):
                    continue
                body = c.content
                for j in range(len(body)):
                    if j == 0:
                        if isinstance(c.parent, _RunCont):
                            pidx = id2idx[(ch.peer, op.counter - 1)]
                        elif c.parent is None:
                            pidx = -1
                        else:
                            pidx = id2idx[(c.parent.peer, c.parent.counter)]
                        side = int(c.side)
                    else:
                        pidx = len(parents) - 1
                        side = 1
                    id2idx[(ch.peer, op.counter + j)] = len(parents)
                    parents.append(pidx)
                    sides.append(side)
                    peers.append(peer_rank[ch.peer])
                    counters.append(op.counter + j)
                    if as_text:
                        contents.append(ord(body[j]))
                    else:
                        contents.append(len(values))
                        values.append(body[j])
            elif isinstance(c, SeqDelete):
                for s in c.spans:
                    deletes.append((s.peer, s.start, s.end))

    n = len(parents)
    deleted = np.zeros(n, bool)
    for peer, start, end in deletes:
        for ctr in range(start, end):
            idx = id2idx.get((peer, ctr))
            if idx is not None:
                deleted[idx] = True
    return SeqExtract(
        parent=np.asarray(parents, np.int32),
        side=np.asarray(sides, np.int32),
        peer=np.asarray(peers, np.int32),
        counter=np.asarray(counters, np.int32),
        deleted=deleted,
        content=np.asarray(contents, np.int32),
        valid=np.ones(n, bool),
        peers=peers_seen,
        values=values if not as_text else None,
    ).sort_by_peer_counter()


def wire_peer_ranks(peers_wire: Sequence[int]) -> np.ndarray:
    """rank_of[wire index] -> rank of the peer id among the sorted u64
    peer ids (the sibling tie-break contract: the wire's registration
    order must not leak into the merge)."""
    rank_of = np.empty(len(peers_wire), np.int64)
    rank_of[np.argsort(np.asarray(peers_wire, np.uint64), kind="stable")] = np.arange(len(peers_wire))
    return rank_of


def pack_wire_ids(peer_idx, ctr) -> np.ndarray:
    """(wire peer index, counter) packed into int64 for vectorized id
    dictionaries (peer indexes are small; counters non-negative)."""
    return (np.asarray(peer_idx, np.int64) << 32) | np.asarray(ctr, np.int64)


def extract_seq_from_payload(payload: bytes, cid: ContainerID) -> SeqExtract:
    """The (peer, counter)-sorted element table of container `cid` in a
    binary updates payload, exploded by the native codec (no Python
    change objects).  Peers are ranked among every peer of the payload's
    table, and `peers` lists those ids sorted.  A container the payload
    does not name gives an empty table.  Raises CodecDecodeError on
    malformed payloads, and RuntimeError when the codec cannot be
    built: there is no Python fallback."""
    peers, _keys, cids, _r = read_tables(payload)
    if cid not in cids:
        z = np.zeros(0, np.int32)
        return SeqExtract(z, z, z, z, np.zeros(0, bool), z, np.zeros(0, bool), peers=[])
    parent, side, peer_idx, counter, deleted, content = explode_seq_payload(payload, cids.index(cid))
    return SeqExtract(
        parent=parent,
        side=side,
        peer=wire_peer_ranks(peers)[peer_idx].astype(np.int32),
        counter=counter,
        deleted=deleted,
        content=content,
        valid=np.ones(parent.shape[0], bool),
        peers=sorted(peers),
    ).sort_by_peer_counter()


@dataclass
class MapExtract:
    """Columns for the batched LWW map merge: one row per map set or
    delete, in change order."""

    slot: np.ndarray  # i32[M] (container, key) slot index
    lamport: np.ndarray  # i32[M]
    peer: np.ndarray  # i32[M] peer rank among the sorted u64 peer ids
    value_idx: np.ndarray  # i32[M] into `values`; -1 = delete
    valid: np.ndarray  # bool[M]
    slots: List[Tuple[ContainerID, str]]  # slot dictionary
    values: List  # value dictionary
    peers: List[int]


def extract_map_ops(changes: Sequence[Change]) -> MapExtract:
    """Every map op of `changes` (all map containers) as LWW rows: slots
    numbered by first use of each (container, key), an op's lamport
    its change's plus its counter offset, peers ranked sorted-u64."""
    peers_seen = sorted({ch.peer for ch in changes})
    peer_rank = {p: i for i, p in enumerate(peers_seen)}
    slot_of: Dict[Tuple[ContainerID, str], int] = {}
    slots: List[Tuple[ContainerID, str]] = []
    values: List = []
    rows: List[Tuple[int, int, int, int]] = []
    for ch in changes:
        for op in ch.ops:
            c = op.content
            if not isinstance(c, MapSet):
                continue
            key = (op.container, c.key)
            if key not in slot_of:
                slot_of[key] = len(slots)
                slots.append(key)
            lam = ch.lamport + (op.counter - ch.ctr_start)
            if c.deleted:
                vi = -1
            else:
                vi = len(values)
                values.append(c.value)
            rows.append((slot_of[key], lam, peer_rank[ch.peer], vi))
    m = len(rows)
    arr = np.asarray(rows, np.int64).reshape(m, 4) if m else np.zeros((0, 4), np.int64)
    return MapExtract(
        slot=arr[:, 0].astype(np.int32),
        lamport=arr[:, 1].astype(np.int32),
        peer=arr[:, 2].astype(np.int32),
        value_idx=arr[:, 3].astype(np.int32),
        valid=np.ones(m, bool),
        slots=slots,
        values=values,
        peers=peers_seen,
    )


@dataclass
class ChainExtract:
    """Right-spine chains (RLE runs) of a SeqExtract.

    Row i is chained to row i-1 iff parent[i]==i-1, side==Right, row i-1
    has exactly one child and no left children, and row i has no left
    children.  On the final tree these conditions make a chain contiguous
    in traversal, so contracting it is exact.  Chains are contiguous row
    ranges numbered in row order (the (peer, counter) sibling-order
    contract carries over to chain level)."""

    parent: np.ndarray  # i32[C] chain-level fugue parent (chain idx, -1 root)
    side: np.ndarray  # i32[C]
    valid: np.ndarray  # bool[C]
    head_row: np.ndarray  # i32[C] first element row of each chain
    chain_id: np.ndarray  # i32[N] element row -> chain

    @property
    def n_chains(self) -> int:
        return int(self.parent.shape[0])


def chain_columns(
    ex: SeqExtract, pad_n: Optional[int] = None, pad_c: Optional[int] = None, bucket: bool = False
) -> ChainColumns:
    """Padded numpy ChainColumns for one doc.  With bucket=True both dims
    pad to power-of-two buckets."""
    ch = contract_chains(ex)
    if bucket:
        n = pad_n or pad_bucket(max(1, ex.n))
        c = pad_c or pad_bucket(max(1, ch.n_chains))
    else:
        n = pad_n or ex.n
        c = pad_c or ch.n_chains
    return ChainColumns(
        c_parent=pad_rows(ch.parent, c, -1),
        c_side=pad_rows(ch.side, c, 0),
        c_valid=pad_rows(ch.valid, c, False),
        head_row=pad_rows(ch.head_row, c, 0),
        chain_id=pad_rows(ch.chain_id, n, 0),
        deleted=pad_rows(ex.deleted, n, True),
        content=pad_rows(ex.content, n, -1),
        valid=pad_rows(ex.valid, n, False),
    )


def contract_chains(ex: SeqExtract) -> ChainExtract:
    n = ex.n
    if n == 0:
        z = np.zeros(0, np.int32)
        return ChainExtract(z, z, np.zeros(0, bool), z, z)
    parent, side = ex.parent, ex.side
    pp = np.maximum(parent, 0)
    cc = np.bincount(parent[parent >= 0], minlength=n)
    lc = np.bincount(parent[(parent >= 0) & (side == 0)], minlength=n)
    rows = np.arange(n)
    link = (
        (parent == rows - 1)
        & (side == 1)
        & (cc[pp] == 1)
        & (lc[pp] == 0)
        & (lc[rows] == 0)
        & (parent >= 0)
    )
    chain_id = np.cumsum(~link) - 1
    head_row = np.flatnonzero(~link).astype(np.int32)
    c_parent_elem = parent[head_row]  # element row of the chain's parent
    c_parent = np.where(c_parent_elem >= 0, chain_id[np.maximum(c_parent_elem, 0)], -1)
    return ChainExtract(
        parent=c_parent.astype(np.int32),
        side=side[head_row].astype(np.int32),
        valid=np.ones(len(head_row), bool),
        head_row=head_row,
        chain_id=chain_id.astype(np.int32),
    )


def stack_docs(per_doc):
    """Stack per-doc numpy ChainColumns or SeqColumns (same pads, one
    type) into one [D, ...] batch of that type."""
    kind = type(per_doc[0])
    return kind(*[np.stack([getattr(c, f) for c in per_doc]) for f in kind._fields])
