"""Batched rich-text merge: text order plus style resolution, the port of
loro_tpu/ops/richtext_batch.py.

Semantics (Peritext-style anchors, as the JAX package models them): a
(start, end) anchor pair styles the characters between them, and per
style key the winning pair covering a char is the one with the largest
(lamport, peer); a pair whose value is None unstyles.  Anchors are
zero-width rows of the same Fugue table as the chars (content -1), so
one order solve places both; the P pairs of a doc then cut its text
into at most 2P + 1 regions of constant style, whose winners resolve by
range-chmax on a segment forest (_resolve_styles).

Three device forms, each over a leading doc axis ([D, N], [D, C],
[D, P] tensors) where the JAX package vmaps one doc:

- the element path (RichtextCols, richtext_merge_batch): the order solve
  on element rows, then the rank histogram (fugue_batch._rank_positions);
- the chain path (RichtextChainCols, richtext_chain_merge_batch), the
  fleet path: the order solve on the contracted chains, then every row's
  position by the histogram placement (fugue_batch.chain_positions);
- the resident path (RichtextPairs, richtext_by_key_batch): one stable
  sort by the standing order keys of a resident batch, no rank solve.

The order solves launch the list-rank kernels of ops/list_rank.py on a
card (fugue_batch._order_core's route); the style forest is torch
scatter code, as it is XLA array code in the JAX package.  The host side
(_explode_richtext, extract_richtext(_chain), pad_richtext_chain_cols,
stack_richtext_chain_cols) builds numpy columns, and
segments_from_device turns one doc's outputs into Quill-style segments.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..core.change import SeqDelete, SeqInsert, StyleAnchor, _RunCont
from ..device import DeviceLike, resolve_device
from .columnar import SeqExtract, chain_columns, peer_counter_perm
from .fugue_batch import (
    _U32,
    ChainColumns,
    SeqColumns,
    _on,
    _order_core,
    _place_codes,
    _rank_positions,
    _u32_tensor,
    chain_positions,
    stack_rows,
)


def _resolve_styles(
    pair_valid, pair_key, pair_value, pair_lamport, pair_peer, a_start, a_end, count, n_keys: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Style winners from anchor char-positions, [D, P] pair columns and
    count [D] -> (bounds int32 [D, 2P + 2], win_value int32 [D, 2P + 1,
    n_keys], -1 = unstyled).

    Regions are cut at the sorted anchor positions.  Pairs get a dense
    priority, their rank in (lamport, peer) order (two stable sorts:
    peer, then lamport); a pair covers a contiguous run of regions, found
    by two searchsorted calls, and its priority is range-chmaxed over
    that run on an iterative segment forest (one subtree of 2s nodes per
    style key, flat [D, n_keys * 2s + 1] with a dump slot last, <= 2
    scatter-max updates per pair per level); each (region, key) then
    takes the max over its leaf's ancestors.  A key past n_keys - 1 is
    clipped to the last, regions that are empty (lo >= hi) style nothing,
    and a doc batch with P = 0 has one unstyled region."""
    dev = pair_valid.device
    n_docs, p = pair_valid.shape
    i64 = torch.int64
    count = count.to(i64)[:, None]
    bounds = torch.sort(torch.cat([a_start, a_end], dim=1).to(i64), dim=1).values  # [D, 2P]
    lo = torch.cat([torch.zeros((n_docs, 1), dtype=i64, device=dev), bounds], dim=1)  # [D, R]
    hi = torch.cat([bounds, count], dim=1)
    out_bounds = torch.cat([lo, count], dim=1).to(torch.int32)
    r_count = 2 * p + 1
    if p == 0:
        return out_bounds, torch.full((n_docs, r_count, n_keys), -1, dtype=torch.int32, device=dev)
    # lexsort by (lamport, peer), ascending: stable sorts from the minor key
    order = torch.sort(pair_peer.to(i64), dim=1, stable=True).indices
    order = order.gather(1, torch.sort(pair_lamport.to(i64).gather(1, order), dim=1, stable=True).indices)
    ar = torch.arange(p, dtype=i64, device=dev).expand(n_docs, p)
    prio = torch.zeros((n_docs, p), dtype=i64, device=dev).scatter_(1, order, ar)

    # pair i covers exactly regions [r_lo, r_hi): lo and hi ascend, so
    # {r : a_start <= lo[r]} is a suffix and {r : a_end >= hi[r]} a prefix
    r_lo = torch.searchsorted(lo, a_start.to(i64).contiguous(), right=False)
    r_hi = torch.searchsorted(hi, a_end.to(i64).contiguous(), right=True)
    r_lo = torch.where(pair_valid, r_lo, 0)
    r_hi = torch.where(pair_valid, r_hi, 0)
    s = 1
    while s < r_count:
        s *= 2
    levels = s.bit_length()
    base = pair_key.to(i64).clamp(0, n_keys - 1) * (2 * s)  # the key's subtree in the flat forest
    tree_size = n_keys * 2 * s
    tree = torch.full((n_docs, tree_size + 1), -1, dtype=i64, device=dev)
    lcur = r_lo + s
    rcur = r_hi + s
    for _ in range(levels):
        upd_l = ((lcur & 1) == 1) & (lcur < rcur)
        tree.scatter_reduce_(1, torch.where(upd_l, base + lcur, tree_size), torch.where(upd_l, prio, -1), "amax")
        lcur = lcur + upd_l.to(i64)
        upd_r = ((rcur & 1) == 1) & (lcur < rcur)
        rcur = rcur - upd_r.to(i64)
        tree.scatter_reduce_(1, torch.where(upd_r, base + rcur, tree_size), torch.where(upd_r, prio, -1), "amax")
        lcur = lcur >> 1
        rcur = rcur >> 1
    # per (key, region) leaf: the max over its ancestors
    lev = torch.arange(r_count, dtype=i64, device=dev)[None, :] + s
    kbase = (torch.arange(n_keys, dtype=i64, device=dev) * (2 * s))[:, None]
    win_prio = torch.full((n_docs, n_keys * r_count), -1, dtype=i64, device=dev)
    for _ in range(levels):
        win_prio = torch.maximum(win_prio, tree.gather(1, (kbase + lev).reshape(1, -1).expand(n_docs, -1)))
        lev = lev >> 1
    win_pair = order.gather(1, win_prio.clamp(0, p - 1))
    win_value = torch.where(win_prio >= 0, pair_value.to(i64).gather(1, win_pair), -1).view(n_docs, n_keys, r_count)
    win_value = torch.where((lo < hi)[:, None, :], win_value, -1)
    return out_bounds, win_value.transpose(1, 2).to(torch.int32).contiguous()


def _anchor_positions(pos, count, start, end, valid) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a_start, a_end) [D, P]: each pair's anchor char-positions (count
    for invalid pairs).  end < 0 marks a deleted end anchor whose start
    lives: the host walk never pops the pair, so its style runs to EOF."""
    n = pos.shape[1]
    cnt = count.to(torch.int64)[:, None]
    ps = start.to(torch.int64).clamp(0, n - 1)
    pe = end.to(torch.int64).clamp(0, n - 1)
    pos = pos.to(torch.int64)
    a_start = torch.where(valid, pos.gather(1, ps), cnt)
    a_end = torch.where(valid & (end >= 0), pos.gather(1, pe), cnt)
    return a_start, a_end


class RichtextCols(NamedTuple):
    """Element rows (chars: content = codepoint; anchors: content -1)
    plus anchor-pair rows, [D, N] and [D, P]."""

    seq: SeqColumns
    pair_start: torch.Tensor  # int32 element row of the start anchor
    pair_end: torch.Tensor  # int32 element row of the end anchor (-1: deleted)
    pair_key: torch.Tensor  # int32 style-key index
    pair_value: torch.Tensor  # int32 value index; -1 = null (unmark)
    pair_lamport: torch.Tensor  # int32
    pair_peer: torch.Tensor  # int32 peer rank
    pair_valid: torch.Tensor  # bool (False for pads and dead start anchors)


_PAIR_FIELDS = ("pair_start", "pair_end", "pair_key", "pair_value", "pair_lamport", "pair_peer", "pair_valid")


def _styles(cols, pos, count, n_keys: int):
    a_start, a_end = _anchor_positions(pos, count, cols.pair_start, cols.pair_end, cols.pair_valid)
    return _resolve_styles(cols.pair_valid, cols.pair_key, cols.pair_value, cols.pair_lamport, cols.pair_peer,
                           a_start, a_end, count, n_keys)


def richtext_merge_batch(cols: RichtextCols, n_keys: int, *, device: DeviceLike = "cuda"):
    """(codes int32 [D, N] in order, -1 pad tail; count int32 [D]; region
    bounds int32 [D, 2P + 2], ascending char positions padded with count;
    winner value index int32 [D, 2P + 1, n_keys], -1 = unstyled) of the
    element path: the Fugue order of element rows, which must obey the
    (peer, counter) row order, then the rank histogram."""
    c = _on(cols, device)
    seq = c.seq
    rank = _order_core(seq.parent, seq.side, seq.valid)
    visible = seq.valid & ~seq.deleted & (seq.content >= 0)
    pos, count = _rank_positions(rank, visible)
    bounds, win = _styles(c, pos, count, n_keys)
    return _place_codes(pos, visible, seq.content), count, bounds, win


class RichtextChainCols(NamedTuple):
    """Chain-contracted richtext batch: the ranking runs on the chain tree
    (char runs contract exactly as in the flagship text path), while
    anchors and deleted chars keep per-row positions."""

    chain: ChainColumns
    pair_start: torch.Tensor
    pair_end: torch.Tensor
    pair_key: torch.Tensor
    pair_value: torch.Tensor
    pair_lamport: torch.Tensor
    pair_peer: torch.Tensor
    pair_valid: torch.Tensor


def richtext_chain_merge_batch(cols: RichtextChainCols, n_keys: int, *, device: DeviceLike = "cuda"):
    """richtext_merge_batch's outputs from the chain path: rank the C
    chains, then every row's char-position by the histogram placement
    (chain_positions gives positions for all rows, so zero-width anchors
    get theirs too)."""
    c = _on(cols, device)
    ch = c.chain
    n_c = ch.c_parent.shape[1]
    crank = _order_core(ch.c_parent, ch.c_side, ch.c_valid)
    visible = ch.valid & ~ch.deleted & (ch.content >= 0)
    cid = torch.where(ch.valid, ch.chain_id, n_c)
    pos, count = chain_positions(crank, ch.c_valid, cid, ch.head_row, visible)
    bounds, win = _styles(c, pos, count, n_keys)
    return _place_codes(pos, visible, ch.content), count, bounds, win


class RichtextPairs(NamedTuple):
    """Anchor-pair table of the resident path ([D, P] rows into a
    SeqColumnsU buffer; see DeviceDocBatch.richtexts)."""

    start: torch.Tensor  # int32 device row of the start anchor
    end: torch.Tensor  # int32 (-1: deleted end anchor)
    key: torch.Tensor  # int32 batch-uniform style-key index
    value: torch.Tensor  # int32 per-doc value ordinal; -1 = null (unmark)
    lamport: torch.Tensor  # int32
    peer: torch.Tensor  # int32 per-doc peer rank (order-isomorphic to the id)
    valid: torch.Tensor  # bool


def richtext_by_key_batch(cols, key_hi, key_lo, pairs: RichtextPairs, n_keys: int, *,
                          device: DeviceLike = "cuda"):
    """The resident richtext read: ONE stable sort by the standing order
    keys (uint32 pair (key_hi, key_lo) [D, N], sorted as one int64 as in
    fugue_batch.materialize_by_key; invalid rows get the largest pair)
    gives the text and every row's char-position, then the styles
    resolve.  richtext_merge_batch's outputs, with no rank solve."""
    dev = resolve_device(device)
    c = _on(cols, dev)
    p = _on(pairs, dev)
    hi = torch.where(c.valid, _u32_tensor(key_hi, dev), _U32)
    lo = torch.where(c.valid, _u32_tensor(key_lo, dev), _U32)
    perm = torch.sort((hi - 2**31) * 2**32 + lo, dim=1, stable=True).indices
    vis = c.valid & ~c.deleted & (c.content >= 0)
    vis_s = vis.gather(1, perm).to(torch.int64)
    pos_s = vis_s.cumsum(1) - vis_s
    count = vis_s.sum(1).to(torch.int32)
    codes = _place_codes(pos_s, vis_s.bool(), c.content.gather(1, perm))
    pos = torch.zeros_like(pos_s).scatter_(1, perm, pos_s)
    a_start, a_end = _anchor_positions(pos, count, p.start, p.end, p.valid)
    bounds, win = _resolve_styles(p.valid, p.key, p.value, p.lamport, p.peer, a_start, a_end, count, n_keys)
    return codes, count, bounds, win


def segments_from_device(codes, count, bounds, win, keys: Sequence[str], values: Sequence) -> List[dict]:
    """One doc's Quill-style [{insert, attributes?}] segments from its
    device outputs (numpy rows or tensors), the form of the JAX
    TextState.get_richtext_value(): regions in order, empty ones
    skipped, neighbours with equal attributes merged.  The text is the
    codepoints codes[:count], one UTF-32 decode (lone surrogates pass,
    as chr does)."""
    count = int(count)
    text = np.asarray(codes)[:count].astype("<u4").tobytes().decode("utf-32-le", "surrogatepass")
    bounds = np.asarray(bounds).tolist()
    win = np.asarray(win).tolist()
    segs: List[dict] = []
    for r in range(len(bounds) - 1):
        lo, hi = bounds[r], bounds[r + 1]
        if lo >= hi:
            continue
        attrs = {keys[k]: values[win[r][k]] for k in range(len(keys)) if win[r][k] >= 0}
        seg = {"insert": text[lo:hi]}
        if attrs:
            seg["attributes"] = attrs
        if segs and segs[-1].get("attributes") == seg.get("attributes"):
            segs[-1]["insert"] += seg["insert"]
        else:
            segs.append(seg)
    return segs


# ---- host side --------------------------------------------------------------------


def _explode_richtext(changes, cid):
    """(SeqExtract of the Text container `cid`, chars and anchors (content
    -1) in (peer, counter) order; pair rows int64 [P, 7] (start row, end
    row, key, value, lamport, peer rank, valid); keys; values).  Pairing
    invariant: a start anchor (p, c) pairs with the end anchor (p, c + 1)
    (TextHandler.mark emits exactly that).  By the host walk's rules a
    dead start makes its pair inactive, a dead end is end row -1 (the
    style runs to EOF), and an unpaired anchor is skipped."""
    peers_seen = sorted({ch.peer for ch in changes})
    peer_rank = {pr: i for i, pr in enumerate(peers_seen)}
    rows = []  # (parent, side, peer_rank, counter, content)
    id2row = {}
    keys: List[str] = []
    key_idx = {}
    values: list = []
    anchors = {}  # (peer, counter) -> dict
    deletes = []

    def kidx(k):
        if k not in key_idx:
            key_idx[k] = len(keys)
            keys.append(k)
        return key_idx[k]

    for ch in changes:
        for op in ch.ops:
            if op.container != cid:
                continue
            c = op.content
            lam = ch.lamport + (op.counter - ch.ctr_start)
            if isinstance(c, SeqInsert):
                if isinstance(c.parent, _RunCont):
                    pidx = id2row[(ch.peer, op.counter - 1)]
                elif c.parent is None:
                    pidx = -1
                else:
                    pidx = id2row[(c.parent.peer, c.parent.counter)]
                if isinstance(c.content, StyleAnchor):
                    a = c.content
                    row = len(rows)
                    id2row[(ch.peer, op.counter)] = row
                    rows.append((pidx, int(c.side), peer_rank[ch.peer], op.counter, -1))
                    if a.value is None:
                        vi = -1
                    else:
                        vi = len(values)
                        values.append(a.value)
                    anchors[(ch.peer, op.counter)] = {
                        "row": row, "key": kidx(a.key), "value": vi, "lamport": lam,
                        "peer": peer_rank[ch.peer], "start": a.is_start, "deleted": False,
                    }
                else:
                    for j, chr_ in enumerate(c.content):
                        row = len(rows)
                        id2row[(ch.peer, op.counter + j)] = row
                        rows.append((pidx if j == 0 else row - 1, int(c.side) if j == 0 else 1,
                                     peer_rank[ch.peer], op.counter + j, ord(chr_)))
            elif isinstance(c, SeqDelete):
                for sp in c.spans:
                    deletes.append((sp.peer, sp.start, sp.end))

    n = len(rows)
    arr = np.asarray(rows, np.int64).reshape(n, 5) if n else np.zeros((0, 5), np.int64)
    deleted = np.zeros(n, bool)
    for peer, start, end in deletes:
        for ctr in range(start, end):
            i = id2row.get((peer, ctr))
            if i is not None:
                deleted[i] = True
                a = anchors.get((peer, ctr))
                if a is not None:
                    a["deleted"] = True
    perm, inv, parent = peer_counter_perm(arr[:, 2], arr[:, 3], arr[:, 0])
    ex = SeqExtract(
        parent=parent.astype(np.int32),
        side=arr[perm, 1].astype(np.int32),
        peer=arr[perm, 2].astype(np.int32),
        counter=arr[perm, 3].astype(np.int32),
        deleted=deleted[perm],
        content=arr[perm, 4].astype(np.int32),
        valid=np.ones(n, bool),
        peers=peers_seen,
    )
    pairs = []
    for (peer, ctr), a in anchors.items():
        if not a["start"]:
            continue
        end = anchors.get((peer, ctr + 1))
        if end is None or end["start"]:
            continue  # unpaired (mid-transfer): inactive
        pairs.append((inv[a["row"]], -1 if end["deleted"] else inv[end["row"]], a["key"], a["value"],
                      a["lamport"], a["peer"], not a["deleted"]))
    pp = len(pairs)
    parr = np.asarray(pairs, np.int64).reshape(pp, 7) if pp else np.zeros((0, 7), np.int64)
    return ex, parr, keys, values


def _pair_fields(parr: np.ndarray) -> dict:
    return dict(zip(_PAIR_FIELDS, [parr[:, j].astype(np.int32) for j in range(6)] + [parr[:, 6].astype(bool)]))


def extract_richtext(changes, cid):
    """(RichtextCols of numpy arrays, keys, values): the element path's
    input (the differential second implementation; the fleet path is
    extract_richtext_chain)."""
    ex, parr, keys, values = _explode_richtext(changes, cid)
    return RichtextCols(seq=ex.to_seq_columns(), **_pair_fields(parr)), keys, values


def extract_richtext_chain(changes, cid):
    """(RichtextChainCols of numpy arrays, keys, values): the chain
    path's input, ranking cost in chains, not elements.  Pad to device
    shapes with pad_richtext_chain_cols or stack_richtext_chain_cols."""
    ex, parr, keys, values = _explode_richtext(changes, cid)
    return RichtextChainCols(chain=chain_columns(ex), **_pair_fields(parr)), keys, values


# fill of pad rows and of all-invalid filler docs, per field
_CHAIN_FILL = ChainColumns(c_parent=-1, c_side=0, c_valid=False, head_row=0, chain_id=0, deleted=True, content=-1,
                           valid=False)
_PAIR_FILL = dict(pair_start=0, pair_end=0, pair_key=0, pair_value=-1, pair_lamport=0, pair_peer=0, pair_valid=False)
_CHAIN_ROWS = ("c_parent", "c_side", "c_valid", "head_row")  # [C] fields; the rest are [N]


def pad_richtext_chain_cols(cols: RichtextChainCols, pad_n: int, pad_c: int, pad_p: int) -> RichtextChainCols:
    """One doc's numpy RichtextChainCols padded to (N, C, P) rows (an
    array already as long is kept)."""

    def pad(a, size, fill):
        if a.shape[0] >= size:
            return a
        out = np.full(size, fill, a.dtype)
        out[: a.shape[0]] = a
        return out

    chain = ChainColumns(*[pad(getattr(cols.chain, f), pad_c if f in _CHAIN_ROWS else pad_n, fill)
                           for f, fill in zip(ChainColumns._fields, _CHAIN_FILL)])
    return RichtextChainCols(chain=chain, **{f: pad(getattr(cols, f), pad_p, _PAIR_FILL[f]) for f in _PAIR_FIELDS})


def stack_richtext_chain_cols(per_doc: Sequence[RichtextChainCols], pad_n: int, pad_c: int, pad_p: int,
                              d_pad: int = 0) -> RichtextChainCols:
    """Numpy RichtextChainCols [d_pad, ...] of a batch of docs: a doc's
    rows then pad rows, then all-invalid filler docs up to d_pad
    (default: the batch size).  The same arrays as padding each doc
    (pad_richtext_chain_cols) and stacking, written into one array a
    column."""
    chain = ChainColumns(*[
        stack_rows([getattr(c.chain, f) for c in per_doc], pad_c if f in _CHAIN_ROWS else pad_n, fill, d_pad,
                   np.bool_ if isinstance(fill, bool) else np.int32)
        for f, fill in zip(ChainColumns._fields, _CHAIN_FILL)
    ])
    return RichtextChainCols(chain=chain, **{
        f: stack_rows([getattr(c, f) for c in per_doc], pad_p, _PAIR_FILL[f], d_pad,
                      np.bool_ if f == "pair_valid" else np.int32)
        for f in _PAIR_FIELDS
    })
