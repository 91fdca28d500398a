"""Batched LWW-map merge and counter sums: the port of loro_tpu/ops/lww.py.

A map slot's winner is its op with the largest (lamport, peer); a
counter's value is the sum of its deltas.  A whole batch of documents'
ops merges in a few scatter passes over (doc, slot) cells, with no sort
and no host loop: each pass is a scatter along dim 1 of a [D, S + 1]
tensor (the JAX package vmaps a one-doc scatter over docs), whose last
column is the dump slot that swallows padding rows.

Every valid row's slot must lie in [0, S]: the JAX scatter drops a slot
past the dump column, where a torch scatter raises on the CPU and is a
device assert on a card.  Resident updates write their tensors in place
(the JAX function donates its state).

Peers of the resident form are u64 ids held as two halves, each an
int64 tensor holding the uint32 value (the SeqColumnsU convention): the
scatter maximum on a card does not cover uint32, and an int32 view would
order halves of 2^31 and more below smaller ones.

make_lww_sharded merges the op rows of a batch sharded over the op axis
of a device mesh (parallel/mesh.py): each shard's partial winners
combine in the (lamport, peer, value) order on its row's lead device.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..errors import ConfigError

NEG = -(2**31) + 1  # "no op": below every lamport and peer rank


class MapOpCols(NamedTuple):
    """[D, M] per-doc padded op columns (see columnar.MapExtract)."""

    slot: torch.Tensor  # int32, doc-local slot id in [0, S)
    lamport: torch.Tensor  # int32
    peer: torch.Tensor  # int32 peer rank
    value_idx: torch.Tensor  # int32 (-1 = delete)
    valid: torch.Tensor  # bool


class LwwResident(NamedTuple):
    """Device-resident per-(doc, slot) LWW winners."""

    lamport: torch.Tensor  # int32 [D, S]; NEG = slot untouched
    peer_hi: torch.Tensor  # int64 [D, S] holding uint32
    peer_lo: torch.Tensor  # int64 [D, S] holding uint32
    value: torch.Tensor  # int32 [D, S]; -1 = deleted, -2 = untouched


def _scatter_max(fill: int, dtype: torch.dtype, idx: torch.Tensor, src: torch.Tensor, n_slots: int) -> torch.Tensor:
    """[D, n_slots + 1] of `fill`, each cell raised to the max of the
    `src` rows whose `idx` names it."""
    out = torch.full((idx.shape[0], n_slots + 1), fill, dtype=dtype, device=idx.device)
    return out.scatter_reduce_(1, idx, src, "amax")


def _lww_winners(slot, lamport, peer, value_idx, valid, n_slots: int) -> Tuple[torch.Tensor, ...]:
    """[D, M] op columns -> (value_idx, lamport, peer) int32 [D, S]: three
    scatter-max passes, lamport first, then the peer among the ops at the
    slot's lamport, then the value of the one op at both."""
    s = torch.where(valid, slot.long(), n_slots)  # pads -> dump slot
    neg = torch.tensor(NEG, dtype=torch.int32, device=slot.device)
    win_lam = _scatter_max(NEG, torch.int32, s, torch.where(valid, lamport, neg), n_slots)
    at_max = valid & (lamport == win_lam.gather(1, s))
    win_peer = _scatter_max(NEG, torch.int32, s, torch.where(at_max, peer, neg), n_slots)
    # op ids are unique per (slot, lamport, peer), so one op matches
    is_win = at_max & (peer == win_peer.gather(1, s))
    win_val = _scatter_max(NEG, torch.int32, s, torch.where(is_win, value_idx, neg), n_slots)
    lam = win_lam[:, :n_slots]
    return torch.where(lam == NEG, -2, win_val[:, :n_slots]), lam, win_peer[:, :n_slots]


def lww_merge_doc(cols: MapOpCols, n_slots: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One doc's LWW winners, [M] columns -> (value_idx int32 [S] (-2 =
    slot untouched, -1 = deleted), win_lamport int32 [S], win_peer int32
    [S]), on the columns' device."""
    out = _lww_winners(*(c[None] for c in cols), n_slots)
    return tuple(t[0] for t in out)


def counter_merge_doc(slot, delta, valid, n_slots: int) -> torch.Tensor:
    """Sum of the deltas per counter slot, float32 [..., S]: one scatter
    add of the rows in row order (pads and invalid rows add 0 to the
    dump slot)."""
    s = torch.where(valid, slot.long(), n_slots)
    d = torch.where(valid, delta, torch.zeros((), dtype=delta.dtype, device=delta.device))
    out = torch.zeros(s.shape[:-1] + (n_slots + 1,), dtype=torch.float32, device=s.device)
    return out.scatter_add_(-1, s, d)[..., :n_slots]


def lww_merge_batch(cols: MapOpCols, n_slots: int, *, device: DeviceLike = "cuda"):
    """[D, M] op columns -> per-doc winners (value_idx, lamport, peer)
    int32 [D, S] in one call on `device`."""
    dev = resolve_device(device)
    return _lww_winners(*(t.to(dev) for t in cols), n_slots)


def counter_merge_batch(slot, delta, valid, n_slots: int, *, device: DeviceLike = "cuda") -> torch.Tensor:
    """[D, M] counter rows -> float32 sums [D, S] on `device`."""
    dev = resolve_device(device)
    return counter_merge_doc(slot.to(dev), delta.to(dev), valid.to(dev), n_slots)


def make_lww_sharded(mesh, n_slots: int):
    """Op-axis-sharded LWW merge over a ("docs", "ops") mesh
    (parallel/mesh.py; a device list is one column).  Returns fn:
    MapOpCols [D, M] (tensors or numpy) -> (value_idx, lamport, peer)
    int32 [D, S] on the mesh's first device.  D must divide by the rows
    and M by the columns (ConfigError).  Each (row, column) block of
    [D / rows, M / columns] runs the three scatter-max passes of
    _lww_winners on its device; the partials combine across the op axis
    on the row's lead device in the lexicographic (lamport, peer, value)
    order, one field at a time, as the JAX package's three pmax
    collectives do."""
    from ..parallel.mesh import DOC_AXIS, OP_AXIS, make_mesh

    mesh = make_mesh(mesh)
    rows, cols_n = mesh.shape[DOC_AXIS], mesh.shape[OP_AXIS]

    def run(cols: MapOpCols):
        d, m = cols.slot.shape
        if d % rows or m % cols_n:
            raise ConfigError("map op columns", (d, m), f"[D, M] with D % {rows} == 0 and M % {cols_n} == 0")
        dr, mc = d // rows, m // cols_n
        out = []
        for r, row in enumerate(mesh.devices):
            parts = [_lww_winners(*(_block(a, r * dr, dr, c * mc, mc, dev) for a in cols), n_slots)
                     for c, dev in enumerate(row)]
            # the collective: every shard's partials copied onto the row's lead device
            val, lam, peer = (torch.stack([t.to(row[0]) for t in ts]) for ts in zip(*parts))
            g_lam = lam.amax(0)
            g_peer = torch.where(lam == g_lam, peer, NEG).amax(0)
            g_val = torch.where((lam == g_lam) & (peer == g_peer), val, -2).amax(0)
            out.append((torch.where(g_lam == NEG, -2, g_val), g_lam, g_peer))
        first = mesh.lead
        return tuple(torch.cat([o[k].to(first) for o in out]) for k in range(3))

    return run


def _block(a, r0: int, nr: int, c0: int, nc: int, dev: torch.device) -> torch.Tensor:
    """a[r0:r0+nr, c0:c0+nc] as a contiguous tensor on `dev` (numpy
    becomes a tensor)."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    return t[r0:r0 + nr, c0:c0 + nc].to(dev).contiguous()


def _blk_winners(slot, lam, hi, lo, val, valid, n_slots: int) -> Tuple[torch.Tensor, ...]:
    """Per-slot winners of one op block [D, M]: four scatter-max passes
    over the (lamport, peer_hi, peer_lo) order, then the value.  Peer
    halves compare as their uint32 values (int64 tensors); the sentinel
    0 is safe for the max because every slot with a lamport above NEG
    has a candidate."""
    s = torch.where(valid, slot.long(), n_slots)
    neg = torch.tensor(NEG, dtype=torch.int32, device=slot.device)
    zero = torch.zeros((), dtype=torch.int64, device=slot.device)
    w_l = _scatter_max(NEG, torch.int32, s, torch.where(valid, lam, neg), n_slots)
    at_l = valid & (lam == w_l.gather(1, s))
    w_h = _scatter_max(0, torch.int64, torch.where(at_l, s, n_slots), torch.where(at_l, hi, zero), n_slots)
    at_h = at_l & (hi == w_h.gather(1, s))
    w_lo = _scatter_max(0, torch.int64, torch.where(at_h, s, n_slots), torch.where(at_h, lo, zero), n_slots)
    is_win = at_h & (lo == w_lo.gather(1, s))
    w_v = _scatter_max(-2, torch.int32, torch.where(is_win, s, n_slots),
                       torch.where(is_win, val, torch.tensor(-2, dtype=torch.int32, device=slot.device)), n_slots)
    return w_l[:, :n_slots], w_h[:, :n_slots], w_lo[:, :n_slots], w_v[:, :n_slots]


def lww_update_resident(res: LwwResident, slot, lam, hi, lo_, valid, n_slots: int, value=None) -> LwwResident:
    """Fold one append block [D, M] into the resident winners [D, S], in
    place, on the device the winners live on; returns `res`.  A block
    winner replaces the resident one when its (lamport, peer_hi, peer_lo)
    is larger.  `value` (int32 [D, M]) rides last, as in the JAX
    signature, and is required."""
    if value is None:
        raise TypeError("lww_update_resident: value is required")
    dev = res.lamport.device
    blk = [t.to(dev) for t in (slot, lam, hi, lo_, value, valid)]
    w_l, w_h, w_lo, w_v = _blk_winners(*blk, n_slots)
    r_lam, r_hi, r_lo, r_val = res
    blk_newer = (w_l > r_lam) | ((w_l == r_lam) & ((w_h > r_hi) | ((w_h == r_hi) & (w_lo > r_lo))))
    take = blk_newer & (w_l > NEG)
    for r, w in zip(res, (w_l, w_h, w_lo, w_v)):
        r.copy_(torch.where(take, w, r))
    return res
