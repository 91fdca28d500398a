"""Batched delta-export selection, the device half of the read plane: the
port of loro_tpu/ops/export_batch.py.

A sync server answers "updates since my frontier" pulls.  The device
holds a change-span index over the doc fleet, one row a stored change
(the u64 peer as two halves, each an int64 tensor holding the uint32
value; the counter span [ctr_start, ctr_end); the lamport), and one call
answers a whole window of (doc, frontier) requests.  Per request:

- a row is selected iff ctr_end > frontier[peer] (an absent peer reads
  0), OpLog.changes_since's per-peer bound;
- the selected rows come first, in the export order (lamport, peer,
  ctr_start), with the straddle correction: a change the client half
  knows exports trimmed, so its keys are lamport + (f - ctr_start) and
  max(ctr_start, f), as trim_known_prefix rewrites it.

The JAX package vmaps one request and sorts five keys in one lax.sort;
here the requests are a batch axis of torch ops (the doc rows gathered
[R, cap], the frontier match [R, cap, F]) and the sort is three stable
torch.sort passes over packed int64 keys, from the last key to the
first.  The framing into wire bytes stays on the host: the index keeps
each doc's stored changes.

Shapes bucket as in the JAX package (pad_bucket on rows, requests a
window and frontier width).  Not ported yet: the obs counters (the
index's plain counters stay and report() returns them).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.version import VersionVector
from ..device import DeviceLike, resolve_device
from ..obs import metrics as obs
from .fugue_batch import _u32_tensor, pad_bucket

_U32 = np.uint32
_MASK32 = (1 << 32) - 1


def _split_peer(peer: int) -> Tuple[int, int]:
    return (peer >> 32) & _MASK32, peer & _MASK32


def _pad_request_shapes(n_req: int, n_peers: int) -> Tuple[int, int]:
    """(requests, frontier width) of a window's tables, bucketed: one
    rule shared by select and warm."""
    return (pad_bucket(max(1, int(n_req)), floor=8),
            pad_bucket(max(1, int(n_peers)), floor=4))


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host column on `dev`: uint32 as int64 holding the same values,
    other dtypes as they are."""
    return _u32_tensor(a, dev) if a.dtype == _U32 else torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _scatter_rows(dev_cols, host_cols, docs: np.ndarray) -> None:
    """The dirty-doc delta upload shared by _device_cols and warm: the
    rows of the distinct docs `docs`, one index copy a column, in place
    (distinct indices: an index copy with repeats has no defined winner
    on a card)."""
    if not len(docs):
        return
    idx = torch.from_numpy(docs.astype(np.int64)).to(dev_cols[0].device)
    for dev, host in zip(dev_cols, host_cols):
        dev.index_copy_(0, idx, _upload(host[docs], dev.device))


def select_since_batch(doc, f_hi, f_lo, f_ctr, f_n, hi, lo, cs, ce, lam, n_rows) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-request beyond-frontier row selection in export order, on the
    tensors' device.  Requests: doc [R], frontier tables f_hi / f_lo
    (int64 holding uint32) and f_ctr (int32) [R, F], f_n [R] (entries in
    use).  Index: hi / lo (int64 holding uint32), cs, ce, lam (int32)
    [D, cap], n_rows [D].  Returns (order int32 [R, cap], count int32
    [R]): the first count[r] entries of order[r] are the selected rows
    of doc doc[r] in export order (the rest is the unselected rows in no
    promised order).  Every doc index must lie in [0, D)."""
    d = doc.long()
    dhi, dlo, dcs, dce, dlam = hi[d], lo[d], cs[d], ce[d], lam[d]
    cap = dhi.shape[1]
    rows = torch.arange(cap, device=dhi.device)
    valid = rows[None, :] < n_rows[d][:, None]
    # each row's frontier counter: its peer matched over the request's
    # frontier table (entries past f_n are padding); absent peers read 0
    fi = torch.arange(f_hi.shape[1], device=dhi.device)
    m = ((dhi[:, :, None] == f_hi[:, None, :]) & (dlo[:, :, None] == f_lo[:, None, :])
         & (fi[None, None, :] < f_n[:, None, None]))
    fctr = torch.where(m, f_ctr[:, None, :], 0).amax(dim=2).to(torch.int32)
    sel = valid & (dce > fctr)
    # straddle-corrected export keys (trim_known_prefix's rewrite)
    eff_lam = dlam + (fctr - dcs).clamp_min(0)
    eff_cs = torch.maximum(dcs, fctr)
    # keys (unselected, eff_lam, hi, lo, eff_cs), packed into three int64
    # keys, each order-preserving, sorted stably from the last to the first
    k_first = (~sel).to(torch.int64) * 2**32 + (eff_lam.to(torch.int64) + 2**31)
    k_peer = (dhi - 2**31) * 2**32 + dlo
    perm = torch.sort(eff_cs, dim=1, stable=True).indices
    for key in (k_peer, k_first):
        perm = perm.gather(1, torch.sort(key.gather(1, perm), dim=1, stable=True).indices)
    return perm.to(torch.int32), sel.sum(1).to(torch.int32)


class ExportIndex:
    """Host-fed, device-resident change-span index over one doc fleet.

    The feed (note_changes) applies the OpLog's import rule: a change the
    doc's head already holds drops, a straddling one is trimmed
    (trim_known_prefix), the head VV advances.  So row i of doc di is the
    i-th change an OpLog fed the same rounds would store, and select
    reproduces OpLog.changes_since row for row; the stored changes ride
    along a doc for the host framing.

    The device copy syncs lazily, right before the next select: the
    whole grid on the first call and after a capacity grow, else the
    dirty docs' rows.  floor_vvs is each doc's birth frontier: a pull
    whose frontier does not dominate it needs history the index never
    saw (covers() says no).  prune_below drops rows under a frontier
    every session holds and advances the floor.

    Thread contract: the owner serializes calls; no lock of its own.
    Bound to one device (default "cuda"; DeviceUnavailable without a
    card unless "cpu" is asked for)."""

    def __init__(self, n_docs: int, family: str = "", floor_vvs: Optional[Sequence[VersionVector]] = None,
                 capacity: int = 256, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.n_docs = int(n_docs)
        self.family = family
        cap = pad_bucket(max(1, int(capacity)))
        self._cap = cap
        self._hi = np.zeros((n_docs, cap), _U32)
        self._lo = np.zeros((n_docs, cap), _U32)
        self._cs = np.zeros((n_docs, cap), np.int32)
        self._ce = np.zeros((n_docs, cap), np.int32)
        self._lam = np.zeros((n_docs, cap), np.int32)
        self._n = np.zeros((n_docs,), np.int32)
        self.changes: List[List] = [[] for _ in range(n_docs)]
        self.head_vvs: List[VersionVector] = [VersionVector() for _ in range(n_docs)]
        self.floor_vvs: List[VersionVector] = [
            (floor_vvs[i].copy() if floor_vvs is not None else VersionVector()) for i in range(n_docs)
        ]
        for i in range(n_docs):
            self.head_vvs[i].merge(self.floor_vvs[i])
        self._dev: Optional[Tuple[torch.Tensor, ...]] = None  # before the first sync
        # docs whose host rows moved past the device copy; None: the whole
        # grid uploads (first sync, capacity grow)
        self._dirty_docs: Optional[set] = None
        self.launches = 0  # one a select() call
        self.warm_launches = 0  # warm()'s, never windows
        self.rows_fed = 0
        self.rows_pruned = 0

    # -- feed ----------------------------------------------------------
    def note_changes(self, di: int, chs: Sequence) -> None:
        """Append one committed round's changes of doc `di` by the OpLog's
        dedup and trim rule (decodable, causally ready changes only, as
        the sync commit path hands them over)."""
        from ..oplog.oplog import trim_known_prefix

        vv = self.head_vvs[di]
        for ch in chs:
            known = vv.get(ch.peer)
            if ch.ctr_end <= known:
                continue  # fully known: the OpLog drops it too
            if ch.ctr_start < known:
                ch = trim_known_prefix(ch, known)
            self._append_row(di, ch)
            vv.set_end(ch.peer, max(vv.get(ch.peer), ch.ctr_end))

    def _append_row(self, di: int, ch) -> None:
        n = int(self._n[di])
        if n >= self._cap:
            self._grow()
        self._hi[di, n], self._lo[di, n] = _split_peer(ch.peer)
        self._cs[di, n] = ch.ctr_start
        self._ce[di, n] = ch.ctr_end
        self._lam[di, n] = ch.lamport
        self._n[di] = n + 1
        self.changes[di].append(ch)
        if self._dirty_docs is not None:
            self._dirty_docs.add(di)
        self.rows_fed += 1

    def _grow(self) -> None:
        new_cap = pad_bucket(self._cap * 2)
        for name in ("_hi", "_lo", "_cs", "_ce", "_lam"):
            old = getattr(self, name)
            fresh = np.zeros((self.n_docs, new_cap), old.dtype)
            fresh[:, : self._cap] = old
            setattr(self, name, fresh)
        self._cap = new_cap
        self._dev = None
        self._dirty_docs = None  # shape changed: full upload

    def head_vv(self, di: int) -> VersionVector:
        return self.head_vvs[di].copy()

    def prune_below(self, di: int, floor_vv: VersionVector) -> int:
        """Drop doc di's rows wholly at or under `floor_vv` and advance its
        floor past it, so pulls from below the new floor fail covers().
        Straddling rows stay whole (a client at the floor needs their
        trimmed tails).  The device rows rewrite through the dirty-doc
        upload.  Returns the rows pruned."""
        old = self.changes[di]
        keep = [ch for ch in old if ch.ctr_end > floor_vv.get(ch.peer)]
        pruned = len(old) - len(keep)
        if pruned == 0:
            return 0
        self.changes[di] = keep
        for j, ch in enumerate(keep):
            self._hi[di, j], self._lo[di, j] = _split_peer(ch.peer)
            self._cs[di, j] = ch.ctr_start
            self._ce[di, j] = ch.ctr_end
            self._lam[di, j] = ch.lamport
        self._n[di] = len(keep)
        # the floor advances by a swap of the reference, never an in-place
        # merge: a reader of covers() sees the old floor or the new one whole
        new_floor = self.floor_vvs[di].copy()
        new_floor.merge(floor_vv)
        self.floor_vvs[di] = new_floor
        if self._dirty_docs is not None:
            self._dirty_docs.add(di)
        self.rows_pruned += pruned
        obs.counter(
            "readbatch.index_rows_pruned_total",
            "change-span index rows dropped below the session ack "
            "floors at compaction",
        ).inc(pruned, family=self.family)
        return pruned

    def covers(self, di: int, from_vv: VersionVector) -> bool:
        """Whether a pull from `from_vv` is servable off the index: the
        client holds everything below the index floor."""
        return self.floor_vvs[di] <= from_vv

    # -- device sync and selection ---------------------------------------
    def _host_cols(self):
        return (self._hi, self._lo, self._cs, self._ce, self._lam)

    def _device_cols(self) -> Tuple[torch.Tensor, ...]:
        """The device copy of the index, synced: the whole grid on the
        first call and after a grow, else the dirty docs' rows (a window
        after K docs committed moves K x cap rows, not n_docs x cap)."""
        if self._dev is not None and not self._dirty_docs:
            return self._dev
        dev = self.device
        if self._dev is None or self._dirty_docs is None:
            self._dev = tuple(_upload(a, dev) for a in self._host_cols() + (self._n,))
            kind = "full"
        else:
            docs = np.asarray(sorted(self._dirty_docs), np.int64)
            _scatter_rows(self._dev[:5], self._host_cols(), docs)
            self._dev = self._dev[:5] + (_upload(self._n, dev),)
            kind = "delta"
        self._dirty_docs = set()
        obs.counter(
            "readbatch.index_uploads_total",
            "change-span index uploads to device (full grid or "
            "dirty-doc delta scatter)",
        ).inc(family=self.family, kind=kind)
        return self._dev

    def select(self, requests: Sequence[Tuple[int, VersionVector]]) -> List[np.ndarray]:
        """One call for the whole window: for each request (di, from_vv)
        the rows of doc di beyond from_vv, int32, in export order (the
        caller frames them into wire bytes on the host).  A doc index
        outside [0, n_docs) raises IndexError before any launch."""
        for di, _vv in requests:
            if not 0 <= di < self.n_docs:
                raise IndexError(f"ExportIndex.select: doc {di} outside [0, {self.n_docs})")
        cols = self._device_cols()
        r_pad, f_pad = _pad_request_shapes(len(requests), max((len(vv) for _di, vv in requests), default=1))
        doc = np.zeros((r_pad,), np.int32)
        f_hi = np.zeros((r_pad, f_pad), _U32)
        f_lo = np.zeros((r_pad, f_pad), _U32)
        f_ctr = np.zeros((r_pad, f_pad), np.int32)
        f_n = np.zeros((r_pad,), np.int32)
        for r, (di, vv) in enumerate(requests):
            doc[r] = di
            for j, (peer, ctr) in enumerate(vv.items()):
                f_hi[r, j], f_lo[r, j] = _split_peer(peer)
                f_ctr[r, j] = ctr
            f_n[r] = len(vv)
        dev = self.device
        order, count = select_since_batch(*(_upload(a, dev) for a in (doc, f_hi, f_lo, f_ctr, f_n)), *cols)
        self.launches += 1
        obs.counter(
            "readbatch.export_launches_total",
            "batched delta-export selection launches (one per window)",
        ).inc(family=self.family)
        count = count.cpu().numpy()
        order = order[:, : int(count.max(initial=0))].cpu().numpy()
        return [order[r, : int(count[r])] for r in range(len(requests))]

    def warm(self, max_requests: int, max_peers: int = 4) -> int:
        """Run the selection once at every request bucket up to
        pad_bucket(max_requests) (frontier width from max_peers) and the
        dirty-doc upload at every doc bucket, at the current row capacity,
        on throwaway all-zero tables and columns: the first window of a
        shape then pays no first-use cost of its kernels (the JAX package
        compiles there).  Reads and writes no index state.  Returns the
        calls made, counted in warm_launches, not in launches."""
        dev = self.device
        n_docs, cap = self.n_docs, self._cap
        dtypes = (_U32, _U32, np.int32, np.int32, np.int32)
        hosts = tuple(np.zeros((n_docs, cap), dt) for dt in dtypes)
        cols = tuple(_upload(a, dev) for a in hosts) + (torch.zeros((n_docs,), dtype=torch.int32, device=dev),)
        target, f_pad = _pad_request_shapes(max_requests, max_peers)
        done = 0
        r = 8
        while r <= target:
            z64 = torch.zeros((r, f_pad), dtype=torch.int64, device=dev)
            zr = torch.zeros((r,), dtype=torch.int32, device=dev)
            _order, count = select_since_batch(zr, z64, z64, z64.to(torch.int32), zr, *cols)
            count.cpu()  # waits for the call
            done += 1
            r *= 2
        k = 8
        kmax = pad_bucket(n_docs, floor=8)
        while k <= kmax:
            _scatter_rows(cols[:5], hosts, np.arange(min(k, n_docs)))
            cols[0][:1].cpu()
            done += 1
            k *= 2
        self.warm_launches += done
        return done

    def report(self) -> Dict[str, int]:
        return {
            "rows": int(self._n.sum()),
            "capacity": self._cap,
            "launches": self.launches,
            "warm_launches": self.warm_launches,
            "rows_fed": self.rows_fed,
            "rows_pruned": self.rows_pruned,
        }
