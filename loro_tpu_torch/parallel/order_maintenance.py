"""Incremental Fugue order maintenance for device-resident batches: the
port's copy of loro_tpu/parallel/order_maintenance.py.

A rank solve re-ranks the whole element table per launch: right for
cold bulk merges, wasteful for a resident fleet where a sync appends a
few rows to a large standing table.  This module keeps, per document, a
*shadow order*: a compact host mirror of the Fugue tree that places
each new row in O(local structure) and gives it a 64-bit integer key
such that ascending key == Fugue traversal order.  The device then
materializes visible content with one sort over the standing key
columns (fugue_batch.materialize_by_key) instead of a rank solve.

Per-sync cost is O(delta), not O(table):
- run-continuation appends (the steady state) are O(1) splices;
- branch inserts bisect the sibling list and find the traversal
  predecessor: subtree-last walks only run at real branch points;
- keys come from gap midpoints (negative keys allowed, so front
  inserts never collide); a middle gap survives ~20 nested same-spot
  concurrent inserts before one O(rows) renumber walk reassigns
  uniform keys; the caller then re-uploads that doc's key column.

Siblings are ordered by ascending (peer, counter), L-children before
the node and R-children after it, as in the Fugue host engine.  The
native engine (native/order_idmap.cpp) runs the same algorithm with
bit-identical keys; this one is its differential oracle.

Memory: ~40 B/row in numpy arrays + dict entries only at branch
points: host RAM buys removing the per-sync rank solve from the device.
"""
from __future__ import annotations

from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

KEY_STEP = 1 << 20
# Run-continuation inserts take a SMALL biased step instead of the gap
# midpoint: a typing run of L chars then consumes L*RUN_STEP of the gap
# instead of halving it L times (which exhausted a fresh 2^20 gap after
# ~2 nearby runs and made renumbers ~35% of epoch ingests).
# 2^20 / 2^8 = 4096 sequential chars fit in one gap before a renumber.
RUN_STEP = 1 << 8
KEY_BIAS = 1 << 62  # added before the u32-halves split (order-preserving)
HEAD = -2  # linked-list sentinel: before the first element


class ShadowOrder:
    """Shadow Fugue order for one document's element rows.

    Rows are referenced by their device row index (the same index the
    resident batch uses).  `append_rows` places a batch of new rows and
    returns their keys — or None after a renumber, in which case the
    caller re-uploads the full key column from `all_keys()`.
    """

    def __init__(self, capacity_hint: int = 256):
        n = max(16, capacity_hint)
        self.n = 0
        self.peer = np.zeros(n, np.uint64)
        self.ctr = np.zeros(n, np.int64)
        self.prev = np.full(n, HEAD, np.int32)  # order links
        self.next = np.full(n, -1, np.int32)
        self.spine = np.full(n, -1, np.int32)  # single R-run child (fast path)
        self.key = np.zeros(n, np.int64)
        self.first_row = -1  # order head
        # branch points only: (row, side) -> child rows sorted by
        # (peer, ctr); side=1 lists INCLUDE the former spine child so
        # sibling order is explicit wherever a node has >1 child
        self.branches: Dict[Tuple[int, int], List[int]] = {}
        self.root_children: List[int] = []
        self.renumbers = 0

    # -- storage -------------------------------------------------------
    def _grow(self, need: int) -> None:
        cap = len(self.peer)
        if need <= cap:
            return
        new = max(need, cap * 2)
        for f in ("peer", "ctr", "prev", "next", "spine", "key"):
            a = getattr(self, f)
            b = np.empty(new, a.dtype)
            b[: self.n] = a[: self.n]
            setattr(self, f, b)

    def all_keys(self) -> np.ndarray:
        return self.key[: self.n]

    # -- navigation ----------------------------------------------------
    def _sib_key(self, row: int) -> Tuple[int, int]:
        return (int(self.peer[row]), int(self.ctr[row]))

    def _last_r_child(self, row: int) -> int:
        br = self.branches.get((row, 1))
        if br:
            return br[-1]
        return int(self.spine[row])

    def _subtree_last(self, row: int) -> int:
        x = row
        while True:
            nxt = self._last_r_child(x)
            if nxt < 0:
                return x
            x = nxt

    def _subtree_first(self, row: int) -> int:
        x = row
        while True:
            br = self.branches.get((x, 0))
            if not br:
                return x
            x = br[0]

    # -- linked list + keys -------------------------------------------
    def _splice_after(self, pred: int, row: int) -> None:
        if pred == HEAD:
            succ = self.first_row
            self.first_row = row
        else:
            succ = int(self.next[pred])
            self.next[pred] = row
        self.prev[row] = pred
        self.next[row] = succ
        if succ >= 0:
            self.prev[succ] = row

    def _assign_key(self, row: int, run: bool = False) -> bool:
        """Gap key from order neighbors: midpoint for branch inserts, a
        small low-biased step for run continuations (see RUN_STEP).
        False = gap empty (caller renumbers)."""
        pred = int(self.prev[row])
        succ = int(self.next[row])
        if pred < 0 and succ < 0:
            self.key[row] = 0
        elif pred < 0:
            self.key[row] = int(self.key[succ]) - KEY_STEP
        elif succ < 0:
            self.key[row] = int(self.key[pred]) + KEY_STEP
        else:
            lo, hi = int(self.key[pred]), int(self.key[succ])
            if hi - lo < 2:
                return False
            step = (hi - lo) // 2
            if run and step > RUN_STEP:
                step = RUN_STEP
            self.key[row] = lo + step
        return True

    def _renumber(self) -> None:
        """Reassign uniform keys along the order list (O(rows), rare)."""
        self.renumbers += 1
        k = 0
        x = self.first_row
        while x >= 0:
            self.key[x] = k
            k += KEY_STEP
            x = int(self.next[x])

    # -- placement -----------------------------------------------------
    def append_rows(
        self, rows: Sequence[Tuple[int, int, int, int]], base_row: int
    ) -> Optional[List[int]]:
        """Place rows (parent_row, side, peer, ctr); row j gets device
        row base_row + j.  Returns per-row keys, or None if a renumber
        happened (caller re-uploads all_keys())."""
        self._grow(base_row + len(rows))
        keys: List[int] = []
        renumbered = False
        for j, (parent_row, side, peer, ctr) in enumerate(rows):
            row = base_row + j
            self.n = max(self.n, row + 1)
            self.peer[row] = np.uint64(peer)
            self.ctr[row] = ctr
            self.spine[row] = -1
            run = self._place(parent_row, side, row)
            if not self._assign_key(row, run):
                self._renumber()
                renumbered = True
            keys.append(int(self.key[row]))
        return None if renumbered else keys

    def append_arrays(self, parent, side, peer, ctr, base_row: int):
        """Columnar adapter matching NativeShadowOrder.append_arrays
        (the fallback pays the tuple conversion; the native engine
        takes the arrays directly)."""
        return self.append_rows(
            list(zip(parent.tolist(), side.tolist(), peer.tolist(), ctr.tolist())),
            base_row,
        )

    def _place(self, parent_row: int, side: int, row: int) -> bool:
        """Place `row`; True = run-continuation fast path (the caller
        assigns a low-biased key so runs don't bisect the gap)."""
        # run-continuation fast path: R-insert under a childless parent
        # from the same peer with a contiguous counter
        if (
            parent_row >= 0
            and side == 1
            and self.spine[parent_row] < 0
            and (parent_row, 1) not in self.branches
            and int(self.peer[parent_row]) == int(self.peer[row])
            and int(self.ctr[parent_row]) == int(self.ctr[row]) - 1
        ):
            self.spine[parent_row] = row
            self._splice_after(parent_row, row)
            return True
        sibs = self._sibling_list(parent_row, side)
        i = bisect_left(sibs, self._sib_key(row), key=self._sib_key)
        sibs.insert(i, row)
        if side == 1 or parent_row < 0:
            if i == 0:
                # smallest R-sibling: immediately after the parent
                pred = parent_row if parent_row >= 0 else HEAD
            else:
                pred = self._subtree_last(sibs[i - 1])
            self._splice_after(pred, row)
        else:
            if i > 0:
                self._splice_after(self._subtree_last(sibs[i - 1]), row)
            else:
                # new leftmost of the parent's subtree: before its old
                # subtree-first (next L-sibling's first, or the parent)
                nxt = sibs[i + 1] if len(sibs) > i + 1 else -1
                old_first = self._subtree_first(nxt) if nxt >= 0 else parent_row
                self._splice_after(int(self.prev[old_first]), row)
        return False

    def _sibling_list(self, parent_row: int, side: int) -> List[int]:
        if parent_row < 0:
            return self.root_children
        key = (parent_row, side)
        lst = self.branches.get(key)
        if lst is None:
            lst = []
            if side == 1:
                sp = int(self.spine[parent_row])
                if sp >= 0:
                    lst.append(sp)
                    self.spine[parent_row] = -1  # now tracked in branches
            self.branches[key] = lst
        return lst


def split_keys(keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Order-preserving (hi, lo) u32 split of signed int64 keys for the
    device sort."""
    biased = (keys.astype(np.int64) + np.int64(KEY_BIAS)).view(np.uint64)
    u = biased
    return (u >> np.uint64(32)).astype(np.uint32), (
        u & np.uint64(0xFFFFFFFF)
    ).astype(np.uint32)
