"""Host ring statistics (numpy): the Euler-tour successor ring that
fugue_batch._ring_and_anchors builds on the device, rebuilt on the host,
and its run statistics.  n_runs is the exact occupancy of the coalesced
rank's contracted ring, so a caller can size a tight static
`ring_budget` (coalesce_budget) and check it before the merge.

The port's copy of the host-ring part of loro_tpu/ops/rank_model.py
(build_ring, run_heads, ring_stats, coalesce_budget); its gather model
and simulators are not needed here.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

BIG = 2**30


def build_ring(
    parent_in: np.ndarray,
    side_in: np.ndarray,
    valid_in: np.ndarray,
    sib_keys: Optional[Tuple[np.ndarray, ...]] = None,
) -> np.ndarray:
    """succ int32 [2*(n+1)] of one doc: the slot-numbered Euler-tour
    successor ring (ENTER(e) = sibling-sort slot, EXIT(e) = m-1-slot,
    invalid tokens chained by index), the ring _ring_and_anchors builds
    on the device."""
    n = parent_in.shape[0]
    n1 = n + 1
    root = n
    parent = np.concatenate([np.where(valid_in, parent_in, BIG), [BIG]]).astype(np.int64)
    parent[:n] = np.where(valid_in & (parent_in < 0), root, parent[:n])
    side = np.concatenate([side_in, [1]]).astype(np.int64)
    valid = np.concatenate([valid_in, [False]])
    key = np.where(parent < BIG, parent * 2 + side, BIG)
    if sib_keys is None:
        order = np.argsort(key, kind="stable")
    else:
        minor = [np.concatenate([k.astype(np.uint32), [0]]) for k in sib_keys]
        order = np.lexsort(tuple(reversed(minor)) + (key,))
    slot = np.empty(n1, np.int64)
    slot[order] = np.arange(n1)
    p_s, s_s = parent[order], side[order]
    prev_same = (p_s == np.roll(p_s, 1)) & (s_s == np.roll(s_s, 1))
    prev_same[0] = False
    is_first = ~prev_same
    nxt_same = (p_s == np.roll(p_s, -1)) & (s_s == np.roll(s_s, -1))
    nxt_same[-1] = False
    next_sib = np.zeros(n1, np.int64)
    next_sib[order] = np.where(nxt_same, np.roll(order, -1), -1)
    is_child = p_s < BIG
    first_l = np.full(n1, -1, np.int64)
    first_r = np.full(n1, -1, np.int64)
    msk = is_first & is_child & (s_s == 0)
    first_l[p_s[msk]] = order[msk]
    msk = is_first & is_child & (s_s == 1)
    first_r[p_s[msk]] = order[msk]
    has_l = first_l >= 0
    has_r = first_r >= 0

    m = 2 * n1
    ent = slot
    ext = (m - 1) - slot
    post_l = np.where(has_r, ent[np.clip(first_r, 0, n)], ext)
    succ_enter = np.where(has_l, ent[np.clip(first_l, 0, n)], post_l)
    par = np.where(parent < BIG, parent, root).astype(np.int64)
    succ_exit = np.where(
        next_sib >= 0,
        ent[np.clip(next_sib, 0, n)],
        np.where(side == 0, post_l[par], ext[par]),
    )
    succ_exit[root] = ext[root]
    succ = np.concatenate([succ_enter[order], succ_exit[order][::-1]])
    tok_valid = np.concatenate([valid[order], valid[order][::-1]])
    tok_ids = np.arange(m)
    keep = tok_valid | (tok_ids == ext[root]) | (tok_ids == ent[root])
    succ = np.where(keep, succ, np.minimum(tok_ids + 1, m - 1))
    succ[ent[root]] = succ_enter[root]
    succ[ext[root]] = ext[root]
    return succ.astype(np.int32)


def run_heads(succ: np.ndarray) -> np.ndarray:
    """bool [m]: the host twin of fugue_batch.ring_run_heads for one ring."""
    m = succ.shape[0]
    tok = np.arange(m)
    indeg = np.bincount(succ, minlength=m)
    is_term = succ == tok
    absorbed = np.zeros(m, bool)
    absorbed[1:] = (succ[:-1] == tok[1:]) & (indeg[1:] == 1) & ~is_term[1:]
    return ~absorbed


def ring_stats(succ: np.ndarray) -> Dict[str, float]:
    """Ring length, run count (the contracted ring's occupancy) and mean
    run length of one ring."""
    m = int(succ.shape[0])
    n_runs = int(run_heads(succ).sum())
    return {"ring_tokens": m, "n_runs": n_runs, "mean_run": m / max(n_runs, 1)}


def coalesce_budget(n_runs_max: int, slack: int = 128) -> int:
    """Static ring_budget from a measured largest run count: one slack
    quantum on top, rounded up to 128."""
    return -(-(n_runs_max + slack) // 128) * 128
