"""Gather-count accounting for the ranking algorithms and the host
Euler-tour ring (numpy, host-side): the port's copy of
loro_tpu/ops/rank_model.py.

Three layers:

- ``gather_model(m, algo)``    — analytic worst-case/cap counts from
  the static ring length alone (what the ``rank.*`` obs counters tick:
  cheap, no device work; ``fugue_batch._tick_rank_obs``).
- ``simulate(succ, algo)``     — numpy re-execution of the algorithm's
  control flow on a REAL ring, counting the rounds the adaptive loops
  actually run and returning the distances (a host oracle for the
  differential tests).
- ``build_ring`` / ``run_heads`` / ``ring_stats`` / ``coalesce_budget``
  — the Euler-tour successor ring fugue_batch._ring_and_anchors builds
  on the device, rebuilt on the host, and its run statistics.  n_runs
  is the exact occupancy of the coalesced rank's contracted ring, so a
  caller can size a tight static ``ring_budget`` and check it before
  the merge.

Row classes: ``global_rows`` are random gathers addressed into an
O(m)-row table; ``local_rows`` are block-local gathers (the blocked
algorithm's in-block phase); ``small_rows`` are gathers from tables
O(m/k) and below.  The counts price the algorithm's row schedule, which
the CUDA kernels and the plain torch versions share.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

BIG = 2**30


def _log2ceil(x: int) -> int:
    return max(1, int(np.ceil(np.log2(max(int(x), 2)))))


# ---------------------------------------------------------------------------
# analytic model
# ---------------------------------------------------------------------------


def gather_model(
    m: int,
    algo: str,
    k: int = 8,
    block: int = 1024,
    r_pad: Optional[int] = None,
) -> Dict[str, int]:
    """Scheduled gather-row counts for a ring of m tokens (worst case:
    adaptive loops priced at their round CAP; `simulate` gives the
    realized counts).  Keys: rounds (cap of the dominant global loop),
    global_rows, local_rows, small_rows.  Counts are backend-neutral:
    they price the ROW SCHEDULE, which is identical for the CUDA
    kernels and the plain torch versions (a kernel's constant factors
    are its own concern, not a schedule one)."""
    lm = _log2ceil(m)
    if algo == "wyllie":
        return {"rounds": lm, "global_rows": lm * m, "local_rows": 0, "small_rows": 0}
    if algo == "ruling":
        # dense table = ceil(m/k) ruler slots + the sink row (exactly
        # what _sim_ruling and the kernels rank)
        mr = -(-m // k) + 1
        return {
            "rounds": lm,
            "global_rows": lm * m + _log2ceil(mr) * mr,
            "local_rows": 0,
            "small_rows": m,  # recombine gather from the dense table
        }
    if algo == "blocked":
        # mirror _blocked_dist exactly: block clamped to the lane-padded
        # ring, then the ring padded to a block multiple — phase B runs
        # over mp tokens, so the ledger must price mp, not m
        b = min(block, max(128, -(-m // 128) * 128))
        mp = -(-m // b) * b
        la = _log2ceil(b)
        sub = gather_model(mp, "ruling", k=k)
        return {
            "rounds": sub["rounds"],
            "global_rows": sub["global_rows"],
            "local_rows": la * mp,
            "small_rows": sub["small_rows"],
        }
    if algo == "coalesced":
        # mirror _coalesced_dist's budget rounding; the ruling sub-rank
        # sees rp+1 tokens (sink slot), and the contraction performs
        # TWO rp-row gathers into O(m) tables (succ[tail_tok] and
        # run_id[succ_tail])
        rp = max(128, -(-(r_pad if r_pad is not None else m) // 128) * 128)
        sub = gather_model(rp + 1, "ruling", k=k)
        return {
            "rounds": sub["rounds"],
            "global_rows": sub["global_rows"] + 2 * rp,
            "local_rows": 0,
            "small_rows": sub["small_rows"],  # expansion is scatter+cumsum
        }
    if algo == "sparse":
        # the port's sparse ruling route (list_rank.sparse_rank; the JAX
        # package has none): the in-degree scatter and the walks touch
        # every token once in O(m)-row tables, one stop-slot read a ruler;
        # the ruler ring (m/k regular rulers, priced without the few heads
        # and merges a real ring adds) doubles, and the expansion reads it
        r = -(-m // k)
        lr_ = _log2ceil(r)
        return {"rounds": lr_, "global_rows": 2 * m + r, "local_rows": 0, "small_rows": lr_ * r + m}
    raise ValueError(f"unknown rank algo {algo!r}")


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


# ---------------------------------------------------------------------------
# simulators (realized rounds/rows on a concrete ring + oracle dists)
# ---------------------------------------------------------------------------


def _sim_wyllie(d: np.ndarray, t: np.ndarray) -> Tuple[np.ndarray, int]:
    rounds = _log2ceil(len(t))
    for _ in range(rounds):
        d = d + d[t]
        t = t[t]
    return d, rounds


def _sim_ruling(
    d: np.ndarray, t: np.ndarray, k: int = 8
) -> Tuple[np.ndarray, Dict[str, int]]:
    """Numpy re-execution of _ruling_dist_from: adaptive phase-1 with
    the exactness cap, dense ruler ring, recombine."""
    m = len(t)
    tok = np.arange(m)
    is_term = t == tok
    is_stop = ((tok % k) == 0) | is_term
    d1, t1 = d.copy(), t.copy()
    frozen = is_term | is_stop[t1]
    cap = _log2ceil(m)
    r1 = 0
    while not frozen.all() and r1 < cap:
        nd = np.where(frozen, d1, d1 + d1[t1])
        nt = np.where(frozen, t1, t1[t1])
        d1, t1 = nd, nt
        frozen = is_term | is_stop[t1]
        r1 += 1
    mr = (m + k - 1) // k
    r_tok = np.arange(mr) * k

    def dense(tt):
        return np.where(is_term[tt], mr, tt // k)

    rD = np.append(d1[r_tok], 0)
    rT = np.append(dense(t1[r_tok]), mr)
    rD, dense_rounds = _sim_wyllie(rD, rT)
    dist = d1 + rD[dense(t1)]
    counts = {
        "rounds": r1,
        "global_rows": r1 * m + dense_rounds * (mr + 1),
        "local_rows": 0,
        "small_rows": m,
    }
    return dist, counts


def _sim_blocked(
    succ: np.ndarray, block: int = 1024, k: int = 8
) -> Tuple[np.ndarray, Dict[str, int]]:
    m = len(succ)
    # mirror _blocked_dist: clamp the block to the lane-padded ring,
    # pad to a block multiple (self-loop pads), phase B over mp
    b = min(block, max(128, -(-m // 128) * 128))
    mp = -(-m // b) * b
    succ = np.concatenate([succ.astype(np.int64), np.arange(m, mp)])
    tok = np.arange(mp)
    d = np.where(succ == tok, 0, 1)
    t = succ.copy()
    la = _log2ceil(b)
    for _ in range(la):
        active = (t // b == tok // b) & (t != tok)
        d = np.where(active, d + d[t], d)
        t = np.where(active, t[t], t)
    dist, counts = _sim_ruling(d, t, k=k)
    counts["local_rows"] = la * mp
    return dist[:m], counts


def _sim_coalesced(
    succ: np.ndarray, r_pad: Optional[int] = None, k: int = 8
) -> Tuple[np.ndarray, Dict[str, int]]:
    m = len(succ)
    tok = np.arange(m)
    heads = run_heads(succ)
    n_runs = int(heads.sum())
    r = r_pad if r_pad is not None else m
    if n_runs > r:
        raise ValueError(f"ring_budget {r} < n_runs {n_runs}")
    head_tok = np.flatnonzero(heads)
    run_id = np.cumsum(heads) - 1
    tail_tok = np.append(head_tok[1:], m) - 1
    succ_tail = succ[tail_tok]
    is_term_run = succ_tail == tail_tok
    w = (tail_tok - head_tok) + np.where(is_term_run, 0, 1)
    t = np.where(is_term_run, n_runs, run_id[succ_tail])
    # sink node + budget pads (self-loops), mirroring _coalesced_dist
    rp = max(128, -(-r // 128) * 128)
    w1 = np.zeros(rp + 1, np.int64)
    t1 = np.arange(rp + 1)
    w1[:n_runs] = w
    t1[:n_runs] = np.where(t == n_runs, rp, t)  # terminals -> sink slot rp
    dist_c, counts = _sim_ruling(w1, t1, k=k)
    dist = dist_c[run_id] - (tok - head_tok[run_id])
    # the succ[tail_tok] + run_id[succ_tail] contraction gathers (two
    # rp-row random gathers into O(m) tables)
    counts["global_rows"] += 2 * rp
    counts["n_runs"] = n_runs
    return dist, counts


def simulate(
    succ: np.ndarray,
    algo: str,
    k: int = 8,
    block: int = 1024,
    r_pad: Optional[int] = None,
) -> Tuple[np.ndarray, Dict[str, int]]:
    """(dist, counts) — realized gather-row counts of `algo` on a real
    ring plus the distances themselves (host oracle: every algorithm
    must produce bit-identical distances)."""
    m = len(succ)
    tok = np.arange(m)
    if algo == "wyllie":
        d, rounds = _sim_wyllie(np.where(succ == tok, 0, 1), succ.copy())
        return d, {
            "rounds": rounds,
            "global_rows": rounds * m,
            "local_rows": 0,
            "small_rows": 0,
        }
    if algo == "ruling":
        return _sim_ruling(np.where(succ == tok, 0, 1), succ.copy(), k=k)
    if algo == "blocked":
        return _sim_blocked(succ, block=block, k=k)
    if algo == "coalesced":
        return _sim_coalesced(succ, r_pad=r_pad, k=k)
    raise ValueError(f"unknown rank algo {algo!r}")
