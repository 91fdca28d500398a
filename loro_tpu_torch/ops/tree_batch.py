"""Batched movable-tree merge: the port of loro_tpu/ops/tree_batch.py.

Reference semantics: crates/loro-internal/src/diff_calc/tree.rs.  Moves
apply in global (lamport, peer, counter) order; a move whose new parent
lies in the target's subtree at that moment is skipped
(``effected = False``, tree.rs:499-508).  Deletion is a move under
TRASH.

The replay is sequential within a doc and independent across docs.  On
a CUDA tensor tree_merge_batch and tree_replay_log_batch launch the
hand-written kernel csrc/tree_replay.cu (one lane replays one doc, its
parent table in shared memory, 1 to 32 docs a warp by plan_replay) or
raise; on a CPU tensor they run
tree_merge_batch_plain, the same replay vectorized over docs with a
Python loop over moves and an inner loop while any doc still walks.
chip_smoke.py holds the kernel against the plain version on the card.
Sibling order (fractional index) is resolved on the host, as in JAX.

The host side (extract_tree_ops, extract_tree_from_payload,
positions_of, pad_tree_cols) is numpy, as in the JAX package.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.change import TreeMove
from ..core.ids import TreeID
from ..errors import KernelLaunchError

ROOT = -1
TRASH = -2
ABSENT = -3
SMEM_LIMIT = 232_448  # opt-in dynamic shared memory of one block on sm_90
SM_SMEM = 233_472  # shared memory of one SM on sm_90 (228 KB)
CTA_RESERVED_SMEM = 1024  # the system's shared memory of each CTA on sm_90
MAX_CTAS_PER_SM = 32  # resident CTAs of one SM on sm_90
MAX_DOCS_PER_WARP = 32  # one lane a doc
DOCS_PER_WARP = (1, 2, 4, 8, 16, 32)
WARPS_PER_SM = 8  # the warps (CTAs) a SM is planned to hold at once: two a scheduler
WARP_SLOTS, TILE_CAP, SLOT_BYTES = 512, 32, 13  # the move tile: moves a warp, moves a doc, bytes a move
STAMPS = 8  # int64 a warp of the timed kernel
VARIANTS = ("smem", "global")

# Launches of the replay kernel by where its tables live, incremented
# only where the kernel is launched.
LAUNCHES: Dict[str, int] = {"smem": 0, "global": 0}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


class TreeOpCols(NamedTuple):
    """[M] (or [D, M]) move log sorted by (lamport, peer, counter).

    target: int32 node index (per-doc node dictionary)
    parent: int32 node index, ROOT, or TRASH
    valid:  bool padding mask
    """

    target: object
    parent: object
    valid: object


class TreeLogCols(NamedTuple):
    """[D, M] UNSORTED device-resident move log (append order; the
    resident batch's buffer).  Peer halves are int64 tensors holding the
    uint32 values (an int32 view would sort a peer with bit 63 set
    first); the global move key (lamport, peer, counter) is sorted on
    the device at each replay."""

    lamport: torch.Tensor  # int32
    peer_hi: torch.Tensor  # int64 holding uint32
    peer_lo: torch.Tensor  # int64 holding uint32
    counter: torch.Tensor  # int32
    target: torch.Tensor  # int32 node ordinal
    parent: torch.Tensor  # int32 node ordinal, ROOT, or TRASH
    valid: torch.Tensor  # bool


def _as_cols(cols: TreeOpCols) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The columns as [D, M] tensors (numpy arrays as CPU tensors)."""
    target, parent, valid = (torch.as_tensor(c) for c in cols)
    if target.dim() != 2 or parent.shape != target.shape or valid.shape != target.shape:
        raise ValueError(f"tree columns must share one [D, M] shape, got {[tuple(c.shape) for c in cols]}")
    return target, parent, valid


def replay_plain(target: torch.Tensor, parent: torch.Tensor, valid: torch.Tensor, n_nodes: int,
                 d_max: Optional[int] = None, order: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain torch version of the kernel on [D, M] columns, on their
    device: (parents int32 [D, n_nodes], effected bool [D, M], the
    dependent loads of each doc's replay int64 [D]: its moves plus the
    walk steps they took).  With `order` the k-th move of a doc is its
    row order[k] and effected is written back at that row (the kernel's
    permutation form)."""
    if n_nodes < 1:
        raise ValueError(f"n_nodes must be >= 1, got {n_nodes}")
    if d_max is None:
        d_max = n_nodes
    d, m = target.shape
    dev = target.device
    if order is not None:
        target, parent, valid = (c.gather(1, order.long()) for c in (target, parent, valid))
    target, parent = target.to(torch.int32), parent.to(torch.int32)
    valid = valid.to(torch.bool)
    table = torch.full((d, n_nodes), ABSENT, dtype=torch.int32, device=dev)
    eff = torch.zeros((d, m), dtype=torch.bool, device=dev)
    loads = torch.full((d,), m, dtype=torch.int64, device=dev)
    docs = torch.arange(d, device=dev)
    gone = torch.full((d,), ROOT - 10, dtype=torch.int32, device=dev)
    for k in range(m):
        t, p, v = target[:, k], parent[:, k], valid[:, k]
        cur = p.clone()
        hit = torch.zeros(d, dtype=torch.bool, device=dev)
        for _ in range(max(d_max, 0)):
            walking = (cur >= 0) & ~hit
            if not bool(walking.any()):
                break
            hit = hit | (walking & (cur == t))
            nxt = torch.where(hit, gone, table[docs, cur.clamp(0, n_nodes - 1)])
            cur = torch.where(walking, nxt, cur)
            loads += walking
        ok = v & ~((hit | (cur == t)) & (p >= 0))
        table[docs[ok], t[ok].clamp(0, n_nodes - 1)] = p[ok]
        eff[:, k] = ok
    if order is not None:
        eff = torch.zeros_like(eff).scatter_(1, order.long(), eff)
    return table, eff, loads


def tree_merge_batch_plain(cols: TreeOpCols, n_nodes: int, d_max: Optional[int] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of tree_merge_batch, run on the columns'
    device."""
    parents, eff, _ = replay_plain(*_as_cols(cols), n_nodes, d_max)
    return parents, eff


def tree_merge_doc(cols: TreeOpCols, n_nodes: int, d_max: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One doc's [M] sorted move log -> (parents int32 [n_nodes], effected
    bool [M]): tree_merge_batch on a batch of one."""
    parents, eff = tree_merge_batch(TreeOpCols(*(torch.as_tensor(c)[None] for c in cols)), n_nodes, d_max)
    return parents[0], eff[0]


def tree_merge_batch(cols: TreeOpCols, n_nodes: int, d_max: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """[D, M] sorted move logs -> (parents int32 [D, n_nodes] with ABSENT
    for never-created nodes, effected bool [D, M]).

    `d_max` bounds the cycle-check walk; the default (n_nodes) is always
    sound, a smaller bound only where the workload caps the depth.  On
    CUDA tensors the kernel runs (its layout by plan_replay); on
    CPU tensors (numpy arrays are taken as such) the plain version."""
    target, parent, valid = _as_cols(cols)
    if target.device.type == "cpu":
        return tree_merge_batch_plain((target, parent, valid), n_nodes, d_max)
    return launch_kernel(target, parent, valid, n_nodes, d_max)


def _sort_order(cols: TreeLogCols) -> torch.Tensor:
    """int64 [D, M]: each doc's rows in (lamport, peer u64, counter)
    order, invalid rows last (at lamport 2^31 - 1), equal keys in row
    order: stable sorts from the least significant key up.  The peer is
    one int64 key, the uint64 less 2^63 (exact), so it sorts as the
    uint64."""
    lam = torch.where(cols.valid, cols.lamport, torch.full_like(cols.lamport, 2**31 - 1))
    peer = (cols.peer_hi - 2**31) * 2**32 + cols.peer_lo
    perm = torch.arange(lam.shape[1], device=lam.device).expand(lam.shape).contiguous()
    for key in (cols.counter, peer, lam):
        _, idx = torch.sort(key.gather(1, perm), dim=1, stable=True)
        perm = perm.gather(1, idx)
    return perm


def tree_replay_log_batch(cols: TreeLogCols, n_nodes: int, d_max: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort each doc's standing move log by the global move key and replay
    it: (parents int32 [D, n_nodes], effected bool [D, M] in ROW
    (append) order; the host resolves sibling positions from the last
    effected non-delete move per node in key order).  The kernel takes
    the sort's permutation and writes effected back in row order."""
    order = _sort_order(cols)
    if cols.target.device.type == "cpu":
        parents, eff, _ = replay_plain(cols.target, cols.parent, cols.valid, n_nodes, d_max, order=order)
        return parents, eff
    return launch_kernel(cols.target, cols.parent, cols.valid, n_nodes, d_max, order=order.to(torch.int32))


def is_deleted_batch(parents: torch.Tensor) -> torch.Tensor:
    """bool [D, N]: the node is trash-reachable.  Pointer doubling,
    ceil(log2(max(N, 2))) + 1 gathers (the JAX package's count), which
    cover any depth <= N."""
    n = parents.shape[1]
    p = parents
    for _ in range(int(np.ceil(np.log2(max(n, 2)))) + 1):
        p = torch.where(p >= 0, p.gather(1, p.clamp(0, n - 1).long()), p)
    return p == TRASH


# ---- host: columns from changes or payloads ------------------------------------


def extract_tree_ops(changes, cid):
    """Host: explode the TreeMove ops of `cid` into sorted columns and a
    node dictionary (first-seen order).  Returns (TreeOpCols of numpy
    arrays, nodes, row_positions aligned with rows; resolve winners with
    positions_of once the replay reports which moves were effected)."""
    rows = []  # (lamport, peer, counter, target, parent, position)
    node_ids = {}
    nodes = []

    def node_idx(tid):
        if tid not in node_ids:
            node_ids[tid] = len(nodes)
            nodes.append(tid)
        return node_ids[tid]

    for ch in changes:
        for op in ch.ops:
            if op.container != cid or not isinstance(op.content, TreeMove):
                continue
            c = op.content
            lam = ch.lamport + (op.counter - ch.ctr_start)
            t = node_idx(c.target)
            if c.is_delete:
                p = TRASH
            elif c.parent is None:
                p = ROOT
            else:
                p = node_idx(c.parent)
            rows.append((lam, ch.peer, op.counter, t, p, c.position))
    rows.sort(key=lambda r: (r[0], r[1], r[2]))
    m = len(rows)
    target = np.asarray([r[3] for r in rows], np.int32)
    parent = np.asarray([r[4] for r in rows], np.int32)
    row_positions = [r[5] for r in rows]
    cols = TreeOpCols(target=target, parent=parent, valid=np.ones(m, bool))
    return cols, nodes, row_positions


def positions_of(cols: TreeOpCols, row_positions, effected) -> dict:
    """Winning fractional index per node: the last *effected*, non-delete
    move in key order (deletes ship position None, and a move that lost
    its cycle check must not clobber the position the tree has)."""
    out: dict = {}
    effected = np.asarray(effected)
    for i in range(len(row_positions)):
        if not effected[i]:
            continue
        if int(cols.parent[i]) == TRASH:
            continue
        out[int(cols.target[i])] = row_positions[i]
    return out


def pad_tree_cols(cols: TreeOpCols, m: int) -> TreeOpCols:
    """Numpy columns padded to m rows: target 0, parent ROOT, invalid."""

    def pad(a, fill, dtype):
        out = np.full(m, fill, dtype)
        out[: a.shape[0]] = a
        return out

    return TreeOpCols(
        target=pad(cols.target, 0, np.int32),
        parent=pad(cols.parent, ROOT, np.int32),
        valid=pad(cols.valid, False, bool),
    )


class _LazyPositions:
    """Row-indexed fractional-index bytes, sliced from the payload on
    demand (positions_of touches only effected rows: no per-row copy for
    the losers)."""

    __slots__ = ("payload", "off", "ln", "has")

    def __init__(self, payload, off, ln, has):
        self.payload = payload
        self.off = off
        self.ln = ln
        self.has = has

    def __len__(self):
        return len(self.off)

    def __getitem__(self, i):
        if not self.has[i]:
            return None
        o = int(self.off[i])
        return bytes(self.payload[o : o + int(self.ln[i])])

    def __eq__(self, other):
        return list(self) == list(other)


def extract_tree_from_payload(payload: bytes, cid):
    """The native path of extract_tree_ops: binary updates payload ->
    (TreeOpCols, nodes, row_positions) without Python change objects.
    Nodes are in packed wire-id order (np.unique), as in the JAX
    package.  Raises CodecDecodeError (a ValueError) on malformed
    payloads and RuntimeError when the codec cannot be built: there is
    no Python fallback here."""
    from ..codec.binary import read_tables
    from ..native import explode_tree_payload
    from .columnar import pack_wire_ids

    peers_wire, _keys, cids, _r = read_tables(payload)
    try:
        target = cids.index(cid)
    except ValueError:
        return TreeOpCols(
            target=np.zeros(0, np.int32),
            parent=np.zeros(0, np.int32),
            valid=np.zeros(0, bool),
        ), [], []
    out = explode_tree_payload(payload, target)
    n = len(out["lamport"])
    peer_u64 = np.asarray(peers_wire, np.uint64)
    order = np.lexsort(
        (out["counter"], peer_u64[out["peer_idx"]] if n else out["peer_idx"], out["lamport"])
    )
    tp = out["target_peer_idx"][order].astype(np.int64)
    tc = out["target_ctr"][order].astype(np.int64)
    fl = out["flags"][order]
    pp = out["parent_peer_idx"][order].astype(np.int64)
    pc = out["parent_ctr"][order].astype(np.int64)
    po = out["pos_off"][order]
    pl = out["pos_len"][order]
    # vectorized node dictionary: (wire peer index, counter) packed into
    # int64, unique + inverse
    has_parent = (fl & 4) != 0
    t_packed = pack_wire_ids(tp, tc)
    p_packed = pack_wire_ids(pp[has_parent], pc[has_parent])
    uniq, inv = np.unique(np.concatenate([t_packed, p_packed]), return_inverse=True)
    nodes = [TreeID(int(peers_wire[int(k) >> 32]), int(k) & 0xFFFFFFFF) for k in uniq]
    target_col = inv[:n].astype(np.int32)
    parent_col = np.full(n, ROOT, np.int32)
    parent_col[has_parent] = inv[n:].astype(np.int32)
    parent_col[(fl & 2) != 0] = TRASH
    cols = TreeOpCols(target=target_col, parent=parent_col, valid=np.ones(n, bool))
    return cols, nodes, _LazyPositions(payload, po, pl, (fl & 8) != 0)


# ---- the CUDA kernel ---------------------------------------------------------------

_lib_handle: Optional[ctypes.CDLL] = None
_sm_count: Dict[int, int] = {}


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        from .._build import library

        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib = library("tree_replay")
        lib.tree_replay_launch.argtypes = [ptr] * 6 + [i32] * 7 + [ptr]
        lib.tree_replay_launch.restype = i32
        lib.tree_replay_launch_timed.argtypes = [ptr] * 7 + [i32] * 7 + [ptr]
        lib.tree_replay_launch_timed.restype = i32
        lib.tree_smem_chase.argtypes = [i32, i32, ptr, ptr, ptr]
        lib.tree_smem_chase.restype = i32
        lib.tree_replay_error_string.argtypes = [i32]
        lib.tree_replay_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def _check(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().tree_replay_error_string(err).decode()
        raise KernelLaunchError(f"tree_replay {what} failed: cudaError {err} ({msg})")


def table_stride(n_nodes: int) -> int:
    """Words between two docs' walk tables in shared memory: the n_nodes
    + 1 slots (slot n stands for every ordinal past n - 1) rounded up to
    an odd count, so lanes at one index hit distinct banks."""
    return (n_nodes + 1) | 1


def tile_moves(docs_per_warp: int) -> int:
    """Moves of each doc a warp stages in shared memory at a time: 32,
    or 16 at 32 docs a warp (WARP_SLOTS moves a warp)."""
    return TILE_CAP if docs_per_warp * TILE_CAP <= WARP_SLOTS else WARP_SLOTS // docs_per_warp


@dataclass(frozen=True)
class ReplayPlan:
    """How a launch lays out its docs: `variant` ("smem" or "global",
    where the tables live) and `docs_per_warp` (a power of two in 1..32;
    one warp a CTA, one lane a doc)."""

    variant: str
    docs_per_warp: int
    n_nodes: int

    @property
    def stride(self) -> int:
        return table_stride(self.n_nodes) if self.variant == "smem" else self.n_nodes

    @property
    def tile(self) -> int:
        return tile_moves(self.docs_per_warp)

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory a CTA: the walk tables and their stop
        word (smem variant), and the move tile."""
        tables = 4 * (self.docs_per_warp * self.stride + 1) if self.variant == "smem" else 0
        return tables + SLOT_BYTES * self.docs_per_warp * self.tile

    def warps(self, n_docs: int) -> int:
        return -(-n_docs // self.docs_per_warp)


def plan_variant(n_nodes: int, variant: Optional[str] = None) -> Tuple[str, int]:
    """(variant, the most docs a warp): "smem" where one doc's table and
    its move tile fit SMEM_LIMIT, with the largest power of two of docs
    (up to 32) whose tables and tile fit, else "global" (the tables in
    the parents output) at up to 32.  An explicit "smem" whose one table
    does not fit raises ValueError."""
    if variant not in (None,) + VARIANTS:
        raise ValueError(f"tree_replay variant {variant!r}: accepted {VARIANTS} or None")
    if n_nodes < 1:
        raise ValueError(f"n_nodes must be >= 1, got {n_nodes}")
    fits = [g for g in DOCS_PER_WARP if ReplayPlan("smem", g, n_nodes).smem_bytes <= SMEM_LIMIT]
    if variant == "smem" and not fits:
        raise ValueError(f"n_nodes={n_nodes}: one table of {4 * table_stride(n_nodes)} bytes and its move tile "
                         f"pass {SMEM_LIMIT}")
    if variant == "global" or not fits:
        return "global", MAX_DOCS_PER_WARP
    return "smem", fits[-1]


def plan_replay(n_docs: int, n_nodes: int, n_sm: int, variant: Optional[str] = None) -> ReplayPlan:
    """The launch's layout, from the number of docs and the card's SMs:
    the docs a warp that replay every doc in the fewest waves of warps
    (a SM planned to hold WARPS_PER_SM warps, or fewer where its shared
    memory or its CTA cap holds fewer of that layout's CTAs), the fewest
    docs a warp among those (a doc's walk then waits on fewer lanes').
    No argument here is a tuning knob: `variant` only forces where the
    tables live (plan_variant)."""
    if n_docs < 0 or n_sm < 1:
        raise ValueError(f"plan_replay needs n_docs >= 0 and n_sm >= 1, got {n_docs}, {n_sm}")
    var, most = plan_variant(n_nodes, variant)

    def waves(plan: ReplayPlan) -> int:
        per_sm = min(WARPS_PER_SM, MAX_CTAS_PER_SM, SM_SMEM // (plan.smem_bytes + CTA_RESERVED_SMEM))
        return -(-plan.warps(n_docs) // (n_sm * per_sm))

    plans = [ReplayPlan(var, g, n_nodes) for g in DOCS_PER_WARP if g <= most]
    return min(plans, key=lambda p: (waves(p), p.docs_per_warp))


def sm_count(device) -> int:
    """The SMs of a CUDA device (cached)."""
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _sm_count:
        _sm_count[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sm_count[idx]


def _launch(target: torch.Tensor, parent: torch.Tensor, valid: torch.Tensor, n_nodes: int,
            d_max: Optional[int], order: Optional[torch.Tensor], plan: Optional[ReplayPlan],
            variant: Optional[str] = None, stamps: bool = False):
    """Check the columns, plan (unless `plan` is given), launch, raise on
    a launch error: (parents, effected, plan, stamps or None)."""
    tensors = {"target": target, "parent": parent, "valid": valid}
    if order is not None:
        tensors["order"] = order
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != target.device:
            raise ValueError(f"tree_replay needs every column on one CUDA device ({name} is on {t.device})")
        want = torch.bool if name == "valid" else torch.int32
        if t.dtype != want:
            raise TypeError(f"tree_replay needs {name} as {want}, got {t.dtype}")
        if t.dim() != 2 or t.shape != target.shape:
            raise ValueError(f"tree_replay needs [D, M] columns of one shape, {name} is {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"tree_replay needs contiguous columns ({name} is not)")
    if n_nodes < 1:
        raise ValueError(f"n_nodes must be >= 1, got {n_nodes}")
    d_max = n_nodes if d_max is None else min(int(d_max), 2**31 - 1)  # past any walk: an int32 for the kernel
    d, m = target.shape
    dev = target.device
    if plan is None:
        plan = plan_replay(d, n_nodes, sm_count(dev), variant)
    if plan.n_nodes != n_nodes or plan.docs_per_warp not in DOCS_PER_WARP or plan.smem_bytes > SMEM_LIMIT:
        raise ValueError(f"tree_replay plan {plan} does not fit n_nodes={n_nodes} and {SMEM_LIMIT} bytes")
    parents = torch.empty((d, n_nodes), dtype=torch.int32, device=dev)
    eff = torch.empty((d, m), dtype=torch.bool, device=dev)
    st = torch.zeros((plan.warps(d), STAMPS), dtype=torch.int64, device=dev) if stamps else None
    args = [target.data_ptr(), parent.data_ptr(), valid.data_ptr(), None if order is None else order.data_ptr(),
            parents.data_ptr(), eff.data_ptr()]
    if st is not None:
        args.append(st.data_ptr())
    args += [d, m, n_nodes, d_max, int(plan.variant == "smem"), plan.docs_per_warp, plan.stride,
             torch.cuda.current_stream(dev).cuda_stream]
    with torch.cuda.device(dev):
        err = (_lib().tree_replay_launch_timed if stamps else _lib().tree_replay_launch)(*args)
    _check(err, "kernel launch")
    return parents, eff, plan, st


def launch_kernel(target: torch.Tensor, parent: torch.Tensor, valid: torch.Tensor, n_nodes: int,
                  d_max: Optional[int] = None, order: Optional[torch.Tensor] = None,
                  variant: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch csrc/tree_replay.cu on [D, M] CUDA columns (int32 target and
    parent, bool valid, optional int32 `order`): (parents int32
    [D, n_nodes], effected bool [D, M]).  The layout is plan_replay's;
    `variant` forces a table variant (plan_variant), else the automatic
    route.  No device-to-host sync.  Raises on anything the kernel does
    not take, and KernelLaunchError on a launch error."""
    parents, eff, plan, _ = _launch(target, parent, valid, n_nodes, d_max, order, None, variant)
    LAUNCHES[plan.variant] += 1
    return parents, eff


def launch_timed(target: torch.Tensor, parent: torch.Tensor, valid: torch.Tensor, n_nodes: int,
                 d_max: Optional[int] = None, order: Optional[torch.Tensor] = None,
                 plan: Optional[ReplayPlan] = None):
    """The timed instantiation of launch_kernel (clock64 counters inside;
    not counted in LAUNCHES): (parents, effected, plan, int64 stamps
    [warps, STAMPS], read by replay_split).  `plan` replaces
    plan_replay's layout (the docs-a-warp sweep)."""
    return _launch(target, parent, valid, n_nodes, d_max, order, plan, stamps=True)


def launch_plan(target: torch.Tensor, parent: torch.Tensor, valid: torch.Tensor, n_nodes: int, plan: ReplayPlan,
                d_max: Optional[int] = None, order: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """launch_kernel at a given layout (`dataclasses.replace` of a plan:
    the docs-a-warp sweep and the card tests), counted in LAUNCHES."""
    parents, eff, _, _ = _launch(target, parent, valid, n_nodes, d_max, order, plan)
    LAUNCHES[plan.variant] += 1
    return parents, eff


def replay_split(stamps: torch.Tensor, n_docs: int, m: int, docs_per_warp: int) -> Dict[str, float]:
    """A timed launch's stamps ([warps, STAMPS] int64, SM cycles) read as
    where a warp's time goes: the longest warp's cycles and the shares,
    summed over warps, of walk steps, of waits for staged moves and of
    move bookkeeping; cycles a warp walk step; the active lanes a step
    over 32 and over the warp's docs; a doc's mean walk a move and the
    warp's walk a move (the lanes waiting on the longest walk at each
    meeting: a move, or a tile)."""
    st = stamps.to(torch.float64).cpu()
    tot = st.sum(dim=0)
    total, walk, wait, book, iters, active, steps, max_steps = (float(x) for x in tot)
    live = float(st[:, 0].max())
    return {
        "warps": int(st.shape[0]), "docs_per_warp": docs_per_warp, "longest_warp_cycles": live,
        "mean_warp_cycles": total / st.shape[0], "walk_share": walk / total, "wait_share": wait / total,
        "book_share": book / total, "walk_cycles_per_step": walk / max(iters, 1.0),
        "book_cycles_per_move": book / max(st.shape[0] * m, 1), "wait_cycles": wait / st.shape[0],
        "active_lanes_of_32": active / max(32.0 * iters, 1.0),
        "active_lanes_of_docs": active / max(min(docs_per_warp, n_docs) * iters, 1.0),
        "mean_walk_per_move": steps / max(n_docs * m, 1), "warp_walk_per_move": max_steps / max(st.shape[0] * m, 1),
    }


CHASE_STEPS = 4096


def smem_load_cycles(device) -> float:
    """SM cycles of one dependent shared-memory load on `device`: one
    thread's chase of CHASE_STEPS loads (tree_smem_chase), cycles over
    steps.  For the kernel's latency bound; not counted in LAUNCHES."""
    dev = torch.device(device)
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().tree_smem_chase(1024, CHASE_STEPS, cycles.data_ptr(), sink.data_ptr(),
                                     torch.cuda.current_stream(dev).cuda_stream)
    _check(err, "shared-memory chase")
    return float(cycles.item()) / CHASE_STEPS
