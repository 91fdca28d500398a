"""Batched Fugue sequence order for the fleet text merge — the torch
counterpart of loro_tpu/ops/fugue_batch.py: the element-level merge
(fugue_order .. merge_docs, and the row-order-free SeqColumnsU
variants) and the chain-contracted merge (chain_materialize ..
chain_merge_docs_checksum_v), the packed uint8 transport of a chunk
(pack_chain_doc_into .. chain_merge_docs_packed_checksum), and the
resident text path's device ops on SeqColumnsU (chain_merge_docs_u,
materialize_by_key), and the op-axis-sharded ring rank over a device
mesh (make_ring_rank_sharded).

Every function takes an explicit leading doc axis ([D, N] / [D, C]
tensors) where the JAX package vmaps one doc; nothing is jitted.  Per
doc the merge is:

1. one stable sort of nodes (elements or chains) by (parent, side) —
   (peer, counter) order within sibling groups comes from the row-order
   contract, or from explicit sibling keys — and the Euler-tour
   successor ring over two tokens per node (_ring_and_anchors);
2. list ranking, distance to the ring terminal (_rank_dist: a CUDA
   kernel of ops/list_rank.py on the card, or a plain torch algorithm;
   the coalesced rank contracts index-consecutive runs first);
3. anchor distances -> rank keys (_order_core);
4. placement: the element path compacts visible rows by a rank
   histogram (_compact); the chain path places all elements by one
   stable sort (_place_by_chain_sort) or the histogram scatter
   (_place_by_chain_scatter);
5. an order-sensitive per-doc checksum (_weighted_checksum).

Bit-exactness with JAX: int32 results are computed in int64 and
narrowed only where the values fit; uint32 arithmetic (the checksum,
the 0xFFFFFFFF sort key) is int64 with explicit masks; out-of-range
gathers are clipped and out-of-range scatters go to explicit dump slots
that are sliced away, exactly where the JAX code clips or drops.  Dump
slots are the only scatter targets that repeat.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..errors import ConfigError
from ..utils import tracing
from . import list_rank

BIG = 2**30  # rank of pads / unreachable nodes (jnp.int32(2**30) in JAX)
_U32 = 0xFFFFFFFF


class SeqColumns(NamedTuple):
    """Columnar element table, [N] or [D, N] (padded to fixed N).

    parent: int32  fugue parent element index; -1 = virtual root
    side:   int32  0 = Left child, 1 = Right child
    peer:   int32  peer rank (order-preserving w.r.t. u64 peer ids)
    counter:int32
    deleted:bool   tombstone flag
    content:int32  codepoint / value-dictionary index
    valid:  bool   False for padding rows
    """

    parent: torch.Tensor
    side: torch.Tensor
    peer: torch.Tensor
    counter: torch.Tensor
    deleted: torch.Tensor
    content: torch.Tensor
    valid: torch.Tensor


class SeqColumnsU(NamedTuple):
    """Row-order-free element table, [N] or [D, N]: sibling order comes
    from explicit (peer_hi, peer_lo, counter) keys, so rows may sit in
    any order.  peer_hi / peer_lo are uint32 on the host and int64
    (holding the uint32 values) as tensors.

    parent: int32, side: int32, peer_hi / peer_lo: uint32 halves of the
    u64 peer id, counter: int32 (non-negative), deleted: bool,
    content: int32 (-1 = invisible anchor row), valid: bool
    """

    parent: torch.Tensor
    side: torch.Tensor
    peer_hi: torch.Tensor
    peer_lo: torch.Tensor
    counter: torch.Tensor
    deleted: torch.Tensor
    content: torch.Tensor
    valid: torch.Tensor


class ChainColumns(NamedTuple):
    """Chain-contracted document batch (see columnar.contract_chains):
    chain-level tree arrays [D, C] + element-level arrays [D, N].  The
    same tuple holds numpy arrays on the host (columnar.chain_columns)
    and tensors on the device (chain_columns_to_torch)."""

    c_parent: torch.Tensor  # int32 [D, C]
    c_side: torch.Tensor  # int32 [D, C]
    c_valid: torch.Tensor  # bool  [D, C]
    head_row: torch.Tensor  # int32 [D, C]
    chain_id: torch.Tensor  # int32 [D, N] element -> chain
    deleted: torch.Tensor  # bool  [D, N]
    content: torch.Tensor  # int32 [D, N]
    valid: torch.Tensor  # bool  [D, N]


_CHAIN_DTYPES = {
    "c_parent": np.int32,
    "c_side": np.int32,
    "c_valid": np.bool_,
    "head_row": np.int32,
    "chain_id": np.int32,
    "deleted": np.bool_,
    "content": np.int32,
    "valid": np.bool_,
}


_SEQ_DTYPES = {
    "parent": np.int32,
    "side": np.int32,
    "peer": np.int32,
    "counter": np.int32,
    "deleted": np.bool_,
    "content": np.int32,
    "valid": np.bool_,
    "peer_hi": np.uint32,
    "peer_lo": np.uint32,
}


def rank_bound(n: int) -> int:
    """Exclusive upper bound of rank keys for an n-node table: ring
    distances live in [0, 2*(n+1))."""
    return 2 * (n + 1)


def pad_bucket(n: int, floor: int = 64) -> int:
    """Next power-of-two bucket >= n."""
    b = floor
    while b < n:
        b *= 2
    return b


def pad_rows(a: np.ndarray, n: int, fill) -> np.ndarray:
    """`a` padded along its first axis to n rows of `fill`."""
    if a.shape[0] == n:
        return a
    out = np.full((n,) + a.shape[1:], fill, a.dtype)
    out[: a.shape[0]] = a
    return out


def stack_rows(arrays: Sequence[np.ndarray], n: int, fill, d_pad: int = 0, dtype=None) -> np.ndarray:
    """[max(d_pad, len(arrays)), n] numpy array of 1-D `arrays`: each
    padded with `fill` to n rows, then all-`fill` filler rows (dtype:
    the first array's unless given).  Padding each array (pad_rows) and
    stacking, written into one array."""
    out = np.full((max(d_pad, len(arrays)), n), fill, dtype or arrays[0].dtype)
    for i, a in enumerate(arrays):
        out[i, : a.shape[0]] = a
    return out


# fill of pad rows and of all-invalid filler docs: invalid, deleted, no content
SEQ_FILL = SeqColumns(parent=-1, side=0, peer=0, counter=0, deleted=True, content=-1, valid=False)


def pad_seq_columns(cols: SeqColumns, n: int) -> SeqColumns:
    """Pad numpy SeqColumns of one doc to n rows (invalid tail)."""
    return SeqColumns(*[pad_rows(a, n, fill) for a, fill in zip(cols, SEQ_FILL)])


def stack_seq_columns(per_doc, n: int, d_pad: Optional[int] = None) -> SeqColumns:
    """Numpy SeqColumns [d_pad, n] of a batch of docs, each given by
    SeqColumns' fields (SeqColumns, columnar.SeqExtract): a doc's rows
    then pad rows, then all-invalid filler docs up to d_pad (default: the
    batch size).  The same arrays as padding each doc (pad_seq_columns)
    and stacking, written into one array a column: at fleet depth the
    per-doc padded copies cost several times the stack."""
    return SeqColumns(*[stack_rows([getattr(c, f) for c in per_doc], n, fill, d_pad or 0)
                        for f, fill in zip(SeqColumns._fields, SEQ_FILL)])


def seq_columns_to_torch(np_cols, device: DeviceLike = "cuda"):
    """Carry numpy SeqColumns or SeqColumnsU (one doc [N] or a stacked
    batch [D, N]) onto `device` as tensors of the same type: int32 and
    bool keep their dtypes, the uint32 peer halves of SeqColumnsU become
    int64 holding the same values; one doc gains a leading doc axis of
    1.  Raises TypeError on any other dtype."""
    if not isinstance(np_cols, (SeqColumns, SeqColumnsU)):
        raise TypeError(f"expected SeqColumns or SeqColumnsU, got {type(np_cols).__name__}")
    dev = resolve_device(device)
    kind = type(np_cols)
    out = {}
    for f in kind._fields:
        a = np.asarray(getattr(np_cols, f))
        if a.dtype != _SEQ_DTYPES[f]:
            raise TypeError(f"{kind.__name__}.{f}: expected {np.dtype(_SEQ_DTYPES[f])}, got {a.dtype}")
        if a.ndim == 1:
            a = a[None, :]
        if a.ndim != 2:
            raise ValueError(f"{kind.__name__}.{f}: expected [N] or [D, N], got shape {a.shape}")
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        out[f] = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    shape = tuple(out["parent"].shape)
    for f, t in out.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{kind.__name__}.{f}: shape {tuple(t.shape)} != {shape}")
    return kind(**out)


def chain_columns_to_torch(np_cols, device: DeviceLike = "cuda") -> ChainColumns:
    """Carry numpy ChainColumns (the arrays the JAX package consumes,
    one doc [C]/[N] or a stacked batch [D, C]/[D, N]) onto `device` as
    tensors with the same dtypes (int32 and bool); one doc gains a
    leading doc axis of 1.  Raises TypeError on any other dtype."""
    dev = resolve_device(device)
    out = {}
    for f in ChainColumns._fields:
        a = np.asarray(getattr(np_cols, f))
        if a.dtype != _CHAIN_DTYPES[f]:
            raise TypeError(f"ChainColumns.{f}: expected {np.dtype(_CHAIN_DTYPES[f])}, got {a.dtype}")
        if a.ndim == 1:
            a = a[None, :]
        if a.ndim != 2:
            raise ValueError(f"ChainColumns.{f}: expected [N] or [D, N], got shape {a.shape}")
        out[f] = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    cols = ChainColumns(**out)
    d = cols.c_parent.shape[0]
    c = cols.c_parent.shape[1]
    n = cols.chain_id.shape[1]
    for f in ChainColumns._fields:
        want = (d, c) if f in ("c_parent", "c_side", "c_valid", "head_row") else (d, n)
        if tuple(getattr(cols, f).shape) != want:
            raise ValueError(f"ChainColumns.{f}: shape {tuple(getattr(cols, f).shape)} != {want}")
    return cols


# ---- plain rank algorithms (torch, batched [D, m]) -------------------------


def _double(d: torch.Tensor, t: torch.Tensor, n_steps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted pointer doubling on (dist, target) [D, m] int64 pairs."""
    for _ in range(n_steps):
        d, t = d + d.gather(1, t), t.gather(1, t)
    return d, t


def _wyllie_dist(succ: torch.Tensor) -> torch.Tensor:
    """Distance-to-terminal by pointer doubling: int32 [D, m] -> int32."""
    m = succ.shape[1]
    t = succ.to(torch.int64)
    tok = torch.arange(m, dtype=torch.int64, device=succ.device)
    d0 = (t != tok).to(torch.int64)
    d, _ = _double(d0, t, list_rank.ceil_log2(m))
    return d.to(torch.int32)


def make_ring_rank_sharded(mesh, m: int, algo: str = "wyllie"):
    """Op-axis-sharded Wyllie ranking over a ("docs", "ops") mesh
    (parallel/mesh.py; a device list is one column): fn(succ int32
    [D, m], tensor or numpy) -> dist int32 [D, m] on the mesh's first
    device, equal to _wyllie_dist.  Each op shard owns m / S contiguous
    ring rows (global ids; shard c's first is c * m / S) of its row's
    docs on its device.  A doubling round gathers the row's (dist, succ)
    tables onto each shard's device (the all-gather, as copies) and
    updates only the shard's rows.

    "wyllie": ceil(log2 m) rounds.  "blocked": first a shard-local phase
    A (a pointer composes only while its target is a row of its own
    shard: ceil(log2(m / S)) rounds, no copies), then adaptive rounds
    that stop, a mesh row at a time, once a round changed no target of
    the row's shards (terminals are the only fixpoint; the round cap
    keeps any ring exact).  The stop check is one host read a round for
    all rows, the counterpart of the JAX package's psum vote; fn.rounds
    holds each row's all-gather rounds of the last call.

    ConfigError for another algo, or when S does not divide m or the
    rows do not divide D; ValueError for an entry outside [0, m)."""
    from ..parallel.mesh import DOC_AXIS, OP_AXIS, make_mesh

    if algo not in ("wyllie", "blocked"):
        raise ConfigError("sharded rank algo", algo, "wyllie|blocked")
    mesh = make_mesh(mesh)
    n_rows, n_sh = mesh.shape[DOC_AXIS], mesh.shape[OP_AXIS]
    if m % n_sh:
        raise ConfigError("ring length", m, f"a multiple of the mesh's op axis ({n_sh})")
    ms = m // n_sh
    n_steps = list_rank.ceil_log2(m)

    def gather_step(tabs, devs):
        fulls = {}  # the row's whole table, copied once onto each distinct device
        for dev in dict.fromkeys(devs):
            fulls[dev] = [torch.cat([tab[k].to(dev) for tab in tabs], 1) for k in (0, 1)]
        out = []
        for (d, t), dev in zip(tabs, devs):
            idx = t.long()
            fd, ft = fulls[dev]
            out.append((d + fd.gather(1, idx), ft.gather(1, idx)))
        return out

    def phase_a(d, t, tok, tok0):
        for _ in range(list_rank.ceil_log2(ms)):
            lt = t.long() - tok0
            in_shard = (lt >= 0) & (lt < ms) & (t != tok)
            lt = lt.clamp(0, ms - 1)
            d, t = torch.where(in_shard, d + d.gather(1, lt), d), torch.where(in_shard, t.gather(1, lt), t)
        return d, t

    def run(succ):
        s = succ if isinstance(succ, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(succ))
        if s.dtype != torch.int32:
            raise TypeError(f"succ must be int32, got {s.dtype}")
        if s.dim() != 2 or s.shape[1] != m:
            raise ValueError(f"succ must be [D, {m}], got shape {tuple(s.shape)}")
        if s.shape[0] % n_rows:
            raise ConfigError("docs", s.shape[0], f"a multiple of the mesh's doc axis ({n_rows})")
        if s.numel() and (int(s.min()) < 0 or int(s.max()) >= m):
            raise ValueError("succ entries must lie in [0, m)")
        dr = s.shape[0] // n_rows
        tabs = []
        for r, row in enumerate(mesh.devices):
            row_tabs = []
            for c, dev in enumerate(row):
                t = s[r * dr:(r + 1) * dr, c * ms:(c + 1) * ms].to(dev).contiguous()
                tok = torch.arange(c * ms, (c + 1) * ms, dtype=torch.int32, device=dev)
                d = (t != tok).to(torch.int32)
                row_tabs.append(phase_a(d, t, tok, c * ms) if algo == "blocked" else (d, t))
            tabs.append(row_tabs)
        rounds = [0] * n_rows
        active = list(range(n_rows))
        while active and rounds[active[0]] < n_steps:
            flags = []
            for r in active:
                new = gather_step(tabs[r], mesh.devices[r])
                if algo == "blocked":
                    flags.append(torch.stack([(nt != t).any().to(mesh.lead)
                                              for (_, nt), (_, t) in zip(new, tabs[r])]).any())
                tabs[r] = new
                rounds[r] += 1
            if algo == "blocked":
                changed = torch.stack(flags).tolist()  # the one host read of the round
                active = [r for r, ch in zip(active, changed) if ch]
        run.rounds = rounds
        return torch.cat([torch.cat([d.to(mesh.lead) for d, _ in row_tabs], 1) for row_tabs in tabs])

    run.rounds = []
    return run


def _ruling_dist(succ: torch.Tensor, k: int = 8) -> torch.Tensor:
    """Distance-to-terminal via a two-level ruling set (rulers: token
    index % k == 0); same output as _wyllie_dist."""
    m = succ.shape[1]
    tok = torch.arange(m, dtype=torch.int64, device=succ.device)
    t = succ.to(torch.int64)
    return _ruling_dist_from((t != tok).to(torch.int64), t, k=k)


def _ruling_dist_from(d0: torch.Tensor, t0: torch.Tensor, k: int = 8) -> torch.Tensor:
    """Ruling-set ranking from a weighted pointer state [D, m]:
    dist(i) = d0[i] + dist(t0[i]), terminals are self-loops with d0 == 0.
    Phase 1 doubles pointers that stop at rulers/terminals (the JAX
    while_loop: same round cap, same exit once every pointer is frozen —
    taken over the whole batch, where a frozen pointer never changes);
    phase 2 doubles the dense ruler ring; phase 3 recombines."""
    dev = t0.device
    n_docs, m = t0.shape
    tok = torch.arange(m, dtype=torch.int64, device=dev)
    t = t0.to(torch.int64)
    d = d0.to(torch.int64)
    is_term = t == tok
    is_stop = is_term | ((tok % k) == 0)
    frozen = is_term | is_stop.gather(1, t)
    max_rounds = list_rank.ceil_log2(m)
    i = 0
    while i < max_rounds and not bool(frozen.all()):
        gd, gt = d.gather(1, t), t.gather(1, t)
        d = torch.where(frozen, d, d + gd)
        t = torch.where(frozen, t, gt)
        frozen = is_term | is_stop.gather(1, t)
        i += 1
    mr = (m + k - 1) // k

    def dense(x: torch.Tensor) -> torch.Tensor:
        # frozen targets are rulers or terminals; terminals sink to mr
        return torch.where(is_term.gather(1, x), torch.full_like(x, mr), x // k)

    r_tok = torch.arange(mr, dtype=torch.int64, device=dev) * k
    r_d = torch.cat([d[:, r_tok], torch.zeros((n_docs, 1), dtype=torch.int64, device=dev)], dim=1)
    r_t = torch.cat(
        [dense(t[:, r_tok]), torch.full((n_docs, 1), mr, dtype=torch.int64, device=dev)], dim=1
    )
    r_d, _ = _double(r_d, r_t, list_rank.ceil_log2(mr + 1))
    return (d + r_d.gather(1, dense(t))).to(torch.int32)


def _blocked_dist(succ: torch.Tensor, block: int = list_rank.DEFAULT_BLOCK) -> torch.Tensor:
    """Blocked two-level ranking, int32 [D, m] -> int32 (the XLA
    _blocked_dist): phase A doubles each pointer only while its target
    lies in the same `block`-token block (the block clamped to the
    lane-padded ring, the ring padded to a whole number of blocks with
    self-loops), ceil(log2(block)) rounds; then the ruling phases rank
    the weighted block-exit graph."""
    n_docs, m = succ.shape
    dev = succ.device
    b = min(block, max(128, -(-m // 128) * 128))
    mp = -(-m // b) * b
    tok = torch.arange(mp, dtype=torch.int64, device=dev)
    t = torch.cat([succ.to(torch.int64), tok[m:].expand(n_docs, mp - m)], dim=1)
    d = (t != tok).to(torch.int64)
    blk = tok // b
    for _ in range(list_rank.ceil_log2(b)):
        active = ((t // b) == blk) & (t != tok)
        d, t = torch.where(active, d + d.gather(1, t), d), torch.where(active, t.gather(1, t), t)
    return _ruling_dist_from(d, t)[:, :m]


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values reduced mod 2^32 and read as int32 (the JAX int32
    wraparound)."""
    return (((x + 2**31) & _U32) - 2**31).to(torch.int32)


def ring_run_heads(succ: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(is_head bool [D, m], n_runs int32 [D]): maximal index-consecutive
    successor runs.  Token j joins its predecessor's run iff
    succ[j-1] == j, j is j's only predecessor and j is not a terminal
    self-loop, so runs are index intervals and a run's tail points at
    some run's head."""
    n_docs, m = succ.shape
    s = succ.to(torch.int64)
    tok = torch.arange(m, dtype=torch.int64, device=succ.device)
    indeg = torch.zeros((n_docs, m), dtype=torch.int64, device=succ.device).scatter_add_(1, s, torch.ones_like(s))
    absorbed = torch.zeros((n_docs, m), dtype=torch.bool, device=succ.device)
    absorbed[:, 1:] = s[:, :-1] == tok[1:]
    is_head = ~(absorbed & (indeg == 1) & (s != tok))
    return is_head, is_head.sum(1).to(torch.int32)


def _coalesced_dist(succ: torch.Tensor, r_pad: Optional[int] = None, use_kernel: bool = False) -> torch.Tensor:
    """Run-coalesced ranking [D, m] int32 -> int32: contract the maximal
    successor runs into super-nodes, rank the contracted ring (the plain
    weighted ruling, or with `use_kernel` the weighted CUDA kernel with
    dist_bound = m), then expand to tokens with one scatter at head
    tokens and one cumsum.

    `r_pad` is the contracted-ring budget, rounded up to 128 (None: m,
    always safe).  Overflow is not detected: with r_pad below a doc's
    n_runs the result is garbage, and callers that pass a tight budget
    own the check (ring_run_heads, or rank_model.ring_stats on the host).
    Past the budget, run ids are clamped into the ring so that garbage
    is all it can give.  A contracted ring whose r + 1 tokens pad past
    list_rank.RANK_MAX_M ranks with the plain weighted ruling even with
    `use_kernel`, counted in RANK_ROUTES["torch:coalesced/over_cap"]."""
    n_docs, m = succ.shape
    dev = succ.device
    i64 = torch.int64
    r = max(128, -(-(m if r_pad is None else r_pad) // 128) * 128)
    s = succ.to(i64)
    tok = torch.arange(m, dtype=i64, device=dev)
    is_head, n_runs = ring_run_heads(succ)
    run_id = is_head.to(i64).cumsum(1) - 1
    # head token of each run [D, r]; slot r is the dump of non-heads and
    # of heads past the budget
    rid_clip = torch.where(is_head, run_id.clamp(max=r), r)
    head_tok = torch.zeros((n_docs, r + 1), dtype=i64, device=dev).scatter_(1, rid_clip, tok.expand(n_docs, m))[:, :r]
    ridx = torch.arange(r, dtype=i64, device=dev)
    nr = n_runs.to(i64)[:, None]
    valid_run = ridx < nr
    nxt_head = torch.cat([head_tok[:, 1:], torch.full((n_docs, 1), m, dtype=i64, device=dev)], dim=1)
    tail_tok = torch.where(ridx + 1 < nr, nxt_head, m) - 1
    tail_tok = torch.where(valid_run, tail_tok, head_tok)
    succ_tail = s.gather(1, tail_tok.clamp(0, m - 1))
    is_term_run = succ_tail == tail_tok
    w = torch.where(valid_run, tail_tok - head_tok + (~is_term_run).to(i64), 0)
    # terminal runs edge to the sink slot r; pad slots are self-loops
    t = torch.where(
        valid_run & ~is_term_run, run_id.gather(1, succ_tail.clamp(0, m - 1)), torch.where(valid_run, r, ridx)
    ).clamp(max=r)
    w1 = torch.cat([w, torch.zeros((n_docs, 1), dtype=i64, device=dev)], dim=1)
    t1 = torch.cat([t, torch.full((n_docs, 1), r, dtype=i64, device=dev)], dim=1)  # sink self-loop
    if use_kernel and -(-(r + 1) // 128) * 128 > list_rank.RANK_MAX_M:
        RANK_ROUTES["torch:coalesced/over_cap"] += 1
        use_kernel = False
    if use_kernel:
        # dist_bound = m: contracted distances count pre-contraction steps
        d = list_rank.wyllie_rank(
            t1.to(torch.int32), weights=w1.to(torch.int32), dist_bound=m, device=dev
        )[:, :r].to(i64)
    else:
        d = _ruling_dist_from(w1, t1)[:, :r].to(i64)
    # expansion: dist[tok] = D[run] - (tok - head_tok[run]); runs are
    # index intervals with ascending ids, so a telescoped scatter at head
    # tokens and one cumsum give D[run] + head_tok[run] at every token
    val = torch.where(valid_run, d + head_tok, 0)
    prev = torch.cat([torch.zeros((n_docs, 1), dtype=i64, device=dev), val[:, :-1]], dim=1)
    delta = torch.where(valid_run, val - prev, 0)
    seg = torch.zeros((n_docs, m + 1), dtype=i64, device=dev).scatter_add_(
        1, torch.where(valid_run, head_tok, m), delta
    )[:, :m]
    return _wrap_i32(seg.cumsum(1) - tok)


# ---- rank dispatch ----------------------------------------------------------

RANK_SPECS = tuple(f"{b}:{a}" for b in ("cuda", "torch") for a in ("ruling", "wyllie", "blocked", "coalesced"))
# Rings sent to a plain torch rank because they are longer than the
# kernels take (RANK_MAX_M), incremented where such a ring is ranked: the
# automatic route on a CUDA device sends them to torch:wyllie, and
# cuda:coalesced ranks a contracted ring that pads past the cap with the
# plain weighted ruling (the JAX package's fallback, fugue_batch.py:438).
RANK_ROUTES: Dict[str, int] = {"torch:wyllie/over_cap": 0, "torch:coalesced/over_cap": 0}


def _resolve_rank_spec(rank_impl: Optional[str], device: torch.device, m: int) -> Tuple[str, str]:
    """(backend, algo) for rings of m tokens.  None picks, on a CUDA
    device, "cuda:ruling" (the hand-written kernels; no environment
    variable overrides it) when m <= list_rank.RANK_MAX_M and else
    "torch:wyllie" (the counterpart of the JAX package's XLA route past
    PALLAS_RANK_MAX_M; a rule on the shape), and
    "torch:ruling" on the CPU.  "cuda:*" needs CUDA tensors; on a ring
    past the cap it raises in list_rank, except "cuda:coalesced", which
    ranks a contracted ring past the cap with the plain weighted ruling
    (_coalesced_dist).  Pure: _order_core counts the over-cap route in
    RANK_ROUTES where it ranks."""
    if rank_impl is None:
        if device.type != "cuda":
            return "torch", "ruling"
        if m <= list_rank.RANK_MAX_M:
            return "cuda", "ruling"
        return "torch", "wyllie"
    backend, _, algo = rank_impl.partition(":")
    if rank_impl not in RANK_SPECS:
        raise ConfigError("rank_impl", rank_impl, "|".join(RANK_SPECS) + " or None")
    if backend == "cuda" and device.type != "cuda":
        raise ValueError(f"rank_impl {rank_impl!r} runs the CUDA kernel and needs CUDA tensors")
    return backend, algo


def _rank_dist(succ: torch.Tensor, backend: str, algo: str, ring_budget: Optional[int] = None) -> torch.Tensor:
    """Distance-to-terminal [D, m] int32 under a resolved spec;
    `ring_budget` is read by the coalesced rank only."""
    if algo == "coalesced":
        return _coalesced_dist(succ, ring_budget, use_kernel=backend == "cuda")
    if backend == "cuda":
        return list_rank.wyllie_rank(succ, algo=algo, device=succ.device)
    if algo == "ruling":
        return _ruling_dist(succ)
    if algo == "blocked":
        return _blocked_dist(succ)
    return _wyllie_dist(succ)


def _tick_rank_obs(
    n_docs: int,
    n_nodes: int,
    rank_impl: Optional[str],
    device: DeviceLike,
    ring_budget: Optional[int] = None,
) -> None:
    """rank.* obs counters from the analytic gather model
    (ops/rank_model.gather_model), ticked at the host-level entry points
    with the caller's ring_budget, the ruling k every CUDA launch plans
    with (list_rank.DEFAULT_K) and the blocked rank's block.  The label
    is the resolved spec, "cuda:ruling" or "torch:wyllie" (the JAX
    package's "pallas:" / "xla:").  Host arithmetic on shapes only: it
    never syncs the device and never raises (the merge must not depend
    on the obs package)."""
    try:
        m = 2 * (n_nodes + 1)
        backend, algo = _resolve_rank_spec(rank_impl, torch.device(device), m)
        from ..obs import metrics as obs_m
        from .rank_model import gather_model

        kw = {}
        if algo == "coalesced":
            kw["r_pad"] = ring_budget
        if algo == "blocked":
            kw["block"] = list_rank.DEFAULT_BLOCK
        if backend == "cuda" and algo in ("ruling", "blocked", "coalesced"):
            kw["k"] = list_rank.DEFAULT_K
        mdl = gather_model(m, algo, **kw)
        label = f"{backend}:{algo}"
        obs_m.counter("rank.ring_tokens").inc(n_docs * m, algo=label)
        obs_m.counter("rank.rounds_total").inc(n_docs * mdl["rounds"], algo=label)
        obs_m.counter("rank.gather_rows_total").inc(n_docs * mdl["global_rows"], algo=label, kind="global")
        if mdl.get("local_rows"):
            obs_m.counter("rank.gather_rows_total").inc(n_docs * mdl["local_rows"], algo=label, kind="local")
    except Exception:  # tpulint: disable=LT-EXC(gather-ledger metrics are an estimate; accounting must never break the merge)
        pass


# ---- Euler-tour ring and order ---------------------------------------------


def _ring_and_anchors(
    parent_in: torch.Tensor,
    side_in: torch.Tensor,
    valid_in: torch.Tensor,
    sib_keys: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(succ int32 [D, 2*(n+1)], anchor int32 [D, n+1]): the Euler-tour
    successor ring over ENTER/EXIT tokens and each node's in-order anchor
    token (the virtual root is node n).  Tokens are numbered by
    sibling-sort slot (ENTER(e) = slot[e], EXIT(e) = m-1-slot[e]) and the
    tokens of invalid nodes are chained by index, as in the JAX package.
    Without `sib_keys`, sibling order is row order; with them ([D, n]
    tensors of uint32 values, most significant first) siblings sort by
    those keys (the JAX lexsort).

    Ring: ENTER(e) -> ENTER(first L-child) | ENTER(first R-child) | EXIT(e);
    EXIT(e) -> ENTER(next sibling) | post_L(parent) (last L-sibling) |
    EXIT(parent) (last R-sibling); EXIT(root) is the terminal.  The anchor
    is EXIT(last L-child) when L-children exist, else ENTER(e)."""
    dev = parent_in.device
    n_docs, n = parent_in.shape
    n1 = n + 1
    root = n
    i64 = torch.int64

    def col(v: int, dtype=i64) -> torch.Tensor:
        return torch.full((n_docs, 1), v, dtype=dtype, device=dev)

    pin = parent_in.to(i64)
    parent = torch.cat([torch.where(valid_in, pin, BIG), col(BIG)], dim=1)
    parent[:, :n] = torch.where(valid_in & (pin < 0), root, parent[:, :n])
    side = torch.cat([side_in.to(i64), col(1)], dim=1)
    valid = torch.cat([valid_in, col(0, torch.bool)], dim=1)  # root is not a child

    key = torch.where(parent < BIG, parent * 2 + side, BIG)
    if sib_keys is None:
        order = torch.sort(key, dim=1, stable=True).indices  # [D, n1] slot -> node
    else:
        # lexsort by (key, *sib_keys): stable sorts from the most minor
        # key up to `key`; the root's sibling keys are 0
        order = torch.arange(n1, dtype=i64, device=dev).expand(n_docs, n1)
        for k in [torch.cat([sk.to(i64) & _U32, col(0)], dim=1) for sk in reversed(sib_keys)] + [key]:
            order = order.gather(1, torch.sort(k.gather(1, order), dim=1, stable=True).indices)
    p_s = parent.gather(1, order)
    s_s = side.gather(1, order)
    prev_same = (p_s == p_s.roll(1, 1)) & (s_s == s_s.roll(1, 1))
    prev_same[:, 0] = False
    nxt_same = (p_s == p_s.roll(-1, 1)) & (s_s == s_s.roll(-1, 1))
    nxt_same[:, -1] = False
    is_first = ~prev_same
    is_last = ~nxt_same
    next_sib_s = torch.where(nxt_same, order.roll(-1, 1), -1)

    # per node: next sibling; per (parent, side): first child, last L-child
    next_sib = torch.zeros((n_docs, n1), dtype=i64, device=dev).scatter_(1, order, next_sib_s)
    is_child = p_s < BIG

    def first_of(mask: torch.Tensor) -> torch.Tensor:
        tgt = torch.where(mask & is_child, p_s, n1)  # n1 = dump slot
        out = torch.full((n_docs, n1 + 1), -1, dtype=i64, device=dev).scatter_(1, tgt, order)
        return out[:, :n1]

    first_l = first_of(is_first & (s_s == 0))
    first_r = first_of(is_first & (s_s == 1))
    last_l = first_of(is_last & (s_s == 0))
    has_next_sib = next_sib >= 0
    has_l = first_l >= 0
    has_r = first_r >= 0

    m = 2 * n1
    slot = torch.zeros((n_docs, n1), dtype=i64, device=dev).scatter_(
        1, order, torch.arange(n1, dtype=i64, device=dev).expand(n_docs, n1)
    )
    ent = slot
    ext = (m - 1) - slot
    post_l = torch.where(has_r, ent.gather(1, first_r.clamp(0, n)), ext)
    succ_enter = torch.where(has_l, ent.gather(1, first_l.clamp(0, n)), post_l)
    par = torch.where(parent < BIG, parent, root)
    succ_exit = torch.where(
        has_next_sib,
        ent.gather(1, next_sib.clamp(0, n)),
        torch.where(side == 0, post_l.gather(1, par), ext.gather(1, par)),
    )
    succ_exit[:, root] = ext[:, root]  # terminal self-loop
    succ = torch.cat([succ_enter.gather(1, order), succ_exit.gather(1, order).flip(1)], dim=1)

    # invalid nodes: chain their tokens by index; root tokens stay
    v_s = valid.gather(1, order)
    tok_valid = torch.cat([v_s, v_s.flip(1)], dim=1)
    tok = torch.arange(m, dtype=i64, device=dev)
    chain_next = torch.clamp(tok + 1, max=m - 1)
    ent_root = ent[:, root : root + 1]
    ext_root = ext[:, root : root + 1]
    keep = tok_valid | (tok == ext_root) | (tok == ent_root)
    succ = torch.where(keep, succ, chain_next)
    succ.scatter_(1, ent_root, succ_enter[:, root : root + 1])
    succ.scatter_(1, ext_root, ext_root)

    anchor = torch.where(has_l, ext.gather(1, last_l.clamp(0, n)), ent)
    return succ.to(torch.int32), anchor.to(torch.int32)


def _order_core(
    parent_in: torch.Tensor,
    side_in: torch.Tensor,
    valid_in: torch.Tensor,
    sib_keys: Optional[Sequence[torch.Tensor]] = None,
    rank_impl: Optional[str] = None,
    ring_budget: Optional[int] = None,
) -> torch.Tensor:
    """Euler-tour in-order rank keys int32 [D, n] (ascending key =
    traversal order; invalid rows get BIG).  Without `sib_keys` rows must
    obey the (peer, counter) order contract.  `ring_budget` is the
    coalesced rank's contracted-ring budget (see _coalesced_dist)."""
    n = parent_in.shape[1]
    succ, anchor = _ring_and_anchors(parent_in, side_in, valid_in, sib_keys)
    backend, algo = _resolve_rank_spec(rank_impl, succ.device, succ.shape[1])
    if rank_impl is None and backend == "torch" and algo == "wyllie":
        RANK_ROUTES["torch:wyllie/over_cap"] += 1
    with tracing.device_span("fugue.rank", succ.device, D=succ.shape[0], m=succ.shape[1]):
        dist = _rank_dist(succ, backend, algo, ring_budget)
    anchor_dist = dist.gather(1, anchor.to(torch.int64))
    rank = anchor_dist[:, n : n + 1] - anchor_dist[:, :n]
    return torch.where(valid_in, rank, BIG).to(torch.int32)


# ---- element-level order and materialization ----------------------------


def _on(cols, device: DeviceLike):
    """The same column tuple with every tensor on `device`; a numpy array
    becomes a tensor there (uint32 as int64 holding the same values), and
    a nested column tuple is carried whole."""
    dev = resolve_device(device)
    return _carry(cols, dev)


def _carry(cols, dev: torch.device):
    out = []
    for c in cols:
        if isinstance(c, tuple):
            out.append(_carry(c, dev))
        elif isinstance(c, torch.Tensor):
            out.append(c.to(dev))
        else:
            a = np.asarray(c)
            out.append(torch.from_numpy(np.ascontiguousarray(a.astype(np.int64) if a.dtype == np.uint32 else a)).to(dev))
    return type(cols)(*out)


def fugue_order(cols: SeqColumns, rank_impl: Optional[str] = None, device: DeviceLike = "cuda") -> torch.Tensor:
    """Rank keys int32 [D, N] whose ascending order is the in-order
    position of each element in the Fugue traversal (keys may have gaps;
    pads get BIG).  Rows must be sorted by (peer, counter)."""
    c = _on(cols, device)
    return _order_core(c.parent, c.side, c.valid, rank_impl=rank_impl)


def visible_order(
    cols: SeqColumns, rank_impl: Optional[str] = None, device: DeviceLike = "cuda"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(perm int32 [D, N], count int32 [D]): perm[d, i] is the element
    at position i in final order, visible elements first in document
    order."""
    c = _on(cols, device)
    rank = _order_core(c.parent, c.side, c.valid, rank_impl=rank_impl)
    visible = c.valid & ~c.deleted
    key = torch.where(visible, rank, BIG)
    perm = torch.sort(key, dim=1, stable=True).indices
    return perm.to(torch.int32), visible.sum(1).to(torch.int32)


def _rank_positions(rank: torch.Tensor, visible: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pos int64 [D, N], count int32 [D]): pos[row] = visible rows of
    smaller rank, for every row (invisible rows included).  Ranks of
    visible rows are distinct and below rank_bound(N), so a rank
    histogram and its exclusive cumsum give each row its position, with
    no sort."""
    n_docs, n = rank.shape
    i64 = torch.int64
    m = rank_bound(n)
    rk = rank.to(i64).clamp(0, m - 1)
    vis_i = visible.to(i64)
    hist = torch.zeros((n_docs, m), dtype=i64, device=rank.device).scatter_add_(
        1, torch.where(visible, rk, m - 1), vis_i
    )
    return (hist.cumsum(1) - hist).gather(1, rk), vis_i.sum(1).to(torch.int32)


def _place_codes(pos: torch.Tensor, visible: torch.Tensor, content: torch.Tensor) -> torch.Tensor:
    """codes int32 [D, N], padded with -1: each visible row's content at
    its position; invisible rows go to the dump slot N (JAX's
    mode="drop"), which is sliced away."""
    n_docs, n = content.shape
    codes = torch.full((n_docs, n + 1), -1, dtype=torch.int32, device=content.device)
    codes.scatter_(1, torch.where(visible, pos.to(torch.int64), n), content.to(torch.int32))
    return codes[:, :n]


def _compact(
    rank: torch.Tensor, visible: torch.Tensor, content: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-free compaction [D, N] -> (codes int32 [D, N] padded with -1,
    count int32 [D]) by the rank histogram (_rank_positions)."""
    pos, count = _rank_positions(rank, visible)
    return _place_codes(pos, visible, content), count


def materialize_content(
    cols: SeqColumns, rank_impl: Optional[str] = None, device: DeviceLike = "cuda"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Content codes of visible elements in document order: (codes int32
    [D, N] with tail padding -1, count int32 [D]).  The doc axis is
    explicit, so this is also the batched form (materialize_content_batch)."""
    c = _on(cols, device)
    rank = _order_core(c.parent, c.side, c.valid, rank_impl=rank_impl)
    return _compact(rank, c.valid & ~c.deleted, c.content)


# the JAX package's vmapped batch form
materialize_content_batch = materialize_content


def merge_docs(
    cols: SeqColumns, rank_impl: Optional[str] = None, device: DeviceLike = "cuda"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fleet entry: materialize_content of a whole batch, with the
    rank.* accounting of one merge."""
    c = _on(cols, device)
    _tick_rank_obs(c.parent.shape[0], c.parent.shape[1], rank_impl, c.parent.device)
    return materialize_content(c, rank_impl, c.parent.device)


def merge_docs_checksum(
    cols: SeqColumns, rank_impl: Optional[str] = None, device: DeviceLike = "cuda"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge, reduced to a per-doc order-sensitive checksum (int64 [D]
    holding uint32 values) and counts int32 [D]."""
    c = _on(cols, device)
    _tick_rank_obs(c.parent.shape[0], c.parent.shape[1], rank_impl, c.parent.device)
    codes, counts = materialize_content(c, rank_impl, c.parent.device)
    return _weighted_checksum(codes), counts


def fugue_order_u(cols: SeqColumnsU, rank_impl: Optional[str] = None, device: DeviceLike = "cuda") -> torch.Tensor:
    """fugue_order for the row-order-free table: siblings ordered by
    (peer_hi, peer_lo, counter)."""
    c = _on(cols, device)
    return _order_u(c, rank_impl)


def _order_u(c: SeqColumnsU, rank_impl: Optional[str]) -> torch.Tensor:
    return _order_core(
        c.parent, c.side, c.valid, rank_impl=rank_impl, sib_keys=(c.peer_hi, c.peer_lo, c.counter)
    )


def materialize_content_u(
    cols: SeqColumnsU, rank_impl: Optional[str] = None, device: DeviceLike = "cuda"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Order + compact for the row-order-free table (content = -1 rows,
    anchors, are invisible)."""
    c = _on(cols, device)
    return _compact(_order_u(c, rank_impl), c.valid & ~c.deleted & (c.content >= 0), c.content)


merge_docs_u = materialize_content_u


# ---- resident text path: device ops on SeqColumnsU -----------------------------


def _contract_u(cols: SeqColumnsU, c_pad: int):
    """The chain table of the row-order-free table [D, N] at chain budget
    `c_pad` (chain_contract_materialize_u's contraction): (c_parent,
    c_side, c_valid, sib_keys, head_row, n_chains), chain columns [D,
    c_pad] whose Euler ring (_ring_and_anchors) the solver ranks."""
    if c_pad < 1:
        raise ConfigError("c_pad", c_pad, "a chain budget >= 1")
    dev = cols.parent.device
    n_docs, n = cols.parent.shape
    i64 = torch.int64
    valid = cols.valid
    parent = cols.parent.to(i64)
    side = cols.side.to(i64)
    pgt = parent.clamp(0, n - 1)
    has_parent = valid & (parent >= 0)
    zeros = torch.zeros((n_docs, n), dtype=i64, device=dev)
    cc = zeros.scatter_add(1, torch.where(has_parent, pgt, n - 1), has_parent.to(i64))
    is_l = has_parent & (side == 0)
    lc = zeros.scatter_add(1, torch.where(is_l, pgt, n - 1), is_l.to(i64))
    idx = torch.arange(n, dtype=i64, device=dev)
    prev_ok = torch.cat([torch.zeros((n_docs, 1), dtype=torch.bool, device=dev), valid[:, :-1]], dim=1)
    link = valid & prev_ok & (parent == idx - 1) & (side == 1) & (cc.roll(1, 1) == 1) & (lc.roll(1, 1) == 0) & (lc == 0)
    link[:, 0] = False
    is_head = valid & ~link
    chain_id = torch.where(valid, is_head.to(i64).cumsum(1) - 1, c_pad)
    n_chains = is_head.sum(1).to(torch.int32)
    tgt = torch.where(is_head, chain_id.clamp(0, c_pad), c_pad)  # c_pad = dump slot

    def head_scatter(src: torch.Tensor, fill: int) -> torch.Tensor:
        out = torch.full((n_docs, c_pad + 1), fill, dtype=i64, device=dev)
        return out.scatter_(1, tgt, src.to(i64).expand(n_docs, n))[:, :c_pad]

    head_row = head_scatter(idx, 0)
    c_parent_row = head_scatter(torch.where(parent >= 0, parent, -1), -1)
    c_parent = torch.where(c_parent_row >= 0, chain_id.gather(1, c_parent_row.clamp(0, n - 1)), -1)
    c_parent = c_parent.clamp(max=c_pad - 1)
    c_valid = torch.arange(c_pad, device=dev) < n_chains[:, None]
    sib_keys = (head_scatter(cols.peer_hi, 0), head_scatter(cols.peer_lo, 0), head_scatter(cols.counter.to(i64) & _U32, 0))
    return c_parent, head_scatter(side, 0), c_valid, sib_keys, head_row, n_chains


def chain_contract_materialize_u(
    cols: SeqColumnsU, c_pad: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Chain contraction on the device, order and placement for the
    row-order-free table [D, N]: (codes int32 [D, N] padded with -1,
    count int32 [D], n_chains int32 [D]).

    Row i links to row i - 1 (columnar.contract_chains' conditions) iff
    both are valid, parent == i - 1, side is Right, row i - 1 has exactly
    one child and no Left child, and row i has no Left child; chains are
    the runs of linked rows, numbered in row order.  Chain attributes are
    scattered from head rows into `c_pad` slots, chains are ranked with
    sibling keys (peer_hi, peer_lo, counter) of their head rows, and
    elements placed by the sort placement.

    When n_chains > c_pad the codes are garbage and the caller retries
    with a larger budget; n_chains is right either way.  Chain ids past
    the budget go to the dump slot c_pad of every scatter, and chain
    parents are clipped to [-1, c_pad - 1] (JAX clamps the gathers that
    read them), so such a call indexes nothing out of range."""
    c_parent, c_side, c_valid, sib_keys, head_row, n_chains = _contract_u(cols, c_pad)
    crank = _order_core(c_parent, c_side, c_valid, sib_keys=sib_keys)
    visible = cols.valid & ~cols.deleted & (cols.content >= 0)
    codes, count = _place_by_chain_sort(crank, c_valid, head_row, visible, cols.content)
    return codes, count, n_chains


def chain_merge_docs_u(
    cols: SeqColumnsU, c_pad: int, *, device: DeviceLike = "cuda"
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The chain-contracted merge of a resident batch at chain budget
    `c_pad`: (codes [D, N], counts [D], n_chains [D]); the codes are
    valid only where max(n_chains) <= c_pad (chain_contract_materialize_u)."""
    c = _on(cols, device)
    _tick_rank_obs(c.parent.shape[0], c_pad, None, c.parent.device)
    return chain_contract_materialize_u(c, c_pad)


def _u32_tensor(x, dev: torch.device) -> torch.Tensor:
    """int64 tensor on `dev` holding the uint32 values of `x` (numpy
    uint32, or a tensor holding them or their int32 bit patterns)."""
    t = x.to(dev) if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x).astype(np.int64)).to(dev)
    return t.to(torch.int64) & _U32


def materialize_by_key(
    cols: SeqColumnsU, key_hi, key_lo, *, device: DeviceLike = "cuda"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Visible content ordered by standing order keys: one sort by the
    uint32 pair (key_hi, key_lo) [D, N] in place of a rank solve (the
    keys' ascending order must be the Fugue traversal order, and unique
    among valid rows).  (codes int32 [D, N] padded with -1, counts int32
    [D]), the contract of chain_merge_docs_u.  The pair sorts as one
    int64, (key_hi - 2^31) * 2^32 + key_lo, which keeps its order;
    invalid rows get the largest pair."""
    c = _on(cols, device)
    dev = c.parent.device
    n_docs, n = c.content.shape
    hi, lo = _u32_tensor(key_hi, dev), _u32_tensor(key_lo, dev)
    if hi.shape != c.content.shape or lo.shape != c.content.shape:
        raise ValueError(f"key_hi {tuple(hi.shape)} and key_lo {tuple(lo.shape)} must be [D, N] = {(n_docs, n)}")
    hi = torch.where(c.valid, hi, _U32)
    lo = torch.where(c.valid, lo, _U32)
    perm = torch.sort((hi - 2**31) * 2**32 + lo, dim=1, stable=True).indices
    content_s = c.content.gather(1, perm)
    vis_s = (c.valid & ~c.deleted & (c.content >= 0)).gather(1, perm)
    pos = vis_s.to(torch.int64).cumsum(1) - 1
    out = torch.full((n_docs, n + 1), -1, dtype=c.content.dtype, device=dev)
    out.scatter_(1, torch.where(vis_s, pos, n), content_s)
    return out[:, :n], vis_s.sum(1).to(torch.int32)


# ---- element placement (chain path) ------------------------------------------

PLACES = ("sort", "scatter")


def chain_positions(
    crank: torch.Tensor,
    c_valid: torch.Tensor,
    chain_id: torch.Tensor,
    head_row: torch.Tensor,
    visible: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Histogram placement core: (pos int32 [D, N], count int32 [D]) where
    pos[row] = number of visible rows strictly before the row in document
    order, defined for every row."""
    dev = crank.device
    n_docs, c = crank.shape
    n = chain_id.shape[1]
    i64 = torch.int64
    vis_i = visible.to(i64)
    cid = chain_id.to(i64).clamp(0, c)  # dump slot c for pads
    w = torch.zeros((n_docs, c + 1), dtype=i64, device=dev).scatter_add_(1, cid, vis_i)[:, :c]
    m = rank_bound(c)
    rk = crank.to(i64).clamp(0, m - 1)
    hist = torch.zeros((n_docs, m), dtype=i64, device=dev).scatter_add_(
        1, torch.where(c_valid, rk, m - 1), torch.where(c_valid, w, 0)
    )
    base_of_rank = hist.cumsum(1) - hist
    base = base_of_rank.gather(1, rk)
    row_excl = vis_i.cumsum(1) - vis_i
    head_excl = row_excl.gather(1, head_row.to(i64).clamp(0, n - 1))
    cid_c = chain_id.to(i64).clamp(0, c - 1)
    within = row_excl - head_excl.gather(1, cid_c)
    pos = base.gather(1, cid_c) + within
    return pos.to(torch.int32), vis_i.sum(1).to(torch.int32)


def _place_by_chain_scatter(crank, c_valid, chain_id, head_row, visible, content):
    """Histogram placement + positional scatter of the content codes."""
    pos, count = chain_positions(crank, c_valid, chain_id, head_row, visible)
    return _place_codes(pos, visible, content), count


def _place_by_chain_sort(crank, c_valid, head_row, visible, content):
    """Sort placement: expand chain ranks to rows with a C-scatter of
    telescoping rank deltas at head rows + one N-cumsum (chain rows are
    contiguous and chain ids ascend with row), then one stable sort by
    key = rank (uint32; 0xFFFFFFFF for every invisible row).  The JAX
    version does this in int32 with wraparound; here it is int64 reduced
    mod 2^32, which gives the same uint32 keys for any input."""
    dev = crank.device
    n_docs, n = visible.shape
    i64 = torch.int64
    cr = crank.to(i64)
    prev = torch.cat([torch.zeros((n_docs, 1), dtype=i64, device=dev), cr[:, :-1]], dim=1)
    delta = torch.where(c_valid, cr - prev, 0)
    seg = torch.zeros((n_docs, n + 1), dtype=i64, device=dev).scatter_add_(
        1, torch.where(c_valid, head_row.to(i64), n), delta
    )[:, :n]
    key = torch.where(visible, seg.cumsum(1) & _U32, _U32)
    perm = torch.sort(key, dim=1, stable=True).indices
    content_sorted = content.gather(1, perm)
    count = visible.sum(1).to(torch.int32)
    idx = torch.arange(n, device=dev)
    codes = torch.where(idx < count[:, None], content_sorted, -1).to(torch.int32)
    return codes, count


def chain_materialize(
    cols: ChainColumns, rank_impl: Optional[str] = None, ring_budget: Optional[int] = None, *, place: str = "sort"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge a doc batch via chain contraction: rank the C chains, then
    place all N elements.  `ring_budget` is the coalesced rank's
    contracted-ring budget (callers passing a tight one own the n_runs
    check; None is always safe).  Returns (codes int32 [D, N] padded
    with -1, visible count int32 [D]).  Works on the tensors' own
    device."""
    if place not in PLACES:
        raise ConfigError("place", place, "|".join(PLACES))
    c = cols.c_parent.shape[1]
    crank = _order_core(cols.c_parent, cols.c_side, cols.c_valid, rank_impl=rank_impl, ring_budget=ring_budget)
    visible = cols.valid & ~cols.deleted
    if place == "sort":
        return _place_by_chain_sort(crank, cols.c_valid, cols.head_row, visible, cols.content)
    chain_id = torch.where(cols.valid, cols.chain_id, c)
    return _place_by_chain_scatter(crank, cols.c_valid, chain_id, cols.head_row, visible, cols.content)


def _weighted_checksum(codes: torch.Tensor) -> torch.Tensor:
    """Order-sensitive per-doc checksum [D, N] -> [D]: the JAX uint32
    arithmetic mod 2^30 / 2^32, carried in int64 (values < 2^32)."""
    n = codes.shape[1]
    wgt = ((torch.arange(n, dtype=torch.int64, device=codes.device) * 2654435761) & _U32) % (1 << 30)
    c = torch.where(codes >= 0, codes.to(torch.int64), 0) & _U32
    return ((((c * wgt) & _U32) % (1 << 30)).sum(1)) & _U32


def chain_merge_docs(cols: ChainColumns, device: DeviceLike = "cuda"):
    """Chain-contracted merge of a doc batch with the default rank."""
    c = _on(cols, device)
    _tick_rank_obs(c.c_parent.shape[0], c.c_parent.shape[1], None, c.c_parent.device)
    return chain_materialize(c)


def chain_merge_docs_checksum(cols: ChainColumns, device: DeviceLike = "cuda"):
    c = _on(cols, device)
    _tick_rank_obs(c.c_parent.shape[0], c.c_parent.shape[1], None, c.c_parent.device)
    codes, counts = chain_materialize(c)
    return _weighted_checksum(codes), counts


def chain_merge_docs_v(
    cols: ChainColumns,
    rank_impl: Optional[str] = None,
    ring_budget: Optional[int] = None,
    *,
    place: str = "sort",
    device: DeviceLike = "cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """chain_merge_docs with an explicit rank spec (one of RANK_SPECS;
    None = default), the coalesced rank's `ring_budget` (in the JAX
    package's position) and placement ("sort" | "scatter").
    (codes [D, N], counts [D])."""
    c = _on(cols, device)
    _tick_rank_obs(c.c_parent.shape[0], c.c_parent.shape[1], rank_impl, c.c_parent.device, ring_budget)
    return chain_materialize(c, rank_impl, ring_budget, place=place)


def chain_merge_docs_checksum_v(
    cols: ChainColumns,
    rank_impl: Optional[str] = None,
    ring_budget: Optional[int] = None,
    *,
    place: str = "sort",
    device: DeviceLike = "cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(checksum int64 [D] holding uint32 values, counts [D])."""
    c = _on(cols, device)
    _tick_rank_obs(c.c_parent.shape[0], c.c_parent.shape[1], rank_impl, c.c_parent.device, ring_budget)
    codes, counts = chain_materialize(c, rank_impl, ring_budget, place=place)
    return _weighted_checksum(codes), counts


def chain_rank_checksum_v(
    cols: ChainColumns, rank_impl: Optional[str] = None, ring_budget: Optional[int] = None, *,
    device: DeviceLike = "cuda",
) -> torch.Tensor:
    """Ranking phase only, reduced per doc to sum(uint32(crank)) mod 2^32
    (int64 [D])."""
    c = _on(cols, device)
    crank = _order_core(c.c_parent, c.c_side, c.c_valid, rank_impl=rank_impl, ring_budget=ring_budget)
    return (crank.to(torch.int64) & _U32).sum(1) & _U32


# ---- packed u8 transport -----------------------------------------------------
# One chunk travels as one uint8 [D, 8C + 8N] buffer (one host-to-device
# copy) instead of the eight columns of ChainColumns.  Layout of a doc's
# row, little-endian, byte for byte the JAX package's
# (fugue_batch.py:739-755):
#   [0    : 2C)     c_parent  u16 (0xFFFF = -1, the root)
#   [2C   : 2C+2N)  chain_id  u16 (pad rows carry 0)
#   [..   : +4C)    head_row  i32
#   [..   : +4N)    content   i32 (-1 = invisible)
#   [..   : +C)     c_side    u8
#   [..   : +C)     c_valid   u8
#   [..   : +N)     deleted   u8
#   [..   : +N)     valid     u8


def packed_row_bytes(pad_c: int, pad_n: int) -> int:
    """Bytes of one doc's packed row; u16 chain ids need pad_c < 0xFFFF."""
    if pad_c >= 0xFFFF:
        raise ValueError(f"packed transport needs pad_c < 65535 (u16 chain ids), got {pad_c}")
    return 8 * pad_c + 8 * pad_n


def _packed_sections(pad_c: int, pad_n: int):
    """Byte offsets of the eight sections, in layout order."""
    offs = [0]
    for nbytes in (2 * pad_c, 2 * pad_n, 4 * pad_c, 4 * pad_n, pad_c, pad_c, pad_n, pad_n):
        offs.append(offs[-1] + nbytes)
    return offs


def pack_chain_doc_into(cols: ChainColumns, out_row: np.ndarray) -> None:
    """Serialize one doc's numpy ChainColumns ([C] / [N] arrays) into a
    packed uint8 row of packed_row_bytes(C, N) bytes; the inverse of
    _unpack_chain_batch."""
    c = cols.c_parent.shape[0]
    n = cols.chain_id.shape[0]
    if out_row.dtype != np.uint8 or out_row.shape != (packed_row_bytes(c, n),):
        raise ValueError(f"out_row must be uint8 [{packed_row_bytes(c, n)}], got {out_row.dtype} {out_row.shape}")
    o = _packed_sections(c, n)
    out_row[o[0]:o[1]].view("<u2")[:] = cols.c_parent.astype(np.int32).astype(np.uint16)
    out_row[o[1]:o[2]].view("<u2")[:] = cols.chain_id.astype(np.int32).astype(np.uint16)
    out_row[o[2]:o[3]].view("<i4")[:] = cols.head_row
    out_row[o[3]:o[4]].view("<i4")[:] = cols.content
    out_row[o[4]:o[5]] = cols.c_side
    out_row[o[5]:o[6]] = cols.c_valid
    out_row[o[6]:o[7]] = cols.deleted
    out_row[o[7]:o[8]] = cols.valid


def _unpack_chain_batch(packed: torch.Tensor, pad_c: int, pad_n: int) -> ChainColumns:
    """uint8 [D, W] -> ChainColumns on the buffer's device.  Each word
    section is copied out before it is viewed as int16 / int32: a view
    in place needs a storage offset divisible by the word size, and the
    JAX layout puts the i32 sections at 2C + 2N bytes, odd in 2 whenever
    C + N is odd."""
    o = _packed_sections(pad_c, pad_n)

    def sec(i: int) -> torch.Tensor:
        return packed[:, o[i]:o[i + 1]]

    def u16(i: int) -> torch.Tensor:
        return sec(i).clone().view(torch.int16).to(torch.int32) & 0xFFFF

    cp = u16(0)
    return ChainColumns(
        c_parent=torch.where(cp == 0xFFFF, -1, cp),
        c_side=sec(4).to(torch.int32),
        c_valid=sec(5).to(torch.bool),
        head_row=sec(2).clone().view(torch.int32),
        chain_id=u16(1),
        deleted=sec(6).to(torch.bool),
        content=sec(3).clone().view(torch.int32),
        valid=sec(7).to(torch.bool),
    )


def _packed_on(packed, pad_c: int, pad_n: int, device: DeviceLike) -> torch.Tensor:
    """The packed buffer (numpy or tensor, [D, W] uint8) on `device`."""
    p = torch.as_tensor(packed).to(resolve_device(device))
    if p.dtype != torch.uint8 or p.dim() != 2 or p.shape[1] != packed_row_bytes(pad_c, pad_n):
        raise ValueError(
            f"packed must be uint8 [D, {packed_row_bytes(pad_c, pad_n)}], got {p.dtype} {tuple(p.shape)}"
        )
    return p


def chain_merge_docs_packed(
    packed, pad_c: int, pad_n: int, rank_impl: Optional[str] = None, ring_budget: Optional[int] = None, *,
    device: DeviceLike = "cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unpack the uint8 transport buffer and merge: (codes int32 [D, N],
    counts int32 [D]), as chain_merge_docs_v on the same columns."""
    cols = _unpack_chain_batch(_packed_on(packed, pad_c, pad_n, device), pad_c, pad_n)
    return chain_materialize(cols, rank_impl, ring_budget)


def chain_merge_docs_packed_checksum(
    packed, pad_c: int, pad_n: int, rank_impl: Optional[str] = None, ring_budget: Optional[int] = None, *,
    device: DeviceLike = "cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(checksum int64 [D] holding uint32 values, counts [D]) of the
    packed buffer's merge."""
    codes, counts = chain_merge_docs_packed(packed, pad_c, pad_n, rank_impl, ring_budget, device=device)
    return _weighted_checksum(codes), counts
