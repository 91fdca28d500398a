"""List ranking on a successor ring: the hand-written Hopper kernel
(csrc/list_rank.cu) and its plain torch version.

Counterpart of loro_tpu/ops/pallas_rank.py (wyllie_rank and all four
of its kernels: packed Wyllie _rank_kernel, ruling set
_rank_kernel_ruling/_ruling_from_packed, blocked _rank_kernel_blocked
and the wide dual-table _rank_kernel_wide).  The contract of
wyllie_rank is kept, except that `succ` may carry a leading doc axis
([m] or [D, m]; one CTA, or for the wide kernel one thread-block
cluster, ranks one ring, so a [D, m] batch is one launch) and the
algorithm, ruler spacing, block size and device are arguments, not
environment knobs.

On a CUDA tensor wyllie_rank launches a kernel or raises.  On a CPU
tensor it runs the plain torch version of the same algorithm (same
padding, same rounds, same freeze): packed_rank_plain, or
wide_rank_plain for rings that need the wide kernel.  chip_smoke.py
holds every kernel against its plain version on the card.

Rings past RANK_MAX_M, which wyllie_rank refuses, take sparse_rank: a
sparse ruling set in device memory (csrc/sparse_rank.cu, ruler spacing
SPARSE_K), with its plain version sparse_rank_plain beside it.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..errors import ConfigError, DeviceUnavailable, KernelLaunchError

ALGOS = ("wyllie", "ruling", "blocked")
# ring-length ceiling of the JAX package's VMEM ranking (PALLAS_RANK_MAX_M)
RANK_MAX_M = 1 << 17
PACKED_MAX_M = 1 << 16  # dist and succ share one u32 as 16 + 16 bits
DEFAULT_BLOCK = 1024  # blocked phase-A block (RANK_BLOCK's default in JAX)
DEFAULT_K = 8  # ruler spacing of the ruling and blocked kernels (no caller overrides it)
_LANES = 128
# Ruler spacing of sparse_rank, chosen by a sweep on an H100 (16 to 256)
# at the element rings of 524,290 tokens (PERF.md has its numbers).
SPARSE_K = 128
# opt-in dynamic shared memory of one block on sm_90 (H100, H200)
SMEM_LIMIT = 232_448
MAX_CLUSTER = 16  # largest thread-block cluster on sm_90 (non-portable above 8)
# CTAs ranking one wide ring: a thread-block cluster with the ring split
# across its shared memories (csrc/list_rank.cu), the size chosen by the
# sweep in chip_smoke.py at the element rings (PERF.md has its numbers).
# 16 is slower (only about one 16-CTA cluster fits a GPC, so eight rings
# run in two waves).  The ruling and blocked kernels rank a ring on one
# CTA: clusters of 2, 4 and 8 were slower for the ruling kernel on the
# flagship chain rings, whose pointers mostly leave a slice.
WIDE_CLUSTER = 8
# CTAs ranking one packed Wyllie ring whose u32 table passes one CTA's
# shared memory (mp * 4 > SMEM_LIMIT): the two halves of the ring in two
# CTAs' shared memories, in place of a table in device memory.
WYLLIE_CLUSTER = 2
# what each clock64 stamp of the timed packed kernel closes (list_rank_launch_timed)
PHASES = ("load", "A", "1", "2", "3+store")
# the timed Wyllie kernels' stamps, one row of WYLLIE_STAMPS int64 a CTA
# (list_rank_wyllie_launch_timed): clock64 at the start, after the load,
# after each round and after the store; the words moved in each round and
# the rounds taken.  A round cap is at most MAX_ROUNDS (ceil_log2(65536)).
WYLLIE_STAMPS = 40
MAX_ROUNDS = 16
_LOW = 0xFFFF
_HIGH = 0xFFFF0000
_U32 = 0xFFFFFFFF

# Launches of the CUDA kernels, by algorithm and by where the tables live
# (launch_key): one CTA's shared memory, a global scratch buffer above
# the shared-memory limit (ruling, blocked), or split across a
# thread-block cluster's shared memories (wide; wyllie above the limit);
# "sparse/global" counts sparse_rank's launches (its tables in device
# memory).  Incremented only where a kernel is launched.
LAUNCHES: Dict[str, int] = {
    "ruling/smem": 0,
    "ruling/global": 0,
    "wyllie/smem": 0,
    "wyllie/cluster": 0,
    "blocked/smem": 0,
    "blocked/global": 0,
    "wide/cluster": 0,
    "sparse/global": 0,
}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def ceil_log2(x: int) -> int:
    """max(1, ceil(log2(max(x, 2)))) — the doubling round cap."""
    return max(1, (max(int(x), 2) - 1).bit_length())


@dataclass(frozen=True)
class RankPlan:
    """Validated shape of one ranking call."""

    m: int  # ring length as given
    mp: int  # padded ring length
    algo: str  # "ruling" | "wyllie" | "blocked" (after the k-quantum rule)
    k: int  # ruler spacing (ruling and blocked)
    n_steps: int  # round cap, from the unpadded m
    wide: bool = False  # ranked by the wide kernel (overrides algo and k)
    block: int = DEFAULT_BLOCK  # phase-A block (blocked only)
    cluster: int = 1  # CTAs ranking one ring: a cluster for wide and over-budget wyllie, else 1

    def __post_init__(self):
        """A plan no kernel can run raises ConfigError: the wide kernel
        needs a cluster of 2 to MAX_CLUSTER CTAs (a power of two) whose
        per-CTA slice fits SMEM_LIMIT; a wyllie ring whose table passes
        SMEM_LIMIT a cluster of WYLLIE_CLUSTER; the other packed plans
        one CTA."""
        if self.wide and not _is_pow2(self.cluster, 2, MAX_CLUSTER):
            raise ConfigError("rank cluster", self.cluster, f"a power of two in [2, {MAX_CLUSTER}] for the wide kernel")
        if self.wyllie_split and not _is_pow2(self.cluster, WYLLIE_CLUSTER, WYLLIE_CLUSTER):
            raise ConfigError(
                "rank cluster", self.cluster,
                f"{WYLLIE_CLUSTER} for a wyllie ring whose table passes one CTA's shared memory (mp={self.mp})",
            )
        if not (self.wide or self.wyllie_split) and not _is_pow2(self.cluster, 1, 1):
            raise ConfigError(
                "rank cluster", self.cluster,
                f"1 for the {self.algo} kernel at mp={self.mp} (only the wide kernel and wyllie rings past "
                f"{SMEM_LIMIT // 4} tokens run on a cluster)",
            )
        if self.smem_bytes > SMEM_LIMIT:
            raise ConfigError(
                "rank cluster", self.cluster,
                f"a cluster whose per-CTA slice fits {SMEM_LIMIT} bytes of shared memory "
                f"({self.smem_bytes} bytes at mp={self.mp})",
            )

    @property
    def wyllie_split(self) -> bool:
        """A packed Wyllie ring whose u32 table passes SMEM_LIMIT: ranked
        by WYLLIE_CLUSTER CTAs, each holding half of it (and a mirror of
        the ring in device memory, table_words a ring)."""
        return self.algo == "wyllie" and not self.wide and self.mp * 4 > SMEM_LIMIT

    @property
    def ruling(self) -> bool:
        """Whether the ruling phases run (ruling and blocked, not wide)."""
        return self.algo in ("ruling", "blocked") and not self.wide

    @property
    def n_steps_dense(self) -> int:
        return ceil_log2(self.mp // self.k)

    @property
    def n_steps_a(self) -> int:
        """Blocked phase-A round cap, from the padded ring as in JAX."""
        return ceil_log2(min(self.block, self.mp)) if self.algo == "blocked" and not self.wide else 0

    @property
    def table_words(self) -> int:
        """u32 words of table per ring: packed ring (+ dense ruler ring
        and sink slot for the ruling phases); two per token (one u64) for
        the wide kernel."""
        if self.wide:
            return 2 * self.mp
        return self.mp + (self.mp // self.k + 1 if self.ruling else 0)

    @property
    def slice_tokens(self) -> int:
        """S = mp / cluster: the tokens each CTA holds (token i lives in
        CTA i // S at slot i % S)."""
        return self.mp // self.cluster

    @property
    def exit_ring_slots(self) -> int:
        """Wide kernel: how many exit tokens (tokens whose successor
        leaves their CTA's slice) the ring may have for each CTA to rank
        them in its own shared memory (csrc/list_rank.cu, phase B2):
        what is left of SMEM_LIMIT after the slice's table (8 bytes a
        token), its exit numbers (2) and 256 bytes of counters, one slot
        kept for the terminal.  More exits take the cluster-wide rounds
        instead."""
        if not self.wide:
            return 0
        return max(0, min(self.mp, (SMEM_LIMIT - 10 * self.slice_tokens - 256) // 8 - 1))

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory each CTA asks for.  Wide: its slice of
        the ring (u64 words, u16 exit numbers), the exit ring and 256
        bytes of counters.  Wyllie on a cluster: its half of the ring
        (u32 words) and 16 bytes for the vote word.  Other packed plans:
        the whole table when it fits SMEM_LIMIT, else 0 (the
        global-scratch variant).  The one-CTA Wyllie kernel sizes its own
        launch: where it holds a thread's words in registers it asks for
        one word more, a sentinel (csrc/list_rank.cu, wyllie_launch), far
        inside SMEM_LIMIT."""
        if self.wide:
            return 10 * self.slice_tokens + 8 * (self.exit_ring_slots + 1) + 256
        if self.wyllie_split:
            return 4 * self.slice_tokens + 16
        return self.table_words * 4 if self.table_words * 4 <= SMEM_LIMIT else 0


def _is_pow2(x, lo: int, hi: int) -> bool:
    return isinstance(x, (int, np.integer)) and not isinstance(x, bool) and lo <= x <= hi and (x & (x - 1)) == 0


def plan_rank(m: int, algo: str = "ruling", k: int = DEFAULT_K, weighted: bool = False,
              dist_bound: Optional[int] = None, block: int = DEFAULT_BLOCK) -> RankPlan:
    """Validate arguments and choose padding, as pallas_rank.wyllie_rank
    does: pad tokens are self-loop terminals; ruling and blocked pad to
    128*k tokens (the dense ruler ring stays 128-aligned), wyllie to 128.
    A ring whose lane-padded length passes 65536, or a weighted ring
    with dist_bound > 65536, takes the wide kernel whatever the algo:
    128-token padding, k ignored, plain Wyllie rounds, one cluster of
    WIDE_CLUSTER CTAs a ring.  A wyllie ring whose table passes
    SMEM_LIMIT takes a cluster of WYLLIE_CLUSTER CTAs a ring."""
    if algo not in ALGOS:
        raise ConfigError("list rank algo", algo, "|".join(ALGOS))
    if not _is_pow2(block, 128, 65536):
        raise ConfigError("rank block", block, "a power of two in [128, 65536]")
    if algo in ("ruling", "blocked"):
        if not _is_pow2(k, 2, 512):
            raise ConfigError("ruling k", k, "a power of two in [2, 512]")
        k = int(k)
        quantum = _LANES * k
        if -(-m // quantum) * quantum > PACKED_MAX_M >= m:
            # kept from the JAX contract: a k-aligned pad that leaves the
            # packed domain ranks with wyllie instead.  For a power of two
            # k <= 512 the quantum divides 65536, so this cannot trigger.
            algo = "wyllie"
            quantum = _LANES
    else:
        k = 8  # unused off the ruling path
        quantum = _LANES
    needs_wide = (-(-m // _LANES) * _LANES) > PACKED_MAX_M or (
        weighted and dist_bound is not None and dist_bound > PACKED_MAX_M
    )
    if needs_wide:
        quantum = _LANES
    mp = -(-m // quantum) * quantum
    if mp > RANK_MAX_M:
        raise ValueError(f"ring too long for the list-rank kernels: {m}")
    if weighted and dist_bound is None:
        raise ValueError("weighted wyllie_rank needs dist_bound (an exclusive bound on any distance)")
    cluster = WIDE_CLUSTER if needs_wide else (WYLLIE_CLUSTER if algo == "wyllie" and mp * 4 > SMEM_LIMIT else 1)
    return RankPlan(m=m, mp=mp, algo=algo, k=k, n_steps=ceil_log2(m), wide=needs_wide, block=int(block),
                    cluster=cluster)


def _prepare(succ: torch.Tensor, weights: Optional[torch.Tensor], algo: str, k: int,
             dist_bound: Optional[int], block: int = DEFAULT_BLOCK):
    """Checks, plan and the padded int32 [D, mp] (succ, w) pair."""
    if succ.dtype != torch.int32:
        raise TypeError(f"succ must be int32, got {succ.dtype}")
    if succ.dim() not in (1, 2):
        raise ValueError(f"succ must be [m] or [D, m], got shape {tuple(succ.shape)}")
    s2 = succ.reshape(1, -1) if succ.dim() == 1 else succ
    d, m = s2.shape
    plan = plan_rank(m, algo, k, weights is not None, dist_bound, block)
    if s2.numel() and bool(((s2 < 0) | (s2 >= m)).any()):
        raise ValueError("succ entries must lie in [0, m)")
    tok = torch.arange(m, dtype=torch.int32, device=s2.device)
    if weights is None:
        w2 = (s2 != tok).to(torch.int32)
    else:
        if weights.shape != succ.shape:
            raise ValueError(f"weights shape {tuple(weights.shape)} != succ shape {tuple(succ.shape)}")
        w2 = weights.reshape(d, m).to(device=s2.device, dtype=torch.int32)
    succ_p = torch.arange(plan.mp, dtype=torch.int32, device=s2.device).repeat(d, 1)
    succ_p[:, :m] = s2
    w_p = torch.zeros((d, plan.mp), dtype=torch.int32, device=s2.device)
    w_p[:, :m] = w2
    return plan, succ_p, w_p


def _finish(dist_p: torch.Tensor, plan: RankPlan, squeeze: bool) -> torch.Tensor:
    out = dist_p[:, : plan.m]
    return out[0] if squeeze else out


def _round(p: torch.Tensor) -> torch.Tensor:
    """One synchronous packed round: p' = (p & 0xFFFF0000) + p[p & 0xFFFF]
    (u32 arithmetic carried in int64)."""
    return ((p & _HIGH) + p.gather(1, p & _LOW)) & _U32


def wide_rank_plain(succ_p: torch.Tensor, w_p: torch.Tensor, plan: RankPlan) -> torch.Tensor:
    """Plain torch version of the wide kernel on padded int32 [D, mp]
    inputs: synchronous dual-table Wyllie in int64, the form of
    pallas_rank._rank_kernel_wide (d += d[s]; s = s[s], n_steps rounds).
    Returns int32 [D, mp]."""
    d = w_p.to(torch.int64)
    s = succ_p.to(torch.int64)
    for _ in range(plan.n_steps):
        d, s = d + d.gather(1, s), s.gather(1, s)
    return d.to(torch.int32)


def packed_rank_plain(succ_p: torch.Tensor, w_p: torch.Tensor, plan: RankPlan) -> torch.Tensor:
    """Plain torch version of the packed kernels on padded int32 [D, mp]
    inputs (the synchronous form of pallas_rank._rank_kernel,
    _rank_kernel_blocked and _ruling_from_packed).  Returns int32
    [D, mp]."""
    p = ((w_p.to(torch.int64) << 16) | (succ_p.to(torch.int64) & _LOW)) & _U32
    if plan.algo == "wyllie":
        for _ in range(plan.n_steps):
            p = _round(p)
        return (p >> 16).to(torch.int32)
    if plan.algo == "blocked":
        # phase A: compose only while the target lies in the token's own
        # block (pallas_rank.py:263-272)
        shift = plan.block.bit_length() - 1
        blk = torch.arange(plan.mp, dtype=torch.int64, device=p.device) >> shift
        for _ in range(plan.n_steps_a):
            p = torch.where(((p & _LOW) >> shift) == blk, _round(p), p)
    k = plan.k
    # phase 1: freeze at rulers (index % k == 0), absorb at terminals
    done = ((p & _LOW) & (k - 1)) == 0
    i = 0
    while i < plan.n_steps and not bool(done.all()):
        s = p & _LOW
        at_ruler = (s & (k - 1)) == 0
        g = p.gather(1, s)
        done = done | at_ruler | ((g & _LOW) == s)
        p = torch.where(at_ruler, p, ((p & _HIGH) + g) & _U32)
        i += 1
    # phase 2: dense ruler ring (slot r <-> token r*k) + 128-slot sink row
    d = p.shape[0]
    mr = plan.mp // k
    pr = p[:, ::k]
    t1r = pr & _LOW
    dense_t = torch.where((t1r & (k - 1)) != 0, torch.full_like(t1r, mr), t1r // k)
    sink = (mr + torch.arange(_LANES, dtype=torch.int64, device=p.device)).repeat(d, 1)
    ring_d = torch.cat([((pr >> 16) << 16) | dense_t, sink], dim=1)
    for _ in range(plan.n_steps_dense):
        ring_d = _round(ring_d)
    dist_d = ring_d >> 16
    # phase 3: recombine
    t1 = p & _LOW
    extra = dist_d.gather(1, t1 // k)
    out = (p >> 16) + torch.where((t1 & (k - 1)) != 0, torch.zeros_like(extra), extra)
    return out.to(torch.int32)


def rank_plain(succ_p: torch.Tensor, w_p: torch.Tensor, plan: RankPlan) -> torch.Tensor:
    """The plain torch version of whichever kernel `plan` picks."""
    return (wide_rank_plain if plan.wide else packed_rank_plain)(succ_p, w_p, plan)


def wyllie_rank_reference(succ, algo: str = "ruling", k: int = DEFAULT_K, weights=None,
                          dist_bound: Optional[int] = None, block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Plain torch version with wyllie_rank's contract, run on whatever
    device `succ` lies on (a numpy array is taken as a CPU tensor)."""
    succ_t = torch.as_tensor(succ)
    w_t = None if weights is None else torch.as_tensor(weights, device=succ_t.device)
    plan, succ_p, w_p = _prepare(succ_t, w_t, algo, k, dist_bound, block)
    return _finish(rank_plain(succ_p, w_p, plan), plan, succ_t.dim() == 1)


def wyllie_rank(succ, algo: str = "ruling", k: int = DEFAULT_K, weights=None,
                dist_bound: Optional[int] = None, device: DeviceLike = "cuda",
                block: int = DEFAULT_BLOCK) -> torch.Tensor:
    """dist-to-terminal for a successor ring (terminal = self-loop).

    succ: int32 [m] or [D, m] with entries in [0, m); returns int32 of
    the same shape on `device`.  `weights` generalizes to
    dist(i) = weights[i] + dist(succ[i]) (terminals weigh 0) and then
    requires `dist_bound`, an exclusive bound on any distance: the
    packed kernels carry dist in 16 bits, so a bound past
    65536 takes the wide kernel.  algo: "ruling" (default), "wyllie" or
    "blocked" (phase A inside `block`-token blocks, a power of two in
    [128, 65536], then the ruling phases); k must be a power of two in
    [2, 512]; rings whose lane-padded length passes 65536 take the wide
    kernel whatever the algo; rings padding past RANK_MAX_M raise
    ValueError."""
    dev = resolve_device(device)
    succ_t = torch.as_tensor(succ).to(dev)
    w_t = None if weights is None else torch.as_tensor(weights).to(dev)
    plan, succ_p, w_p = _prepare(succ_t, w_t, algo, k, dist_bound, block)
    if succ_p.device.type == "cpu":
        dist_p = rank_plain(succ_p, w_p, plan)
    else:
        dist_p = launch_kernel(succ_p, w_p, plan)
    return _finish(dist_p, plan, succ_t.dim() == 1)


# ---- the CUDA kernels ------------------------------------------------------

_lib_handle: Optional[ctypes.CDLL] = None
_smem_budget: Dict[int, int] = {}
_max_clusters: Dict[Tuple[int, bool, int, int], int] = {}


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is None:
        from .._build import library

        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib = library("list_rank")
        for name, args in (
            ("list_rank_launch", [ptr] * 4 + [i32] * 9 + [ptr]),
            ("list_rank_launch_timed", [ptr] * 5 + [i32] * 8 + [ptr]),
            ("list_rank_wyllie_launch_timed", [ptr] * 5 + [i32] * 6 + [ptr]),
            ("list_rank_wide_launch", [ptr] * 3 + [i32] * 6 + [ptr]),
            ("list_rank_wyllie_cluster_launch", [ptr] * 4 + [i32] * 4 + [ptr]),
            ("list_rank_cluster_occupancy", [i32] * 3 + [ctypes.POINTER(i32)]),
            ("list_rank_smem_budget", [i32]),
        ):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = i32
        lib.list_rank_error_string.argtypes = [i32]
        lib.list_rank_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def _check(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().list_rank_error_string(err).decode()
        raise KernelLaunchError(f"list_rank {what} failed: cudaError {err} ({msg})")


def _device_index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def smem_budget(device: torch.device) -> int:
    """Opt-in dynamic shared memory (bytes) one block may use on `device`."""
    idx = _device_index(device)
    if idx not in _smem_budget:
        v = _lib().list_rank_smem_budget(idx)
        if v <= 0:
            raise DeviceUnavailable(f"cannot read the shared-memory limit of cuda:{idx} (no such device?)")
        _smem_budget[idx] = v
    return _smem_budget[idx]


def max_active_clusters(plan: RankPlan, device: torch.device) -> int:
    """How many clusters of plan.cluster CTAs of the plan's cluster
    kernel (wide, or two-CTA Wyllie; each CTA with plan.smem_bytes of
    shared memory) `device` holds at once (cudaOccupancyMaxActiveClusters);
    0 when such a cluster cannot be scheduled.  Cached per (device,
    kernel, C, bytes)."""
    if plan.cluster == 1:
        raise ValueError("max_active_clusters needs a plan on a cluster (wide, or wyllie past SMEM_LIMIT)")
    key = (_device_index(device), plan.wide, plan.cluster, plan.smem_bytes)
    if key not in _max_clusters:
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = _lib().list_rank_cluster_occupancy(int(not plan.wide), plan.cluster, plan.smem_bytes,
                                                     ctypes.byref(out))
        _check(err, f"occupancy query for a cluster of {plan.cluster}")
        _max_clusters[key] = out.value
    return _max_clusters[key]


def launch_key(plan: RankPlan) -> str:
    """The LAUNCHES key of the kernel `plan` launches, by where its table
    lives: "wide/cluster" and "wyllie/cluster" (split across a cluster's
    shared memories), or "{algo}/smem" (one CTA's shared memory) and
    "{algo}/global" (a scratch buffer in device memory, for ruling and
    blocked tables past SMEM_LIMIT)."""
    if plan.wide:
        return "wide/cluster"
    if plan.wyllie_split:
        return "wyllie/cluster"
    return f"{plan.algo}/{'smem' if plan.smem_bytes else 'global'}"


def _check_plan_fits(plan: RankPlan, dev: torch.device) -> None:
    """The host-side checks of a plan against the card: its shared-memory
    slice within the per-block budget, its cluster one the card can
    schedule.  ConfigError (a LoroError: the supervisor passes it
    through) when either does not hold."""
    if plan.smem_bytes > smem_budget(dev):
        raise ConfigError("rank plan shared memory per CTA", plan.smem_bytes,
                          f"at most {dev}'s {smem_budget(dev)} bytes")
    if plan.cluster > 1 and max_active_clusters(plan, dev) < 1:
        raise ConfigError(
            "rank plan cluster", f"{plan.cluster} CTAs with {plan.smem_bytes} bytes of shared memory each",
            f"a cluster that {dev} ({torch.cuda.get_device_name(dev)}) can schedule",
        )


def _launch(succ_p: torch.Tensor, w_p: torch.Tensor, plan: RankPlan,
            stamps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Check the inputs, launch, raise on a launch error; returns dist.
    `stamps` takes the timed kernel (launch_timed)."""
    if succ_p.device.type != "cuda" or w_p.device != succ_p.device:
        raise ValueError("launch_kernel needs succ and w on one CUDA device")
    if succ_p.dtype != torch.int32 or w_p.dtype != torch.int32:
        raise TypeError("launch_kernel needs int32 succ and w")
    if succ_p.shape != w_p.shape or succ_p.dim() != 2 or succ_p.shape[1] != plan.mp:
        raise ValueError(f"launch_kernel needs [D, {plan.mp}] inputs, got {tuple(succ_p.shape)}")
    if not (succ_p.is_contiguous() and w_p.is_contiguous()):
        raise ValueError("launch_kernel needs contiguous inputs")
    dev = succ_p.device
    d = succ_p.shape[0]
    _check_plan_fits(plan, dev)
    dist = torch.empty_like(succ_p)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (succ_p.data_ptr(), w_p.data_ptr(), dist.data_ptr())
    with torch.cuda.device(dev):
        if plan.wide:
            err = _lib().list_rank_wide_launch(
                *ptrs, d, plan.mp, plan.n_steps, plan.exit_ring_slots, plan.cluster, plan.smem_bytes, stream
            )
        else:
            smem = plan.smem_bytes > 0
            # a table in device memory, or the two-CTA kernel's mirror of the ring
            scratch = None if smem and not plan.wyllie_split else torch.empty(
                d * plan.table_words, dtype=torch.int32, device=dev)
            ptrs += (None if scratch is None else scratch.data_ptr(),)
            shape = (d, plan.mp, plan.n_steps, plan.n_steps_dense if plan.ruling else 0)
            rest = (plan.k.bit_length() - 1, plan.n_steps_a, plan.block.bit_length() - 1, int(smem), stream)
            if stamps is not None and not plan.ruling:
                err = _lib().list_rank_wyllie_launch_timed(*ptrs, stamps.data_ptr(), d, plan.mp, plan.n_steps,
                                                           int(smem), plan.cluster, plan.smem_bytes, stream)
            elif stamps is not None:
                err = _lib().list_rank_launch_timed(*ptrs, stamps.data_ptr(), *shape, *rest)
            elif plan.wyllie_split:
                err = _lib().list_rank_wyllie_cluster_launch(*ptrs, d, plan.mp, plan.n_steps, plan.smem_bytes, stream)
            else:
                err = _lib().list_rank_launch(*ptrs, *shape, int(plan.ruling), *rest)
    _check(err, "kernel launch")
    return dist


def launch_kernel(succ_p: torch.Tensor, w_p: torch.Tensor, plan: RankPlan) -> torch.Tensor:
    """Launch csrc/list_rank.cu on padded int32 [D, mp] CUDA tensors:
    the wide kernel on a cluster of plan.cluster CTAs a ring, or the
    one-CTA packed kernel (ruling, wyllie, blocked).  Returns int32
    [D, mp] dist.  Raises KernelLaunchError on a launch error, and
    ConfigError on a shared-memory slice the device cannot give and on a
    cluster the device cannot schedule."""
    dist = _launch(succ_p, w_p, plan)
    LAUNCHES[launch_key(plan)] += 1
    return dist


def launch_timed(succ_p: torch.Tensor, w_p: torch.Tensor, plan: RankPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """The packed kernel of a plan, timed inside: (dist, int64 stamps).
    Ruling and blocked: stamps [D, 8]; per ring, stamps[:, 1:6] -
    stamps[:, 0:5] are the cycles (the SM clock, read by clock64) of
    PHASES.  Wyllie: stamps [D * plan.cluster, WYLLIE_STAMPS], one row a
    CTA, read by wyllie_rounds.  For measurement only: not counted in
    LAUNCHES."""
    if plan.wide:
        raise ValueError("launch_timed needs a packed plan (ruling, blocked or wyllie)")
    shape = (succ_p.shape[0], 8) if plan.ruling else (succ_p.shape[0] * plan.cluster, WYLLIE_STAMPS)
    stamps = torch.zeros(shape, dtype=torch.int64, device=succ_p.device)
    return _launch(succ_p, w_p, plan, stamps), stamps


def wyllie_rounds(stamps: torch.Tensor) -> Dict[str, object]:
    """Reads the stamps of timed Wyllie launches (rows of WYLLIE_STAMPS,
    one a CTA, any number of launches stacked): the median over rows of
    the load's cycles, the store's, each round's cycles and moved words
    (rounds that every row ran), and the rounds taken (min, max)."""
    st = stamps.to(torch.float64).cpu()
    rounds = st[:, 2 * MAX_ROUNDS + 3].to(torch.int64)
    lo, hi = int(rounds.min()), int(rounds.max())
    clock = torch.cat([st[:, 1:2], st[:, 2:2 + lo]], dim=1)
    end = st.gather(1, (rounds + 1).view(-1, 1)).view(-1)  # the clock after the last round
    return {
        "rounds": (lo, hi),
        "load_cycles": float((st[:, 1] - st[:, 0]).median()),
        "round_cycles": (clock[:, 1:] - clock[:, :-1]).median(dim=0).values.tolist(),
        "moved": st[:, 2 + MAX_ROUNDS:2 + MAX_ROUNDS + lo].median(dim=0).values.tolist(),
        "rounds_cycles": float((end - st[:, 1]).median()),
        "store_cycles": float((st[:, 2 * MAX_ROUNDS + 2] - end).median()),
        "total_cycles": float((st[:, 2 * MAX_ROUNDS + 2] - st[:, 0]).median()),
    }


# ---- the sparse ruling route (rings past RANK_MAX_M) -------------------------


def sparse_rank_plain(succ: torch.Tensor) -> torch.Tensor:
    """Plain torch version of csrc/sparse_rank.cu on int32 [D, m], on
    succ's device: the same rulers (index % SPARSE_K == 0, terminals,
    in-degree other than 1), every ruler's walk taken one step a round
    for all rulers at once, the ruler ring ranked by synchronous pointer
    doubling, the same expansion dist = D(owner) - offset.  Irregular
    rulers take their slots in token order (the kernel's are in the
    order of its atomics; no distance depends on it).  The kernel walks
    a run of index-consecutive tokens as one step and writes owners at
    run starts only; the owners it implies are the ones written here.
    Returns int32 [D, m]."""
    n_docs, m = succ.shape
    dev = succ.device
    if n_docs * m == 0:
        return torch.empty((n_docs, m), dtype=torch.int32, device=dev)
    i64 = torch.int64
    tok = torch.arange(m, dtype=i64, device=dev)
    s = succ.to(i64)
    term = (s == tok) | (s < 0) | (s >= m)
    s = torch.where(term, tok, s)
    indeg = torch.zeros((n_docs, m), dtype=i64, device=dev).scatter_add_(1, s, (~term).to(i64))
    regular = (tok % SPARSE_K) == 0
    ruler = regular | term | (indeg != 1)
    irregular = ruler & ~regular
    nblk = -(-m // SPARSE_K)
    slot = torch.where(regular, tok // SPARSE_K, nblk + irregular.cumsum(1) - 1)
    # flat ids: token (d, i) -> d * m + i, slot (d, j) -> d * m + j (a ring has at most m rulers)
    base = torch.arange(n_docs, dtype=i64, device=dev)[:, None] * m
    nxt = (s + base).view(-1)
    is_ruler = ruler.view(-1)
    starts = (tok + base)[ruler]
    gslot = (slot + base)[ruler]
    own_slot = torch.zeros(n_docs * m, dtype=i64, device=dev)
    own_off = torch.zeros_like(own_slot)
    own_slot[starts] = gslot
    stop = starts.clone()
    weight = torch.zeros_like(starts)
    live = torch.nonzero(nxt[starts] != starts).view(-1)  # terminal rulers stop at themselves
    cur = nxt[starts[live]]
    steps = 1
    while live.numel():
        at = is_ruler[cur]
        stop[live[at]] = cur[at]
        weight[live[at]] = steps
        live, cur = live[~at], cur[~at]
        own_slot[cur] = gslot[live]
        own_off[cur] = steps
        cur = nxt[cur]
        steps += 1
    r_d = torch.zeros(n_docs * m, dtype=i64, device=dev)
    r_t = torch.arange(n_docs * m, dtype=i64, device=dev)
    r_d[gslot] = weight
    r_t[gslot] = own_slot[stop]
    for _ in range(ceil_log2(nblk + int(irregular.sum(1).max()))):
        r_d, r_t = r_d + r_d[r_t], r_t[r_t]
    return (r_d[own_slot] - own_off).view(n_docs, m).to(torch.int32)


def sparse_rank(succ) -> torch.Tensor:
    """dist-to-terminal of a successor in-forest of any length (terminal =
    self-loop; any number of heads and of tokens sharing a successor), the
    route for rings past RANK_MAX_M.  succ: int32 [m] or [D, m]; returns
    int32 of the same shape on succ's device.  A CUDA tensor launches
    csrc/sparse_rank.cu (LAUNCHES["sparse/global"]) or raises, with no
    host sync; a CPU tensor runs sparse_rank_plain.  The result equals
    fugue_batch._wyllie_dist bit for bit.  No bounds check (it would sync
    the device): an entry outside [0, m) ranks as a terminal."""
    succ_t = torch.as_tensor(succ)
    if succ_t.dtype != torch.int32:
        raise TypeError(f"succ must be int32, got {succ_t.dtype}")
    if succ_t.dim() not in (1, 2):
        raise ValueError(f"succ must be [m] or [D, m], got shape {tuple(succ_t.shape)}")
    s2 = succ_t.reshape(1, -1) if succ_t.dim() == 1 else succ_t
    if s2.device.type == "cpu":
        out = sparse_rank_plain(s2)
    else:
        out = _launch_sparse(s2)
        LAUNCHES["sparse/global"] += 1
    return out[0] if succ_t.dim() == 1 else out


_sparse_handle: Optional[ctypes.CDLL] = None


def _sparse_lib() -> ctypes.CDLL:
    global _sparse_handle
    if _sparse_handle is None:
        from .._build import library

        lib = library("sparse_rank")
        lib.sparse_rank_launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.sparse_rank_launch.restype = ctypes.c_int
        lib.sparse_rank_error_string.argtypes = [ctypes.c_int]
        lib.sparse_rank_error_string.restype = ctypes.c_char_p
        _sparse_handle = lib
    return _sparse_handle


def _launch_sparse(succ: torch.Tensor) -> torch.Tensor:
    """Launch csrc/sparse_rank.cu on int32 [D, m] CUDA succ at ruler
    spacing SPARSE_K; not counted.  The scratch tables are allocated
    here: 24 bytes a token and four bits.  Raises KernelLaunchError on a
    launch error."""
    if succ.device.type != "cuda":
        raise ValueError(f"sparse_rank launches on a CUDA tensor, got {succ.device}")
    k = SPARSE_K
    succ = succ.contiguous()
    d, m = succ.shape
    dev = succ.device
    dist = torch.empty((d, m), dtype=torch.int32, device=dev)
    if d * m == 0:
        return dist
    nblk = -(-m // k)
    i32 = dict(dtype=torch.int32, device=dev)
    n = d * m
    deg, bits = torch.empty(-(-n // 16), **i32), torch.empty(2 * -(-n // 32), **i32)
    rtok, nirr = torch.empty((d, m), **i32), torch.empty(d, **i32)
    own, rw = (torch.empty((d, m), dtype=torch.int64, device=dev) for _ in range(2))
    # rulers one CTA ranks in shared memory (the kernel cuts it to the
    # device's limit): room for as many irregular rulers (heads, merges,
    # terminals) as regular ones; more take its device-memory rounds
    smem_slots = min(m, 2 * nblk)
    ptrs = [t.data_ptr() for t in (succ, dist, deg, bits, rtok, nirr, own, rw)]
    with torch.cuda.device(dev):
        err = _sparse_lib().sparse_rank_launch(*ptrs, d, m, k.bit_length() - 1, smem_slots,
                                               torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = _sparse_lib().sparse_rank_error_string(err).decode()
        raise KernelLaunchError(f"sparse_rank launch failed: cudaError {err} ({msg})")
    return dist
