"""The port's list-rank kernels on the card, against their plain torch
versions (ops/list_rank.py) on the same CUDA tensors.

Imports torch, numpy, pytest and loro_tpu_torch only, so it runs on a
machine without jax:
    python -m pytest -q -m cuda --noconftest tests/test_torch_list_rank_cuda.py
Every test is marked `cuda` and skips without a card.

Tolerance: exact — distances are integers and the kernels must give the
plain versions' int32 values bit for bit.
"""
import numpy as np
import pytest
import torch

from loro_tpu_torch.ops import list_rank as lr


def _random_ring(m: int, seed: int) -> np.ndarray:
    """One ring through every token."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(m).astype(np.int32)
    succ = np.empty(m, np.int32)
    succ[perm[:-1]] = perm[1:]
    succ[perm[-1]] = perm[-1]
    return succ


def _cross_slice_ring(m: int, s: int) -> np.ndarray:
    """One chain whose every pointer leaves its CTA's slice of s tokens
    when m is a multiple of s: succ[i] = (i + s) mod m, plus one where
    it wraps, ending in the terminal m - 1."""
    i = np.arange(m, dtype=np.int64)
    succ = ((i + s) % m + (i + s) // m).astype(np.int32)
    succ[m - 1] = m - 1
    return succ


def _weighted_ring():
    """20,000 tokens with weights 3 or 4: distances pass 65,536, under
    dist_bound 70,000, so the ring takes the wide kernel."""
    rng = np.random.default_rng(8)
    succ = _random_ring(20000, 9)
    w = np.where(succ == np.arange(20000), 0, 3 + (rng.random(20000) < 0.3)).astype(np.int32)
    assert int(w.sum()) < 70_000
    return succ, w


def _weighted_packed_ring(m: int, seed: int):
    """A random ring whose weights (1 to 3) bring the distances near
    dist_bound = 65,536, the packed kernels' limit."""
    succ = _random_ring(m, seed)
    base = 65_536 // m
    w = (base + (np.random.default_rng(seed).random(m) < (64_500 - base * m) / m)).astype(np.int32)
    w[succ == np.arange(m)] = 0
    assert 60_000 < int(w.sum()) < 65_536
    return succ, w


def _short_lists(m: int, length: int, seed: int) -> np.ndarray:
    """Many lists of `length` tokens in random order (a head every
    `length` tokens)."""
    perm = np.random.default_rng(seed).permutation(m).astype(np.int32)
    succ = np.arange(m, dtype=np.int32)
    body = np.arange(m - 1) % length != length - 1
    succ[perm[:-1][body]] = perm[1:][body]
    return succ


def _in_tree(m: int, seed: int) -> np.ndarray:
    """A random recursive tree: many tokens share a successor."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(m).astype(np.int32)
    succ = np.empty(m, np.int32)
    succ[perm] = perm[(rng.random(m) * np.arange(m)).astype(np.int64)]
    return succ


def _gap_ring(m: int, k: int) -> np.ndarray:
    """Every non-ruler before any ruler along the ring: the longest ruler
    gap, m - m/k hops."""
    order = np.concatenate([np.flatnonzero(np.arange(m) % k != 0), np.flatnonzero(np.arange(m) % k == 0)])
    succ = np.arange(m, dtype=np.int32)
    succ[order[:-1]] = order[1:]
    return succ


def _runs_ring(m: int, run_len: int, seed: int) -> np.ndarray:
    """One chain over index-consecutive runs in shuffled run order."""
    starts = np.arange(0, m, run_len)
    order = np.random.default_rng(seed).permutation(len(starts))
    ends = np.minimum(starts + run_len, m) - 1
    succ = np.arange(1, m + 1, dtype=np.int32)
    succ[ends[order[:-1]]] = starts[order[1:]]
    succ[ends[order[-1]]] = ends[order[-1]]
    return succ


def _needs_card() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card")


def _check(succ, expect: str, **kw) -> None:
    s = torch.as_tensor(succ).cuda()
    if "weights" in kw:
        kw["weights"] = torch.as_tensor(kw["weights"]).cuda()
    before = dict(lr.LAUNCHES)
    got = lr.wyllie_rank(s, **kw)
    torch.cuda.synchronize()
    assert {k for k, v in lr.LAUNCHES.items() if v != before[k]} == {expect}
    ref = lr.wyllie_rank_reference(s, **kw)
    assert got.dtype == torch.int32 and got.shape == s.shape
    assert torch.equal(got, ref), int((got.long() - ref.long()).abs().max())


@pytest.mark.cuda
def test_kernel_matches_reference_on_card():
    """Kernel vs plain version on CUDA tensors (both table variants of
    the packed kernels, and the wide kernel)."""
    _needs_card()
    for algo in ("ruling", "wyllie", "blocked"):
        for m in (1000, 51200, 52000, 58112, 58200, 65536, 65537, 131072):
            s = torch.from_numpy(_random_ring(m, m)).cuda()
            got = lr.wyllie_rank(s, algo=algo)
            torch.cuda.synchronize()
            assert torch.equal(got, lr.wyllie_rank_reference(s, algo=algo)), (algo, m)


_CASES = [("ruling", m) for m in (1000, 35840, 65536)]
_CASES += [("wide", m) for m in (65537, 98304, 131072, "weighted", "cross")]
# wyllie: one CTA (words in registers up to 39,936 tokens), then past
# 58,112 tokens (one CTA's shared memory) a cluster of WYLLIE_CLUSTER
_CASES += [("wyllie", m) for m in (1, 1000, 34944, 39936, 39937, 58112, 58113, 65536, "weighted", "weighted-split")]


@pytest.mark.cuda
@pytest.mark.parametrize("route,m", _CASES, ids=[f"{r}-m{m}" for r, m in _CASES])
def test_cluster_kernels_match_plain_on_card(route, m):
    """The ruling route (one CTA a ring), the wide route (a cluster of
    WIDE_CLUSTER CTAs a ring) on random rings, the weighted wide ring and
    a ring whose every pointer crosses CTA slices, and the wyllie route on
    both sides of its register and shared-memory edges and on weighted
    rings whose distances come near dist_bound = 65,536."""
    _needs_card()
    if route == "wyllie" and str(m).startswith("weighted"):
        succ, w = _weighted_packed_ring(60000 if m == "weighted-split" else 30000, 11)
        plan = lr.plan_rank(succ.shape[0], "wyllie", weighted=True, dist_bound=65_536)
        assert not plan.wide and plan.wyllie_split == (m == "weighted-split")
        _check(succ, lr.launch_key(plan), algo="wyllie", weights=w, dist_bound=65_536)
    elif route == "wyllie":
        plan = lr.plan_rank(m, "wyllie")
        assert plan.wyllie_split == (plan.mp > lr.SMEM_LIMIT // 4)
        _check(np.stack([_random_ring(m, m + i) for i in range(2)]), lr.launch_key(plan), algo="wyllie")
    elif m == "weighted":
        succ, w = _weighted_ring()
        _check(succ, "wide/cluster", weights=w, dist_bound=70_000)
    elif m == "cross":
        plan = lr.plan_rank(65664)
        assert plan.wide and plan.cluster == lr.WIDE_CLUSTER
        _check(_cross_slice_ring(plan.mp, plan.slice_tokens), "wide/cluster")
    else:
        plan = lr.plan_rank(m)
        assert plan.wide == (route == "wide")
        _check(np.stack([_random_ring(m, m + i) for i in range(2)]), lr.launch_key(plan))


# Ring families for the ruling phases, blocked's phase A and wyllie's
# rounds: many heads, an in-tree, the longest ruler gaps, every ruler
# spacing, weights, both sides of the shared-memory boundary, and phase A
# on runs at every block.
_FAMILY_RINGS = {
    "short-lists": lambda: _short_lists(35000, 6, 1),
    "in-tree": lambda: _in_tree(35000, 2),
    "gap-2048": lambda: _gap_ring(2048, 8),
    "gap-65536": lambda: _gap_ring(65536, 8),
    "runs": lambda: _runs_ring(40000, 37, 3),
}
_FAMILY_CASES = [(algo, ring) for algo in ("ruling", "blocked", "wyllie") for ring in _FAMILY_RINGS]


@pytest.mark.cuda
@pytest.mark.parametrize("algo,ring", _FAMILY_CASES, ids=[f"{a}-{r}" for a, r in _FAMILY_CASES])
def test_ring_families_match_plain_on_card(algo, ring):
    _needs_card()
    succ = _FAMILY_RINGS[ring]()
    _check(succ, lr.launch_key(lr.plan_rank(succ.shape[0], algo)), algo=algo)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 8, 64, 512])
def test_ruler_spacings_match_plain_on_card(k):
    _needs_card()
    for algo in ("ruling", "blocked"):
        succ = np.stack([_random_ring(30000, k), _in_tree(30000, k)])
        _check(succ, lr.launch_key(lr.plan_rank(30000, algo, k)), algo=algo, k=k)


@pytest.mark.cuda
def test_weighted_and_boundary_rings_match_plain_on_card():
    """A weighted in-tree, and random rings on the last shared-memory
    size and the first global-scratch one of the ruling table."""
    _needs_card()
    rng = np.random.default_rng(5)
    succ = _in_tree(30000, 6)
    w = np.where(succ == np.arange(30000), 0, rng.integers(1, 3, 30000)).astype(np.int32)
    under = 1024
    while lr.plan_rank(under + 1024).smem_bytes:
        under += 1024
    for algo in ("ruling", "blocked"):
        _check(succ, f"{algo}/smem", algo=algo, weights=w, dist_bound=60_000)
        _check(_random_ring(under, 7), f"{algo}/smem", algo=algo)
        _check(_random_ring(under + 1, 8), f"{algo}/global", algo=algo)


@pytest.mark.cuda
@pytest.mark.parametrize("block", [128, 1024, 65536])
def test_blocked_runs_match_plain_on_card(block):
    _needs_card()
    for m in (1000, 35000, 65536):
        _check(_runs_ring(m, 37, m + block), lr.launch_key(lr.plan_rank(m, "blocked")), algo="blocked", block=block)


# ---- the coalesced rank and the packed transport ------------------------------


_COALESCED_RINGS = {
    **_FAMILY_RINGS,
    "random-35000": lambda: _random_ring(35000, 4),
    "random-65536": lambda: _random_ring(65536, 5),
    "one-chain": lambda: np.minimum(np.arange(1, 40001), 39999).astype(np.int32),
    "over-cap": lambda: _runs_ring(131072, 4096, 6),
}


@pytest.mark.cuda
@pytest.mark.parametrize("ring", list(_COALESCED_RINGS))
def test_coalesced_matches_plain_on_card(ring):
    """cuda:coalesced (the weighted kernel on the contracted ring,
    dist_bound = m) against torch:coalesced (the plain weighted ruling),
    at the default budget and at a tight one from the run counts; a
    contracted ring that pads past RANK_MAX_M takes the plain ruling and
    is counted in RANK_ROUTES."""
    _needs_card()
    from loro_tpu_torch.ops import fugue_batch as fb
    from loro_tpu_torch.ops import rank_model as rm

    succ = np.stack([_COALESCED_RINGS[ring]()] * 2)
    m = succ.shape[1]
    s = torch.from_numpy(succ).cuda()
    _, n_runs = fb.ring_run_heads(s)
    assert n_runs.tolist() == [int(rm.run_heads(row).sum()) for row in succ]
    for r_pad in (None, rm.coalesce_budget(int(n_runs.max()))):
        r = max(128, -(-(m if r_pad is None else r_pad) // 128) * 128)
        over_cap = -(-(r + 1) // 128) * 128 > lr.RANK_MAX_M
        before, routes = dict(lr.LAUNCHES), fb.RANK_ROUTES["torch:coalesced/over_cap"]
        got = fb._coalesced_dist(s, r_pad, use_kernel=True)
        torch.cuda.synchronize()
        ran = {k for k, v in lr.LAUNCHES.items() if v != before[k]}
        if over_cap:
            assert ran == set() and fb.RANK_ROUTES["torch:coalesced/over_cap"] == routes + 1
        else:
            assert ran == {lr.launch_key(lr.plan_rank(r + 1, weighted=True, dist_bound=m))}
        want = fb._coalesced_dist(s.cpu(), r_pad)
        assert got.dtype == torch.int32 and torch.equal(got.cpu(), want), (ring, r_pad)
        assert torch.equal(want, fb._wyllie_dist(s.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("pads", [(64, 256), (61, 256), (64, 253), (3000, 20001)], ids=lambda p: f"C{p[0]}-N{p[1]}")
def test_packed_unpack_on_card_matches_cpu(pads):
    """The packed buffer unpacked on the card equals the unpack on the
    CPU, field for field, with aligned and unaligned pads (C + N odd puts
    the int32 sections off a 4-byte boundary)."""
    _needs_card()
    from loro_tpu_torch.ops import fugue_batch as fb

    c, n = pads
    rng = np.random.default_rng(c + n)
    packed = np.empty((3, fb.packed_row_bytes(c, n)), np.uint8)
    for row in packed:
        cols = fb.ChainColumns(
            c_parent=rng.integers(-1, c, c).astype(np.int32), c_side=rng.integers(0, 2, c).astype(np.int32),
            c_valid=rng.random(c) < 0.8, head_row=rng.integers(-(2**31), 2**31 - 1, c, dtype=np.int64).astype(np.int32),
            chain_id=rng.integers(0, c, n).astype(np.int32), deleted=rng.random(n) < 0.3,
            content=rng.integers(-(2**31), 2**31 - 1, n, dtype=np.int64).astype(np.int32), valid=rng.random(n) < 0.9,
        )
        fb.pack_chain_doc_into(cols, row)
    on_card = fb._unpack_chain_batch(torch.from_numpy(packed).cuda(), c, n)
    on_cpu = fb._unpack_chain_batch(torch.from_numpy(packed), c, n)
    for f in fb.ChainColumns._fields:
        a, b = getattr(on_card, f), getattr(on_cpu, f)
        assert a.device.type == "cuda" and a.dtype == b.dtype and torch.equal(a.cpu(), b), f


@pytest.mark.cuda
def test_packed_merge_on_card_matches_cpu():
    """A packed chunk of generated docs (unaligned pads) merges on the card
    as on the CPU, for every rank spec."""
    _needs_card()
    from loro_tpu_torch import tracegen
    from loro_tpu_torch.ops import columnar
    from loro_tpu_torch.ops import fugue_batch as fb

    docs = tracegen.fleet_docs(2, n_patches=3000, seed=3, use_cache=False)
    pad_n = max(d.extract.n for d in docs) + 7
    pad_c = max(columnar.contract_chains(d.extract).n_chains for d in docs) + 4
    packed = np.empty((len(docs), fb.packed_row_bytes(pad_c, pad_n)), np.uint8)
    for d, row in zip(docs, packed):
        fb.pack_chain_doc_into(columnar.chain_columns(d.extract, pad_n=pad_n, pad_c=pad_c), row)
    want = fb.chain_merge_docs_packed_checksum(packed, pad_c, pad_n, device="cpu")
    for spec in (None, "cuda:ruling", "cuda:wyllie", "cuda:blocked", "cuda:coalesced"):
        got = fb.chain_merge_docs_packed_checksum(packed, pad_c, pad_n, spec, device="cuda")
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want)), spec


# ---- the sparse ruling route (rings past RANK_MAX_M) ---------------------------


def _euler_ring(n_el: int, n: int, device) -> torch.Tensor:
    """The Euler ring [2 (n + 1)] of a right spine of n_el elements padded
    to n rows: the invalid rows' tokens chained by index into it."""
    from loro_tpu_torch import entry
    from loro_tpu_torch.ops import columnar as pcol
    from loro_tpu_torch.ops import fugue_batch as fb

    ex = entry.example_cols(d=1, n=n_el)
    cols = fb.SeqColumns(*[pcol.pad_rows(a[0], n, f) for a, f in zip(ex, (-1, 0, 0, 0, True, -1, False))])
    t = fb.seq_columns_to_torch(cols, device=device)
    return fb._ring_and_anchors(t.parent, t.side, t.valid)[0][0]


def _sparse_rows(rows: str, m: int, device) -> torch.Tensor:
    """[len(rows), m] rings on the card: e an Euler ring (a spine of
    m / 4 elements), r a random single list, t a random in-tree, s a
    star (every token but one a head)."""
    make = {
        "e": lambda: _euler_ring(m // 4, m // 2 - 1, device),
        "r": lambda: torch.from_numpy(_random_ring(m, m + 1)).to(device),
        "t": lambda: torch.from_numpy(_in_tree(m, m + 2)).to(device),
        "s": lambda: torch.full((m,), m // 3, dtype=torch.int32, device=device),
    }
    return torch.stack([make[c]() for c in rows])


_SPARSE_SHAPES = [("erts", 524_290), ("er", 1_048_578), ("ts", 1_048_578)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,m", _SPARSE_SHAPES, ids=[f"{r}-m{m}" for r, m in _SPARSE_SHAPES])
def test_sparse_kernel_matches_plain_and_wyllie_on_card(rows, m):
    """The sparse ruling kernel equals its plain version and _wyllie_dist
    bit for bit past RANK_MAX_M (Euler ring, random list, in-tree, star),
    with one launch a call in LAUNCHES["sparse/global"]."""
    _needs_card()
    from loro_tpu_torch.ops import fugue_batch as fb

    s = _sparse_rows(rows, m, "cuda")
    assert m > lr.RANK_MAX_M and fb._resolve_rank_spec(None, s.device, m) == ("cuda", "sparse")
    for _ in range(2):
        before = dict(lr.LAUNCHES)
        got = lr.sparse_rank(s)
        torch.cuda.synchronize()
        assert {k: v - before[k] for k, v in lr.LAUNCHES.items() if v != before[k]} == {"sparse/global": 1}
    want = fb._wyllie_dist(s)
    assert got.dtype == torch.int32 and got.shape == s.shape
    assert torch.equal(got, want), int((got.long() - want.long()).abs().max())
    assert torch.equal(lr.sparse_rank_plain(s), want)
    assert torch.equal(lr.sparse_rank(s[0]), want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("offset", ["rows", "one_token"])
def test_sparse_kernel_reads_unaligned_views_in_place_on_card(offset):
    """A view that starts off a 16-byte boundary (rows 1.. of a batch whose
    row is 2,097,160 bytes, or a ring one token into a larger buffer)
    ranks in place, bit-equal to _wyllie_dist, with one launch."""
    _needs_card()
    from loro_tpu_torch.ops import fugue_batch as fb

    s = _sparse_rows("erts", 524_290, "cuda")
    if offset == "rows":
        view = s[1:]
    else:
        buf = torch.empty(s.numel() + 1, dtype=torch.int32, device="cuda")
        buf[1:] = s.flatten()
        view = buf[1:].view(s.shape)
    assert view.is_contiguous() and view.data_ptr() % 16
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = dict(lr.LAUNCHES)
    got = lr.sparse_rank(view)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in lr.LAUNCHES.items() if v != before[k]} == {"sparse/global": 1}
    # dist and the scratch tables take 24.5 bytes a token; a copy of the
    # ring would add 4 more
    assert torch.cuda.max_memory_allocated() - base < 26 * view.numel()
    assert torch.equal(got, fb._wyllie_dist(view))


@pytest.mark.cuda
def test_sparse_rank_syncs_nothing_on_card():
    """The over-cap rank, alone and through the automatic route of
    _rank_dist, makes no host sync."""
    _needs_card()
    from loro_tpu_torch.ops import fugue_batch as fb

    s = _sparse_rows("erts", 524_290, "cuda")
    want = fb._wyllie_dist(s)
    lr.sparse_rank(s)  # builds and loads the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = lr.sparse_rank(s)
        auto = fb._rank_dist(s, *fb._resolve_rank_spec(None, s.device, s.shape[1]))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got, want) and torch.equal(auto, want)


@pytest.mark.cuda
def test_over_cap_merge_takes_the_sparse_kernel_on_card():
    """The over-cap doc merges on the card through cuda:sparse: one sparse
    launch, the route counted once, the text the oracle's."""
    _needs_card()
    from loro_tpu_torch import entry
    from loro_tpu_torch.ops import columnar as pcol
    from loro_tpu_torch.ops import fugue_batch as fb

    n_el, n = 40_000, 65_536
    ex = entry.example_cols(d=1, n=n_el)
    cols = fb.SeqColumns(*[pcol.pad_rows(a[0], n, f) for a, f in zip(ex, (-1, 0, 0, 0, True, -1, False))])
    before, routes = dict(lr.LAUNCHES), fb.RANK_ROUTES["cuda:sparse/over_cap"]
    codes, counts = fb.merge_docs(fb.seq_columns_to_torch(cols, device="cuda"), device="cuda")
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in lr.LAUNCHES.items() if v != before[k]} == {"sparse/global": 1}
    assert fb.RANK_ROUTES["cuda:sparse/over_cap"] == routes + 1
    want = "".join(chr(97 + i % 26) for i in range(n_el) if i % 7 != 6)
    assert "".join(map(chr, codes[0][: int(counts[0])].tolist())) == want
