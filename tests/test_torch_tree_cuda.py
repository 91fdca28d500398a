"""The movable-tree replay kernel (csrc/tree_replay.cu) on the card,
against its plain torch version on the same CUDA tensors, and the tree
paths (Fleet.merge_tree_*, DeviceTreeBatch) on the card against the same
calls on the CPU.

Imports torch, numpy, pytest and loro_tpu_torch only, so it runs on a
machine without jax:
    python -m pytest -q -m cuda --noconftest tests/test_torch_tree_cuda.py
Every test is marked `cuda` and skips without a card.  Tolerance: none;
parents and effected are integers, held bit for bit.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

from loro_tpu_torch import tracegen
from loro_tpu_torch.ops import tree_batch as tb
from loro_tpu_torch.parallel.fleet import DeviceTreeBatch, Fleet


def _needs_card() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card")


def _cols(rng, d: int, m: int, n: int, valid_frac: float = 0.9):
    """The JAX bench's columns (targets in [0, n), parents in [-2, n)),
    some rows invalid."""
    target = torch.from_numpy(rng.integers(0, n, (d, m)).astype(np.int32))
    parent = torch.from_numpy(rng.integers(-2, n, (d, m)).astype(np.int32))
    valid = torch.from_numpy(rng.random((d, m)) < valid_frac)
    return target, parent, valid


def _chains(d: int, depth: int, m: int):
    """Per doc a chain of `depth` nodes built root-down, then moves of the
    chain's head under nodes ever deeper in it (each a cycle the walk
    must climb the whole way to find) and under the root."""
    target = np.zeros((d, m), np.int32)
    parent = np.full((d, m), tb.ROOT, np.int32)
    k = 0
    for i in range(depth):
        target[:, k], parent[:, k] = i, i - 1
        k += 1
    while k < m:
        target[:, k] = 0
        parent[:, k] = (k * 7) % depth if k % 5 else tb.ROOT
        k += 1
    return torch.from_numpy(target), torch.from_numpy(parent), torch.ones((d, m), dtype=torch.bool)


def _check(cols, n: int, d_max=None, order=None):
    """The kernel in both table variants (and by the automatic route of
    tree_merge_batch) against replay_plain on the same columns."""
    want = tb.replay_plain(*cols, n, d_max, order=order)[:2]
    dev = [c.cuda() for c in cols]
    runs = [(v, lambda v=v: tb.launch_kernel(*dev, n, d_max, order=None if order is None else order.cuda(), variant=v))
            for v in tb.VARIANTS]
    if order is None:
        runs.append((tb.plan_variant(n)[0], lambda: tb.tree_merge_batch(tb.TreeOpCols(*dev), n, d_max)))
    for v, run in runs:
        before = dict(tb.LAUNCHES)
        got = run()
        torch.cuda.synchronize()
        assert tb.LAUNCHES[v] == before[v] + 1
        for g, w in zip(got, want):
            assert g.is_cuda and g.dtype == w.dtype and torch.equal(g.cpu(), w), (v, d_max)
    return want


def _check_at(cols, n: int, g: int, d_max=None, order=None):
    """The kernel at `g` docs a warp (launch_plan), both table variants,
    against replay_plain on the same columns; each launch counted once
    under its variant."""
    want = tb.replay_plain(*cols, n, d_max, order=order)[:2]
    dev = [c.cuda() for c in cols]
    for v in tb.VARIANTS:
        plan = replace(tb.plan_replay(dev[0].shape[0], n, tb.sm_count("cuda"), v), docs_per_warp=g)
        if plan.smem_bytes > tb.SMEM_LIMIT:
            continue
        before = dict(tb.LAUNCHES)
        got = tb.launch_plan(*dev, n, plan, d_max, None if order is None else order.cuda())
        torch.cuda.synchronize()
        assert tb.LAUNCHES[v] == before[v] + 1 and sum(tb.LAUNCHES.values()) == sum(before.values()) + 1
        for x, w in zip(got, want):
            assert x.is_cuda and x.dtype == w.dtype and torch.equal(x.cpu(), w), (v, g, d_max)
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("g", tb.DOCS_PER_WARP)
@pytest.mark.parametrize("permuted", [False, True])
def test_kernel_every_docs_a_warp(g, permuted):
    """Each layout plan_replay can choose: 70 docs (not a multiple of any
    docs a warp past 2), 75 moves (past two tiles, not a multiple of
    one), invalid rows between valid ones, sorted and permutation forms."""
    _needs_card()
    rng = np.random.default_rng(100 + g)
    d, m, n = 70, 75, 40
    order = torch.from_numpy(np.argsort(rng.random((d, m)), axis=1).astype(np.int32)) if permuted else None
    _check_at(_cols(rng, d, m, n, valid_frac=0.7), n, g, order=order)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [0, 1, 5, 16, 31, 32, 33, 100])
@pytest.mark.parametrize("g", [1, 4, 32])
def test_kernel_logs_shorter_and_longer_than_a_tile(m, g):
    """M = 0, M < 32, M on and off a tile (32 moves a doc, 16 at 32 docs
    a warp), in the permutation form."""
    _needs_card()
    rng = np.random.default_rng(7 * m + g)
    d, n = 41, 30
    order = torch.from_numpy(np.argsort(rng.random((d, m)), axis=1).astype(np.int32))
    _check_at(_cols(rng, d, m, n), n, g, order=order)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 8, 32])
def test_kernel_all_invalid_and_interleaved_rows(g):
    """A log of invalid rows only (nothing written, nothing effected), and
    one whose rows alternate valid and invalid, at a layout's docs a warp."""
    _needs_card()
    rng = np.random.default_rng(3 + g)
    target, parent, _ = _cols(rng, 40, 96, 30)
    parents, eff = _check_at((target, parent, torch.zeros_like(target, dtype=torch.bool)), 30, g)
    assert bool((parents == tb.ABSENT).all()) and not bool(eff.any())
    alt = torch.from_numpy(np.tile(np.arange(96) % 2 == 0, (40, 1)))
    _check_at((target, parent, alt), 30, g)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 2, 16, 32])
@pytest.mark.parametrize("d_max", [None, 1, 3, 40])
def test_kernel_deep_chains_at_every_layout(g, d_max):
    """Chains deeper than a tile walked by lanes that share a warp, with a
    small d_max (unsound, but the same on both) and with none."""
    _needs_card()
    _check_at(_chains(37, 90, 200), 90, g, d_max)


@pytest.mark.cuda
def test_kernel_out_of_range_ordinals_at_every_layout():
    """Targets and parents past n and below TRASH (JAX's clip, kept),
    written into the table and walked through, at each docs a warp."""
    _needs_card()
    rng = np.random.default_rng(5)
    d, m, n = 45, 120, 20
    target = torch.from_numpy(rng.integers(-5, n + 5, (d, m)).astype(np.int32))
    parent = torch.from_numpy(rng.integers(-5, n + 5, (d, m)).astype(np.int32))
    valid = torch.from_numpy(rng.random((d, m)) < 0.9)
    for g in tb.DOCS_PER_WARP:
        _check_at((target, parent, valid), n, g)
        _check_at((target, parent, valid), n, g, d_max=2)


@pytest.mark.cuda
@pytest.mark.parametrize("d,m,n", [(37, 200, 50), (1, 0, 1), (5, 64, 1), (33, 17, 3)])
def test_kernel_matches_plain_on_random_columns(d, m, n):
    """D not a multiple of 32, n = 1, M = 0, both table variants."""
    _needs_card()
    _check(_cols(np.random.default_rng(d * 1000 + m), d, m, n), n)


@pytest.mark.cuda
def test_kernel_all_invalid_rows():
    _needs_card()
    target, parent, _ = _cols(np.random.default_rng(1), 40, 96, 30)
    parents, eff = _check((target, parent, torch.zeros_like(target, dtype=torch.bool)), 30)
    assert bool((parents == tb.ABSENT).all()) and not bool(eff.any())


@pytest.mark.cuda
@pytest.mark.parametrize("d_max", [None, 1, 2, 7, 40])
def test_kernel_deep_chains_and_small_d_max(d_max):
    """Chains of 100 nodes (deeper than a warp's 32 lanes) whose head is
    moved under its own descendants: the full walk rejects every such
    move, a small d_max lets some through (unsound, but the same on both)."""
    _needs_card()
    parents, eff = _check(_chains(45, 100, 300), 100, d_max)
    if d_max is None:
        assert not bool(eff[:, 100:][(torch.arange(100, 300) % 5 != 0).expand(45, -1)].any())


@pytest.mark.cuda
def test_kernel_permutation_form():
    """tree_replay_log_batch's form: the kernel reads the rows in the
    sort's order and writes effected back by row."""
    _needs_card()
    rng = np.random.default_rng(9)
    d, m, n = 70, 160, 40
    target, parent, valid = _cols(rng, d, m, n)
    _check((target, parent, valid), n, order=torch.from_numpy(np.argsort(rng.random((d, m)), axis=1).astype(np.int32)))
    lam = torch.from_numpy(rng.integers(0, 5, (d, m)).astype(np.int32))
    hi = torch.from_numpy(rng.choice(np.array([0, 2**31 + 3, 2**32 - 1], np.int64), (d, m)))
    lo = torch.from_numpy(rng.choice(np.array([1, 2**31], np.int64), (d, m)))
    ctr = torch.from_numpy(rng.integers(0, 3, (d, m)).astype(np.int32))
    log = tb.TreeLogCols(lam, hi, lo, ctr, target, parent, valid)
    want = tb.tree_replay_log_batch(log, n)
    got = tb.tree_replay_log_batch(tb.TreeLogCols(*(c.cuda() for c in log)), n)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("permuted", [False, True])
def test_kernel_fewer_docs_a_cta(permuted):
    """n = 2,048 (the resident depth cell's node cap): the tables of only
    16 docs (a power of two) and their move tile fit a CTA's shared
    memory, so at 16 docs a warp 61 docs take four CTAs of 16, 16, 16
    and 13; chains deeper than a warp, plain and permutation forms, by
    the automatic route and at 16 docs a warp."""
    _needs_card()
    d, m, n = 61, 260, 2048
    assert tb.plan_variant(n) == ("smem", 16)
    target, parent, valid = _chains(d, 120, m)
    rng = np.random.default_rng(11)
    target[:, 200:] = torch.from_numpy(rng.integers(0, n, (d, m - 200)).astype(np.int32))
    parent[:, 200:] = torch.from_numpy(rng.integers(-2, 120, (d, m - 200)).astype(np.int32))
    order = torch.from_numpy(np.argsort(rng.random((d, m)), axis=1).astype(np.int32)) if permuted else None
    _check((target, parent, valid), n, order=order)
    _check_at((target, parent, valid), n, 16, order=order)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take():
    _needs_card()
    t, p, v = (c.cuda() for c in _cols(np.random.default_rng(2), 4, 8, 5))
    with pytest.raises(TypeError):
        tb.launch_kernel(t.long(), p, v, 5)
    with pytest.raises(ValueError):
        tb.launch_kernel(t[:, ::2], p[:, ::2], v[:, ::2], 5)
    with pytest.raises(ValueError):
        tb.launch_kernel(t, p, v, 0)
    with pytest.raises(ValueError):
        tb.launch_kernel(t, p, v, 70_000, variant="smem")
    assert tb.plan_variant(70_000) == ("global", tb.MAX_DOCS_PER_WARP) and tb.plan_variant(512) == ("smem", 32)
    assert tb.plan_variant(4000)[1] == 8
    plan = tb.plan_replay(4, 5, tb.sm_count("cuda"))
    with pytest.raises(ValueError):
        tb.launch_plan(t, p, v, 5, replace(plan, docs_per_warp=3))
    with pytest.raises(ValueError):
        tb.launch_plan(t, p, v, 6, plan)
    with pytest.raises(ValueError):
        tb.launch_plan(t, p, v, 60_000, replace(tb.plan_replay(4, 60_000, 132), variant="smem"))


@pytest.mark.cuda
def test_tree_paths_on_card_match_cpu():
    """merge_tree_payloads / merge_tree_children and a DeviceTreeBatch fed
    one epoch a round (it grows), on the card and on the CPU, against the
    oracle and each other's checkpoint bytes."""
    _needs_card()
    docs = [tracegen.tree_doc(s, n_moves=600, n_nodes=150, sync_every=150) for s in range(3)]
    cid = tracegen.TREE_CID
    want = [tracegen.oracle_tree(d) for d in docs]
    fl = Fleet(device="cuda")
    assert fl.merge_tree_payloads([tracegen.tree_payload(d) for d in docs], cid) == [w[0] for w in want]
    assert fl.merge_tree_children([d.changes for d in docs], cid) == [w[1] for w in want]
    eps = [tracegen.tree_epoch_payloads(d) for d in docs]
    gb = DeviceTreeBatch(3, 64, 16, device="cuda", auto_grow=True)
    cb = DeviceTreeBatch(3, 64, 16, device="cpu", auto_grow=True)
    for e in range(docs[0].n_epochs):
        for b in (gb, cb):
            b.append_payloads([ep[e] for ep in eps], cid)
        assert gb.export_state() == cb.export_state()
        pre = [tracegen.oracle_tree(d, e + 1) for d in docs]
        assert gb.parent_maps() == [w[0] for w in pre] and gb.children_maps() == [w[1] for w in pre]
    assert DeviceTreeBatch.import_state(gb.export_state(), device="cuda").export_state() == cb.export_state()
