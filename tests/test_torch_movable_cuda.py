"""The one-shot MovableList merge on the card (its order solve launches
the CUDA list-rank kernels), against the same calls on the CPU and
tracegen's oracle.

Imports torch, numpy, pytest and loro_tpu_torch only, so it runs on a
machine without jax:
    python -m pytest -q -m cuda --noconftest tests/test_torch_movable_cuda.py
Every test is marked `cuda` and skips without a card.  Tolerance: none;
value indexes and counts are integers.
"""
import numpy as np
import pytest
import torch

from loro_tpu_torch import tracegen
from loro_tpu_torch.ops import fugue_batch as fb
from loro_tpu_torch.ops import list_rank as lr
from loro_tpu_torch.ops import movable_batch as mb
from loro_tpu_torch.parallel.fleet import Fleet


def _needs_card() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card")


def _bench_cols(rng, d: int, s: int):
    """bench_movable's columns (a spine of s / 2 creations, then moves of
    random elements under random slots), with a tenth of the slots
    tombstoned and lamport ties among the moves."""
    n = s // 2
    tile = lambda a: np.broadcast_to(a, (d,) + a.shape).copy()  # noqa: E731
    seq = fb.SeqColumns(
        parent=tile(np.concatenate([np.arange(-1, n - 1), rng.integers(0, n, s - n)]).astype(np.int32)),
        side=np.ones((d, s), np.int32), peer=rng.integers(0, 3, (d, s)).astype(np.int32),
        counter=tile(np.arange(s, dtype=np.int32)), deleted=rng.random((d, s)) < 0.1,
        content=tile(np.concatenate([np.arange(n), rng.integers(0, n, s - n)]).astype(np.int32)),
        valid=np.ones((d, s), bool),
    )
    lam = tile(np.concatenate([np.arange(n), rng.integers(n, n + 4, s - n)]).astype(np.int32))
    return mb.MovableCols(seq, lam, tile(np.arange(n, dtype=np.int32)), rng.integers(0, 3, (d, n)).astype(np.int32),
                          rng.integers(0, 3, (d, n)).astype(np.int32), tile(np.arange(n, dtype=np.int32)),
                          np.ones((d, n), bool)), n


@pytest.mark.cuda
@pytest.mark.parametrize("d,s", [(5, 512), (3, 8192)])
def test_movable_merge_batch_on_card_matches_cpu(d, s):
    """One list-rank launch (the ruling kernel), outputs equal to the CPU's."""
    _needs_card()
    cols, n = _bench_cols(np.random.default_rng(s), d, s)
    want = mb.movable_merge_batch(cols, n, device="cpu")
    before = dict(lr.LAUNCHES)
    got = mb.movable_merge_batch(cols, n, device="cuda")
    torch.cuda.synchronize()
    ran = {k: v - before[k] for k, v in lr.LAUNCHES.items() if v != before[k]}
    assert sum(ran.values()) == 1 and list(ran)[0].startswith("ruling/")
    for g, w in zip(got, want):
        assert g.is_cuda and g.dtype == w.dtype and torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_movable_by_key_batch_on_card_matches_cpu():
    _needs_card()
    rng = np.random.default_rng(2)
    d, s, e = 3, 300, 120
    keys = np.stack([rng.permutation(s) for _ in range(d)]).astype(np.uint32)
    args = (rng.random((d, s)) < 0.9, rng.random((d, s)) < 0.2, keys | np.uint32(1 << 31), keys,
            rng.integers(0, s, (d, e)).astype(np.int32),
            np.where(rng.random((d, e)) < 0.1, mb.NEG, 5).astype(np.int32), rng.integers(0, 80, (d, e)).astype(np.int32))
    want = mb.movable_by_key_batch(*args, device="cpu")
    got = mb.movable_by_key_batch(*args, device="cuda")
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_fleet_movable_merges_on_card():
    """merge_movable_payloads and merge_movable_changes on the card against
    the oracle."""
    _needs_card()
    docs = [tracegen.movable_doc(s, n_elems=400, n_moves=200, n_sets=100, n_deletes=50, sync_every=100)
            for s in range(3)]
    want = [tracegen.oracle_movable(d) for d in docs]
    fl = Fleet(device="cuda")
    assert fl.merge_movable_payloads([tracegen.movable_payload(d) for d in docs], tracegen.MOVABLE_CID) == want
    assert fl.merge_movable_changes([d.changes for d in docs], tracegen.MOVABLE_CID) == want
