"""The device mesh's op-axis sharding on the card: the sharded ring rank
against the CUDA Wyllie kernel, and the sharded LWW merge against
lww_merge_batch, on meshes that name the one card many times.

Imports torch, numpy, pytest and loro_tpu_torch only, so it runs on a
machine without jax:
    python -m pytest -q -m cuda --noconftest tests/test_torch_op_sharding_cuda.py
Every test is marked `cuda` and skips without a card.  Tolerance: exact.
"""
import numpy as np
import pytest
import torch

from loro_tpu_torch.ops import list_rank, lww
from loro_tpu_torch.ops.fugue_batch import make_ring_rank_sharded
from loro_tpu_torch.parallel.mesh import make_mesh


def _needs_card() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card")


def _rings(rng, d: int, m: int) -> np.ndarray:
    """d random rings of m tokens (a random subset linked, the rest
    self-loops); doc 0 one index run, whose shards phase A collapses."""
    out = np.tile(np.arange(m, dtype=np.int32), (d, 1))
    for i in range(1, d):
        live = rng.choice(m, size=int(rng.integers(2, m + 1)), replace=False)
        p = rng.permutation(live).astype(np.int32)
        out[i, p[:-1]] = p[1:]
    out[0] = np.minimum(np.arange(1, m + 1, dtype=np.int32), m - 1)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("op_parallel", [2, 4, 8])
def test_sharded_rank_on_card_matches_the_wyllie_kernel(op_parallel):
    _needs_card()
    mesh = make_mesh([torch.device("cuda", 0)] * 8, op_parallel=op_parallel)
    d, m = mesh.shape["docs"] * 2, 8192
    succ = torch.from_numpy(_rings(np.random.default_rng(op_parallel), d, m)).cuda()
    before = dict(list_rank.LAUNCHES)
    want = list_rank.wyllie_rank(succ, algo="wyllie", device="cuda")
    assert sum(list_rank.LAUNCHES.values()) == sum(before.values()) + 1
    for algo in ("wyllie", "blocked"):
        got = make_ring_rank_sharded(mesh, m, algo)(succ)
        assert got.is_cuda and got.dtype == torch.int32 and torch.equal(got, want), algo


@pytest.mark.cuda
@pytest.mark.parametrize("op_parallel", [1, 2, 4])
def test_lww_sharded_on_card_matches_lww_merge_batch(op_parallel):
    _needs_card()
    mesh = make_mesh([torch.device("cuda", 0)] * 4, op_parallel=op_parallel)
    rng = np.random.default_rng(11)
    d, m, s = 64, 4096, 300
    lam = rng.integers(0, 40, (d, m)).astype(np.int32)
    peer = rng.integers(0, 9, (d, m)).astype(np.int32)
    slot = rng.integers(0, s, (d, m)).astype(np.int32)
    # (slot, lamport, peer) unique a doc: duplicates turned into pads
    key = (slot.astype(np.int64) * 64 + lam) * 16 + peer
    valid = np.zeros((d, m), bool)
    for i in range(d):
        valid[i, np.unique(key[i], return_index=True)[1]] = True
    valid &= np.arange(m)[None, :] < rng.integers(m // 2, m + 1, (d, 1))
    cols = lww.MapOpCols(*(torch.from_numpy(a).cuda() for a in (slot, lam, peer,
                                                              rng.integers(-1, 10_000, (d, m)).astype(np.int32),
                                                              valid)))
    want = lww.lww_merge_batch(cols, s, device="cuda")
    got = lww.make_lww_sharded(mesh, s)(cols)
    for g, w in zip(got, want):
        assert g.is_cuda and torch.equal(g, w)
