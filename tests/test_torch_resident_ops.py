"""The resident text path's device ops in the port
(fugue_batch.chain_contract_materialize_u, chain_merge_docs_u,
materialize_by_key) against the JAX package on the CPU.

Inputs: SeqColumnsU of seeded tracegen documents (tracegen.seq_columns_u)
with rows in apply order, in (peer, counter) order and shuffled, at a
chain budget that fits and at one below the chain count; standing keys
from a rank solve (key_hi >= 2^31) and keys spread over the whole uint32
range.  Every comparison is exact (tolerance: none).
"""
import numpy as np
import pytest
import torch

from loro_tpu.ops import fugue_batch as jfb
from loro_tpu_torch import tracegen
from loro_tpu_torch.errors import ConfigError
from loro_tpu_torch.ops import fugue_batch as pfb

N = 4096


def _stack(cols):
    return pfb.SeqColumnsU(*[np.stack([getattr(c, f) for c in cols]) for f in pfb.SeqColumnsU._fields])


def _shuffled(u: pfb.SeqColumnsU, seed: int) -> pfb.SeqColumnsU:
    """The same table with its rows in a random order, parents remapped."""
    perm = np.random.default_rng(seed).permutation(u.parent.shape[0])
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0])
    parent = u.parent[perm].astype(np.int64)
    parent = np.where(parent >= 0, inv[np.maximum(parent, 0)], -1).astype(np.int32)
    return pfb.SeqColumnsU(parent, *[getattr(u, f)[perm] for f in pfb.SeqColumnsU._fields[1:]])


@pytest.fixture(scope="module")
def docs():
    return tracegen.fleet_docs(2, n_patches=3000, seed=6, use_cache=False)


def _batch(docs, order: str) -> pfb.SeqColumnsU:
    if order == "shuffled":
        return _stack([_shuffled(tracegen.seq_columns_u(d, "apply", pad_to=N), 10 + i) for i, d in enumerate(docs)])
    return _stack([tracegen.seq_columns_u(d, order, pad_to=N) for d in docs])


def _jax(np_cols):
    return jfb.SeqColumnsU(*[np.asarray(a) for a in np_cols])


@pytest.mark.parametrize("order", ["apply", "peer", "shuffled"])
def test_chain_merge_docs_u_matches_jax(docs, order):
    """codes, counts and n_chains bit for bit at a budget that fits; at
    one below the chain count only n_chains is compared (the codes are
    garbage by contract) and nothing raises."""
    np_cols = _batch(docs, order)
    cols = pfb.seq_columns_to_torch(np_cols, device="cpu")
    jcodes, jcounts, jn = (np.asarray(a) for a in jfb.chain_merge_docs_u(_jax(np_cols), N))
    codes, counts, n_chains = pfb.chain_merge_docs_u(cols, N, device="cpu")
    assert codes.dtype == counts.dtype == n_chains.dtype == torch.int32
    assert np.array_equal(n_chains.numpy(), jn)
    assert np.array_equal(codes.numpy(), jcodes) and np.array_equal(counts.numpy(), jcounts)
    for i, d in enumerate(docs):
        assert "".join(map(chr, codes[i, : int(counts[i])].tolist())) == d.text
    tight = int(jn.min()) // 2
    _, _, jn_tight = jfb.chain_merge_docs_u(_jax(np_cols), tight)
    _, _, n_tight = pfb.chain_merge_docs_u(cols, tight, device="cpu")
    assert np.array_equal(n_tight.numpy(), np.asarray(jn_tight)) and np.array_equal(n_tight.numpy(), jn)


def test_chain_merge_docs_u_chain_counts_and_budget(docs):
    """(peer, counter) order gives the host contraction's chain counts,
    shuffled rows link no more rows than apply order does, and a budget
    below 1 is refused."""
    from loro_tpu_torch.ops import columnar

    host = [columnar.contract_chains(d.extract).n_chains for d in docs]
    counts = {}
    for order in ("apply", "peer", "shuffled"):
        cols = pfb.seq_columns_to_torch(_batch(docs, order), device="cpu")
        counts[order] = pfb.chain_merge_docs_u(cols, N, device="cpu")[2].tolist()
    assert counts["peer"] == host
    assert all(s >= a for s, a in zip(counts["shuffled"], counts["apply"]))
    with pytest.raises(ConfigError):
        pfb.chain_merge_docs_u(pfb.seq_columns_to_torch(_batch(docs, "apply"), device="cpu"), 0, device="cpu")


def _rank_keys(np_cols):
    """Standing keys from a rank solve: key_hi = 2^31 + (rank >> 10),
    key_lo = rank & 0x3FF, so every key_hi is 2^31 or above and
    (hi, lo) order is rank order."""
    rank = pfb.fugue_order_u(pfb.seq_columns_to_torch(np_cols, device="cpu"), device="cpu").numpy().astype(np.int64)
    return (0x80000000 + (rank >> 10)).astype(np.uint32), (rank & 0x3FF).astype(np.uint32)


def _spread_keys(np_cols, seed: int):
    """Keys over the whole uint32 range in each doc's rank order: sorted
    distinct random u64 values handed out by rank; invalid rows get
    random keys (they are masked)."""
    rank = pfb.fugue_order_u(pfb.seq_columns_to_torch(np_cols, device="cpu"), device="cpu").numpy()
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, 2**32, rank.shape, dtype=np.uint64)
    lo = rng.integers(0, 2**32, rank.shape, dtype=np.uint64)
    for i in range(rank.shape[0]):
        rows = np.flatnonzero(np_cols.valid[i])
        v = np.unique(rng.integers(0, 2**64 - 1, rows.shape[0] + 64, dtype=np.uint64))
        v = v[np.sort(rng.choice(v.shape[0], rows.shape[0], replace=False))]
        rows = rows[np.argsort(rank[i, rows], kind="stable")]
        hi[i, rows] = v >> np.uint64(32)
        lo[i, rows] = v & np.uint64(0xFFFFFFFF)
    return hi.astype(np.uint32), lo.astype(np.uint32)


@pytest.mark.parametrize("keys", ["rank_split", "spread"])
def test_materialize_by_key_matches_jax(docs, keys):
    np_cols = _batch(docs, "shuffled")
    hi, lo = _rank_keys(np_cols) if keys == "rank_split" else _spread_keys(np_cols, 3)
    valid = np_cols.valid
    if keys == "rank_split":
        assert (hi[valid] >= 2**31).all()
    else:
        assert hi[valid].min() < 2**28 and hi[valid].max() > 2**32 - 2**28
    jcodes, jcounts = (np.asarray(a) for a in jfb.materialize_by_key(_jax(np_cols), hi, lo))
    cols = pfb.seq_columns_to_torch(np_cols, device="cpu")
    codes, counts = pfb.materialize_by_key(cols, hi, lo, device="cpu")
    assert codes.dtype == counts.dtype == torch.int32
    assert np.array_equal(codes.numpy(), jcodes) and np.array_equal(counts.numpy(), jcounts)
    for i, d in enumerate(docs):
        assert "".join(map(chr, codes[i, : int(counts[i])].tolist())) == d.text
    # the same keys as tensors holding the uint32 values
    t_codes, t_counts = pfb.materialize_by_key(
        cols, torch.from_numpy(hi.astype(np.int64)), torch.from_numpy(lo.astype(np.int64)), device="cpu")
    assert torch.equal(t_codes, codes) and torch.equal(t_counts, counts)
    with pytest.raises(ValueError):
        pfb.materialize_by_key(cols, hi[:, :-1], lo[:, :-1], device="cpu")
