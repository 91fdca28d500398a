"""The port's run-coalesced rank (ring_run_heads, _coalesced_dist, the
torch:coalesced / cuda:coalesced specs), the ring_budget parameter of
its chain entry points, and its host ring statistics (ops/rank_model),
against the JAX package on the CPU.

On the CPU, cuda:coalesced's kernel call takes the kernel's plain
version (list_rank.wyllie_rank on a CPU tensor), which is held here
against the JAX package's pallas:coalesced in interpret mode (rings of
at most 4,096 tokens).  Every comparison is exact (tolerance: none).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from loro_tpu.ops import fugue_batch as jfb
from loro_tpu.ops import rank_model as jrm
from loro_tpu_torch import tracegen
from loro_tpu_torch.ops import columnar as pcol
from loro_tpu_torch.ops import fugue_batch as pfb
from loro_tpu_torch.ops import list_rank
from loro_tpu_torch.ops import rank_model as prm


def _random_ring(rng, m):
    """A ring over a random live subset; other tokens self-loop."""
    live = rng.choice(m, size=rng.integers(min(2, m), m + 1), replace=False)
    p = rng.permutation(live).astype(np.int32)
    succ = np.arange(m, dtype=np.int32)
    succ[p[:-1]] = p[1:]
    return succ


def _in_tree(rng, m):
    """A random recursive tree: many tokens share a successor."""
    perm = rng.permutation(m).astype(np.int32)
    succ = np.empty(m, np.int32)
    succ[perm] = perm[(rng.random(m) * np.arange(m)).astype(np.int64)]
    return succ


def _runs_ring(rng, m, run_len):
    """One chain over index-consecutive runs in shuffled run order."""
    starts = np.arange(0, m, run_len)
    order = rng.permutation(len(starts))
    ends = np.minimum(starts + run_len, m) - 1
    succ = np.arange(1, m + 1, dtype=np.int32)
    succ[ends[order[:-1]]] = starts[order[1:]]
    succ[ends[order[-1]]] = ends[order[-1]]
    return succ


_heads = jax.jit(jax.vmap(jfb.ring_run_heads))
_wyllie = jax.jit(jax.vmap(jfb._wyllie_dist))


def _jax_coalesced(batch: np.ndarray, r_pad, use_pallas: bool = False) -> np.ndarray:
    fn = jax.jit(jax.vmap(lambda x: jfb._coalesced_dist(x, r_pad, use_pallas=use_pallas)))
    return np.asarray(fn(jnp.asarray(batch)))


@pytest.fixture(scope="module")
def chain_batch():
    """(numpy ChainColumns [3, ...], texts) of tracegen docs whose chain
    rings stay within 4,096 tokens."""
    docs = tracegen.fleet_docs(2, n_patches=2500, seed=13, use_cache=False)
    pad_n = max(d.extract.n for d in docs) + 5
    pad_c = max(pcol.contract_chains(d.extract).n_chains for d in docs) + 3
    assert 2 * (pad_c + 1) <= 4096
    cols = pcol.stack_docs([pcol.chain_columns(d.extract, pad_n=pad_n, pad_c=pad_c) for d in docs])
    return cols, [d.text for d in docs]


def _rings(kind, m, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return [_random_ring(rng, m) for _ in range(3)]
    if kind == "in-tree":
        return [_in_tree(rng, m) for _ in range(3)]
    return [_runs_ring(rng, m, L) for L in (1, 7, 64)]


_RING_CASES = [(k, m) for k in ("random", "in-tree", "runs") for m in (1, 5, 130, 1000, 4096)]


@pytest.mark.parametrize("kind,m", _RING_CASES, ids=[f"{k}-{m}" for k, m in _RING_CASES])
def test_ring_run_heads_and_coalesced_dist_match_jax(kind, m):
    rings = np.stack(_rings(kind, m, m))
    batch = torch.from_numpy(rings)
    heads, n_runs = pfb.ring_run_heads(batch)
    assert heads.dtype == torch.bool and n_runs.dtype == torch.int32
    jh, jn = _heads(jnp.asarray(rings))
    np.testing.assert_array_equal(heads.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(n_runs.numpy(), np.asarray(jn))
    wyllie = np.asarray(_wyllie(jnp.asarray(rings)))
    for r_pad in (None, prm.coalesce_budget(int(n_runs.max()), slack=0)):
        got = pfb._coalesced_dist(batch, r_pad)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), _jax_coalesced(rings, r_pad), err_msg=f"r_pad={r_pad}")
        np.testing.assert_array_equal(got.numpy(), wyllie)


@pytest.mark.parametrize("kind", ["random", "runs"])
def test_kernel_route_matches_pallas_coalesced(kind):
    """cuda:coalesced's kernel call, on a CPU tensor its plain version,
    against pallas:coalesced (interpret mode), at the default and a
    tight budget."""
    rings = np.stack(_rings(kind, 2000, 7))
    batch = torch.from_numpy(rings)
    tight = prm.coalesce_budget(int(pfb.ring_run_heads(batch)[1].max()))
    for r_pad in (None, tight):
        got = pfb._coalesced_dist(batch, r_pad, use_kernel=True)
        np.testing.assert_array_equal(got.numpy(), _jax_coalesced(rings, r_pad, True), err_msg=f"r_pad={r_pad}")


def test_chain_rings_coalesce_like_jax(chain_batch):
    cols, _ = chain_batch
    t = pfb.chain_columns_to_torch(cols, device="cpu")
    succ, _ = pfb._ring_and_anchors(t.c_parent, t.c_side, t.c_valid)
    _, n_runs = pfb.ring_run_heads(succ)
    for r_pad in (None, prm.coalesce_budget(int(n_runs.max()), slack=0)):
        got = pfb._coalesced_dist(succ, r_pad)
        np.testing.assert_array_equal(got.numpy(), _jax_coalesced(succ.numpy(), r_pad))


@pytest.mark.parametrize("budget", [None, "tight"])
def test_chain_merge_coalesced_matches_jax(chain_batch, budget):
    """torch:coalesced and cuda:coalesced's plain route against JAX's
    xla:coalesced and pallas:coalesced, through the chain entry points
    with ring_budget as their third argument."""
    cols, texts = chain_batch
    t = pfb.chain_columns_to_torch(cols, device="cpu")
    jc = jfb.ChainColumns(*[jnp.asarray(a) for a in cols])
    if budget == "tight":
        stats = [prm.ring_stats(prm.build_ring(*[getattr(cols, f)[i] for f in ("c_parent", "c_side", "c_valid")]))
                 for i in range(cols.c_parent.shape[0])]
        budget = prm.coalesce_budget(max(s["n_runs"] for s in stats))
    cs, n = pfb.chain_merge_docs_checksum_v(t, "torch:coalesced", budget, device="cpu")
    for spec in ("xla:coalesced", "pallas:coalesced"):
        jcs, jn = jfb.chain_merge_docs_checksum_v(jc, spec, budget)
        np.testing.assert_array_equal(cs.numpy(), np.asarray(jcs).astype(np.int64), err_msg=spec)
        np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    codes, counts = pfb.chain_merge_docs_v(t, "torch:coalesced", budget, device="cpu")
    jcodes, jcounts = jfb.chain_merge_docs_v(jc, "xla:coalesced", budget)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    rk = pfb.chain_rank_checksum_v(t, "torch:coalesced", budget, device="cpu")
    jrk = jfb.chain_rank_checksum_v(jc, "pallas:coalesced", budget)
    np.testing.assert_array_equal(rk.numpy(), np.asarray(jrk).astype(np.int64))
    # cuda:coalesced's kernel call, on CPU tensors its plain version
    crank = pfb._order_core(t.c_parent, t.c_side, t.c_valid, ring_budget=budget, rank_impl="torch:coalesced")
    succ, anchor = pfb._ring_and_anchors(t.c_parent, t.c_side, t.c_valid)
    dist = pfb._coalesced_dist(succ, budget, use_kernel=True)
    ad = dist.gather(1, anchor.long())
    nc = t.c_parent.shape[1]
    np.testing.assert_array_equal(torch.where(t.c_valid, ad[:, nc:] - ad[:, :nc], pfb.BIG).numpy(), crank.numpy())
    for i, want in enumerate(texts):
        assert "".join(map(chr, codes[i][: int(counts[i])].tolist())) == want


def test_ring_budget_is_the_third_positional_parameter(chain_batch):
    """The same positional call in both packages: (cols, None, budget)
    is the default rank with the budget ignored."""
    cols, _ = chain_batch
    t = pfb.chain_columns_to_torch(cols, device="cpu")
    jc = jfb.ChainColumns(*[jnp.asarray(a) for a in cols])
    cs, n = pfb.chain_merge_docs_checksum_v(t, None, 512, device="cpu")
    jcs, jn = jfb.chain_merge_docs_checksum_v(jc, None, 512)
    np.testing.assert_array_equal(cs.numpy(), np.asarray(jcs).astype(np.int64))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    codes, _ = pfb.chain_merge_docs_v(t, None, 512, device="cpu")
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jfb.chain_merge_docs_v(jc, None, 512)[0]))
    rk = pfb.chain_rank_checksum_v(t, None, 512, device="cpu")
    np.testing.assert_array_equal(rk.numpy(), np.asarray(jfb.chain_rank_checksum_v(jc, None, 512)).astype(np.int64))
    with pytest.raises(TypeError):
        pfb.chain_merge_docs_checksum_v(t, None, None, "sort", device="cpu")  # place is keyword-only
    scatter = pfb.chain_merge_docs_checksum_v(t, None, place="scatter", device="cpu")
    assert torch.equal(scatter[0], cs)


def test_over_cap_contracted_ring_takes_the_plain_ruling():
    """A contracted ring whose r + 1 tokens pad past RANK_MAX_M (the
    default budget at m = RANK_MAX_M) is ranked by the plain weighted
    ruling and counted, as the JAX package falls back past
    PALLAS_RANK_MAX_M."""
    m = list_rank.RANK_MAX_M
    succ = torch.from_numpy(_runs_ring(np.random.default_rng(3), m, 4096))[None]
    before = pfb.RANK_ROUTES["torch:coalesced/over_cap"]
    got = pfb._coalesced_dist(succ, None, use_kernel=True)
    assert pfb.RANK_ROUTES["torch:coalesced/over_cap"] == before + 1
    assert torch.equal(got, pfb._coalesced_dist(succ, None))
    assert torch.equal(got, pfb._wyllie_dist(succ))
    tight = pfb._coalesced_dist(succ, prm.coalesce_budget(int(pfb.ring_run_heads(succ)[1].max())), use_kernel=True)
    assert pfb.RANK_ROUTES["torch:coalesced/over_cap"] == before + 1
    assert torch.equal(tight, got)


@pytest.mark.parametrize("seed", range(3))
def test_host_ring_statistics_match_jax(chain_batch, seed):
    cols, _ = chain_batch
    for i in range(cols.c_parent.shape[0]):
        args = [getattr(cols, f)[i] for f in ("c_parent", "c_side", "c_valid")]
        ring = prm.build_ring(*args)
        np.testing.assert_array_equal(ring, jrm.build_ring(*args))
        t = pfb.chain_columns_to_torch(cols, device="cpu")
        dev_ring, _ = pfb._ring_and_anchors(t.c_parent, t.c_side, t.c_valid)
        np.testing.assert_array_equal(ring, dev_ring[i].numpy())
        np.testing.assert_array_equal(prm.run_heads(ring), jrm.run_heads(ring))
        assert prm.ring_stats(ring) == jrm.ring_stats(ring)
    rng = np.random.default_rng(seed)
    for kind in ("random", "in-tree", "runs"):
        for s in _rings(kind, 700, seed):
            np.testing.assert_array_equal(prm.run_heads(s), jrm.run_heads(s))
            assert prm.ring_stats(s) == jrm.ring_stats(s)
    # the row-order-free table's sibling keys
    n = 300
    parent = np.where(rng.random(n) < 0.2, -1, rng.integers(0, n, n)).astype(np.int32)
    parent = np.minimum(parent, np.arange(n) - 1).astype(np.int32)
    side, valid = rng.integers(0, 2, n).astype(np.int32), rng.random(n) < 0.9
    keys = tuple(rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32) for _ in range(3))
    np.testing.assert_array_equal(prm.build_ring(parent, side, valid, keys), jrm.build_ring(parent, side, valid, keys))
    for n_runs in (0, 1, 127, 128, 5000):
        for slack in (0, 128):
            assert prm.coalesce_budget(n_runs, slack) == jrm.coalesce_budget(n_runs, slack)
