"""The port's gather-count model (loro_tpu_torch.ops.rank_model:
gather_model, simulate and its _sim_* re-executions) and the rank.*
counters fugue_batch._tick_rank_obs feeds from it, against the JAX
package's on the CPU.

Inputs are seeded with numpy: random rings over a live subset, rings of
index-consecutive runs, the tiny and adversarial rings of
tests/test_rank_blocked.py, and the chain rings of tracegen docs built
by both packages' build_ring.  Every comparison is exact (tolerance:
none): the model's counts, the simulated distances and counts, and the
counter deltas per label, the backend part of the label mapped
(cuda <-> pallas, torch <-> xla).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loro_tpu.obs import metrics as jobs
from loro_tpu.ops import fugue_batch as jfb
from loro_tpu.ops import rank_model as jrm
from loro_tpu_torch import tracegen
from loro_tpu_torch.obs import metrics as pobs
from loro_tpu_torch.ops import columnar as pcol
from loro_tpu_torch.ops import fugue_batch as pfb
from loro_tpu_torch.ops import list_rank
from loro_tpu_torch.ops import rank_model as prm

ALGOS = ("wyllie", "ruling", "blocked", "coalesced")
BACKEND = {"cuda": "pallas", "torch": "xla"}


def _random_ring(rng, m):
    live = rng.choice(m, size=rng.integers(2, m + 1) if m > 1 else 1, replace=False)
    p = rng.permutation(live).astype(np.int32)
    succ = np.arange(m, dtype=np.int32)
    succ[p[:-1]] = p[1:]
    return succ


def _runs_ring(m, run_len, seed):
    rng = np.random.default_rng(seed)
    starts = np.arange(0, m, run_len)
    order = rng.permutation(len(starts))
    succ = np.arange(1, m + 1, dtype=np.int32)
    succ[-1] = m - 1
    for a, b in zip(order[:-1], order[1:]):
        succ[min(starts[a] + run_len, m) - 1] = starts[b]
    last = starts[order[-1]]
    succ[min(last + run_len, m) - 1] = min(last + run_len, m) - 1
    return succ


def _adversarial_ruling(m, k=8):
    """Every non-ruler before every ruler along the ring: ruling's phase 1
    runs to its round cap."""
    order = [i for i in range(m) if i % k] + [i for i in range(m) if i % k == 0]
    succ = np.arange(m, dtype=np.int32)
    for a, b in zip(order[:-1], order[1:]):
        succ[a] = b
    return succ


def _rings(kind, m, seed):
    if kind == "random":
        return _random_ring(np.random.default_rng(seed), m)
    if kind == "runs":
        return _runs_ring(m, 1 + seed % 9, seed)
    if kind == "chain":
        succ = np.arange(1, m + 1, dtype=np.int32)
        succ[-1] = m - 1
        return succ
    if kind == "reversed":
        return np.concatenate([[0], np.arange(m - 1)]).astype(np.int32)
    return _adversarial_ruling(m)


@pytest.mark.parametrize("algo", ALGOS)
def test_gather_model_matches_jax(algo):
    rng = np.random.default_rng(sum(map(ord, algo)))
    ms = [1, 2, 3, 127, 128, 129, 1000, 4096, 65536] + [int(x) for x in rng.integers(1, 200_000, 24)]
    for m in ms:
        for k in (2, 8, 32):
            for kw in ({}, {"block": 128}, {"block": 4096}, {"r_pad": 300}, {"r_pad": None}):
                assert prm.gather_model(m, algo, k=k, **kw) == jrm.gather_model(m, algo, k=k, **kw), (m, k, kw)
    with pytest.raises(ValueError):
        prm.gather_model(10, "nope")
    assert prm._log2ceil(1) == jrm._log2ceil(1) == 1


_CASES = [(k, m) for k in ("random", "runs", "chain", "reversed", "adversarial") for m in (1, 5, 257, 1000, 4097)]


@pytest.mark.parametrize("kind,m", _CASES, ids=[f"{k}-{m}" for k, m in _CASES])
def test_simulate_matches_jax_and_the_plain_rank(kind, m):
    """Equal distances and counts for every algo (and block, budget) on
    the same seeded ring; the distances also equal the port's plain
    Wyllie rank."""
    succ = _rings(kind, m, m)
    want = pfb._wyllie_dist(torch.from_numpy(succ)[None])[0].numpy()
    n_runs = int(prm.run_heads(succ).sum())
    for algo in ALGOS:
        for kw in ({}, {"block": 128}, {"r_pad": prm.coalesce_budget(n_runs, slack=0)}, {"k": 4}):
            if "r_pad" in kw and algo != "coalesced":
                continue
            pd, pc = prm.simulate(succ, algo, **kw)
            jd, jc = jrm.simulate(succ, algo, **kw)
            np.testing.assert_array_equal(pd, jd, err_msg=f"{algo} {kw}")
            assert pc == jc, (algo, kw)
            np.testing.assert_array_equal(pd, want, err_msg=f"{algo} {kw} vs the plain wyllie")


def test_simulate_refuses_a_budget_under_the_runs():
    succ = _rings("reversed", 512, 0)
    assert int(prm.run_heads(succ).sum()) == 512
    for rm in (prm, jrm):
        with pytest.raises(ValueError):
            rm.simulate(succ, "coalesced", r_pad=128)
        with pytest.raises(ValueError):
            rm.simulate(succ, "nope")


def test_model_caps_the_realized_counts():
    """gather_model bounds simulate: the blocked rank's global rows and
    exact local rows, the ruling rank at its round cap, and the coalesced
    rank's >= 2x cut of Wyllie's global rows on a runs ring."""
    for m, block in ((1024, 128), (4096, 1024), (5000, 1024)):
        _, counts = prm.simulate(_random_ring(np.random.default_rng(m), m), "blocked", block=block)
        cap = prm.gather_model(m, "blocked", block=block)
        assert counts["global_rows"] <= cap["global_rows"] and counts["local_rows"] == cap["local_rows"]
    for m in (1001, 2048, 4097):
        _, realized = prm.simulate(_adversarial_ruling(m), "ruling")
        assert realized["global_rows"] <= prm.gather_model(m, "ruling")["global_rows"]
    succ = _runs_ring(4096, 8, seed=2)
    n_runs = int(prm.run_heads(succ).sum())
    _, cc = prm.simulate(succ, "coalesced", r_pad=prm.coalesce_budget(n_runs, slack=0))
    _, cw = prm.simulate(succ, "wyllie")
    assert cc["n_runs"] == n_runs and cw["global_rows"] >= 2 * cc["global_rows"]


@pytest.fixture(scope="module")
def chain_batch():
    """(numpy ChainColumns [2, ...]) of tracegen docs, and their texts."""
    docs = tracegen.fleet_docs(2, n_patches=1500, seed=21, use_cache=False)
    pad_n = max(d.extract.n for d in docs) + 5
    pad_c = max(pcol.contract_chains(d.extract).n_chains for d in docs) + 3
    cols = pcol.stack_docs([pcol.chain_columns(d.extract, pad_n=pad_n, pad_c=pad_c) for d in docs])
    return cols, [d.text for d in docs]


def test_simulate_on_chain_rings_matches_jax(chain_batch):
    cols, _ = chain_batch
    for i in range(cols.c_parent.shape[0]):
        args = [getattr(cols, f)[i] for f in ("c_parent", "c_side", "c_valid")]
        succ = prm.build_ring(*args)
        np.testing.assert_array_equal(succ, jrm.build_ring(*args))
        budget = prm.coalesce_budget(int(prm.run_heads(succ).sum()))
        for algo in ALGOS:
            kw = {"r_pad": budget} if algo == "coalesced" else {}
            pd, pc = prm.simulate(succ, algo, **kw)
            jd, jc = jrm.simulate(succ, algo, **kw)
            np.testing.assert_array_equal(pd, jd)
            assert pc == jc


def _rank_counters(obs_m):
    """{(metric, algo label, kind): value} of the rank.* counters."""
    out = {}
    for m in obs_m.registry().metrics():
        if not m.name.startswith("rank."):
            continue
        for row in m.snapshot()["values"]:
            lab = dict(row["labels"])
            out[(m.name, lab.get("algo"), lab.get("kind"))] = row["value"]
    return out


def _delta(before, after, mapped=False):
    out = {}
    for key, v in after.items():
        d = v - before.get(key, 0)
        if d:
            name, algo, kind = key
            if mapped:
                b, _, a = algo.partition(":")
                algo = f"{BACKEND[b]}:{a}"
            out[(name, algo, kind)] = d
    return out


@pytest.mark.parametrize("algo", ALGOS)
def test_rank_counters_after_a_chain_merge_match_jax(chain_batch, algo):
    """The same chain merge through both packages' four chain entry
    points ticks the same rank.* counts (torch:<algo> <-> xla:<algo>);
    the merge itself is equal too."""
    cols, texts = chain_batch
    t = pfb.chain_columns_to_torch(cols, device="cpu")
    jc = jfb.ChainColumns(*[jnp.asarray(a) for a in cols])
    budget = None
    if algo == "coalesced":
        stats = [prm.ring_stats(prm.build_ring(*[getattr(cols, f)[i] for f in ("c_parent", "c_side", "c_valid")]))
                 for i in range(cols.c_parent.shape[0])]
        budget = prm.coalesce_budget(max(s["n_runs"] for s in stats))
    p0, j0 = _rank_counters(pobs), _rank_counters(jobs)
    codes, counts = pfb.chain_merge_docs_v(t, f"torch:{algo}", budget, device="cpu")
    pfb.chain_merge_docs_checksum_v(t, f"torch:{algo}", budget, device="cpu")
    jcodes, jcounts = jfb.chain_merge_docs_v(jc, f"xla:{algo}", budget)
    jfb.chain_merge_docs_checksum_v(jc, f"xla:{algo}", budget)
    pd = _delta(p0, _rank_counters(pobs), mapped=True)
    jd = _delta(j0, _rank_counters(jobs))
    assert pd == jd and pd
    n_docs, n_chains = cols.c_parent.shape
    assert pd[("rank.ring_tokens", f"xla:{algo}", None)] == 2 * n_docs * 2 * (n_chains + 1)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    for i, want in enumerate(texts):
        assert "".join(map(chr, codes[i][: int(counts[i])].tolist())) == want


def test_default_and_element_entry_points_tick(chain_batch):
    """chain_merge_docs, its checksum, merge_docs, merge_docs_checksum and
    chain_merge_docs_u tick once each on the CPU's default route
    (torch:ruling); materialize_content alone ticks nothing (as in the
    JAX package)."""
    cols, _ = chain_batch
    t = pfb.chain_columns_to_torch(cols, device="cpu")
    docs = tracegen.fleet_docs(2, n_patches=300, seed=3, use_cache=False)
    seq = pfb.seq_columns_to_torch(pcol.stack_docs([d.extract.to_seq_columns(pad_to=512) for d in docs]), device="cpu")
    c0 = pobs.counter("rank.ring_tokens").get(algo="torch:ruling")
    pfb.materialize_content(seq, device="cpu")
    assert pobs.counter("rank.ring_tokens").get(algo="torch:ruling") == c0
    pfb.chain_merge_docs(t, device="cpu")
    pfb.chain_merge_docs_checksum(t, device="cpu")
    n_docs, n_chains = cols.c_parent.shape
    m_chain = n_docs * 2 * (n_chains + 1)
    assert pobs.counter("rank.ring_tokens").get(algo="torch:ruling") == c0 + 2 * m_chain
    pfb.merge_docs(seq, device="cpu")
    pfb.merge_docs_checksum(seq, device="cpu")
    m_seq = seq.parent.shape[0] * 2 * (seq.parent.shape[1] + 1)
    assert pobs.counter("rank.ring_tokens").get(algo="torch:ruling") == c0 + 2 * m_chain + 2 * m_seq
    per_doc = [tracegen.seq_columns_u(d, "apply", pad_to=512) for d in docs]
    u = pfb.SeqColumnsU(*[np.stack([getattr(c, f) for c in per_doc]) for f in pfb.SeqColumnsU._fields])
    pfb.chain_merge_docs_u(u, 64, device="cpu")
    m_u = u.parent.shape[0] * 2 * (64 + 1)
    assert pobs.counter("rank.ring_tokens").get(algo="torch:ruling") == c0 + 2 * m_chain + 2 * m_seq + m_u


@pytest.mark.parametrize("spec", [None, "cuda:ruling", "cuda:blocked", "cuda:coalesced", "cuda:wyllie"])
def test_card_labels_match_pallas(spec):
    """On a CUDA device the label is the port's spec ("cuda:ruling" by
    default) and the counts are the JAX package's for "pallas:<algo>" at
    the ruling k every launch plans with; the tick reads shapes only (no
    tensor is made, so it runs here without a card) and leaves the
    over-cap route counter alone."""
    n_docs, n_nodes, budget = 3, 4000, 1024
    algo = "ruling" if spec is None else spec.split(":")[1]
    routes0 = dict(pfb.RANK_ROUTES)
    p0, j0 = _rank_counters(pobs), _rank_counters(jobs)
    pfb._tick_rank_obs(n_docs, n_nodes, spec, "cuda", budget)
    jfb._tick_rank_obs(n_docs, n_nodes, f"pallas:{algo}", budget)
    pd = _delta(p0, _rank_counters(pobs), mapped=True)
    assert pd == _delta(j0, _rank_counters(jobs)) and pd
    assert list_rank.DEFAULT_K == 8 and pfb.RANK_ROUTES == routes0
    over = list_rank.RANK_MAX_M  # n_nodes past the kernels' cap: cuda:sparse, uncounted
    p0 = _rank_counters(pobs)
    pfb._tick_rank_obs(1, over, None, "cuda")
    assert {k[1] for k in _delta(p0, _rank_counters(pobs))} == {"cuda:sparse"} and pfb.RANK_ROUTES == routes0


def test_over_cap_tick_counts_the_cells_ring_tokens():
    """The import cell's call (256 docs of 262,144 slots, rings of
    524,290 tokens past the cap) ticks rank.ring_tokens by D x m under
    the sparse route's label, priced by gather_model at SPARSE_K; a
    device object needs no card."""
    m = 2 * (262_144 + 1)
    c0 = pobs.counter("rank.ring_tokens").get(algo="cuda:sparse")
    r0 = pobs.counter("rank.rounds_total").get(algo="cuda:sparse")
    pfb._tick_rank_obs(256, 262_144, None, torch.device("cuda"))
    assert pobs.counter("rank.ring_tokens").get(algo="cuda:sparse") == c0 + 256 * 524_290
    mdl = prm.gather_model(m, "sparse", k=list_rank.SPARSE_K)
    assert pobs.counter("rank.rounds_total").get(algo="cuda:sparse") == r0 + 256 * mdl["rounds"]
    assert mdl["global_rows"] == 2 * m + -(-m // list_rank.SPARSE_K)


def test_tick_never_raises():
    pfb._tick_rank_obs(2, 100, "torch:nope", "cpu")
    pfb._tick_rank_obs(2, 100, "cuda:ruling", "cpu")  # a CUDA spec on the CPU: the merge raises, the tick does not
    pfb._tick_rank_obs(2, 100, None, "not-a-device")
