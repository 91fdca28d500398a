"""The port's list-rank module (loro_tpu_torch/ops/list_rank.py) against
the JAX package's Pallas kernels (interpret mode) and its XLA references
(wyllie_rank_xla, fugue_batch._wyllie_dist).

Tolerance: exact — distances are integers and every version must give
the same int32 values.  Inputs are numpy rings made from fixed seeds.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from loro_tpu.ops.fugue_batch import _wyllie_dist as jax_wyllie_dist
from loro_tpu.ops.pallas_rank import wyllie_rank as jax_wyllie_rank
from loro_tpu.ops.pallas_rank import wyllie_rank_xla
from loro_tpu_torch.errors import ConfigError
from loro_tpu_torch.ops import list_rank as lr


def _random_ring(m: int, seed: int) -> np.ndarray:
    """One ring through every token (tests/test_pallas_rank.py)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(m).astype(np.int32)
    succ = np.empty(m, np.int32)
    succ[perm[:-1]] = perm[1:]
    succ[perm[-1]] = perm[-1]
    return succ


def _subset_ring(rng, m: int) -> np.ndarray:
    """A chain over a random subset; other tokens self-loop
    (tests/test_ruling_rank.py)."""
    live = rng.choice(m, size=rng.integers(2, m + 1), replace=False)
    p = rng.permutation(live).astype(np.int32)
    succ = np.arange(m, dtype=np.int32)
    succ[p[:-1]] = p[1:]
    return succ


def _gap_ring(m: int, k: int) -> np.ndarray:
    """Every non-ruler before any ruler along the ring (worst ruler gap)."""
    order = [i for i in range(m) if i % k != 0] + [i for i in range(m) if i % k == 0]
    succ = np.arange(m, dtype=np.int32)
    for a, b in zip(order[:-1], order[1:]):
        succ[a] = b
    return succ


def _runs_ring(m: int, run_len: int, seed: int) -> np.ndarray:
    """One chain over index-consecutive runs in shuffled run order
    (tests/test_rank_blocked.py)."""
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


def _short_lists(m: int, length: int, seed: int) -> np.ndarray:
    """Many lists of `length` tokens in random order (a head every
    `length` tokens)."""
    perm = np.random.default_rng(seed).permutation(m).astype(np.int32)
    succ = np.arange(m, dtype=np.int32)
    body = np.arange(m - 1) % length != length - 1
    succ[perm[:-1][body]] = perm[1:][body]
    return succ


def _in_tree(m: int, seed: int) -> np.ndarray:
    """A random recursive tree: token perm[j] points to a random earlier
    perm[i], so many tokens share a successor; perm[0] is the terminal."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(m).astype(np.int32)
    succ = np.empty(m, np.int32)
    succ[perm] = perm[(rng.random(m) * np.arange(m)).astype(np.int64)]
    return succ


def _port(succ, **kw) -> np.ndarray:
    got = lr.wyllie_rank(succ, device="cpu", **kw).numpy()
    ref = lr.wyllie_rank_reference(succ, **kw).numpy()
    np.testing.assert_array_equal(got, ref)
    return got


@pytest.mark.parametrize("algo", ["ruling", "wyllie"])
@pytest.mark.parametrize("m", [8, 64, 257, 1024, 4096])
def test_matches_pallas_interpret_and_xla(m, algo):
    succ = _random_ring(m, m)
    want = np.asarray(jax_wyllie_rank(jnp.asarray(succ), interpret=True, algo=algo))
    np.testing.assert_array_equal(want, np.asarray(wyllie_rank_xla(jnp.asarray(succ))))
    np.testing.assert_array_equal(_port(succ, algo=algo), want)


@pytest.mark.parametrize("algo", ["ruling", "wyllie"])
@pytest.mark.parametrize("m", [5, 64, 257, 1000])
def test_subset_rings_match_xla(m, algo):
    rng = np.random.default_rng(m)
    for _ in range(4):
        succ = _subset_ring(rng, m)
        want = np.asarray(wyllie_rank_xla(jnp.asarray(succ)))
        np.testing.assert_array_equal(_port(succ, algo=algo), want)


def test_subset_ring_matches_pallas_interpret():
    succ = _subset_ring(np.random.default_rng(3), 700)
    want = np.asarray(jax_wyllie_rank(jnp.asarray(succ), interpret=True, algo="ruling"))
    np.testing.assert_array_equal(_port(succ), want)


def test_adversarial_gap_matches_pallas(monkeypatch):
    """All non-rulers consecutive: the phase-1 round cap must still give
    exact distances."""
    succ = _gap_ring(2048, 8)
    want = np.asarray(jax_wyllie_rank(jnp.asarray(succ), interpret=True, algo="ruling"))
    np.testing.assert_array_equal(want, np.asarray(wyllie_rank_xla(jnp.asarray(succ))))
    np.testing.assert_array_equal(_port(succ, algo="ruling", k=8), want)


@pytest.mark.parametrize("k", [2, 4, 16, 64, 128])
def test_k_sweep_matches_pallas(k, monkeypatch):
    monkeypatch.setenv("PALLAS_RULING_K", str(k))
    for m in (64, 257, 1500):
        succ = _random_ring(m, 31 * m + k)
        want = np.asarray(jax_wyllie_rank(jnp.asarray(succ), interpret=True, algo="ruling"))
        np.testing.assert_array_equal(_port(succ, algo="ruling", k=k), want, err_msg=f"k={k} m={m}")


@pytest.mark.parametrize("algo", ["ruling", "wyllie"])
def test_weighted_matches_pallas(algo):
    rng = np.random.default_rng(11)
    succ = _subset_ring(rng, 900)
    w = np.where(succ == np.arange(900), 0, rng.integers(1, 5, 900)).astype(np.int32)
    bound = int(w.sum()) + 1
    want = np.asarray(
        jax_wyllie_rank(jnp.asarray(succ), interpret=True, algo=algo, weights=jnp.asarray(w), dist_bound=bound)
    )
    np.testing.assert_array_equal(_port(succ, algo=algo, weights=w, dist_bound=bound), want)


@pytest.mark.parametrize("algo", ["ruling", "wyllie"])
def test_batched_rows_match_single_rings(algo):
    rings = [_random_ring(1500, s) for s in range(3)] + [_gap_ring(1500, 8)]
    got = _port(np.stack(rings), algo=algo)
    assert got.shape == (4, 1500) and got.dtype == np.int32
    for row, succ in zip(got, rings):
        np.testing.assert_array_equal(row, np.asarray(wyllie_rank_xla(jnp.asarray(succ))))


def test_distances_are_list_positions():
    dist = _port(_random_ring(512, 7))
    assert sorted(dist.tolist()) == list(range(512))


@pytest.mark.parametrize("m", [65537, 65600, 131072])
def test_wide_matches_pallas_interpret_and_xla(m):
    """Rings past 65536 lane-padded tokens take the wide kernel."""
    succ = _random_ring(m, m + 1)
    want = np.asarray(jax_wyllie_rank(jnp.asarray(succ), interpret=True))
    np.testing.assert_array_equal(want, np.asarray(jax.jit(jax_wyllie_dist)(jnp.asarray(succ))))
    assert lr.plan_rank(m).wide
    np.testing.assert_array_equal(_port(succ), want)


def test_weighted_wide_matches_pallas_interpret():
    """dist_bound past 65536 takes the wide kernel on a short ring; the
    distances themselves pass 16 bits."""
    rng = np.random.default_rng(12)
    succ = _random_ring(3000, 12)
    # 2999 weighted steps of 22 or 23: the head's distance lies in
    # (65536, 70000)
    w = np.where(succ == np.arange(3000), 0, rng.integers(22, 24, 3000)).astype(np.int32)
    want = np.asarray(
        jax_wyllie_rank(jnp.asarray(succ), interpret=True, weights=jnp.asarray(w), dist_bound=70_000)
    )
    assert 1 << 16 < want.max() < 70_000
    plan = lr.plan_rank(3000, weighted=True, dist_bound=70_000)
    assert plan.wide and plan.mp == 3072
    for algo in ("ruling", "wyllie", "blocked"):
        np.testing.assert_array_equal(_port(succ, algo=algo, weights=w, dist_bound=70_000), want)


@pytest.mark.parametrize("block", [128, 1024, 8192])
def test_blocked_matches_pallas_interpret(block, monkeypatch):
    """Blocked plain version vs the Pallas blocked kernel (RANK_BLOCK is
    the JAX block) on the blocked-rank ring generators at lengths around
    the lane quantum and the default block."""
    monkeypatch.setenv("RANK_BLOCK", str(block))
    for m in (127, 128, 129, 1023, 1024, 1025, 4097):
        for name, succ in (("random", _subset_ring(np.random.default_rng(m), m)), ("runs", _runs_ring(m, 37, m))):
            want = np.asarray(jax_wyllie_rank(jnp.asarray(succ), interpret=True, algo="blocked"))
            got = _port(succ, algo="blocked", block=block)
            np.testing.assert_array_equal(got, want, err_msg=f"{name} m={m} block={block}")


def test_blocked_phase_a_alone_is_exact():
    """A block as large as the ring collapses every chain in phase A."""
    succ = _random_ring(2048, 4)
    want = np.asarray(wyllie_rank_xla(jnp.asarray(succ)))
    np.testing.assert_array_equal(_port(succ, algo="blocked", block=65536), want)
    np.testing.assert_array_equal(_port(_gap_ring(2048, 8), algo="blocked", block=128),
                                  np.asarray(wyllie_rank_xla(jnp.asarray(_gap_ring(2048, 8)))))


def test_wide_and_blocked_plans():
    p = lr.plan_rank(65600, "blocked", 8)  # blocked on a wide ring -> wide, as in JAX
    assert (p.wide, p.mp, p.n_steps, p.ruling, p.n_steps_a) == (True, 65664, 17, False, 0)
    assert p.table_words == 2 * 65664
    p = lr.plan_rank(65600, "ruling", 64)  # k ignored: 128-token padding
    assert (p.wide, p.mp) == (True, 65664)
    p = lr.plan_rank(65536, "ruling")  # lane-padded 65536: still packed
    assert not p.wide and p.mp == 65536
    p = lr.plan_rank(1000, "blocked", 8, block=128)
    assert (p.wide, p.mp, p.ruling, p.n_steps_a) == (False, 1024, True, 7)
    assert p.table_words == 1024 + 128 + 1
    assert lr.plan_rank(1000, "blocked", 8).n_steps_a == 10  # min(block, mp) = 1024
    assert lr.plan_rank(1000, "ruling").n_steps_a == 0
    for bad in (64, 100, 1000, 1 << 17, 0, -128):
        with pytest.raises(ConfigError):
            lr.plan_rank(1000, "blocked", block=bad)


def test_padding_plan_matches_jax_contract():
    p = lr.plan_rank(1000, "ruling", 8)
    assert (p.mp, p.algo, p.n_steps) == (1024, "ruling", 10)
    p = lr.plan_rank(1000, "wyllie")
    assert (p.mp, p.algo) == (1024, "wyllie")
    p = lr.plan_rank(37000, "ruling", 8)
    assert p.mp == 37888 and p.table_words == 37888 + 37888 // 8 + 1
    assert lr.plan_rank(65536, "ruling", 512).mp == 65536  # quantum divides 65536: no fallback


def test_contract_errors():
    succ = _random_ring(64, 1)
    for bad in (6, 1, 1024, 0):
        with pytest.raises(ConfigError):
            lr.wyllie_rank(succ, algo="ruling", k=bad, device="cpu")
    np.testing.assert_array_equal(_port(succ, algo="wyllie", k=6), _port(succ, algo="ruling"))
    with pytest.raises(ConfigError):
        lr.wyllie_rank(succ, algo="bogus", device="cpu")
    np.testing.assert_array_equal(_port(succ, algo="blocked"), _port(succ, algo="ruling"))
    ring = _random_ring(65600, 2)
    np.testing.assert_array_equal(_port(ring), np.asarray(wyllie_rank_xla(jnp.asarray(ring))))
    w = np.where(succ == np.arange(64), 0, 1).astype(np.int32)
    np.testing.assert_array_equal(_port(succ, weights=w, dist_bound=70000), _port(succ, algo="wyllie"))
    with pytest.raises(ValueError, match="dist_bound"):
        lr.wyllie_rank(succ, weights=np.ones(64, np.int32), device="cpu")
    with pytest.raises(ValueError, match="too long"):
        lr.wyllie_rank(np.zeros(lr.RANK_MAX_M + 1, np.int32), device="cpu")
    with pytest.raises(TypeError):
        lr.wyllie_rank(succ.astype(np.int64), device="cpu")
    with pytest.raises(ValueError):
        lr.wyllie_rank(np.full(8, 9, np.int32), device="cpu")


def test_build_key_covers_included_headers(tmp_path, monkeypatch):
    """A kernel library is rebuilt when a header its source includes
    (directly or through another header) changes."""
    from loro_tpu_torch import _build

    (tmp_path / "inc").mkdir()
    src = tmp_path / "k.cu"
    src.write_text('#include <cstdint>\n#include "inc/a.cuh"\n')
    (tmp_path / "inc" / "a.cuh").write_text('#include "b.cuh"\n')
    (tmp_path / "inc" / "b.cuh").write_text("// b\n")
    (tmp_path / "unused.cuh").write_text("// not included\n")
    monkeypatch.setitem(_build.SOURCES, "k", src)
    assert sorted(f.name for f in _build._inputs(src)) == ["a.cuh", "b.cuh", "k.cu"]
    key = _build._target("k")
    (tmp_path / "unused.cuh").write_text("// changed\n")
    assert _build._target("k") == key
    (tmp_path / "inc" / "b.cuh").write_text("// b changed\n")
    assert _build._target("k") != key


def test_cpu_path_never_launches():
    lr.reset_launches()
    _port(_random_ring(300, 5))
    _port(_random_ring(300, 5), algo="blocked", block=128)
    _port(_random_ring(65600, 5))
    assert sum(lr.LAUNCHES.values()) == 0


def test_default_cluster_plans_fit_shared_memory():
    """Every padded length from 128 to RANK_MAX_M, on every route: the
    wide kernel on a cluster of WIDE_CLUSTER, wyllie past one CTA's
    shared memory on a cluster of WYLLIE_CLUSTER, the other packed plans
    on one CTA, an integral slice S = mp / C, and a per-CTA table within
    the opt-in shared-memory limit."""
    for m in range(128, lr.RANK_MAX_M + 1, 128):
        for algo in lr.ALGOS:
            p = lr.plan_rank(m, algo)
            split = p.algo == "wyllie" and not p.wide and p.mp * 4 > lr.SMEM_LIMIT
            assert p.wyllie_split == split
            assert p.cluster == (lr.WIDE_CLUSTER if p.wide else lr.WYLLIE_CLUSTER if split else 1), (m, algo)
            assert p.mp % p.cluster == 0 and p.slice_tokens * p.cluster == p.mp
            assert 0 <= p.smem_bytes <= lr.SMEM_LIMIT, (m, algo, p.smem_bytes)
            assert lr.launch_key(p) == ("wide/cluster" if p.wide else "wyllie/cluster" if split else
                                        f"{p.algo}/{'smem' if p.smem_bytes else 'global'}")
            assert lr.launch_key(p) in lr.LAUNCHES
            assert p.algo != "wyllie" or p.wide or p.smem_bytes  # wyllie never takes a global table


@pytest.mark.parametrize("cluster", [2, 4, 8, 16])
def test_explicit_cluster_plans(cluster):
    """The packed kernels run on one CTA: a cluster raises.  A wide slice
    takes 10 bytes a token (u64 word, u16 exit number) and 256 bytes of
    counters; the exit ring gets what is left, so the wide kernel fits
    from C = 8 up at the cap (C = 4 up to 92,800 tokens)."""
    for m in range(1024, lr.PACKED_MAX_M + 1, 8192):
        with pytest.raises(ConfigError, match="only the wide kernel"):
            replace(lr.plan_rank(m, "ruling"), cluster=cluster)
    for m in range(lr.PACKED_MAX_M + 128, lr.RANK_MAX_M + 1, 128):
        s = m // cluster
        base = lr.plan_rank(m)
        if 10 * s + 264 <= lr.SMEM_LIMIT:
            p = replace(base, cluster=cluster)
            assert p.wide and p.slice_tokens == s and 0 <= p.exit_ring_slots <= m
            assert p.smem_bytes == 10 * s + 8 * (p.exit_ring_slots + 1) + 256 <= lr.SMEM_LIMIT
            assert p.exit_ring_slots == m or p.smem_bytes > lr.SMEM_LIMIT - 8  # the rest goes to the exit ring
        else:
            with pytest.raises(ConfigError, match="shared memory"):
                replace(base, cluster=cluster)
    if cluster >= 8:
        p = replace(lr.plan_rank(lr.RANK_MAX_M), cluster=cluster)
        assert p.smem_bytes <= lr.SMEM_LIMIT and p.exit_ring_slots >= 8000
    if cluster == 4:
        assert replace(lr.plan_rank(92800), cluster=4).wide
        with pytest.raises(ConfigError):
            replace(lr.plan_rank(92801), cluster=4)


@pytest.mark.parametrize("cluster", [2, 4, 8, 16])
def test_wide_cluster_sizes_accepted(cluster):
    """Every power-of-two cluster from 2 to MAX_CLUSTER takes a short
    weighted wide ring whole: its exit ring fits every token."""
    p = replace(lr.plan_rank(3000, weighted=True, dist_bound=70_000), cluster=cluster)
    assert p.wide and p.mp == 3072 and p.cluster == cluster
    assert p.slice_tokens * cluster == p.mp and p.exit_ring_slots == p.mp
    assert p.smem_bytes == 10 * p.slice_tokens + 8 * (p.mp + 1) + 256 <= lr.SMEM_LIMIT
    assert lr.launch_key(p) == "wide/cluster"


def test_cluster_config_errors():
    wide = lr.plan_rank(70000)
    assert wide.cluster == lr.WIDE_CLUSTER
    for bad in (0, 1, 3, 6, 12, 32, -8, 2.0, True, "8"):
        with pytest.raises(ConfigError, match="rank cluster"):
            replace(wide, cluster=bad)
    for algo in lr.ALGOS:
        p = lr.plan_rank(1000, algo)
        assert p.cluster == 1
        for bad in (2, 8, True, 1.0):
            with pytest.raises(ConfigError, match="only the wide kernel"):
                replace(p, cluster=bad)
        assert lr.plan_rank(70000, algo).cluster == lr.WIDE_CLUSTER  # a wide ring takes the wide cluster
    for m, c in ((lr.RANK_MAX_M, 2), (lr.RANK_MAX_M, 4), (65664, 2)):
        with pytest.raises(ConfigError, match="shared memory"):
            replace(lr.plan_rank(m), cluster=c)
    with pytest.raises(TypeError):
        lr.wyllie_rank(_random_ring(64, 1), cluster=8, device="cpu")  # not a user option


def test_cpu_route_ignores_cluster_and_matches_pallas():
    """The CPU route runs the unchanged plain versions, whatever cluster
    a plan carries: ruling, weighted ruling and wide rings stay
    bit-exact against the Pallas kernels (interpret mode) and the XLA
    reference."""
    succ = _random_ring(1500, 77)
    want = np.asarray(jax_wyllie_rank(jnp.asarray(succ), interpret=True, algo="ruling"))
    np.testing.assert_array_equal(_port(succ, algo="ruling"), want)
    rng = np.random.default_rng(78)
    w = np.where(succ == np.arange(1500), 0, rng.integers(1, 5, 1500)).astype(np.int32)
    bound = int(w.sum()) + 1
    want = np.asarray(
        jax_wyllie_rank(jnp.asarray(succ), interpret=True, weights=jnp.asarray(w), dist_bound=bound)
    )
    np.testing.assert_array_equal(_port(succ, weights=w, dist_bound=bound), want)
    wide = _random_ring(65600, 79)
    want = np.asarray(wyllie_rank_xla(jnp.asarray(wide)))
    np.testing.assert_array_equal(_port(wide), want)
    plan, succ_p, w_p = lr._prepare(torch.as_tensor(wide), None, "ruling", 8, None)
    for c in (4, 16):
        got = lr.rank_plain(succ_p, w_p, replace(plan, cluster=c))[0, :65600]
        np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_cluster_route_never_launches():
    lr.reset_launches()
    _port(_random_ring(3000, 6))
    succ = _random_ring(3000, 7)
    w = np.where(succ == np.arange(3000), 0, 22).astype(np.int32)
    assert lr.plan_rank(3000, weighted=True, dist_bound=70_000).wide
    _port(succ, weights=w, dist_bound=70_000)
    assert lr.plan_rank(60000, "wyllie").wyllie_split
    _port(_random_ring(60000, 8), algo="wyllie")
    assert sum(lr.LAUNCHES.values()) == 0
    assert {"wide/cluster", "wyllie/cluster"} <= set(lr.LAUNCHES)
    assert not {"ruling/cluster", "blocked/cluster", "wide/global", "wyllie/global"} & set(lr.LAUNCHES)


# The two-CTA Wyllie plan: a packed wyllie ring whose u32 table passes
# SMEM_LIMIT (58,112 < mp <= 65,536) is split over WYLLIE_CLUSTER CTAs.
_WYLLIE_EDGE = lr.SMEM_LIMIT // 4  # 58,112: the last mp one CTA holds


@pytest.mark.parametrize("m", [1, 1000, 34818, 39936, 39937, _WYLLIE_EDGE, _WYLLIE_EDGE + 1, 60000, 65535, 65536])
def test_wyllie_cluster_plan(m):
    """cluster = WYLLIE_CLUSTER is taken, and accepted, only past the
    budget; its shared memory is per CTA (half the table and the vote
    word); its key is wyllie/cluster; ruling and blocked plans of the
    same ring stay on one CTA and reject every cluster above 1."""
    p = lr.plan_rank(m, "wyllie")
    over = p.mp > _WYLLIE_EDGE
    assert not p.wide and p.wyllie_split == over
    assert p.table_words == p.mp
    if over:
        assert p.cluster == lr.WYLLIE_CLUSTER == 2 and p.slice_tokens == p.mp // 2
        assert p.smem_bytes == 4 * (p.mp // 2) + 16 <= 131_088
        assert lr.launch_key(p) == "wyllie/cluster"
        for bad in (1, 4, 8, 16, True, 2.0):
            with pytest.raises(ConfigError, match="wyllie ring whose table passes"):
                replace(p, cluster=bad)
    else:
        assert p.cluster == 1 and p.smem_bytes == 4 * p.table_words <= lr.SMEM_LIMIT
        assert lr.launch_key(p) == "wyllie/smem"
        for bad in (2, 4, 8):
            with pytest.raises(ConfigError, match="only the wide kernel and wyllie rings"):
                replace(p, cluster=bad)
    for algo in ("ruling", "blocked"):
        q = lr.plan_rank(m, algo)
        assert q.cluster == 1 and not q.wyllie_split
        for bad in (2, 4, 8, 16):
            with pytest.raises(ConfigError, match="only the wide kernel"):
                replace(q, cluster=bad)


def test_wyllie_rounds_reads_stamps():
    """wyllie_rounds on stamps laid out as the timed Wyllie kernels write
    them (list_rank_wyllie_launch_timed): two CTAs, 3 and 4 rounds."""
    st = torch.zeros((2, lr.WYLLIE_STAMPS), dtype=torch.int64)
    for row, (rounds, per_round) in enumerate(((3, 100), (4, 200))):
        st[row, 0], st[row, 1] = 1000, 1500  # start, after the load
        for r in range(rounds):
            st[row, 2 + r] = 1500 + per_round * (r + 1)
            st[row, 2 + lr.MAX_ROUNDS + r] = 50 - r
        st[row, 2 * lr.MAX_ROUNDS + 2] = 1500 + per_round * rounds + 70  # after the store
        st[row, 2 * lr.MAX_ROUNDS + 3] = rounds
    info = lr.wyllie_rounds(st)
    assert info["rounds"] == (3, 4) and info["load_cycles"] == 500 and info["store_cycles"] == 70
    # torch's median of two rows is the lower one
    assert info["round_cycles"] == [100.0] * 3 and info["moved"] == [50.0, 49.0, 48.0]
    assert info["rounds_cycles"] == 300 and info["total_cycles"] == 870


def test_wyllie_cluster_plan_errors():
    """A weighted ring past the packed dist range takes the wide kernel,
    not the two-CTA one; launch_timed refuses wide plans only; the
    two-CTA plan has no other cluster size."""
    assert lr.plan_rank(60000, "wyllie", weighted=True, dist_bound=65_536).wyllie_split
    wide = lr.plan_rank(60000, "wyllie", weighted=True, dist_bound=65_537)
    assert wide.wide and not wide.wyllie_split and wide.cluster == lr.WIDE_CLUSTER
    assert lr.launch_key(wide) == "wide/cluster"
    plan, succ_p, w_p = lr._prepare(torch.as_tensor(_random_ring(60000, 3)), None, "wyllie", 8, None)
    with pytest.raises(ValueError, match="CUDA"):
        lr.launch_kernel(succ_p, w_p, plan)
    with pytest.raises(ValueError, match="packed plan"):
        lr.launch_timed(succ_p, w_p, wide)
    with pytest.raises(ValueError, match="needs a plan on a cluster"):
        lr.max_active_clusters(lr.plan_rank(1000, "wyllie"), torch.device("cpu"))


# The ring families of the card tests (tests/test_torch_list_rank_cuda.py)
# against the JAX package: many heads, an in-tree, ruler gaps, index-local
# runs, every ruler spacing, weights, both sides of the ruling table's
# shared-memory boundary, and blocked phase A at every block size.
_FAMILIES = {
    "short-lists": lambda: _short_lists(3000, 6, 1),
    "in-tree": lambda: _in_tree(3000, 2),
    "gap-2048": lambda: _gap_ring(2048, 8),
    "runs": lambda: _runs_ring(3000, 37, 3),
}


@pytest.mark.parametrize("algo", ["ruling", "blocked", "wyllie"])
@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_ring_families_match_pallas(family, algo):
    succ = _FAMILIES[family]()
    want = np.asarray(jax_wyllie_rank(jnp.asarray(succ), interpret=True, algo=algo))
    np.testing.assert_array_equal(want, np.asarray(wyllie_rank_xla(jnp.asarray(succ))))
    np.testing.assert_array_equal(_port(succ, algo=algo), want)


@pytest.mark.parametrize("algo", ["ruling", "blocked"])
@pytest.mark.parametrize("k", [2, 8, 64, 512])
def test_ruler_spacings_match_xla(k, algo):
    """k = 512 pads to 65,536 tokens: the plain version's ruling phases
    on a whole packed ring."""
    for succ in (_random_ring(3000, k), _in_tree(3000, k)):
        np.testing.assert_array_equal(_port(succ, algo=algo, k=k), np.asarray(wyllie_rank_xla(jnp.asarray(succ))))


def _smem_edge(algo: str = "ruling") -> int:
    """The longest ring whose table fits one block's shared memory: the
    ruling table's (in steps of 1024), or the wyllie table's (58,112)."""
    if algo == "wyllie":
        return lr.SMEM_LIMIT // 4
    m = 1024
    while lr.plan_rank(m + 1024).smem_bytes:
        m += 1024
    return m


_LARGE = {
    "gap-65536": lambda algo: _gap_ring(65536, 8),
    "smem-edge": lambda algo: _random_ring(_smem_edge(algo), 5),
    "past-smem-edge": lambda algo: _random_ring(_smem_edge(algo) + 1, 6),
}


@pytest.mark.parametrize("algo", ["ruling", "blocked", "wyllie"])
@pytest.mark.parametrize("ring", sorted(_LARGE))
def test_large_rings_match_xla(ring, algo):
    """The rings whose tables sit on both sides of the shared-memory
    boundary, and the longest ruler gap a packed ring can have; past the
    boundary ruling and blocked take a global table, wyllie a cluster of
    two CTAs."""
    succ = _LARGE[ring](algo)
    past = "wyllie/cluster" if algo == "wyllie" else f"{algo}/global"
    assert lr.launch_key(lr.plan_rank(succ.shape[0], algo)) == (f"{algo}/smem" if ring == "smem-edge" else past)
    np.testing.assert_array_equal(_port(succ, algo=algo), np.asarray(wyllie_rank_xla(jnp.asarray(succ))))


@pytest.mark.parametrize("algo", ["ruling", "blocked"])
def test_weighted_in_tree_matches_pallas(algo):
    rng = np.random.default_rng(21)
    succ = _in_tree(2000, 22)
    w = np.where(succ == np.arange(2000), 0, rng.integers(1, 5, 2000)).astype(np.int32)
    bound = int(w.sum()) + 1
    want = np.asarray(
        jax_wyllie_rank(jnp.asarray(succ), interpret=True, algo=algo, weights=jnp.asarray(w), dist_bound=bound)
    )
    np.testing.assert_array_equal(_port(succ, algo=algo, weights=w, dist_bound=bound), want)


@pytest.mark.parametrize("block", [128, 1024, 65536])
def test_blocked_families_match_pallas(block, monkeypatch):
    """Blocked phase A on runs, an in-tree and many short lists, at the
    smallest, the default and the largest block."""
    monkeypatch.setenv("RANK_BLOCK", str(block))
    for succ in (_runs_ring(2000, 37, block), _in_tree(2000, block), _short_lists(2000, 6, block)):
        want = np.asarray(jax_wyllie_rank(jnp.asarray(succ), interpret=True, algo="blocked"))
        np.testing.assert_array_equal(_port(succ, algo="blocked", block=block), want)


# ---- the sparse ruling route (rings past RANK_MAX_M) ---------------------------


def _spine_ring(n_el: int = 40_000, n: int = 65_536) -> np.ndarray:
    """The Euler ring of a right spine of n_el elements padded to n rows
    (test_torch_element_merge's over-cap doc): 2 (n + 1) tokens, the
    invalid rows' tokens chained by index into it."""
    from loro_tpu_torch import entry
    from loro_tpu_torch.ops import columnar as pcol
    from loro_tpu_torch.ops import fugue_batch as pfb

    ex = entry.example_cols(d=1, n=n_el)
    cols = pfb.SeqColumns(*[pcol.pad_rows(a[0], n, f) for a, f in zip(ex, (-1, 0, 0, 0, True, -1, False))])
    t = pfb.seq_columns_to_torch(cols, device="cpu")
    return pfb._ring_and_anchors(t.parent, t.side, t.valid)[0][0].numpy()


def _forest_ring(n: int, seed: int) -> np.ndarray:
    """The Euler ring of a random Fugue tree whose invalid rows are
    scattered among the valid ones (each valid row's parent an earlier
    valid row or the root): many heads and merge points."""
    from loro_tpu_torch.ops import fugue_batch as pfb

    rng = np.random.default_rng(seed)
    valid = rng.random(n) < 0.7
    parent = np.array([rng.integers(-1, i) if i else -1 for i in range(n)], np.int64)
    parent = np.where(valid[np.maximum(parent, 0)] | (parent < 0), parent, -1)
    side = rng.integers(0, 2, n)
    t = [torch.from_numpy(a) for a in (parent[None].astype(np.int32), side[None].astype(np.int32), valid[None])]
    return pfb._ring_and_anchors(*t)[0][0].numpy()


def _star(m: int) -> np.ndarray:
    """Every token points at one terminal: every token but it is a head."""
    succ = np.full(m, m // 3, np.int32)
    return succ


_SPARSE_RINGS = {
    "spine-euler": lambda: _spine_ring()[None],
    "random-list": lambda: _random_ring(200_003, 41)[None],
    "in-forest": lambda: _forest_ring(70_000, 42)[None],
    "in-tree": lambda: _in_tree(150_000, 43)[None],
    "star": lambda: _star(140_001)[None],
    "three-rows": lambda: np.stack([_random_ring(131_200, 44), _star(131_200), _in_tree(131_200, 45)]),
}


@pytest.mark.parametrize("ring", list(_SPARSE_RINGS))
def test_sparse_plain_matches_wyllie_past_the_cap(ring):
    """torch:sparse (sparse_rank_plain, and sparse_rank on a CPU tensor)
    equals the port's and the JAX package's _wyllie_dist bit for bit on
    rings past RANK_MAX_M: the over-cap Euler ring, a random single list,
    an Euler in-forest with index-chained invalid tokens, a random in-tree,
    a star, and three rows of different shapes."""
    from loro_tpu_torch.ops import fugue_batch as pfb

    succ = _SPARSE_RINGS[ring]()
    assert succ.shape[1] > lr.RANK_MAX_M
    s = torch.from_numpy(succ)
    want = pfb._wyllie_dist(s)
    got = lr.sparse_rank_plain(s)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(lr.sparse_rank(s), want)
    for row, jw in zip(want.numpy(), (np.asarray(jax.jit(jax_wyllie_dist)(jnp.asarray(r))) for r in succ)):
        np.testing.assert_array_equal(row, jw)


@pytest.mark.parametrize("k", [2, 8, 128, 1024])
def test_sparse_plain_is_exact_at_every_ruler_spacing(k, monkeypatch):
    """The distances do not depend on SPARSE_K: spacings down to 2 (a
    ruler every other token) and past the gap of the longest walk."""
    from loro_tpu_torch.ops import fugue_batch as pfb

    monkeypatch.setattr(lr, "SPARSE_K", k)
    for succ in (_random_ring(5000, k), _forest_ring(3000, k)[:], _gap_ring(4096, 8), _star(777), _short_lists(3000, 5, k)):
        s = torch.from_numpy(np.ascontiguousarray(succ))[None]
        assert torch.equal(lr.sparse_rank_plain(s), pfb._wyllie_dist(s)), k


def test_sparse_route_contract_on_cpu():
    """One ring [m] or a batch [D, m]; int32 only; the CPU path never
    launches; an entry outside [0, m) ranks as a terminal."""
    lr.reset_launches()
    succ = _random_ring(3000, 46)
    one = lr.sparse_rank(succ)
    assert one.shape == (3000,) and sorted(one.tolist()) == list(range(3000))
    assert torch.equal(lr.sparse_rank(np.stack([succ, succ]))[1], one)
    assert sum(lr.LAUNCHES.values()) == 0 and "sparse/global" in lr.LAUNCHES
    with pytest.raises(TypeError):
        lr.sparse_rank(succ.astype(np.int64))
    with pytest.raises(ValueError):
        lr.sparse_rank(np.zeros((2, 2, 2), np.int32))
    assert lr.sparse_rank(np.array([1, -5, 9, 2], np.int32)).tolist() == [1, 0, 0, 1]
    assert lr.sparse_rank(np.zeros((0, 5), np.int32)).shape == (0, 5)
