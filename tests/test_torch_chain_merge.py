"""The port's chain-contracted text merge (loro_tpu_torch.ops.columnar /
fugue_batch, and tracegen) against the JAX package, on the CPU.

Inputs: seeded tracegen tables at small size (2000 patches, 4 peers)
and real Loro concurrent variants from loro_tpu.bench_utils.  Every
comparison is exact (tolerance: none): codes, counts, rank keys and
checksums are integers and must be bit-identical to
loro_tpu.ops.fugue_batch with rank_impl "xla:wyllie" / "xla:ruling".
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from loro_tpu.ops import columnar as jcol
from loro_tpu.ops import fugue_batch as jfb
from loro_tpu_torch import tracegen
from loro_tpu_torch.errors import ConfigError
from loro_tpu_torch.ops import columnar as pcol
from loro_tpu_torch.ops import fugue_batch as pfb
from loro_tpu_torch.ops import list_rank


def _to_port_extract(ex) -> pcol.SeqExtract:
    return pcol.SeqExtract(
        parent=ex.parent, side=ex.side, peer=ex.peer, counter=ex.counter,
        deleted=ex.deleted, content=ex.content, valid=ex.valid, peers=list(ex.peers),
    )


def _to_jax_extract(ex) -> jcol.SeqExtract:
    return jcol.SeqExtract(
        parent=ex.parent, side=ex.side, peer=ex.peer, counter=ex.counter,
        deleted=ex.deleted, content=ex.content, valid=ex.valid, peers=list(ex.peers),
    )


def _batch(extracts):
    pad_n = -(-max(e.n for e in extracts) // 512) * 512 + 512
    pad_c = -(-max(pcol.contract_chains(e).n_chains for e in extracts) // 128) * 128 + 64
    return pcol.stack_docs([pcol.chain_columns(e, pad_n=pad_n, pad_c=pad_c) for e in extracts])


@pytest.fixture(scope="module")
def datasets():
    """name -> (numpy ChainColumns [D, ...], texts, port SeqExtracts)."""
    from loro_tpu.bench_utils import concurrent_trace_variants

    docs = tracegen.fleet_docs(2, n_patches=2000, seed=7, use_cache=False)
    gen = [d.extract for d in docs]
    variants = concurrent_trace_variants(n_variants=2, limit=2000, use_cache=False)
    loro = [_to_port_extract(v["extract"]) for v in variants]
    return {
        "tracegen": (_batch(gen), [d.text for d in docs], gen),
        "loro": (_batch(loro), [v["text"] for v in variants], loro),
    }


def _jax_cols(np_cols):
    return jfb.ChainColumns(*[jnp.asarray(a) for a in np_cols])


def _text(codes, count) -> str:
    return "".join(map(chr, np.asarray(codes)[: int(count)].tolist()))


# ---- columnar -----------------------------------------------------------


@pytest.mark.parametrize("name", ["tracegen", "loro"])
def test_chain_columns_match_jax(datasets, name):
    np_cols, _, extracts = datasets[name]
    pad_n, pad_c = np_cols.chain_id.shape[1], np_cols.c_parent.shape[1]
    for ex in extracts:
        for kw in ({"pad_n": pad_n, "pad_c": pad_c}, {"bucket": True}):
            a = jcol.chain_columns(_to_jax_extract(ex), **kw)
            b = pcol.chain_columns(ex, **kw)
            for f in a._fields:
                x, y = getattr(a, f), getattr(b, f)
                assert x.dtype == y.dtype, f
                np.testing.assert_array_equal(x, y, err_msg=f)
        assert pcol.contract_chains(ex).n_chains == jcol.contract_chains(_to_jax_extract(ex)).n_chains


def test_sort_by_peer_counter_matches_jax():
    doc = tracegen.fleet_docs(1, n_patches=600, seed=3, use_cache=False)[1]
    ex = doc.extract
    perm = np.random.default_rng(0).permutation(ex.n)
    inv = np.empty(ex.n, np.int64)
    inv[perm] = np.arange(ex.n)
    par = np.where(ex.parent[perm] >= 0, inv[np.maximum(ex.parent[perm], 0)], -1).astype(np.int32)
    fields = dict(
        parent=par, side=ex.side[perm], peer=ex.peer[perm], counter=ex.counter[perm],
        deleted=ex.deleted[perm], content=ex.content[perm], valid=ex.valid[perm], peers=ex.peers,
    )
    a = jcol.SeqExtract(**fields).sort_by_peer_counter()
    b = pcol.SeqExtract(**fields).sort_by_peer_counter()
    for f in ("parent", "side", "peer", "counter", "deleted", "content", "valid"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    np.testing.assert_array_equal(b.parent, ex.parent)


def test_chain_columns_to_torch_preserves_dtypes(datasets):
    np_cols, _, _ = datasets["tracegen"]
    t = pfb.chain_columns_to_torch(np_cols, device="cpu")
    for f in pfb.ChainColumns._fields:
        a, x = getattr(np_cols, f), getattr(t, f)
        assert x.dtype == (torch.bool if a.dtype == np.bool_ else torch.int32), f
        np.testing.assert_array_equal(x.numpy(), a, err_msg=f)
    one = pfb.chain_columns_to_torch(pfb.ChainColumns(*[a[0] for a in np_cols]), device="cpu")
    assert one.c_parent.shape == (1, np_cols.c_parent.shape[1])
    bad = np_cols._replace(c_parent=np_cols.c_parent.astype(np.int64))
    with pytest.raises(TypeError):
        pfb.chain_columns_to_torch(bad, device="cpu")


# ---- ring, order, placement ---------------------------------------------


@pytest.mark.parametrize("name", ["tracegen", "loro"])
def test_ring_and_anchors_match_jax(datasets, name):
    np_cols, _, _ = datasets[name]
    t = pfb.chain_columns_to_torch(np_cols, device="cpu")
    succ, anchor = pfb._ring_and_anchors(t.c_parent, t.c_side, t.c_valid)
    assert succ.dtype == torch.int32 and anchor.dtype == torch.int32
    ring = jax.jit(jax.vmap(jfb._ring_and_anchors))
    js, ja = ring(*[jnp.asarray(a) for a in (np_cols.c_parent, np_cols.c_side, np_cols.c_valid)])
    np.testing.assert_array_equal(succ.numpy(), np.asarray(js))
    np.testing.assert_array_equal(anchor.numpy(), np.asarray(ja))


@pytest.mark.parametrize("algo", ["wyllie", "ruling", "blocked"])
@pytest.mark.parametrize("name", ["tracegen", "loro"])
def test_order_core_matches_jax(datasets, name, algo):
    np_cols, _, _ = datasets[name]
    t = pfb.chain_columns_to_torch(np_cols, device="cpu")
    got = pfb._order_core(t.c_parent, t.c_side, t.c_valid, rank_impl="torch:" + algo)
    core = jax.jit(jax.vmap(lambda p, s, v: jfb._order_core(p, s, v, rank_impl="xla:" + algo)))
    want = core(*[jnp.asarray(a) for a in (np_cols.c_parent, np_cols.c_side, np_cols.c_valid)])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _placement_inputs(rng, d=3, c=40, n=300):
    """Random chain layouts incl. rank keys that overflow int32 deltas."""
    head = np.sort(np.stack([rng.choice(np.arange(1, n), c - 1, replace=False) for _ in range(d)]), axis=1)
    head_row = np.concatenate([np.zeros((d, 1), np.int64), head], axis=1).astype(np.int32)
    n_valid = rng.integers(c // 2, c + 1, d)
    c_valid = np.arange(c)[None, :] < n_valid[:, None]
    crank = rng.integers(-(2**31), 2**31 - 1, (d, c), dtype=np.int64).astype(np.int32)
    crank[:, :3] = [2**31 - 1, -(2**31), 5]
    chain_id = np.stack([np.searchsorted(h, np.arange(n), side="right") - 1 for h in head_row]).astype(np.int32)
    visible = rng.random((d, n)) < 0.7
    content = rng.integers(0, 50000, (d, n)).astype(np.int32)
    return crank, c_valid, chain_id, head_row, visible, content


def test_sort_placement_matches_jax_with_int32_wraparound():
    rng = np.random.default_rng(21)
    for _ in range(3):
        crank, c_valid, _cid, head_row, visible, content = _placement_inputs(rng)
        got = pfb._place_by_chain_sort(*[torch.from_numpy(a) for a in (crank, c_valid, head_row, visible, content)])
        want = jax.jit(jax.vmap(jfb._place_by_chain_sort))(
            *[jnp.asarray(a) for a in (crank, c_valid, head_row, visible, content)]
        )
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("name", ["tracegen", "loro"])
def test_scatter_placement_and_positions_match_jax(datasets, name):
    np_cols, _, _ = datasets[name]
    t = pfb.chain_columns_to_torch(np_cols, device="cpu")
    crank = pfb._order_core(t.c_parent, t.c_side, t.c_valid, rank_impl="torch:wyllie")
    c = np_cols.c_parent.shape[1]
    visible = np_cols.valid & ~np_cols.deleted
    chain_id = np.where(np_cols.valid, np_cols.chain_id, c).astype(np.int32)
    args = (crank.numpy(), np_cols.c_valid, chain_id, np_cols.head_row, visible)
    got_pos = pfb.chain_positions(*[torch.from_numpy(np.ascontiguousarray(a)) for a in args])
    want_pos = jax.jit(jax.vmap(jfb.chain_positions))(*[jnp.asarray(a) for a in args])
    for g, w in zip(got_pos, want_pos):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    args = args + (np_cols.content,)
    got = pfb._place_by_chain_scatter(*[torch.from_numpy(np.ascontiguousarray(a)) for a in args])
    want = jax.jit(jax.vmap(jfb._place_by_chain_scatter))(*[jnp.asarray(a) for a in args])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---- the slice as a whole -------------------------------------------------


@pytest.mark.parametrize("place", ["sort", "scatter"])
@pytest.mark.parametrize("algo", ["wyllie", "ruling", "blocked"])
@pytest.mark.parametrize("name", ["tracegen", "loro"])
def test_chain_merge_matches_jax(datasets, name, algo, place):
    np_cols, texts, _ = datasets[name]
    t = pfb.chain_columns_to_torch(np_cols, device="cpu")
    jc = _jax_cols(np_cols)
    codes, counts = pfb.chain_merge_docs_v(t, rank_impl="torch:" + algo, place=place, device="cpu")
    jcodes, jcounts = jfb.chain_merge_docs_v(jc, rank_impl="xla:" + algo)
    assert codes.dtype == torch.int32 and counts.dtype == torch.int32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    cs, cs_counts = pfb.chain_merge_docs_checksum_v(t, rank_impl="torch:" + algo, place=place, device="cpu")
    jcs, _ = jfb.chain_merge_docs_checksum_v(jc, rank_impl="xla:" + algo)
    np.testing.assert_array_equal(cs.numpy(), np.asarray(jcs).astype(np.int64))
    np.testing.assert_array_equal(cs_counts.numpy(), np.asarray(jcounts))
    rk = pfb.chain_rank_checksum_v(t, rank_impl="torch:" + algo, device="cpu")
    jrk = jfb.chain_rank_checksum_v(jc, rank_impl="xla:" + algo)
    np.testing.assert_array_equal(rk.numpy(), np.asarray(jrk).astype(np.int64))
    for i, want in enumerate(texts):
        assert _text(codes[i], counts[i]) == want, f"doc {i}"


def test_default_entry_points_on_cpu(datasets):
    np_cols, texts, _ = datasets["tracegen"]
    t = pfb.chain_columns_to_torch(np_cols, device="cpu")
    codes, counts = pfb.chain_merge_docs(t, device="cpu")
    cs, _ = pfb.chain_merge_docs_checksum(t, device="cpu")
    jcs, _ = jfb.chain_merge_docs_checksum_v(_jax_cols(np_cols), rank_impl="xla:ruling")
    np.testing.assert_array_equal(cs.numpy(), np.asarray(jcs).astype(np.int64))
    assert [_text(codes[i], counts[i]) for i in range(len(texts))] == texts


def test_tracegen_oracle_equals_jax_merge(datasets):
    np_cols, texts, _ = datasets["tracegen"]
    jcodes, jcounts = jfb.chain_merge_docs_v(_jax_cols(np_cols), rank_impl="xla:wyllie")
    for i, want in enumerate(texts):
        assert _text(jcodes[i], jcounts[i]) == want


def test_weighted_checksum_matches_jax():
    rng = np.random.default_rng(5)
    codes = rng.integers(-1, 2**31 - 1, (3, 4000), dtype=np.int64).astype(np.int32)
    got = pfb._weighted_checksum(torch.from_numpy(codes))
    want = jax.jit(jfb._weighted_checksum)(jnp.asarray(codes))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("m", [5, 64, 257, 1000])
def test_plain_rank_algorithms_match_jax(m):
    from loro_tpu.ops.fugue_batch import _blocked_dist, _ruling_dist, _wyllie_dist

    rng = np.random.default_rng(m)
    rings = []
    for _ in range(3):
        live = rng.choice(m, size=rng.integers(2, m + 1), replace=False)
        p = rng.permutation(live).astype(np.int32)
        s = np.arange(m, dtype=np.int32)
        s[p[:-1]] = p[1:]
        rings.append(s)
    batch = torch.from_numpy(np.stack(rings))
    for k in (2, 8, 64):
        got = pfb._ruling_dist(batch, k=k).numpy()
        for row, s in zip(got, rings):
            np.testing.assert_array_equal(row, np.asarray(jax.jit(lambda x: _ruling_dist(x, k=k))(jnp.asarray(s))))
    got = pfb._wyllie_dist(batch).numpy()
    for row, s in zip(got, rings):
        np.testing.assert_array_equal(row, np.asarray(jax.jit(_wyllie_dist)(jnp.asarray(s))))
    for block in (128, 1024):
        got = pfb._blocked_dist(batch, block).numpy()
        for row, s in zip(got, rings):
            want = np.asarray(jax.jit(lambda x: _blocked_dist(x, block))(jnp.asarray(s)))
            np.testing.assert_array_equal(row, want, err_msg=f"block={block}")


def test_rank_spec_contract(monkeypatch):
    cpu = torch.device("cpu")
    cuda = torch.device("cuda")  # a device object needs no card
    cap = list_rank.RANK_MAX_M
    assert pfb._resolve_rank_spec(None, cpu, 1000) == ("torch", "ruling")
    assert pfb._resolve_rank_spec(None, cpu, cap + 2) == ("torch", "ruling")
    assert pfb._resolve_rank_spec("torch:wyllie", cpu, 1000) == ("torch", "wyllie")
    assert pfb._resolve_rank_spec("torch:blocked", cpu, 1000) == ("torch", "blocked")
    # auto route on a CUDA device: the shared-memory kernels up to the
    # cap, the sparse ruling kernel past it (where the JAX package takes
    # its XLA route); resolving counts nothing
    before = pfb.RANK_ROUTES["cuda:sparse/over_cap"]
    for m in (1000, 65538, cap):
        assert pfb._resolve_rank_spec(None, cuda, m) == ("cuda", "ruling")
    assert pfb._resolve_rank_spec(None, cuda, cap + 2) == ("cuda", "sparse")
    assert pfb.RANK_ROUTES["cuda:sparse/over_cap"] == before
    assert "torch:wyllie/over_cap" not in pfb.RANK_ROUTES  # the old over-cap route is gone
    # the merge counts the automatic over-cap route where it ranks (the
    # CUDA device's resolution stood in on the CPU, where sparse_rank runs
    # its plain version), and not an explicit torch:wyllie or torch:sparse
    from loro_tpu_torch import entry

    real = pfb._resolve_rank_spec
    monkeypatch.setattr(pfb, "_resolve_rank_spec",
                        lambda impl, dev, m: ("cuda", "sparse") if impl is None else real(impl, dev, m))
    cols = pfb.seq_columns_to_torch(entry.example_cols(d=1, n=64), device="cpu")
    want = pfb.materialize_content(cols, "torch:ruling", "cpu")
    for impl, counted in ((None, 1), ("torch:wyllie", 0), ("torch:sparse", 0)):
        routes = pfb.RANK_ROUTES["cuda:sparse/over_cap"]
        got = pfb.materialize_content(cols, impl, "cpu")
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert pfb.RANK_ROUTES["cuda:sparse/over_cap"] == routes + counted
    monkeypatch.undo()
    assert pfb._resolve_rank_spec("torch:wyllie", cuda, cap + 2) == ("torch", "wyllie")
    assert pfb._resolve_rank_spec("cuda:sparse", cuda, 1000) == ("cuda", "sparse")
    assert pfb._resolve_rank_spec("torch:sparse", cpu, cap + 2) == ("torch", "sparse")
    assert pfb._resolve_rank_spec("cuda:blocked", cuda, cap + 2) == ("cuda", "blocked")
    with pytest.raises(ValueError, match="too long"):
        list_rank.wyllie_rank(np.arange(cap + 2, dtype=np.int32), algo="blocked", device="cpu")
    for spec in ("cuda:ruling", "cuda:blocked", "cuda:sparse"):
        with pytest.raises(ValueError, match="CUDA"):
            pfb._resolve_rank_spec(spec, cpu, 1000)
    assert pfb._resolve_rank_spec("torch:coalesced", cpu, 1000) == ("torch", "coalesced")
    assert pfb._resolve_rank_spec("cuda:coalesced", cuda, cap + 2) == ("cuda", "coalesced")
    with pytest.raises(ValueError, match="CUDA"):
        pfb._resolve_rank_spec("cuda:coalesced", cpu, 1000)
    for spec in ("xla:wyllie", "pallas", "torch:bogus"):
        with pytest.raises(ConfigError):
            pfb._resolve_rank_spec(spec, cpu, 1000)


def test_place_validation(datasets):
    t = pfb.chain_columns_to_torch(datasets["tracegen"][0], device="cpu")
    with pytest.raises(ConfigError):
        pfb.chain_merge_docs_v(t, place="bogus", device="cpu")


# ---- tracegen -------------------------------------------------------------


def test_tracegen_is_seeded_and_keeps_the_ratio():
    a = tracegen.automerge_like_patches(4, 5000)
    b = tracegen.automerge_like_patches(4, 5000)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    n_ins = int(a[1].sum())
    assert n_ins == round(5000 * 182_315 / 259_778)
    d1 = tracegen.fleet_docs(1, n_patches=1500, seed=2, use_cache=False)
    d2 = tracegen.fleet_docs(1, n_patches=1500, seed=2, use_cache=False)
    for x, y in zip(d1, d2):
        assert x.text == y.text and np.array_equal(x.extract.parent, y.extract.parent)
    assert d1[0].n_peers == 1 and len(set(d1[1].extract.peer.tolist())) == 4
    # concurrency really happened: peers that started from an empty view
    # each placed a root child; the linear doc has exactly one
    assert int((d1[0].extract.parent < 0).sum()) == 1
    assert int((d1[1].extract.parent < 0).sum()) >= 2


def test_tracegen_cache_round_trip(tmp_path, monkeypatch):
    monkeypatch.setattr(tracegen, "CACHE_DIR", tmp_path)
    fresh = tracegen.fleet_docs(1, n_patches=800, seed=9)
    assert len(list(tmp_path.glob("trace_*.npz"))) == 2
    cached = tracegen.fleet_docs(1, n_patches=800, seed=9)
    for x, y in zip(fresh, cached):
        assert x.text == y.text and x.n_ops == y.n_ops and x.extract.peers == y.extract.peers
        for f in ("parent", "side", "peer", "counter", "deleted", "content", "valid"):
            np.testing.assert_array_equal(getattr(x.extract, f), getattr(y.extract, f))
        assert tracegen.oracle_text(y.extract) == y.text
