"""The port's element-level text merge (loro_tpu_torch.ops.fugue_batch:
fugue_order .. merge_docs_checksum, the row-order-free SeqColumnsU
variants, seq_columns_to_torch; ops.columnar.SeqExtract.to_seq_columns;
loro_tpu_torch.entry) against the JAX package, on the CPU.

Inputs: seeded tracegen tables (2000 patches), real Loro concurrent
variants from loro_tpu.bench_utils, the JAX entry's example batch, and
one test at the slice's width (N = 32,768, the wide-kernel domain)
reduced to two docs.  On the CPU the JAX merge takes its automatic
route (xla:wyllie); every port rank spec must give the same integers.
Tolerance: none — codes, counts, rank keys, rings and checksums are
integers and must be bit-identical.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from loro_tpu.ops import columnar as jcol
from loro_tpu.ops import fugue_batch as jfb
from loro_tpu.ops.pallas_rank import wyllie_rank as jax_wyllie_rank
from loro_tpu_torch import entry as pentry
from loro_tpu_torch import tracegen
from loro_tpu_torch.ops import columnar as pcol
from loro_tpu_torch.ops import fugue_batch as pfb
from loro_tpu_torch.ops import list_rank

ALGOS = ["wyllie", "ruling", "blocked"]
NAMES = ["tracegen", "loro", "example"]


def _port_extract(ex) -> pcol.SeqExtract:
    return pcol.SeqExtract(
        parent=ex.parent, side=ex.side, peer=ex.peer, counter=ex.counter,
        deleted=ex.deleted, content=ex.content, valid=ex.valid, peers=list(ex.peers),
    )


def _seq_batch(extracts, n: int) -> pfb.SeqColumns:
    return pcol.stack_docs([ex.to_seq_columns(pad_to=n) for ex in extracts])


def _u_batch(extracts, n: int, seed: int, anchor_p: float = 0.05) -> pfb.SeqColumnsU:
    """Row-shuffled SeqColumnsU (parents remapped, u64 peer ids split
    into halves); a share `anchor_p` of rows become content -1 anchors."""
    rng = np.random.default_rng(seed)
    per_doc = []
    for ex in extracts:
        perm = rng.permutation(ex.n)
        inv = np.empty(ex.n, np.int64)
        inv[perm] = np.arange(ex.n)
        par = ex.parent[perm]
        par = np.where(par >= 0, inv[np.maximum(par, 0)], -1).astype(np.int32)
        pid = np.asarray(ex.peers, np.uint64)[ex.peer[perm]]
        content = ex.content[perm].copy()
        content[rng.random(ex.n) < anchor_p] = -1
        fields = dict(
            parent=par, side=ex.side[perm], peer_hi=(pid >> np.uint64(32)).astype(np.uint32),
            peer_lo=(pid & np.uint64(0xFFFFFFFF)).astype(np.uint32), counter=ex.counter[perm],
            deleted=ex.deleted[perm], content=content, valid=ex.valid[perm],
        )
        fill = dict(parent=-1, side=0, peer_hi=0, peer_lo=0, counter=0, deleted=True, content=-1, valid=False)
        per_doc.append(pfb.SeqColumnsU(**{f: pcol.pad_rows(a, n, fill[f]) for f, a in fields.items()}))
    return pcol.stack_docs(per_doc)


@pytest.fixture(scope="module")
def datasets():
    """name -> (numpy SeqColumns [D, N], texts or None, numpy SeqColumnsU or None)."""
    from loro_tpu.bench_utils import concurrent_trace_variants

    gen = [d.extract for d in tracegen.fleet_docs(2, n_patches=2000, seed=7, use_cache=False)]
    variants = concurrent_trace_variants(n_variants=2, limit=2000, use_cache=False)
    loro = [_port_extract(v["extract"]) for v in variants]
    out = {}
    for name, exs, texts in (
        ("tracegen", gen, [tracegen.oracle_text(e) for e in gen]),
        ("loro", loro, [v["text"] for v in variants]),
    ):
        n = pfb.pad_bucket(max(e.n for e in exs))
        out[name] = (_seq_batch(exs, n), texts, _u_batch(exs, n, seed=len(name)))
    out["example"] = (pfb.SeqColumns(*graft._example_cols()), None, None)
    return out


def _jax_type(cols):
    return jfb.SeqColumnsU if isinstance(cols, pfb.SeqColumnsU) else jfb.SeqColumns


def _to_jax(cols):
    return _jax_type(cols)(*[jnp.asarray(a) for a in cols])


def _text(codes, count) -> str:
    return "".join(map(chr, np.asarray(codes)[: int(count)].tolist()))


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=msg)


# ---- host tables and transfer ---------------------------------------------


def test_to_seq_columns_and_pad_match_jax():
    doc = tracegen.fleet_docs(1, n_patches=600, seed=3, use_cache=False)[1]
    ex = doc.extract
    jex = jcol.SeqExtract(
        parent=ex.parent, side=ex.side, peer=ex.peer, counter=ex.counter,
        deleted=ex.deleted, content=ex.content, valid=ex.valid, peers=ex.peers,
    )
    for pad in (None, ex.n, 1024):
        a, b = jex.to_seq_columns(pad), ex.to_seq_columns(pad)
        for f in a._fields:
            assert getattr(a, f).dtype == getattr(b, f).dtype, f
            _eq(getattr(b, f), getattr(a, f), f)
        a, b = jfb.pad_seq_columns(jex.to_seq_columns(), 2048), pfb.pad_seq_columns(ex.to_seq_columns(), 2048)
        for f in a._fields:
            _eq(getattr(b, f), getattr(a, f), f)
    with pytest.raises(ValueError):
        ex.to_seq_columns(ex.n - 1)


def test_seq_columns_to_torch_dtypes(datasets):
    np_cols, _, np_u = datasets["tracegen"]
    t = pfb.seq_columns_to_torch(np_cols, device="cpu")
    assert isinstance(t, pfb.SeqColumns)
    for f in pfb.SeqColumns._fields:
        a, x = getattr(np_cols, f), getattr(t, f)
        assert x.dtype == (torch.bool if a.dtype == np.bool_ else torch.int32), f
        _eq(x.numpy(), a, f)
    u = pfb.seq_columns_to_torch(np_u, device="cpu")
    assert isinstance(u, pfb.SeqColumnsU)
    for f in pfb.SeqColumnsU._fields:
        a, x = getattr(np_u, f), getattr(u, f)
        want = {np.dtype(np.bool_): torch.bool, np.dtype(np.int32): torch.int32, np.dtype(np.uint32): torch.int64}
        assert x.dtype == want[a.dtype], f
        _eq(x.numpy(), a.astype(np.int64), f)
    one = pfb.seq_columns_to_torch(pfb.SeqColumns(*[a[0] for a in np_cols]), device="cpu")
    assert one.parent.shape == (1, np_cols.parent.shape[1])
    with pytest.raises(TypeError):
        pfb.seq_columns_to_torch(np_cols._replace(parent=np_cols.parent.astype(np.int64)), device="cpu")
    with pytest.raises(TypeError):
        pfb.seq_columns_to_torch(np_u._replace(peer_hi=np_u.peer_hi.astype(np.int32)), device="cpu")
    with pytest.raises(ValueError):
        pfb.seq_columns_to_torch(np_cols._replace(valid=np_cols.valid[:, :-1]), device="cpu")
    with pytest.raises(TypeError):
        pfb.seq_columns_to_torch(tuple(np_cols), device="cpu")


# ---- ring and order ----------------------------------------------------------


@pytest.mark.parametrize("name", ["tracegen", "loro"])
def test_ring_and_anchors_with_sib_keys_match_jax(datasets, name):
    _, _, np_u = datasets[name]
    u = pfb.seq_columns_to_torch(np_u, device="cpu")
    succ, anchor = pfb._ring_and_anchors(u.parent, u.side, u.valid, (u.peer_hi, u.peer_lo, u.counter))
    ring = jax.jit(
        jax.vmap(lambda p, s, v, hi, lo, c: jfb._ring_and_anchors(p, s, v, (hi, lo, c.astype(jnp.uint32))))
    )
    js, ja = ring(*[jnp.asarray(getattr(np_u, f)) for f in ("parent", "side", "valid", "peer_hi", "peer_lo", "counter")])
    _eq(succ.numpy(), js)
    _eq(anchor.numpy(), ja)


def test_sib_keys_sort_uint32_keys_unsigned():
    """Keys at and past 2**31 sort as uint32, as JAX's lexsort does."""
    rng = np.random.default_rng(2)
    n = 64
    parent = np.full((1, n), -1, np.int32)
    side = rng.integers(0, 2, (1, n)).astype(np.int32)
    valid = np.ones((1, n), bool)
    hi = rng.choice(np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.uint32), (1, n))
    lo = rng.integers(0, 2**32, (1, n), dtype=np.uint64).astype(np.uint32)
    ctr = rng.integers(0, 5, (1, n)).astype(np.int32)
    got = pfb._ring_and_anchors(
        *[torch.from_numpy(a) for a in (parent, side, valid)],
        tuple(torch.from_numpy(a.astype(np.int64)) for a in (hi, lo, ctr)),
    )
    want = jax.vmap(lambda p, s, v, a, b, c: jfb._ring_and_anchors(p, s, v, (a, b, c.astype(jnp.uint32))))(
        *[jnp.asarray(a) for a in (parent, side, valid, hi, lo, ctr)]
    )
    for g, w in zip(got, want):
        _eq(g.numpy(), w)


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("name", NAMES)
def test_fugue_order_matches_jax(datasets, name, algo):
    np_cols = datasets[name][0]
    t = pfb.seq_columns_to_torch(np_cols, device="cpu")
    got = pfb.fugue_order(t, rank_impl="torch:" + algo, device="cpu")
    assert got.dtype == torch.int32
    _eq(got.numpy(), jax.jit(jfb.fugue_order_batch)(_to_jax(np_cols)))


@pytest.mark.parametrize("name", NAMES)
def test_visible_order_matches_jax(datasets, name):
    np_cols = datasets[name][0]
    t = pfb.seq_columns_to_torch(np_cols, device="cpu")
    perm, count = pfb.visible_order(t, device="cpu")
    jperm, jcount = jax.jit(jfb.visible_order_batch)(_to_jax(np_cols))
    assert perm.dtype == torch.int32 and count.dtype == torch.int32
    _eq(perm.numpy(), jperm)
    _eq(count.numpy(), jcount)


# ---- materialization and the batch entry points ---------------------------


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("name", NAMES)
def test_merge_docs_match_jax(datasets, name, algo):
    np_cols, texts, _ = datasets[name]
    t = pfb.seq_columns_to_torch(np_cols, device="cpu")
    jc = _to_jax(np_cols)
    spec = "torch:" + algo
    jcodes, jcounts = jfb.merge_docs(jc)
    for fn in (pfb.materialize_content, pfb.materialize_content_batch, pfb.merge_docs):
        codes, counts = fn(t, rank_impl=spec, device="cpu")
        assert codes.dtype == torch.int32 and counts.dtype == torch.int32
        _eq(codes.numpy(), jcodes, fn.__name__)
        _eq(counts.numpy(), jcounts, fn.__name__)
    jcs, _ = jfb.merge_docs_checksum(jc)
    cs, cs_counts = pfb.merge_docs_checksum(t, rank_impl=spec, device="cpu")
    _eq(cs.numpy(), np.asarray(jcs).astype(np.int64))
    _eq(cs_counts.numpy(), jcounts)
    for i, want in enumerate(texts or []):
        assert _text(codes[i], counts[i]) == want, f"doc {i}"


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("name", ["tracegen", "loro"])
def test_row_order_free_table_matches_jax(datasets, name, algo):
    np_cols, texts, np_u = datasets[name]
    u = pfb.seq_columns_to_torch(np_u, device="cpu")
    ju = _to_jax(np_u)
    spec = "torch:" + algo
    rank = pfb.fugue_order_u(u, rank_impl=spec, device="cpu")
    _eq(rank.numpy(), jax.jit(jax.vmap(jfb.fugue_order_u))(ju))
    jcodes, jcounts = jfb.merge_docs_u(ju)
    for fn in (pfb.materialize_content_u, pfb.merge_docs_u):
        codes, counts = fn(u, rank_impl=spec, device="cpu")
        _eq(codes.numpy(), jcodes, fn.__name__)
        _eq(counts.numpy(), jcounts, fn.__name__)


def test_u_table_without_anchors_equals_sorted_merge():
    """The same docs as a row-shuffled U table (no anchor rows) and as a
    (peer, counter) sorted table merge to the same codes."""
    from loro_tpu.bench_utils import concurrent_trace_variants

    variants = concurrent_trace_variants(n_variants=2, limit=1500, use_cache=False)
    exs = [_port_extract(v["extract"]) for v in variants]
    n = pfb.pad_bucket(max(e.n for e in exs))
    np_u = _u_batch(exs, n, seed=3, anchor_p=0.0)
    codes, counts = pfb.merge_docs_u(pfb.seq_columns_to_torch(np_u, device="cpu"), device="cpu")
    s_codes, s_counts = pfb.merge_docs(pfb.seq_columns_to_torch(_seq_batch(exs, n), device="cpu"), device="cpu")
    _eq(codes.numpy(), s_codes.numpy())
    _eq(counts.numpy(), s_counts.numpy())
    _eq(codes.numpy(), jfb.merge_docs_u(_to_jax(np_u))[0])
    for i, v in enumerate(variants):
        assert _text(codes[i], counts[i]) == v["text"]


def test_entry_matches_graft_entry():
    fn, (cols,) = pentry.entry()
    for f in cols._fields:
        _eq(getattr(cols, f), getattr(graft._example_cols(), f), f)
    codes, counts = fn(cols, device="cpu")
    jfn, (jcols,) = graft.entry()
    jcodes, jcounts = jax.jit(jfn)(jfb.SeqColumns(*[jnp.asarray(a) for a in jcols]))
    _eq(codes.numpy(), jcodes)
    _eq(counts.numpy(), jcounts)
    assert int(counts[0]) == 256 - 256 // 7
    small = pentry.example_cols(d=2, n=64)
    codes, counts = fn(small, device="cpu")
    assert codes.shape == (2, 64) and int(counts[1]) == 64 - 64 // 7


def test_ring_past_the_kernel_cap_merges_on_cpu():
    """A 40,000-element right spine padded to N = 65,536 gives a ring of
    131,074 tokens, past RANK_MAX_M: the port's plain Wyllie (the route
    the CUDA default takes there) equals the JAX XLA merge."""
    n_el, n = 40_000, 65_536
    ex = pentry.example_cols(d=1, n=n_el)
    np_cols = pfb.SeqColumns(*[pcol.pad_rows(a[0], n, f) for a, f in zip(ex, (-1, 0, 0, 0, True, -1, False))])
    assert pfb.rank_bound(n) > list_rank.RANK_MAX_M
    t = pfb.seq_columns_to_torch(np_cols, device="cpu")
    codes, counts = pfb.merge_docs(t, rank_impl="torch:wyllie", device="cpu")
    jcodes, jcounts = jfb.merge_docs(_to_jax(pfb.SeqColumns(*[a[None] for a in np_cols])))
    _eq(codes.numpy(), jcodes)
    _eq(counts.numpy(), jcounts)
    want = "".join(chr(97 + i % 26) for i in range(n_el) if i % 7 != 6)
    assert _text(codes[0], counts[0]) == want
    succ, _ = pfb._ring_and_anchors(t.parent, t.side, t.valid)
    with pytest.raises(ValueError, match="too long"):  # an explicit kernel spec still raises
        list_rank.wyllie_rank(succ, device="cpu")


def test_ring_past_the_kernel_cap_merges_sparse_on_cpu():
    """The same over-cap doc through torch:sparse (the plain version of
    the sparse ruling kernel the CUDA default takes there) equals the JAX
    XLA merge, and its ring's distances equal _wyllie_dist."""
    n_el, n = 40_000, 65_536
    ex = pentry.example_cols(d=1, n=n_el)
    np_cols = pfb.SeqColumns(*[pcol.pad_rows(a[0], n, f) for a, f in zip(ex, (-1, 0, 0, 0, True, -1, False))])
    t = pfb.seq_columns_to_torch(np_cols, device="cpu")
    codes, counts = pfb.merge_docs(t, rank_impl="torch:sparse", device="cpu")
    jcodes, jcounts = jfb.merge_docs(_to_jax(pfb.SeqColumns(*[a[None] for a in np_cols])))
    _eq(codes.numpy(), jcodes)
    _eq(counts.numpy(), jcounts)
    succ, _ = pfb._ring_and_anchors(t.parent, t.side, t.valid)
    assert torch.equal(pfb._rank_dist(succ, "torch", "sparse"), pfb._wyllie_dist(succ))


# ---- the slice at its width (N = 32,768), two docs -------------------------


def test_slice_width_two_docs_match_jax():
    """Two tracegen docs of 40,000 patches (28,072 elements) padded to
    N = 32,768: ring 65,538 tokens, the wide kernel's domain.  JAX
    merge_docs_checksum equals the port's; the port's element ring
    through list_rank.wyllie_rank on the CPU (the wide plain version)
    equals the JAX wide kernel in interpret mode on the same ring."""
    docs = tracegen.fleet_docs(2, n_patches=40_000, seed=0, use_cache=False)[1:]
    n = 32_768
    assert all(pfb.pad_bucket(d.extract.n) == n for d in docs)
    np_cols = _seq_batch([d.extract for d in docs], n)
    t = pfb.seq_columns_to_torch(np_cols, device="cpu")
    cs, counts = pfb.merge_docs_checksum(t, device="cpu")
    jcs, jcounts = jfb.merge_docs_checksum(_to_jax(np_cols))
    _eq(cs.numpy(), np.asarray(jcs).astype(np.int64))
    _eq(counts.numpy(), jcounts)
    codes, counts = pfb.merge_docs(t, device="cpu")
    for i, d in enumerate(docs):
        assert _text(codes[i], counts[i]) == d.text
    succ, _ = pfb._ring_and_anchors(t.parent, t.side, t.valid)
    assert succ.shape == (2, 65_538) and list_rank.plan_rank(65_538).wide
    got = list_rank.wyllie_rank(succ[0], device="cpu")
    want = jax_wyllie_rank(jnp.asarray(succ[0].numpy()), interpret=True)
    _eq(got.numpy(), want)
