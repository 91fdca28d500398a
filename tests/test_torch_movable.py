"""The port's one-shot MovableList merge (loro_tpu_torch.ops.movable_batch,
native.explode_movable_payload, Fleet.merge_movable_*) and tracegen's
movable traces, against the JAX package on the CPU.

Inputs: the JAX bench_movable's random columns at a small slot count,
with invalid rows and lamport ties; multi-peer LoroDoc histories
(inserts of runs, sets, deletes, moves, concurrent moves of one element
and a move concurrent with a delete, which revives the element; values
of every tag); seeded random resident folds for movable_by_key_batch;
and small tracegen traces.  Every comparison is exact (tolerance: none):
integer arrays, element dictionaries, decoded values, value lists.
"""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loro_tpu import LoroDoc
from loro_tpu.codec.binary import decode_changes as jdecode
from loro_tpu.core.ids import ContainerID as JContainerID
from loro_tpu.core.ids import ContainerType as JContainerType
from loro_tpu.doc import frame_columnar_updates, strip_envelope
from loro_tpu.native import explode_movable_payload as jexplode
from loro_tpu.ops import movable_batch as jmb
from loro_tpu.parallel.fleet import Fleet as JFleet
from loro_tpu.parallel.mesh import make_mesh
from loro_tpu_torch import native as pnative
from loro_tpu_torch import tracegen
from loro_tpu_torch.codec.binary import decode_changes as pdecode
from loro_tpu_torch.codec.binary import read_tables
from loro_tpu_torch.core.change import MovableMove
from loro_tpu_torch.core.ids import ContainerID, ContainerType
from loro_tpu_torch.ops import fugue_batch as pfb
from loro_tpu_torch.ops import movable_batch as pmb
from loro_tpu_torch.parallel import fleet as pfleet
from loro_tpu_torch.parallel.fleet import Fleet

PEERS = ((1 << 63) + (1 << 31) + 9, 5, (1 << 32) + 3)
VALUES = (1, "s", None, 2.5, True, -(2**40), "é☃")
JCID = JContainerID.root("l", JContainerType.MovableList)
PCID = ContainerID.root("l", ContainerType.MovableList)


def _mesh():
    return make_mesh(jax.devices()[:1])


def _np(t):
    return np.asarray(t)


def _jax_cols(cols):
    return jax.tree_util.tree_map(jnp.asarray, cols)


def _same(jx, px) -> None:
    jl, pl = jax.tree_util.tree_leaves(jx), jax.tree_util.tree_leaves(px)
    assert len(jl) == len(pl)
    for a, b in zip(jl, pl):
        assert _np(a).dtype == _np(b).dtype and np.array_equal(_np(a), _np(b))


def _check_merge(cols, n_elems: int):
    out, count = pmb.movable_merge_batch(cols, n_elems, device="cpu")
    jout, jcount = jmb.movable_merge_batch(_jax_cols(cols), n_elems)
    assert out.dtype == torch.int32 and count.dtype == torch.int32
    assert np.array_equal(out.numpy(), _np(jout)) and np.array_equal(count.numpy(), _np(jcount))
    return out, count


def _bench_cols(rng, d: int, s: int, invalid: float = 0.0, ties: bool = False):
    """bench_movable's columns (bench.py:437-473) at [d, s]: a spine of
    s / 2 creations, then moves of random elements under random slots;
    optionally invalid rows and lamports drawn from a few values."""
    n_elems = s // 2
    parent = np.concatenate([np.arange(-1, n_elems - 1), rng.integers(0, n_elems, s - n_elems)]).astype(np.int32)
    elem = np.concatenate([np.arange(n_elems), rng.integers(0, n_elems, s - n_elems)]).astype(np.int32)
    lam = np.concatenate([np.arange(n_elems), rng.integers(n_elems, 4 * n_elems, s - n_elems)]).astype(np.int32)
    if ties:
        lam[n_elems:] = rng.integers(n_elems, n_elems + 3, s - n_elems)
    tile = lambda a: np.broadcast_to(a, (d,) + a.shape).copy()  # noqa: E731
    valid = rng.random((d, s)) >= invalid
    seq = pfb.SeqColumns(
        parent=tile(parent), side=np.ones((d, s), np.int32),
        peer=rng.integers(0, 3, (d, s)).astype(np.int32) if ties else np.zeros((d, s), np.int32),
        counter=tile(np.arange(s, dtype=np.int32)), deleted=rng.random((d, s)) < (0.1 if ties else 0.0),
        content=tile(elem), valid=valid,
    )
    return pmb.MovableCols(
        seq=seq, lamport=tile(lam), set_elem=tile(np.arange(n_elems, dtype=np.int32)),
        set_lamport=rng.integers(0, 3, (d, n_elems)).astype(np.int32) if ties else np.zeros((d, n_elems), np.int32),
        set_peer=rng.integers(0, 3, (d, n_elems)).astype(np.int32) if ties else np.zeros((d, n_elems), np.int32),
        set_value=tile(np.arange(n_elems, dtype=np.int32)), set_valid=rng.random((d, n_elems)) >= invalid,
    ), n_elems


@pytest.mark.parametrize("s,invalid,ties", [(256, 0.0, False), (512, 0.0, False), (256, 0.1, True), (64, 0.3, True)])
def test_movable_merge_batch_matches_jax_on_bench_columns(s, invalid, ties):
    cols, n_elems = _bench_cols(np.random.default_rng(s + int(10 * invalid)), 3, s, invalid, ties)
    out, count = _check_merge(cols, n_elems)
    assert int(count.min()) > 0


# ---- LoroDoc histories ---------------------------------------------------------------


def _mv_edit(rng: random.Random, lst) -> None:
    n = len(lst)
    u = rng.random()
    if n == 0 or u < 0.35:
        lst.insert(rng.randint(0, n), *[rng.choice(VALUES) for _ in range(rng.randint(1, 3))])
    elif u < 0.5:
        p = rng.randrange(n)
        lst.delete(p, min(rng.randint(1, 2), n - p))
    elif u < 0.7:
        lst.set(rng.randrange(min(n, 4)) if rng.random() < 0.5 else rng.randrange(n), rng.choice(VALUES))
    elif n >= 2:
        a = rng.randrange(min(n, 4)) if rng.random() < 0.5 else rng.randrange(n)
        b = rng.randrange(n)
        if a != b:
            lst.move(a, b)


def _history(seed: int, steps: int = 90):
    """A 3-peer MovableList history on "l" with random syncs (moves and
    deletes favour the first positions, so they meet concurrently),
    fully synced at the end: (payload, the doc)."""
    rng = random.Random(seed)
    docs = [LoroDoc(peer=p + seed) for p in PEERS]
    for _ in range(steps):
        _mv_edit(rng, rng.choice(docs).get_movable_list("l"))
        if rng.random() < 0.25:
            a, b = rng.sample(docs, 2)
            b.import_(a.export_updates(b.oplog_vv()))
    for _ in range(2):
        for a in docs:
            for b in docs:
                if a is not b:
                    b.import_(a.export_updates(b.oplog_vv()))
    return strip_envelope(docs[0].export_updates()), docs[0]


def _revive():
    """a creates [x, y, z]; b syncs; a deletes x while b moves x to the
    end (a newer slot than the one a deleted); after the sync x is back,
    at the end.  (payload, the doc)."""
    a, b = LoroDoc(peer=PEERS[1]), LoroDoc(peer=PEERS[0])
    a.get_movable_list("l").insert(0, "x", "y", "z")
    b.import_(a.export_updates())
    a.get_movable_list("l").delete(0, 1)
    b.get_movable_list("l").move(0, 2)
    a.import_(b.export_updates(a.oplog_vv()))
    assert a.get_movable_list("l").get_value() == ["y", "z", "x"]
    return strip_envelope(a.export_updates()), a


@pytest.fixture(scope="module")
def histories():
    return [_history(s) for s in range(5)] + [_revive()]


def test_extracts_and_native_explode_match_jax(histories):
    """extract_movable, extract_movable_from_payload (values decoded) and
    native.explode_movable_payload, field for field."""
    for payload, _ in histories:
        _same(jmb.extract_movable(jdecode(payload), JCID)[0], pmb.extract_movable(pdecode(payload), PCID)[0])
        jc, je, jv = jmb.extract_movable(jdecode(payload), JCID)
        pc, pe, pv = pmb.extract_movable(pdecode(payload), PCID)
        assert je == pe and jv == pv
        jc, je, jv = jmb.extract_movable_from_payload(payload, JCID)
        pc, pe, pv = pmb.extract_movable_from_payload(payload, PCID)
        _same(jc, pc)
        assert je == pe and [v.get() for v in jv] == [v.get() for v in pv]
        assert all(isinstance(v, pmb.LazyPayloadValue) for v in pv)
        target = read_tables(payload)[2].index(PCID)
        jx, px = jexplode(payload, target), pnative.explode_movable_payload(payload, target)
        for part in ("slots", "sets", "dels"):
            assert list(jx[part]) == list(px[part])
            for f in jx[part]:
                assert jx[part][f].dtype == px[part][f].dtype and np.array_equal(jx[part][f], px[part][f]), (part, f)
    # a container the payload does not name: empty tables
    other = ContainerID.root("other", ContainerType.MovableList)
    cols, elems, values = pmb.extract_movable_from_payload(histories[0][0], other)
    assert cols.seq.parent.shape == (0,) and elems == [] and values == []


def test_movable_merge_batch_matches_jax_and_loro_doc(histories):
    """The batch merge of the histories (the revive case among them)
    against JAX and each LoroDoc's list."""
    extracts = [pmb.extract_movable(pdecode(p), PCID) for p, _ in histories]
    out, count = _check_merge(*pfleet._stack_movable(extracts))  # the Fleet's stacked columns
    for i, (_, _, values) in enumerate(extracts):
        assert [values[j] for j in out[i, : count[i]].tolist()] == histories[i][1].get_movable_list("l").get_value()


def test_movable_by_key_batch_matches_jax():
    """The resident read on random slot columns and folds: never-placed
    elements (win_lam NEG), dead and invalid winning slots, keys with the
    top bit set."""
    rng = np.random.default_rng(3)
    d, s, e = 4, 96, 40
    valid = rng.random((d, s)) < 0.9
    deleted = rng.random((d, s)) < 0.2
    keys = np.stack([rng.permutation(s) for _ in range(d)]).astype(np.int64)
    key_hi = ((keys * 2654435761) >> 5 & 0xFFFFFFFF).astype(np.uint32) | np.uint32(1 << 31)
    key_lo = (keys & 0xFFFFFFFF).astype(np.uint32)
    win_row = rng.integers(0, s, (d, e)).astype(np.int32)
    win_lam = np.where(rng.random((d, e)) < 0.15, pmb.NEG, rng.integers(0, 100, (d, e))).astype(np.int32)
    val_idx = rng.integers(-1, 50, (d, e)).astype(np.int32)
    args = (valid, deleted, key_hi, key_lo, win_row, win_lam, val_idx)
    out, count = pmb.movable_by_key_batch(*args, device="cpu")
    jout, jcount = jmb.movable_by_key_batch(*(jnp.asarray(a) for a in args))
    assert out.dtype == torch.int32 and np.array_equal(out.numpy(), _np(jout))
    assert np.array_equal(count.numpy(), _np(jcount)) and 0 < int(count.min()) < e


def test_fleet_movable_merges_match_jax_and_loro_doc(histories, monkeypatch):
    """merge_movable_changes, merge_movable_payloads and
    _merge_movable_extracted against JAX's Fleet and each LoroDoc's list;
    a payload the native explode rejects
    takes the counted Python decode; a payload that is not
    self-contained raises ValueError."""
    payloads = [p for p, _ in histories]
    want = [d.get_movable_list("l").get_value() for _, d in histories]
    fl = Fleet(device="cpu")
    jfl = JFleet(mesh=_mesh())
    assert fl.merge_movable_changes([pdecode(p) for p in payloads], PCID) == want
    assert jfl.merge_movable_changes([jdecode(p) for p in payloads], JCID) == want
    assert (fl._merge_movable_extracted([pmb.extract_movable(pdecode(p), PCID) for p in payloads])
            == jfl._merge_movable_extracted([jmb.extract_movable(jdecode(p), JCID) for p in payloads]) == want)
    before = pfleet.FLEET_FALLBACKS["payload_extract"]
    assert fl.merge_movable_payloads(payloads, PCID) == jfl.merge_movable_payloads(payloads, JCID) == want
    assert pfleet.FLEET_FALLBACKS["payload_extract"] == before
    real = pfleet.extract_movable_from_payload

    def rejects(payload, cid):
        if payload == payloads[2]:
            raise ValueError("rejected")
        return real(payload, cid)

    monkeypatch.setattr(pfleet, "extract_movable_from_payload", rejects)
    assert fl.merge_movable_payloads(payloads, PCID) == want
    assert pfleet.FLEET_FALLBACKS["payload_extract"] == before + 1
    monkeypatch.undo()
    a = LoroDoc(peer=PEERS[1])
    a.get_movable_list("l").insert(0, 1, 2)
    a.commit()
    vv = a.oplog_vv()
    a.get_movable_list("l").insert(1, 3)
    delta = strip_envelope(a.export_updates(vv))
    with pytest.raises(ValueError, match="not self-contained"):
        fl.merge_movable_payloads([delta], PCID)
    assert pfleet.FLEET_FALLBACKS["payload_extract"] == before + 2


# ---- tracegen ----------------------------------------------------------------------------


def test_tracegen_movable_oracle_agrees_with_loro_doc(tmp_path, monkeypatch):
    """A small movable trace imported epoch by epoch into a LoroDoc: after
    each epoch its list equals oracle_movable of that prefix.  The trace
    moves one element from two peers in one epoch and revives an element
    that a concurrent delete tombstoned."""
    monkeypatch.setattr(tracegen, "CACHE_DIR", tmp_path)
    doc = tracegen.movable_doc(4, n_elems=500, n_moves=250, n_sets=120, n_deletes=70, sync_every=120)
    assert doc.n_epochs >= 4 and any(p >> 63 for p in doc.peers)
    ld = LoroDoc(peer=1)
    for e, group in enumerate(doc.epoch_changes()):
        ld.import_(frame_columnar_updates(jdecode(tracegen.encode_changes(group))))
        assert tracegen.oracle_movable(doc, e + 1) == ld.get_movable_list("list").get_value(), f"epoch {e}"
    movers = {}
    for ch, e in zip(doc.changes, doc.epochs):
        for op in ch.ops:
            if isinstance(op.content, MovableMove):
                movers.setdefault((e, op.content.elem), set()).add(ch.peer)
    assert any(len(p) > 1 for p in movers.values())
    # revived: an element whose winning slot (largest (lamport, peer)) is
    # live while another of its slots is tombstoned
    seq = pmb.extract_movable(doc.changes, tracegen.MOVABLE_CID)[0].seq
    lamport = pmb.extract_movable(doc.changes, tracegen.MOVABLE_CID)[0].lamport
    win = {}
    for i, (e, k) in enumerate(zip(seq.content.tolist(), (lamport.astype(np.int64) << 32 | seq.peer).tolist())):
        if e not in win or k > win[e][0]:
            win[e] = (k, i)
    assert any(not seq.deleted[i] and seq.deleted[seq.content == e].any() for e, (_, i) in win.items())


def test_tracegen_movable_traces_through_the_fleet(tmp_path, monkeypatch):
    """Two small traces through merge_movable_payloads and
    merge_movable_changes against the oracle and JAX's Fleet."""
    monkeypatch.setattr(tracegen, "CACHE_DIR", tmp_path)
    docs = [tracegen.movable_doc(s, n_elems=300, n_moves=150, n_sets=80, n_deletes=40, sync_every=100)
            for s in range(2)]
    want = [tracegen.oracle_movable(d) for d in docs]
    payloads = [tracegen.movable_payload(d) for d in docs]
    fl = Fleet(device="cpu")
    assert fl.merge_movable_payloads(payloads, tracegen.MOVABLE_CID) == want
    assert fl.merge_movable_changes([d.changes for d in docs], tracegen.MOVABLE_CID) == want
    jcid = JContainerID.root("list", JContainerType.MovableList)
    assert JFleet(mesh=_mesh()).merge_movable_payloads(payloads, jcid) == want
