"""The port's rich-text merge (loro_tpu_torch.ops.richtext_batch, the
one-shot Fleet.merge_richtext_changes and DeviceDocBatch.richtexts) and
tracegen's rich-text traces, against the JAX package on the CPU.

Inputs: seeded numpy pair tables for _resolve_styles (no pairs, dead
ends, equal lamports on different peers, empty regions, keys past
n_keys - 1), multi-peer LoroDoc histories with marks, unmarks, deletes
and concurrent syncs, change lists edited to hold a dead start, a dead
end and an unpaired anchor, random LoroDoc rounds of 2-3 replicas a doc
for the resident batch, and small tracegen traces.  The JAX batches run
on a one-device mesh.  Every comparison is exact (tolerance: none):
integer arrays, pair rows, strings, segment lists.
"""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from loro_tpu import ExportMode, LoroDoc
from loro_tpu.codec.binary import decode_changes as jdecode
from loro_tpu.core.ids import ContainerID as JContainerID
from loro_tpu.core.ids import ContainerType as JContainerType
from loro_tpu.doc import frame_columnar_updates, strip_envelope
from loro_tpu.ops import fugue_batch as jfb
from loro_tpu.ops import richtext_batch as jrb
from loro_tpu.parallel.fleet import DeviceDocBatch as JBatch
from loro_tpu.parallel.fleet import Fleet as JFleet
from loro_tpu.parallel.mesh import make_mesh
from loro_tpu_torch import tracegen
from loro_tpu_torch.codec.binary import decode_changes as pdecode
from loro_tpu_torch.codec.binary import encode_changes as pencode
from loro_tpu_torch.core.change import Change, Op, SeqDelete, SeqInsert, StyleAnchor
from loro_tpu_torch.core.ids import ID, ContainerID, ContainerType, IdSpan
from loro_tpu_torch.core.version import Frontiers
from loro_tpu_torch.errors import LoroError
from loro_tpu_torch.ops import fugue_batch as pfb
from loro_tpu_torch.ops import richtext_batch as prb
from loro_tpu_torch.parallel.fleet import DeviceDocBatch, Fleet

PEERS = ((1 << 63) + (1 << 31) + 9, 5, (1 << 32) + 3)
KEYS = ("bold", "italic", "color", "link", "size")
VALUES = (True, "red", 7, {"h": 1}, None)
JCID = JContainerID.root("t", JContainerType.Text)
PCID = ContainerID.root("t", ContainerType.Text)


def _mesh():
    return make_mesh(jax.devices()[:1])


def _np(t):
    return np.asarray(t)


# ---- _resolve_styles on raw pair tables ---------------------------------------------


def _pair_table(rng, d: int, p: int, count: int, n_keys: int, case: str):
    """[D, P] pair columns and count [D] for one edge case."""
    key = rng.integers(0, n_keys + (3 if case == "keys_past" else 0), (d, p)).astype(np.int32)
    value = rng.integers(-1, 6, (d, p)).astype(np.int32)
    lam = rng.integers(0, 3 if case == "lamport_ties" else 1 << 20, (d, p)).astype(np.int32)
    peer = np.stack([rng.permutation(p) for _ in range(d)]).astype(np.int32) if p else np.zeros((d, 0), np.int32)
    valid = rng.random((d, p)) < 0.85
    cnt = rng.integers(0, count + 1, d).astype(np.int32)
    a_start = (rng.random((d, p)) * (cnt[:, None] + 1)).astype(np.int32)
    a_end = np.minimum(a_start + rng.integers(0, 9, (d, p)), cnt[:, None]).astype(np.int32)
    if case == "dead_ends":  # a deleted end anchor: the style runs to the count
        a_end = np.where(rng.random((d, p)) < 0.4, cnt[:, None], a_end).astype(np.int32)
    if case == "empty_regions":  # anchors stacked at a few positions
        a_start = rng.choice(np.array([0, 1]), (d, p)).astype(np.int32).clip(0, cnt[:, None])
        a_end = a_start.copy()
    a_start = np.where(valid, a_start, cnt[:, None])
    a_end = np.where(valid, a_end, cnt[:, None])
    return valid, key, value, lam, peer, a_start, a_end, cnt


@pytest.mark.parametrize("case,p", [("plain", 7), ("no_pairs", 0), ("dead_ends", 12), ("lamport_ties", 16),
                                    ("empty_regions", 9), ("keys_past", 10), ("one_pair", 1)])
def test_resolve_styles_matches_jax(case, p):
    """Batched _resolve_styles against the JAX function doc by doc."""
    rng = np.random.default_rng(sum(map(ord, case)) + p)
    n_keys = 4
    cols = _pair_table(rng, 9, p, 40, n_keys, case)
    bounds, win = prb._resolve_styles(*(torch.from_numpy(a) for a in cols), n_keys)
    assert bounds.dtype == torch.int32 and win.dtype == torch.int32
    assert tuple(bounds.shape) == (9, 2 * p + 2) and tuple(win.shape) == (9, 2 * p + 1, n_keys)
    for i in range(9):
        jb, jw = jrb._resolve_styles(*(jnp.asarray(a[i]) for a in cols[:7]), jnp.int32(cols[7][i]), n_keys)
        assert np.array_equal(bounds[i].numpy(), _np(jb)) and np.array_equal(win[i].numpy(), _np(jw)), (case, i)
    if p and case != "empty_regions":
        assert (win >= 0).any()


# ---- LoroDoc histories -----------------------------------------------------------------


def _rt_edit(rng: random.Random, t) -> None:
    u = rng.random()
    n = len(t)
    if n == 0 or u < 0.45:
        t.insert(rng.randint(0, n), rng.choice(["ab", "xyz", "m", "é☃", "\U0001f600q"]))
    elif u < 0.6:
        pos = rng.randint(0, n - 1)
        t.delete(pos, min(rng.randint(1, 3), n - pos))
    elif n >= 2:
        s = rng.randint(0, n - 2)
        e = rng.randint(s + 1, n)
        if rng.random() < 0.3:
            t.unmark(s, e, rng.choice(KEYS))
        else:
            t.mark(s, e, rng.choice(KEYS), rng.choice(VALUES[:4]))


def _history(seed: int, steps: int = 70):
    """A 3-peer LoroDoc history on text "t" with random syncs, fully
    synced at the end: (payload, the doc)."""
    rng = random.Random(seed)
    docs = [LoroDoc(peer=p + seed) for p in PEERS]
    for _ in range(steps):
        _rt_edit(rng, rng.choice(docs).get_text("t"))
        if rng.random() < 0.3:
            a, b = rng.sample(docs, 2)
            b.import_(a.export_updates(b.oplog_vv()))
    for _ in range(2):
        for a in docs:
            for b in docs:
                if a is not b:
                    b.import_(a.export_updates(b.oplog_vv()))
    return strip_envelope(docs[0].export_updates()), docs[0]


@pytest.fixture(scope="module")
def histories():
    return [_history(s) for s in range(6)]


def _edited_payload(payload: bytes) -> bytes:
    """The payload's changes plus a change that tombstones one mark's
    start anchor and another mark's end anchor, with the last mark's end
    anchor op dropped (an unpaired start): the three pairing edge cases."""
    changes = pdecode(payload)
    anchors = [(ch, op) for ch in changes for op in ch.ops
               if isinstance(op.content, SeqInsert) and isinstance(op.content.content, StyleAnchor)]
    starts = [(ch.peer, op.counter) for ch, op in anchors if op.content.content.is_start]
    assert len(starts) >= 3
    last_ch, last_op = anchors[-1]
    assert not last_op.content.content.is_start
    last_ch.ops.remove(last_op)
    if not last_ch.ops:
        changes.remove(last_ch)
    dead = (IdSpan(starts[0][0], starts[0][1], starts[0][1] + 1), IdSpan(starts[1][0], starts[1][1] + 1, starts[1][1] + 2))
    tail = changes[-1]
    changes.append(Change(ID(tail.peer, tail.ctr_end), tail.lamport_end, Frontiers([tail.last_id()]),
                          [Op(tail.ctr_end, PCID, SeqDelete(dead))]))
    return pencode(changes)


def _same_cols(jc, pc) -> None:
    jl, pl = jax.tree_util.tree_leaves(jc), jax.tree_util.tree_leaves(pc)
    assert len(jl) == len(pl)
    for a, b in zip(jl, pl):
        assert _np(a).dtype == _np(b).dtype and np.array_equal(_np(a), _np(b))


def test_explode_richtext_matches_jax_field_for_field(histories):
    """_explode_richtext and both extracts, field for field, on LoroDoc
    histories and on one edited to hold a dead start, a dead end and an
    unpaired start."""
    edited = _edited_payload(histories[0][0])
    for payload in [h[0] for h in histories] + [edited]:
        jex, jparr, jk, jv = jrb._explode_richtext(jdecode(payload), JCID)
        pex, pparr, pk, pv = prb._explode_richtext(pdecode(payload), PCID)
        for f in ("parent", "side", "peer", "counter", "deleted", "content", "valid"):
            assert np.array_equal(getattr(jex, f), getattr(pex, f)), f
        assert jex.peers == pex.peers and jk == pk and jv == pv
        assert jparr.dtype == pparr.dtype and np.array_equal(jparr, pparr)
        _same_cols(jrb.extract_richtext(jdecode(payload), JCID)[0], prb.extract_richtext(pdecode(payload), PCID)[0])
        _same_cols(jrb.extract_richtext_chain(jdecode(payload), JCID)[0],
                   prb.extract_richtext_chain(pdecode(payload), PCID)[0])
    _, parr, _, _ = prb._explode_richtext(pdecode(edited), PCID)
    n_before = prb._explode_richtext(pdecode(histories[0][0]), PCID)[1].shape[0]
    assert parr.shape[0] == n_before - 1 and (parr[:, 1] == -1).sum() >= 1 and (parr[:, 6] == 0).sum() >= 1


def _batch(payloads, pad_n=None):
    """Per-doc numpy RichtextChainCols and RichtextCols of the payloads at
    shared pads, the pads, the dictionaries."""
    chain = [prb.extract_richtext_chain(pdecode(p), PCID) for p in payloads]
    elem = [prb.extract_richtext(pdecode(p), PCID) for p in payloads]
    n = pad_n or pfb.pad_bucket(max(c.chain.chain_id.shape[0] for c, _, _ in chain))
    c_pad = pfb.pad_bucket(max(c.chain.c_parent.shape[0] for c, _, _ in chain))
    p = pfb.pad_bucket(max(1, max(c.pair_start.shape[0] for c, _, _ in chain)), floor=16)
    return chain, elem, (n, c_pad, p), [(k, v) for _, k, v in chain]


def _jax_stack(cols_list):
    return jax.tree_util.tree_map(lambda *a: jnp.asarray(np.stack(a)), *cols_list)


def test_batch_merges_match_jax_and_loro_doc(histories):
    """richtext_chain_merge_batch and richtext_merge_batch against the JAX
    vmapped batches on the same padded columns (a filler doc included),
    and their segments against each doc's get_richtext_value()."""
    payloads = [h[0] for h in histories] + [_edited_payload(histories[1][0])]
    chain, elem, (n, c_pad, p), dicts = _batch(payloads)
    n_keys = 8
    stacked = prb.stack_richtext_chain_cols([c for c, _, _ in chain], n, c_pad, p, len(chain) + 1)
    got = prb.richtext_chain_merge_batch(stacked, n_keys, device="cpu")
    padded = [jrb.pad_richtext_chain_cols(c, n, c_pad, p) for c, _, _ in chain]
    for jc, (c, _, _) in zip(padded, chain):
        _same_cols(jc, prb.pad_richtext_chain_cols(c, n, c_pad, p))
    _same_cols(_jax_stack(padded), jax.tree_util.tree_map(lambda a: a[: len(chain)], stacked))
    want = jrb.richtext_chain_merge_batch(_jax_stack(padded), n_keys)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and np.array_equal(g[: len(chain)].numpy(), _np(w))
    assert int(got[1][-1]) == 0 and bool((got[3][-1] == -1).all())  # the filler doc
    # the element path on the same docs
    ne = pfb.pad_bucket(max(c.seq.parent.shape[0] for c, _, _ in elem))
    ecols = []
    for c, _, _ in elem:
        pairs = {f: np.concatenate([getattr(c, f), np.full(p - getattr(c, f).shape[0], prb._PAIR_FILL[f],
                                                            getattr(c, f).dtype)]) for f in prb._PAIR_FIELDS}
        ecols.append(prb.RichtextCols(seq=pfb.pad_seq_columns(c.seq, ne), **pairs))
    enp = prb.RichtextCols(pfb.SeqColumns(*[np.stack([getattr(c.seq, f) for c in ecols]) for f in pfb.SeqColumns._fields]),
                           *[np.stack([getattr(c, f) for c in ecols]) for f in prb._PAIR_FIELDS])
    eg = prb.richtext_merge_batch(enp, n_keys, device="cpu")
    ew = jrb.richtext_merge_batch(_jax_stack(ecols), n_keys)
    for g, w in zip(eg, ew):
        assert np.array_equal(g.numpy(), _np(w))
    for i, (keys, values) in enumerate(dicts):
        segs = prb.segments_from_device(got[0][i].numpy(), got[1][i], got[2][i], got[3][i], keys, values)
        assert segs == jrb.segments_from_device(_np(want[0][i]), want[1][i], want[2][i], want[3][i], keys, values)
        assert segs == prb.segments_from_device(eg[0][i].numpy(), eg[1][i], eg[2][i], eg[3][i], keys, values)
        if i < len(histories):
            assert segs == histories[i][1].get_text("t").get_richtext_value()


def test_richtext_by_key_batch_matches_jax(histories):
    """The resident read on a DeviceDocBatch's columns and standing keys,
    with random pair rows (dead ends, invalid pairs, rows past the
    table), against the JAX function on the same arrays."""
    payloads = [h[0] for h in histories[:4]]
    pb = DeviceDocBatch(4, 256, device="cpu")
    pb.append_payloads(payloads, PCID)
    rng = np.random.default_rng(5)
    p = 24
    cols = [c.numpy() for c in pb.cols]
    kh, kl = pb.key_hi.numpy().astype(np.uint32), pb.key_lo.numpy().astype(np.uint32)
    n = cols[0].shape[1]
    pairs = prb.RichtextPairs(
        start=rng.integers(0, n + 3, (4, p)).astype(np.int32),
        end=rng.integers(-1, n, (4, p)).astype(np.int32),
        key=rng.integers(0, 5, (4, p)).astype(np.int32),
        value=rng.integers(-1, 4, (4, p)).astype(np.int32),
        lamport=rng.integers(0, 6, (4, p)).astype(np.int32),
        peer=rng.integers(0, 3, (4, p)).astype(np.int32),
        valid=rng.random((4, p)) < 0.8,
    )
    got = prb.richtext_by_key_batch(pb.cols, pb.key_hi, pb.key_lo, pairs, 4, device="cpu")
    jcols = jfb.SeqColumnsU(*[jnp.asarray(c.astype(np.uint32) if f in ("peer_hi", "peer_lo") else c)
                              for f, c in zip(pfb.SeqColumnsU._fields, cols)])
    want = jrb.richtext_by_key_batch(jcols, jnp.asarray(kh), jnp.asarray(kl),
                                     jrb.RichtextPairs(*(jnp.asarray(a) for a in pairs)), 4)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and np.array_equal(g.numpy(), _np(w))
    assert pb.texts() == [h[1].get_text("t").to_string() for h in histories[:4]]


@pytest.mark.parametrize("pad_docs", [None, 8, 6])
def test_fleet_merge_richtext_changes_matches_jax_and_loro_doc(histories, pad_docs):
    """merge_richtext_changes on 6 docs (one with the pairing edge cases)
    against JAX's Fleet and each LoroDoc's get_richtext_value()."""
    payloads = [h[0] for h in histories[:5]] + [_edited_payload(histories[5][0])]
    got = Fleet(device="cpu").merge_richtext_changes([pdecode(p) for p in payloads], PCID, pad_docs=pad_docs)
    want = JFleet(mesh=_mesh()).merge_richtext_changes([jdecode(p) for p in payloads], JCID)
    assert got == want and len(got) == 6
    assert got[:5] == [h[1].get_text("t").get_richtext_value() for h in histories[:5]]
    assert any("attributes" in s for segs in got for s in segs)


# ---- DeviceDocBatch.richtexts -----------------------------------------------------------


class _Replicas:
    """Each doc's 2-3 replicas editing rich text: every round some docs
    edit on every replica and sync, others stay idle; a doc's payload is
    its first replica's updates since the last round."""

    def __init__(self, rng: random.Random, n_docs: int):
        self.rng = rng
        self.docs = [[LoroDoc(peer=PEERS[(i + j) % 3] + 100 * i) for j in range(rng.randint(2, 3))]
                     for i in range(n_docs)]
        self.vv = [reps[0].oplog_vv() for reps in self.docs]

    def round(self):
        payloads = []
        for i, reps in enumerate(self.docs):
            if self.rng.random() < 0.25:
                payloads.append(None)
                continue
            for d in reps:
                for _ in range(self.rng.randint(1, 6)):
                    _rt_edit(self.rng, d.get_text("t"))
                d.commit()
            for a in reps:
                for b in reps:
                    if a is not b:
                        b.import_(a.export_updates(b.oplog_vv()))
            head = reps[0]
            payloads.append(strip_envelope(head.export(ExportMode.UpdatesInRange(self.vv[i], head.oplog_vv()))))
            self.vv[i] = head.oplog_vv()
        return payloads

    def richtexts(self):
        return [reps[0].get_text("t").get_richtext_value() for reps in self.docs]


@pytest.mark.parametrize("path", ["payloads", "changes"])
def test_device_doc_batch_richtexts_match_jax_every_round(path):
    """richtexts() of the port's resident batch against the JAX batch's
    and the replicas' get_richtext_value() after every round (the batch
    grows on the way)."""
    rng = random.Random(31)
    reps = _Replicas(rng, 4)
    jb = JBatch(4, 32, mesh=_mesh(), as_text=True, auto_grow=True)
    pb = DeviceDocBatch(4, 32, device="cpu", as_text=True, auto_grow=True)
    for r in range(6):
        payloads = reps.round()
        if path == "payloads":
            jb.append_payloads(payloads, JCID)
            pb.append_payloads(payloads, PCID)
        else:
            jb.append_changes([jdecode(p) if p else None for p in payloads], JCID)
            pb.append_changes([pdecode(p) if p else None for p in payloads], PCID)
        got = pb.richtexts()
        assert got == jb.richtexts() == reps.richtexts(), f"round {r}"
    assert pb.cap > 32 and set(pb.stage_ms()) == {"pairs", "sort", "fetch", "decode"}
    with pytest.raises(LoroError):
        DeviceDocBatch(1, 16, device="cpu", as_text=False).richtexts()


# ---- tracegen ------------------------------------------------------------------------------


def test_tracegen_richtext_oracle_agrees_with_loro_doc(tmp_path, monkeypatch):
    """A small rich-text trace imported epoch by epoch into a LoroDoc: after
    each epoch its get_richtext_value() equals oracle_richtext of that
    prefix; the trace has every key, unmarks, deletes and a bit-63 peer."""
    monkeypatch.setattr(tracegen, "CACHE_DIR", tmp_path)
    doc = tracegen.richtext_doc(3, n_chars=2_000, n_marks=160, sync_every=200)
    assert doc.n_epochs >= 3 and any(p >> 63 for p in doc.peers)
    ld = LoroDoc(peer=1)
    for e, p in enumerate(tracegen.richtext_epoch_payloads(doc)):
        ld.import_(frame_columnar_updates(jdecode(p)))
        assert tracegen.oracle_richtext(doc, e + 1) == ld.get_text("text").get_richtext_value(), f"epoch {e}"
    ops = [op.content for ch in doc.changes for op in ch.ops]
    anchors = [c.content for c in ops if isinstance(c, SeqInsert) and isinstance(c.content, StyleAnchor)]
    assert len(anchors) == 320 and any(a.value is None for a in anchors)
    assert {a.key for a in anchors} == set(tracegen.RICHTEXT_KEYS)
    assert any(isinstance(c, SeqDelete) for c in ops)


def test_tracegen_richtext_traces_through_every_port_path(tmp_path, monkeypatch):
    """Two small traces through merge_richtext_changes (their cached and
    fresh forms alike) and a DeviceDocBatch fed one epoch a round: the
    oracle's segments at every prefix."""
    monkeypatch.setattr(tracegen, "CACHE_DIR", tmp_path)
    docs = [tracegen.richtext_doc(s, n_chars=1_200, n_marks=90, sync_every=150) for s in range(2)]
    again = [tracegen.richtext_doc(s, n_chars=1_200, n_marks=90, sync_every=150) for s in range(2)]
    assert [tracegen.richtext_payload(d) for d in again] == [tracegen.richtext_payload(d) for d in docs]
    assert [d.epochs for d in again] == [d.epochs for d in docs] and len(list(tmp_path.iterdir())) == 2
    cid = tracegen.TEXT_CID
    want = [tracegen.oracle_richtext(d) for d in docs]
    assert Fleet(device="cpu").merge_richtext_changes([d.changes for d in again], cid) == want
    eps = [tracegen.richtext_epoch_payloads(d) for d in docs]
    pb = DeviceDocBatch(2, 256, device="cpu", as_text=True, auto_grow=True)
    for e in range(max(d.n_epochs for d in docs)):
        pb.append_payloads([ep[e] if e < len(ep) else None for ep in eps], cid)
        assert pb.richtexts() == [tracegen.oracle_richtext(d, e + 1) for d in docs]


# ---- the _order_core repair ------------------------------------------------------------------


def test_order_core_positional_call_matches_jax():
    """_order_core(parent, side, valid, sib_keys) with sib_keys in the
    fourth position, as the JAX package orders its parameters: equal
    ranks through both packages on a seeded forest with shuffled rows."""
    rng = np.random.default_rng(17)
    d, n = 3, 90
    parent = np.stack([np.where(rng.random(n) < 0.2, -1, (rng.random(n) * np.arange(n)).astype(np.int64))
                       for _ in range(d)]).astype(np.int32)
    side = rng.integers(0, 2, (d, n)).astype(np.int32)
    parent[:, 0] = -1
    valid = rng.random((d, n)) < 0.9
    keys = [rng.integers(0, 1 << 32, (d, n), dtype=np.uint64).astype(np.uint32) for _ in range(2)]
    keys.append(rng.permutation(d * n).reshape(d, n).astype(np.uint32))
    got = pfb._order_core(torch.from_numpy(parent), torch.from_numpy(side), torch.from_numpy(valid),
                          tuple(torch.from_numpy(k.astype(np.int64)) for k in keys))
    for i in range(d):
        want = jfb._order_core(jnp.asarray(parent[i]), jnp.asarray(side[i]), jnp.asarray(valid[i]),
                               tuple(jnp.asarray(k[i]) for k in keys))
        assert np.array_equal(got[i].numpy(), _np(want))
