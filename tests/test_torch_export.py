"""The port's read plane (loro_tpu_torch.ops.export_batch: ExportIndex and
select_since_batch; core/version.VersionVector; oplog/oplog.trim_known_prefix;
export_select on every resident batch) against the JAX package on the CPU,
JAX's OpLog.changes_since and tracegen.oracle_export.

Inputs: multi-peer LoroDoc histories (text and list edits, random syncs)
exported as one delta payload a round, each package's index fed its own
decode of the same payloads; a request window that mixes empty, epoch-
boundary, straddling and absent-peer version vectors and a doc with no
rows.  Every comparison is exact (tolerance: none): row indices, bytes,
counters.
"""
import random

import numpy as np
import pytest
import torch

from loro_tpu import LoroDoc
from loro_tpu.codec.binary import decode_changes as jdecode
from loro_tpu.core.version import VersionVector as JVV
from loro_tpu.doc import frame_columnar_updates, strip_envelope
from loro_tpu.ops.export_batch import ExportIndex as JIndex
from loro_tpu.oplog.oplog import trim_known_prefix as jtrim
from loro_tpu_torch import tracegen
from loro_tpu_torch.codec.binary import decode_changes as pdecode
from loro_tpu_torch.core.change import Change, Op, SeqInsert, Side
from loro_tpu_torch.core.ids import ID, ContainerID, ContainerType
from loro_tpu_torch.core.version import Frontiers, VersionVector
from loro_tpu_torch.ops import export_batch as peb
from loro_tpu_torch.ops.export_batch import ExportIndex
from loro_tpu_torch.oplog.oplog import trim_known_prefix
from loro_tpu_torch.parallel.fleet import (DeviceCounterBatch, DeviceDocBatch, DeviceMapBatch, DeviceMovableBatch,
                                          DeviceTreeBatch)
from test_torch_fleet import _plain

# peers past 2^63, with a low half past 2^31, and small ones
PEERS = ((1 << 63) + (1 << 31) + 9, 5, (1 << 32) + 3)
ABSENT = (1 << 62) + 77  # a peer no doc has seen


def _one_char(peer: int, ctr: int) -> Change:
    """A one-op text change at (peer, ctr), lamport ctr."""
    return Change(ID(peer, ctr), ctr, Frontiers(), [Op(ctr, ContainerID.root("t", ContainerType.Text),
                                                       SeqInsert(None, Side.Right, "z"))])


def _vv_pair(m: dict):
    return VersionVector(m), JVV(m)


# ---- VersionVector and the trim ------------------------------------------------------


@pytest.mark.parametrize("m", [{}, {5: 3}, {PEERS[0]: 1, 5: 0, PEERS[2]: 2**31 - 1}, {7: 300, 1 << 40: 129}])
def test_version_vector_bytes_and_order_match_jax(m):
    """encode / decode, <=, merge, diff_spans and the JSON form equal
    JAX's; a truncated blob raises ValueError in both."""
    p, j = _vv_pair(m)
    assert p.encode() == j.encode()
    assert VersionVector.decode(j.encode()) == p and JVV.decode(p.encode()) == j
    other = {k: v + 1 for k, v in m.items()} | {11: 4}
    po, jo = _vv_pair(other)
    assert (p <= po, po <= p, p <= p) == (j <= jo, jo <= j, j <= j)
    assert [tuple(s) for s in p.diff_spans(po)] == [tuple(s) for s in j.diff_spans(jo)]
    assert [tuple(s) for s in po.diff_spans(p)] == [tuple(s) for s in jo.diff_spans(j)]
    p.merge(po)
    j.merge(jo)
    assert p.to_json() == j.to_json() and repr(p) == repr(j) and len(p) == len(j)
    if m:
        blob = p.encode()
        for bad in (blob[:-1], blob[:3]):
            with pytest.raises(ValueError):
                VersionVector.decode(bad)
            with pytest.raises(ValueError):
                JVV.decode(bad)


def _history(seed: int, rounds: int, doc_kinds=("text",)):
    """A 3-peer history (text and list edits, random partial syncs); per
    round, the delta peer 0's doc exports since its previous export,
    after syncing with the others: (payloads, the final doc)."""
    rng = random.Random(seed)
    docs = [LoroDoc(peer=p) for p in PEERS]
    mark = None
    payloads = []
    for _ in range(rounds):
        for _ in range(rng.randint(1, 4)):
            d = rng.choice(docs)
            t = d.get_text("t")
            n = len(t.to_string())
            if n and rng.random() < 0.3:
                p = rng.randrange(n)
                t.delete(p, min(rng.randint(1, 3), n - p))
            else:
                t.insert(rng.randint(0, n), "".join(rng.choice("abcxyz") for _ in range(rng.randint(1, 6))))
            if "list" in doc_kinds and rng.random() < 0.5:
                lst = d.get_list("l")
                lst.insert(rng.randint(0, len(lst.get_value())), rng.randint(0, 9))
            d.commit()
        for _ in range(2):
            a, b = rng.sample(docs, 2)
            b.import_(a.export_updates(b.oplog_vv()))
        for b in docs[1:]:
            docs[0].import_(b.export_updates(docs[0].oplog_vv()))
        payloads.append(strip_envelope(docs[0].export_updates(mark)) if mark is not None
                        else strip_envelope(docs[0].export_updates()))
        mark = docs[0].oplog_vv()
    return payloads, docs[0]


def test_trim_known_prefix_matches_jax():
    """Every change of a history with runs, cut at every counter inside
    it: the same id, lamport, deps and ops (the straddling run sliced,
    its parent the run's previous element)."""
    payloads = [p for seed in range(3) for p in _history(seed, 8, ("text", "list"))[0]]
    n_cuts = 0
    for blob in payloads:
        for jch, pch in zip(jdecode(blob), pdecode(blob)):
            for k in range(pch.ctr_start, pch.ctr_end + 1):
                assert _plain(trim_known_prefix(pch, k)) == _plain(jtrim(jch, k))
                n_cuts += 1
    assert n_cuts > 50


# ---- ExportIndex ----------------------------------------------------------------------


def _fed_pair(n_docs: int, rounds_by_doc, capacity: int = 8):
    """A JAX index and a CPU port index (capacity `capacity`, so both
    grow) fed each doc's rounds, each package its own decode; returns
    (jax index, port index, port change lists by doc, epoch-boundary VVs
    by doc)."""
    jx = JIndex(n_docs, capacity=capacity)
    px = ExportIndex(n_docs, capacity=capacity, device="cpu")
    fed = [[] for _ in range(n_docs)]
    bounds = [[{}] for _ in range(n_docs)]
    for di, rounds in enumerate(rounds_by_doc):
        for blob in rounds:
            pch = pdecode(blob)
            jx.note_changes(di, jdecode(blob))
            px.note_changes(di, pch)
            fed[di].extend(pch)
            bounds[di].append(dict(px.head_vv(di).items()))
    return jx, px, fed, bounds


def _window(rng: random.Random, n_docs: int, fed, bounds, empty_doc: int):
    """The mixed request window: per doc an empty VV, every epoch
    boundary, a straddling VV (a peer's counter inside a change of two
    or more ops), a VV naming an absent peer; and the doc with no rows."""
    reqs = []
    for di in range(n_docs):
        if di == empty_doc:
            reqs += [(di, {}), (di, {PEERS[0]: 3})]
            continue
        reqs.append((di, {}))
        reqs += [(di, dict(b)) for b in bounds[di]]
        long = [ch for ch in fed[di] if ch.ctr_end - ch.ctr_start > 1]
        for ch in rng.sample(long, min(3, len(long))):
            b = dict(rng.choice(bounds[di]))
            b[ch.peer] = ch.ctr_start + rng.randrange(1, ch.ctr_end - ch.ctr_start)
            reqs.append((di, b))
        b = dict(rng.choice(bounds[di]))
        b[ABSENT] = 5
        reqs.append((di, b))
    rng.shuffle(reqs)
    return reqs


def _histories():
    return [_history(s, 5, ("text", "list"))[0] for s in range(3)]


def test_select_matches_jax_changes_since_and_the_oracle():
    """The mixed window through both indexes (both grown past their
    capacity): equal row selections; equal to tracegen.oracle_export on
    the fed changes; and, per request, the selected rows, trimmed, are
    the changes JAX's OpLog.changes_since returns on a LoroDoc fed the
    same payloads, in its order."""
    rounds = _histories() + [[]]
    n_docs = len(rounds)
    jx, px, fed, bounds = _fed_pair(n_docs, rounds)
    assert px.report() == jx.report() and px.report()["capacity"] > 8
    assert px.rows_fed == sum(map(len, fed))  # LoroDoc deltas never repeat a change
    reqs = _window(random.Random(7), n_docs, fed, bounds, n_docs - 1)
    got = px.select([(di, VersionVector(m)) for di, m in reqs])
    want = jx.select([(di, JVV(m)) for di, m in reqs])
    assert len(got) == len(want) == len(reqs)
    loro = []
    for blobs in rounds:
        ld = LoroDoc(peer=1)
        for blob in blobs:
            ld.import_(frame_columnar_updates(jdecode(blob)))
        loro.append(ld)
    n_straddled = 0
    for (di, m), g, w in zip(reqs, got, want):
        assert g.dtype == np.int32 and np.array_equal(g, np.asarray(w))
        assert g.tolist() == tracegen.oracle_export(fed[di], m)
        mine = []
        for i in g.tolist():
            ch = px.changes[di][i]
            f = m.get(ch.peer, 0)
            n_straddled += ch.ctr_start < f
            if ch.ctr_start < f:
                ch = trim_known_prefix(ch, f)
            mine.append((ch.peer, ch.ctr_start, ch.ctr_end, ch.lamport))
        theirs = [(c.peer, c.ctr_start, c.ctr_end, c.lamport) for c in loro[di].oplog.changes_since(JVV(m))]
        assert mine == theirs
    assert n_straddled > 0 and any(len(g) == 0 for g in got) and any(len(g) > 5 for g in got)
    assert px.launches == jx.launches == 1


def test_select_orders_peers_as_unsigned_and_checks_doc_indices():
    """Rows tied on lamport order by the u64 peer (a peer past 2^63, and
    a high half past 2^31, after small ones); a doc index outside the
    index raises IndexError before any launch."""
    cid = ContainerID.root("t", ContainerType.Text)
    chs = [Change(ID(p, 0), 4, Frontiers(), [Op(0, cid, SeqInsert(None, Side.Right, "ab"))])
           for p in (PEERS[0], 5, PEERS[2], (1 << 31) + 1)]
    px = ExportIndex(1, device="cpu")
    px.note_changes(0, chs)
    (got,) = px.select([(0, VersionVector())])
    assert [px.changes[0][i].peer for i in got] == sorted(c.peer for c in chs)
    assert got.tolist() == tracegen.oracle_export(chs, {})
    with pytest.raises(IndexError):
        px.select([(1, VersionVector())])
    assert px.launches == 1


def test_prune_covers_grow_delta_and_warm():
    """prune_below drops rows under a frontier (straddlers stay) and
    advances the floor, so covers() refuses pulls from below it; the
    device copy follows a grow (full upload) and a commit to one doc (a
    delta of that doc's rows only); warm() runs every bucket and touches
    no state.  Both packages agree on every step."""
    rounds = _histories()
    jx, px, fed, bounds = _fed_pair(3, [r[:3] for r in rounds], capacity=64)
    win = [(di, VersionVector(b)) for di in range(3) for b in bounds[di]]
    jwin = [(di, JVV(dict(v.items()))) for di, v in win]

    def same():
        for g, w in zip(px.select(win), jx.select(jwin)):
            assert np.array_equal(g, np.asarray(w))

    same()
    dev0 = px._dev
    # a commit to doc 1 only: the next select uploads doc 1's rows
    uploads = []
    real = peb._scatter_rows
    peb._scatter_rows = lambda dev, host, docs: (uploads.append(docs.tolist()), real(dev, host, docs))
    try:
        for blob in rounds[1][3:]:
            px.note_changes(1, pdecode(blob))
            jx.note_changes(1, jdecode(blob))
        bounds[1].append(dict(px.head_vv(1).items()))
        same()
        win.append((1, VersionVector(bounds[1][-1])))
        jwin.append((1, JVV(bounds[1][-1])))
        same()
    finally:
        peb._scatter_rows = real
    assert uploads == [[1]] and px._dev[0] is dev0[0]
    assert torch.equal(px._dev[0], torch.from_numpy(px._hi.astype(np.int64)))
    # prune doc 0 below its second boundary
    floor = bounds[0][2]
    assert px.prune_below(0, VersionVector(floor)) == jx.prune_below(0, JVV(floor)) > 0
    assert px.covers(0, VersionVector(floor)) and not px.covers(0, VersionVector(bounds[0][1]))
    assert jx.covers(0, JVV(floor)) and not jx.covers(0, JVV(bounds[0][1]))
    assert px.prune_below(0, VersionVector(floor)) == 0
    win = [(di, v) for di, v in win if di or px.covers(0, v)]
    jwin = [(di, JVV(dict(v.items()))) for di, v in win]
    same()
    # past the capacity: a full upload of the grown grid
    px.note_changes(2, [_one_char(9, i) for i in range(70)])
    assert px._dev is None and px.report()["capacity"] == 128
    vv = px.head_vv(2)
    vv.set_end(9, 60)
    (got,) = px.select([(2, vv)])
    assert [px.changes[2][i].ctr_start for i in got] == list(range(60, 70))
    assert px._dev[0].shape == (3, 128)
    # warm: selections at 8, 16, 32 and 64 requests, the delta upload at 8 docs
    rep = dict(px.report())
    assert px.warm(40, max_peers=5) == jx.warm(40, max_peers=5) == 5 and px.warm_launches == 5
    assert {k: v for k, v in px.report().items() if k != "warm_launches"} == \
        {k: v for k, v in rep.items() if k != "warm_launches"}


def test_export_select_on_every_batch_returns_the_index_selection():
    """export_select of the five resident batches gives index.select's
    answer, under each batch's device lock."""
    rounds = _histories()
    _jx, px, fed, bounds = _fed_pair(3, rounds)
    reqs = [(di, VersionVector(b)) for di in range(3) for b in bounds[di][::2]]
    want = px.select(reqs)
    batches = [DeviceDocBatch(3, 16, device="cpu"), DeviceMapBatch(3, 4, device="cpu"),
               DeviceCounterBatch(3, 4, device="cpu"), DeviceTreeBatch(3, 16, 4, device="cpu"),
               DeviceMovableBatch(3, 16, 4, device="cpu")]
    for b in batches:
        held = []
        real = px.select

        def select(requests):
            held.append(b._dev_lock._is_owned())
            return real(requests)

        px.select = select
        try:
            got = b.export_select(px, reqs)
        finally:
            del px.select
        assert held == [True] and len(got) == len(want)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert px.launches == 1 + len(batches)


def test_select_on_tracegen_epochs_matches_the_oracle(tmp_path, monkeypatch):
    """Small text traces fed one sync epoch a round from their epoch
    payloads, as the chip's read-plane phase feeds them: every request of
    a seeded window equals oracle_export."""
    monkeypatch.setattr(tracegen, "CACHE_DIR", tmp_path)
    docs = tracegen.fleet_docs(1, n_patches=3000, seed=3, use_cache=False)
    eps = [[pdecode(p) for p in tracegen.epoch_payloads(d, use_cache=False)] for d in docs]
    px = ExportIndex(len(docs), device="cpu")
    for di, groups in enumerate(eps):
        for g in groups:
            px.note_changes(di, g)
    rng = random.Random(1)
    reqs = []
    for di, groups in enumerate(eps):
        vv: dict = {}
        ends = [{}]
        for g in groups:
            for ch in g:
                vv[ch.peer] = max(vv.get(ch.peer, 0), ch.ctr_end)
            ends.append(dict(vv))
        for _ in range(6):
            reqs.append((di, rng.choice(ends)))
    got = px.select([(di, VersionVector(m)) for di, m in reqs])
    for (di, m), g in zip(reqs, got):
        assert g.tolist() == tracegen.oracle_export(eps[di], m)
    assert sum(map(len, got)) > 0
