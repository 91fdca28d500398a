"""The port's resident MovableList batch (loro_tpu_torch.parallel.fleet.
DeviceMovableBatch) and its native delta explode
(native.explode_movable_delta_payload) against the JAX package on the CPU
(its DeviceMovableBatch on a one-device mesh), tracegen.oracle_movable and
LoroDoc lists.

Inputs: small tracegen.movable_doc traces fed one sync epoch a round;
random multi-peer LoroDoc rounds (inserts of runs, moves, sets, deletes,
values of every tag, idle docs and idle rounds) exported as one delta
payload a doc a round, so slot parents lie in earlier epochs; the revive
case (a move concurrent with a delete) and a set-only round.  Every
comparison is exact (tolerance: none): value lists, checkpoint bytes,
integer columns.
"""
import random

import jax
import numpy as np
import pytest

from loro_tpu import LoroDoc
from loro_tpu.codec.binary import decode_changes as jdecode
from loro_tpu.core.ids import ContainerID as JContainerID
from loro_tpu.core.ids import ContainerType as JContainerType
from loro_tpu.doc import strip_envelope
from loro_tpu.native import explode_movable_delta_payload as jexplode_delta
from loro_tpu.native import explode_movable_payload as jexplode
from loro_tpu.parallel.fleet import DeviceMovableBatch as JMovableBatch
from loro_tpu.parallel.mesh import make_mesh
from loro_tpu_torch import native as pnative
from loro_tpu_torch import tracegen
from loro_tpu_torch.codec.binary import decode_changes as pdecode
from loro_tpu_torch.codec.binary import read_tables
from loro_tpu_torch.core.ids import ContainerID, ContainerType
from loro_tpu_torch.errors import CodecDecodeError, DecodeError
from loro_tpu_torch.ops.lww import NEG
from loro_tpu_torch.parallel import fleet as pfleet
from loro_tpu_torch.parallel.fleet import DeviceMovableBatch
from loro_tpu_torch.storage import MemKvStore

PEERS = ((1 << 63) + (1 << 31) + 9, 5, (1 << 32) + 3)
VALUES = (1, "s", None, 2.5, True, -(2**40), "é☃")
JCID = JContainerID.root("l", JContainerType.MovableList)
PCID = ContainerID.root("l", ContainerType.MovableList)
JTRACE = JContainerID.root("list", JContainerType.MovableList)


def _mesh():
    return make_mesh(jax.devices()[:1])


def _pair(n_docs: int, cap: int, e_cap: int, auto_grow: bool = True):
    return (JMovableBatch(n_docs, cap, e_cap, mesh=_mesh(), auto_grow=auto_grow),
            DeviceMovableBatch(n_docs, cap, e_cap, device="cpu", auto_grow=auto_grow))


def _same(jb, pb) -> bytes:
    """Equal checkpoint bytes, capacities and epochs; the bytes."""
    blob = pb.export_state()
    assert blob == jb.export_state()
    assert (pb.seq.cap, pb.e_cap, pb.epoch) == (jb.seq.cap, jb.e_cap, jb.epoch)
    return blob


def _append(jb, pb, payloads, path: str, jcid=JCID, pcid=PCID) -> None:
    """One round into both batches: payloads, or their decoded changes
    (each package its own decode)."""
    if path == "payloads":
        jb.append_payloads(payloads, jcid)
        pb.append_payloads(payloads, pcid)
    else:
        jb.append_changes([jdecode(p) if p else None for p in payloads], jcid)
        pb.append_changes([pdecode(p) if p else None for p in payloads], pcid)


# ---- traces ------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """Three small movable traces and their epoch payloads (cached in a
    directory of their own)."""
    real = tracegen.CACHE_DIR
    tracegen.CACHE_DIR = tmp_path_factory.mktemp("tracegen")
    try:
        docs = [tracegen.movable_doc(s, n_elems=240, n_moves=120, n_sets=70, n_deletes=40, sync_every=70)
                for s in range(3)]
    finally:
        tracegen.CACHE_DIR = real
    return docs, [tracegen.movable_epoch_payloads(d) for d in docs]


@pytest.mark.parametrize("path", ["payloads", "changes"])
def test_device_movable_batch_matches_jax_every_epoch(traces, path):
    """The traces fed one sync epoch a round through append_payloads or
    append_changes, from 16 slots and 8 elements with auto_grow (both
    grow): after every epoch, value_lists() equals JAX's and
    oracle_movable of the prefix, and export_state() equals JAX's bytes
    for bytes; no payload falls back."""
    docs, eps = traces
    jb, pb = _pair(3, 16, 8)
    before = pfleet.FLEET_FALLBACKS["payload_decode"]
    n = max(map(len, eps))
    assert n >= 5
    for e in range(n):
        _append(jb, pb, [ep[e] if e < len(ep) else None for ep in eps], path, JTRACE, tracegen.MOVABLE_CID)
        got = pb.value_lists()
        assert got == jb.value_lists() == [tracegen.oracle_movable(d, e + 1) for d in docs], e
        _same(jb, pb)
    assert pb.seq.cap > 16 and pb.e_cap > 8 and pfleet.FLEET_FALLBACKS["payload_decode"] == before
    assert pb.stage_ms()["fold"] >= 0 and "explode" in pb.stage_ms()


def test_delta_explode_matches_jax_field_for_field(traces):
    """native.explode_movable_delta_payload against JAX's on every epoch
    payload (parents in earlier epochs come back as row -2 with their
    external ids) and on whole histories (no -2); the one-shot explode is
    unchanged on whole histories and rejects a delta."""
    _docs, eps = traces
    n_ext = 0
    whole = [tracegen.movable_payload(d) for d in _docs]
    for blob in [p for ep in eps for p in ep] + whole:
        target = read_tables(blob)[2].index(tracegen.MOVABLE_CID)
        jx, px = jexplode_delta(blob, target), pnative.explode_movable_delta_payload(blob, target)
        for part in ("slots", "sets", "dels"):
            assert list(jx[part]) == list(px[part])
            for f in jx[part]:
                assert jx[part][f].dtype == px[part][f].dtype and np.array_equal(jx[part][f], px[part][f]), (part, f)
        ext = px["slots"]["parent"] == -2
        assert np.array_equal(ext, px["slots"]["ext_peer_idx"] >= 0)
        n_ext += int(ext.sum())
    assert n_ext > 0
    for blob in whole:
        target = read_tables(blob)[2].index(tracegen.MOVABLE_CID)
        px = pnative.explode_movable_delta_payload(blob, target)
        assert not (px["slots"]["parent"] == -2).any()
        one = pnative.explode_movable_payload(blob, target)
        jone = jexplode(blob, target)
        for part in ("slots", "sets", "dels"):
            assert list(one[part]) == list(jone[part])
            for f in one[part]:
                assert np.array_equal(one[part][f], jone[part][f]) and np.array_equal(one[part][f], px[part][f])
    with pytest.raises(CodecDecodeError):
        pnative.explode_movable_payload(eps[0][1], read_tables(eps[0][1])[2].index(tracegen.MOVABLE_CID))


# ---- LoroDoc rounds ------------------------------------------------------------------------


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


def _rounds(seed: int, n_docs: int, n_rounds: int):
    """Per doc two peers editing "l" (moves and sets favour the first
    positions, so they meet concurrently), synced every round; each round
    gives a doc the delta its first peer exports since the last round
    (None for an idle doc; one round idle for all).  (docs, rounds)."""
    rng = random.Random(seed)
    docs = [(LoroDoc(peer=PEERS[0] + di), LoroDoc(peer=PEERS[2] + di)) for di in range(n_docs)]
    marks = [None] * n_docs
    idle = rng.randrange(1, n_rounds)
    rounds = []
    for r in range(n_rounds):
        payloads = []
        for di, (a, b) in enumerate(docs):
            if r == idle or rng.random() < 0.2:
                payloads.append(None)
                continue
            for d in (a, b):
                for _ in range(rng.randint(1, 5)):
                    _mv_edit(rng, d.get_movable_list("l"))
                d.commit()
            b.import_(a.export_updates(b.oplog_vv()))
            a.import_(b.export_updates(a.oplog_vv()))
            payloads.append(strip_envelope(a.export_updates(marks[di]) if marks[di] is not None
                                           else a.export_updates()))
            marks[di] = a.oplog_vv()
        rounds.append(payloads)
    return docs, rounds


@pytest.mark.parametrize("path", ["payloads", "changes"])
def test_random_rounds_match_jax_and_loro_doc(path):
    """Random LoroDoc rounds (idle docs, an idle round) through either
    append: equal bytes and value lists after every round, and the final
    lists equal each doc's LoroDoc list."""
    docs, rounds = _rounds(3, 4, 7)
    jb, pb = _pair(4, 16, 8)
    for payloads in rounds:
        _append(jb, pb, payloads, path)
        _same(jb, pb)
        assert pb.value_lists() == jb.value_lists()
    assert pb.value_lists() == [a.get_movable_list("l").get_value() for a, _ in docs]
    assert pb.epoch == jb.epoch > 0


def test_import_state_both_directions():
    """Each package imports the other's checkpoint; the restored batches
    then take the same rounds to equal bytes and lists."""
    _docs, rounds = _rounds(5, 3, 8)
    jb, pb = _pair(3, 32, 16)
    for payloads in rounds[:4]:
        _append(jb, pb, payloads, "payloads")
    blob = _same(jb, pb)
    p2 = DeviceMovableBatch.import_state(jb.export_state(), device="cpu")
    j2 = JMovableBatch.import_state(blob, mesh=_mesh())
    assert p2.export_state() == blob and j2.export_state() == blob
    assert p2.value_lists() == pb.value_lists() == j2.value_lists()
    for payloads in rounds[4:]:
        _append(j2, p2, payloads, "payloads")
        pb.append_payloads(payloads, PCID)
        assert _same(j2, p2) == pb.export_state()
    assert p2.value_lists() == j2.value_lists()


def test_capacity_errors_leave_the_batch_untouched_and_grow_works():
    """Past the slot or the element capacity without auto_grow: a
    RuntimeError from both packages and the bytes the batch had; grow
    (either capacity) then takes the same append; auto_grow grows both."""
    a = LoroDoc(peer=PEERS[1])
    a.get_movable_list("l").insert(0, *range(20))
    a.commit()
    p = strip_envelope(a.export_updates())
    for cap, e_cap, what in ((16, 64, "capacity exceeded"), (64, 8, "element capacity")):
        for b, cid in ((JMovableBatch(1, cap, e_cap, mesh=_mesh()), JCID),
                       (DeviceMovableBatch(1, cap, e_cap, device="cpu"), PCID)):
            before = b.export_state()
            with pytest.raises(RuntimeError, match=what):
                b.append_payloads([p], cid)
            assert b.export_state() == before and b.epoch == 0 and b.elem_ids[0] == {}
            b.grow(capacity=64, elem_capacity=64)
            b.append_payloads([p], cid)
            assert (b.seq.cap, b.e_cap) == (64, 64) and b.value_lists() == [list(range(20))]
    pb = DeviceMovableBatch(1, 16, 8, device="cpu", auto_grow=True)
    jb = JMovableBatch(1, 16, 8, mesh=_mesh(), auto_grow=True)
    pb.append_payloads([p], PCID)
    jb.append_payloads([p], JCID)
    assert (pb.seq.cap, pb.e_cap) == (32, 32) and _same(jb, pb)
    pb.grow(elem_capacity=16)  # never shrinks
    assert pb.e_cap == 32 and pb.value_lists() == [list(range(20))]


def test_corrupt_state_raises_decode_error():
    """A truncated meta, a winner row past the seq capacity, a value
    ordinal past the value store, an element ordinal at the element
    capacity and missing sections raise DecodeError."""
    _docs, rounds = _rounds(2, 2, 4)
    pb = DeviceMovableBatch(2, 64, 32, device="cpu", auto_grow=True)
    for payloads in rounds:
        pb.append_payloads(payloads, PCID)
    good = pb.export_state()
    assert DeviceMovableBatch.import_state(good, device="cpu").export_state() == good

    def patched(key: bytes, value: bytes) -> bytes:
        kv = MemKvStore()
        kv.import_all(good)
        kv.set(key, value)
        return kv.export_all()

    kv = MemKvStore()
    kv.import_all(good)
    meta = kv.get(b"meta")
    with pytest.raises(DecodeError, match="malformed meta"):
        DeviceMovableBatch.import_state(patched(b"meta", meta[:2]), device="cpu")
    with pytest.raises(DecodeError, match="implausible"):
        DeviceMovableBatch.import_state(patched(b"meta", bytes([2, 3, 2]) + meta[3:]), device="cpu")
    with pytest.raises(DecodeError, match="missing"):
        DeviceMovableBatch.import_state(_without(good, b"vals"), device="cpu")
    # a folded move whose winner row lies past the seq capacity
    e_cap, cap = pb.e_cap, pb.seq.cap
    grids = [g.copy() for g in pfleet._state_read_grid(kv.get(b"moves"), [((2, e_cap), dt) for dt in pfleet._LWW_GRID.values()])]
    grids[0][0, 0], grids[3][0, 0] = 7, cap
    with pytest.raises(DecodeError, match="winner row"):
        DeviceMovableBatch.import_state(patched(b"moves", _grid_blob(grids)), device="cpu")
    grids = [g.copy() for g in pfleet._state_read_grid(kv.get(b"vals"), [((2, e_cap), dt) for dt in pfleet._LWW_GRID.values()])]
    grids[3][1, 0] = len(pb.values[1])
    with pytest.raises(DecodeError, match="value ordinal"):
        DeviceMovableBatch.import_state(patched(b"vals", _grid_blob(grids)), device="cpu")
    w = pfleet.Writer()
    w.varint(1)
    w.u64le(PEERS[0])
    w.zigzag(0)
    w.varint(e_cap)
    with pytest.raises(DecodeError, match="elem ordinal"):
        DeviceMovableBatch.import_state(patched(b"doc/00000000/elems", bytes(w.buf)), device="cpu")
    with pytest.raises(DecodeError):
        DeviceMovableBatch.import_state(good[:-7], device="cpu")


def _grid_blob(arrays) -> bytes:
    w = pfleet.Writer()
    for a in arrays:
        w.bytes_(np.ascontiguousarray(a).tobytes())
    return bytes(w.buf)


def _without(blob: bytes, key: bytes) -> bytes:
    kv = MemKvStore()
    kv.import_all(blob)
    out = MemKvStore()
    for k, v in kv:
        if k != key:
            out.set(k, v)
    return out.export_all()


def test_cross_epoch_parent_resolves_through_the_id_map():
    """An insert and a move whose parents lie in an earlier epoch: the
    delta explode gives row -2, the batch resolves them through the id
    map (no fallback), equal to JAX and the LoroDoc."""
    a = LoroDoc(peer=PEERS[1])
    lst = a.get_movable_list("l")
    lst.insert(0, "x", "y", "z")
    a.commit()
    first = strip_envelope(a.export_updates())
    vv = a.oplog_vv()
    lst.insert(2, "w")
    lst.move(0, 3)
    a.commit()
    delta = strip_envelope(a.export_updates(vv))
    target = read_tables(delta)[2].index(PCID)
    out = pnative.explode_movable_delta_payload(delta, target)
    assert (out["slots"]["parent"] == -2).sum() == 2
    jb, pb = _pair(1, 16, 8)
    before = pfleet.FLEET_FALLBACKS["payload_decode"]
    for p in (first, delta):
        _append(jb, pb, [p], "payloads")
    assert pfleet.FLEET_FALLBACKS["payload_decode"] == before
    assert pb.value_lists() == jb.value_lists() == [lst.get_value()]
    _same(jb, pb)


def test_malformed_payload_falls_back_to_the_walk_once(monkeypatch):
    """A payload the native explode rejects is walked in Python, counted
    once in FLEET_FALLBACKS["payload_decode"], to the batch JAX builds
    without the fallback."""
    _docs, rounds = _rounds(9, 2, 5)
    jb, pb = _pair(2, 32, 16)
    bad = rounds[2][0] or rounds[2][1]
    assert bad is not None
    real = pnative.explode_movable_delta_payload

    def rejects(payload, target):
        if payload == bad:
            raise CodecDecodeError("rejected")
        return real(payload, target)

    monkeypatch.setattr(pnative, "explode_movable_delta_payload", rejects)
    before = pfleet.FLEET_FALLBACKS["payload_decode"]
    for payloads in rounds:
        _append(jb, pb, payloads, "payloads")
        _same(jb, pb)
    assert pfleet.FLEET_FALLBACKS["payload_decode"] == before + 1
    assert pb.value_lists() == jb.value_lists()


def test_revive_and_a_set_only_round():
    """a deletes x while b moves x (a newer slot): after the sync x is
    back; then a round of sets only (no slot rows: the move fold stays
    as it was).  Both appends, equal to JAX and the LoroDoc."""
    a, b = LoroDoc(peer=PEERS[1]), LoroDoc(peer=PEERS[0])
    a.get_movable_list("l").insert(0, "x", "y", "z")
    a.commit()
    r1 = strip_envelope(a.export_updates())
    vv = a.oplog_vv()
    b.import_(a.export_updates())
    a.get_movable_list("l").delete(0, 1)
    b.get_movable_list("l").move(0, 2)
    a.commit()
    b.commit()
    a.import_(b.export_updates(a.oplog_vv()))
    assert a.get_movable_list("l").get_value() == ["y", "z", "x"]
    r2 = strip_envelope(a.export_updates(vv))
    vv = a.oplog_vv()
    a.get_movable_list("l").set(0, 7)
    a.get_movable_list("l").set(2, "q")
    a.commit()
    r3 = strip_envelope(a.export_updates(vv))
    for path in ("payloads", "changes"):
        jb, pb = _pair(1, 16, 8)
        _append(jb, pb, [r1], path)
        _append(jb, pb, [r2], path)
        assert pb.value_lists() == jb.value_lists() == [["y", "z", "x"]]
        moves = [t.clone() for t in pb.moves]
        _append(jb, pb, [r3], path)
        assert all(np.array_equal(t.numpy(), m.numpy()) for t, m in zip(pb.moves, moves))
        assert pb.value_lists() == jb.value_lists() == [a.get_movable_list("l").get_value()] == [[7, "z", "q"]]
        _same(jb, pb)
        assert int((pb.moves.lamport[0] != NEG).sum()) == 3
