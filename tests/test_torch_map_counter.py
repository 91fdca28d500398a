"""The port's LWW-map and counter merges (loro_tpu_torch.ops.lww, the
one-shot Fleet.merge_map_docs / merge_counter_changes, the resident
DeviceMapBatch / DeviceCounterBatch) and what they stand on (the general
encoder codec.binary.encode_changes, columnar.extract_map_ops, the
native map explode, tracegen's map and counter traces), against the JAX
package on the CPU.

Inputs: seeded numpy columns (lamport ties, many ops a slot, pads, peer
halves of 2^31 and more, slots only a delete touches), fuzzed 2-3 peer
LoroDoc histories over every container kind and value tag, random
LoroDoc rounds of 2 replicas a doc editing two map containers or
counters (u64 peers past 2^63 among them), and small tracegen traces.
The JAX batches run on a one-device mesh.  Every comparison is exact
(tolerance: none): winner arrays, float32 sums bit for bit, payload and
checkpoint bytes.
"""
import random

import jax
import numpy as np
import pytest
import torch

from loro_tpu import LoroDoc
from loro_tpu.codec.binary import decode_changes as jdecode
from loro_tpu.codec.binary import encode_changes as jencode
from loro_tpu.core.ids import ContainerType as JContainerType
from loro_tpu.doc import frame_columnar_updates, strip_envelope
from loro_tpu.native import explode_map_payload as jexplode_map
from loro_tpu.ops import columnar as jcol
from loro_tpu.ops import lww as jlww
from loro_tpu.parallel.fleet import DeviceCounterBatch as JCounterBatch
from loro_tpu.parallel.fleet import DeviceMapBatch as JMapBatch
from loro_tpu.parallel.fleet import Fleet as JFleet
from loro_tpu.parallel.mesh import make_mesh
from loro_tpu_torch import tracegen
from loro_tpu_torch.codec.binary import decode_changes as pdecode
from loro_tpu_torch.codec.binary import encode_changes as pencode
from loro_tpu_torch.errors import DecodeError
from loro_tpu_torch.native import explode_map_payload as pexplode_map
from loro_tpu_torch.ops import columnar as pcol
from loro_tpu_torch.ops import lww as plww
from loro_tpu_torch.parallel import fleet as pfleet
from loro_tpu_torch.parallel.fleet import DeviceCounterBatch, DeviceMapBatch, Fleet
from loro_tpu_torch.storage import MemKvStore
from test_torch_fleet import _FUZZ, _crafted_payload, _fuzz_docs, _payload, _plain

# peers past 2^63, with a low half past 2^31, and small ones
PEERS = ((1 << 63) + (1 << 31) + 9, 5, (1 << 32) + 3, (1 << 31) + 7)
KEYS = "abcdefg"
MAP_VALUES = [None, True, False, -7, 2**40, 2.5, "v☃", b"\x00\xff", [1, "a", None], {"n": 2.5, "l": [True]}]
NEG = plww.NEG


def _mesh():
    return make_mesh(jax.devices()[:1])


def _t(a):
    """numpy -> torch on the CPU, uint32 as int64 holding it."""
    return pfleet._to_device(np.ascontiguousarray(a), torch.device("cpu"))


# ---- raw columns ------------------------------------------------------------------


def _map_cols(rng, d: int, m: int, s: int):
    """[d, m] op columns: slots crowded on a few (many ops a slot), lamport
    ties, a dozen peer ranks, 1 row in 5 a delete, pads at each doc's
    tail, slot s - 2 untouched and slot s - 1 touched by deletes only."""
    slot = rng.integers(0, s - 2, (d, m)).astype(np.int32)
    slot[:, ::7] = rng.integers(0, 3, (d, len(range(0, m, 7))))
    lam = rng.integers(0, 12, (d, m)).astype(np.int32)
    peer = rng.integers(0, 12, (d, m)).astype(np.int32)
    val = np.arange(d * m, dtype=np.int32).reshape(d, m)
    val[rng.random((d, m)) < 0.2] = -1
    only_del = rng.random((d, m)) < 0.05
    slot[only_del], val[only_del] = s - 1, -1
    valid = np.arange(m)[None, :] < rng.integers(m // 2, m + 1, (d, 1))
    return slot, lam, peer, val, valid


@pytest.mark.parametrize("seed", range(3))
def test_lww_merge_batch_matches_jax(seed):
    """The three winner arrays of every doc and slot, and the one-doc
    form, equal JAX's."""
    rng = np.random.default_rng(seed)
    d, m, s = 5, 96, 9 + seed
    cols = _map_cols(rng, d, m, s)
    want = jlww.lww_merge_batch(jlww.MapOpCols(*cols), s)
    got = plww.lww_merge_batch(plww.MapOpCols(*map(_t, cols)), s, device="cpu")
    for w, g in zip(want, got):
        assert g.dtype == torch.int32 and np.array_equal(g.numpy(), np.asarray(w))
    assert (np.asarray(want[0]) == -1).any() and (np.asarray(want[0]) == -2).any() and (np.asarray(want[0]) >= 0).any()
    one = plww.lww_merge_doc(plww.MapOpCols(*(_t(c[0]) for c in cols)), s)
    for w, g in zip(jlww.lww_merge_doc(jlww.MapOpCols(*(c[0] for c in cols)), s), one):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", range(3))
def test_counter_merge_batch_matches_jax_bit_for_bit(seed):
    """float32 sums of deltas no float32 sum holds exactly (tenths and
    thirds), with pads and invalid rows: the same bits as JAX's."""
    rng = np.random.default_rng(seed)
    d, m, s = 4, 128, 7
    slot = rng.integers(0, s, (d, m)).astype(np.int32)
    delta = (rng.integers(-50, 50, (d, m)) / np.where(rng.random((d, m)) < 0.5, 10.0, 3.0)).astype(np.float32)
    valid = rng.random((d, m)) < 0.8
    want = np.asarray(jlww.counter_merge_batch(slot, delta, valid, s))
    got = plww.counter_merge_batch(_t(slot), _t(delta), _t(valid), s, device="cpu")
    assert got.dtype == torch.float32 and got.numpy().tobytes() == want.tobytes()


def _resident(rng, d: int, s: int):
    """Random resident winners: untouched slots, lamports that tie the
    blocks', peer halves of 2^31 and more."""
    lam = rng.integers(0, 12, (d, s)).astype(np.int32)
    hi = rng.choice(np.array([0, 1, 2**31, 2**32 - 1], np.uint32), (d, s))
    lo = rng.choice(np.array([3, 2**31 + 7, 2**32 - 2], np.uint32), (d, s))
    val = rng.integers(-1, 1000, (d, s)).astype(np.int32)
    untouched = rng.random((d, s)) < 0.3
    lam[untouched], hi[untouched], lo[untouched], val[untouched] = NEG, 0, 0, -2
    return lam, hi, lo, val


@pytest.mark.parametrize("seed", range(3))
def test_lww_update_resident_matches_jax(seed):
    """Four blocks folded one after another into random winners: all four
    resident arrays equal JAX's after each (uint32 halves compared as
    uint32; a signed view would order halves of 2^31 and more first)."""
    rng = np.random.default_rng(seed)
    d, s, m = 4, 11, 64
    state = _resident(rng, d, s)
    # JAX gets copies: the port's int32 winners share memory with `state`
    # and are written in place, while the CPU JAX call may still read its
    # zero-copy inputs
    jres = jlww.LwwResident(*[np.array(a) for a in state])
    pres = plww.LwwResident(*map(_t, state))
    for _ in range(4):
        slot, lam, _peer, val, valid = _map_cols(rng, d, m, s)
        hi = rng.choice(np.array([0, 1, 2**31, 2**32 - 1], np.uint32), (d, m))
        lo = rng.choice(np.array([3, 2**31 + 7, 2**32 - 2], np.uint32), (d, m))
        jres = jlww.lww_update_resident(jres, slot, lam, hi, lo, valid, s, value=val)
        out = plww.lww_update_resident(pres, *map(_t, (slot, lam, hi, lo, valid)), s, value=_t(val))
        assert out is pres
        for f, dt in (("lamport", np.int32), ("peer_hi", np.uint32), ("peer_lo", np.uint32), ("value", np.int32)):
            assert np.array_equal(getattr(pres, f).numpy().astype(dt), np.asarray(getattr(jres, f))), f
    assert (np.asarray(jres.peer_hi) >= 2**31).any()
    with pytest.raises(TypeError):
        plww.lww_update_resident(pres, *map(_t, (slot, lam, hi, lo, valid)), s)


# ---- codec -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fuzz_payloads():
    return [_payload(_fuzz_docs(seed, n)[0]) for seed, n in _FUZZ] + [_crafted_payload()]


def test_encode_changes_matches_jax(fuzz_payloads):
    """Re-encoding each package's decode of fuzzed LoroDoc histories over
    every container kind and value tag (and the crafted payload: run
    continuations, unknown ops, container values, messages) gives the
    JAX encoder's bytes, which are the payload's own."""
    for p in fuzz_payloads:
        want = jencode(jdecode(p))
        assert want == p
        assert pencode(pdecode(p)) == want
    doc = tracegen.map_doc(4, n_ops=500, n_keys=30, sync_every=128)
    assert tracegen.map_payload(doc) == jencode(jdecode(tracegen.map_payload(doc)))
    cdoc = tracegen.counter_doc(4, n_incr=300, n_counters=9, epoch_incr=64)
    assert pencode(cdoc.changes) == jencode(jdecode(pencode(cdoc.changes)))


def test_explode_map_payload_matches_jax(fuzz_payloads):
    """Field for field on every map op of every container (peer_u64 and
    the value byte offsets included), and the tables."""
    pls = fuzz_payloads + [tracegen.map_payload(tracegen.map_doc(s, n_ops=400, n_keys=25, sync_every=100))
                           for s in range(2)]
    n_rows = 0
    for p in pls:
        want, got = jexplode_map(p), pexplode_map(p)
        for f in ("cid_idx", "key_idx", "lamport", "peer_rank", "value_ordinal", "value_offset"):
            assert np.array_equal(got[f], want[f]), f
        assert got["peer_u64"].dtype == np.uint64 and got["peer_u64"].tolist() == list(want["peer_u64"])
        assert got["peers"] == want["peers"] and got["keys"] == want["keys"]
        assert [repr(c) for c in got["cids"]] == [repr(c) for c in want["cids"]]
        n_rows += len(got["cid_idx"])
    assert n_rows > 800
    with pytest.raises(ValueError):
        pexplode_map(pls[-1][: len(pls[-1]) // 2])


# ---- one-shot fleet ----------------------------------------------------------------


def test_fleet_merge_map_docs_matches_jax_and_loro_doc(fuzz_payloads):
    """extract_map_ops of each package's decode (the port's columns equal
    JAX's), then both Fleets: equal winners; on tracegen map docs the
    result equals the LoroDoc state and the oracle."""
    docs = [tracegen.map_doc(s, n_ops=700, n_keys=40, sync_every=128) for s in range(3)]
    pls = fuzz_payloads + [tracegen.map_payload(d) for d in docs]
    jex = [jcol.extract_map_ops(jdecode(p)) for p in pls]
    pex = [pcol.extract_map_ops(pdecode(p)) for p in pls]
    for j, p in zip(jex, pex):
        for f in ("slot", "lamport", "peer", "value_idx", "valid"):
            assert np.array_equal(getattr(p, f), getattr(j, f)), f
        assert p.peers == j.peers and _plain(p.values) == _plain(j.values)
    want = JFleet(mesh=_mesh()).merge_map_docs(jex)
    got = Fleet(device="cpu").merge_map_docs(pex)
    assert _plain(got) == _plain(want)
    for d, out in zip(docs, got[len(fuzz_payloads):]):
        ld = LoroDoc(peer=1)
        ld.import_(frame_columnar_updates(jdecode(tracegen.map_payload(d))))
        assert out == ld.get_map("m").get_value() == tracegen.oracle_map(d)


def test_fleet_merge_counter_changes_matches_jax_and_loro_doc(fuzz_payloads):
    """Both Fleets give the same float32 sums bit for bit (the fuzz docs'
    deltas -2.5, 0.125 and the tracegen quarters; and tenths, which no
    float32 sum holds exactly); the tracegen sums equal the LoroDoc's and
    the float64 oracle's."""
    docs = [tracegen.counter_doc(s, n_incr=600, n_counters=12, epoch_incr=128) for s in range(2)]
    rng = random.Random(3)
    tenths = LoroDoc(peer=PEERS[0])
    for _ in range(60):
        tenths.get_counter(rng.choice("xy")).increment(rng.randint(-30, 30) / 10)
        tenths.commit()
    pls = fuzz_payloads + [pencode(d.changes) for d in docs] + [_payload(tenths)]
    want = JFleet(mesh=_mesh()).merge_counter_changes([jdecode(p) for p in pls])
    got = Fleet(device="cpu").merge_counter_changes([pdecode(p) for p in pls])
    assert [[(repr(c), np.float32(v).tobytes()) for c, v in m.items()] for m in got] == \
           [[(repr(c), np.float32(v).tobytes()) for c, v in m.items()] for m in want]
    assert any(got[:len(fuzz_payloads)])
    for d, out in zip(docs, got[len(fuzz_payloads):]):
        ld = LoroDoc(peer=1)
        ld.import_(frame_columnar_updates(jdecode(pencode(d.changes))))
        assert out == tracegen.oracle_counter(d)
        assert {c.name: v for c, v in out.items()} == {c.name: ld.get_counter(c.name).get_value() for c in out}


# ---- resident batches ------------------------------------------------------------------


def _map_rounds(seed: int, n_docs: int, n_rounds: int, containers=("m", "m2")):
    """(docs, rounds): each round, for every doc, the payload its first
    replica exports since the last round after two replicas edited maps
    `containers` (same key names in each; every value tag, a child
    container now and then; deletes) and synced, or None for a doc left
    alone; one round in which every doc is left alone."""
    rng = random.Random(seed)
    docs = []
    for i in range(n_docs):
        a, b = rng.sample(PEERS, 2)
        docs.append((LoroDoc(peer=a), LoroDoc(peer=b + i)))
    marks = [a.oplog_vv() for a, _ in docs]
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
                    m = d.get_map(rng.choice(containers))
                    u = rng.random()
                    if u < 0.2:
                        m.delete(rng.choice(KEYS))
                    elif u < 0.25:
                        m.set_container(rng.choice(KEYS), JContainerType.Map)
                    else:
                        m.set(rng.choice(KEYS), rng.choice(MAP_VALUES))
                d.commit()
            b.import_(a.export_updates(b.oplog_vv()))
            a.import_(b.export_updates(a.oplog_vv()))
            payloads.append(strip_envelope(a.export_updates(marks[di])))
            marks[di] = a.oplog_vv()
        rounds.append(payloads)
    return docs, rounds


def _map_pair(n_docs: int, cap: int, auto_grow: bool = True):
    return JMapBatch(n_docs, cap, mesh=_mesh(), auto_grow=auto_grow), DeviceMapBatch(n_docs, cap, device="cpu",
                                                                                      auto_grow=auto_grow)


def _same_map(jb, pb) -> bytes:
    blob = pb.export_state()
    assert blob == jb.export_state()
    assert pb.s == jb.s and pb.epoch == jb.epoch
    return blob


@pytest.mark.parametrize("path", ["payloads", "changes"])
@pytest.mark.parametrize("seed", range(2))
def test_device_map_batch_matches_jax_every_round(path, seed):
    """Random rounds through append_payloads (lazy value cells) or
    append_changes, from 2 slots with auto_grow (it grows): equal
    checkpoint bytes after every round (an all-idle round too), equal
    value maps, and the root maps equal each doc's LoroDoc state."""
    docs, rounds = _map_rounds(seed, 3, 5)
    jb, pb = _map_pair(3, 2)
    for payloads in rounds:
        if path == "payloads":
            jb.append_payloads(payloads)
            pb.append_payloads(payloads)
        else:
            jb.append_changes([jdecode(p) if p else None for p in payloads])
            pb.append_changes([pdecode(p) if p else None for p in payloads])
        _same_map(jb, pb)
    assert pb.s > 2 and pb.epoch == len(rounds)
    assert [[(_plain(cid), k, _plain(v)) for (cid, k), v in m.items()] for m in pb.value_maps()] == \
           [[(_plain(cid), k, _plain(v)) for (cid, k), v in m.items()] for m in jb.value_maps()]
    for name in ("m", "m2"):
        got = pb.root_value_maps(name)
        assert _plain(got) == _plain(jb.root_value_maps(name))
        for (a, _), g in zip(docs, got):
            want = a.get_map(name).get_value()
            assert {k: v for k, v in g.items() if type(v).__name__ != "ContainerID"} == \
                   {k: v for k, v in want.items() if k in g and type(g[k]).__name__ != "ContainerID"}
            assert set(g) == set(want)


def test_same_key_in_two_map_containers_does_not_collide():
    """One key name in two map containers of one doc: two slots, two
    winners."""
    a = LoroDoc(peer=1)
    a.get_map("m1").set("k", "v1")
    a.get_map("m2").set("k", "v2")
    a.commit()
    for append in ("append_payloads", "append_changes"):
        pb = DeviceMapBatch(1, 8, device="cpu")
        p = strip_envelope(a.export_updates())
        getattr(pb, append)([p if append == "append_payloads" else pdecode(p)])
        full = pb.value_maps()[0]
        assert len(full) == 2 and set(full.values()) == {"v1", "v2"}
        assert pb.root_value_maps("m1") == [{"k": "v1"}] and pb.root_value_maps("m2") == [{"k": "v2"}]


def test_map_import_state_both_directions():
    """Each package imports the other's checkpoint (lazy cells decoded on
    export) and the two then ingest the same rounds to equal bytes."""
    _docs, rounds = _map_rounds(5, 2, 6)
    jb, pb = _map_pair(2, 4)
    for payloads in rounds[:3]:
        jb.append_payloads(payloads)
        pb.append_payloads(payloads)
    blob = _same_map(jb, pb)
    p2 = DeviceMapBatch.import_state(jb.export_state(), device="cpu")
    j2 = JMapBatch.import_state(blob, mesh=_mesh())
    assert p2.export_state() == blob and j2.export_state() == blob
    for payloads in rounds[3:]:
        j2.append_payloads(payloads)
        p2.append_payloads(payloads)
        pb.append_payloads(payloads)
        assert _same_map(j2, p2) == pb.export_state()


def test_map_capacity_error_leaves_the_batch_untouched():
    """Past capacity without auto_grow: ValueError from both packages,
    slot maps, values, epoch and checkpoint bytes unchanged; a fitting
    append then lands as in JAX."""
    docs, rounds = _map_rounds(7, 2, 3, containers=("m",))
    jb, pb = _map_pair(2, 4, auto_grow=False)
    small = LoroDoc(peer=PEERS[1])
    small.get_map("m").set("a", 1)
    small.commit()
    first = [strip_envelope(small.export_updates()), None]
    jb.append_payloads(first)
    pb.append_payloads(first)
    before = _same_map(jb, pb)
    wide = LoroDoc(peer=PEERS[0])
    for k in "pqrstu":
        wide.get_map("m").set(k, k)
    wide.commit()
    big = [None, strip_envelope(wide.export_updates())]
    for b in (jb, pb):
        with pytest.raises(ValueError, match="slot capacity"):
            b.append_payloads(big)
        with pytest.raises(ValueError, match="slot capacity"):
            b.append_changes([None, (jdecode if b is jb else pdecode)(big[1])])
    assert _same_map(jb, pb) == before and pb.epoch == 1 and pb.values[1] == []
    jb.append_payloads(first[::-1])
    pb.append_payloads(first[::-1])
    _same_map(jb, pb)


def _counter_rounds(seed: int, n_docs: int, n_rounds: int):
    """Each round, every doc's payload since the last round after two
    replicas incremented counters (tenths, thirds and halves, several to
    a counter, so a block's sum and the resident one round differently
    from a running sum; a new counter each round, so a small batch
    grows) and synced, or None."""
    rng = random.Random(seed)
    docs = [(LoroDoc(peer=PEERS[0]), LoroDoc(peer=PEERS[2] + i)) for i in range(n_docs)]
    marks = [a.oplog_vv() for a, _ in docs]
    rounds = []
    for r in range(n_rounds):
        payloads = []
        for di, (a, b) in enumerate(docs):
            if rng.random() < 0.2:
                payloads.append(None)
                continue
            for d in (a, b):
                for _ in range(rng.randint(4, 12)):
                    d.get_counter(f"c{rng.randrange(2 + r)}").increment(rng.randint(-40, 40) / rng.choice((10, 3, 2)))
                d.commit()
            b.import_(a.export_updates(b.oplog_vv()))
            a.import_(b.export_updates(a.oplog_vv()))
            payloads.append(strip_envelope(a.export_updates(marks[di])))
            marks[di] = a.oplog_vv()
        rounds.append(payloads)
    return docs, rounds


@pytest.mark.parametrize("seed", range(2))
def test_device_counter_batch_matches_jax_every_round(seed):
    """append_changes rounds from 2 slots with auto_grow: equal
    checkpoint bytes (the float32 sums bit for bit) after every round,
    an empty append dated like JAX's; the values equal the LoroDoc's
    within float32 rounding; both directions of import."""
    docs, rounds = _counter_rounds(seed, 3, 5)
    jb = JCounterBatch(3, 2, mesh=_mesh(), auto_grow=True)
    pb = DeviceCounterBatch(3, 2, device="cpu", auto_grow=True)
    for payloads in rounds + [[None] * 3]:
        jb.append_changes([jdecode(p) if p else None for p in payloads])
        pb.append_changes([pdecode(p) if p else None for p in payloads])
        blob = pb.export_state()
        assert blob == jb.export_state() and pb.epoch == jb.epoch and pb.s == jb.s
    assert pb.s > 2 and pb.epoch == len(rounds) + 1
    for (a, _), m in zip(docs, pb.value_maps()):
        for cid, v in m.items():
            assert v == np.float32(v) and abs(v - a.get_counter(cid.name).get_value()) <= 1e-4
    assert DeviceCounterBatch.import_state(jb.export_state(), device="cpu").export_state() == blob
    assert JCounterBatch.import_state(blob, mesh=_mesh()).export_state() == blob


def test_counter_capacity_error_leaves_the_batch_untouched():
    a = LoroDoc(peer=3)
    for k in "xyz":
        a.get_counter(k).increment(1.5)
    a.commit()
    p = strip_envelope(a.export_updates())
    for b in (JCounterBatch(1, 2, mesh=_mesh()), DeviceCounterBatch(1, 2, device="cpu")):
        before = b.export_state()
        with pytest.raises(RuntimeError, match="slot capacity"):
            b.append_changes([(jdecode if isinstance(b, JCounterBatch) else pdecode)(p)])
        assert b.export_state() == before and b.epoch == 0 and b.slot_of[0] == {}


def test_corrupt_state_raises_decode_error():
    """A flipped byte, a truncated store, a value ordinal past the store,
    a slot past capacity and an implausible capacity raise DecodeError."""
    a = LoroDoc(peer=1)
    a.get_map("m").set("k", "v")
    a.get_counter("c").increment(2)
    a.commit()
    p = strip_envelope(a.export_updates())
    mb = DeviceMapBatch(1, 8, device="cpu")
    mb.append_payloads([p])
    cb = DeviceCounterBatch(1, 8, device="cpu")
    cb.append_changes([pdecode(p)])
    for cls, b in ((DeviceMapBatch, mb), (DeviceCounterBatch, cb)):
        blob = bytearray(b.export_state())
        blob[25] ^= 0xFF
        with pytest.raises(DecodeError):
            cls.import_state(bytes(blob), device="cpu")
        with pytest.raises(DecodeError):
            cls.import_state(b.export_state()[:-7], device="cpu")
        kv = MemKvStore()
        kv.import_all(b.export_state())
        kv.set(b"doc/00000000/slots", kv.get(b"doc/00000000/slots")[:-1] + b"\x08")  # slot 8 >= capacity 8
        with pytest.raises(DecodeError, match="slot index"):
            cls.import_state(kv.export_all(), device="cpu")
        kv.import_all(b.export_state())
        # version 3, 1 doc of width 1, capacity 2^32 - 1
        kv.set(b"meta", bytes([3, 1, 1]) + b"\xff\xff\xff\xff\x0f" + bytes([0, 1]))
        with pytest.raises(DecodeError, match="implausible slot_capacity"):
            cls.import_state(kv.export_all(), device="cpu")
    kv = MemKvStore()
    kv.import_all(mb.export_state())
    kv.set(b"doc/00000000/values", b"\x00")  # no values, one winning ordinal
    with pytest.raises(DecodeError, match="value ordinal"):
        DeviceMapBatch.import_state(kv.export_all(), device="cpu")


# ---- tracegen ------------------------------------------------------------------------


def test_tracegen_oracles_agree_with_loro_doc():
    """A small map trace and counter trace imported epoch by epoch into a
    LoroDoc: after each epoch its map equals oracle_map of that prefix,
    its counters oracle_counter's; a bit-63 peer id is among the map
    trace's peers."""
    doc = tracegen.map_doc(2, n_ops=900, n_keys=50, sync_every=200)
    assert doc.n_epochs == 5 and any(p >> 63 for p in doc.peers)
    assert doc.epoch_changes() and sum(len(g) for g in doc.epoch_changes()) == len(doc.changes)
    ld = LoroDoc(peer=1)
    for e, p in enumerate(tracegen.map_epoch_payloads(doc)):
        ld.import_(frame_columnar_updates(jdecode(p)))
        assert ld.get_map("m").get_value() == tracegen.oracle_map(doc, e + 1)
    tags = {type(op.content.value).__name__ for ch in doc.changes for op in ch.ops if not op.content.deleted}
    assert tags == {"int", "str", "float", "bool", "NoneType"}
    cdoc = tracegen.counter_doc(2, n_incr=640, n_counters=16, epoch_incr=128)
    ld = LoroDoc(peer=1)
    for e, group in enumerate(cdoc.epoch_changes()):
        ld.import_(frame_columnar_updates(jdecode(pencode(group))))
        want = tracegen.oracle_counter(cdoc, e + 1)
        assert {c.name: ld.get_counter(c.name).get_value() for c in want} == {c.name: v for c, v in want.items()}
    assert all(v * 4 == int(v * 4) for v in want.values())


def test_tracegen_epochs_feed_both_resident_batches_to_the_oracle():
    """map_epoch_payloads through both map batches (from 16 slots: they
    grow) and the counter epochs through both counter batches: equal
    bytes every round, and the oracles' prefixes."""
    docs = [tracegen.map_doc(s, n_ops=600, n_keys=60, sync_every=150) for s in range(2)]
    eps = [tracegen.map_epoch_payloads(d) for d in docs]
    jb, pb = _map_pair(2, 16)
    for e in range(docs[0].n_epochs):
        jb.append_payloads([ep[e] for ep in eps])
        pb.append_payloads([ep[e] for ep in eps])
        _same_map(jb, pb)
        assert pb.root_value_maps("m") == [tracegen.oracle_map(d, e + 1) for d in docs]
    assert pb.s == 64
    cdocs = [tracegen.counter_doc(s, n_incr=512, n_counters=40, epoch_incr=128) for s in range(2)]
    jc = JCounterBatch(2, 16, mesh=_mesh(), auto_grow=True)
    pc = DeviceCounterBatch(2, 16, device="cpu", auto_grow=True)
    for e in range(cdocs[0].n_epochs):
        jc.append_changes([jdecode(pencode(d.epoch_changes()[e])) for d in cdocs])
        pc.append_changes([d.epoch_changes()[e] for d in cdocs])
        assert pc.export_state() == jc.export_state()
        assert pc.value_maps() == [tracegen.oracle_counter(d, e + 1) for d in cdocs]
    assert pc.s == 64
