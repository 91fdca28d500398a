"""The port's resident text batch (loro_tpu_torch.parallel.fleet
.DeviceDocBatch) and what it stands on (parallel.order_maintenance,
parallel.idmap, the native order engine, id map and delta explode,
storage.kv, tracegen.epoch_payloads), against the JAX package on the
CPU.

Inputs: random rounds of 2-4 LoroDoc replicas a doc (u64 peers past
2^32 among them) editing text with marks or lists, synced every round;
each round's payload is strip_envelope(export_updates(vv)) of one
replica, so the same bytes go through both packages (and each
package's decode_changes gives the change lists).  The JAX batch runs
on a one-device mesh (tests/conftest.py forces 8 host devices, and the
JAX batch pads its doc axis to the mesh).  Every comparison is exact
(tolerance: none): keys, ids, rows and checkpoint bytes.
"""
import random

import jax
import numpy as np
import pytest
import torch

from loro_tpu import ExportMode, LoroDoc
from loro_tpu.codec.binary import decode_changes as jdecode
from loro_tpu.codec.binary import read_tables as jread_tables
from loro_tpu.core.ids import ContainerID as JContainerID
from loro_tpu.core.ids import ContainerType as JContainerType
from loro_tpu.doc import strip_envelope
from loro_tpu.errors import DecodeError as JDecodeError
from loro_tpu.errors import LoroError as JLoroError
from loro_tpu.native import decode_value_at as jvalue
from loro_tpu.native import explode_seq_anchor_meta as jexplode_anchor
from loro_tpu.native import explode_seq_delta_payload as jexplode_delta
from loro_tpu.obs import metrics as jobs
from loro_tpu.parallel import order_maintenance as jorder
from loro_tpu.parallel.fleet import DeviceDocBatch as JBatch
from loro_tpu.parallel.mesh import make_mesh
from loro_tpu.storage import MemKvStore as JKv
from loro_tpu_torch import native as pnative
from loro_tpu_torch import tracegen
from loro_tpu_torch.codec.binary import Reader
from loro_tpu_torch.codec.binary import decode_changes as pdecode
from loro_tpu_torch.codec.binary import read_tables as pread_tables
from loro_tpu_torch.core.change import SeqInsert
from loro_tpu_torch.core.ids import ContainerID, ContainerType
from loro_tpu_torch.errors import CodecDecodeError, DecodeError, LoroError
from loro_tpu_torch.ops import columnar as pcol
from loro_tpu_torch.parallel import fleet as pfleet
from loro_tpu_torch.parallel import order_maintenance as porder
from loro_tpu_torch.parallel.fleet import DeviceDocBatch
from loro_tpu_torch.parallel.idmap import PyIdMap
from loro_tpu_torch.storage import MemKvStore

PEERS = (1, 7, (1 << 33) + 5, (1 << 63) + 9)
LIST_VALUES = [1, "s", None, 2.5, {"n": [1, True]}, b"\x00\xff", -(2**40)]


def _mesh():
    return make_mesh(jax.devices()[:1])


def _cid(name: str, as_text: bool):
    kind = "Text" if as_text else "List"
    return JContainerID.root(name, JContainerType[kind]), ContainerID.root(name, ContainerType[kind])


# ---- order engines ----------------------------------------------------------------


def _random_rows(rng: random.Random, n: int, n_peers: int, hot: int):
    """n causally valid rows (parent row < row) of up to n_peers peers:
    run continuations, root inserts, and branch inserts crowded on the
    first `hot` rows (nested same-spot inserts, which exhaust key gaps and
    force renumbers)."""
    rows = []
    ctr = {}
    peers = PEERS[:n_peers]
    for r in range(n):
        peer = rng.choice(peers)
        c = ctr.get(peer, 0)
        u = rng.random()
        if r and u < 0.45 and rows[-1][2] == peer and rows[-1][3] == c - 1:
            parent, side = r - 1, 1  # run continuation
        elif r == 0 or u < 0.5:
            parent, side = -1, rng.randint(0, 1)
        elif u < 0.8:
            parent, side = rng.randrange(min(r, hot)), rng.randint(0, 1)
        else:
            parent, side = rng.randrange(r), rng.randint(0, 1)
        rows.append((parent, side, peer, c))
        ctr[peer] = c + 1
    return rows


@pytest.mark.parametrize("seed", range(4))
def test_shadow_order_keys_match_jax_and_native(seed):
    """The port's Python ShadowOrder against JAX's, and the port's native
    engine against its Python one, batch by batch: the same keys (or the
    same renumber), all_keys after every batch, renumber counts and
    split_keys."""
    rng = random.Random(seed)
    rows = _random_rows(rng, 1500, 2 + seed % 3, hot=4 + seed)
    j, p, nat = jorder.ShadowOrder(), porder.ShadowOrder(), pnative.native_order()
    base = 0
    while base < len(rows):
        k = rng.randint(1, 200)
        chunk = rows[base : base + k]
        cols = [np.asarray([r[i] for r in chunk], dt) for i, dt in enumerate((np.int32, np.int32, np.uint64, np.int64))]
        kj = j.append_rows(chunk, base)
        kp = p.append_rows(chunk, base)
        kn = nat.append_arrays(*cols, base)
        assert (kj is None) == (kp is None) == (kn is None)
        if kp is not None:
            assert kp == kj and np.array_equal(kn, np.asarray(kp, np.int64))
        all_p = np.asarray(p.all_keys(), np.int64)
        assert np.array_equal(all_p, np.asarray(j.all_keys(), np.int64))
        assert np.array_equal(nat.all_keys(), all_p)
        for a, b in zip(porder.split_keys(all_p), jorder.split_keys(all_p)):
            assert a.dtype == b.dtype == np.uint32 and np.array_equal(a, b)
        base += len(chunk)
    assert p.renumbers == j.renumbers == nat.renumbers and nat.n == len(rows)
    assert p.renumbers > 0 or seed == 0
    with pytest.raises(ValueError, match="non-contiguous"):
        nat.append_arrays(*[c[:1] for c in cols], base + 1)
    # ascending keys are a traversal order: unique
    assert len(np.unique(all_p)) == len(rows)
    assert (porder.KEY_STEP, porder.RUN_STEP, porder.KEY_BIAS) == (jorder.KEY_STEP, jorder.RUN_STEP, jorder.KEY_BIAS)


def test_split_keys_extremes_match_jax():
    keys = np.asarray([-(2**62), -1, 0, 1, 2**40, 2**62 - 1], np.int64)
    for a, b in zip(porder.split_keys(keys), jorder.split_keys(keys)):
        assert np.array_equal(a, b)
    hi, lo = porder.split_keys(keys)
    pairs = list(zip(hi.tolist(), lo.tolist()))
    assert pairs == sorted(pairs)


# ---- id maps ----------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_native_idmap_matches_pyidmap(seed):
    """A stage / lookup / commit / abort / insert fuzz: every lookup, get,
    membership test and length agree."""
    rng = random.Random(seed)
    nat, py = pnative.native_idmap(), PyIdMap()
    row = 0
    for _ in range(300):
        op = rng.random()
        n = rng.randint(0, 6)
        peer = np.asarray([rng.choice(PEERS) for _ in range(n)], np.uint64)
        ctr = np.asarray([rng.randint(0, 40) for _ in range(n)], np.int64)
        if op < 0.3:
            nat.stage_base(peer, ctr, row)
            py.stage_base(peer, ctr, row)
            row += n
        elif op < 0.45:
            nat.commit()
            py.commit()
        elif op < 0.55:
            nat.abort()
            py.abort()
        elif op < 0.65:
            rows = np.asarray([rng.randint(0, 999) for _ in range(n)], np.int32)
            nat.insert_arrays(peer, ctr, rows)
            py.insert_arrays(peer, ctr, rows)
        elif op < 0.7:
            d = {(int(p), int(c)): rng.randint(0, 999) for p, c in zip(peer, ctr)}
            nat.update(d)
            py.update(d)
        got = nat.lookup(peer, ctr)
        assert got.dtype == np.int32 and np.array_equal(got, py.lookup(peer, ctr))
        for p, c in zip(peer.tolist(), ctr.tolist()):
            assert nat.get((p, c)) == py.get((p, c)) and ((p, c) in nat) == ((p, c) in py)
        assert len(nat) == len(py) and bool(nat) == bool(py)
    with pytest.raises(KeyError):
        nat[(12345, 1)]


# ---- the delta explode ------------------------------------------------------------


def _edit_text(rng: random.Random, doc: LoroDoc, marks: bool) -> None:
    t = doc.get_text("t")
    for _ in range(rng.randint(1, 8)):
        u = rng.random()
        if len(t) and u < 0.3:
            pos = rng.randint(0, len(t) - 1)
            t.delete(pos, min(rng.randint(1, 3), len(t) - pos))
        elif marks and len(t) >= 2 and u < 0.42:
            s = rng.randint(0, len(t) - 2)
            t.mark(s, rng.randint(s + 1, len(t)), rng.choice(["bold", "link"]), rng.choice([True, "u", {"h": 1}]))
        else:
            t.insert(rng.randint(0, len(t)), rng.choice(["ab", "z", "qrs", "é☃", "\U0001f600x"]))


def _edit_list(rng: random.Random, doc: LoroDoc) -> None:
    lst = doc.get_list("t")
    for _ in range(rng.randint(1, 6)):
        if len(lst) and rng.random() < 0.3:
            lst.delete(rng.randint(0, len(lst) - 1), 1)
        else:
            lst.insert(rng.randint(0, len(lst)), rng.choice(LIST_VALUES))


class _Replicas:
    """Each doc's 2-4 replicas: every round some docs edit on every
    replica and sync, others stay idle; the round's payload of a doc is
    its first replica's updates since the last round."""

    def __init__(self, rng: random.Random, n_docs: int, as_text: bool = True, marks: bool = True):
        self.rng = rng
        self.as_text = as_text
        self.marks = marks
        self.docs = []
        for i in range(n_docs):
            k = rng.randint(2, 4)
            self.docs.append([LoroDoc(peer=PEERS[(i + j) % len(PEERS)] + 100 * i) for j in range(k)])
        self.marks_vv = [reps[0].oplog_vv() for reps in self.docs]

    def round(self, idle: float = 0.3):
        """(payloads, JAX change lists, port change lists): None for idle docs."""
        payloads = []
        for i, reps in enumerate(self.docs):
            if self.rng.random() < idle:
                payloads.append(None)
                continue
            for d in reps:
                if self.as_text:
                    _edit_text(self.rng, d, self.marks)
                else:
                    _edit_list(self.rng, d)
                d.commit()
            for a in reps:
                for b in reps:
                    if a is not b:
                        b.import_(a.export_updates(b.oplog_vv()))
            head = reps[0]
            payloads.append(strip_envelope(head.export(ExportMode.UpdatesInRange(self.marks_vv[i], head.oplog_vv()))))
            self.marks_vv[i] = head.oplog_vv()
        jch = [jdecode(p) if p else None for p in payloads]
        pch = [pdecode(p) if p else None for p in payloads]
        return payloads, jch, pch

    def texts(self):
        return [reps[0].get_text("t").to_string() for reps in self.docs]

    def values(self):
        return [reps[0].get_list("t").get_value() for reps in self.docs]


def test_delta_explode_matches_jax_field_for_field():
    """Multi-epoch payloads with parents in earlier epochs (parent -2),
    deletes of rows from earlier epochs and marks (anchor metadata with
    values): every column of the delta explode and the anchor pass, and
    the anchors' decoded values."""
    rng = random.Random(5)
    reps = _Replicas(rng, 3)
    jcid, cid = _cid("t", True)
    seen_ext = seen_del = seen_anchor = 0
    for _ in range(5):
        payloads, _, _ = reps.round(idle=0.0)
        for p in payloads:
            _, _, jcids, _ = jread_tables(p)
            _, _, cids, _ = pread_tables(p)
            target = cids.index(cid)
            assert jcids.index(jcid) == target
            want, got = jexplode_delta(p, target), pnative.explode_seq_delta_payload(p, target)
            assert set(got) == set(want)
            for f in want:
                assert got[f].dtype == want[f].dtype and np.array_equal(got[f], want[f]), f
            seen_ext += int((got["parent"] == -2).sum())
            seen_del += len(got["del_start"])
            want_a, got_a = jexplode_anchor(p, target), pnative.explode_seq_anchor_meta(p, target)
            assert set(got_a) == set(want_a)
            for f in want_a:
                assert got_a[f].dtype == want_a[f].dtype and np.array_equal(got_a[f], want_a[f]), f
            for off in got_a["voffset"].tolist():
                assert pnative.decode_value_at(p, off, cids) == jvalue(p, off, jcids)
            seen_anchor += len(got_a["row"])
    assert seen_ext and seen_del and seen_anchor
    with pytest.raises(CodecDecodeError):
        pnative.explode_seq_delta_payload(payloads[0][:-3], target)


# ---- DeviceDocBatch, the gate -------------------------------------------------------


def _pair(n_docs: int, cap: int, as_text: bool = True, auto_grow: bool = False):
    return (JBatch(n_docs, cap, mesh=_mesh(), as_text=as_text, auto_grow=auto_grow),
            DeviceDocBatch(n_docs, cap, device="cpu", as_text=as_text, auto_grow=auto_grow))


def _same_state(jb, pb):
    blob = pb.export_state()
    assert blob == jb.export_state()
    assert pb.cap == jb.cap and pb.epoch == jb.epoch and np.array_equal(pb.counts, jb.counts)
    return blob


@pytest.mark.parametrize("path", ["payloads", "changes"])
@pytest.mark.parametrize("seed", range(2))
def test_device_doc_batch_matches_jax_every_round(path, seed):
    """Text with marks, auto_grow across a capacity boundary and an
    explicit grow: after every round the checkpoint bytes equal the JAX
    batch's, and texts() (standing keys) equals texts(use_solver=True)
    and the replicas' text."""
    rng = random.Random(100 + seed)
    reps = _Replicas(rng, 4)
    jcid, cid = _cid("t", True)
    jb, pb = _pair(4, 32, auto_grow=True)
    grown = False
    for r in range(7):
        payloads, jch, pch = reps.round()
        if path == "payloads":
            jb.append_payloads(payloads, jcid)
            pb.append_payloads(payloads, cid)
        else:
            jb.append_changes(jch, jcid)
            pb.append_changes(pch, cid)
        if r == 3:
            jb.grow(jb.cap * 2)
            pb.grow(pb.cap * 2)
        grown |= pb.cap > 32
        _same_state(jb, pb)
        want = reps.texts()
        assert pb.texts() == want, f"round {r}"
        assert pb.texts(use_solver=True) == want
        assert pb._c_pad >= 256
    assert grown and pb.cap >= 128
    st = pb.stage_ms()
    assert set(st) == {"solve", "fetch", "decode"}


@pytest.mark.parametrize("path", ["payloads", "changes"])
def test_device_doc_batch_values_match_jax(path):
    """as_text=False (List containers): values() against the replicas,
    export bytes against JAX after every round (payloads take the Python
    decode in both packages)."""
    rng = random.Random(7)
    reps = _Replicas(rng, 3, as_text=False)
    jcid, cid = _cid("t", False)
    jb, pb = _pair(3, 64, as_text=False, auto_grow=True)
    for r in range(4):
        payloads, jch, pch = reps.round()
        if path == "payloads":
            jb.append_payloads(payloads, jcid)
            pb.append_payloads(payloads, cid)
        else:
            jb.append_changes(jch, jcid)
            pb.append_changes(pch, cid)
        _same_state(jb, pb)
        assert pb.values() == reps.values() == pb.values(use_solver=True)
    with pytest.raises(LoroError, match="as_text=False"):
        DeviceDocBatch(1, 16, device="cpu").values()


def test_stage_times_of_an_append():
    rng = random.Random(3)
    reps = _Replicas(rng, 2, marks=False)
    _, cid = _cid("t", True)
    pb = DeviceDocBatch(2, 64, device="cpu")
    payloads, _, _ = reps.round(idle=0.0)
    pb.append_payloads(payloads, cid)
    st = pb.stage_ms()
    assert {"explode", "stage", "commit", "block", "order", "upload_scatter"} <= set(st)
    assert all(v >= 0 for v in st.values())


# ---- failure paths ----------------------------------------------------------------


def test_capacity_error_leaves_the_batch_untouched():
    """An over-capacity append raises before any write: the checkpoint
    bytes are unchanged, no staged id is left in any doc's map (the
    payload's ids do not resolve), and the next append that fits works,
    as in JAX."""
    rng = random.Random(11)
    reps = _Replicas(rng, 2, marks=False)
    jcid, cid = _cid("t", True)
    jb, pb = _pair(2, 64)
    payloads, _, _ = reps.round(idle=0.0)
    jb.append_payloads(payloads, jcid)
    pb.append_payloads(payloads, cid)
    before = _same_state(jb, pb)
    reps.docs[1][0].get_text("t").insert(0, "x" * 80)
    reps.docs[1][0].commit()
    big, _, _ = reps.round(idle=0.0)
    with pytest.raises(RuntimeError, match="capacity exceeded"):
        pb.append_payloads(big, cid)
    with pytest.raises(RuntimeError, match="capacity exceeded"):
        jb.append_payloads(big, jcid)
    assert pb.export_state() == before == jb.export_state()
    peer, ctr = next((c.peer, o.counter) for c in pdecode(big[1]) for o in c.ops if isinstance(o.content, SeqInsert))
    assert pb.resolve_row(1, peer, ctr) is None
    assert all(len(m) == int(c) for m, c in zip(pb.id2row, pb.counts))
    pb.grow(256)
    jb.grow(256)
    pb.append_payloads(big, cid)
    jb.append_payloads(big, jcid)
    _same_state(jb, pb)
    assert pb.texts() == reps.texts()


def _jfallbacks() -> float:
    return jobs.counter("fleet.host_fallback_total").get(kind="payload_decode")


def test_missing_base_raises_loro_error_after_the_counted_fallback():
    """A delta whose parents were never appended: the native path cannot
    resolve them, the Python decode is tried (counted, as in JAX) and
    raises LoroError; the batch is untouched."""
    doc = LoroDoc(peer=3)
    t = doc.get_text("t")
    t.insert(0, "base text")
    doc.commit()
    vv = doc.oplog_vv()
    t.insert(4, "MID")
    doc.commit()
    delta = strip_envelope(doc.export_updates(vv))
    jcid, cid = _cid("t", True)
    jb, pb = _pair(2, 64)
    before = pb.export_state()
    j0, p0 = _jfallbacks(), pfleet.FLEET_FALLBACKS["payload_decode"]
    with pytest.raises(JLoroError, match="unknown element"):
        jb.append_payloads([None, delta], jcid)
    with pytest.raises(LoroError, match="unknown element"):
        pb.append_payloads([None, delta], cid)
    assert _jfallbacks() == j0 + 1 and pfleet.FLEET_FALLBACKS["payload_decode"] == p0 + 1
    assert pb.export_state() == before == jb.export_state()
    with pytest.raises(LoroError, match="FULL history"):
        pb.append_changes([None, pdecode(delta)], cid)


def test_malformed_payload_falls_back_counted_and_leaves_no_staged_ids():
    """A truncated payload beside a good one: the native explode rejects
    it, the counted Python decode raises CodecDecodeError, the good doc's
    staged ids are rolled back, and the batch is untouched, in both
    packages."""
    rng = random.Random(12)
    reps = _Replicas(rng, 2, marks=False)
    jcid, cid = _cid("t", True)
    jb, pb = _pair(2, 128)
    payloads, _, _ = reps.round(idle=0.0)
    jb.append_payloads(payloads, jcid)
    pb.append_payloads(payloads, cid)
    before = _same_state(jb, pb)
    good, _, _ = reps.round(idle=0.0)
    bad = [good[0], good[1][:-2]]
    j0, p0 = _jfallbacks(), pfleet.FLEET_FALLBACKS["payload_decode"]
    with pytest.raises(JDecodeError):
        jb.append_payloads(bad, jcid)
    with pytest.raises(CodecDecodeError):
        pb.append_payloads(bad, cid)
    assert _jfallbacks() == j0 + 1 and pfleet.FLEET_FALLBACKS["payload_decode"] == p0 + 1
    assert pb.export_state() == before == jb.export_state()
    assert all(len(m) == int(c) for m, c in zip(pb.id2row, pb.counts))
    pb.append_payloads(good, cid)
    jb.append_payloads(good, jcid)
    _same_state(jb, pb)
    assert pb.texts() == reps.texts()


# ---- state in both directions ------------------------------------------------------


def _filled_pair(as_text: bool = True):
    rng = random.Random(21 if as_text else 22)
    reps = _Replicas(rng, 3, as_text=as_text)
    jcid, cid = _cid("t", as_text)
    jb, pb = _pair(3, 128, as_text=as_text, auto_grow=True)
    for _ in range(3):
        payloads, _, _ = reps.round()
        jb.append_payloads(payloads, jcid)
        pb.append_payloads(payloads, cid)
    return reps, jb, pb


@pytest.mark.parametrize("as_text", [True, False])
def test_import_state_both_directions(as_text):
    """The port imports JAX's bytes and JAX imports the port's; each
    re-exports them unchanged, and the port's restored batch reads and
    takes further rounds like the original."""
    reps, jb, pb = _filled_pair(as_text)
    blob = _same_state(jb, pb)
    restored = DeviceDocBatch.import_state(jb.export_state(), device="cpu")
    assert restored.export_state() == blob
    assert JBatch.import_state(blob, mesh=_mesh()).export_state() == blob
    read = (lambda b: b.texts()) if as_text else (lambda b: b.values())
    assert read(restored) == read(pb)
    jcid, cid = _cid("t", as_text)
    payloads, _, _ = reps.round()
    pb.append_payloads(payloads, cid)
    restored.append_payloads(payloads, cid)
    assert restored.export_state() == pb.export_state()
    assert read(restored) == (reps.texts() if as_text else reps.values())


def test_corrupt_state_raises_decode_error():
    """The mutations of the JAX package's test_corrupt_state_raises and
    test_corrupt_anchor_row_raises, and a truncated store."""
    doc = LoroDoc(peer=1)
    t = doc.get_text("t")
    t.insert(0, "hello")
    t.mark(0, 3, "bold", True)
    doc.commit()
    _, cid = _cid("t", True)
    pb = DeviceDocBatch(1, 128, device="cpu")
    pb.append_payloads([strip_envelope(doc.export_updates())], cid)
    blob = bytearray(pb.export_state())
    blob[25] ^= 0xFF
    with pytest.raises(DecodeError):
        DeviceDocBatch.import_state(bytes(blob), device="cpu")
    with pytest.raises(DecodeError):
        DeviceDocBatch.import_state(pb.export_state()[:-7], device="cpu")
    kv = MemKvStore()
    kv.import_all(pb.export_state())
    anch = bytearray(kv.get(b"doc/00000000/anchors"))
    r = Reader(bytes(anch))
    assert r.varint() >= 1
    r.varint()
    r.zigzag()
    assert anch[r.i] < 0x80
    anch[r.i] = 0x7F  # row 127 >= count
    kv.set(b"doc/00000000/anchors", bytes(anch))
    with pytest.raises(DecodeError, match="anchor row"):
        DeviceDocBatch.import_state(kv.export_all(), device="cpu")
    # version 2, 1 doc of width 1, capacity 2^32 - 1, text, c_pad 256,
    # count 0, epoch 0, no auto_grow: refused before any allocation
    kv.set(b"meta", bytes([2, 1, 1]) + b"\xff\xff\xff\xff\x0f" + bytes([1, 0x80, 0x02, 0, 0, 0]))
    with pytest.raises(DecodeError, match="implausible capacity"):
        DeviceDocBatch.import_state(kv.export_all(), device="cpu")


def test_python_engines_give_the_same_export(monkeypatch):
    """LORO_PY_ORDER=1 / LORO_PY_IDMAP=1 pick the Python engines (each
    pick counted) and give the native engines' checkpoint bytes."""
    rng = random.Random(31)
    reps = _Replicas(rng, 3)
    _, cid = _cid("t", True)
    nat = DeviceDocBatch(3, 64, device="cpu", auto_grow=True)
    o0, i0 = pfleet.FLEET_FALLBACKS["order"], pfleet.FLEET_FALLBACKS["idmap"]
    monkeypatch.setenv("LORO_PY_ORDER", "1")
    monkeypatch.setenv("LORO_PY_IDMAP", "1")
    py = DeviceDocBatch(3, 64, device="cpu", auto_grow=True)
    assert pfleet.FLEET_FALLBACKS["order"] == o0 + 3 and pfleet.FLEET_FALLBACKS["idmap"] == i0 + 3
    assert isinstance(py.order[0], porder.ShadowOrder) and isinstance(py.id2row[0], PyIdMap)
    assert isinstance(nat.order[0], pnative.NativeShadowOrder) and isinstance(nat.id2row[0], pnative.NativeIdMap)
    for _ in range(4):
        payloads, _, _ = reps.round()
        nat.append_payloads(payloads, cid)
        py.append_payloads(payloads, cid)
        assert py.export_state() == nat.export_state()
        assert torch.equal(py.key_hi, nat.key_hi) and torch.equal(py.key_lo, nat.key_lo)
    assert py.texts() == nat.texts() == reps.texts()


# ---- the store ---------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_mem_kv_store_export_matches_jax(seed):
    """Random key sets with values past the block size: export_all bytes
    equal JAX's, and each imports the other's."""
    rng = random.Random(seed)
    jkv, pkv = JKv(block_size=256), MemKvStore(block_size=256)
    for _ in range(120):
        k = bytes(rng.randrange(256) for _ in range(rng.randint(0, 12)))
        v = bytes(rng.randrange(256) for _ in range(rng.choice([0, 3, 40, 300, 1000])))
        jkv.set(k, v)
        pkv.set(k, v)
        if rng.random() < 0.1:
            jkv.remove(k)
            pkv.remove(k)
    blob = pkv.export_all()
    assert blob == jkv.export_all()
    back = MemKvStore(block_size=256)
    back.import_all(blob)
    assert list(back.scan()) == list(jkv.scan())
    assert back.export_all() == blob
    assert back.n_blocks > 1 and any(b.large for b in back._blocks)


def test_mem_kv_store_corrupt_raises():
    kv = MemKvStore(block_size=64)
    for i in range(40):
        kv.set(b"k%03d" % i, b"v" * i)
    blob = kv.export_all()
    for bad in (b"XXXX" + blob[4:], blob[:5], blob[:-2] + b"\xff\xff"):
        with pytest.raises(DecodeError):
            MemKvStore().import_all(bad)
    flipped = bytearray(blob)
    flipped[10] ^= 0x40  # inside the first block: its checksum fails on first touch
    store = MemKvStore()
    store.import_all(bytes(flipped))
    with pytest.raises(DecodeError):
        list(store.scan())


# ---- tracegen.epoch_payloads ---------------------------------------------------------


def test_epoch_payloads_feed_both_batches_to_the_oracle():
    """A generated doc's sync epochs, appended one a round to both
    batches: equal checkpoints after every round, the oracle text at the
    end, and the epochs' changes decode to the doc's extract."""
    docs = tracegen.fleet_docs(1, n_patches=9000, seed=4, use_cache=False)
    eps = [tracegen.epoch_payloads(d, use_cache=False) for d in docs]
    assert [len(e) for e in eps] == [3, 3]
    jcid = JContainerID.root("text", JContainerType.Text)
    jb, pb = _pair(2, 1024, auto_grow=True)
    for e in range(3):
        jb.append_payloads([ep[e] for ep in eps], jcid)
        pb.append_payloads([ep[e] for ep in eps], tracegen.TEXT_CID)
        _same_state(jb, pb)
    want = [tracegen.oracle_text(d.extract) for d in docs]
    assert want == [d.text for d in docs]
    assert pb.texts() == want == pb.texts(use_solver=True)
    for d, ep in zip(docs, eps):
        ex = pcol.extract_seq_container([c for p in ep for c in pdecode(p)], tracegen.TEXT_CID)
        for f in ("parent", "side", "peer", "counter", "deleted", "content"):
            assert np.array_equal(getattr(ex, f), getattr(d.extract, f)), f
