"""The resident batches' lifecycle in the port (loro_tpu_torch.parallel
.fleet: the coalesce group begin_coalesce / detach_coalesce /
commit_detached / flush_coalesce and release_doc on all five batches,
compact on the text / list, tree and movable batches) against the JAX
package's batches, on the CPU.

Every scenario is recorded once from JAX LoroDocs (their payload bytes
and the host oracle's reads) and driven through both packages' batches
(the JAX batch on a one-device mesh): after every step the checkpoint
bytes, compact's return values and remaps, and the reads are equal, and
the reads equal the LoroDoc oracle.  A coalesced run is also held
against the same steps run serially.  Tolerance: exact.  The compaction
cases mirror tests/test_compact.py's, as parametrised cases.
"""
import random
import threading

import jax
import numpy as np
import pytest

from loro_tpu import LoroDoc
from loro_tpu.codec.binary import decode_changes as jdecode
from loro_tpu.core.ids import ContainerID as JContainerID
from loro_tpu.core.ids import ContainerType as JContainerType
from loro_tpu.doc import strip_envelope
from loro_tpu.obs import metrics as jobs
from loro_tpu.parallel import fleet as jfleet
from loro_tpu.parallel.mesh import make_mesh
from loro_tpu_torch.codec.binary import decode_changes as pdecode
from loro_tpu_torch.core.ids import ContainerID, ContainerType
from loro_tpu_torch.obs import metrics as pobs
from loro_tpu_torch.parallel import fleet as pfleet
from loro_tpu_torch.storage import MemKvStore

KINDS = {
    # kind: (class name, container type, as_text)
    "text": ("DeviceDocBatch", "Text", True),
    "list": ("DeviceDocBatch", "List", False),
    "tree": ("DeviceTreeBatch", "Tree", None),
    "movable": ("DeviceMovableBatch", "MovableList", None),
    "map": ("DeviceMapBatch", "Map", None),
    "counter": ("DeviceCounterBatch", "Counter", None),
}


def _mesh():
    return make_mesh(jax.devices()[:1])


def _payload(doc, vv=None) -> bytes:
    return strip_envelope(doc.export_updates(vv) if vv is not None else doc.export_updates())


def _norm(x):
    """A package-neutral form of a read: container ids by (type, name),
    named tuples (TreeID) as tuples, dicts as item lists in their order."""
    if isinstance(x, dict):
        return [(_norm(k), _norm(v)) for k, v in x.items()]
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if type(x).__name__ == "ContainerID":
        return ("cid", int(x.ctype), x.name)
    return x


def _unordered(x):
    """_norm with dicts as item lists sorted by key (an oracle's dicts
    need not iterate in the batch's order)."""
    if isinstance(x, dict):
        return sorted(((repr(_norm(k)), _unordered(v)) for k, v in x.items()), key=lambda kv: kv[0])
    if isinstance(x, (list, tuple)):
        return [_unordered(v) for v in x]
    return _norm(x)


# ---- the two packages ------------------------------------------------------------------


class _Side:
    """One package's batch classes, decode and container ids."""

    def __init__(self, port: bool):
        self.port = port
        self.mod = pfleet if port else jfleet
        self.decode = pdecode if port else jdecode

    def new(self, kind, *args, **kw):
        cls_name, _ctype, as_text = KINDS[kind]
        if as_text is not None:
            kw["as_text"] = as_text
        cls = getattr(self.mod, cls_name)
        return cls(*args, device="cpu", **kw) if self.port else cls(*args, mesh=_mesh(), **kw)

    def import_state(self, kind, blob):
        cls = getattr(self.mod, KINDS[kind][0])
        return cls.import_state(blob, device="cpu") if self.port else cls.import_state(blob, mesh=_mesh())

    def cid(self, kind, name):
        ctype = KINDS[kind][1]
        if self.port:
            return ContainerID.root(name, ContainerType[ctype])
        return JContainerID.root(name, JContainerType[ctype])


P, J = _Side(True), _Side(False)


def _append(side, kind, b, payloads, path, name):
    if kind in ("map", "counter"):
        if path == "payloads" and kind == "map":
            b.append_payloads(payloads)
        else:
            b.append_changes([side.decode(p) if p else None for p in payloads])
        return
    cid = side.cid(kind, name)
    if path == "payloads":
        b.append_payloads(payloads, cid)
    else:
        b.append_changes([side.decode(p) if p else None for p in payloads], cid)


def _reads(kind, b, rich=False):
    """(primary read, all reads) of a batch: the primary one in the
    oracle's form (_unordered), all of them normalized."""
    if kind == "text":
        t = b.texts()
        assert b.texts(use_solver=True) == t
        return _unordered(t), _norm((t, b.richtexts() if rich else None))
    if kind == "list":
        v = b.values()
        assert b.values(use_solver=True) == v
        return _unordered(v), _norm(v)
    if kind == "tree":
        pm = b.parent_maps()
        return _unordered(pm), _norm((pm, b.children_maps()))
    if kind == "movable":
        v = b.value_lists()
        return _unordered(v), _norm(v)
    if kind == "map":
        return _unordered(b.root_value_maps("m")), _norm(b.value_maps())
    vm = b.value_maps()
    return _unordered([{c.name: v for c, v in m.items()} for m in vm]), _norm(vm)


class _Script:
    """A scenario's steps: payload bytes and oracle reads taken from JAX
    LoroDocs as the scenario is built, then driven through either
    package by drive()."""

    def __init__(self, kind, *args, name="t", **kw):
        self.kind = kind
        self.name = name
        self.steps = [("new", args, kw)]

    def append(self, payloads, path="changes"):
        self.steps.append(("append", list(payloads), path))

    def compact(self, stable, **kw):
        """stable: a list of epochs, None, or "E" (the batch's epoch at
        that step); kw: compact's extra arguments."""
        self.steps.append(("compact", list(stable), kw))

    def call(self, fn):
        """fn(batch) -> an observation (any method call of a scenario)."""
        self.steps.append(("call", fn))

    def release(self, di):
        self.steps.append(("release", di))

    def begin(self):
        self.steps.append(("begin",))

    def flush(self):
        self.steps.append(("flush",))

    def detach_async(self):
        """Detach the open group and commit it on a second thread while
        the following steps stage the next group (join() waits)."""
        self.steps.append(("detach_async",))

    def join(self):
        self.steps.append(("join",))

    def roundtrip(self):
        self.steps.append(("roundtrip",))

    def reimport(self, fn):
        """Continue on the batch imported from fn(batch) (state bytes)."""
        self.steps.append(("reimport", fn))

    def check(self, want=None, rich=False):
        self.steps.append(("check", want, rich))


def drive(side: _Side, sc: _Script, coalesce: bool = True):
    """Run a script through one package: [(step index, observation)],
    an observation a check, compact, call or roundtrip step (state bytes
    included), none inside an open group."""
    kind = sc.kind
    b = None
    obs = []
    thread = None
    for i, st in enumerate(sc.steps):
        op = st[0]
        if op == "new":
            b = side.new(kind, *st[1], **st[2])
            new_args = st[1:]
        elif op == "append":
            _append(side, kind, b, st[1], st[2], sc.name)
        elif op == "compact":
            stable = [b.epoch if e == "E" else e for e in st[1]]
            out = b.compact(stable, **st[2])
            if isinstance(out, tuple):
                out = (out[0], {di: r.tolist() for di, r in sorted(out[1].items())})
            obs.append((i, ("compact", out), b.export_state()))
        elif op == "call":
            obs.append((i, _norm(st[1](b)), b.export_state()))
        elif op == "release":
            b.release_doc(st[1])
        elif op == "reimport":
            b = side.import_state(kind, st[1](b))
        elif op == "released_fresh":
            fresh = side.new(kind, *new_args[0], **new_args[1])
            assert _released_row_is_fresh(kind, b, fresh, st[1]), f"step {i}: a released row is not a fresh one"
        elif op in ("begin", "flush", "detach_async", "join"):
            if not coalesce:
                continue
            if op == "begin":
                b.begin_coalesce()
            elif op == "flush":
                b.flush_coalesce()
            elif op == "detach_async":
                thread = threading.Thread(target=b.commit_detached, args=(b.detach_coalesce(),))
                thread.start()
            else:
                thread.join()
                thread = None
        elif op == "roundtrip":
            blob = b.export_state()
            b = side.import_state(kind, blob)
            assert b.export_state() == blob
            obs.append((i, "roundtrip", blob))
        elif op == "check":
            prim, allr = _reads(kind, b, st[2])
            if st[1] is not None:
                assert prim == _unordered(st[1]), f"step {i}: the reads differ from the LoroDoc oracle"
            obs.append((i, allr, b.export_state()))
    return obs


def _device_arrays(kind, b):
    """Every [D, *] device array of a batch."""
    if kind in ("text", "list"):
        return [getattr(b.cols, f) for f in b.cols._fields] + [b.key_hi, b.key_lo]
    if kind == "tree":
        return list(b.cols)
    if kind == "movable":
        return _device_arrays("text", b.seq) + list(b.moves) + list(b.vals)
    if kind == "map":
        return list(b.res)
    return [b.sums]


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


def _released_row_is_fresh(kind, b, fresh, di) -> bool:
    """Every device row of doc `di` holds its construction fill (a fresh
    batch's, whose rows are constant; `b` may have grown since)."""
    return all(np.all(_host(x)[di] == _host(y)[di][0])
               for x, y in zip(_device_arrays(kind, b), _device_arrays(kind, fresh)))


def _jax_launches(kind: str) -> float:
    """The JAX package's resident launches of a batch kind (a movable
    batch's slot scatters count under its inner seq batch)."""
    fams = {"text": ["resident_seq"], "list": ["resident_seq"], "tree": ["resident_tree"],
            "movable": ["resident_seq", "resident_movable"], "map": ["resident_map"],
            "counter": ["resident_counter"]}[kind]
    return sum(jobs.counter("fleet.device_launches_total").get(family=f) for f in fams)


class _PortLaunches:
    """Counts the port's device scatters and folds (the JAX package's
    fleet.device_launches_total counts the same launches)."""

    def __init__(self, monkeypatch):
        self.n = 0
        for name in ("_scatter_rows", "lww_update_resident", "_fold_counter_rows"):
            real = getattr(pfleet, name)

            def wrapped(*a, _real=real, **k):
                self.n += 1
                return _real(*a, **k)

            monkeypatch.setattr(pfleet, name, wrapped)


def _both(sc: _Script, monkeypatch=None, serial: bool = True):
    """Drive a script through JAX, the port, and (serial=True) the port
    with its groups dropped; every observation equal (the serial run's
    state bytes equal at every observation).  Returns (port launches,
    JAX launches, serial port launches) when monkeypatch is given."""
    counter = _PortLaunches(monkeypatch) if monkeypatch is not None else None
    j0 = _jax_launches(sc.kind)
    want = drive(J, sc)
    j_launches = _jax_launches(sc.kind) - j0
    n0 = counter.n if counter else 0
    got = drive(P, sc)
    p_launches = (counter.n - n0) if counter else None
    assert len(got) == len(want)
    for (i, a, blob_a), (_i, b, blob_b) in zip(got, want):
        assert a == b, f"step {i}: the reads or return values differ from JAX"
        assert blob_a == blob_b, f"step {i}: export_state differs from JAX"
    s_launches = None
    if serial:
        n1 = counter.n if counter else 0
        ser = drive(P, sc, coalesce=False)
        s_launches = (counter.n - n1) if counter else None
        assert [(i, a, blob) for i, a, blob in ser] == [(i, a, blob) for i, a, blob in got]
    return p_launches, j_launches, s_launches


# ---- compaction: test_compact.py's cases --------------------------------------------------


def _text_doc(peer, s):
    doc = LoroDoc(peer=peer)
    t = doc.get_text("t")
    t.insert(0, s)
    doc.commit()
    return doc, t


def sc_reclaims_and_preserves_text():
    doc, t = _text_doc(1, "hello cruel world")
    t.delete(5, 6)
    doc.commit()
    sc = _Script("text", 1, 64)
    sc.append([_payload(doc)])
    sc.compact(["E"])
    sc.call(lambda b: int(b.counts[0]))
    sc.check(["hello world"])
    return sc


def sc_keeps_tombstones_with_unstable_delete():
    doc, t = _text_doc(1, "abcdef")
    sc = _Script("text", 1, 64)
    sc.append([_payload(doc)])
    sc.call(lambda b: b.epoch)  # acked before the delete is ingested
    vv = doc.oplog_vv()
    t.delete(1, 3)
    doc.commit()
    sc.append([_payload(doc, vv)])
    sc.compact([1])
    sc.check(["aef"])
    sc.compact(["E"])
    sc.check(["aef"])
    return sc


def sc_keeps_dead_rows_with_live_descendants():
    doc = LoroDoc(peer=1)
    t = doc.get_text("t")
    t.insert(0, "ab")
    t.insert(1, "XY")
    doc.commit()
    t.delete(1, 1)
    doc.commit()
    sc = _Script("text", 1, 64)
    sc.append([_payload(doc)])
    sc.compact(["E"])
    sc.check(["aYb"])
    return sc


def _two_peer_edits(rng, docs, choices, p_del, n_edits=6, mark=False):
    for d in docs:
        t = d.get_text("t")
        for _ in range(n_edits):
            L = len(t)
            if L > 6 and rng.random() < p_del:
                t.delete(rng.randrange(L - 2), rng.randint(1, 2))
            else:
                t.insert(rng.randint(0, L), rng.choice(choices))
        if mark:
            t.mark(0, min(4, len(t)), "bold", True)
        d.commit()
    a, b = docs
    a.import_(b.export_updates(a.oplog_vv()))
    b.import_(a.export_updates(b.oplog_vv()))


def sc_append_after_compact_converges():
    rng = random.Random(42)
    a, b = LoroDoc(peer=1), LoroDoc(peer=2)
    ta = a.get_text("t")
    ta.insert(0, "the quick brown fox jumps over the lazy dog")
    a.commit()
    b.import_(a.export_snapshot())
    sc = _Script("text", 1, 512)
    sc.append([_payload(a)])
    mark = a.oplog_vv()
    _two_peer_edits(rng, (a, b), ["zig", "zag"], 0.4)
    sc.append([_payload(a, mark)], "payloads")
    mark = a.oplog_vv()
    sc.check([ta.to_string()])
    sc.compact(["E"])
    sc.check([ta.to_string()])
    _two_peer_edits(rng, (a, b), ["AB", "c"], 0.3, mark=True)
    sc.append([_payload(a, mark)], "payloads")
    sc.check([ta.to_string()], rich=True)
    return sc


def sc_compact_with_styles_preserves_richtext():
    doc, t = _text_doc(7, "styled region here")
    t.mark(0, 6, "bold", True)
    doc.commit()
    t.delete(7, 7)
    doc.commit()
    sc = _Script("text", 1, 128)
    sc.append([_payload(doc)])
    sc.check([t.to_string()], rich=True)
    sc.compact(["E"])
    sc.check([t.to_string()], rich=True)
    return sc


def sc_checkpoint_roundtrip_after_compact():
    doc, t = _text_doc(3, "persisted after gc")
    t.delete(0, 4)
    doc.commit()
    sc = _Script("text", 1, 64)
    sc.append([_payload(doc)])
    sc.compact(["E"])
    sc.roundtrip()
    sc.check([t.to_string()])
    return sc


def sc_dead_end_anchor_survives_compaction():
    doc, t = _text_doc(1, "abcdef tail")
    t.mark(0, 6, "bold", True)
    doc.commit()
    sc = _Script("text", 1, 128)
    sc.append([_payload(doc)])

    def kill_end_anchor(b):
        end_rows = [a["row"] for a in b.anchor_meta[0].values() if not a["start"]]
        assert end_rows
        b.mark_deleted([(0, end_rows[0])])
        return end_rows[0]

    sc.call(kill_end_anchor)
    vv = doc.oplog_vv()
    t.insert(len(t), "!")
    doc.commit()
    sc.append([_payload(doc, vv)])
    sc.call(lambda b: any("bold" in (seg.get("attributes") or {}) for seg in b.richtexts()[0]))
    sc.check(rich=True)
    sc.compact(["E"])
    sc.check(rich=True)
    return sc


def sc_direct_mark_deleted_gets_fresh_epoch():
    doc, t = _text_doc(1, "abc")
    sc = _Script("text", 1, 32)
    sc.append([_payload(doc)])
    sc.call(lambda b: b.mark_deleted([(0, 1)]) or b.epoch)
    sc.compact([1])  # the out-of-band delete is dated past the ack
    sc.check()
    return sc


def sc_multi_doc_selective():
    docs = [LoroDoc(peer=i + 1) for i in range(3)]
    for d in docs:
        t = d.get_text("t")
        t.insert(0, f"doc {d.peer} payload")
        d.commit()
        t.delete(0, 4)
        d.commit()
    sc = _Script("text", 3, 64)
    sc.append([_payload(d) for d in docs])
    sc.compact([None, "E", None])
    sc.check([d.get_text("t").to_string() for d in docs])
    return sc


def sc_list_value_store_shrinks():
    doc = LoroDoc(peer=1)
    lst = doc.get_list("t")
    for i in range(12):
        lst.push(f"item-{i}")
    doc.commit()
    for _ in range(8):
        lst.delete(2, 1)
    doc.commit()
    sc = _Script("list", 1, 64)
    sc.append([_payload(doc)])
    sc.call(lambda b: len(b.value_store[0]))
    sc.compact(["E"])
    sc.call(lambda b: len(b.value_store[0]))
    sc.check([lst.get_value()])
    vv = doc.oplog_vv()
    lst.push("after-gc")
    doc.commit()
    sc.append([_payload(doc, vv)])
    sc.check([lst.get_value()])
    return sc


def sc_return_remaps_and_extra_rows():
    """compact's extra_protect, extra_dead and return_remaps on two docs
    (one skipped), the remaps compared as arrays."""
    docs = []
    for peer in (4, 5):
        doc = LoroDoc(peer=peer)
        t = doc.get_text("t")
        t.insert(0, "abcdefghijklmnop")
        doc.commit()
        t.delete(3, 6)
        doc.commit()
        docs.append(doc)
    sc = _Script("text", 3, 64)
    sc.append([_payload(d) for d in docs] + [None])
    sc.compact(["E", "E", None], extra_protect=[np.array([4, 5]), None, None],
               extra_dead=[None, np.array([0, 1, 99]), None], return_remaps=True)
    sc.check()
    return sc


def sc_undated_rows_from_an_imported_checkpoint():
    """A checkpoint without its epoch columns (an older state version's
    rows): its tombstones are undated and never drop; a delete ingested
    after the import is dated and does."""
    doc, t = _text_doc(6, "undated tombstones stay")
    t.delete(0, 8)
    doc.commit()
    sc = _Script("text", 1, 64)
    sc.append([_payload(doc)])

    def strip_epochs(b):
        kv = MemKvStore()
        kv.import_all(b.export_state())
        out = MemKvStore()
        for k, v in kv:
            if not k.endswith((b"/tombepoch", b"/rowepoch")):
                out.set(k, v)
        return out.export_all()

    sc.reimport(strip_epochs)
    sc.compact(["E"])
    vv = doc.oplog_vv()
    t.delete(5, 4)
    doc.commit()
    sc.append([_payload(doc, vv)])
    sc.compact(["E"])
    sc.check([t.to_string()])
    return sc


def sc_text_fuzz(seed):
    rng = random.Random(0xC0117AC7 + seed)
    a, b = LoroDoc(peer=1), LoroDoc(peer=2)
    ta = a.get_text("t")
    ta.insert(0, "seed text for compaction fuzz")
    a.commit()
    b.import_(a.export_snapshot())
    sc = _Script("text", 1, 4096)
    sc.append([_payload(a)])
    mark = a.oplog_vv()
    for epoch in range(6):
        for d in (a, b):
            t = d.get_text("t")
            for _ in range(rng.randint(3, 10)):
                L = len(t)
                if L > 6 and rng.random() < 0.45:
                    pos = rng.randrange(L - 1)
                    t.delete(pos, min(rng.randint(1, 4), L - pos))
                else:
                    t.insert(rng.randint(0, L), rng.choice(["x", "yz", "hello", "qrs tuv"]))
            if rng.random() < 0.3 and len(t) > 2:
                s = rng.randrange(len(t) - 1)
                t.mark(s, rng.randint(s + 1, len(t)), "bold", True)
            d.commit()
        a.import_(b.export_updates(a.oplog_vv()))
        b.import_(a.export_updates(b.oplog_vv()))
        sc.append([_payload(a, mark)], "payloads")
        mark = a.oplog_vv()
        sc.check([ta.to_string()])
        if epoch % 2 == 1:
            sc.compact(["E"])
            sc.check([ta.to_string()], rich=True)
    return sc


def sc_list_fuzz(seed):
    rng = random.Random(0x115 + seed)
    a, b = LoroDoc(peer=1), LoroDoc(peer=2)
    la = a.get_list("t")
    for i in range(6):
        la.push(f"base{i}")
    a.commit()
    b.import_(a.export_snapshot())
    sc = _Script("list", 1, 4096, auto_grow=True)
    sc.append([_payload(a)])
    mark = a.oplog_vv()
    for epoch in range(6):
        for d in (a, b):
            lst = d.get_list("t")
            for _ in range(rng.randint(2, 8)):
                L = len(lst.get_value())
                if L > 2 and rng.random() < 0.45:
                    p0 = rng.randrange(L - 1)
                    lst.delete(p0, min(rng.randint(1, 3), L - p0))
                else:
                    lst.insert(rng.randint(0, L), rng.choice([f"x{epoch}", 1.5, None, {"k": epoch}]))
            d.commit()
        a.import_(b.export_updates(a.oplog_vv()))
        b.import_(a.export_updates(b.oplog_vv()))
        sc.append([_payload(a, mark)])
        mark = a.oplog_vv()
        if epoch % 2 == 1:
            sc.compact(["E"])
            sc.check([la.get_value()])
    return sc


def sc_movable_churn():
    doc = LoroDoc(peer=1)
    ml = doc.get_movable_list("l")
    ml.push(*[f"v{i}" for i in range(6)])
    doc.commit()
    sc = _Script("movable", 1, 512, 64, name="l")
    sc.append([_payload(doc)])
    vv = doc.oplog_vv()
    for i in range(10):
        ml.move(i % len(ml.get_value()), (i * 3) % len(ml.get_value()))
        ml.set(i % len(ml.get_value()), f"set{i}")
    ml.delete(1, 2)
    doc.commit()
    sc.append([_payload(doc, vv)])
    sc.check([ml.get_value()])
    sc.compact(["E"])
    sc.call(lambda b: int(b.seq.counts[0]))
    sc.check([ml.get_value()])
    vv = doc.oplog_vv()
    ml.push("post-gc")
    ml.move(0, len(ml.get_value()) - 1)
    doc.commit()
    sc.append([_payload(doc, vv)])
    sc.check([ml.get_value()])
    return sc


def sc_movable_fuzz(seed):
    rng = random.Random(0x30AB + seed)
    a, b = LoroDoc(peer=1), LoroDoc(peer=2)
    ma = a.get_movable_list("l")
    ma.push(*[f"s{i}" for i in range(4)])
    a.commit()
    b.import_(a.export_snapshot())
    sc = _Script("movable", 1, 4096, 512, name="l", auto_grow=True)
    sc.append([_payload(a)])
    mark = a.oplog_vv()
    for epoch in range(6):
        for d in (a, b):
            m = d.get_movable_list("l")
            for _ in range(rng.randint(1, 6)):
                L = len(m.get_value())
                r = rng.random()
                if L and r < 0.3:
                    m.move(rng.randrange(L), rng.randrange(L))
                elif L and r < 0.5:
                    m.set(rng.randrange(L), rng.random())
                elif L > 2 and r < 0.65:
                    m.delete(rng.randrange(L - 1), 1)
                else:
                    m.insert(rng.randint(0, L), f"e{epoch}{rng.random():.3f}")
            d.commit()
        a.import_(b.export_updates(a.oplog_vv()))
        b.import_(a.export_updates(b.oplog_vv()))
        sc.append([_payload(a, mark)], "payloads" if epoch % 2 else "changes")
        mark = a.oplog_vv()
        sc.check([ma.get_value()])
        if epoch % 2 == 1:
            sc.compact(["E"])
            sc.check([ma.get_value()])
    return sc


def _tree_parents(tr):
    return [{t_: tr.parent(t_) for t_ in tr.nodes()}]


def sc_tree_superseded_moves_drop():
    doc = LoroDoc(peer=1)
    tr = doc.get_tree("tr")
    root = tr.create()
    kids = [tr.create(root) for _ in range(3)]
    doc.commit()
    sc = _Script("tree", 1, 256, 64, name="tr")
    sc.append([_payload(doc)])
    vv = doc.oplog_vv()
    for _ in range(5):
        tr.move(kids[0], root, 0)
        tr.move(kids[0], kids[1])
        tr.move(kids[0], root)
    doc.commit()
    sc.append([_payload(doc, vv)])
    sc.check(_tree_parents(tr))
    sc.compact(["E"])
    sc.call(lambda b: int(b.counts[0]))
    sc.check(_tree_parents(tr))
    return sc


def sc_tree_unstable_moves_kept():
    doc = LoroDoc(peer=1)
    tr = doc.get_tree("tr")
    root = tr.create()
    kid = tr.create(root)
    doc.commit()
    sc = _Script("tree", 1, 256, 64, name="tr")
    sc.append([_payload(doc)])
    vv = doc.oplog_vv()
    tr.move(kid, root, 0)
    tr.move(kid, root, 0)
    doc.commit()
    sc.append([_payload(doc, vv)])
    sc.compact([1])
    sc.check(_tree_parents(tr))
    return sc


def sc_tree_append_after_compact(seed):
    rng = random.Random(3 + seed)
    a, b = LoroDoc(peer=1), LoroDoc(peer=2)
    ta = a.get_tree("tr")
    root = ta.create()
    for _ in range(4):
        ta.create(root)
    a.commit()
    b.import_(a.export_snapshot())
    sc = _Script("tree", 1, 2048, 128, name="tr")
    sc.append([_payload(a)])
    mark = a.oplog_vv()
    for epoch in range(5):
        for d in (a, b):
            t = d.get_tree("tr")
            for _ in range(rng.randint(1, 6)):
                alive = list(t.nodes())
                r = rng.random()
                if alive and r < 0.3:
                    t.create(rng.choice(alive))
                elif len(alive) > 2 and r < 0.8:
                    x, y = rng.sample(alive, 2)
                    try:
                        t.move(x, y)
                    except Exception:
                        pass  # a cycle, rejected locally
                elif alive and rng.random() < 0.2:
                    try:
                        t.delete(rng.choice(alive))
                    except Exception:
                        pass
            d.commit()
        a.import_(b.export_updates(a.oplog_vv()))
        b.import_(a.export_updates(b.oplog_vv()))
        sc.append([_payload(a, mark)], "payloads" if epoch % 2 else "changes")
        mark = a.oplog_vv()
        sc.check(_tree_parents(ta))
        if epoch % 2 == 1:
            sc.compact(["E"])
            sc.check(_tree_parents(ta))
    return sc


def sc_tree_checkpoint_roundtrip_after_compact():
    doc = LoroDoc(peer=5)
    tr = doc.get_tree("tr")
    root = tr.create()
    kid = tr.create(root)
    tr.move(kid, root, 0)
    tr.move(kid, root)
    tr.delete(kid)
    doc.commit()
    sc = _Script("tree", 1, 256, 64, name="tr")
    sc.append([_payload(doc)])
    sc.compact(["E"])
    sc.roundtrip()
    sc.check(_tree_parents(tr))
    sc.call(lambda b: b.epoch)
    return sc


COMPACT_CASES = {
    "reclaims_and_preserves_text": sc_reclaims_and_preserves_text,
    "keeps_tombstones_with_unstable_delete": sc_keeps_tombstones_with_unstable_delete,
    "keeps_dead_rows_with_live_descendants": sc_keeps_dead_rows_with_live_descendants,
    "append_after_compact_converges": sc_append_after_compact_converges,
    "compact_with_styles_preserves_richtext": sc_compact_with_styles_preserves_richtext,
    "checkpoint_roundtrip_after_compact": sc_checkpoint_roundtrip_after_compact,
    "dead_end_anchor_survives_compaction": sc_dead_end_anchor_survives_compaction,
    "direct_mark_deleted_gets_fresh_epoch": sc_direct_mark_deleted_gets_fresh_epoch,
    "multi_doc_selective": sc_multi_doc_selective,
    "list_value_store_shrinks": sc_list_value_store_shrinks,
    "return_remaps_and_extra_rows": sc_return_remaps_and_extra_rows,
    "undated_rows_from_an_imported_checkpoint": sc_undated_rows_from_an_imported_checkpoint,
    "movable_churn": sc_movable_churn,
    "tree_superseded_moves_drop": sc_tree_superseded_moves_drop,
    "tree_unstable_moves_kept": sc_tree_unstable_moves_kept,
    "tree_checkpoint_roundtrip_after_compact": sc_tree_checkpoint_roundtrip_after_compact,
}
COMPACT_CASES.update({f"text_fuzz_{s}": (lambda s=s: sc_text_fuzz(s)) for s in range(6)})
COMPACT_CASES.update({f"list_fuzz_{s}": (lambda s=s: sc_list_fuzz(s)) for s in range(4)})
COMPACT_CASES.update({f"movable_fuzz_{s}": (lambda s=s: sc_movable_fuzz(s)) for s in range(4)})
COMPACT_CASES.update({f"tree_append_after_compact_{s}": (lambda s=s: sc_tree_append_after_compact(s)) for s in range(2)})


def _reclaimed(obs):
    """The rows each compact step of a run reclaimed."""
    return [o[1][0] if isinstance(o[1], tuple) else o[1] for _i, o, _b in obs if isinstance(o, tuple) and
            o[:1] == ("compact",)]


# what test_compact.py asserts of each case's compact calls (default: some
# call reclaims)
COMPACT_EXPECT = {
    "keeps_tombstones_with_unstable_delete": lambda r: r[0] == 0 and r[1] > 0,
    "direct_mark_deleted_gets_fresh_epoch": lambda r: r == [0],
    "tree_unstable_moves_kept": lambda r: r == [0],
    "undated_rows_from_an_imported_checkpoint": lambda r: r[0] == 0 and r[1] > 0,
    "keeps_dead_rows_with_live_descendants": lambda r: True,
    "checkpoint_roundtrip_after_compact": lambda r: True,
    "dead_end_anchor_survives_compaction": lambda r: True,
    "tree_checkpoint_roundtrip_after_compact": lambda r: True,
    "movable_fuzz_0": lambda r: True,
    "movable_fuzz_1": lambda r: True,
    "movable_fuzz_2": lambda r: True,
    "movable_fuzz_3": lambda r: True,
    "tree_append_after_compact_0": lambda r: True,
    "tree_append_after_compact_1": lambda r: True,
}


@pytest.mark.parametrize("case", list(COMPACT_CASES))
def test_compact_matches_jax(case):
    """Each compaction case through both packages: compact's return value
    (and remaps), the checkpoint bytes and the reads equal after every
    step, and the reads equal the LoroDoc oracle; what the JAX case
    asserts of the rows reclaimed holds."""
    sc = COMPACT_CASES[case]()
    _both(sc, serial=False)
    reclaimed = _reclaimed(drive(P, sc))
    assert COMPACT_EXPECT.get(case, lambda r: sum(r) > 0)(reclaimed), reclaimed


# ---- coalesce groups and release_doc ------------------------------------------------------

VALUES = [1, "s", None, 2.5, {"n": [1, True]}, b"\x00\xff", -(2**40)]
PEERS = (1, 7, (1 << 33) + 5, (1 << 63) + 9)


def _edit(kind, rng, d):
    """A few random edits of one replica's container of `kind`."""
    if kind == "text":
        t = d.get_text("t")
        for _ in range(rng.randint(1, 6)):
            u = rng.random()
            if len(t) and u < 0.3:
                p0 = rng.randrange(len(t))
                t.delete(p0, min(rng.randint(1, 3), len(t) - p0))
            elif len(t) >= 2 and u < 0.4:
                s = rng.randrange(len(t) - 1)
                t.mark(s, rng.randint(s + 1, len(t)), "bold", True)
            else:
                t.insert(rng.randint(0, len(t)), rng.choice(["ab", "z", "qrs", "é☃"]))
    elif kind == "list":
        lst = d.get_list("t")
        for _ in range(rng.randint(1, 5)):
            if len(lst) and rng.random() < 0.3:
                lst.delete(rng.randrange(len(lst)), 1)
            else:
                lst.insert(rng.randint(0, len(lst)), rng.choice(VALUES))
    elif kind == "movable":
        m = d.get_movable_list("l")
        for _ in range(rng.randint(1, 5)):
            n = len(m)
            u = rng.random()
            if n == 0 or u < 0.35:
                m.insert(rng.randint(0, n), rng.choice(VALUES))
            elif u < 0.5:
                m.delete(rng.randrange(n), 1)
            elif u < 0.75:
                m.set(rng.randrange(n), rng.choice(VALUES))
            elif n >= 2:
                m.move(rng.randrange(n), rng.randrange(n))
    elif kind == "tree":
        tr = d.get_tree("tr")
        for _ in range(rng.randint(1, 5)):
            nodes = tr.nodes()
            u = rng.random()
            if not nodes or u < 0.4:
                tr.create(rng.choice(nodes) if nodes and rng.random() < 0.6 else None)
            elif u < 0.85 and len(nodes) >= 2:
                x, y = rng.sample(nodes, 2)
                try:
                    tr.move(x, y)
                except ValueError:
                    pass  # a cycle, rejected locally
            else:
                tr.delete(rng.choice(nodes))
    elif kind == "map":
        for _ in range(rng.randint(1, 5)):
            m = d.get_map(rng.choice(("m", "m2")))
            if rng.random() < 0.2:
                m.delete(rng.choice("abcde"))
            else:
                m.set(rng.choice("abcde"), rng.choice(VALUES))
    else:
        for _ in range(rng.randint(1, 6)):
            d.get_counter(f"c{rng.randrange(3)}").increment(rng.randint(-40, 40))


def _oracle(kind, d):
    if kind == "text":
        return d.get_text("t").to_string()
    if kind == "list":
        return d.get_list("t").get_value()
    if kind == "movable":
        return d.get_movable_list("l").get_value()
    if kind == "tree":
        tr = d.get_tree("tr")
        return {t_: tr.parent(t_) for t_ in tr.nodes()}
    if kind == "map":
        return d.get_map("m").get_value()
    return {name: d.get_counter(name).get_value() for name in ("c0", "c1", "c2") if name in d.get_deep_value()}


class _Docs:
    """Two replicas a doc slot, edited and synced each round; a round's
    payload of a slot is its first replica's updates since its last one
    (its whole history after the slot was given a fresh doc)."""

    def __init__(self, kind, rng, n_docs):
        self.kind, self.rng = kind, rng
        self.n_fresh = 0
        self.slots = [self._fresh(i) for i in range(n_docs)]

    def _fresh(self, i):
        self.n_fresh += 1
        a = LoroDoc(peer=PEERS[i % len(PEERS)] + 1000 * self.n_fresh)
        b = LoroDoc(peer=PEERS[(i + 2) % len(PEERS)] + 1000 * self.n_fresh + 1)
        if self.kind == "tree":
            for d in (a, b):
                d.get_tree("tr").enable_fractional_index(0)
        return [a, b, None]  # replicas, the last export's version

    def replace(self, i):
        self.slots[i] = self._fresh(i)

    def round(self, idle=0.25):
        out = []
        for slot in self.slots:
            a, b, vv = slot
            if self.rng.random() < idle:
                out.append(None)
                continue
            for d in (a, b):
                _edit(self.kind, self.rng, d)
                d.commit()
            b.import_(a.export_updates(b.oplog_vv()))
            a.import_(b.export_updates(a.oplog_vv()))
            out.append(_payload(a, vv))
            slot[2] = a.oplog_vv()
        return out

    def oracle(self):
        return [_oracle(self.kind, a) for a, _b, _vv in self.slots]


# the batch shapes a kind's scenarios use: (args, kwargs)
SHAPES = {
    "text": ((4, 64), dict(auto_grow=True)),
    "list": ((4, 64), dict(auto_grow=True)),
    "tree": ((4, 64, 32), dict(auto_grow=True)),
    "movable": ((4, 64, 32), dict(auto_grow=True)),
    "map": ((4, 8), dict(auto_grow=True)),
    "counter": ((4, 2), dict(auto_grow=True)),
}
NAMES = {"text": "t", "list": "t", "tree": "tr", "movable": "l", "map": "m", "counter": "c"}


def _script(kind):
    args, kw = SHAPES[kind]
    return _Script(kind, *args, name=NAMES[kind], **kw)


def sc_groups(kind, path, mode, seed=0, n_groups=3, size=3):
    """Rounds in groups of `size`, committed by flush_coalesce or (mode
    "detached") detached and committed on a second thread while the next
    group stages."""
    rng = random.Random(seed)
    docs = _Docs(kind, rng, 4)
    sc = _script(kind)
    for g in range(n_groups):
        sc.begin()
        for _ in range(size):
            sc.append(docs.round(), path)
        if mode == "detached" and g + 1 < n_groups:
            sc.detach_async()
            sc.begin()
            for _ in range(size):
                sc.append(docs.round(), path)
            sc.join()
        sc.flush()
        sc.check(docs.oracle(), rich=kind == "text" and g == n_groups - 1)
    return sc


def _counters():
    """Both packages' lifecycle counters, by family."""
    out = []
    for reg in (pobs, jobs):
        out.append({(name, fam): reg.counter(name).get(family=fam)
                    for name in ("pipeline.coalesced_rounds_total", "fleet.doc_releases_total")
                    for fam in KINDS})
    return out


def _counter_deltas(before, after):
    return [{k: a[k] - b[k] for k in a if a[k] != b[k]} for b, a in zip(before, after)]


GROUP_CASES = [(k, path, mode) for k in ("text", "list", "tree", "movable") for path in ("changes", "payloads")
               for mode in ("flush", "detached")]
GROUP_CASES += [("map", "payloads", "flush"), ("map", "changes", "detached"), ("counter", "changes", "flush"),
                ("counter", "changes", "detached")]


@pytest.mark.parametrize("kind,path,mode", GROUP_CASES)
def test_coalesced_groups_match_jax_and_serial(kind, path, mode, monkeypatch):
    """Groups of three rounds: after each group's commit the checkpoint
    bytes and reads equal the JAX batch's (same groups) and the port
    batch fed serially, and the reads the LoroDoc oracle; one scatter (or
    fold) a group where JAX launches one, fewer than serially; the
    lifecycle counters move as JAX's do."""
    sc = sc_groups(kind, path, mode, seed=len(kind) + (path == "payloads"))
    before = _counters()
    launches, j_launches, serial = _both(sc, monkeypatch)
    d_port, d_jax = _counter_deltas(before, _counters())
    assert launches == j_launches and launches < serial
    assert d_jax[("pipeline.coalesced_rounds_total", kind)] > 0 and d_port == d_jax


def sc_fallback(kind):
    """A group whose merged window passes the capacity though each round
    fit: 10 new rows a round at cap 30 (a round's window is 16 wide, the
    merged one 32), so the commit takes one scatter a round."""
    doc = LoroDoc(peer=3)
    if kind == "text":
        t = doc.get_text("t")
        sc = _Script("text", 1, 30, name="t")
    else:
        tr = doc.get_tree("tr")
        sc = _Script("tree", 1, 30, 32, name="tr")
    vv = None
    sc.begin()
    for r in range(2):
        if kind == "text":
            t.insert(len(t), "0123456789")
        else:
            for _ in range(10):
                tr.create()
        doc.commit()
        sc.append([_payload(doc, vv)])
        vv = doc.oplog_vv()
    sc.flush()
    sc.check([_oracle(kind, doc)])
    return sc


@pytest.mark.parametrize("kind", ["text", "tree"])
def test_merged_window_past_the_capacity_takes_one_scatter_a_round(kind, monkeypatch):
    sc = sc_fallback(kind)
    launches, j_launches, serial = _both(sc, monkeypatch)
    assert launches == j_launches == serial == 2


def _add_rows(kind, doc, n):
    """n new device rows in one doc: characters, list values, tree nodes
    or movable elements (a slot row each)."""
    if kind == "text":
        t = doc.get_text("t")
        t.insert(len(t), "x" * n)
    elif kind == "list":
        lst = doc.get_list("t")
        for i in range(n):
            lst.insert(len(lst), i)
    elif kind == "tree":
        tr = doc.get_tree("tr")
        for _ in range(n):
            tr.create()
    else:
        ml = doc.get_movable_list("l")
        for i in range(n):
            ml.insert(len(ml), i)
    doc.commit()


def sc_idle_near_capacity(kind, mode, merged):
    """Doc 0 holds 60 of its 64 rows and stays idle through a group while
    doc 1 appends 6 rows a round for 3 rounds.  merged=True: doc 1 starts
    at 4 rows and the group commits in one scatter; merged=False: doc 1
    starts at 34, the merged window (34 + 32) passes the capacity and the
    commit takes one scatter a round.  Either way the idle doc's window
    must not start at its row count (60 + 16 > 64).  mode "detached": the
    group commits on a second thread (while, when merged, a second group
    stages 2 more rounds)."""
    docs = [LoroDoc(peer=5), LoroDoc(peer=6)]
    if kind == "tree":
        for d in docs:
            d.get_tree("tr").enable_fractional_index(0)
    args = {"text": (2, 64), "list": (2, 64), "tree": (2, 64, 64), "movable": (2, 64, 64)}[kind]
    sc = _Script(kind, *args, name=NAMES[kind])
    vv = [None, None]

    def feed(rows):
        out = []
        for i, n in enumerate(rows):
            if not n:
                out.append(None)
                continue
            _add_rows(kind, docs[i], n)
            out.append(_payload(docs[i], vv[i]))
            vv[i] = docs[i].oplog_vv()
        sc.append(out)

    feed([60, 4 if merged else 34])
    sc.check([_oracle(kind, d) for d in docs])
    sc.begin()
    for _ in range(3):
        feed([0, 6])
    if mode == "detached":
        sc.detach_async()
        if merged:
            sc.begin()
            for _ in range(2):
                feed([0, 6])
        sc.join()
    sc.flush()
    sc.check([_oracle(kind, d) for d in docs])
    return sc


@pytest.mark.parametrize("merged", [True, False], ids=["merged", "per_round"])
@pytest.mark.parametrize("mode", ["flush", "detached"])
@pytest.mark.parametrize("kind", ["text", "list", "tree", "movable"])
def test_idle_doc_near_the_capacity_keeps_its_rows_through_a_group(kind, mode, merged, monkeypatch):
    """A doc idle through a group gets offset 0 in the group's scatters,
    as in a serial append: no window reaches past the capacity, and the
    bytes, reads and launches equal JAX's (which clamps such a window)."""
    sc = sc_idle_near_capacity(kind, mode, merged)
    launches, j_launches, serial = _both(sc, monkeypatch)
    groups = 2 if merged and mode == "detached" else 1
    scatters = groups if merged else 3
    folds = 2 if kind == "movable" else 0  # a movable commit also folds moves and values
    assert launches == j_launches == (1 + folds) + scatters + folds * groups


def sc_renumber_detached(seed):
    """Same-spot inserts renumber a doc's keys every round: the detached
    commit re-uploads the renumbered key rows from its detach-time
    snapshot while the next group renumbers the doc again."""
    rng = random.Random(seed)
    doc = LoroDoc(peer=9)
    t = doc.get_text("t")
    t.insert(0, "ab")
    doc.commit()
    other = LoroDoc(peer=11)
    sc = _Script("text", 2, 4096, name="t")
    vv = [None, None]

    def round_():
        for _ in range(40):
            t.insert(1, rng.choice("xyz"))
            doc.commit()
        o = other.get_text("t")
        o.insert(rng.randint(0, len(o)), "pq")
        other.commit()
        out = [_payload(doc, vv[0]), _payload(other, vv[1])]
        vv[:] = [doc.oplog_vv(), other.oplog_vv()]
        return out

    for g in range(3):
        sc.begin()
        sc.append(round_(), "payloads")
        sc.append(round_(), "payloads")
        sc.detach_async()
        sc.begin()
        sc.append(round_(), "payloads")
        sc.join()
        sc.flush()
        sc.check([t.to_string(), other.get_text("t").to_string()])
    return sc


@pytest.mark.parametrize("seed", range(2))
def test_renumbered_keys_of_a_detached_group_come_from_its_snapshot(seed, monkeypatch):
    calls = []
    real = pfleet.DeviceDocBatch._upload_renumbered_keys

    def spy(self, renumbered, key_snap=None):
        calls.append(key_snap is not None)
        return real(self, renumbered, key_snap)

    monkeypatch.setattr(pfleet.DeviceDocBatch, "_upload_renumbered_keys", spy)
    _both(sc_renumber_detached(seed))
    assert any(calls), "no detached group renumbered"


def sc_insert_then_delete_in_one_group():
    """A row appended and deleted in the same group ends up deleted (the
    merged scatter runs before the group's tombstones)."""
    doc = LoroDoc(peer=2)
    t = doc.get_text("t")
    sc = _Script("text", 1, 64, name="t")
    sc.begin()
    t.insert(0, "abcdef")
    doc.commit()
    sc.append([_payload(doc)])
    vv = doc.oplog_vv()
    t.delete(1, 3)
    doc.commit()
    sc.append([_payload(doc, vv)])
    vv = doc.oplog_vv()
    t.insert(2, "XY")
    doc.commit()
    sc.append([_payload(doc, vv)])
    sc.flush()
    sc.check([t.to_string()])
    return sc


def test_insert_then_delete_in_one_group():
    _both(sc_insert_then_delete_in_one_group())


def sc_release(kind, in_group, seed=0):
    """Three rounds, then doc 1 released (outside a group, or inside an
    open one after a round that leaves it idle) and its row checked
    against a fresh batch's; the slot refilled with a fresh doc's whole
    history; two more rounds."""
    rng = random.Random(100 + seed)
    docs = _Docs(kind, rng, 4)
    sc = _script(kind)
    for _ in range(3):
        sc.append(docs.round())
    sc.check(docs.oracle())
    if in_group:
        sc.begin()
        p = docs.round()
        p[1] = None
        sc.append(p)
    sc.release(1)
    sc.steps.append(("released_fresh", 1))
    docs.replace(1)
    sc.append(docs.round(idle=0.0))
    if in_group:
        sc.flush()
    sc.check(docs.oracle())
    for _ in range(2):
        sc.append(docs.round())
    sc.check(docs.oracle())
    return sc


@pytest.mark.parametrize("in_group", [False, True], ids=["outside", "in_group"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_release_doc_matches_jax(kind, in_group):
    """release_doc on every batch kind: checkpoint bytes and reads equal
    JAX's after every step, the released device row equals a fresh
    batch's, and the refilled slot reads as its new doc."""
    before = _counters()
    _both(sc_release(kind, in_group), serial=in_group)
    d_port, d_jax = _counter_deltas(before, _counters())
    key = ("fleet.doc_releases_total", kind)
    assert d_jax[key] == 1
    assert d_port[key] == (2 if in_group else 1)  # the port ran it serially too


def sc_lifecycle_fuzz(kind, seed):
    """Random appends, groups (flushed or detached), releases with
    refills, compactions (kinds that have them) and checkpoint round
    trips."""
    rng = random.Random(0x1F3 + seed)
    n = SHAPES[kind][0][0]
    docs = _Docs(kind, rng, n)
    sc = _script(kind)
    sc.append(docs.round(idle=0.0))
    in_group = False
    staged = set()  # slots with rows in the open group: not released (the contract)
    for _step in range(14):
        u = rng.random()
        if not in_group and u < 0.25:
            sc.begin()
            in_group, staged = True, set()
        elif in_group and u < 0.4:
            sc.flush()
            in_group = False
        elif u < 0.5:
            free = [di for di in range(n) if di not in staged]
            if free:
                di = rng.choice(free)
                sc.release(di)
                docs.replace(di)  # its next round ships the new doc's whole history
        elif not in_group and u < 0.62 and kind in ("text", "list", "tree", "movable"):
            sc.compact([rng.choice(["E", "E", None, 1]) for _ in range(n)])
        elif not in_group and u < 0.68:
            sc.roundtrip()
        else:
            p = docs.round()
            staged |= {di for di, x in enumerate(p) if x}
            sc.append(p, rng.choice(["changes", "payloads"]))
        if not in_group:
            sc.check(docs.oracle())
    if in_group:
        sc.flush()
    sc.check(docs.oracle())
    return sc


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("kind", list(KINDS))
def test_lifecycle_fuzz_matches_jax(kind, seed):
    """Any mix of appends, groups, releases, compactions and round trips:
    equal bytes, return values and reads after every step, the reads
    equal to the LoroDoc oracle."""
    _both(sc_lifecycle_fuzz(kind, seed), serial=False)


@pytest.mark.parametrize("side", [J, P], ids=["jax", "port"])
def test_detached_commit_uploads_the_detach_time_keys(side):
    """A group that renumbered doc 0 is detached, the next group stages
    more rows into doc 0 (its order engine moves on), then the first
    group commits: doc 0's key row holds the detach-time keys and the
    fill past them, not the live engine's keys of the staged rows."""
    doc = LoroDoc(peer=9)
    t = doc.get_text("t")
    t.insert(0, "ab")
    doc.commit()
    payloads, vv = [], None
    for _ in range(3):
        for _ in range(40):
            t.insert(1, "x")
            doc.commit()
        payloads.append(_payload(doc, vv))
        vv = doc.oplog_vv()
    b = side.new("text", 1, 4096)
    cid = side.cid("text", "t")
    b.append_payloads([payloads[0]], cid)
    b.begin_coalesce()
    b.append_payloads([payloads[1]], cid)
    d = b.detach_coalesce()
    assert d.renumbered == {0} and d.key_snap is not None
    k1 = int(b.counts[0])
    b.begin_coalesce()
    b.append_payloads([payloads[2]], cid)
    assert int(b.counts[0]) > k1
    b.commit_detached(d)
    kh = _host(b.key_hi)[0].astype(np.int64)
    kl = _host(b.key_lo)[0].astype(np.int64)
    sh, sl = pfleet.split_keys(d.key_snap[0])
    assert len(sh) == k1 and np.array_equal(kh[:k1], sh) and np.array_equal(kl[:k1], sl)
    assert (kh[k1:] == 0xFFFFFFFF).all() and (kl[k1:] == 0xFFFFFFFF).all()
    b.flush_coalesce()
    assert b.texts() == [t.to_string()]
