"""The port's one-shot fleet text merge (loro_tpu_torch.parallel.fleet)
and what it stands on (core.change, core.ids, core.version, the
codec's decode_changes, columnar.extract_seq_container), against the
JAX package on the CPU.

Inputs: fuzzed 2-3 peer LoroDoc histories over every container kind
(text with marks, map, list, movable list, tree, counter) and every
value tag, payloads built from change lists with the JAX encoder (run
continuations, unknown ops, deletes of ids never inserted), and seeded
tracegen documents.  Change trees of the two packages are compared
through _plain (class names and field values), never by == across
packages.  Every comparison is exact (tolerance: none).
"""
import dataclasses
import enum
import random

import numpy as np
import pytest

from loro_tpu import LoroDoc
from loro_tpu.codec.binary import decode_changes as jdecode
from loro_tpu.codec.binary import encode_changes
from loro_tpu.core import change as jch
from loro_tpu.core.ids import ID, IdSpan, TreeID
from loro_tpu.core.ids import ContainerID as JContainerID
from loro_tpu.core.ids import ContainerType as JContainerType
from loro_tpu.core.version import Frontiers
from loro_tpu.doc import strip_envelope
from loro_tpu.obs import metrics as jobs
from loro_tpu.ops import columnar as jcol
from loro_tpu.ops import fugue_batch as jfb
from loro_tpu.oplog.oplog import _RUN_CONT as J_RUN_CONT
from loro_tpu.parallel.fleet import Fleet as JFleet
from loro_tpu_torch import tracegen
from loro_tpu_torch.codec.binary import decode_changes as pdecode
from loro_tpu_torch.core import change as pch
from loro_tpu_torch.core.ids import ContainerID, ContainerType
from loro_tpu_torch.core.ids import ID as PID
from loro_tpu_torch.core.version import Frontiers as PFrontiers
from loro_tpu_torch.errors import CodecDecodeError, DecodeError
from loro_tpu_torch.ops import columnar as pcol
from loro_tpu_torch.ops import fugue_batch as pfb
from loro_tpu_torch.parallel import fleet as pfleet

FIELDS = ("parent", "side", "peer", "counter", "deleted", "content", "valid")
VALUES = [None, True, False, -7, 2**40, 2.5, "v☃", b"\x00\xff", [1, "a", None], {"n": 2.5, "l": [True]}]


def _plain(x):
    """A package-neutral form of a decoded object tree: class names and
    field values, with scalars tagged by type (so True != 1)."""
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return [("key", k, _plain(v)) for k, v in x.items()]
    if isinstance(x, enum.Enum):
        return (type(x).__name__, int(x))
    if hasattr(x, "_fields"):  # ID, IdSpan, TreeID
        return (type(x).__name__,) + tuple(_plain(v) for v in x)
    name = type(x).__name__
    if name == "ContainerID":
        return ("cid", int(x.ctype), x.name, x.peer, x.counter)
    if name == "Frontiers":
        return ("Frontiers", _plain(list(x.as_ids())))
    if name == "_RunCont":
        return ("run-cont",)
    if dataclasses.is_dataclass(x):
        return (name,) + tuple(_plain(getattr(x, f.name)) for f in dataclasses.fields(x))
    return (type(x).__name__, x)


def _sync_all(docs):
    for _ in range(2):
        for s in docs:
            for t in docs:
                if s is not t:
                    t.import_(s.export_updates(t.oplog_vv()))


def _fuzz_docs(seed: int, n_peers: int, steps: int = 60, marks: bool = True, kinds: bool = True):
    """Synced peers: text inserts and deletes (multi-byte utf8 too) and,
    with `marks`, marks and unmarks; with `kinds`, also map sets (every
    value tag, a child container), deletes, list inserts, movable list
    inserts, moves, sets and deletes, tree creates, moves and deletes,
    and counter increments.  Returns the docs (all equal)."""
    rng = random.Random(seed)
    docs = [LoroDoc(peer=rng.getrandbits(50) + 1) for _ in range(n_peers)]
    docs[0].get_tree("tr").enable_fractional_index(0)
    for _ in range(steps):
        d = rng.choice(docs)
        t = d.get_text("t")
        r = rng.random()
        if marks and len(t) > 2 and r < 0.1:
            a = rng.randint(0, len(t) - 2)
            if rng.random() < 0.7:
                t.mark(a, rng.randint(a + 1, len(t)), rng.choice(["bold", "color"]), rng.choice([True, "red"]))
            else:
                t.unmark(a, rng.randint(a + 1, len(t)), "bold")
        elif len(t) and r < 0.4:
            pos = rng.randint(0, len(t) - 1)
            t.delete(pos, min(rng.randint(1, 3), len(t) - pos))
        else:
            t.insert(rng.randint(0, len(t)), rng.choice(["ab", "ç", "1234", "☃", "x"]))
        if kinds:
            r = rng.random()
            if r < 0.2:
                d.get_map("m").set(rng.choice("kqz"), rng.choice(VALUES))
            elif r < 0.25:
                d.get_map("m").delete(rng.choice("kqz"))
            elif r < 0.28:
                d.get_map("m").set_container(rng.choice("cd"), JContainerType.Map)
            elif r < 0.4:
                ll = d.get_list("l")
                ll.insert(rng.randint(0, len(ll)), rng.choice(VALUES))
                if len(ll) > 3:
                    ll.delete(0, 1)
            elif r < 0.55:
                ml = d.get_movable_list("ml")
                n = len(ml)
                r2 = rng.random()
                if n < 2 or r2 < 0.4:
                    ml.insert(rng.randint(0, n), rng.randint(0, 99))
                elif r2 < 0.7:
                    ml.move(rng.randint(0, n - 1), rng.randint(0, n - 1))
                elif r2 < 0.85:
                    ml.set(rng.randint(0, n - 1), rng.choice(VALUES))
                else:
                    ml.delete(rng.randint(0, n - 1), 1)
            elif r < 0.7:
                tr = d.get_tree("tr")
                ns = tr.nodes()
                r2 = rng.random()
                if not ns or r2 < 0.5:
                    tr.create(rng.choice(ns) if ns and rng.random() < 0.5 else None)
                elif r2 < 0.8:
                    try:
                        tr.move(rng.choice(ns), rng.choice(ns + [None]))
                    except Exception:  # a move into the node's own subtree
                        pass
                else:
                    tr.delete(rng.choice(ns))
            elif r < 0.8:
                d.get_counter("c").increment(rng.choice([1.0, -2.5, 0.125]))
        d.commit(message=rng.choice([None, "msg"]))
        if rng.random() < 0.3:
            src, dst = rng.sample(docs, 2)
            dst.import_(src.export_updates(dst.oplog_vv()))
    _sync_all(docs)
    docs[0].commit()
    return docs


def _payload(doc) -> bytes:
    return strip_envelope(doc.export_updates())


def _jtext():
    return JContainerID.root("t", JContainerType.Text)


def _pcid(cid: JContainerID) -> ContainerID:
    if cid.is_root:
        return ContainerID.root(cid.name, ContainerType(int(cid.ctype)))
    return ContainerID.normal(cid.peer, cid.counter, ContainerType(int(cid.ctype)))


def _crafted_payload() -> bytes:
    """JAX-encoded changes with what LoroDoc histories do not write: a
    run continuation parent, an unknown op, a delete of ids never
    inserted, a container value of a normal container, a timestamp and
    deps on two peers."""
    t = _jtext()
    lst = JContainerID.normal(7, 0, JContainerType.List)
    m = JContainerID.root("m", JContainerType.Map)
    c1 = jch.Change(ID(7, 0), 0, Frontiers(), [
        jch.Op(0, t, jch.SeqInsert(None, jch.Side.Right, "abc")),
        jch.Op(3, lst, jch.SeqInsert(None, jch.Side.Right, (1, "x", [2.5]))),
    ], timestamp=1_700_000_000)
    c2 = jch.Change(ID(9, 0), 0, Frontiers(), [
        jch.Op(0, t, jch.SeqInsert(None, jch.Side.Left, "Q")),
    ], timestamp=1_699_999_990, message="m2")
    c3 = jch.Change(ID(7, 6), 6, Frontiers([ID(7, 5), ID(9, 0)]), [
        jch.Op(6, t, jch.SeqInsert(ID(7, 1), jch.Side.Left, "de")),
        jch.Op(8, t, jch.SeqInsert(J_RUN_CONT, jch.Side.Right, "fg")),
        jch.Op(10, t, jch.SeqDelete((IdSpan(7, 1, 2), IdSpan(9, 40, 44), IdSpan(123, 0, 3)))),
        jch.Op(11, lst, jch.SeqInsert(ID(7, 5), jch.Side.Right, (None,))),
        jch.Op(12, m, jch.MapSet("k", lst)),
        jch.Op(13, m, jch.MapSet("gone", None, True)),
        jch.Op(14, JContainerID.root("u", JContainerType.Unknown), jch.UnknownContent(3, b"\x01\x02")),
        jch.Op(15, JContainerID.root("ml", JContainerType.MovableList),
               jch.MovableMove(ID(7, 3), J_RUN_CONT, jch.Side.Right)),
        jch.Op(16, JContainerID.root("tr", JContainerType.Tree),
               jch.TreeMove(TreeID(7, 16), TreeID(9, 0), b"\x80", True, False)),
    ])
    return encode_changes([c1, c2, c3])


_FUZZ = [(seed, 2 + seed % 2) for seed in range(4)]


@pytest.fixture(scope="module")
def fuzz_payloads():
    return [_payload(_fuzz_docs(seed, n)[0]) for seed, n in _FUZZ] + [_crafted_payload()]


def test_decode_changes_matches_jax(fuzz_payloads):
    """Field by field, on every payload; between them the payloads carry
    every op kind and every value tag."""
    kinds, tags = set(), set()

    def visit(v):
        tags.add(type(v).__name__)
        if isinstance(v, (list, tuple)):
            for x in v:
                visit(x)
        elif isinstance(v, dict):
            for x in v.values():
                visit(x)

    for p in fuzz_payloads:
        want, got = jdecode(p), pdecode(p)
        assert all(isinstance(c, pch.Change) for c in got)
        assert _plain(got) == _plain(want)
        for ch in got:
            for op in ch.ops:
                c = op.content
                kinds.add((type(c).__name__, type(getattr(c, "content", None)).__name__, getattr(c, "deleted", None)))
                if isinstance(c, pch.MapSet) and not c.deleted:
                    visit(c.value)
                elif isinstance(c, pch.MovableSet):
                    visit(c.value)
                elif isinstance(c, pch.SeqInsert) and isinstance(c.content, tuple):
                    visit(list(c.content))
    # the 11 op kinds of the wire
    assert {("MapSet", "NoneType", False), ("MapSet", "NoneType", True), ("SeqInsert", "str", None),
            ("SeqInsert", "tuple", None), ("SeqInsert", "StyleAnchor", None), ("SeqDelete", "NoneType", None),
            ("TreeMove", "NoneType", None), ("CounterIncr", "NoneType", None), ("MovableSet", "NoneType", None),
            ("MovableMove", "NoneType", None), ("UnknownContent", "NoneType", None)} <= kinds
    # the 10 value tags
    assert {"NoneType", "bool", "int", "float", "str", "bytes", "list", "dict", "ContainerID"} <= tags


def test_decode_changes_run_continuation_and_ids():
    """The crafted payload's run continuation decodes to the port's own
    sentinel, and its ids, spans and deps are the port's types."""
    got = pdecode(_crafted_payload())
    ins = got[2].ops[1].content
    assert ins.parent is pch._RUN_CONT and isinstance(ins.parent, pch._RunCont)
    assert got[2].deps.as_ids() == (PID(7, 5), PID(9, 0))
    assert got[2].ops[2].content.spans[1] == (9, 40, 44) and len(got[2].ops[2].content.spans[1]) == 4
    assert got[0].ctr_end == 6 and got[2].lamport_end == 6 + got[2].atom_len()
    assert ContainerID.parse(repr(got[2].ops[4].container)) == got[2].ops[4].container
    m, t, lst = got[2].ops[4].container, _pcid(_jtext()), got[0].ops[1].container
    assert sorted([lst, t, m]) == [m, t, lst]  # roots by name, then normals


def test_decode_malformed_raises_codec_error_in_both(fuzz_payloads):
    """Truncated payloads raise CodecDecodeError in both packages; after
    each single-byte flip both raise it, or both decode the same
    changes."""
    p = fuzz_payloads[1]
    for cut in (1, len(p) // 3, len(p) // 2, len(p) - 1):
        for dec in (jdecode, pdecode):
            with pytest.raises(ValueError) as ei:
                dec(p[:cut])
            assert type(ei.value).__name__ == "CodecDecodeError"
    with pytest.raises(CodecDecodeError):
        pdecode(p[: len(p) // 2])
    assert issubclass(CodecDecodeError, DecodeError) and issubclass(CodecDecodeError, ValueError)
    rng = random.Random(5)
    raised = 0
    for _ in range(120):
        i = rng.randrange(len(p))
        q = bytearray(p)
        q[i] ^= 1 << rng.randrange(8)
        outcome = []
        for dec in (jdecode, pdecode):
            try:
                outcome.append(_plain(dec(bytes(q))))
            except ValueError as e:
                assert type(e).__name__ == "CodecDecodeError", (i, e)
                outcome.append("CodecDecodeError")
        assert outcome[0] == outcome[1], i
        raised += outcome[0] == "CodecDecodeError"
    assert raised > 0


def _assert_same_extract(a, b) -> None:
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert list(a.peers) == list(b.peers)
    assert _plain(a.values) == _plain(b.values)


def test_extract_seq_container_matches_jax(fuzz_payloads):
    """Text containers (as_text) and list containers (values), marks'
    anchors skipped, on the fuzzed histories and the crafted payload (a
    run continuation parent, deletes of ids never inserted)."""
    for p in fuzz_payloads:
        jchanges, pchanges = jdecode(p), pdecode(p)
        jcids = {op.container for ch in jchanges for op in ch.ops}
        for jcid in sorted(jcids):
            if jcid.ctype not in (JContainerType.Text, JContainerType.List):
                continue
            as_text = jcid.ctype == JContainerType.Text
            try:
                want = jcol.extract_seq_container(jchanges, jcid, as_text=as_text)
            except KeyError:  # an insert after a mark's anchor: not self-contained in both
                with pytest.raises(KeyError):
                    pcol.extract_seq_container(pchanges, _pcid(jcid), as_text=as_text)
                continue
            got = pcol.extract_seq_container(pchanges, _pcid(jcid), as_text=as_text)
            _assert_same_extract(got, want)
            assert got.n > 0
    crafted = pdecode(fuzz_payloads[-1])
    ex = pcol.extract_seq_container(crafted, _pcid(_jtext()))
    assert tracegen.oracle_text(ex) == "adefgcQ"  # root children in (peer, counter) order
    lst = pcol.extract_seq_container(crafted, ContainerID.normal(7, 0, ContainerType.List), as_text=False)
    assert lst.values == [1, "x", [2.5], None] and lst.content.tolist() == [0, 1, 2, 3]


@pytest.fixture(scope="module")
def jfleet():
    return JFleet()


def _texts_docs(seed: int, n: int):
    """Synced docs of text, map and list ops (no marks): the first doc's
    payload and changes, and its text."""
    docs = _fuzz_docs(seed, n, steps=40, marks=False)
    return _payload(docs[0]), docs[0].oplog.changes_in_causal_order(), docs[0].get_text("t").to_string()


@pytest.fixture(scope="module")
def text_docs():
    out = [_texts_docs(100 + i, 2 + i % 2) for i in range(3)]
    quiet = LoroDoc(peer=77)  # no op on the text container
    quiet.get_map("m").set("k", 1)
    quiet.commit()
    out.append((_payload(quiet), quiet.oplog.changes_in_causal_order(), ""))
    return out


@pytest.mark.parametrize("pad_docs", [None, 8, 6])
def test_fleet_merges_match_jax_and_the_doc(jfleet, text_docs, pad_docs):
    """merge_text_docs, merge_text_changes and merge_text_payloads give
    the JAX Fleet's texts and the LoroDoc's own, with the doc axis
    padded or not (a doc without text ops merges to "")."""
    payloads = [p for p, _, _ in text_docs]
    want = [t for _, _, t in text_docs]
    pf = pfleet.Fleet(device="cpu")
    jcid, cid = _jtext(), _pcid(_jtext())
    j = jfleet.merge_text_payloads(payloads, jcid).texts
    assert j == want
    before = pfleet.FLEET_FALLBACKS["payload_extract"]
    assert pf.merge_text_payloads(payloads, cid).texts == want
    assert pfleet.FLEET_FALLBACKS["payload_extract"] == before
    assert pf.merge_text_changes([pdecode(p) for p in payloads], cid).texts == want
    assert jfleet.merge_text_changes([chs for _, chs, _ in text_docs], jcid).texts == want
    jex = [jcol.extract_seq_container(jdecode(p), jcid) for p in payloads]
    pex = [pcol.extract_seq_from_payload(p, cid) for p in payloads]
    # the JAX doc axis is sharded over the tests' 8 virtual devices, so
    # its pad_docs must be a multiple of 8; the port's is any count
    assert jfleet.merge_text_docs(jex, pad_docs=pad_docs if pad_docs != 6 else None).texts == want
    assert pf.merge_text_docs(pex, pad_docs=pad_docs).texts == want
    # the batch equals the JAX package's construction: per-doc padded
    # copies, all-invalid filler docs, one np.stack a column
    n = pfb.pad_bucket(max(e.n for e in pex))
    batch = pfb.stack_seq_columns(pex, n, pad_docs)
    per_doc = [e.to_seq_columns(pad_to=n) for e in jex]
    per_doc += [jfb.SeqColumns(np.full(n, -1, np.int32), np.zeros(n, np.int32), np.zeros(n, np.int32),
                               np.zeros(n, np.int32), np.ones(n, bool), np.full(n, -1, np.int32),
                               np.zeros(n, bool))] * ((pad_docs or len(pex)) - len(pex))
    for f in pfb.SeqColumns._fields:
        want_f = np.stack([getattr(c, f) for c in per_doc])
        got_f = getattr(batch, f)
        assert got_f.dtype == want_f.dtype and np.array_equal(got_f, want_f), f


def _fallbacks_jax() -> float:
    return jobs.counter("fleet.host_fallback_total").get(kind="payload_extract")


def _dup_peer_payload() -> bytes:
    """A payload the native explode rejects and the Python decode
    resolves: its peer table names one peer id twice (as a corrupted
    table entry would), and an insert names its parent through the
    other entry.  The explode keys elements by table index, the decode
    by peer id."""
    t = _jtext()
    c1 = jch.Change(ID(1, 0), 0, Frontiers(), [jch.Op(0, t, jch.SeqInsert(None, jch.Side.Right, "abc"))])
    c2 = jch.Change(ID(2, 10), 3, Frontiers(), [jch.Op(10, t, jch.SeqInsert(ID(1, 2), jch.Side.Right, "de"))])
    c3 = jch.Change(ID(1, 3), 5, Frontiers(), [jch.Op(3, t, jch.SeqInsert(ID(1, 10), jch.Side.Left, "XY"))])
    p = bytearray(encode_changes([c1, c2, c3]))
    assert p[0] == 2 and p[1:9] == (1).to_bytes(8, "little") and p[9:17] == (2).to_bytes(8, "little")
    p[9:17] = (1).to_bytes(8, "little")
    return bytes(p)


def test_fleet_fallback_counts_where_jax_takes_its_python_path(jfleet, text_docs):
    """The duplicate-peer payload: both packages fall back once and give
    the same text.  A payload with marks whose insert hangs off an
    anchor, and an incremental payload: both fall back, then raise
    ValueError (not self-contained).  Clean payloads never fall back."""
    from loro_tpu.native import available

    assert available()
    jcid, cid = _jtext(), _pcid(_jtext())
    pf = pfleet.Fleet(device="cpu")
    dup = _dup_peer_payload()
    with pytest.raises(ValueError):
        pcol.extract_seq_from_payload(dup, cid)
    with pytest.raises(ValueError):
        jcol.extract_seq_from_payload(dup, jcid)
    j0, p0 = _fallbacks_jax(), pfleet.FLEET_FALLBACKS["payload_extract"]
    want = jfleet.merge_text_payloads([dup, text_docs[0][0]], jcid).texts
    got = pf.merge_text_payloads([dup, text_docs[0][0]], cid).texts
    assert got == want and got[1] == text_docs[0][2]
    assert want[0] == "abcXYde"
    assert _fallbacks_jax() == j0 + 1 and pfleet.FLEET_FALLBACKS["payload_extract"] == p0 + 1

    marked = LoroDoc(peer=5)
    t = marked.get_text("t")
    t.insert(0, "hello world")
    t.mark(0, 5, "bold", True)
    marked.commit()
    t.insert(0, "Z")  # its parent is the mark's start anchor
    marked.commit()
    base = LoroDoc(peer=6)
    base.get_text("t").insert(0, "base")
    base.commit()
    other = LoroDoc(peer=8)
    other.import_(base.export_updates())
    vv = other.oplog_vv()
    other.get_text("t").insert(2, "--")
    other.commit()
    incremental = strip_envelope(other.export_updates(vv))
    for bad in (_payload(marked), incremental):
        j0, p0 = _fallbacks_jax(), pfleet.FLEET_FALLBACKS["payload_extract"]
        with pytest.raises(ValueError, match="not self-contained"):
            jfleet.merge_text_payloads([bad], jcid)
        with pytest.raises(ValueError, match="not self-contained"):
            pf.merge_text_payloads([bad], cid)
        assert _fallbacks_jax() == j0 + 1 and pfleet.FLEET_FALLBACKS["payload_extract"] == p0 + 1


def test_fleet_marks_without_anchor_parents_match_jax(jfleet):
    """Marks whose anchors no insert hangs off: the native explode skips
    the anchors, no fallback, and the text is the doc's."""
    d = LoroDoc(peer=11)
    t = d.get_text("t")
    t.insert(0, "hello world")
    t.mark(2, 7, "bold", True)
    t.insert(len(t), "!")
    t.insert(1, "Q")
    d.commit()
    p = _payload(d)
    p0 = pfleet.FLEET_FALLBACKS["payload_extract"]
    got = pfleet.Fleet(device="cpu").merge_text_payloads([p], _pcid(_jtext())).texts
    assert got == jfleet.merge_text_payloads([p], _jtext()).texts == [t.to_string()]
    assert pfleet.FLEET_FALLBACKS["payload_extract"] == p0


def test_fleet_texts_take_lone_surrogates_as_jax(jfleet):
    """Codepoints that are lone surrogates (a Python str may hold them):
    the port's one decode a row gives JAX's chr join, and a codepoint
    past U+10FFFF raises ValueError where chr does."""
    text = "a\ud800b\udfffc\U0001f600"
    jt, pt = _jtext(), _pcid(_jtext())
    jchs = [jch.Change(ID(3, 0), 0, Frontiers(), [jch.Op(0, jt, jch.SeqInsert(None, jch.Side.Right, text))])]
    pchs = [pch.Change(PID(3, 0), 0, PFrontiers(), [pch.Op(0, pt, pch.SeqInsert(None, pch.Side.Right, text))])]
    got = pfleet.Fleet(device="cpu").merge_text_changes([pchs, []], pt).texts
    assert got == jfleet.merge_text_changes([jchs, []], jt).texts == [text, ""]
    with pytest.raises(ValueError):
        pfleet.texts_of(np.array([[0x41, 0x110000]], np.int32), np.array([2]), 1)
    with pytest.raises(ValueError):
        chr(0x110000)


def test_fleet_codec_build_failure_propagates(monkeypatch):
    """A codec that cannot be built raises RuntimeError out of the
    merge; it is not a decode fallback."""
    from loro_tpu_torch import native

    def broken(*a, **k):
        raise RuntimeError("g++ failed")

    monkeypatch.setattr(native, "_lib_handle", None)
    monkeypatch.setattr("loro_tpu_torch._build.library", broken)
    p0 = pfleet.FLEET_FALLBACKS["payload_extract"]
    docs = tracegen.fleet_docs(0, n_patches=50, seed=1, use_cache=False)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        pfleet.Fleet(device="cpu").merge_text_payloads([tracegen.trace_payload(docs[0], use_cache=False)],
                                                       tracegen.TEXT_CID)
    assert pfleet.FLEET_FALLBACKS["payload_extract"] == p0


@pytest.mark.parametrize("order", ["apply", "peer"])
def test_seq_columns_u_merges_to_the_doc_text(order):
    """tracegen.seq_columns_u in either row order: the port's and the
    JAX package's merge_docs_u give the doc's text."""
    docs = tracegen.fleet_docs(2, n_patches=1500, seed=4, use_cache=False)
    u = [tracegen.seq_columns_u(d, order, pad_to=2048) for d in docs]
    st = pfb.SeqColumnsU(*[np.stack([getattr(x, f) for x in u]) for f in pfb.SeqColumnsU._fields])
    codes, counts = pfb.merge_docs_u(pfb.seq_columns_to_torch(st, device="cpu"), device="cpu")
    jcodes, jcounts = jfb.merge_docs_u(jfb.SeqColumnsU(*[np.asarray(a) for a in st]))
    assert np.array_equal(codes.numpy(), np.asarray(jcodes)) and np.array_equal(counts.numpy(), np.asarray(jcounts))
    for i, d in enumerate(docs):
        assert "".join(map(chr, codes[i, : int(counts[i])].tolist())) == d.text
    if order == "apply":
        ins = d.events["insert"].astype(bool)
        assert u[-1].counter[: d.extract.n].tolist() == d.events["counter"][ins].tolist()
