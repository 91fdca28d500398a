"""The port's payload ingest (loro_tpu_torch.codec, .native, the payload
half of ops.columnar, tracegen's payloads) and its packed uint8
transport, against the JAX package on the CPU.

Inputs: fuzzed 2-3 peer LoroDoc histories with a text, a map and a list
container (so the native explode skips ops of other containers), and
seeded tracegen documents of a few thousand patches.  Every comparison
is exact (tolerance: none): element tables, payload bytes, packed bytes,
merged codes and checksums are integers and must be identical.
"""
import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from loro_tpu import LoroDoc
from loro_tpu.codec.binary import encode_changes
from loro_tpu.core.change import Change, Op, SeqDelete, SeqInsert, Side
from loro_tpu.core.ids import ID, IdSpan
from loro_tpu.core.ids import ContainerID as JContainerID
from loro_tpu.core.ids import ContainerType as JContainerType
from loro_tpu.core.version import Frontiers
from loro_tpu.doc import strip_envelope
from loro_tpu.ops import columnar as jcol
from loro_tpu.ops import fugue_batch as jfb
from loro_tpu_torch import native, tracegen
from loro_tpu_torch.codec.binary import TextChange, TextDelete, TextInsert, encode_text_changes, read_tables
from loro_tpu_torch.core.ids import ContainerID, ContainerType
from loro_tpu_torch.errors import CodecDecodeError, DecodeError
from loro_tpu_torch.ops import columnar as pcol
from loro_tpu_torch.ops import fugue_batch as pfb

FIELDS = ("parent", "side", "peer", "counter", "deleted", "content", "valid")
TEXT = ContainerID.root("t", ContainerType.Text)


def _jcid(cid: ContainerID) -> JContainerID:
    if cid.is_root:
        return JContainerID.root(cid.name, JContainerType(int(cid.ctype)))
    return JContainerID.normal(cid.peer, cid.counter, JContainerType(int(cid.ctype)))


def _fuzz_payload(seed: int, n_peers: int, steps: int = 80) -> bytes:
    """A synced multi-peer history: text inserts (multi-byte utf8 too)
    and deletes, interleaved with map sets and list pushes."""
    rng = random.Random(seed)
    docs = [LoroDoc(peer=rng.getrandbits(50) + 1) for _ in range(n_peers)]
    for _ in range(steps):
        d = rng.choice(docs)
        t = d.get_text("t")
        if len(t) and rng.random() < 0.35:
            pos = rng.randint(0, len(t) - 1)
            t.delete(pos, min(rng.randint(1, 3), len(t) - pos))
        else:
            t.insert(rng.randint(0, len(t)), rng.choice(["ab", "ç", "1234", "☃", "x"]))
        if rng.random() < 0.3:
            d.get_map("m").set(rng.choice("kq"), rng.choice([1, "v", [1, 2], {"n": 2.5}, None, True]))
        if rng.random() < 0.3:
            d.get_list("l").push(rng.randint(0, 9))
        if rng.random() < 0.3:
            src, dst = rng.sample(docs, 2)
            dst.import_(src.export_updates(dst.oplog_vv()))
    for _ in range(2):
        for s in docs:
            for t2 in docs:
                if s is not t2:
                    t2.import_(s.export_updates(t2.oplog_vv()))
    docs[0].commit()
    return strip_envelope(docs[0].export_updates())


def _assert_same_extract(a, b) -> None:
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert list(a.peers) == list(b.peers)


# ---- payload decode ---------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_extract_seq_from_payload_matches_jax(seed):
    payload = _fuzz_payload(seed, 2 + seed % 2)
    for cid in (TEXT, ContainerID.root("l", ContainerType.List), ContainerID.root("nope", ContainerType.Text)):
        got = pcol.extract_seq_from_payload(payload, cid)
        want = jcol.extract_seq_from_payload(payload, _jcid(cid))
        _assert_same_extract(got, want)
    assert pcol.extract_seq_from_payload(payload, TEXT).n > 0
    peers, keys, cids, _ = read_tables(payload)
    from loro_tpu.codec.binary import read_tables as jread_tables

    jpeers, jkeys, jcids, _ = jread_tables(payload)
    assert (peers, keys) == (jpeers, jkeys) and [repr(c) for c in cids] == [repr(c) for c in jcids]


def test_wire_peer_ranks_match_jax():
    wire = [9, 2**63 + 5, 3, 2**40, 7]
    np.testing.assert_array_equal(pcol.wire_peer_ranks(wire), jcol.wire_peer_ranks(wire))


def test_idmap_path_matches_jax():
    """A direct-table budget of a few entries sends every payload down the
    hash-map path of the explode, which must give the same table."""
    payloads = [_fuzz_payload(10 + s, 3) for s in range(2)]
    try:
        native.set_rowtable_budget(4)
        got = [pcol.extract_seq_from_payload(p, TEXT) for p in payloads]
    finally:
        native.set_rowtable_budget(0)
    for p, g in zip(payloads, got):
        _assert_same_extract(g, jcol.extract_seq_from_payload(p, _jcid(TEXT)))
        _assert_same_extract(g, pcol.extract_seq_from_payload(p, TEXT))


def test_malformed_payloads_raise_codec_decode_error():
    payload = _fuzz_payload(20, 2, steps=30)
    assert issubclass(CodecDecodeError, DecodeError) and issubclass(CodecDecodeError, ValueError)
    for cut in (1, 9, len(payload) // 3, len(payload) // 2, len(payload) - 1):
        with pytest.raises(CodecDecodeError):
            pcol.extract_seq_from_payload(payload[:cut], TEXT)
    flipped = bytes([payload[0] | 0x80]) + payload[1:]  # the peer count's varint runs on
    with pytest.raises(CodecDecodeError):
        pcol.extract_seq_from_payload(flipped, TEXT)
    # every single-byte flip: the port raises exactly where the JAX
    # package's native path raises, and otherwise decodes the same table
    raised = 0
    for i in range(len(payload)):
        bad = payload[:i] + bytes([payload[i] ^ 0xFF]) + payload[i + 1:]
        try:
            want = jcol.extract_seq_from_payload(bad, _jcid(TEXT))
        except ValueError:
            with pytest.raises(CodecDecodeError):
                pcol.extract_seq_from_payload(bad, TEXT)
            raised += 1
            continue
        _assert_same_extract(pcol.extract_seq_from_payload(bad, TEXT), want)
    assert raised > len(payload) // 4


# ---- the encoder ------------------------------------------------------------------


def _jax_changes(changes, cid: ContainerID):
    out = []
    for ch in changes:
        ctr = ch.ctr_start
        ops = []
        for op in ch.ops:
            if isinstance(op, TextInsert):
                parent = None if op.parent is None else ID(*op.parent)
                ops.append(Op(ctr, _jcid(cid), SeqInsert(parent, Side(op.side), op.text)))
                ctr += len(op.text)
            else:
                ops.append(Op(ctr, _jcid(cid), SeqDelete(tuple(IdSpan(*s) for s in op.spans))))
                ctr += 1
        out.append(Change(ID(ch.peer, ch.ctr_start), ch.lamport, Frontiers([ID(*d) for d in ch.deps]), ops,
                          timestamp=ch.timestamp))
    return out


def test_encode_text_changes_is_byte_identical_to_jax():
    a, b = 2**60 + 11, 7
    changes = [
        TextChange(a, 0, 0, 1_700_000_000, (), (TextInsert(None, 1, "héllo ☃"), TextDelete(((a, 1, 3),)))),
        TextChange(b, 0, 8, 1_699_999_000, ((a, 7),),
                   (TextInsert((a, 6), 0, "x"), TextDelete(((a, 0, 1), (b, 0, 1))), TextInsert((b, 0), 1, "yz"))),
        # deps in (peer, counter) order, the order the JAX package's Frontiers writes
        TextChange(a, 8, 12, 1_700_000_500, ((b, 3), (a, 7)), (TextDelete(((b, 2, 4),)),)),
    ]
    for cid in (TEXT, ContainerID.normal(b, 3, ContainerType.Text), ContainerID.normal(99, 0, ContainerType.List)):
        assert encode_text_changes(changes, cid) == encode_changes(_jax_changes(changes, cid)), cid
    assert encode_text_changes([], TEXT) == encode_changes([])


@pytest.fixture(scope="module")
def trace_docs():
    return tracegen.fleet_docs(2, n_patches=4000, seed=11, use_cache=False)


@pytest.mark.parametrize("variant", [0, 1, 2])
def test_trace_payload_decodes_to_the_generators_table(trace_docs, variant):
    doc = trace_docs[variant]
    changes = tracegen.trace_changes(doc)
    payload = tracegen.trace_payload(doc, use_cache=False)
    assert payload == encode_changes(_jax_changes(changes, tracegen.TEXT_CID))
    got = pcol.extract_seq_from_payload(payload, tracegen.TEXT_CID)
    _assert_same_extract(got, doc.extract)
    _assert_same_extract(jcol.extract_seq_from_payload(payload, _jcid(tracegen.TEXT_CID)), doc.extract)
    assert tracegen.oracle_text(got) == doc.text
    # multi-character typing runs, and causally sound deps: every dep is
    # an op of an earlier change, below the change's lamport
    assert any(len(op.text) > 1 for ch in changes for op in ch.ops if isinstance(op, TextInsert))
    seen, lam_of = {}, {}
    for ch in changes:
        for peer, ctr in ch.deps:
            assert seen.get(peer, -1) >= ctr
            assert lam_of[(peer, ctr)] < ch.lamport
        n = sum(len(op.text) if isinstance(op, TextInsert) else 1 for op in ch.ops)
        assert ch.ctr_start == seen.get(ch.peer, -1) + 1
        for k in range(n):
            lam_of[(ch.peer, ch.ctr_start + k)] = ch.lamport + k
        seen[ch.peer] = ch.ctr_start + n - 1
    assert sum(len(ch.ops) for ch in changes) < doc.n_ops


def test_trace_payload_cache(tmp_path, monkeypatch, trace_docs):
    monkeypatch.setattr(tracegen, "CACHE_DIR", tmp_path)
    first = tracegen.trace_payload(trace_docs[1])
    assert len(list(tmp_path.glob("payload_*.bin"))) == 1
    assert tracegen.trace_payload(trace_docs[1]) == first == tracegen.trace_payload(trace_docs[1], use_cache=False)


# ---- packed transport ---------------------------------------------------------


def _packed_batch(extracts, pad_n, pad_c):
    cols = [pcol.chain_columns(e, pad_n=pad_n, pad_c=pad_c) for e in extracts]
    packed = np.empty((len(cols), pfb.packed_row_bytes(pad_c, pad_n)), np.uint8)
    for c, row in zip(cols, packed):
        pfb.pack_chain_doc_into(c, row)
    return cols, packed


@pytest.fixture(scope="module")
def packed_extracts(trace_docs):
    fuzz = [pcol.extract_seq_from_payload(_fuzz_payload(30 + s, 2), TEXT) for s in range(2)]
    return [d.extract for d in trace_docs] + fuzz


@pytest.mark.parametrize("slack,odd", [(0, False), (0, True), (7, True), (8, False)],
                         ids=["tight-even", "tight-odd", "unaligned", "aligned"])
def test_packed_transport_matches_jax(packed_extracts, slack, odd):
    """pack bytes, the unpacked columns and the packed merges equal the
    JAX package's and the port's column path; pads with C + N odd put
    the int32 sections off a 4-byte boundary."""
    exs = packed_extracts
    pad_c = max(pcol.contract_chains(e).n_chains for e in exs) + 3 * (slack > 0)
    pad_n = max(e.n for e in exs) + slack
    pad_n += (pad_c + pad_n + odd) % 2  # C + N odd iff `odd`
    assert (pad_c + pad_n) % 2 == odd
    cols, packed = _packed_batch(exs, pad_n, pad_c)
    for e, row in zip(exs, packed):
        jex = jcol.SeqExtract(**{f: getattr(e, f) for f in FIELDS}, peers=list(e.peers))
        jrow = np.empty_like(row)
        jfb.pack_chain_doc_into(jcol.chain_columns(jex, pad_n=pad_n, pad_c=pad_c), jrow)
        np.testing.assert_array_equal(row, jrow)
    unpacked = pfb._unpack_chain_batch(torch.from_numpy(packed), pad_c, pad_n)
    stacked = pcol.stack_docs(cols)
    for f in pfb.ChainColumns._fields:
        got, want = getattr(unpacked, f), getattr(stacked, f)
        assert got.dtype == (torch.bool if want.dtype == np.bool_ else torch.int32), f
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f)
    codes, counts = pfb.chain_merge_docs_packed(packed, pad_c, pad_n, device="cpu")
    jcodes, jcounts = jfb.chain_merge_docs_packed(jnp.asarray(packed), pad_c, pad_n)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    cs, n = pfb.chain_merge_docs_packed_checksum(packed, pad_c, pad_n, device="cpu")
    jcs, jn = jfb.chain_merge_docs_packed_checksum(jnp.asarray(packed), pad_c, pad_n)
    np.testing.assert_array_equal(cs.numpy(), np.asarray(jcs).astype(np.int64))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    t = pfb.chain_columns_to_torch(stacked, device="cpu")
    for spec in ("torch:ruling", "torch:wyllie", "torch:blocked", "torch:coalesced"):
        got = pfb.chain_merge_docs_packed_checksum(packed, pad_c, pad_n, spec, device="cpu")
        want = pfb.chain_merge_docs_checksum_v(t, spec, device="cpu")
        assert all(torch.equal(g, w) for g, w in zip(got, want)), spec
        assert torch.equal(got[0], cs), spec
    for i, e in enumerate(exs):
        assert "".join(map(chr, codes[i][: int(counts[i])].tolist())) == tracegen.oracle_text(e)


def test_packed_transport_validates():
    assert pfb.packed_row_bytes(10, 20) == 240
    with pytest.raises(ValueError):
        pfb.packed_row_bytes(0xFFFF, 16)
    ex = pcol.extract_seq_from_payload(_fuzz_payload(40, 2, steps=20), TEXT)
    c = pcol.chain_columns(ex, pad_n=64, pad_c=32)
    with pytest.raises(ValueError):
        pfb.pack_chain_doc_into(c, np.empty(pfb.packed_row_bytes(32, 64) + 1, np.uint8))
    with pytest.raises(ValueError):
        pfb.chain_merge_docs_packed(np.zeros((1, 10), np.uint8), 32, 64, device="cpu")
    with pytest.raises(ValueError):
        pfb.chain_merge_docs_packed(np.zeros((1, pfb.packed_row_bytes(32, 64)), np.int8), 32, 64, device="cpu")
