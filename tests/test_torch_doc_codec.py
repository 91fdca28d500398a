"""The port's document codecs against the JAX package's on the CPU:
every EncodeMode round-trips with equal bytes, corrupted bytes raise the
port's DecodeError wherever the JAX package raises its own (the
corruption offsets of the JAX suite's test_codec_harden.py), redaction
and the envelope helpers give equal bytes.  Exact equality throughout
(tolerance: none)."""
import json
import zlib

import pytest

import loro_tpu as J
import loro_tpu_torch as P
from loro_tpu import doc as jdoc
from loro_tpu.codec import binary as jbin
from loro_tpu.codec import json_schema as jjs
from loro_tpu_torch import doc as pdoc
from loro_tpu_torch.codec import binary as pbin
from loro_tpu_torch.codec import json_schema as pjs
from test_codec_harden import FAMILIES, _corruptions
from test_torch_doc import PKGS, _history, both, conv, plain

MODES = {
    "JsonUpdates": lambda pkg, d: d._encode_changes(d.oplog.changes_since(pkg.VersionVector()),
                                                    pkg.EncodeMode.JsonUpdates),
    "JsonSnapshot": lambda pkg, d: d._encode_changes(d.oplog.changes_since(pkg.VersionVector()),
                                                     pkg.EncodeMode.JsonSnapshot),
    "ColumnarUpdates": lambda pkg, d: d.export_updates(),
    "ColumnarSnapshot": lambda pkg, d: d.export(pkg.ExportMode.SnapshotAt(d.oplog_frontiers())),
    "ShallowSnapshot": lambda pkg, d: d.export(pkg.ExportMode.ShallowSnapshot(d.oplog_frontiers())),
    "FastSnapshot": lambda pkg, d: d.export_snapshot(),
    "StateOnly": lambda pkg, d: d.export(pkg.ExportMode.StateOnly),
}


@pytest.fixture(scope="module")
def hist():
    return _history(4, steps=100)


@pytest.mark.parametrize("mode", list(MODES))
def test_every_encode_mode_round_trips(hist, mode):
    """Each EncodeMode: equal bytes from both packages, the envelope
    names the mode, and a fresh doc of either package that imports
    either package's bytes reaches the sender's value and re-exports
    equal bytes."""
    pair = hist.docs[0]
    blobs = both(lambda k: MODES[mode](PKGS[k], pair[k]))
    assert blobs[0] == blobs[1]
    assert both(lambda k: (PKGS[k].doc.parse_envelope_header(blobs[k])[1].name))[0] == mode
    both(lambda k: PKGS[k].LoroDoc.decode_import_blob_meta(blobs[k]))
    for src in range(2):
        fresh = [pkg.LoroDoc(peer=42) for pkg in PKGS]
        both(lambda k: (fresh[k].import_(blobs[src]), fresh[k].get_deep_value(), fresh[k].oplog_vv(),
                        fresh[k].export_snapshot(), fresh[k].export(PKGS[k].ExportMode.StateOnly)))
        assert fresh[1 - src].get_deep_value() == pair[src].get_deep_value()


def _family_doc(pkg, family):
    """test_codec_harden._payload's histories, built in package `pkg`."""
    d = pkg.LoroDoc(peer=11)
    if family == "text":
        t = d.get_text("t")
        t.insert(0, "hardening payload text")
        t.delete(2, 3)
        t.mark(0, 5, "bold", True)
    elif family == "map":
        m = d.get_map("m")
        m.set("alpha", 1)
        m.set("beta", [1, "two", None])
        m.delete("alpha")
    elif family == "tree":
        tr = d.get_tree("tr")
        r = tr.create()
        c = tr.create(r)
        tr.move(c, None)
    elif family == "movable":
        ml = d.get_movable_list("ml")
        ml.push("a", "b", "c")
        ml.move(0, 2)
        ml.set(0, "z")
        ml.delete(1, 1)
    elif family == "counter":
        d.get_counter("c").increment(41.5)
        d.get_counter("c").decrement(1.5)
    d.commit()
    return d


def _outcome(fn):
    try:
        return ("ok", plain(fn()))
    except (J.DecodeError, P.DecodeError) as e:
        return ("DecodeError", type(e).__name__)


def _reframe(blob, payload):
    return blob[:6] + zlib.crc32(payload).to_bytes(4, "little") + payload


@pytest.mark.parametrize("family", FAMILIES)
def test_decode_errors_at_the_same_offsets(family):
    """Every truncation and bit flip of test_codec_harden.py's
    corruptions, of the bare updates payload (decode_changes), of the
    framed blob (crc) and of the payload re-framed with a valid crc
    (updates, snapshot, shallow snapshot, state only through import_):
    the port raises its DecodeError exactly where the JAX package raises
    its own, and otherwise decodes to the same changes and values."""
    docs = [_family_doc(pkg, family) for pkg in PKGS]
    blobs = both(lambda k: docs[k].export_updates())
    pl = jdoc.strip_envelope(blobs[0])
    assert pdoc.strip_envelope(blobs[1]) == pl
    n_raised = 0
    for bad in _corruptions(pl):
        got = [_outcome(lambda: jbin.decode_changes(bad)), _outcome(lambda: pbin.decode_changes(bad))]
        assert got[0] == got[1], got
        n_raised += got[0][0] != "ok"
    assert n_raised
    exports = {
        "updates": lambda pkg, d: d.export_updates(),
        "snapshot": lambda pkg, d: d.export_snapshot(),
        "shallow": lambda pkg, d: d.export(pkg.ExportMode.ShallowSnapshot(d.oplog_frontiers())),
        "state_only": lambda pkg, d: d.export(pkg.ExportMode.StateOnly),
    }
    for name, ex in exports.items():
        blob = both(lambda k: ex(PKGS[k], docs[k]))[0]
        body = blob[10:]
        cases = list(_corruptions(blob)) + [_reframe(blob, b) for b in _corruptions(body)]
        for bad in cases:
            got = [_outcome(lambda: _import_fresh(pkg, bad)) for pkg in PKGS]
            assert got[0] == got[1], (name, got)


def _import_fresh(pkg, blob):
    d = pkg.LoroDoc(peer=5)
    d.import_(blob)
    return d.get_deep_value(), d.oplog_vv()


def test_redact_json_updates(hist):
    """redact_json_updates over ranges of every peer (and a range past
    the history), in place: equal JSON, equal errors; the redacted JSON
    imports into either package to equal values."""
    pair = hist.docs[1]
    vv = pair[0].oplog_vv()
    peers = sorted(p for p, _ in vv.items())
    ranges = [{peers[0]: (0, vv.get(peers[0]))}, {p: (c // 3, c // 2 + 1) for p, c in vv.items()},
              {peers[-1]: (0, (1 << 31) - 1)}, {}]
    for rng in ranges:
        outs = []
        for k, (pkg, js) in enumerate(((J, jjs), (P, pjs))):
            obj = pair[k].export_json_updates()
            try:
                js.redact_json_updates(obj, pkg.VersionRange(rng))
                outs.append(json.dumps(obj, sort_keys=True))
            except pkg.RedactError as e:
                outs.append(("RedactError", str(e)))
        assert outs[0] == outs[1]
        if isinstance(outs[0], str):
            both(lambda k: _json_import(PKGS[k], outs[0]))
    bad = {"changes": [{"id": "0@1", "ops": [{"counter": -1, "container": "cid:root-t:Text",
                                               "content": {"type": "insert", "pos": 0, "text": "x"}}]}]}
    errs = []
    for pkg, js in ((J, jjs), (P, pjs)):
        with pytest.raises(pkg.RedactError) as e:
            js.redact_json_updates(json.loads(json.dumps(bad)), pkg.VersionRange({1: (0, 5)}))
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def _json_import(pkg, text):
    d = pkg.LoroDoc(peer=3)
    d.import_json_updates(text)
    return d.get_deep_value(), d.export_snapshot()


def test_envelope_helpers(hist):
    """parse_envelope_header and strip_envelope on every export mode and
    on bad envelopes (magic, version, mode, crc), and
    frame_columnar_updates on export-ordered change lists: equal bytes
    and equal errors; a framed list equals export(Updates(vv))."""
    pair = hist.docs[2]
    blobs = [MODES[m](J, pair[0]) for m in MODES]
    bad = [b"", b"LTPU", b"XXXX" + blobs[0][4:], blobs[0][:4] + b"\x09" + blobs[0][5:],
           blobs[0][:5] + b"\x63" + blobs[0][6:], blobs[2][:-1] + bytes([blobs[2][-1] ^ 1]),
           blobs[5][:4] + b"\x01" + blobs[5][5:]]
    for blob in blobs + bad:
        got = [_outcome(lambda: (m.parse_envelope_header(blob)[0], m.parse_envelope_header(blob)[1].name,
                                 m.strip_envelope(blob))) for m in (jdoc, pdoc)]
        assert got[0] == got[1]
    for q in range(4):
        vv = [(p, c * q // 4) for p, c in sorted(pair[0].oplog_vv().items())]
        outs = both(lambda k: (PKGS[k].doc.frame_columnar_updates(
            pair[k].oplog.changes_since(conv(PKGS[k], ("vv", vv)))),
            pair[k].export(PKGS[k].ExportMode.Updates(conv(PKGS[k], ("vv", vv))))))
        assert outs[0][0] == outs[0][1] == outs[1][0]
