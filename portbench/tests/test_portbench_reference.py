"""The plain reference against the generator's own text and against the
port on the CPU at a tiny size of the cell's shape (whole concurrent
histories); and the traffic's author streams: a recorded trace read
character by character, and the configuration's counts held."""
import gzip
import json

import pytest

from portbench import textgen, traffic
from portbench.reference import fugue


@pytest.fixture(scope="module")
def hist():
    return textgen.concurrent_events(textgen.automerge_like_patches(21, 5000), 4, 800, seed=2101)


def test_reference_text_is_the_generators(hist):
    el = fugue.elements(hist.events)
    assert fugue.text_at(el, fugue.traversal(el, hist.peers)) == hist.text


def test_peer_order_and_arrival_order_change_the_text(hist):
    el = fugue.elements(hist.events)
    base = fugue.text_at(el, fugue.traversal(el, hist.peers))
    assert fugue.text_at(el, fugue.traversal(el, hist.peers[::-1])) != base
    assert fugue.text_at(el, fugue.traversal(el, hist.peers, "arrival")) != base


SHAPE = {"patches_per_doc": 5000, "inserts_per_doc": round(5000 * 182_315 / 259_778),
         "deletes_per_doc": 5000 - round(5000 * 182_315 / 259_778), "peers_per_doc": 4, "sync_every": 800}
MIX = {"pool": 2, "pool_seed": 3, "orders_per_base": 3}


@pytest.fixture(scope="module")
def docs(tmp_path_factory):
    pool = traffic.load_pool(SHAPE, MIX, tmp_path_factory.mktemp("data"))
    return pool, traffic.make_docs(MIX, pool, 2**31 + 99, 6)


def test_reference_agrees_with_the_port_on_whole_histories(docs):
    from loro_tpu_torch.core.ids import ContainerID, ContainerType
    from loro_tpu_torch.parallel.fleet import Fleet

    pool, ds = docs
    got = Fleet(device="cpu").merge_text_payloads([traffic.history_payload(pool, d) for d in ds],
                                                  ContainerID.root("text", ContainerType.Text)).texts
    ref = fugue.TextReference([b.events for b in pool])
    assert got == [ref.text(d.base, d.peer_ids) for d in ds]
    assert len(set(got)) > 1


def _write_trace(path, patches):
    with gzip.open(path, "wt", encoding="utf-8") as f:
        json.dump({"txns": [{"patches": patches}]}, f)


def test_a_trace_file_is_read_character_by_character(tmp_path):
    _write_trace(tmp_path / "t.json.gz", [[0, 0, "ab"], [1, 1, ""], [0, 1, "xy"]])
    pos, ins, chars = traffic.trace_patches(tmp_path / "t.json.gz")
    assert pos.tolist() == [0, 1, 1, 0, 0, 1]
    assert ins.tolist() == [True, True, False, False, True, True]
    assert chars.tolist() == [97, 98, 0, 0, 120, 121]


def test_a_trace_file_stands_in_for_the_generated_stream(tmp_path):
    mix = {"pool": 1, "pool_seed": 3}
    pos, ins, chars = textgen.automerge_like_patches(3, SHAPE["patches_per_doc"])
    _write_trace(tmp_path / "t.json.gz", [[int(p), 0, chr(c)] if i else [int(p), 1, ""]
                                          for p, i, c in zip(pos, ins, chars)])
    (made,) = traffic.load_pool(SHAPE, mix, tmp_path / "made")
    (read,) = traffic.load_pool({**SHAPE, "trace_file": str(tmp_path / "t.json.gz")}, mix, tmp_path / "read")
    assert read.history == made.history and read.peers == made.peers
    assert all((read.events[f] == made.events[f]).all() for f in textgen.EVENT_FIELDS)


def test_the_configurations_counts_are_held(tmp_path):
    with pytest.raises(ValueError, match="inserts, deletes"):
        traffic.load_pool({**SHAPE, "inserts_per_doc": SHAPE["inserts_per_doc"] + 1}, {"pool": 1, "pool_seed": 3},
                          tmp_path)
