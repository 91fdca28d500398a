"""The frozen generator gives the port's generator's bytes (the only test
that imports the port's generator)."""
import pytest

from portbench import textgen


@pytest.mark.parametrize("n_patches,sync_every,seed", [(3000, 500, 7), (9000, 4000, 11)])
def test_frozen_generator_matches_the_port(n_patches, sync_every, seed):
    from loro_tpu_torch import tracegen

    p_port = tracegen.automerge_like_patches(seed, n_patches)
    p_ours = textgen.automerge_like_patches(seed, n_patches)
    assert all((a == b).all() for a, b in zip(p_port, p_ours))
    doc = tracegen.concurrent_doc(p_port, 4, sync_every, seed=seed * 1000 + 1, peer_base=2 << 8)
    h = textgen.concurrent_events(p_ours, 4, sync_every, seed=seed * 1000 + 1, peer_base=2 << 8)
    assert (doc.text, doc.n_ops, doc.extract.peers) == (h.text, h.n_ops, h.peers)
    for f in textgen.EVENT_FIELDS:
        assert (doc.events[f] == h.events[f]).all()
    assert tracegen.trace_payload(doc, use_cache=False) == textgen.history_payload(h)


def test_remap_rewrites_the_peer_table_only():
    h = textgen.concurrent_events(textgen.automerge_like_patches(3, 2000), 4, 500, seed=5)
    payload = textgen.history_payload(h)
    new = {p: (1 << 63) + i for i, p in enumerate(h.peers)}
    out = textgen.remap_peers(payload, new)
    ids, off = textgen.peer_table(out)
    assert sorted(ids) == sorted(new.values())
    assert len(out) == len(payload) and out[off + 8 * len(ids):] == payload[off + 8 * len(ids):]
