"""The port's host mirror (loro_tpu_torch.resilience.hostpath) on the
CPU: HostEngine against the JAX package's HostEngine and against the
port's resident batches, and host_merge_changes against the JAX
package's and against the port's one-shot Fleet merges on
device="cpu" (the plain kernels).

Inputs: tracegen.loro_fleet, seeded 3-peer LoroDoc histories over all
six container kinds made by the port's LoroDoc, one payload a sync
round (the bytes are the JAX package's too: test_torch_doc holds the
two encoders byte for byte).  Every comparison is exact (tolerance:
none); across packages through test_torch_doc.plain.
"""
import pytest

from loro_tpu.core.ids import ContainerID as JContainerID
from loro_tpu.resilience import hostpath as jhp
from loro_tpu_torch import tracegen as tg
from loro_tpu_torch.codec.binary import decode_changes
from loro_tpu_torch.parallel.fleet import (DeviceCounterBatch, DeviceDocBatch, DeviceMapBatch, DeviceMovableBatch,
                                          DeviceTreeBatch, Fleet)
from loro_tpu_torch.resilience import hostpath as php
from test_torch_doc import plain

# family -> (container, the HostEngine reads of that family)
FAMILIES = {
    "text": (tg.TEXT_CID, ("texts",)),
    "richtext": (tg.RICH_CID, ("richtexts",)),
    "list": (tg.LIST_CID, ("values",)),
    "movable": (tg.MOVABLE_CID, ("value_lists",)),
    "tree": (tg.TREE_CID, ("parent_maps", "children_maps")),
    "counter": (None, ("value_maps",)),
    "map": (None, ("value_maps", "root_value_maps")),
}


def _reads(eng, names):
    return [getattr(eng, n)("m") if n == "root_value_maps" else getattr(eng, n)() for n in names]


@pytest.fixture(scope="module")
def fleet_docs():
    return tg.loro_fleet(3, 6, n_rounds=5)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_host_engine_matches_jax_every_round(fleet_docs, family):
    """Both packages' HostEngines fed the same epoch payloads (bytes, and
    in the last round decoded change lists): every read equal every
    round, and equal to peer 0's own LoroDoc at the end."""
    cid, names = FAMILIES[family]
    jcid = None if cid is None else JContainerID.parse(str(cid))
    engines = [jhp.HostEngine(family, len(fleet_docs)), php.HostEngine(family, len(fleet_docs))]
    n_rounds = len(fleet_docs[0].epochs)
    for r in range(n_rounds):
        payloads = [d.epochs[r] if (r + i) % 4 else None for i, d in enumerate(fleet_docs)]  # idle docs too
        if r == n_rounds - 1:
            payloads = [decode_changes(p) if p is not None else None for p in payloads]
            jpayloads = [jhp.normalize_updates([d.epochs[r]])[0] if p is not None else None
                         for p, d in zip(payloads, fleet_docs)]
        else:
            jpayloads = payloads
        assert engines[0].apply(jpayloads, jcid) == engines[1].apply(payloads, cid) == r + 1
        got = [_reads(e, names) for e in engines]
        assert plain(got[0]) == plain(got[1])
    # the idle rounds dropped some epochs: feed them now, in order, and the
    # mirror must reach each doc's own state
    late = php.HostEngine(family, len(fleet_docs))
    for r in range(n_rounds):
        late.apply([d.epochs[r] for d in fleet_docs], cid)
    for i, d in enumerate(fleet_docs):
        if family == "text":
            assert late.texts()[i] == d.doc.get_text(cid.name).to_string()
        elif family == "richtext":
            assert late.richtexts()[i] == d.doc.get_text(cid.name).get_richtext_value()
        elif family in ("list", "movable"):
            assert _reads(late, names)[0][i] == d.doc.get_container(cid).get_value()
        elif family == "counter":
            assert late.value_maps()[i] == {c: d.doc.get_counter(c.name).get_value() for c in tg.COUNTER_CIDS
                                            if c in late.value_maps()[i]}
        elif family == "map":
            assert late.root_value_maps("m")[i] == d.doc.get_map("m").get_value()


def _resident(family, n):
    if family in ("text", "richtext"):
        return DeviceDocBatch(n, 64, device="cpu", auto_grow=True)
    if family == "list":
        return DeviceDocBatch(n, 64, device="cpu", as_text=False, auto_grow=True)
    if family == "movable":
        return DeviceMovableBatch(n, 64, 16, device="cpu", auto_grow=True)
    if family == "tree":
        return DeviceTreeBatch(n, 64, 16, device="cpu", auto_grow=True)
    if family == "counter":
        return DeviceCounterBatch(n, 4, device="cpu", auto_grow=True)
    return DeviceMapBatch(n, 16, device="cpu", auto_grow=True)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_host_engine_mirrors_the_resident_batches(fleet_docs, family):
    """The port's HostEngine and the port's resident batch of the family
    (on device="cpu", plain kernels) fed the same epoch payloads: the
    same read names give equal results every round."""
    cid, names = FAMILIES[family]
    eng = php.HostEngine(family, len(fleet_docs))
    batch = _resident(family, len(fleet_docs))
    for r in range(len(fleet_docs[0].epochs)):
        payloads = [d.epochs[r] for d in fleet_docs]
        eng.apply(payloads, cid)
        if family == "counter":
            batch.append_changes([decode_changes(p) for p in payloads])
        elif family == "map":
            batch.append_payloads(payloads)
        else:
            batch.append_payloads(payloads, cid)
        assert _reads(batch, names) == _reads(eng, names), (family, r)


@pytest.mark.parametrize("family", ["text", "richtext", "movable", "tree", "tree_children", "counter"])
def test_host_merge_changes_matches_jax_and_the_cpu_fleet(fleet_docs, family):
    """host_merge_changes of each family equals the JAX package's and the
    port's one-shot Fleet merge on device="cpu" of the same change lists."""
    cid = {"text": tg.TEXT_CID, "richtext": tg.RICH_CID, "movable": tg.MOVABLE_CID, "tree": tg.TREE_CID,
           "tree_children": tg.TREE_CID, "counter": None}[family]
    changes = [d.changes() for d in fleet_docs]
    host = php.host_merge_changes(family, changes, cid)
    jchanges = [jhp.normalize_updates([d.payload()])[0] for d in fleet_docs]
    jhost = jhp.host_merge_changes(family, jchanges, None if cid is None else JContainerID.parse(str(cid)))
    assert plain(host) == plain(jhost)
    fleet = Fleet(device="cpu")
    dev = {
        "text": lambda: fleet.merge_text_changes(changes, cid).texts,
        "richtext": lambda: fleet.merge_richtext_changes(changes, cid),
        "movable": lambda: fleet.merge_movable_changes(changes, cid),
        "tree": lambda: fleet.merge_tree_changes(changes, cid),
        "tree_children": lambda: fleet.merge_tree_children(changes, cid),
        "counter": lambda: fleet.merge_counter_changes(changes),
    }[family]()
    assert dev == host
    with pytest.raises(ValueError):
        php.host_merge_changes("map", changes)
