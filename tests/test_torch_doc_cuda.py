"""LoroDoc-made histories through the card's one-shot Fleet merges
(their order solves launch the CUDA list-rank kernels, the tree merges
the replay kernel), against the host engine (resilience.hostpath
.host_merge_changes, per-doc port LoroDocs) on the same change lists.

Imports torch, pytest and loro_tpu_torch only, so it runs on a machine
without jax:
    python -m pytest -q -m cuda --noconftest tests/test_torch_doc_cuda.py
Every test is marked `cuda` and skips without a card.  Tolerance: none
(counter sums are exact in float32 by the generator's steps).
"""
import pytest
import torch

from loro_tpu_torch import tracegen as tg
from loro_tpu_torch.ops import list_rank as lr
from loro_tpu_torch.ops import tree_batch as tb
from loro_tpu_torch.ops.columnar import extract_map_ops
from loro_tpu_torch.parallel.fleet import Fleet
from loro_tpu_torch.resilience.hostpath import host_merge_changes

pytestmark = pytest.mark.cuda


def _needs_card() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card")


@pytest.fixture(scope="module")
def docs():
    return tg.loro_fleet(11, 12, n_rounds=6)


@pytest.mark.parametrize("family", ["text", "richtext", "movable", "tree", "tree_children", "counter"])
def test_card_merges_equal_the_host_engine(docs, family):
    """Each family's card merge of 12 LoroDoc histories (from change
    lists, and from payloads where the Fleet takes them) equals
    host_merge_changes; the merge launched its kernel."""
    _needs_card()
    fleet = Fleet(device="cuda")
    changes = [d.changes() for d in docs]
    payloads = [d.payload() for d in docs]
    lr.reset_launches()
    tb.reset_launches()
    if family == "text":
        got = fleet.merge_text_changes(changes, tg.TEXT_CID).texts
        assert fleet.merge_text_payloads(payloads, tg.TEXT_CID).texts == got
    elif family == "richtext":
        got = fleet.merge_richtext_changes(changes, tg.RICH_CID)
    elif family == "movable":
        got = fleet.merge_movable_changes(changes, tg.MOVABLE_CID)
        assert fleet.merge_movable_payloads(payloads, tg.MOVABLE_CID) == got
    elif family == "tree":
        got = fleet.merge_tree_changes(changes, tg.TREE_CID)
        assert fleet.merge_tree_payloads(payloads, tg.TREE_CID) == got
    elif family == "tree_children":
        got = fleet.merge_tree_children(changes, tg.TREE_CID)
    else:
        got = fleet.merge_counter_changes(changes)
    cid = {"text": tg.TEXT_CID, "richtext": tg.RICH_CID, "movable": tg.MOVABLE_CID}.get(family, tg.TREE_CID)
    assert got == host_merge_changes(family, changes, None if family == "counter" else cid)
    if family in ("text", "richtext", "movable"):
        assert sum(lr.LAUNCHES.values()) > 0
    elif family.startswith("tree"):
        assert sum(tb.LAUNCHES.values()) > 0


def test_card_map_merge_equals_the_docs(docs):
    """merge_map_docs of the same histories equals each LoroDoc's root map."""
    _needs_card()
    got = Fleet(device="cuda").merge_map_docs([extract_map_ops(d.changes()) for d in docs])
    assert got == [d.doc.get_map(tg.MAP_CID.name).get_value() for d in docs]

