"""The resident MovableList batch (DeviceMovableBatch) on the card, against
the same appends on the CPU and tracegen's oracle.

Imports torch, numpy, pytest and loro_tpu_torch only, so it runs on a
machine without jax:
    python -m pytest -q -m cuda --noconftest tests/test_torch_movable_resident_cuda.py
Every test is marked `cuda` and skips without a card.  Tolerance: none;
value lists and checkpoint bytes are compared exactly.
"""
import pytest
import torch

from loro_tpu_torch import tracegen
from loro_tpu_torch.ops import list_rank as lr
from loro_tpu_torch.parallel import fleet as pfleet
from loro_tpu_torch.parallel.fleet import DeviceMovableBatch


def _needs_card() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["payloads", "changes"])
def test_resident_movable_on_card_matches_cpu_and_oracle(path, tmp_path, monkeypatch):
    """Three traces fed one sync epoch a round from small capacities with
    auto_grow: after every epoch the card batch's lists equal the CPU
    batch's and oracle_movable of the prefix, and their checkpoints are
    the same bytes; a checkpoint taken mid-way restores on the card and
    runs on to the same bytes; no list-rank kernel launches, no payload
    falls back."""
    _needs_card()
    monkeypatch.setattr(tracegen, "CACHE_DIR", tmp_path)
    docs = [tracegen.movable_doc(s, n_elems=400, n_moves=200, n_sets=100, n_deletes=50, sync_every=100)
            for s in range(3)]
    eps = [tracegen.movable_epoch_payloads(d) for d in docs]
    card = DeviceMovableBatch(3, 16, 8, device="cuda", auto_grow=True)
    cpu = DeviceMovableBatch(3, 16, 8, device="cpu", auto_grow=True)
    before, fell = dict(lr.LAUNCHES), pfleet.FLEET_FALLBACKS["payload_decode"]
    restored = None
    n = max(map(len, eps))
    for e in range(n):
        pls = [ep[e] if e < len(ep) else None for ep in eps]
        for b in (card, cpu) + ((restored,) if restored else ()):
            if path == "payloads":
                b.append_payloads(pls, tracegen.MOVABLE_CID)
            else:
                b.append_changes([g[e] if e < len(g) else None for g in (d.epoch_changes() for d in docs)],
                                 tracegen.MOVABLE_CID)
        got = card.value_lists()
        assert got == cpu.value_lists() == [tracegen.oracle_movable(d, e + 1) for d in docs], e
        assert card.moves.value.is_cuda and card.export_state() == cpu.export_state()
        if e == n // 2:
            restored = DeviceMovableBatch.import_state(card.export_state(), device="cuda")
    assert restored.export_state() == card.export_state() and restored.value_lists() == got
    assert card.seq.cap > 16 and card.e_cap > 8
    assert lr.LAUNCHES == before and pfleet.FLEET_FALLBACKS["payload_decode"] == fell
