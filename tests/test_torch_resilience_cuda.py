"""The port's DeviceSupervisor over CUDA on the card: real torch device
errors classified, the drain on CUDA results, the supervised one-shot
merges against the host engine.

Imports torch, pytest and loro_tpu_torch only, so it runs on a machine
without jax:
    python -m pytest -q -m cuda --noconftest tests/test_torch_resilience_cuda.py
Every test is marked `cuda` and skips without a card.  Tolerance: none.
A device-side assert would leave this process's context unusable, so it
runs in chip_smoke.py's phase 4l, in a child process.
"""
import pytest
import torch

from loro_tpu_torch import tracegen
from loro_tpu_torch.errors import DeviceFailure
from loro_tpu_torch.parallel.fleet import Fleet
from loro_tpu_torch.resilience import DeviceSupervisor, faultinject, get_supervisor, set_supervisor
from loro_tpu_torch.resilience.hostpath import host_merge_changes


def _needs_card() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card")


@pytest.fixture
def sup():
    _needs_card()
    s = DeviceSupervisor(sleep=lambda _s: None)
    set_supervisor(s)
    yield s
    faultinject.clear()
    set_supervisor(None)


@pytest.mark.cuda
def test_a_real_out_of_memory_becomes_device_failure(sup):
    """An allocation past the card's memory raises torch's
    OutOfMemoryError: one attempt, no retry, a DeviceFailure; the card
    stays usable."""
    with pytest.raises(DeviceFailure) as ei:
        sup.launch(lambda: torch.empty(1 << 50, dtype=torch.uint8, device="cuda"), label="oom")
    assert isinstance(ei.value.__cause__, torch.OutOfMemoryError) and ei.value.attempts == 1
    assert sup.report()["failures"] == 1 and sup.report()["retries"] == 0
    assert int((torch.zeros(8, dtype=torch.int32, device="cuda") + 1).sum()) == 8


@pytest.mark.cuda
def test_drain_on_cuda_results_and_not_in_a_capture():
    """With drain_every=1 every launch drains by fetching its smallest
    CUDA tensor; a launch inside a CUDA graph capture does not sync, so
    the capture holds."""
    _needs_card()
    s = DeviceSupervisor(drain_every=1)
    x = torch.arange(1 << 16, device="cuda")
    out = s.launch(lambda: (x * 2, x[:4] + 1), label="drain")
    assert s.report()["drains"] == 1 and s.in_flight == 0
    assert out[1].tolist() == [1, 2, 3, 4]
    stream = torch.cuda.Stream()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        y = x * 3  # warm-up outside the capture
        with torch.cuda.graph(g, stream=stream):
            y = s.launch(lambda: x * 3, label="captured")
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, x * 3) and s.report()["drains"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["text", "tree", "counter"])
def test_supervised_merges_on_the_card(sup, family):
    """The one-shot merges on the card through the supervisor: equal to
    the host engine, launches counted, no failure; under a fatal launch
    fault the same result from the host engine, one degradation."""
    docs = tracegen.loro_fleet(3, 8, n_rounds=4, max_edits=8)
    changes = [d.changes() for d in docs]
    fl = Fleet("cuda")
    call, cid = {"text": (lambda: fl.merge_text_changes(changes, tracegen.TEXT_CID).texts, tracegen.TEXT_CID),
                 "tree": (lambda: fl.merge_tree_changes(changes, tracegen.TREE_CID), tracegen.TREE_CID),
                 "counter": (lambda: fl.merge_counter_changes(changes), None)}[family]
    want = host_merge_changes(family, changes, cid)
    assert call() == want
    assert sup.report()["launches"] >= 2 and sup.report()["failures"] == 0
    faultinject.inject("launch", exc=RuntimeError("INTERNAL: injected device death"), times=1)
    try:
        assert call() == want
    finally:
        faultinject.clear()
    assert sup.report()["degradations"] == 1 and get_supervisor() is sup
