"""The port's device spans on the card: a fleet text merge's
fleet.text.merge_device and fugue.rank device spans are delivered inside
the merge call without a new synchronize; the resident batches' device
stages are device spans; live spans sit in torch.profiler's host timeline
beside the kernels.

Imports torch, pytest and loro_tpu_torch only, so it runs on a machine
without jax:
    python -m pytest -q -m cuda --noconftest tests/test_torch_tracing_cuda.py
Every test is marked `cuda` and skips without a card.
"""
import pytest
import torch

from loro_tpu_torch import tracegen
from loro_tpu_torch.parallel import fleet as pfleet
from loro_tpu_torch.utils import tracing

CID = tracegen.TEXT_CID


def _needs_card() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card")


@pytest.fixture(autouse=True)
def quiet_tracing():
    saved = (tracing._span_observers, tracing._enabled)
    tracing._span_observers, tracing._enabled = (), False
    tracing.clear()
    tracing._pending.clear()
    yield
    tracing._span_observers, tracing._enabled = saved
    tracing.clear()
    tracing._pending.clear()


@pytest.fixture(scope="module")
def payloads():
    return [d.payload() for d in tracegen.loro_fleet(43, 8, n_rounds=4, max_edits=8)]


def _count_syncs(monkeypatch):
    """Count torch.cuda.synchronize and torch.cuda.Event.synchronize calls."""
    calls = {"device": 0, "event": 0}
    real_sync, real_ev_sync = torch.cuda.synchronize, torch.cuda.Event.synchronize

    def sync(*a, **kw):
        calls["device"] += 1
        return real_sync(*a, **kw)

    def ev_sync(self):
        calls["event"] += 1
        return real_ev_sync(self)

    monkeypatch.setattr(torch.cuda, "synchronize", sync)
    monkeypatch.setattr(torch.cuda.Event, "synchronize", ev_sync)
    return calls


@pytest.mark.cuda
def test_device_spans_resolve_inside_the_call_without_a_new_sync(monkeypatch, payloads):
    """The same merge with spans off and live makes as many synchronize
    calls (device and event); live, the merge's device spans reach the
    observer before fleet.text.payloads closes, with positive times, and
    nothing is left pending."""
    _needs_card()
    fl = pfleet.Fleet(device="cuda")
    want = fl.merge_text_payloads(payloads, CID).texts  # warm
    calls = _count_syncs(monkeypatch)
    assert fl.merge_text_payloads(payloads, CID).texts == want
    off = dict(calls)
    seen = []
    tracing.add_span_observer(lambda name, s: seen.append((name, s)))
    tracing.enable()
    calls.update(device=0, event=0)
    assert fl.merge_text_payloads(payloads, CID).texts == want
    assert calls == off
    names = [n for n, _ in seen]
    assert names[-1] == "fleet.text.payloads" and not tracing._pending
    assert names.index("fleet.text.merge_device") < names.index("fleet.text.decode")
    ranks = [s for n, s in seen if n == "fugue.rank"]
    assert len(ranks) == 1 and ranks[0] > 0
    ev = next(e for e in tracing.events() if e["name"] == "fugue.rank")
    assert ev["cat"] == "device" and ev["args"]["D"] == len(payloads)
    merge = next(s for n, s in seen if n == "fleet.text.merge_device")
    assert ranks[0] <= merge


@pytest.mark.cuda
def test_resident_device_stages_are_device_spans(payloads):
    """A DeviceDocBatch on the card: stage_ms() names the same stages
    live and off, and each device stage is a resident.<stage> device span
    (a Chrome X event of cat device), delivered once the read's fetch has
    waited for it."""
    _needs_card()
    b = pfleet.DeviceDocBatch(len(payloads), 4096, device="cuda")
    b.append_payloads(payloads, CID)
    off_append = set(b.stage_ms())
    want = b.texts()
    off_read = set(b.stage_ms())
    tracing.enable()
    b2 = pfleet.DeviceDocBatch(len(payloads), 4096, device="cuda")
    b2.append_payloads(payloads, CID)
    assert set(b2.stage_ms()) == off_append
    assert b2.texts() == want
    assert set(b2.stage_ms()) == off_read
    tracing.resolve_device_spans()
    device = {e["name"] for e in tracing.events() if e.get("cat") == "device"}
    assert {"resident.upload_scatter", "resident.sort"} <= device
    host = {e["name"] for e in tracing.events() if e.get("cat") is None}
    assert {"resident.explode", "resident.fetch", "resident.decode"} <= host


@pytest.mark.cuda
def test_live_spans_sit_in_the_profiler_timeline(payloads):
    """In a CPU and CUDA profile the live spans are loro_tpu_torch.*
    annotations, and the merge's kernels run inside the launch span's
    reach: after the entry span opens and before it closes."""
    _needs_card()
    fl = pfleet.Fleet(device="cuda")
    fl.merge_text_payloads(payloads, CID)
    tracing.add_span_observer(lambda name, s: None)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fl.merge_text_payloads(payloads, CID)
    evs = prof.events()
    host = {e.name: e.time_range for e in evs if e.name.startswith(tracing.PROFILER_PREFIX)
            and e.device_type != torch.autograd.DeviceType.CUDA}
    assert {tracing.PROFILER_PREFIX + n for n in ("fleet.text.payloads", "fleet.text.launch", "fleet.text.fetch")} \
        <= set(host)
    top = host["loro_tpu_torch.fleet.text.payloads"]
    kernels = [e.time_range for e in evs if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(tracing.PROFILER_PREFIX) and not e.name.startswith("Memcpy")]
    assert kernels and all(top.start <= k.start and k.end <= top.end for k in kernels)
