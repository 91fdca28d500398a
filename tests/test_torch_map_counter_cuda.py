"""The LWW-map and counter merges (ops.lww, DeviceMapBatch,
DeviceCounterBatch) on the card, against the same calls on the CPU.

Imports torch, numpy, pytest and loro_tpu_torch only, so it runs on a
machine without jax:
    python -m pytest -q -m cuda --noconftest tests/test_torch_map_counter_cuda.py
Every test is marked `cuda` and skips without a card.

Tolerance: exact for the LWW winners, the checkpoint bytes and counter
sums of quarter deltas (every partial sum exact in float32); the counter
sums of tenths, whose additions run in no fixed order on the card, within
count * 2^-24 * sum(|delta|) of the CPU fold per slot.
"""
import numpy as np
import pytest
import torch

from loro_tpu_torch import tracegen
from loro_tpu_torch.ops import lww
from loro_tpu_torch.parallel.fleet import DeviceCounterBatch, DeviceMapBatch, Fleet


def _needs_card() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card")


def _u32(rng, shape):
    """int64 holding uint32 peer halves, crowded on values of 2^31 and more."""
    return torch.from_numpy(rng.choice(np.array([0, 1, 2**31, 2**31 + 5, 2**32 - 1], np.int64), shape))


@pytest.mark.cuda
def test_lww_folds_on_card_match_cpu():
    """lww_merge_batch and four lww_update_resident folds (peer halves of
    2^31 and more, lamport ties, pads) give the CPU's arrays."""
    _needs_card()
    rng = np.random.default_rng(5)
    d, m, s = 64, 2048, 300
    slot = torch.from_numpy(rng.integers(0, s, (d, m)).astype(np.int32))
    lam = torch.from_numpy(rng.integers(0, 40, (d, m)).astype(np.int32))
    peer = torch.from_numpy(rng.integers(0, 9, (d, m)).astype(np.int32))
    val = torch.from_numpy(rng.integers(-1, 10_000, (d, m)).astype(np.int32))
    valid = torch.from_numpy(np.arange(m)[None, :] < rng.integers(m // 2, m + 1, (d, 1)))
    cols = lww.MapOpCols(slot, lam, peer, val, valid)
    for c, g in zip(lww.lww_merge_batch(cols, s, device="cpu"), lww.lww_merge_batch(cols, s, device="cuda")):
        assert g.is_cuda and torch.equal(g.cpu(), c)
    res = {dev: lww.LwwResident(
        torch.full((d, s), lww.NEG, dtype=torch.int32, device=dev), torch.zeros((d, s), dtype=torch.int64, device=dev),
        torch.zeros((d, s), dtype=torch.int64, device=dev), torch.full((d, s), -2, dtype=torch.int32, device=dev))
        for dev in ("cpu", "cuda")}
    for _ in range(4):
        hi, lo = _u32(rng, (d, m)), _u32(rng, (d, m))
        for dev, r in res.items():
            lww.lww_update_resident(r, *(t.to(dev) for t in (slot, lam, hi, lo, valid)), s, value=val.to(dev))
        for c, g in zip(res["cpu"], res["cuda"]):
            assert torch.equal(g.cpu(), c)
        lam = torch.from_numpy(rng.integers(0, 40, (d, m)).astype(np.int32))
    assert (res["cuda"].peer_hi >= 2**31).any()


@pytest.mark.cuda
def test_resident_batches_on_card_match_cpu():
    """tracegen map epochs through DeviceMapBatch (from 16 slots: it grows)
    and counter epochs through DeviceCounterBatch, on the card and on the
    CPU: equal checkpoint bytes every round, the oracles' prefixes, the
    card's checkpoint restored on the CPU and back; the one-shot merges
    equal the oracles."""
    _needs_card()
    docs = [tracegen.map_doc(s, n_ops=3000, n_keys=200, sync_every=600) for s in range(3)]
    eps = [tracegen.map_epoch_payloads(d) for d in docs]
    mb = {dev: DeviceMapBatch(3, 16, device=dev, auto_grow=True) for dev in ("cpu", "cuda")}
    for e in range(docs[0].n_epochs):
        for b in mb.values():
            b.append_payloads([ep[e] for ep in eps])
        assert mb["cuda"].export_state() == mb["cpu"].export_state()
        assert mb["cuda"].root_value_maps("m") == [tracegen.oracle_map(d, e + 1) for d in docs]
    assert mb["cuda"].s == 256
    blob = mb["cuda"].export_state()
    assert DeviceMapBatch.import_state(DeviceMapBatch.import_state(blob, device="cpu").export_state(),
                                       device="cuda").export_state() == blob
    cdocs = [tracegen.counter_doc(s, n_incr=1024, n_counters=40, epoch_incr=256) for s in range(3)]
    cb = {dev: DeviceCounterBatch(3, 16, device=dev, auto_grow=True) for dev in ("cpu", "cuda")}
    for e in range(cdocs[0].n_epochs):
        for b in cb.values():
            b.append_changes([d.epoch_changes()[e] for d in cdocs])
        assert cb["cuda"].export_state() == cb["cpu"].export_state()
        assert cb["cuda"].value_maps() == [tracegen.oracle_counter(d, e + 1) for d in cdocs]
    assert cb["cuda"].s == 64
    fl = Fleet(device="cuda")
    from loro_tpu_torch.codec.binary import decode_changes
    from loro_tpu_torch.ops.columnar import extract_map_ops

    exs = [extract_map_ops(decode_changes(tracegen.map_payload(d))) for d in docs]
    assert fl.merge_map_docs(exs) == [tracegen.oracle_map(d) for d in docs]
    assert fl.merge_counter_changes([d.changes for d in cdocs]) == [tracegen.oracle_counter(d) for d in cdocs]


@pytest.mark.cuda
def test_capacity_errors_on_card_leave_the_state_and_the_card_usable():
    """Past capacity without auto_grow: ValueError (map) and RuntimeError
    (counter) before any device write; the bytes are unchanged and a
    fitting append and a device op then run."""
    _needs_card()
    doc = tracegen.map_doc(1, n_ops=400, n_keys=40, sync_every=200)
    p0, p1 = tracegen.map_epoch_payloads(doc)
    mb = DeviceMapBatch(2, 64, device="cuda")
    mb.append_payloads([p0, None])
    before = mb.export_state()
    small = DeviceMapBatch(2, 8, device="cuda")
    with pytest.raises(ValueError, match="slot capacity"):
        small.append_payloads([None, p1])
    assert small.export_state() == DeviceMapBatch(2, 8, device="cuda").export_state()
    mb.append_payloads([p1, None])
    assert mb.root_value_maps("m")[0] == tracegen.oracle_map(doc) and mb.export_state() != before
    cdoc = tracegen.counter_doc(1, n_incr=256, n_counters=12, epoch_incr=128)
    cb = DeviceCounterBatch(1, 4, device="cuda")
    before = cb.export_state()
    with pytest.raises(RuntimeError, match="slot capacity"):
        cb.append_changes([cdoc.changes])
    assert cb.export_state() == before
    cb.grow(16)
    cb.append_changes([cdoc.changes])
    assert cb.value_maps()[0] == tracegen.oracle_counter(cdoc)
    torch.cuda.synchronize()
    assert int(torch.arange(10, device="cuda").sum()) == 45


@pytest.mark.cuda
def test_counter_tenths_on_card_within_stated_tolerance():
    """Deltas k / 10, which no float32 sum holds exactly: the card's
    unordered scatter add stays within count * 2^-24 * sum(|delta|) of the
    CPU's row-order fold, slot by slot."""
    _needs_card()
    rng = np.random.default_rng(9)
    d, m, s = 32, 4096, 96
    slot = torch.from_numpy(rng.integers(0, s, (d, m)).astype(np.int32))
    delta = torch.from_numpy((rng.integers(-640, 641, (d, m)) / 10).astype(np.float32))
    valid = torch.from_numpy(rng.random((d, m)) < 0.9)
    cpu = lww.counter_merge_batch(slot, delta, valid, s, device="cpu").double()
    card = lww.counter_merge_batch(slot, delta, valid, s, device="cuda").cpu().double()
    idx = torch.where(valid, slot.long(), s)
    count = torch.zeros(d, s + 1, dtype=torch.float64).scatter_add_(1, idx, torch.ones(d, m, dtype=torch.float64))
    mass = torch.zeros(d, s + 1, dtype=torch.float64).scatter_add_(1, idx, delta.double().abs())
    tol = count[:, :s] * 2.0**-24 * mass[:, :s]
    assert ((card - cpu).abs() <= tol).all()
