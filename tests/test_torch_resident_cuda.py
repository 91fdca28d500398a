"""The resident text batch (parallel.fleet.DeviceDocBatch) and its device
ops on the card, against the same calls on the CPU.

Imports torch, numpy, pytest and loro_tpu_torch only, so it runs on a
machine without jax:
    python -m pytest -q -m cuda --noconftest tests/test_torch_resident_cuda.py
Every test is marked `cuda` and skips without a card.

Tolerance: exact (rows, keys and checkpoint bytes are integers).
"""
import numpy as np
import pytest
import torch

from loro_tpu_torch import tracegen
from loro_tpu_torch.ops import list_rank as lr
from loro_tpu_torch.parallel import fleet as pfleet
from loro_tpu_torch.parallel.fleet import DeviceDocBatch


def _needs_card() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card")


def _epochs():
    docs = tracegen.fleet_docs(2, n_patches=9000, seed=8, use_cache=False)
    return docs, [tracegen.epoch_payloads(d, use_cache=False) for d in docs]


@pytest.mark.cuda
def test_block_scatter_tombstones_and_key_rows_on_card_match_cpu():
    """The block scatter at per-doc offsets (invalid block rows keep the
    window's values), the tombstone scatter and whole key-row writes,
    on every column dtype the batch holds."""
    _needs_card()
    rng = np.random.default_rng(3)
    d, cap, w = 6, 512, 64
    state = {
        "parent": rng.integers(-1, 500, (d, cap)).astype(np.int32),
        "peer_hi": rng.integers(0, 2**32, (d, cap)).astype(np.int64),
        "deleted": rng.random((d, cap)) < 0.5,
    }
    blk = {f: (rng.integers(-1, 500, (d, w)).astype(np.int32) if f == "parent" else
               rng.integers(0, 2**32, (d, w)).astype(np.int64) if f == "peer_hi" else rng.random((d, w)) < 0.5)
           for f in state}
    blk["valid"] = rng.random((d, w)) < 0.7
    offsets = rng.integers(0, cap - w + 1, d).astype(np.int64)
    d_idx = rng.integers(0, d, 40).astype(np.int64)
    r_idx = rng.integers(0, cap, 40).astype(np.int64)
    key_rows = rng.integers(0, 2**32, (2, cap))
    out = {}
    for dev in ("cpu", "cuda"):
        st = {f: torch.from_numpy(a.copy()).to(dev) for f, a in state.items()}
        b = {f: torch.from_numpy(a).to(dev) for f, a in blk.items()}
        pfleet._scatter_rows(st, b, torch.from_numpy(offsets).to(dev))
        pfleet._set_deleted(st["deleted"], torch.from_numpy(d_idx).to(dev), torch.from_numpy(r_idx).to(dev))
        hi = torch.from_numpy(state["peer_hi"].copy()).to(dev)
        lo = hi.clone()
        rows = torch.from_numpy(key_rows).to(dev)
        pfleet._set_key_rows(hi, lo, torch.tensor([4, 1], device=dev), rows, rows + 1)
        out[dev] = {**{f: t.cpu() for f, t in st.items()}, "key_hi": hi.cpu(), "key_lo": lo.cpu()}
    torch.cuda.synchronize()
    for f, t in out["cpu"].items():
        assert torch.equal(out["cuda"][f], t), f
    # the windows took valid rows only
    for i in range(d):
        win = out["cpu"]["parent"][i, offsets[i] : offsets[i] + w].numpy()
        assert np.array_equal(win, np.where(blk["valid"][i], blk["parent"][i], state["parent"][i, offsets[i] : offsets[i] + w]))


@pytest.mark.cuda
def test_device_doc_batch_on_card_exports_the_cpu_bytes():
    """Sync epochs of generated docs, grown across a capacity boundary:
    after every round the card batch's checkpoint equals the CPU batch's;
    texts by the standing keys and by the solver equal the oracle, the
    solver launching a list-rank kernel; the checkpoint restores on the
    card."""
    _needs_card()
    docs, eps = _epochs()
    batches = {dev: DeviceDocBatch(4, 1024, device=dev, auto_grow=True) for dev in ("cpu", "cuda")}
    for e in range(len(eps[0])):
        for b in batches.values():
            b.append_payloads([eps[j % 3][e] for j in range(4)], tracegen.TEXT_CID)
        assert batches["cuda"].export_state() == batches["cpu"].export_state()
    gpu = batches["cuda"]
    assert gpu.cap > 1024 and gpu.key_hi.is_cuda
    want = [docs[j % 3].text for j in range(4)]
    assert gpu.texts() == want
    lr.reset_launches()
    assert gpu.texts(use_solver=True) == want
    assert sum(lr.LAUNCHES.values()) >= 1
    blob = gpu.export_state()
    restored = DeviceDocBatch.import_state(blob, device="cuda")
    assert restored.cols.parent.is_cuda and restored.export_state() == blob and restored.texts() == want


@pytest.mark.cuda
def test_over_capacity_append_raises_with_no_device_assert():
    """An append past the capacity raises RuntimeError before any device
    write: the state is unchanged, the card stays usable (a device assert
    would poison every later call), and the append fits after grow()."""
    _needs_card()
    _, eps = _epochs()
    b = DeviceDocBatch(2, 8192, device="cuda")
    b.append_payloads([eps[0][0], eps[1][0]], tracegen.TEXT_CID)
    small = DeviceDocBatch(2, pfleet.pad_bucket(int(b.counts.max()), floor=16), device="cuda")
    small.append_payloads([eps[0][0], eps[1][0]], tracegen.TEXT_CID)
    kept = small.export_state()
    with pytest.raises(RuntimeError, match="capacity exceeded"):
        small.append_payloads([eps[0][1], eps[1][1]], tracegen.TEXT_CID)
    with pytest.raises(RuntimeError, match="capacity exceeded"):
        DeviceDocBatch(1, 16, device="cuda").append_payloads([eps[0][0]], tracegen.TEXT_CID)
    torch.cuda.synchronize()
    assert small.export_state() == kept
    assert all(len(m) == int(c) for m, c in zip(small.id2row, small.counts))
    small.grow(8192)
    small.append_payloads([eps[0][1], eps[1][1]], tracegen.TEXT_CID)
    b.append_payloads([eps[0][1], eps[1][1]], tracegen.TEXT_CID)
    torch.cuda.synchronize()
    assert small.texts() == b.texts()
