"""The rich-text merge on the card (its order solves launch the CUDA
list-rank kernels), against the same calls on the CPU and tracegen's
oracle.

Imports torch, numpy, pytest and loro_tpu_torch only, so it runs on a
machine without jax:
    python -m pytest -q -m cuda --noconftest tests/test_torch_richtext_cuda.py
Every test is marked `cuda` and skips without a card.  Tolerance: none;
codes, counts, region bounds and winners are integers.
"""
import numpy as np
import pytest
import torch

from loro_tpu_torch import tracegen
from loro_tpu_torch.ops import fugue_batch as fb
from loro_tpu_torch.ops import list_rank as lr
from loro_tpu_torch.ops import richtext_batch as rb
from loro_tpu_torch.parallel.fleet import DeviceDocBatch, Fleet


def _needs_card() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card")


def _docs():
    return [tracegen.richtext_doc(s, n_chars=1_500, n_marks=120, sync_every=200) for s in range(3)]


def _same(got, want) -> None:
    for g, w in zip(got, want):
        assert g.is_cuda and g.dtype == w.dtype and torch.equal(g.cpu(), w)


def _launched(fn):
    """fn's result and the list-rank launches it made."""
    before = dict(lr.LAUNCHES)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v - before[k] for k, v in lr.LAUNCHES.items() if v != before[k]}


@pytest.mark.cuda
def test_chain_and_element_paths_on_card_match_cpu():
    """richtext_chain_merge_batch and richtext_merge_batch on the card: one
    ruling launch each, every output equal to the CPU's, and the
    segments equal to the oracle's."""
    _needs_card()
    docs = _docs()
    ex = [rb.extract_richtext_chain(d.changes, tracegen.TEXT_CID) for d in docs]
    n = fb.pad_bucket(max(c.chain.chain_id.shape[0] for c, _, _ in ex))
    c_pad = fb.pad_bucket(max(c.chain.c_parent.shape[0] for c, _, _ in ex))
    p = fb.pad_bucket(max(c.pair_start.shape[0] for c, _, _ in ex), floor=16)
    cols = rb.stack_richtext_chain_cols([c for c, _, _ in ex], n, c_pad, p, 4)
    want = rb.richtext_chain_merge_batch(cols, 4, device="cpu")
    got, ran = _launched(lambda: rb.richtext_chain_merge_batch(cols, 4, device="cuda"))
    assert sum(ran.values()) == 1 and list(ran)[0].startswith("ruling/")
    _same(got, want)
    for i, (d, (_, keys, values)) in enumerate(zip(docs, ex)):
        segs = rb.segments_from_device(*(t[i].cpu().numpy() for t in got), keys, values)
        assert segs == tracegen.oracle_richtext(d)
    el = [rb.extract_richtext(d.changes, tracegen.TEXT_CID)[0] for d in docs]
    ne = fb.pad_bucket(max(c.seq.parent.shape[0] for c in el))
    ecols = rb.RichtextCols(
        fb.stack_seq_columns([c.seq for c in el], ne),
        *[np.stack([np.concatenate([getattr(c, f), np.full(p - getattr(c, f).shape[0], rb._PAIR_FILL[f],
                                                           getattr(c, f).dtype)]) for c in el])
          for f in rb._PAIR_FIELDS])
    want_e = rb.richtext_merge_batch(ecols, 4, device="cpu")
    got_e, ran = _launched(lambda: rb.richtext_merge_batch(ecols, 4, device="cuda"))
    assert sum(ran.values()) == 1
    _same(got_e, want_e)
    assert torch.equal(got_e[2].cpu(), want[2][:3]) and torch.equal(got_e[3].cpu(), want[3][:3])


@pytest.mark.cuda
@pytest.mark.parametrize("p", [0, 1, 40])
def test_resolve_styles_on_card_matches_cpu(p):
    _needs_card()
    rng = np.random.default_rng(p)
    d, count = 6, 50
    cnt = rng.integers(0, count, d).astype(np.int32)
    a_start = (rng.random((d, p)) * (cnt[:, None] + 1)).astype(np.int32)
    cols = (rng.random((d, p)) < 0.8, rng.integers(0, 6, (d, p)).astype(np.int32),
            rng.integers(-1, 5, (d, p)).astype(np.int32), rng.integers(0, 4, (d, p)).astype(np.int32),
            rng.integers(0, 3, (d, p)).astype(np.int32), a_start,
            np.minimum(a_start + rng.integers(0, 12, (d, p)), cnt[:, None]).astype(np.int32), cnt)
    want = rb._resolve_styles(*(torch.from_numpy(a) for a in cols), 4)
    _same(rb._resolve_styles(*(torch.from_numpy(a).cuda() for a in cols), 4), want)


@pytest.mark.cuda
def test_fleet_and_resident_richtext_on_card():
    """merge_richtext_changes on the card, and a DeviceDocBatch on the card
    fed one epoch a round, against the oracle at every prefix."""
    _needs_card()
    docs = _docs()
    cid = tracegen.TEXT_CID
    (out, ran) = _launched(lambda: Fleet(device="cuda").merge_richtext_changes([d.changes for d in docs], cid))
    assert out == [tracegen.oracle_richtext(d) for d in docs] and sum(ran.values()) == 1
    eps = [tracegen.richtext_epoch_payloads(d) for d in docs]
    gb = DeviceDocBatch(3, 64, device="cuda", auto_grow=True)
    for e in range(max(map(len, eps))):
        gb.append_payloads([ep[e] if e < len(ep) else None for ep in eps], cid)
        assert gb.richtexts() == [tracegen.oracle_richtext(d, e + 1) for d in docs]
