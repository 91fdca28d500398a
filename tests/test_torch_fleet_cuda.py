"""The one-shot fleet text merge and the resident text path's device
ops on the card, against the same calls on the CPU.

Imports torch, numpy, pytest and loro_tpu_torch only, so it runs on a
machine without jax:
    python -m pytest -q -m cuda --noconftest tests/test_torch_fleet_cuda.py
Every test is marked `cuda` and skips without a card.

Tolerance: exact — codes, counts and chain counts are integers.
"""
import numpy as np
import pytest
import torch

from loro_tpu_torch import tracegen
from loro_tpu_torch.ops import fugue_batch as fb
from loro_tpu_torch.ops import list_rank as lr
from loro_tpu_torch.parallel.fleet import Fleet

N = 4096


def _needs_card() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card")


def _docs():
    return tracegen.fleet_docs(2, n_patches=3000, seed=6, use_cache=False)


def _batch(docs, order: str = "apply") -> fb.SeqColumnsU:
    cols = [tracegen.seq_columns_u(d, order, pad_to=N) for d in docs]
    return fb.SeqColumnsU(*[np.stack([getattr(c, f) for c in cols]) for f in fb.SeqColumnsU._fields])


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["apply", "peer"])
def test_chain_merge_docs_u_on_card_matches_cpu(order):
    """At a budget that fits (a kernel launches) and at budgets below the
    chain count (the output is garbage by contract): the same n_chains,
    and no device-side assert."""
    _needs_card()
    docs = _docs()
    np_cols = _batch(docs, order)
    cpu = fb.seq_columns_to_torch(np_cols, device="cpu")
    gpu = fb.seq_columns_to_torch(np_cols, device="cuda")
    want = fb.chain_merge_docs_u(cpu, N, device="cpu")
    lr.reset_launches()
    got = fb.chain_merge_docs_u(gpu, N, device="cuda")
    torch.cuda.synchronize()
    assert sum(lr.LAUNCHES.values()) == 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
    for i, d in enumerate(docs):
        assert "".join(map(chr, got[0][i, : int(got[1][i])].tolist())) == d.text
    for tight in (1, 64, int(want[2].min()) // 2):
        _, _, n_cpu = fb.chain_merge_docs_u(cpu, tight, device="cpu")
        _, _, n_gpu = fb.chain_merge_docs_u(gpu, tight, device="cuda")
        torch.cuda.synchronize()
        assert torch.equal(n_gpu.cpu(), n_cpu) and torch.equal(n_cpu, want[2])


@pytest.mark.cuda
def test_materialize_by_key_on_card_matches_cpu():
    """Keys from a rank solve split with key_hi >= 2^31."""
    _needs_card()
    docs = _docs()
    np_cols = _batch(docs)
    cpu = fb.seq_columns_to_torch(np_cols, device="cpu")
    rank = fb.fugue_order_u(cpu, device="cpu").to(torch.int64)
    hi, lo = 0x80000000 + (rank >> 10), rank & 0x3FF
    assert bool((hi[cpu.valid] >= 2**31).all())
    want = fb.materialize_by_key(cpu, hi, lo, device="cpu")
    got = fb.materialize_by_key(fb.seq_columns_to_torch(np_cols, device="cuda"), hi.cuda(), lo.cuda(), device="cuda")
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
    for i, d in enumerate(docs):
        assert "".join(map(chr, got[0][i, : int(got[1][i])].tolist())) == d.text


@pytest.mark.cuda
@pytest.mark.parametrize("pad_docs", [None, 5])
def test_fleet_merge_text_docs_on_card_matches_cpu(pad_docs):
    _needs_card()
    docs = tracegen.fleet_docs(2, n_patches=2000, seed=7, use_cache=False)
    extracts = [d.extract for d in docs]
    lr.reset_launches()
    got = Fleet(device="cuda").merge_text_docs(extracts, pad_docs=pad_docs).texts
    assert sum(lr.LAUNCHES.values()) == 1
    assert got == Fleet(device="cpu").merge_text_docs(extracts, pad_docs=pad_docs).texts == [d.text for d in docs]
    payloads = [tracegen.trace_payload(d, use_cache=False) for d in docs]
    assert Fleet(device="cuda").merge_text_payloads(payloads, tracegen.TEXT_CID).texts == got
