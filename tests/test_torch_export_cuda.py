"""The read plane's batched export selection (ops/export_batch.ExportIndex
and select_since_batch) on the card, against the same index on the CPU
and tracegen.oracle_export.

Imports torch, numpy, pytest and loro_tpu_torch only, so it runs on a
machine without jax:
    python -m pytest -q -m cuda --noconftest tests/test_torch_export_cuda.py
Every test is marked `cuda` and skips without a card.  Tolerance: none;
row selections are compared exactly.
"""
import random

import numpy as np
import pytest
import torch

from loro_tpu_torch import tracegen
from loro_tpu_torch.codec.binary import decode_changes
from loro_tpu_torch.core.version import VersionVector
from loro_tpu_torch.ops import export_batch as peb
from loro_tpu_torch.ops.export_batch import ExportIndex
from loro_tpu_torch.parallel.fleet import DeviceMovableBatch


def _needs_card() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card")


def _window(rng: random.Random, groups_by_doc, n: int):
    """n requests: VVs at epoch ends, straddling ones (a peer's counter
    inside a change), empty ones and ones naming an absent peer."""
    reqs = []
    for _ in range(n):
        di = rng.randrange(len(groups_by_doc))
        groups = groups_by_doc[di]
        k = rng.randrange(len(groups) + 1)
        vv = {}
        for g in groups[:k]:
            for ch in g:
                vv[ch.peer] = max(vv.get(ch.peer, 0), ch.ctr_end)
        u = rng.random()
        if u < 0.25 and k < len(groups) and groups[k]:
            ch = rng.choice(groups[k])
            if ch.ctr_end - ch.ctr_start > 1:
                vv[ch.peer] = ch.ctr_start + rng.randrange(1, ch.ctr_end - ch.ctr_start)
        elif u < 0.4:
            vv = {}
        elif u < 0.5:
            vv[(1 << 62) + 5] = 9
        reqs.append((di, vv))
    return reqs


@pytest.mark.cuda
def test_select_on_card_matches_cpu_and_oracle(tmp_path, monkeypatch):
    """Two text traces' epochs fed to a card index and a CPU index (both
    grow), a seeded window of 64 requests: equal selections, each equal
    to oracle_export; a commit to one doc ships that doc's rows only and
    the next window still agrees; warm() runs every bucket; a movable
    batch's export_select gives the same answer."""
    _needs_card()
    monkeypatch.setattr(tracegen, "CACHE_DIR", tmp_path)
    docs = tracegen.fleet_docs(1, n_patches=6000, seed=5, use_cache=False)
    groups = [[decode_changes(p) for p in tracegen.epoch_payloads(d, use_cache=False)] for d in docs]
    card, cpu = ExportIndex(len(docs), capacity=8, device="cuda"), ExportIndex(len(docs), capacity=8, device="cpu")
    half = [len(g) // 2 for g in groups]
    for di, gs in enumerate(groups):
        for g in gs[: half[di]]:
            card.note_changes(di, g)
            cpu.note_changes(di, g)
    rng = random.Random(3)
    fed = [gs[: half[di]] for di, gs in enumerate(groups)]
    reqs = _window(rng, fed, 64)
    got = card.select([(di, VersionVector(m)) for di, m in reqs])
    want = cpu.select([(di, VersionVector(m)) for di, m in reqs])
    for (di, m), g, w in zip(reqs, got, want):
        assert np.array_equal(g, w) and g.tolist() == tracegen.oracle_export(fed[di], m)
    assert card._dev[0].is_cuda
    shipped = []
    real = peb._scatter_rows
    monkeypatch.setattr(peb, "_scatter_rows", lambda dev, host, d: (shipped.append(d.tolist()), real(dev, host, d)))
    for g in groups[1][half[1]:]:
        card.note_changes(1, g)
        cpu.note_changes(1, g)
    reqs = _window(rng, [fed[0], groups[1]], 64)
    got = DeviceMovableBatch(len(docs), 16, 4, device="cuda").export_select(
        card, [(di, VersionVector(m)) for di, m in reqs])
    want = cpu.select([(di, VersionVector(m)) for di, m in reqs])
    for (di, m), g, w in zip(reqs, got, want):
        assert np.array_equal(g, w) and g.tolist() == tracegen.oracle_export([fed[0], groups[1]][di], m)
    assert shipped == [[1], [1]] and card.launches == 2  # each index ships doc 1's rows only
    assert card.warm(256) == cpu.warm(256) == 7  # six request buckets, one doc bucket
