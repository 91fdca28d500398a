"""The port's tiered residency (loro_tpu_torch.parallel.residency:
TieredBatch, ResidencyManager, TieredResidentServer) on the CPU against
the JAX package's and against always-hot servers.

Inputs: test_torch_server's seeded tracegen.loro_fleet rounds over 4
docs with a hot set of 2 or 3 device slots, so rounds evict and revive
docs.  The tier policy's clock (last-touch times) is the same counter in
both packages.  Tolerance: exact: reads, epochs, tier maps, the
residency report's counts and checkpoint bytes equal the JAX tiered
server's, and reads equal an always-hot server's.  Covered too: the
hot-budget and host_fallback errors, the evict_flush and revive_replay
fault sites, an armed degradation and recover(), the durable cold tier
(demote, cold revive, recover_server) and eviction's in-place
release_doc (the slot's rows back at the batch's construction fill).
"""
import json

import pytest
import torch

from loro_tpu.parallel.residency import TieredResidentServer as JTiered
from loro_tpu.persist import recover_server as jrecover_server
from loro_tpu.resilience import faultinject as jfi
from loro_tpu_torch.errors import ResidencyError
from loro_tpu_torch.parallel.residency import TieredResidentServer as PTiered
from loro_tpu_torch.parallel.server import ResidentServer as PServer
from loro_tpu_torch.persist import recover_server
from loro_tpu_torch.resilience import faultinject as pfi
from test_torch_server import (FAMILIES, _quiet, _tiered_fake_clock, fleet, jcid_of, mesh, reads,  # noqa: F401
                               rounds_of)

REPORT_KEYS = ("hot_slots", "docs", "hits", "misses", "promotions", "evictions", "demotions", "cold_revives",
               "hot", "warm", "cold")


def tiered_twins(family, n_docs, hot_slots, **kw):
    caps = {**FAMILIES[family][1], **kw}
    j = JTiered(family, n_docs, hot_slots=hot_slots, mesh=mesh(), **caps)
    p = PTiered(family, n_docs, hot_slots=hot_slots, device="cpu", **caps)
    _tiered_fake_clock(j)
    _tiered_fake_clock(p)
    return j, p


def raw_reads(srv, family):
    """The reads as the port returns them, compared with == (a revived
    doc's maps may list their keys in another order than an always-hot
    doc's; the JAX tiered server's order is the port's, held by plain)."""
    names = FAMILIES[family][2]
    return [getattr(srv, n)("m") if n == "root_value_maps" else getattr(srv, n)() for n in names]


def _report(srv):
    rep = srv.residency.report()
    return {k: rep[k] for k in REPORT_KEYS}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_tiered_matches_jax_and_always_hot(fleet, family):
    """hot_slots=3 over 4 docs: every round's reads equal the JAX tiered
    server's and an always-hot port server's; tier maps, report counts
    (evictions and revives happen) and checkpoint bytes equal JAX's."""
    cid = FAMILIES[family][0]
    j, p = tiered_twins(family, len(fleet), 3)
    hot = PServer(family, len(fleet), device="cpu", **FAMILIES[family][1])
    rounds = rounds_of(fleet)
    for i, r in enumerate(rounds):
        assert j.ingest(r, jcid_of(cid)) == p.ingest(r, cid)
        hot.ingest(r, cid)
        assert reads(p, family) == reads(j, family)
        assert raw_reads(p, family) == raw_reads(hot, family)
        assert p.residency.tiers() == j.residency.tiers()
        if i == len(rounds) // 2:
            assert j.checkpoint() == p.checkpoint()
    assert _report(p) == _report(j)
    assert _report(p)["evictions"] > 0 and _report(p)["promotions"] > 3
    assert j.checkpoint() == p.checkpoint()


@pytest.mark.parametrize("family", ["text", "map"])
def test_tiered_pipeline_matches_jax(fleet, family):
    """The same rounds through pipeline(coalesce=4) on tiered servers (the
    group bounded by pipeline_doc_budget): reads equal JAX's piped tiered
    server's and the always-hot server's."""
    cid = FAMILIES[family][0]
    j, p = tiered_twins(family, len(fleet), 3)
    hot = PServer(family, len(fleet), device="cpu", **FAMILIES[family][1])
    rounds = rounds_of(fleet)
    for srv, c in ((j, jcid_of(cid)), (p, cid)):
        ex = srv.pipeline(cid=c, coalesce=4)
        futs = [ex.submit(list(r)) for r in rounds]
        ex.flush()
        assert [f.epoch() for f in futs] == sorted(f.epoch() for f in futs)
        ex.close()
    for r in rounds:
        hot.ingest(r, cid)
    assert p.pipeline_doc_budget == j.pipeline_doc_budget == 1
    assert reads(p, family) == reads(j, family)
    assert raw_reads(p, family) == raw_reads(hot, family)


def test_budget_and_host_fallback_errors(fleet):
    """A round touching more docs than hot_slots fails typed; tiering
    without host_fallback or a mirror anchor is refused (as JAX's)."""
    cid = FAMILIES["text"][0]
    srv = PTiered("text", len(fleet), hot_slots=2, device="cpu", capacity=64)
    with pytest.raises(ResidencyError):
        srv.ingest([d.epochs[0] for d in fleet], cid)
    with pytest.raises(ResidencyError):
        PServer("text", 4, device="cpu", hot_slots=2, host_fallback=False)
    with pytest.raises(ResidencyError):
        PServer("text", 4, device="cpu", hot_slots=2, mirror_anchor=False)


def _one_hot_slot(fleet):
    cid = FAMILIES["text"][0]
    srv = PTiered("text", 2, hot_slots=1, device="cpu", capacity=64)
    srv.ingest([fleet[0].epochs[0], None], cid)
    return srv, cid, [None, fleet[1].epochs[0]]


def test_evict_fault_leaves_the_doc_hot(fleet):
    """An armed evict_flush fault: the round fails typed, the victim stays
    hot, the server is not degraded, and the same round then lands once."""
    srv, cid, round1 = _one_hot_slot(fleet)
    pfi.inject("evict_flush", times=1)
    with pytest.raises(ResidencyError):
        srv.ingest(round1, cid)
    assert srv.residency.tier_of(0) == "hot" and srv.residency.tier_of(1) == "warm"
    assert not srv.degraded
    srv.ingest(round1, cid)
    want = PServer("text", 2, device="cpu", capacity=64)
    want.ingest([fleet[0].epochs[0], None], cid)
    want.ingest(round1, cid)
    assert srv.texts() == want.texts() and srv.residency.tier_of(1) == "hot"


def test_revive_fault_fails_only_the_round(fleet):
    """An armed revive_replay fault fails only the triggering round: the
    doc stays warm, no epoch is spent, the next round succeeds."""
    srv, cid, round1 = _one_hot_slot(fleet)
    srv.ingest(round1, cid)  # doc 0 -> warm, doc 1 hot
    e = srv.epoch
    pfi.inject("revive_replay", times=1)
    with pytest.raises(ResidencyError):
        srv.ingest([fleet[0].epochs[1], None], cid)
    assert srv.residency.tier_of(0) == "warm" and srv.epoch == e and not srv.degraded
    srv.ingest([fleet[0].epochs[1], None], cid)
    assert srv.residency.tier_of(0) == "hot"


def test_eviction_releases_the_slot_in_place(fleet):
    """An evicted doc's device slot holds the batch's construction fills
    again (the port's in-place release_doc) before its reuse."""
    cid = FAMILIES["text"][0]
    srv = PTiered("text", 4, hot_slots=1, device="cpu", capacity=64)
    fresh = srv.batch.inner.cols
    fills = {f: getattr(fresh, f)[0].clone() for f in fresh._fields}
    srv.ingest([fleet[0].epochs[0], None, None, None], cid)
    released = []
    real = srv.batch.inner.release_doc

    def spy(slot):
        real(slot)
        cols = srv.batch.inner.cols
        released.append(all(torch.equal(getattr(cols, f)[slot], fills[f]) for f in cols._fields))

    srv.batch.inner.release_doc = spy
    srv.ingest([None, fleet[1].epochs[0], None, None], cid)
    assert released == [True]
    assert srv.residency.report()["evictions"] == 1


def test_armed_degradation_and_recover_with_tiers(fleet):
    """An armed launch fault degrades a tiered server (both packages):
    reads equal while degraded and after recover(), and both recovered
    servers checkpoint to the same bytes."""
    cid = FAMILIES["text"][0]
    j, p = tiered_twins("text", len(fleet), 3)
    rounds = rounds_of(fleet)
    for r in rounds[:-2]:
        j.ingest(r, jcid_of(cid))
        p.ingest(r, cid)
    jfi.inject("launch", exc=OSError("armed"), times=1)
    pfi.inject("launch", exc=OSError("armed"), times=1)
    for r in rounds[-2:]:
        assert j.ingest(r, jcid_of(cid)) == p.ingest(r, cid)
    assert j.degraded and p.degraded and reads(p, "text") == reads(j, "text")
    assert j.recover() and p.recover()
    assert reads(p, "text") == reads(j, "text")
    assert j.checkpoint() == p.checkpoint()


def test_durable_cold_tier_matches_jax(tmp_path, fleet):
    """Durable tiered servers: a checkpoint, a warm doc demoted to cold
    (its anchor blob dropped, residency.json naming the rung), a round
    that revives it from the rung and the WAL, a second demotion and
    checkpoint, close, recover_server by each package of each directory:
    the same tiers, epochs, reads and residency.json as JAX's."""
    cid = FAMILIES["text"][0]
    dirs = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
    j = JTiered("text", len(fleet), hot_slots=2, mesh=mesh(), durable_dir=str(dirs["jax"]), capacity=64)
    p = PTiered("text", len(fleet), hot_slots=2, device="cpu", durable_dir=str(dirs["port"]), capacity=64)
    _tiered_fake_clock(j)
    _tiered_fake_clock(p)
    rounds = rounds_of(fleet)
    one_doc = [[u if i == k else None for i, u in enumerate(r)] for r in rounds for k in range(len(fleet))]
    one_doc = [r for r in one_doc if any(u is not None for u in r)]
    for r in one_doc[:8]:
        assert j.ingest(r, jcid_of(cid)) == p.ingest(r, cid)
    assert j.checkpoint() == p.checkpoint()
    warm = p.residency.tiers()["warm"]
    assert warm == j.residency.tiers()["warm"] and warm
    for srv in (j, p):
        srv.batch.demote(warm[0])
        assert srv.residency.tier_of(warm[0]) == "cold" and srv._anchor.doc_blobs[warm[0]] == b""
    nxt = next(r for r in one_doc[8:] if r[warm[0]] is not None)
    assert j.ingest(nxt, jcid_of(cid)) == p.ingest(nxt, cid)
    assert p.residency.report()["cold_revives"] == j.residency.report()["cold_revives"] == 1
    assert reads(p, "text") == reads(j, "text")
    warm2 = p.residency.tiers()["warm"]
    for srv in (j, p):
        srv.batch.demote(warm2[0])
    assert j.checkpoint() == p.checkpoint()
    assert json.loads((dirs["jax"] / "residency.json").read_text()) == \
        json.loads((dirs["port"] / "residency.json").read_text())
    want, epoch = reads(p, "text"), p.epoch
    j.close()
    p.close()
    jback = jrecover_server(str(dirs["jax"]), mesh=mesh())
    for d in dirs.values():
        back = recover_server(str(d), device="cpu")
        assert back.epoch == back.durable_epoch == epoch == jback.epoch
        assert back.residency.tier_of(warm2[0]) == jback.residency.tier_of(warm2[0]) == "cold"
        assert back.residency.tiers() == jback.residency.tiers()
        assert reads(back, "text") == want
        back.close()
    assert reads(jback, "text") == want
    jback.close()
