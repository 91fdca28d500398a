"""The port's sharded server (loro_tpu_torch.parallel.sharded:
ShardedResidentServer, ShardedPipeline, migrate, recover_sharded_server;
parallel.placement; parallel.mesh's device lists) on the CPU against
the JAX package's.

Torch has one CPU device, so two shards run over ``devices=["cpu",
"cpu"]`` (a device list may name one device twice); the JAX server runs
two shards over a two-device mesh (one device a shard, so each shard's
batch bytes are comparable).  Inputs: test_torch_server's seeded
tracegen.loro_fleet rounds over 6 docs.  Tolerance: exact: rendezvous
placement and the epoch maps for the same keys, epochs, reads, the fleet
checkpoint bytes (its manifest and every shard's checkpoint), migration,
the durable directories and their recovery.
"""
import json
import random
from pathlib import Path

import jax
import pytest

from loro_tpu.parallel import placement as jplacement
from loro_tpu.parallel.mesh import make_mesh
from loro_tpu.parallel.sharded import ShardedResidentServer as JSharded
from loro_tpu.parallel.sharded import recover_sharded_server as jrecover_sharded
from loro_tpu.resilience import faultinject as jfi
from loro_tpu_torch import tracegen as tg
from loro_tpu_torch.errors import ConfigError, DeviceFailure, KernelLaunchError, ShardingError
from loro_tpu_torch.parallel import placement as pplacement
from loro_tpu_torch.parallel.mesh import make_mesh as pmake_mesh
from loro_tpu_torch.parallel.mesh import shard_meshes
from loro_tpu_torch.parallel.server import ResidentServer as PServer
from loro_tpu_torch.parallel.sharded import ShardedResidentServer as PSharded
from loro_tpu_torch.persist import recover_sharded_server
from loro_tpu_torch.resilience import faultinject as pfi
from test_torch_server import FAMILIES, _quiet, jcid_of, reads  # noqa: F401

N_DOCS = 6
CPU2 = ["cpu", "cpu"]


@pytest.fixture(scope="module")
def fleet6():
    return tg.loro_fleet(9, N_DOCS, n_rounds=5)


def jmesh2():
    return make_mesh(jax.devices()[:2])


def sharded_twins(family, **kw):
    caps = {**FAMILIES[family][1], **kw}
    return (JSharded(family, N_DOCS, shards=2, mesh=jmesh2(), **caps),
            PSharded(family, N_DOCS, shards=2, devices=CPU2, **caps))


def rounds6(fleet6):
    return [[d.epochs[r] for d in fleet6] for r in range(5)]


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 7])
def test_placement_equals_jax(n_shards):
    """rendezvous_shard, ShardPlacement (custom keys, spare slots, moves)
    and the epoch maps give the JAX package's answers for the same
    keys."""
    keys = [f"doc-{i}" for i in range(50)] + [str(i) for i in range(50)]
    assert [pplacement.rendezvous_shard(k, n_shards) for k in keys] == \
        [jplacement.rendezvous_shard(k, n_shards) for k in keys]
    for ks in (None, keys[:40]):
        pp = pplacement.ShardPlacement(40, n_shards, keys=ks, spare_slots=2)
        jp = jplacement.ShardPlacement(40, n_shards, keys=ks, spare_slots=2)
        if n_shards > 1:
            for di in (0, 7):
                to = (pp.place(di)[0] + 1) % n_shards
                assert pp.move(di, to) == jp.move(di, to)
        for f in ("keys", "shard_of", "slot_of", "widths", "free"):
            assert getattr(pp, f) == getattr(jp, f), f
    rng = random.Random(n_shards)
    pm, jm = pplacement._EpochMap(), jplacement._EpochMap()
    g = e = 0
    for _ in range(40):
        g += 1
        e += rng.choice([1, 1, 2])
        pm.note(g, e)
        jm.note(g, e)
    assert pm.encode() == jm.encode()
    for x in range(0, e + 3):
        assert pm.to_global(x) == jm.to_global(x)
    for x in range(0, g + 3):
        assert pm.to_shard(x) == jm.to_shard(x)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_sharded_matches_jax_and_single_servers(fleet6, family):
    """Two shards: serial rounds and a coalesced group give the JAX
    sharded server's global epochs, reads and fleet checkpoint bytes;
    each shard's batch equals a single port server fed that shard's
    slices."""
    cid = FAMILIES[family][0]
    j, p = sharded_twins(family)
    rounds = rounds6(fleet6)
    for r in rounds[:3]:
        assert j.ingest(r, jcid_of(cid)) == p.ingest(r, cid)
    assert j.ingest_coalesced(rounds[3:], jcid_of(cid)) == p.ingest_coalesced(rounds[3:], cid)
    assert p.epoch == j.epoch == len(rounds)
    assert reads(p, family) == reads(j, family)
    assert [p.placement.place(g) for g in range(N_DOCS)] == [j.placement.place(g) for g in range(N_DOCS)]
    for s in range(2):
        ref = PServer(family, p.placement.widths[s], device="cpu", **FAMILIES[family][1])
        for r in rounds:
            part = [None] * p.placement.widths[s]
            for g, u in enumerate(r):
                ss, slot = p.placement.place(g)
                if ss == s:
                    part[slot] = u
            ref.ingest(part, cid)
        assert ref.batch.export_state() == p.shards[s].batch.export_state()
    assert j.checkpoint() == p.checkpoint()


def test_sharded_pipeline_resolves_global_epochs_in_order(fleet6):
    """Per-shard pipelines behind one submit: global epochs 1..n in
    submit order, reads and checkpoint bytes equal serial ingest's."""
    cid = FAMILIES["text"][0]
    rounds = rounds6(fleet6)
    _, serial = sharded_twins("text")
    for r in rounds:
        serial.ingest(r, cid)
    _, p = sharded_twins("text")
    ex = p.pipeline(cid=cid, coalesce=2)
    futs = [ex.submit(list(r)) for r in rounds]
    assert [f.epoch(timeout=60) for f in futs] == list(range(1, len(rounds) + 1))
    ex.flush()
    rep = ex.report()
    assert rep["shards"] == 2 and rep["rounds"] == len(rounds)
    assert p.texts() == serial.texts() and p.checkpoint() == serial.checkpoint()
    p.close()


def test_migrate_matches_jax(fleet6):
    """A doc moved to the other shard after a checkpoint (its history
    re-exported from the deep mirror anchor): the same migration epoch,
    placement, reads and fleet checkpoint bytes as JAX's, and later
    rounds land under the new placement."""
    cid = FAMILIES["text"][0]
    j, p = sharded_twins("text")
    rounds = rounds6(fleet6)
    for r in rounds[:3]:
        assert j.ingest(r, jcid_of(cid)) == p.ingest(r, cid)
    assert j.checkpoint() == p.checkpoint()
    src = p.placement.place(1)[0]
    assert j.migrate(1, 1 - src) == p.migrate(1, 1 - src)
    assert p.placement.place(1) == j.placement.place(1) and p.placement.place(1)[0] == 1 - src
    for r in rounds[3:]:
        assert j.ingest(r, jcid_of(cid)) == p.ingest(r, cid)
    assert reads(p, "text") == reads(j, "text")
    assert j.checkpoint() == p.checkpoint()
    full = PServer("text", N_DOCS, device="cpu", capacity=64)
    for r in rounds:
        full.ingest(r, cid)
    assert p.texts() == full.texts()


def test_migration_needs_a_spare_slot(fleet6):
    srv = PSharded("map", 4, shards=2, devices=CPU2, spare_slots=0, slot_capacity=16)
    srv.ingest([None] * 4)
    src, _ = srv.placement.place(0)
    with pytest.raises(ShardingError):
        srv.migrate(0, 1 - src)


def _files(d):
    return sorted(str(x.relative_to(d)) for x in Path(d).rglob("*") if x.is_file())


def test_recover_sharded_server_matches_jax(tmp_path, fleet6):
    """Durable sharded fleets (a shard-NN/ WAL and ladder each, the
    sharding.json manifest): byte-equal directories, and
    recover_sharded_server of either directory gives JAX's recovered
    global epoch, durable watermark, placement and reads."""
    cid = FAMILIES["text"][0]
    jd, pd = tmp_path / "jax", tmp_path / "port"
    j, p = (JSharded("text", N_DOCS, shards=2, mesh=jmesh2(), durable_dir=str(jd), capacity=64),
            PSharded("text", N_DOCS, shards=2, devices=CPU2, durable_dir=str(pd), capacity=64))
    rounds = rounds6(fleet6)
    for r in rounds[:2]:
        assert j.ingest(r, jcid_of(cid)) == p.ingest(r, cid)
    assert j.checkpoint() == p.checkpoint()
    for r in rounds[2:]:
        assert j.ingest(r, jcid_of(cid)) == p.ingest(r, cid)
    want = reads(p, "text")
    j.close()
    p.close()
    assert _files(jd) == _files(pd)
    for name in _files(pd):
        assert (jd / name).read_bytes() == (pd / name).read_bytes(), name
    jrec = jrecover_sharded(str(jd), mesh=jmesh2())
    for d in (jd, pd):
        rec = recover_sharded_server(str(d), devices=CPU2)
        assert (rec.epoch, rec.durable_epoch) == (jrec.epoch, jrec.durable_epoch) == (len(rounds), len(rounds))
        assert reads(rec, "text") == reads(jrec, "text") == want
        assert [s.last_recovery.rounds_replayed for s in rec.shards] == \
            [s.last_recovery.rounds_replayed for s in jrec.shards]
        rec.ingest([None] * N_DOCS, cid)
        assert rec.epoch == len(rounds) + 1
        rec.close()
    jrec.close()


def test_armed_failure_degrades_one_shard_like_jax(fleet6):
    """An armed launch fault degrades one shard onto its host mirror in
    both packages (the same shard); the other serves on; reads equal
    JAX's throughout, and recover() puts it back."""
    cid = FAMILIES["text"][0]
    j, p = sharded_twins("text")
    rounds = rounds6(fleet6)
    assert j.ingest(rounds[0], jcid_of(cid)) == p.ingest(rounds[0], cid)
    jfi.inject("launch", exc=OSError("armed"), times=1)
    pfi.inject("launch", exc=OSError("armed"), times=1)
    assert j.ingest(rounds[1], jcid_of(cid)) == p.ingest(rounds[1], cid)
    assert p.degraded_shards() == j.degraded_shards() and len(p.degraded_shards()) == 1
    for r in rounds[2:]:
        assert j.ingest(r, jcid_of(cid)) == p.ingest(r, cid)
    assert reads(p, "text") == reads(j, "text")
    assert j.recover() and p.recover() and not p.degraded
    assert reads(p, "text") == reads(j, "text")


def test_real_device_error_on_one_shard_reaches_the_caller(fleet6, monkeypatch):
    """A real device error in one shard's batch (a failed kernel launch)
    reaches the caller of the sharded ingest typed; no shard degrades."""
    cid = FAMILIES["text"][0]
    _, p = sharded_twins("text")
    rounds = rounds6(fleet6)
    p.ingest(rounds[0], cid)

    def fail(*a, **k):
        raise KernelLaunchError("cudaErrorLaunchFailure (test)")

    monkeypatch.setattr(p.shards[1].batch, "append_payloads", fail)
    with pytest.raises(DeviceFailure) as info:
        p.ingest(rounds[1], cid)
    assert not info.value.injected and p.degraded_shards() == []


def test_device_lists_and_shard_knobs(monkeypatch):
    """shard_meshes carves contiguous slices and refuses a count that does
    not divide the list; shards defaults to the list's length, then
    LORO_SHARDS (typed ConfigError on a bad value); each shard's server is
    bound to the first device of its slice."""
    devs = pmake_mesh(["cpu"] * 4)
    assert [len(s) for s in shard_meshes(devs, 2)] == [2, 2]
    with pytest.raises(ConfigError):
        shard_meshes(devs, 3)
    with pytest.raises(ConfigError):
        shard_meshes(devs, 0)
    with pytest.raises(ConfigError):
        PSharded("map", 4, shards=3, devices=["cpu"] * 4)
    srv = PSharded("map", 4, devices=["cpu"] * 4)
    assert srv.n_shards == 4 and all(s.batch.device.type == "cpu" for s in srv.shards)
    monkeypatch.setenv("LORO_SHARDS", "2")
    assert PSharded("map", 4, devices=["cpu"] * 4).n_shards == 2
    monkeypatch.setenv("LORO_SHARDS", "zero")
    with pytest.raises(ConfigError):
        PSharded("map", 4, devices=["cpu"] * 4)
    json.dumps(srv._manifest())


def test_heat_accountant_matches_jax():
    """obs.heat (the per-doc and per-shard decayed heat the tiered and
    sharded servers tick) on one injected clock: the same report as the
    JAX package's after the same events, pruning included."""
    from loro_tpu.obs import heat as jheat
    from loro_tpu_torch.obs import heat as pheat

    now = [0.0]
    accts = [m.HeatAccountant(clock=lambda: now[0], half_life_s=10.0, top_k=4, max_docs=16) for m in (jheat, pheat)]
    rng = random.Random(3)
    for step in range(300):
        now[0] += rng.choice([0.0, 0.5, 2.0])
        kind, di = rng.choice(["push", "pull", "touch"]), rng.randrange(40)
        shard = rng.randrange(3)
        for a in accts:
            a.tick_doc(di, kind)
            a.tick_shard(shard, "ingest", of=4)
            if step % 7 == 0:
                a.tick_shard(shard, "degradation")
                a.tick_revive(2.0)
    assert accts[0].report() == accts[1].report()
    assert [a.doc_heat(5) for a in accts][0] == accts[1].doc_heat(5)
    assert accts[0].skew_ratio() == accts[1].skew_ratio() is not None


def test_sharded_pipelines_under_thread_stress(fleet6):
    """Four shards over one device (four stage and four commit threads and
    the collector) with a tiny interpreter switch interval: the global
    epochs resolve 1..n in order and the fleet ends in the bytes of
    serial ingest (a lost or doubled round would change both)."""
    import sys

    cid = FAMILIES["text"][0]
    rounds = rounds6(fleet6)
    kw = dict(shards=4, devices=["cpu"] * 4, capacity=64)
    serial = PSharded("text", N_DOCS, **kw)
    for r in rounds:
        serial.ingest(r, cid)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        p = PSharded("text", N_DOCS, **kw)
        ex = p.pipeline(cid=cid, coalesce=2, depth=1)
        futs = [ex.submit(list(r)) for r in rounds]
        assert [f.epoch(timeout=60) for f in futs] == list(range(1, len(rounds) + 1))
        ex.close()
    finally:
        sys.setswitchinterval(old)
    assert p.checkpoint() == serial.checkpoint()
