"""The port's ResidentServer (loro_tpu_torch.parallel.server) on the CPU
against the JAX package's, on the same seeded rounds.

Inputs: tracegen.loro_fleet, seeded 3-peer LoroDoc histories over all
six container kinds, one envelope-stripped payload a sync round (some
docs idle a round, one round as decoded change lists).  Both servers
take the same rounds: the JAX one on a one-device mesh, the port's on
device="cpu" (the plain kernels).  Every comparison is exact
(tolerance: none): epochs, acks, stable epochs, compact's return values,
the reads (through test_torch_doc.plain) and the bytes of checkpoint(),
with ``_wall`` (the WAL stamp clock) patched in both.

Cases: the six families' lifecycle; a checkpoint carried across both
ways (and a tiered server's); a poison round a family; coalesced and
staged rounds equal to serial ingest; an armed degradation and
recover(); and a real device error (a port batch call raising
KernelLaunchError or torch.OutOfMemoryError), which reaches the caller
of ingest, ingest_coalesced and ingest_commit typed, the server not
degraded, where the JAX server degrades to its host mirror.
"""
import jax
import pytest
import torch

from loro_tpu.codec.binary import decode_changes as jdecode
from loro_tpu.core.ids import ContainerID as JContainerID
from loro_tpu.obs import metrics as jobs
from loro_tpu.parallel.mesh import make_mesh
from loro_tpu.parallel.server import ResidentServer as JServer
from loro_tpu.resilience import DeviceSupervisor as JSupervisor
from loro_tpu.resilience import faultinject as jfi
from loro_tpu.resilience import get_supervisor as jget_supervisor
from loro_tpu.resilience import set_supervisor as jset_supervisor
from loro_tpu_torch import tracegen as tg
from loro_tpu_torch.codec.binary import decode_changes as pdecode
from loro_tpu_torch.errors import DeviceFailure, KernelLaunchError
from loro_tpu_torch.obs import metrics as pobs
from loro_tpu_torch.parallel.server import ResidentServer as PServer
from loro_tpu_torch.resilience import DeviceSupervisor as PSupervisor
from loro_tpu_torch.resilience import faultinject as pfi
from loro_tpu_torch.resilience import get_supervisor as pget_supervisor
from loro_tpu_torch.resilience import set_supervisor as pset_supervisor
from test_torch_doc import plain

# family -> (container, small capacities (so rounds grow the batches), reads)
FAMILIES = {
    "text": (tg.TEXT_CID, {"capacity": 64}, ("texts",)),
    "list": (tg.LIST_CID, {"capacity": 64}, ("values",)),
    "map": (None, {"slot_capacity": 16}, ("value_maps", "root_value_maps")),
    "tree": (tg.TREE_CID, {"move_capacity": 64, "node_capacity": 16}, ("parent_maps", "children_maps")),
    "movable": (tg.MOVABLE_CID, {"capacity": 64, "elem_capacity": 16}, ("value_lists",)),
    "counter": (None, {"slot_capacity": 4}, ("value_maps",)),
}
N_DOCS, N_ROUNDS = 4, 5
WALL = 1_700_000_000.25  # the patched WAL stamp clock


@pytest.fixture(autouse=True)
def _quiet(monkeypatch):
    """A fresh supervisor a package that never wall-sleeps, the WAL stamp
    clock patched in both servers, every armed fault cleared after."""
    jset_supervisor(JSupervisor(sleep=lambda s: None))
    pset_supervisor(PSupervisor(sleep=lambda s: None))
    monkeypatch.setattr(JServer, "_wall", staticmethod(lambda: WALL))
    monkeypatch.setattr(PServer, "_wall", staticmethod(lambda: WALL))
    yield
    jfi.clear()
    pfi.clear()
    jset_supervisor(None)
    pset_supervisor(None)


@pytest.fixture(scope="module")
def fleet():
    return tg.loro_fleet(5, N_DOCS, n_rounds=N_ROUNDS)


def mesh():
    return make_mesh(jax.devices()[:1])


def jcid_of(cid):
    return None if cid is None else JContainerID.parse(str(cid))


def twins(family, n_docs=N_DOCS, **kw):
    """(JAX server on a one-device mesh, port server on the CPU) of one
    family at its small capacities."""
    caps = {**FAMILIES[family][1], **kw}
    return JServer(family, n_docs, mesh=mesh(), **caps), PServer(family, n_docs, device="cpu", **caps)


def rounds_of(fleet, idle=True):
    """The fleet's sync rounds as per-doc payloads.  With `idle`, doc i
    sits out round r when (r + i) % 3 == 0 (None) and takes its next
    epoch in its next round, so a doc's epochs arrive in order and the
    rounds outnumber the epochs."""
    if not idle:
        return [[d.epochs[r] for d in fleet] for r in range(N_ROUNDS)]
    nxt = [0] * len(fleet)
    out = []
    r = 0
    while any(n < N_ROUNDS for n in nxt):
        round_ = [None] * len(fleet)
        for i, d in enumerate(fleet):
            if (r + i) % 3 and nxt[i] < N_ROUNDS:
                round_[i] = d.epochs[nxt[i]]
                nxt[i] += 1
        out.append(round_)
        r += 1
    return out


def as_changes(round_, package):
    dec = jdecode if package == "jax" else pdecode
    return [None if p is None else dec(p) for p in round_]


def reads(srv, family):
    names = FAMILIES[family][2]
    return plain([getattr(srv, n)("m") if n == "root_value_maps" else getattr(srv, n)() for n in names])


def both_ingest(j, p, family, round_, changes=False):
    cid = FAMILIES[family][0]
    ju = as_changes(round_, "jax") if changes else round_
    pu = as_changes(round_, "torch") if changes else round_
    ej, ep = j.ingest(ju, jcid_of(cid)), p.ingest(pu, cid)
    assert ej == ep
    return ep


def assert_same(j, p, family):
    assert j.epoch == p.epoch
    assert reads(j, family) == reads(p, family)
    assert j.last_poison_docs == p.last_poison_docs


@pytest.mark.parametrize("family", list(FAMILIES))
def test_server_lifecycle_matches_jax(fleet, family):
    """Rounds (payloads, one as change lists, idle docs), replica acks,
    stable epochs and compaction, then checkpoints: the same epochs,
    floors, reclaimed rows, reads and checkpoint bytes."""
    j, p = twins(family)
    for di in range(N_DOCS):
        for rep in ("a", "b"):
            j.register_replica(di, rep)
            p.register_replica(di, rep)
    prev = 0
    rounds = rounds_of(fleet)
    for r, round_ in enumerate(rounds):
        e = both_ingest(j, p, family, round_, changes=(r == len(rounds) - 2))
        assert_same(j, p, family)
        for di in range(N_DOCS):
            for srv in (j, p):
                srv.ack(di, "a", e)
                srv.ack(di, "b", prev)
            assert j.stable_epoch(di) == p.stable_epoch(di) == prev
        assert j.compact() == p.compact()
        assert_same(j, p, family)
        if r in (1, len(rounds) - 1):
            assert j.checkpoint() == p.checkpoint()
        prev = e
    assert j.acks == p.acks


RESTORE_CASES = [(f, d) for f in FAMILIES for d in ("jax_to_port", "port_to_jax")] + [
    ("text-tiered", "jax_to_port"), ("text-tiered", "port_to_jax")]


def _tiered_fake_clock(srv):
    """The tier policy's clock (last-touch times, revive times) on a
    counter, the same sequence in both packages."""
    n = [0.0]

    def clock():
        n[0] += 1.0
        return n[0]

    srv.batch.mgr.clock = clock


@pytest.mark.parametrize("family,direction", RESTORE_CASES)
def test_checkpoint_carried_across(fleet, family, direction):
    """A checkpoint() blob of one package restores in the other: equal
    reads, equal checkpoint() bytes of the two restored servers, and
    both keep serving the same (one more round, then checkpoint bytes
    again)."""
    tiered = family.endswith("-tiered")
    fam = family.split("-")[0]
    kw = {"hot_slots": 3} if tiered else {}
    j, p = twins(fam, **kw)
    if tiered:
        _tiered_fake_clock(j)
        _tiered_fake_clock(p)
    rounds = rounds_of(fleet)
    for round_ in rounds[:3]:
        both_ingest(j, p, fam, round_)
    blob_j, blob_p = j.checkpoint(), p.checkpoint()
    assert blob_j == blob_p
    if direction == "jax_to_port":
        js, ps = JServer.restore(blob_j, mesh=mesh()), PServer.restore(blob_j, device="cpu")
    else:
        js, ps = JServer.restore(blob_p, mesh=mesh()), PServer.restore(blob_p, device="cpu")
    if tiered:
        _tiered_fake_clock(js)
        _tiered_fake_clock(ps)
    assert reads(js, fam) == reads(ps, fam) == reads(j, fam)
    assert js.checkpoint() == ps.checkpoint()
    both_ingest(js, ps, fam, rounds[3])
    assert_same(js, ps, fam)
    assert js.checkpoint() == ps.checkpoint()


def _poisoned(fleet, kind):
    """Round 1 of the fleet with doc 1's payload replaced: `garbage`
    bytes that no decoder takes, or `dangling`, its round-3 payload,
    whose ops name elements of epochs the server has not seen."""
    r = [d.epochs[1] for d in fleet]
    r[1] = b"\x00\x07 not a payload" if kind == "garbage" else fleet[1].epochs[3]
    return r


def _counter(obs, name, family):
    return obs.counter(name).get(family=family)


def _outcome(fn):
    """("epoch", e) or ("raised", the error's class name)."""
    try:
        return ("epoch", fn())
    except Exception as e:  # compared across the packages
        return ("raised", type(e).__name__)


@pytest.mark.parametrize("kind", ["garbage", "dangling"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_poison_round_isolated_like_jax(fleet, family, kind):
    """A round with one poison doc: the good docs' reads, the epochs,
    last_poison_docs, server.poison_docs_total and the checkpoint bytes
    equal the JAX server's.  Garbage bytes are poison in every family; a
    payload whose ops name elements the server never saw has the JAX
    server's outcome in each family (isolated, or raised typed before
    any write)."""
    cid = FAMILIES[family][0]
    j, p = twins(family)
    both_ingest(j, p, family, [d.epochs[0] for d in fleet])
    before = (_counter(jobs, "server.poison_docs_total", family), _counter(pobs, "server.poison_docs_total", family))
    bad = _poisoned(fleet, kind)
    got_j = _outcome(lambda: j.ingest(bad, jcid_of(cid)))
    got_p = _outcome(lambda: p.ingest(bad, cid))
    assert got_j == got_p
    assert_same(j, p, family)
    after = (_counter(jobs, "server.poison_docs_total", family), _counter(pobs, "server.poison_docs_total", family))
    assert after[0] - before[0] == after[1] - before[1] == len(p.last_poison_docs)
    if kind == "garbage":
        assert p.last_poison_docs == [1] and got_p[0] == "epoch"
    both_ingest(j, p, family, [d.epochs[1] if i != 1 else None for i, d in enumerate(fleet)])
    assert_same(j, p, family)
    assert j.checkpoint() == p.checkpoint()


@pytest.mark.parametrize("mode", ["coalesced", "staged", "poison_in_group"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_coalesced_and_staged_equal_serial(fleet, family, mode):
    """ingest_coalesced, and ingest_stage / ingest_commit in two groups,
    give the epochs, reads and checkpoint bytes of serial ingest, in the
    port and in the JAX server (a group holding a poison round isolates
    it and runs the tail serially, as JAX's does)."""
    cid = FAMILIES[family][0]
    rounds = rounds_of(fleet)
    if mode == "poison_in_group":
        # a poison doc in the last round but one, idle in the last round
        k = next(i for i, u in enumerate(rounds[-2]) if u is not None)
        rounds[-2] = list(rounds[-2])
        rounds[-2][k] = b"\x00\x07 not a payload"
        rounds[-1] = list(rounds[-1])
        rounds[-1][k] = None
    _, serial = twins(family)
    want = [serial.ingest(r, cid) for r in rounds]
    j, p = twins(family)
    if mode == "staged":
        got_p = p.ingest_commit(p.ingest_stage(rounds[:2], cid))
        got_p += p.ingest_commit(p.ingest_stage(rounds[2:], cid))
        got_j = j.ingest_commit(j.ingest_stage(rounds[:2], jcid_of(cid)))
        got_j += j.ingest_commit(j.ingest_stage(rounds[2:], jcid_of(cid)))
    else:
        got_p, got_j = p.ingest_coalesced(rounds, cid), j.ingest_coalesced(rounds, jcid_of(cid))
    assert got_p == got_j == want
    assert reads(p, family) == reads(serial, family) == reads(j, family)
    assert p.checkpoint() == serial.checkpoint() == j.checkpoint()


def _arm_launch_fault():
    jfi.inject("launch", exc=OSError("armed device loss"), times=1)
    pfi.inject("launch", exc=OSError("armed device loss"), times=1)


@pytest.mark.parametrize("entry", ["ingest", "coalesced"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_armed_degradation_and_recover_match_jax(fleet, family, entry):
    """An armed launch fault degrades both servers to their host mirror
    (after a checkpoint, so the mirror seeds from the anchor): the same
    epochs and reads while degraded, then recover() puts both back on
    their batches with equal reads and checkpoint bytes."""
    cid = FAMILIES[family][0]
    j, p = twins(family)
    rounds = rounds_of(fleet, idle=False)
    for round_ in rounds[:2]:
        both_ingest(j, p, family, round_)
    assert j.checkpoint() == p.checkpoint()
    _arm_launch_fault()
    if entry == "ingest":
        both_ingest(j, p, family, rounds[2])
        assert j.degraded and p.degraded
        both_ingest(j, p, family, rounds[3])
    else:
        assert j.ingest_coalesced(rounds[2:4], jcid_of(cid)) == p.ingest_coalesced(rounds[2:4], cid)
    assert j.degraded and p.degraded
    assert pget_supervisor().report()["degradations"] == jget_supervisor().report()["degradations"] == 1
    assert_same(j, p, family)
    both_ingest(j, p, family, rounds[4])
    assert_same(j, p, family)
    assert j.recover() and p.recover()
    assert not p.degraded
    assert_same(j, p, family)
    assert j.checkpoint() == p.checkpoint()


def _raiser(exc_type):
    def raise_(*a, **k):
        raise exc_type("device error for the test") if exc_type is not torch.OutOfMemoryError else \
            torch.OutOfMemoryError("CUDA out of memory (test)")

    return raise_


@pytest.mark.parametrize("exc", [KernelLaunchError, torch.OutOfMemoryError])
@pytest.mark.parametrize("entry", ["ingest", "ingest_coalesced", "ingest_commit", "auto_checkpoint"])
@pytest.mark.parametrize("family", ["text", "map"])
def test_real_device_error_reaches_the_caller(fleet, monkeypatch, family, entry, exc):
    """A real device error from the port's batch (a failed kernel launch,
    an out-of-memory) reaches the caller of every ingest entry point as a
    typed DeviceFailure (injected False), with server.errors_total
    counted, the server not degraded and no degradation noted; the JAX
    server, given an OSError at the same call (its device error), degrades
    to its host mirror instead."""
    cid = FAMILIES[family][0]
    rounds = rounds_of(fleet, idle=False)
    j, p = twins(family)
    if entry != "auto_checkpoint":
        both_ingest(j, p, family, rounds[0])
    call = {"ingest": "append_payloads", "ingest_coalesced": "commit_detached", "ingest_commit": "commit_detached",
            "auto_checkpoint": "export_state"}[entry]
    monkeypatch.setattr(p.batch, call, _raiser(exc))
    monkeypatch.setattr(j.batch, call, _raiser(OSError))
    errors0 = _counter(pobs, "server.errors_total", family)
    with pytest.raises(DeviceFailure) as info:
        if entry in ("ingest", "auto_checkpoint"):
            p.ingest(rounds[1], cid)
        elif entry == "ingest_coalesced":
            p.ingest_coalesced(rounds[1:3], cid)
        else:
            p.ingest_commit(p.ingest_stage(rounds[1:3], cid))
    assert info.value.injected is False
    assert isinstance(info.value.__cause__, exc)
    assert not p.degraded
    assert _counter(pobs, "server.errors_total", family) == errors0 + 1
    assert pget_supervisor().report()["degradations"] == 0
    # the JAX server: the same failure degrades it (the reference's
    # behaviour; the port's differs on purpose)
    if entry in ("ingest", "auto_checkpoint"):
        j.ingest(rounds[1], jcid_of(cid))
    elif entry == "ingest_coalesced":
        j.ingest_coalesced(rounds[1:3], jcid_of(cid))
    else:
        j.ingest_commit(j.ingest_stage(rounds[1:3], jcid_of(cid)))
    assert j.degraded


def test_device_default_and_unknown_family():
    """device= defaults to the card (DeviceUnavailable without one, the
    isolation test's case); an unknown family is a ValueError before any
    device is resolved, as in JAX."""
    with pytest.raises(ValueError):
        PServer("graph", 2, device="cpu")
    srv = PServer("counter", 2, device="cpu")
    assert srv.batch.device.type == "cpu" and srv.epoch == 0


@pytest.mark.parametrize("family", list(FAMILIES))
def test_empty_rounds_match_jax(family):
    """Empty input through each entry point (a round of no docs, a round
    of all-None docs, an empty group, a group of empty rounds): the same
    epochs, outcomes and checkpoint bytes as the JAX server's."""
    cid = FAMILIES[family][0]
    j, p = twins(family)
    for call in (lambda s, c: s.ingest([], c), lambda s, c: s.ingest([None] * N_DOCS, c),
                 lambda s, c: s.ingest_coalesced([], c), lambda s, c: s.ingest_coalesced([[], [None] * N_DOCS], c),
                 lambda s, c: s.ingest_commit(s.ingest_stage([], c))):
        assert _outcome(lambda: call(j, jcid_of(cid))) == _outcome(lambda: call(p, cid))
        assert j.epoch == p.epoch
    assert j.checkpoint() == p.checkpoint()
