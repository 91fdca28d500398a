"""The port's supervised one-shot Fleet merges and their host degradation
on the CPU (Fleet(device="cpu"), the plain kernels), against the JAX
package's Fleet and against host_merge_changes.

Inputs: tracegen.loro_fleet, seeded 3-peer LoroDoc histories over every
container kind (the bytes are the JAX package's too); the JAX package
decodes its own change lists from the same payloads.  For each of the
nine branches that degrade (text changes and payloads, rich text,
movable changes and payloads, tree changes and payloads, tree children,
counter): the clean result equals the JAX Fleet's and the host engine's;
an armed fatal launch or fetch fault degrades to the host engine, whose
result equals the JAX package's degraded result, counted once in
fleet.degraded_merges_total{family} and the supervisor's report; a
transient fault retries on the device with no degradation; a real device
error (a CUDA error, a kernel's failed launch, an out-of-memory) reaches
the caller as a typed DeviceFailure, with no host result.  The two
merges of extracts (merge_text_docs, merge_map_docs) and export_select
let the DeviceFailure reach the caller.  Every comparison is exact
(tolerance: none); across packages through test_torch_doc.plain.
"""
import jax
import pytest
import torch

from loro_tpu.codec.binary import decode_changes as jdecode
from loro_tpu.core.ids import ContainerID as JContainerID
from loro_tpu.ops import columnar as jcol
from loro_tpu.parallel.fleet import Fleet as JFleet
from loro_tpu.parallel.mesh import make_mesh
from loro_tpu.resilience import faultinject as jfi
from loro_tpu_torch import tracegen as tg
from loro_tpu_torch.core.version import VersionVector
from loro_tpu_torch.errors import DeviceFailure, KernelLaunchError
from loro_tpu_torch.obs import flight as pflight
from loro_tpu_torch.obs import metrics as pobs
from loro_tpu_torch.ops import columnar as pcol
from loro_tpu_torch.parallel import fleet as pfleet
from loro_tpu_torch.resilience import faultinject as pfi
from loro_tpu_torch.resilience import hostpath as php
from loro_tpu_torch.resilience import supervisor as psup
from test_torch_doc import plain
from test_torch_resilience import DEVICE_ASSERT, ILLEGAL_ADDRESS

pytestmark = pytest.mark.faultinject

# branch -> (family, cid, the port call, the JAX call); D and J hold each
# package's inputs: changes, payloads
BRANCHES = {
    "text_changes": ("text", tg.TEXT_CID, lambda f, D, c: f.merge_text_changes(D.changes, c).texts),
    "text_payloads": ("text", tg.TEXT_CID, lambda f, D, c: f.merge_text_payloads(D.payloads, c).texts),
    "richtext": ("richtext", tg.RICH_CID, lambda f, D, c: f.merge_richtext_changes(D.changes, c)),
    "movable_changes": ("movable", tg.MOVABLE_CID, lambda f, D, c: f.merge_movable_changes(D.changes, c)),
    "movable_payloads": ("movable", tg.MOVABLE_CID, lambda f, D, c: f.merge_movable_payloads(D.payloads, c)),
    "tree_changes": ("tree", tg.TREE_CID, lambda f, D, c: f.merge_tree_changes(D.changes, c)),
    "tree_payloads": ("tree", tg.TREE_CID, lambda f, D, c: f.merge_tree_payloads(D.payloads, c)),
    "tree_children": ("tree_children", tg.TREE_CID, lambda f, D, c: f.merge_tree_children(D.changes, c)),
    "counter": ("counter", None, lambda f, D, c: f.merge_counter_changes(D.changes)),
}


class _Inputs:
    def __init__(self, changes, payloads):
        self.changes, self.payloads = changes, payloads


@pytest.fixture(scope="module")
def docs():
    fleet = tg.loro_fleet(11, 4, n_rounds=3, max_edits=6)
    payloads = [d.payload() for d in fleet]
    return _Inputs([d.changes() for d in fleet], payloads), _Inputs([jdecode(p) for p in payloads], payloads)


@pytest.fixture(scope="module")
def jax_results(docs):
    """Each branch's JAX Fleet result, clean and with a fatal launch fault
    armed (its host degradation), on a one-device mesh."""
    _, J = docs
    jfl = JFleet(mesh=make_mesh(jax.devices()[:1]))
    out = {}
    for name, (_family, cid, call) in BRANCHES.items():
        jcid = None if cid is None else JContainerID.parse(str(cid))
        clean = call(jfl, J, jcid)
        jfi.inject("launch", exc=RuntimeError("INTERNAL: injected device death"), times=1)
        try:
            degraded = call(jfl, J, jcid)
        finally:
            jfi.clear()
        out[name] = (clean, degraded)
    return out


@pytest.fixture(autouse=True)
def sup():
    """A fresh process supervisor whose backoffs never wall-sleep; the
    port's faults cleared and checked for leaks afterwards."""
    s = psup.DeviceSupervisor(sleep=lambda _s: None)
    psup.set_supervisor(s)
    yield s
    leaked = pfi.active()
    pfi.clear()
    pfi.set_sleep(None)
    psup.set_supervisor(None)
    assert not leaked, f"port faults leaked by this test: {leaked}"


def _degraded(family):
    return pobs.counter("fleet.degraded_merges_total").get(family=family)


def _run(name, D):
    family, cid, call = BRANCHES[name]
    return call(pfleet.Fleet(device="cpu"), D, cid)


def _host(name, D):
    family, cid, _ = BRANCHES[name]
    return php.host_merge_changes(family, D.changes, cid)


@pytest.mark.parametrize("name", list(BRANCHES))
def test_clean_merge_equals_jax_and_the_host_engine(docs, jax_results, sup, name):
    D, _ = docs
    family = BRANCHES[name][0]
    d0 = _degraded(family)
    got = _run(name, D)
    assert got == _host(name, D)
    assert plain(got) == plain(jax_results[name][0])
    rep = sup.report()
    assert rep["launches"] >= 2 and rep["failures"] == rep["degradations"] == rep["retries"] == 0
    assert _degraded(family) == d0


@pytest.mark.parametrize("name", list(BRANCHES))
def test_fatal_launch_degrades_to_the_host_engine(docs, jax_results, sup, name):
    """A fatal launch fault: the host engine's result, equal to the JAX
    package's degraded result; one failure and one degradation counted,
    recorded in the flight ring."""
    D, _ = docs
    family = BRANCHES[name][0]
    d0 = _degraded(family)
    pflight.clear()
    pfi.inject("launch", exc=RuntimeError("INTERNAL: injected device death"), times=1)
    try:
        got = _run(name, D)
    finally:
        pfi.clear()
    assert got == _host(name, D)
    assert plain(got) == plain(jax_results[name][1])
    assert _degraded(family) == d0 + 1
    rep = sup.report()
    assert rep["failures"] == 1 and rep["degradations"] == 1 and rep["retries"] == 0
    kinds = [(e["kind"], e.get("where")) for e in pflight.events() if e["kind"].startswith("sup.")]
    assert kinds == [("sup.failure", None), ("sup.degrade", f"fleet.{family}")]


@pytest.mark.parametrize("name", list(BRANCHES))
def test_transient_launch_retries_on_the_device(docs, sup, name):
    D, _ = docs
    family = BRANCHES[name][0]
    sleeps = []
    sup.sleep = sleeps.append
    d0 = _degraded(family)
    pfi.inject("launch", times=2)  # the default: a transient UNAVAILABLE
    try:
        got = _run(name, D)
    finally:
        pfi.clear()
    assert got == _host(name, D)
    assert len(sleeps) == 2 and sup.report()["retries"] == 2
    assert sup.report()["degradations"] == 0 and _degraded(family) == d0


@pytest.mark.parametrize("name", list(BRANCHES))
def test_fetch_fault_degrades(docs, sup, name):
    """A device error surfacing at the sync point (the fetch) takes the
    same host path as one at the launch."""
    D, _ = docs
    family = BRANCHES[name][0]
    d0 = _degraded(family)
    pfi.inject("fetch", exc=RuntimeError("INTERNAL: injected at the fetch"), times=1)
    try:
        got = _run(name, D)
    finally:
        pfi.clear()
    assert got == _host(name, D)
    assert _degraded(family) == d0 + 1 and sup.report()["degradations"] == 1


@pytest.mark.parametrize("name,patched", [("text_changes", "materialize_content_batch"),
                                          ("tree_changes", "tree_merge_batch")])
@pytest.mark.parametrize("msg", [ILLEGAL_ADDRESS, DEVICE_ASSERT], ids=["illegal_address", "device_assert"])
def test_cuda_error_in_the_device_call_reaches_the_caller(docs, sup, monkeypatch, name, patched, msg):
    """The device call raising torch's CUDA error type with a sticky
    error's text: one attempt (no retry), then a typed DeviceFailure that
    carries it; no host result, no degradation."""
    D, _ = docs
    err = torch.AcceleratorError(msg)

    def sticky(*a, **k):
        raise err

    monkeypatch.setattr(pfleet, patched, sticky)
    with pytest.raises(DeviceFailure) as ei:
        _run(name, D)
    assert ei.value.__cause__ is err and ei.value.injected is False
    rep = sup.report()
    assert rep["failures"] == 1 and rep["retries"] == 0 and rep["degradations"] == 0


# the real errors a card raises in a merge: torch's CUDA error type with a
# sticky error's text, a hand-written kernel's failed launch, an
# out-of-memory
REAL_ERRORS = {
    "illegal_address": lambda: torch.AcceleratorError(ILLEGAL_ADDRESS),
    "device_assert": lambda: torch.AcceleratorError(DEVICE_ASSERT),
    "kernel_launch": lambda: KernelLaunchError("list_rank kernel launch failed: cudaError 700 "
                                               "(an illegal memory access was encountered)"),
    "out_of_memory": lambda: torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
}


@pytest.mark.parametrize("name", list(BRANCHES))
@pytest.mark.parametrize("where,error", [("launch", e) for e in REAL_ERRORS] + [("fetch", "device_assert")])
def test_real_device_error_reaches_the_caller(docs, sup, monkeypatch, name, where, error):
    """A real device error, raised in the merge's second supervised
    launch (its device call) or at its first fetch (the sync point where
    a kernel's fault surfaces): the supervisor's typed DeviceFailure
    reaches the caller with the error as its cause; one failure, no
    retry, no degradation, no sup.degrade in the flight ring."""
    D, _ = docs
    family = BRANCHES[name][0]
    err = REAL_ERRORS[error]()
    seen = []

    def raise_err(*_a):
        raise err

    if where == "launch":
        real_launch = pfleet._sup_launch

        def launch(label, thunk):
            seen.append(label)
            return real_launch(label, raise_err if len(seen) == 2 else thunk)

        monkeypatch.setattr(pfleet, "_sup_launch", launch)
    else:
        monkeypatch.setattr(psup, "_to_host", raise_err)
    d0 = _degraded(family)
    pflight.clear()
    with pytest.raises(DeviceFailure) as ei:
        _run(name, D)
    assert ei.value.__cause__ is err and ei.value.injected is False and ei.value.attempts == 1
    assert ei.value.label == f"fleet.{family}"
    rep = sup.report()
    assert rep["failures"] == 1 and rep["retries"] == 0 and rep["degradations"] == 0
    assert _degraded(family) == d0
    # the launch records its failure in the flight ring, the fetch (as in
    # the JAX package) only counts it
    kinds = [e["kind"] for e in pflight.events() if e["kind"].startswith("sup.")]
    assert kinds == (["sup.failure"] if where == "launch" else [])


@pytest.mark.parametrize("site", ["launch", "fetch"])
@pytest.mark.parametrize("entry", ["merge_text_docs", "merge_map_docs"])
def test_extract_merges_raise_device_failure(docs, sup, site, entry):
    """merge_text_docs and merge_map_docs take extracts: nothing to
    degrade to, so the DeviceFailure reaches the caller, typed, and no
    degradation is counted; clean, they equal the JAX Fleet's."""
    D, J = docs
    fl = pfleet.Fleet(device="cpu")
    jfl = JFleet(mesh=make_mesh(jax.devices()[:1]))
    if entry == "merge_text_docs":
        jcid = JContainerID.parse(str(tg.TEXT_CID))
        call = lambda: fl.merge_text_docs([pcol.extract_seq_container(c, tg.TEXT_CID) for c in D.changes]).texts
        want = jfl.merge_text_docs([jcol.extract_seq_container(c, jcid) for c in J.changes]).texts
        family = "text"
    else:
        call = lambda: fl.merge_map_docs([pcol.extract_map_ops(c) for c in D.changes])
        want = jfl.merge_map_docs([jcol.extract_map_ops(c) for c in J.changes])
        family = "map"
    assert plain(call()) == plain(want)
    d0 = _degraded(family)
    pfi.inject(site, exc=RuntimeError("INTERNAL: injected"), times=1)
    try:
        with pytest.raises(DeviceFailure) as ei:
            call()
    finally:
        pfi.clear()
    assert ei.value.label == f"fleet.{family}"
    assert _degraded(family) == d0 and sup.report()["degradations"] == 0


@pytest.mark.parametrize("name", ["text_payloads", "movable_payloads", "tree_payloads"])
def test_decode_fault_takes_the_python_decode(docs, sup, name):
    """A decode fault truncates one payload before the native explode: a
    typed CodecDecodeError inside the entry point, then its Python-decode
    fallback (counted), the same result, no degradation."""
    D, _ = docs
    fn = {"text_payloads": "seq", "movable_payloads": "movable", "tree_payloads": "tree"}[name]
    f0 = pfleet.FLEET_FALLBACKS["payload_extract"]
    calls0 = pobs.counter("codec.native_decode_calls_total").get(fn=fn)
    fault = pfi.inject("decode", action="truncate", keep_bytes=9, times=1)
    try:
        got = _run(name, D)
    finally:
        pfi.clear()
    assert fault.fired == 1
    assert got == _host(name, D)
    assert pfleet.FLEET_FALLBACKS["payload_extract"] == f0 + 1
    assert pobs.counter("codec.native_decode_calls_total").get(fn=fn) == calls0 + len(D.payloads)
    assert sup.report()["degradations"] == 0


def _batches():
    return {"seq": pfleet.DeviceDocBatch(3, 16, device="cpu"), "map": pfleet.DeviceMapBatch(3, 4, device="cpu"),
            "counter": pfleet.DeviceCounterBatch(3, 4, device="cpu"),
            "tree": pfleet.DeviceTreeBatch(3, 16, 4, device="cpu"),
            "movable": pfleet.DeviceMovableBatch(3, 16, 4, device="cpu")}


@pytest.mark.parametrize("kind", ["seq", "map", "counter", "tree", "movable"])
def test_export_select_is_supervised(kind):
    """export_select(sup=...) of each resident batch: one launch under
    fleet.export.{kind} through the given supervisor, equal to the index's
    own selection; a transient export_launch fault retries; a device
    error, or a transient one that outlasts the retries, raises
    DeviceFailure; a host error passes through."""
    from test_torch_export import _fed_pair, _histories

    _jx, px, _fed, bounds = _fed_pair(3, _histories())
    reqs = [(di, VersionVector(b)) for di in range(3) for b in bounds[di][::2]]
    want = [a.tolist() for a in px.select(reqs)]
    batch = _batches()[kind]
    sleeps = []
    own = psup.DeviceSupervisor(sleep=sleeps.append)
    assert [a.tolist() for a in batch.export_select(px, reqs, sup=own)] == want
    assert own.report()["launches"] == 1 and psup.get_supervisor().report()["launches"] == 0
    pfi.inject("export_launch", times=1)
    try:
        assert [a.tolist() for a in batch.export_select(px, reqs, sup=own)] == want
    finally:
        pfi.clear()
    assert len(sleeps) == 1 and own.report()["retries"] == 1
    # the fault fires inside the thunk, so it is classified by its type
    # and text, as a device error would be: a CUDA error type fails at
    # once, a transient one that never clears exhausts the retries
    for exc, attempts in ((KernelLaunchError("list_rank kernel launch failed: cudaError 700"), 1), (None, 4)):
        pfi.inject("export_launch", exc=exc)
        try:
            with pytest.raises(DeviceFailure) as ei:
                batch.export_select(px, reqs, sup=own)
        finally:
            pfi.clear()
        assert ei.value.label == f"fleet.export.{kind}" and ei.value.attempts == attempts
    assert own.report()["failures"] == 2
    # a host-side error of the selection passes through
    pfi.inject("export_launch", exc=RuntimeError("INTERNAL: a host error"), times=1)
    try:
        with pytest.raises(RuntimeError, match="a host error"):
            batch.export_select(px, reqs, sup=own)
    finally:
        pfi.clear()
    assert own.report()["failures"] == 2
    # without sup=, the process supervisor takes the launch
    assert [a.tolist() for a in batch.export_select(px, reqs)] == want
    assert psup.get_supervisor().report()["launches"] == 1
