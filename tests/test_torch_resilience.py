"""The port's resilience layer (loro_tpu_torch.resilience: DeviceSupervisor,
RetryPolicy, faultinject, probe; obs.flight; analysis.lockwitness) on the
CPU, against the JAX package's.

Every scenario runs through both packages with the same fake clock and
sleeper and the same armed faults: the outcomes (results, error types,
attempts, backoff sleeps, report() dicts, flight event kinds) must be
equal (tolerance: none).  The error classification is the port's own:
torch's CUDA errors (AcceleratorError, OutOfMemoryError) and the port's
KernelLaunchError degrade; a bare RuntimeError, ValueError, ConfigError,
KernelBuildError, DeviceUnavailable and the shared-memory check pass
through, and a kernel build or load failure reaches the caller of a
supervised merge with no degradation counted.
"""
import inspect
import json
import types

import numpy as np
import pytest
import torch

from loro_tpu import errors as jerrors
from loro_tpu.analysis import lockwitness as jlw
from loro_tpu.obs import flight as jflight
from loro_tpu.resilience import faultinject as jfi
from loro_tpu.resilience import probe as jprobe
from loro_tpu.resilience import supervisor as jsup
from loro_tpu_torch import _build, tracegen
from loro_tpu_torch import errors as perrors
from loro_tpu_torch.analysis import lockwitness as plw
from loro_tpu_torch.obs import flight as pflight
from loro_tpu_torch.obs import metrics as pobs
from loro_tpu_torch.ops import list_rank
from loro_tpu_torch.parallel import fleet as pfleet
from loro_tpu_torch.resilience import faultinject as pfi
from loro_tpu_torch.resilience import probe as pprobe
from loro_tpu_torch.resilience import supervisor as psup

JAX = types.SimpleNamespace(name="jax", sup=jsup, fi=jfi, errors=jerrors, flight=jflight, probe=jprobe, lw=jlw)
PORT = types.SimpleNamespace(name="port", sup=psup, fi=pfi, errors=perrors, flight=pflight, probe=pprobe, lw=plw)

# torch's own texts of the two sticky CUDA errors (c10's CUDA check; the
# device-side assert's first two lines as torch 2.11 raised it on an H100)
_TORCH_TAIL = ("\nCUDA kernel errors might be asynchronously reported at some other API call, so the stacktrace "
               "below might be incorrect.\nFor debugging consider passing CUDA_LAUNCH_BLOCKING=1\nCompile with "
               "`TORCH_USE_CUDA_DSA` to enable device-side assertions.\n")
_SEARCH = ("\nSearch for `{}' in https://docs.nvidia.com/cuda/cuda-runtime-api/group__CUDART__TYPES.html for more "
           "information.")
ILLEGAL_ADDRESS = ("CUDA error: an illegal memory access was encountered" + _SEARCH.format("cudaErrorIllegalAddress")
                   + _TORCH_TAIL)
DEVICE_ASSERT = "CUDA error: device-side assert triggered" + _SEARCH.format("cudaErrorAssert") + _TORCH_TAIL


@pytest.fixture(autouse=True)
def _port_fault_guard():
    """The port's own leak guard (tests/conftest.py watches the JAX
    package's fault table only): no fault may outlive a test, and the
    process supervisor is a fresh default afterwards."""
    yield
    leaked = pfi.active()
    pfi.clear()
    pfi.set_sleep(None)
    psup.set_supervisor(None)
    jsup.set_supervisor(None)
    assert not leaked, f"port faults leaked by this test: {leaked}"


class FakeClock:
    def __init__(self):
        self.t = 1000.0
        self.sleeps = []

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.sleeps.append(s)
        self.t += s


def _sup(pkg, **kw):
    clk = FakeClock()
    if "max_retries" in kw:
        kw["retry"] = pkg.sup.RetryPolicy(max_retries=kw.pop("max_retries"), backoff_base=kw.pop("backoff_base", 0.25))
    return pkg.sup.DeviceSupervisor(clock=clk, sleep=clk.sleep, **kw), clk


def _outcome(fn):
    """(result, error type name, DeviceFailure attempts) of one call."""
    try:
        out = fn()
        return ("ok", out.tolist() if isinstance(out, np.ndarray) else out, None)
    except BaseException as e:  # noqa: BLE001 — the outcome is the comparison
        return ("raised", type(e).__name__, getattr(e, "attempts", None))


def _flaky(n_fail, msg="UNAVAILABLE: backend setup error"):
    calls = []

    def thunk():
        calls.append(1)
        if len(calls) <= n_fail:
            raise RuntimeError(msg)
        return "ok"
    return thunk


def _scenario_transient_then_ok(pkg):
    sup, clk = _sup(pkg, max_retries=3)
    return [_outcome(lambda: sup.launch(_flaky(2), label="t"))], sup, clk


def _scenario_budget_exhausted(pkg):
    sup, clk = _sup(pkg, max_retries=2, backoff_base=0.1)
    return [_outcome(lambda: sup.launch(_flaky(99, "UNAVAILABLE: still down"), label="flaky"))], sup, clk


def _scenario_injected_transient(pkg):
    sup, clk = _sup(pkg, max_retries=3, backoff_base=0.01)
    pkg.fi.inject("launch", times=2)
    try:
        return [_outcome(lambda: sup.launch(lambda: "ok")), pkg.fi.fired("launch")], sup, clk
    finally:
        pkg.fi.clear()


def _scenario_injected_fatal(pkg):
    sup, clk = _sup(pkg)
    pkg.fi.inject("launch", exc=RuntimeError("INTERNAL: injected"), times=1)
    try:
        return [_outcome(lambda: sup.launch(lambda: "never")), _outcome(lambda: sup.launch(lambda: "after"))], sup, clk
    finally:
        pkg.fi.clear()


def _scenario_fetch_fault(pkg):
    sup, clk = _sup(pkg)
    pkg.fi.inject("fetch", exc=RuntimeError("INTERNAL: injected at fetch"), times=1)
    try:
        return [_outcome(lambda: sup.fetch([1, 2, 3])), _outcome(lambda: sup.fetch([4, 5]))], sup, clk
    finally:
        pkg.fi.clear()


def _scenario_fetch_delay(pkg):
    sup, clk = _sup(pkg)
    pkg.fi.set_sleep(clk.sleep)
    pkg.fi.inject("fetch", action="delay", delay_s=3.5, times=1)
    try:
        return [_outcome(lambda: sup.fetch([7]))], sup, clk
    finally:
        pkg.fi.clear()
        pkg.fi.set_sleep(None)


def _scenario_deadline(pkg):
    sup, clk = _sup(pkg, deadline_s=10.0)
    first = _outcome(lambda: sup.launch(lambda: 1))
    clk.t += 11.0
    return [first, _outcome(lambda: sup.launch(lambda: 2, label="late"))], sup, clk


def _scenario_no_retry_past_deadline(pkg):
    sup, clk = _sup(pkg, deadline_s=1.0, max_retries=5, backoff_base=2.0)
    return [_outcome(lambda: sup.launch(_flaky(99, "UNAVAILABLE")))], sup, clk


def _scenario_drain_budget(pkg):
    sup, clk = _sup(pkg, drain_every=8)
    drains, depth = [], []
    for i in range(100):
        sup.launch(lambda i=i: i, label="stress", drain=lambda: drains.append(1))
        depth.append(sup.in_flight)
    return [len(drains), max(depth), sup.max_in_flight], sup, clk


def _scenario_fetch_resets_depth(pkg):
    sup, clk = _sup(pkg, drain_every=100)
    for _ in range(5):
        sup.launch(lambda: 1)
    before = sup.in_flight
    return [before, _outcome(lambda: sup.fetch([1, 2, 3])), sup.in_flight], sup, clk


def _scenario_degradation(pkg):
    sup, clk = _sup(pkg)
    sup.note_degradation("fleet.text")
    return [], sup, clk


SCENARIOS = [_scenario_transient_then_ok, _scenario_budget_exhausted, _scenario_injected_transient,
             _scenario_injected_fatal, _scenario_fetch_fault, _scenario_fetch_delay, _scenario_deadline,
             _scenario_no_retry_past_deadline, _scenario_drain_budget, _scenario_fetch_resets_depth,
             _scenario_degradation]


@pytest.mark.faultinject
@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__[len("_scenario_"):])
def test_supervisor_matches_jax(scenario):
    """One scenario through both packages' supervisors and fault tables:
    equal outcomes, backoff sleeps, report() dicts and flight events
    (their kinds and labels, in order)."""
    got = {}
    for pkg in (JAX, PORT):
        pkg.flight.clear()
        outcomes, sup, clk = scenario(pkg)
        events = [(e["kind"], e.get("label"), e.get("site"), e.get("where")) for e in pkg.flight.events()]
        got[pkg.name] = (outcomes, clk.sleeps, sup.report(), events)
    assert got["port"] == got["jax"]


def test_backoff_policy_matches_jax():
    for kw in ({}, {"max_retries": 10, "backoff_base": 1.0, "backoff_max": 4.0}):
        j, p = jsup.RetryPolicy(**kw), psup.RetryPolicy(**kw)
        assert [p.backoff(i) for i in range(8)] == [j.backoff(i) for i in range(8)]


@pytest.mark.parametrize("exc", [
    torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
    perrors.KernelLaunchError("list_rank kernel launch failed: cudaError 700 (an illegal memory access was encountered)"),
    perrors.KernelLaunchError("tree_replay kernel launch failed: cudaError 98 (invalid device function)"),
    torch.AcceleratorError(ILLEGAL_ADDRESS),
    torch.AcceleratorError(DEVICE_ASSERT),
    ConnectionError("connection to the device lost"),
], ids=["oom", "launch_illegal_address", "launch_invalid_function", "accelerator_illegal_address",
        "accelerator_device_assert", "connection"])
def test_device_errors_become_device_failure_without_retry(exc):
    """torch's CUDA errors, KernelLaunchError and ConnectionError become a
    DeviceFailure after one attempt: no backoff, one failure counted."""
    sup, clk = _sup(PORT, max_retries=3)

    def thunk():
        raise exc

    with pytest.raises(perrors.DeviceFailure) as ei:
        sup.launch(thunk, label="fleet.text")
    assert ei.value.attempts == 1 and ei.value.__cause__ is exc and ei.value.injected is False
    assert clk.sleeps == [] and sup.report()["failures"] == 1 and sup.report()["retries"] == 0
    with pytest.raises(perrors.DeviceFailure) as ei:
        sup.fetch(_Exploding(exc))
    assert ei.value.injected is False and sup.report()["failures"] == 2


@pytest.mark.faultinject
def test_armed_faults_mark_the_failure_injected():
    """A DeviceFailure is marked injected when an armed fault ended the
    launch or the fetch (a fatal one, or a transient one that outlasts
    the retries), and not when a real error did, even after an armed
    transient fault was retried."""
    sup, _clk = _sup(PORT, max_retries=2)
    real = torch.AcceleratorError(ILLEGAL_ADDRESS)

    def failing():
        raise real

    cases = [("launch", {"exc": RuntimeError("INTERNAL: injected device death"), "times": 1}, lambda: 1, True),
             ("launch", {}, lambda: 1, True),
             ("launch", {"times": 1}, failing, False),
             ("fetch", {"exc": RuntimeError("INTERNAL: injected at the fetch"), "times": 1}, None, True)]
    for site, kw, thunk, injected in cases:
        pfi.inject(site, **kw)
        try:
            with pytest.raises(perrors.DeviceFailure) as ei:
                if thunk is None:
                    sup.fetch(np.zeros(2))
                else:
                    sup.launch(thunk, label="fleet.text")
        finally:
            pfi.clear()
        assert ei.value.injected is injected, (site, kw)


class _Exploding:
    """A value whose host fetch raises `exc` (a fault surfacing at the
    sync point)."""

    def __init__(self, exc):
        self.exc = exc

    def __array__(self, *a, **kw):
        raise self.exc


def test_sticky_cuda_errors_are_never_transient():
    """torch's texts of an illegal address and a device-side assert never
    mark an error transient, whatever type carries them and whatever
    transient marker rides along; a transient text on a CUDA error type
    is not transient either (no CUDA error heals by waiting)."""
    for msg in (ILLEGAL_ADDRESS, DEVICE_ASSERT):
        for exc in (torch.AcceleratorError(msg), RuntimeError(msg), RuntimeError("UNAVAILABLE: " + msg),
                    pfi.InjectedFault("UNAVAILABLE: injected, " + msg)):
            assert not psup.default_transient(exc), repr(exc)
    assert not psup.default_transient(torch.AcceleratorError("UNAVAILABLE: CUDA error: out of memory"))
    assert not psup.default_transient(perrors.KernelLaunchError("temporarily unavailable"))
    for exc in (RuntimeError("UNAVAILABLE: x"), OSError("DEADLINE_EXCEEDED"), RuntimeError("segfault")):
        assert psup.default_transient(exc) == jsup.default_transient(exc)


@pytest.mark.parametrize("make", [
    lambda: RuntimeError("DeviceDocBatch capacity exceeded: pass auto_grow=True"),
    lambda: ValueError("payload is not self-contained"),
    lambda: perrors.CodecDecodeError("bad bytes"),
    lambda: perrors.ConfigError("rank plan shared memory per CTA", 300_000, "at most cuda:0's 232448 bytes"),
    lambda: perrors.KernelBuildError("native build failed: list_rank (nvcc rc=1)"),
    lambda: perrors.DeviceUnavailable("device='cuda' requested but torch.cuda.is_available() is False"),
    lambda: OSError("a host file that could not be read"),
    lambda: KeyError("missing"),
], ids=["runtime", "value", "codec", "config", "build", "unavailable", "oserror", "key"])
def test_host_errors_pass_through(make):
    """Everything that is not a device error reaches the caller as it is,
    from a launch and from a fetch: no failure, no retry counted."""
    sup, clk = _sup(PORT, max_retries=3)
    exc = make()

    def thunk():
        raise exc

    with pytest.raises(type(exc)) as ei:
        sup.launch(thunk)
    assert ei.value is exc
    with pytest.raises(type(exc)):
        sup.guard(thunk)
    assert sup.report()["failures"] == 0 and sup.report()["retries"] == 0 and clk.sleeps == []


def _text_changes():
    docs = tracegen.loro_fleet(5, 2, n_rounds=2, max_edits=4)
    return [d.changes() for d in docs]


def _degraded():
    return pobs.counter("fleet.degraded_merges_total").get(family="text")


@pytest.mark.parametrize("failure", ["load", "compiler", "smem", "cluster", "unavailable", "bare_runtime"])
def test_merge_passes_build_and_config_errors_through(monkeypatch, tmp_path, failure):
    """A supervised Fleet(device="cpu") text merge whose device call meets
    what the CUDA route meets at its first launch: a kernel library that
    does not load (ctypes.CDLL's OSError), a compiler that cannot start
    (subprocess.Popen's FileNotFoundError), the shared-memory and cluster
    checks, an unavailable device, or a bare RuntimeError.  Each reaches
    the caller as it is, typed (the first two as KernelBuildError), with
    no failure and no degradation counted."""
    if failure == "load":
        lib = tmp_path / "liblist_rank.so"
        lib.write_bytes(b"not a shared library")
        monkeypatch.setattr(_build, "_loaded", {})
        monkeypatch.setattr(_build, "_target", lambda name: lib)

        def boom(*a, **k):
            raise OSError(f"{lib}: invalid ELF header")

        monkeypatch.setattr(_build.ctypes, "CDLL", boom)
        call, want = (lambda: _build.library("list_rank")), perrors.KernelBuildError
    elif failure == "compiler":
        monkeypatch.setattr(_build, "_loaded", {})
        monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
        monkeypatch.setattr(_build, "_gxx", lambda: "/usr/bin/g++")

        def no_compiler(*a, **k):
            raise FileNotFoundError(2, "No such file or directory", "/usr/bin/g++")

        monkeypatch.setattr(_build.subprocess, "Popen", no_compiler)
        call, want = (lambda: _build.library("seq_codec")), perrors.KernelBuildError
    elif failure in ("smem", "cluster"):
        plan = list_rank.plan_rank(70_000, "ruling") if failure == "cluster" else list_rank.plan_rank(20_000, "ruling")
        assert plan.cluster > 1 or failure == "smem"
        monkeypatch.setattr(list_rank, "smem_budget", lambda dev: 1024 if failure == "smem" else 1 << 30)
        monkeypatch.setattr(list_rank, "max_active_clusters", lambda p, dev: 0)
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "a card")
        call, want = (lambda: list_rank._check_plan_fits(plan, torch.device("cuda:0"))), perrors.ConfigError
    elif failure == "unavailable":
        call, want = (lambda: torch.empty(1, device=pfleet.resolve_device("cuda"))), perrors.DeviceUnavailable
        if torch.cuda.is_available():
            pytest.skip("needs a machine without a card")
    else:
        def call():
            raise RuntimeError("a bare runtime error of host code")
        want = RuntimeError

    real = pfleet.materialize_content_batch

    def device_call(cols, device):
        call()
        return real(cols, device=device)

    monkeypatch.setattr(pfleet, "materialize_content_batch", device_call)
    changes = _text_changes()
    psup.set_supervisor(psup.DeviceSupervisor(sleep=lambda s: None))
    d0 = _degraded()
    with pytest.raises(want) as ei:
        pfleet.Fleet(device="cpu").merge_text_changes(changes, tracegen.TEXT_CID)
    assert type(ei.value) is want
    rep = psup.get_supervisor().report()
    assert rep["failures"] == 0 and rep["degradations"] == 0 and _degraded() == d0


def test_build_errors_are_typed(monkeypatch, tmp_path):
    """Every build and load failure of _build is a KernelBuildError (a
    LoroError and a RuntimeError): no compiler on the PATH, a compiler
    that fails, one that cannot start, a library that does not load."""
    assert issubclass(perrors.KernelBuildError, perrors.LoroError)
    assert issubclass(perrors.KernelBuildError, RuntimeError)
    assert not issubclass(perrors.KernelLaunchError, perrors.LoroError)
    assert issubclass(perrors.KernelLaunchError, RuntimeError)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(perrors.KernelBuildError, match="nvcc not found"):
        _build._nvcc()
    with pytest.raises(perrors.KernelBuildError, match="g\\+\\+ not found"):
        _build._gxx()
    monkeypatch.undo()
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_gxx", lambda: "false")  # a compiler that fails
    with pytest.raises(perrors.KernelBuildError, match="native build failed: seq_codec"):
        _build.build_all(["seq_codec"])
    monkeypatch.setattr(_build, "_gxx", lambda: str(tmp_path / "no-such-compiler"))
    with pytest.raises(perrors.KernelBuildError, match="cannot start"):
        _build.build_all(["seq_codec"])


def test_probe_body_names_no_jax():
    """The probe's subprocess bodies are strings, out of the isolation
    test's import walk: neither names jax or the JAX package."""
    for src in (pprobe._PROBE_BODY, inspect.getsource(pprobe.tunnel_alive)):
        assert "jax" not in src
        assert "loro_tpu." not in src.replace("loro_tpu_torch.", "")
    assert "torch.cuda.get_device_name()" in pprobe._PROBE_BODY and 'platform="gpu"' in pprobe._PROBE_BODY


def test_fault_sites_are_the_ports():
    assert sorted(pfi.sites()) == ["backend_init", "ckpt_corrupt", "conn_stall", "decode", "evict_flush",
                                   "export_launch", "fetch", "health_tick", "launch", "net_accept", "net_frame",
                                   "poison_doc", "read_batch", "repl_apply", "repl_promote", "repl_ship",
                                   "revive_replay", "session_stall", "sync_pull", "sync_push", "wal_torn_tail",
                                   "wal_write"]
    assert sorted(pfi.sites()) == sorted(JAX.fi.sites())  # every JAX-package site has its plane in the port
    assert all(m.startswith("loro_tpu_torch.") for info in pfi.sites().values() for m in info["modules"])
    with pytest.raises(perrors.ConfigError):
        pfi.inject("net_frmae")  # a misspelled site never fires: refused typed


@pytest.mark.faultinject
def test_fault_table_matches_jax():
    """inject / check / mangle / active / fired and the LORO_FAULT spec
    parser: equal behavior in both packages."""
    payload = bytes(range(32))
    got = {}
    for pkg in (JAX, PORT):
        out = []
        pkg.fi.inject("decode", action="truncate", keep_bytes=10, times=1)
        try:
            out += [pkg.fi.mangle("decode", payload), pkg.fi.mangle("decode", payload)]
        finally:
            pkg.fi.clear()
        pkg.fi.inject("decode", action="bitflip", flip_at=3, times=1)
        try:
            out.append(pkg.fi.mangle("decode", payload))
        finally:
            pkg.fi.clear()
        pkg.fi._install_env_entry("launch:raise:times=2:msg=UNAVAILABLE hi")
        pkg.fi._install_env_entry("decode:truncate=16")
        pkg.fi._install_env_entry("fetch:delay:s=0.5:times=1")
        try:
            out.append(pkg.fi.active())
            try:
                pkg.fi.check("launch")
            except pkg.fi.InjectedFault as e:
                out.append(str(e))
            out.append(pkg.fi.fired("launch"))
        finally:
            pkg.fi.clear()
        for bad in ("launch:explode", "launch:raise:when=now", "nosuchsite:raise"):
            try:
                pkg.fi._install_env_entry(bad)
                out.append("accepted")
            except pkg.errors.ConfigError as e:
                out.append(("ConfigError", e.knob))
        out.append(pkg.fi.active())
        got[pkg.name] = out
    assert got["port"] == got["jax"]


def test_flight_recorder_matches_jax():
    """The ring: capacity wrap, tail, snapshot and the disabled fast path,
    equal in both packages."""
    got = {}
    for pkg in (JAX, PORT):
        r = pkg.flight.FlightRecorder(capacity=4, clock=iter(range(100)).__next__, wall=lambda: 7.0)
        for i in range(6):
            r.record("ev", n=i)
        r.disable()
        r.record("dropped")
        r.enable()
        snap = r.snapshot()
        got[pkg.name] = (r.events(), r.tail(2), r.recorded_total, {k: v for k, v in snap.items() if k != "pid"})
    assert got["port"] == got["jax"]


def test_lock_witness_matches_jax():
    """Strict witness: the declared order (fleet.dev before
    supervisor.state) is allowed, the reverse raises LockOrderViolation
    at the acquire, and the witnessed graph then holds a cycle; equal
    edges and findings in both packages."""
    got = {}
    for pkg in (JAX, PORT):
        w = pkg.lw.witness()
        w.reset()
        w.enable(strict=True)
        try:
            dev, state = pkg.lw.named_rlock("fleet.dev"), pkg.lw.named_lock("supervisor.state")
            with dev, state:
                pass
            with pytest.raises(pkg.errors.LockOrderViolation):
                with state, dev:
                    pass
            edges, declared = w.edges(), w.check_declared()
            with pytest.raises(pkg.errors.LockOrderViolation, match="cycle"):
                w.assert_acyclic()
        finally:
            w.disable()
            w.reset()
        got[pkg.name] = (edges, declared)
    assert got["port"] == got["jax"]
    # (the flight recorder's records under both locks add edges into obs.flight)
    assert {e: n for e, n in got["port"][0].items() if "obs.flight" not in e} == {
        ("fleet.dev", "supervisor.state"): 1, ("supervisor.state", "fleet.dev"): 1}
    assert len(got["port"][1]) == 1


def test_export_select_is_witnessed_in_order():
    """The read plane's supervised selection under a batch's fleet.dev
    lock takes supervisor.state inside it: declared order, no violation."""
    from test_torch_export import _fed_pair, _histories

    from loro_tpu_torch.core.version import VersionVector

    _jx, px, _fed, bounds = _fed_pair(3, _histories())
    reqs = [(di, VersionVector(b)) for di in range(3) for b in bounds[di][::2]]
    w = plw.witness()
    w.reset()
    w.enable(strict=True)
    try:
        got = pfleet.DeviceDocBatch(3, 16, device="cpu").export_select(px, reqs)
        edges = w.edges()
    finally:
        w.disable()
        w.reset()
    assert [a.tolist() for a in got] == [a.tolist() for a in px.select(reqs)]
    assert ("fleet.dev", "supervisor.state") in edges and not plw.witness().violations()


class TestProbe:
    def test_ladder_matches_jax(self, tmp_path):
        """The staggered ladder with an injected spawner and fake clock:
        the third probe reports done, the same status in both packages;
        a ladder that never sees done times out the same way."""
        got = {}
        for pkg in (JAX, PORT):
            clk = FakeClock()
            spawned = []

            def spawn(path):
                spawned.append(path)
                if len(spawned) == 3:
                    with open(path, "w") as f:
                        json.dump({"step": "done", "platform": "gpu", "kind": "a card"}, f)

            st = pkg.probe.wait_for_backend(1000.0, status_path=str(tmp_path / f"{pkg.name}.json"), stagger_s=120.0,
                                            poll_s=2.0, clock=clk, sleep=clk.sleep, spawn=spawn)
            clk2 = FakeClock()
            late = pkg.probe.wait_for_backend(300.0, status_path=str(tmp_path / f"{pkg.name}2.json"), stagger_s=120.0,
                                              poll_s=5.0, clock=clk2, sleep=clk2.sleep, spawn=lambda p: None)
            with pytest.raises(pkg.errors.BackendUnavailable):
                pkg.probe.wait_for_backend(10.0, status_path=str(tmp_path / f"{pkg.name}3.json"), stagger_s=120.0,
                                           poll_s=5.0, clock=clk2, sleep=clk2.sleep, spawn=lambda p: None,
                                           raise_on_timeout=True)
            got[pkg.name] = (st, len(spawned), late, clk.sleeps)
        assert got["port"] == got["jax"]
        assert got["port"][0]["ok"] and got["port"][0]["probes"] == 3 and not got["port"][2]["ok"]

    def test_real_probe_subprocess_fake_ok(self, tmp_path, monkeypatch):
        """One real detached probe (LORO_PROBE_FAKE=ok skips backend init):
        spawned -> done; the parent never signals it and waits for it."""
        monkeypatch.setenv("LORO_PROBE_FAKE", "ok")
        procs = []
        st = pprobe.wait_for_backend(30.0, status_path=str(tmp_path / "probe.json"), stagger_s=30.0, poll_s=0.05,
                                     spawn=lambda p: procs.append(pprobe.start_probe(p)))
        assert st["ok"] and st.get("platform") == "fake"
        assert [p.wait(timeout=30) for p in procs] == [0]

    def test_backend_init_fault_in_the_probe(self, tmp_path, monkeypatch):
        """LORO_FAULT=backend_init:raise reaches the probe subprocess
        through the port's faultinject: the probe writes step=error and
        the ladder times out cooperatively (typed, no hang)."""
        monkeypatch.delenv("LORO_PROBE_FAKE", raising=False)
        monkeypatch.setenv("LORO_FAULT", "backend_init:raise:msg=INTERNAL injected")
        procs = []
        path = str(tmp_path / "probe.json")
        pprobe.wait_for_backend(0.0, status_path=path, spawn=lambda p: procs.append(pprobe.start_probe(p)))
        assert procs[0].wait(timeout=120) != 0
        st = pprobe.read_status(path)
        assert st["step"] == "error" and "INTERNAL injected" in st["error"]

    def test_tunnel_alive_without_a_card(self):
        """tunnel_alive runs a CUDA op in a subprocess: False here, where
        torch has no CUDA (a card run holds it True)."""
        if torch.cuda.is_available():
            pytest.skip("needs a machine without a card")
        assert pprobe.tunnel_alive(timeout_s=120.0) is False
