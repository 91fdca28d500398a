"""The port's tracing on the import path (loro_tpu_torch.utils.tracing) on
the CPU: the off path, the span tree of a fleet text merge with its args,
the profiler mirror, the resident batches' stage spans, the rank.*
counters of the one-shot text merges, dump()'s clock, the device-span
queue (with stand-in CUDA events), and the benchmark's span log and
span readers.  The card's cases are in test_torch_tracing_cuda.py.
"""
import importlib.util
import json
import os
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import pytest
import torch

from loro_tpu_torch import tracegen
from loro_tpu_torch.codec.binary import decode_changes, encode_changes
from loro_tpu_torch.core import change as pch
from loro_tpu_torch.core.ids import ID
from loro_tpu_torch.core.version import Frontiers
from loro_tpu_torch.obs import metrics as obs
from loro_tpu_torch.ops.columnar import extract_seq_container
from loro_tpu_torch.ops.fugue_batch import pad_bucket
from loro_tpu_torch.parallel import fleet as pfleet
from loro_tpu_torch.utils import tracing

ROOT = Path(__file__).resolve().parent.parent
CID = tracegen.TEXT_CID
INNER = ["fleet.text.extract", "fleet.text.stack", "fleet.text.upload", "fleet.text.launch", "fleet.text.fetch",
         "fleet.text.decode"]
HOST_READERS = ["import.span.extract_ms", "import.span.upload_ms", "import.span.prep_ms", "import.span.wait_ms"]


@pytest.fixture(autouse=True)
def quiet_tracing():
    """Every test starts off (no observer, tracing disabled, no events)
    and leaves the module as it found it."""
    saved = (tracing._span_observers, tracing._enabled)
    tracing._span_observers, tracing._enabled = (), False
    tracing.clear()
    tracing._pending.clear()
    yield
    tracing._span_observers, tracing._enabled = saved
    tracing.clear()
    tracing._pending.clear()


@pytest.fixture(scope="module")
def payloads():
    return [d.payload() for d in tracegen.loro_fleet(41, 4, n_rounds=3, max_edits=6)]


def _recorder():
    seen = []
    tracing.add_span_observer(lambda name, s: seen.append((name, s)))
    return seen


def _args():
    """Each span's args by name, from the Chrome events (tracing enabled)."""
    return {e["name"]: e["args"] for e in tracing.events()}


def _dup_peer_payload() -> bytes:
    """A payload the native explode rejects and the Python decode
    resolves: its peer table names one peer id twice, and an insert names
    its parent through the other entry."""
    t = CID
    c1 = pch.Change(ID(1, 0), 0, Frontiers(), [pch.Op(0, t, pch.SeqInsert(None, pch.Side.Right, "abc"))])
    c2 = pch.Change(ID(2, 10), 3, Frontiers(), [pch.Op(10, t, pch.SeqInsert(ID(1, 2), pch.Side.Right, "de"))])
    c3 = pch.Change(ID(1, 3), 5, Frontiers(), [pch.Op(3, t, pch.SeqInsert(ID(1, 10), pch.Side.Left, "XY"))])
    p = bytearray(encode_changes([c1, c2, c3]))
    assert p[1:9] == (1).to_bytes(8, "little") and p[9:17] == (2).to_bytes(8, "little")
    p[9:17] = (1).to_bytes(8, "little")
    return bytes(p)


class _CountingLock:
    def __init__(self):
        self.acquired = 0
        self._lock = threading.Lock()

    def __enter__(self):
        self.acquired += 1
        return self._lock.__enter__()

    def __exit__(self, *exc):
        return self._lock.__exit__(*exc)


def test_off_path_opens_no_range_event_or_lock(monkeypatch, payloads):
    """Tracing off, no observer, torch's profiler recording: a payload
    merge opens no record_function of ours, constructs no CUDA event and
    takes the tracing lock never; span() and device_span() yield None."""
    ranges, events = [], []
    real_rf = torch.profiler.record_function

    def rf(name, *a, **kw):
        ranges.append(name)
        return real_rf(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", rf)
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **kw: events.append(1))
    lock = _CountingLock()
    monkeypatch.setattr(tracing, "_lock", lock)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert torch._C._autograd._profiler_enabled()
        texts = pfleet.Fleet(device="cpu").merge_text_payloads(payloads, CID).texts
        with tracing.span("x", a=1) as sp, tracing.device_span("y", torch.device("cuda"), b=2) as dsp:
            assert sp is None and dsp is None
        tracing.instant("z")
    assert len(texts) == len(payloads)
    assert not [n for n in ranges if n.startswith(tracing.PROFILER_PREFIX)]
    assert not [e.name for e in prof.events() if e.name.startswith(tracing.PROFILER_PREFIX)]
    assert events == [] and lock.acquired == 0 and not tracing._pending
    assert tracing.resolve_device_spans() == 0


def test_payload_merge_emits_the_span_tree_with_args(payloads):
    """The inner spans close in order inside fleet.text.payloads, with
    their args; the fallback payload shows in the extract span's args;
    with tracing enabled the Chrome events nest in the entry span."""
    seen = _recorder()
    tracing.enable()
    batch = payloads + [_dup_peer_payload()]
    texts = pfleet.Fleet(device="cpu").merge_text_payloads(batch, CID).texts
    assert texts[-1] == "abcXYde"
    assert [n for n, _ in seen] == INNER + ["fleet.text.payloads"]
    args = _args()
    assert args["fleet.text.payloads"] == {"docs": len(batch), "payload_bytes": sum(map(len, batch))}
    assert args["fleet.text.extract"] == {"docs": len(batch), "fallbacks": 1}
    assert args["fleet.text.stack"]["docs"] == len(batch) and args["fleet.text.stack"]["rows"] >= 64
    assert args["fleet.text.decode"] == {"docs": len(batch)}
    evs = {e["name"]: e for e in tracing.events()}
    top = evs["fleet.text.payloads"]
    assert top["args"]["payload_bytes"] == sum(map(len, batch))
    for name in INNER:
        e = evs[name]
        assert e["ph"] == "X" and top["ts"] <= e["ts"] and e["ts"] + e["dur"] <= top["ts"] + top["dur"] + 1e-3
    inner = sum(s for n, s in seen if n in INNER)
    assert inner <= seen[-1][1]


def test_change_and_extract_merges_share_the_inner_spans(payloads):
    chs = [decode_changes(p) for p in payloads]
    seen = _recorder()
    tracing.enable()
    fl = pfleet.Fleet(device="cpu")
    fl.merge_text_changes(chs, CID)
    assert [n for n, _ in seen] == INNER + ["fleet.text.changes"]
    assert _args()["fleet.text.extract"] == {"docs": len(chs), "fallbacks": 0}
    seen.clear()
    fl.merge_text_docs([extract_seq_container(c, CID) for c in chs])
    assert [n for n, _ in seen] == INNER[1:]


def test_spans_mirror_into_the_profiler(payloads):
    """Live spans inside a CPU torch.profiler profile appear as
    loro_tpu_torch.fleet.text.* events, each containing its children."""
    _recorder()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        pfleet.Fleet(device="cpu").merge_text_payloads(payloads, CID)
    ours = {e.name: e for e in prof.events() if e.name.startswith(tracing.PROFILER_PREFIX)}
    assert set(ours) == {tracing.PROFILER_PREFIX + n for n in INNER + ["fleet.text.payloads"]}
    top = ours["loro_tpu_torch.fleet.text.payloads"].time_range
    for name in INNER:
        r = ours[tracing.PROFILER_PREFIX + name].time_range
        assert top.start <= r.start and r.end <= top.end


@pytest.mark.parametrize("entry", ["payloads", "changes", "docs"])
def test_one_shot_text_merges_tick_rank(entry, payloads):
    """Each one-shot text merge ticks rank.ring_tokens by D x m, the
    padded docs times the Euler ring's 2 (n + 1) tokens, once a call."""
    chs = [decode_changes(p) for p in payloads]
    extracts = [extract_seq_container(c, CID) for c in chs]
    fl = pfleet.Fleet(device="cpu")
    call = {"payloads": lambda: fl.merge_text_payloads(payloads, CID),
            "changes": lambda: fl.merge_text_changes(chs, CID),
            "docs": lambda: fl.merge_text_docs(extracts)}[entry]
    d, m = len(extracts), 2 * (pad_bucket(max(e.n for e in extracts)) + 1)
    ring = obs.counter("rank.ring_tokens")
    for k in (1, 2):
        before = ring.get(algo="torch:ruling")
        call()
        assert ring.get(algo="torch:ruling") - before == d * m, k
    assert obs.counter("rank.rounds_total").get(algo="torch:ruling") > 0


def _fake_clock(monkeypatch):
    t = [0]

    def tick():
        t[0] += 10**9
        return t[0]

    monkeypatch.setattr(pfleet.time, "perf_counter_ns", tick)


def test_stage_clock_is_unchanged_and_each_stage_is_a_span(monkeypatch):
    """On the CPU every stage is a host stage: under a fake host clock
    stage_ms() reads the same with spans off and live, and each stage is
    a resident.<stage> span with the clock's own time."""
    clock = pfleet.StageClock(torch.device("cpu"))

    def run():
        clock.reset()
        with clock.host("explode"):
            pass
        with clock.device_stage("upload_scatter"):
            pass
        with clock.host("explode"):
            pass
        return clock.read()

    _fake_clock(monkeypatch)
    off = run()
    seen = _recorder()
    live = run()
    assert off == live == {"explode": 2000.0, "upload_scatter": 1000.0}
    assert seen == [("resident.explode", 1.0), ("resident.upload_scatter", 1.0), ("resident.explode", 1.0)]


def test_resident_batch_stages_are_spans(payloads):
    """A DeviceDocBatch append and read on the CPU: every stage that
    stage_ms() names is a resident.<stage> span, and the spans of a
    stage add up to its time."""
    b = pfleet.DeviceDocBatch(len(payloads), 1024, device="cpu")
    b.append_payloads(payloads, CID)
    off = set(b.stage_ms())
    seen = _recorder()
    b2 = pfleet.DeviceDocBatch(len(payloads), 1024, device="cpu")
    b2.append_payloads(payloads, CID)
    stages = b2.stage_ms()
    assert set(stages) == off
    spent = {}
    for n, s in seen:
        assert n.startswith("resident.")
        spent[n[len("resident."):]] = spent.get(n[len("resident."):], 0.0) + s
    assert set(spent) == set(stages)
    assert all(spent[k] * 1e3 == pytest.approx(stages[k]) for k in stages)
    seen.clear()
    assert b2.texts() == pfleet.Fleet(device="cpu").merge_text_payloads(payloads, CID).texts
    assert {n for n, _ in seen} >= {"resident." + k for k in b2.stage_ms()}


def test_dump_writes_its_clock_origin(tmp_path):
    """dump()'s otherData.clock lays a span's ts onto the epoch clock."""
    tracing.enable()
    wall0 = time.time_ns()
    with tracing.span("clocked"):
        pass
    wall1 = time.time_ns()
    data = json.loads(Path(tracing.dump(str(tmp_path / "t.json"))).read_text())
    clock = data["otherData"]["clock"]
    assert set(clock) == {"origin_perf_counter_ns", "perf_counter_ns", "time_ns"}
    ev = next(e for e in data["traceEvents"] if e["name"] == "clocked")
    epoch = clock["time_ns"] - (clock["perf_counter_ns"] - clock["origin_perf_counter_ns"]) + ev["ts"] * 1e3
    assert wall0 - 5e6 <= epoch <= wall1 + 5e6


class _FakeEvent:
    """A stand-in for torch.cuda.Event: done when the test says so; its
    record raises while `poisoned` (a device error has poisoned the
    context)."""

    ready = set()
    poisoned = False

    def __init__(self, enable_timing=False):
        self.recorded = False

    def record(self, stream=None):
        if _FakeEvent.poisoned:
            raise RuntimeError("CUDA error: device-side assert triggered")
        self.recorded = True

    def query(self):
        return id(self) in _FakeEvent.ready

    def elapsed_time(self, end):
        return 2.5


@pytest.fixture
def fake_cuda(monkeypatch):
    _FakeEvent.ready, _FakeEvent.poisoned = set(), False
    stream = types.SimpleNamespace(device=torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: stream)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    return _FakeEvent


def test_device_spans_resolve_without_waiting(fake_cuda):
    """A device span waits in the queue until its end event has completed
    (query, never a wait), then is delivered oldest first as a Chrome X
    event with cat device and to the observers in seconds; a live span
    closing delivers what has completed."""
    seen = _recorder()
    tracing.enable()
    dev = torch.device("cuda", 0)
    with tracing.device_span("fugue.rank", dev, D=2, m=10) as args:
        assert args == {"D": 2, "m": 10}
    with tracing.device_span("later", dev):
        pass
    first, second = tracing._pending[0], tracing._pending[1]
    assert tracing.resolve_device_spans() == 0 and seen == []
    fake_cuda.ready.add(id(second[4]))  # the later one alone: delivery stays in order
    assert tracing.resolve_device_spans() == 0
    fake_cuda.ready.add(id(first[4]))
    with tracing.span("host"):
        pass
    assert seen == [("host", seen[0][1]), ("fugue.rank", 2.5e-3), ("later", 2.5e-3)]
    assert not tracing._pending
    ev = next(e for e in tracing.events() if e["name"] == "fugue.rank")
    assert ev["ph"] == "X" and ev["cat"] == "device" and ev["dur"] == 2500.0 and ev["args"] == {"D": 2, "m": 10}


def test_device_span_queue_is_bounded(fake_cuda, monkeypatch):
    _recorder()
    monkeypatch.setattr(tracing, "DEVICE_PENDING_MAX", 2)
    dropped = obs.counter("trace.device_spans_dropped_total")
    before = dropped.get()
    for name in ("a", "b", "c"):
        with tracing.device_span(name, torch.device("cuda", 0)):
            pass
    assert [p[0] for p in tracing._pending] == ["b", "c"] and dropped.get() == before + 1
    assert dropped.get() == tracing.device_spans_dropped
    assert obs.snapshot()["trace.device_spans_dropped_total"]["values"] == [{"labels": {}, "value": dropped.get()}]


@pytest.mark.parametrize("when", ["open", "close"])
def test_a_device_span_that_cannot_record_lets_the_bodys_error_through(fake_cuda, when):
    """A device error that poisons the context makes an event's record
    raise: the span is dropped and counted, and the caller sees the body's
    own error (a supervised launch's DeviceFailure), not the record's."""
    from loro_tpu_torch.errors import DeviceFailure

    _recorder()
    before = tracing.device_spans_dropped
    fake_cuda.poisoned = when == "open"
    with pytest.raises(DeviceFailure):
        with tracing.device_span("fleet.text.merge_device", torch.device("cuda", 0)):
            fake_cuda.poisoned = True
            raise DeviceFailure("fleet.text", cause="device-side assert")
    assert tracing.device_spans_dropped == before + 1 and not tracing._pending
    fake_cuda.poisoned = True
    with tracing.device_span("fleet.text.merge_device", torch.device("cuda", 0)) as args:
        assert args == {}
    assert tracing.device_spans_dropped == before + 2 and not tracing._pending


def test_device_span_off_a_card_is_the_body_alone(fake_cuda):
    seen = _recorder()
    with tracing.device_span("fugue.rank", torch.device("cpu"), D=1) as args:
        assert args == {"D": 1}
    assert not tracing._pending and seen == []


# -- the benchmark's span log and readers ---------------------------------


@pytest.fixture
def spanlog():
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench import spanlog as sl

    tracing.add_span_observer(sl.observe)  # the import registered it once a process
    sl.clear()
    yield sl
    tracing.remove_span_observer(sl.observe)
    sl.clear()


def _reader(name: str):
    spec = importlib.util.spec_from_file_location("reader_" + name.replace(".", "_"),
                                                  ROOT / "portbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_spanlog_keeps_the_warm_call_out_of_the_window(spanlog, payloads):
    fl = pfleet.Fleet(device="cpu")
    fl.merge_text_payloads(payloads[:1], CID)  # the warm call
    for _ in range(2):
        fl.merge_text_payloads(payloads, CID)
    window = spanlog.window(types.SimpleNamespace(step_ms=[1.0, 1.0]))
    assert len(window) == 2
    assert [n for n, _ in window[0]] == [n for n, _ in window[1]] == INNER + ["fleet.text.payloads"]
    assert spanlog.window(types.SimpleNamespace(step_ms=[1.0] * 4)) is None  # fewer entry spans than steps
    assert spanlog.window(types.SimpleNamespace(step_ms=[])) is None


def test_span_readers_on_the_cpu(spanlog, payloads):
    """The four host readers read the window's spans a call; the device
    readers find no device span on the CPU and read nothing."""
    fl = pfleet.Fleet(device="cpu")
    fl.merge_text_payloads(payloads, CID)
    for _ in range(3):
        fl.merge_text_payloads(payloads, CID)
    probe = types.SimpleNamespace(step_ms=[1.0, 1.0, 1.0])
    window = spanlog.window(probe)

    def per_call(*names):
        return sum(s for c in window for n, s in c if n in names) * 1e3 / 3

    want = {"import.span.extract_ms": per_call("fleet.text.extract"),
            "import.span.upload_ms": per_call("fleet.text.upload"),
            "import.span.prep_ms": per_call("fleet.text.stack", "fleet.text.decode"),
            "import.span.wait_ms": per_call("fleet.text.launch", "fleet.text.fetch")}
    for name in HOST_READERS:
        r = _reader(name)
        assert r.WRAPS == [] and not getattr(r, "DEVICE", False)
        assert r.read(probe) == pytest.approx(want[name]) and want[name] > 0
    for name in ("import.span.merge_device_ms", "rank.span_roofline"):
        r = _reader(name)
        assert r.WRAPS == [] and r.DEVICE is True and r.read(probe) is None


def test_spanlog_counts_the_windows_ring_tokens(spanlog, payloads):
    """The window's ring tokens are rank.ring_tokens' rise over its calls:
    D x m a call, the warm call and the calls before the span log's start
    left out."""
    fl = pfleet.Fleet(device="cpu")
    fl.merge_text_payloads(payloads, CID)
    spanlog.clear()
    probe = types.SimpleNamespace(step_ms=[1.0, 1.0])
    fl.merge_text_payloads(payloads, CID)
    fl.merge_text_payloads(payloads, CID)
    extracts = [extract_seq_container(decode_changes(p), CID) for p in payloads]
    d, m = len(extracts), 2 * (pad_bucket(max(e.n for e in extracts)) + 1)
    assert spanlog.window_ring_tokens(probe) == 2 * d * m
    fl.merge_text_payloads(payloads[:1], CID)  # a smaller call ends the window
    assert spanlog.window_ring_tokens(types.SimpleNamespace(step_ms=[1.0])) < d * m
    assert spanlog.window_ring_tokens(types.SimpleNamespace(step_ms=[1.0] * 4)) is None


_REHEARSAL = """
import json, sys
from pathlib import Path
sys.path.insert(0, '.')
from portbench import harness
patches = 3000
inserts = round(patches * 182315 / 259778)
config = {"patches_per_doc": patches, "inserts_per_doc": inserts, "deletes_per_doc": patches - inserts,
          "sync_every": 1000, "fleet_docs": 8}
mix = {"pool": 2, "orders_per_base": 2, "docs_per_call": 4}
out = {}
for trace in (False, True):
    r = harness.run("text_import.full4", 2**31 + 23, 0.5, trace, device="cpu", cache_dir=Path(sys.argv[1]),
                    mix_overrides=mix, config_overrides=config, log=lambda m: None)
    out[str(trace)] = r
print(json.dumps(out))
"""


def test_span_readers_rehearse_through_the_harness(tmp_path):
    """The cell's traced run on the CPU at a tiny size reports the four
    host span metrics, beside the wrapped ones, and the device ones not
    at all; the untraced run loads no span reader, so its spans stay off."""
    res = subprocess.run([sys.executable, "-c", _REHEARSAL, str(tmp_path)], cwd=ROOT, capture_output=True,
                         text=True, timeout=600, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    traced, untraced = out["True"], out["False"]
    assert traced["correct"] and untraced["correct"]
    m = traced["metrics"]
    assert set(HOST_READERS) <= set(m) and all(m[n]["value"] > 0 for n in HOST_READERS)
    assert "import.span.merge_device_ms" not in m and "rank.span_roofline" not in m
    assert m["import.span.extract_ms"]["value"] >= m["import.extract_ms"]["value"]
    assert set(untraced["metrics"]) == {"setup_s"}
