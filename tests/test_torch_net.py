"""The port's network edge (loro_tpu_torch.net: the wire codec, NetServer,
NetClient and the net config knobs) on the CPU against the JAX package's,
on the same seeded client edits.

Every scenario runs once through each package (`both`): the JAX
SyncServer on its default device behind the JAX NetServer, the port's on
device="cpu" behind the port's, client LoroDocs of the same package made
by the same seeded script.  A scenario returns a record of what its
clients saw over the sockets; the two records must be equal exactly
(tolerance: none): every frame's bytes, the pulled bytes, the ack
epochs and durable watermarks, the ERROR codes and messages, the
connection counts of `report()`, the STATUS keys.  Left out: trace ids
(a process counter: each package mints its own) and timings.  Every
socket pull is also held against the in-process `Session.pull` of a
session set to the client's frontier (the wire ships the bytes
verbatim).

Port-only cases: a real device failure in a push's ingest or in a pull's
selection reaches the NetClient as NetError with no bytes, the push's
connection staying open and the pull's failing with E_INTERNAL; a strict
lock witness over clients on threads; and no CPU fallback without a
card.  Every socket, ticket and poll wait has a finite timeout.
"""
import importlib
import json
import random
import socket
import threading
import time
import types

import pytest
import torch

from test_torch_doc import plain
from test_torch_sync import CAPS, FAMILIES, PRESENCE_T0, cid_of, edit, seed_doc


def _pkg(root: str):
    m = lambda n: importlib.import_module(f"{root}.{n}")  # noqa: E731
    doc = m("doc")
    net = m("net")
    return types.SimpleNamespace(
        name=root, LoroDoc=doc.LoroDoc, ExportMode=doc.ExportMode, SyncServer=m("sync").SyncServer,
        NetServer=net.NetServer, NetClient=net.NetClient, wire=m("net.wire"), netcfg=m("net.config"),
        ReadOnly=m("replication.readonly").ReadOnlySyncServer, errors=m("errors"), fi=m("resilience.faultinject"),
        res=m("resilience"), VV=m("core.version").VersionVector, obs=m("obs.metrics"), health=m("obs.health"),
        lockwitness=m("analysis.lockwitness"), lockorder=m("analysis.lockorder"),
        EphemeralStore=m("awareness").EphemeralStore, presence=m("sync.presence"),
        dev={} if root == "loro_tpu" else {"device": "cpu"},
    )


JX, PT = _pkg("loro_tpu"), _pkg("loro_tpu_torch")
HOST = "127.0.0.1"
TIMEOUT = 30.0  # every client socket's timeout


@pytest.fixture(autouse=True)
def _quiet():
    """A sleepless supervisor a package; every armed fault cleared after."""
    for pk in (JX, PT):
        pk.res.set_supervisor(pk.res.DeviceSupervisor(sleep=lambda s: None))
    yield
    for pk in (JX, PT):
        pk.fi.clear()
        pk.res.set_supervisor(None)


def both(scenario, *args):
    """Run `scenario(pkg, *args)` through the JAX package and the port;
    their records must be equal.  Returns the port's record."""
    rj = scenario(JX, *args)
    rp = scenario(PT, *args)
    assert rj == rp
    return rp


def wait_for(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return pred()


def text_server(pk, n_docs=1, **kw):
    """A text SyncServer with the seeded base pushed into every doc."""
    base = seed_doc(pk, 61, 0)
    caps = dict(CAPS["text"])
    caps.update(kw)
    srv = pk.SyncServer("text", n_docs, cid=cid_of("text", base), **pk.dev, **caps)
    boot = srv.connect(sid="boot")
    for di in range(n_docs):
        boot.push(di, base.export_updates({})).epoch(60)
    return srv, base


def client(pk, net, client_id="", family="text"):
    cli = pk.NetClient(HOST, net.port, family, client_id=client_id, timeout=TIMEOUT)
    cli.connect()
    return cli


def counts(rep):
    """A NetServer report without its address (an ephemeral port)."""
    return {k: v for k, v in rep.items() if k != "addr"}


def in_process_pull(srv, cli, di):
    """The in-process Session.pull at the client's frontier."""
    s = srv.connect()
    try:
        with srv._lock:
            s._vv[di] = cli.frontiers.get(di, type(s.frontier(di))()).copy()
        return s.pull(di)
    finally:
        s.close()


def raw_frames(pk, port, bodies):
    """Send framed bodies on a raw socket and read frames until the
    server closes it; returns the decoded frames."""
    s = socket.create_connection((HOST, port), timeout=TIMEOUT)
    out = []
    try:
        for b in bodies:
            s.sendall(pk.wire.frame(b))
        buf = b""
        while True:
            try:
                chunk = s.recv(65536)
            except OSError:
                break
            if not chunk:
                break
            buf += chunk
        while buf:
            n, crc = pk.wire.parse_header(buf[:pk.wire.HEADER_LEN], 1 << 20)
            body = pk.wire.check_body(buf[pk.wire.HEADER_LEN:pk.wire.HEADER_LEN + n], crc)
            out.append(pk.wire.decode(body))
            buf = buf[pk.wire.HEADER_LEN + n:]
    finally:
        s.close()
    return out


# -- the wire codec -------------------------------------------------------------


def sample_bodies(pk):
    """One encoded body a message type (and the None / edge encodings)."""
    w = pk.wire
    vv = pk.VV({7: 3, 9: 12})
    return {
        "hello": w.encode_hello("text", "cli-1", {0: vv, 2: vv}),
        "hello_empty": w.encode_hello("map", ""),
        "hello_future": w.encode_hello("text", "x", version=w.PROTO_VERSION + 1),
        "hello_ok": w.encode_hello_ok("text", 8, 41, "net-c-3", 2),
        "push": w.encode_push(5, 2, b"\x00\x01payload bytes"),
        "push_ack": w.encode_push_ack(5, 41, 39, "p77-3"),
        "push_ack_volatile": w.encode_push_ack(1, 3, None, ""),
        "pull": w.encode_pull(6, 1, min_epoch=12),
        "pull_any": w.encode_pull(1, 0),
        "delta": w.encode_delta(6, 1, b"delta-bytes", vv, False),
        "delta_first": w.encode_delta(300, 70000, b"", pk.VV(), True),
        "poll": w.encode_poll(7, 1500),
        "event": w.encode_event(7, {0: 41, 3: 40}, [b"pres", b""]),
        "presence": w.encode_presence(b"aware-blob"),
        "error": w.encode_error(0, w.E_NOT_LEADER, "read-only", "10.0.0.2:7777"),
        "error_plain": w.encode_error(9, w.E_INTERNAL, "boom é"),
        "bye": w.encode_bye(),
        "status": w.encode_status(9),
        "status_ok": w.encode_status_ok(9, b'{"verdict": "ok", "alerts": []}'),
    }


def decoded(pk, body):
    t, fields = pk.wire.decode(body)
    return t, plain({k: (dict(v.items()) if isinstance(v, pk.VV) else
                         {di: dict(x.items()) for di, x in v.items()} if k == "frontiers" else v)
                     for k, v in fields.items()})


@pytest.mark.parametrize("kind", list(sample_bodies(PT)))
def test_wire_bytes_equal_for_every_message(kind):
    """Each message encodes to the JAX package's bytes, frames to its
    envelope, and decodes to its fields."""
    bj, bp = sample_bodies(JX)[kind], sample_bodies(PT)[kind]
    assert bj == bp
    assert JX.wire.frame(bj) == PT.wire.frame(bp)
    assert decoded(JX, bj) == decoded(PT, bp)
    framed = PT.wire.frame(bp)
    n, crc = PT.wire.parse_header(framed[:PT.wire.HEADER_LEN], len(bp))
    assert n == len(bp) and PT.wire.check_body(framed[PT.wire.HEADER_LEN:], crc) == bp


def _typed(pk, fn):
    try:
        fn()
    except (pk.errors.CodecDecodeError, pk.errors.NetProtocolError) as e:
        return type(e).__name__, str(e)
    return None


def test_wire_damage_raises_alike():
    """Truncation at every offset, bit flips past the crc gate, oversized
    frames, unknown types, a wrong HELLO magic and a varint overrun raise
    the same typed error with the same message in both packages."""
    def record(pk):
        out = []
        for kind, body in sample_bodies(pk).items():
            for cut in range(len(body)):
                if kind == "bye" and cut == 1:
                    continue
                out.append(_typed(pk, lambda: pk.wire.decode(body[:cut])))
        assert None not in out
        rng = random.Random(0xF1)
        body = sample_bodies(pk)["delta"]
        _, crc = pk.wire.parse_header(pk.wire.frame(body)[:pk.wire.HEADER_LEN], 1 << 20)
        for _ in range(64):
            flipped = bytearray(body)
            flipped[rng.randrange(len(body))] ^= 1 << rng.randrange(8)
            out.append(_typed(pk, lambda: pk.wire.check_body(bytes(flipped), crc)))
        out.append(_typed(pk, lambda: pk.wire.frame(b"x" * 100, max_frame=64)))
        out.append(_typed(pk, lambda: pk.wire.parse_header(pk.wire.frame(b"x" * 100)[:8], 64)))
        out.append(_typed(pk, lambda: pk.wire.parse_header(b"\x00" * 8, 64)))
        out.append(_typed(pk, lambda: pk.wire.parse_header(b"\x00" * 3, 64)))
        out.append(_typed(pk, lambda: pk.wire.decode(bytes([0x7F]) + b"junk")))
        out.append(_typed(pk, lambda: pk.wire.decode(b"")))
        hello = bytearray(sample_bodies(pk)["hello"])
        hello[1:5] = b"HTTP"
        out.append(_typed(pk, lambda: pk.wire.decode(bytes(hello))))
        out.append(_typed(pk, lambda: pk.wire.decode(bytes([pk.wire.PUSH]) + b"\xff" * 12)))
        out.append(_typed(pk, lambda: pk.wire.decode(bytes([pk.wire.HELLO]) + b"LTNT\x01\x02\xff\xfe")))
        assert None not in out
        return out

    both(record)


def _error_classes(pk):
    e = pk.errors
    return [
        e.PushRejected("poison"), e.StaleFrontier("below the root"), e.NotLeader("read-only", leader="10.0.0.9:1"),
        e.NotLeader("read-only"), e.ReplicaLag("behind"), e.SessionClosed("gone"),
        e.CodecDecodeError("crc"), e.NetProtocolError("magic"), e.NetError("queue overflow"),
        e.SyncError("sync"), e.DeviceFailure("server.ingest.text", cause="CUDA error"), ValueError("v"),
        TimeoutError("slow"), RuntimeError("r"),
    ]


@pytest.mark.parametrize("k", range(len(_error_classes(PT))))
def test_error_codes_map_alike(k):
    """error_code_for gives each error the JAX package's (code, leader);
    the ERROR frame it makes re-raises the same type and message through
    raise_error."""
    def record(pk):
        exc = _error_classes(pk)[k]
        code, leader = pk.wire.error_code_for(exc)
        body = pk.wire.encode_error(3, code, str(exc), leader)
        _, fields = pk.wire.decode(body)
        try:
            pk.wire.raise_error(fields)
        except Exception as e:  # noqa: BLE001 — every mapped type is recorded
            got = (type(e).__name__, str(e), getattr(e, "leader", None))
        return code, leader, body, got

    both(record)


@pytest.mark.parametrize("knob,bad", [
    ("LORO_NET_PORT", "not-a-port"), ("LORO_NET_PORT", "70000"), ("LORO_NET_MAX_FRAME", "12"),
    ("LORO_NET_MAX_FRAME", "huge"), ("LORO_NET_BACKLOG", "0"), ("LORO_NET_MAX_CONNS", "0"),
    ("LORO_NET_MAX_CONNS", "many"), ("LORO_NET_IDLE_S", "-1"), ("LORO_NET_IDLE_S", "soon"),
])
def test_config_knobs_raise_typed_alike(monkeypatch, knob, bad):
    """A malformed knob raises ConfigError naming it, with the JAX
    package's message; explicit arguments beat the environment."""
    fn = {"LORO_NET_PORT": "resolve_port", "LORO_NET_MAX_FRAME": "resolve_max_frame",
          "LORO_NET_BACKLOG": "resolve_backlog", "LORO_NET_MAX_CONNS": "resolve_max_conns",
          "LORO_NET_IDLE_S": "resolve_idle_s"}[knob]
    monkeypatch.setenv(knob, bad)

    def record(pk):
        with pytest.raises(pk.errors.ConfigError) as info:
            getattr(pk.netcfg, fn)()
        return str(info.value)

    assert knob in both(record)
    explicit = {"resolve_port": 0, "resolve_max_frame": 4096, "resolve_backlog": 9, "resolve_max_conns": 7,
                "resolve_idle_s": 2.5}[fn]
    assert getattr(PT.netcfg, fn)(explicit) == explicit
    with pytest.raises(PT.errors.ConfigError):
        getattr(PT.netcfg, fn)(-5)


def test_config_good_env_resolves_alike(monkeypatch):
    for k, v in (("LORO_NET_MAX_FRAME", "65536"), ("LORO_NET_IDLE_S", "2.5"), ("LORO_NET_MAX_CONNS", "7"),
                 ("LORO_NET_BACKLOG", "9"), ("LORO_NET_PORT", "0")):
        monkeypatch.setenv(k, v)
    both(lambda pk: [pk.netcfg.resolve_max_frame(), pk.netcfg.resolve_idle_s(), pk.netcfg.resolve_max_conns(),
                     pk.netcfg.resolve_backlog(), pk.netcfg.resolve_port()])


def _server_config_error(pk):
    srv, _ = text_server(pk)
    try:
        with pytest.raises(pk.errors.ConfigError) as info:
            pk.NetServer(srv)
        return str(info.value)
    finally:
        srv.close()


def test_server_surfaces_config_error_at_construction(monkeypatch):
    monkeypatch.setenv("LORO_NET_MAX_CONNS", "0")
    both(_server_config_error)


# -- a NetServer and its clients --------------------------------------------------


def _round_trip(pk):
    """A writer and two readers over the wire: acks, pulls (each equal
    to the in-process pull at the client's frontier), a long poll woken
    by a push, presence, a poison push's typed ERROR, a resume."""
    srv, base = text_server(pk, 2)
    net = pk.NetServer(srv)
    clis = []
    try:
        w = client(pk, net, "writer")
        r1, r2 = client(pk, net, "r1"), client(pk, net, "r2")
        clis += [w, r1, r2]
        hello = (dict(w.hello_info, sid=w.hello_info["sid"].split("-", 1)[0]), r1.hello_info["n_docs"])
        docs, marks = [], []
        for di in range(2):
            docs.append(pk.LoroDoc(peer=70 + di))
            docs[di].import_(base.export_snapshot())
            marks.append(docs[di].oplog_vv())
        acks, pulls = [], []
        for r in range(3):
            for di, d in enumerate(docs):
                d.get_text("t").insert(0, f"w{r}{di} ")
                d.commit()
                ack = w.push(di, d.export_updates(marks[di]))
                marks[di] = d.oplog_vv()
                acks.append((ack["rid"], ack["epoch"], ack["durable_epoch"], ack["trace_id"][:1]))
            for cli in (r1, r2):
                for di in range(2):
                    want = in_process_pull(srv, cli, di)
                    got = cli.pull(di)
                    assert got == want
                    pulls.append((got, plain(dict(cli.frontiers[di].items())), cli.last_pull))
        ev = {}
        th = threading.Thread(target=lambda: ev.update(r1.poll(timeout_s=10)))
        th.start()
        assert wait_for(lambda: any(c.pending_poll for c in list(net._conns.values())))
        d = docs[0]
        d.get_text("t").insert(0, "woken ")
        d.commit()
        acks.append(w.push(0, d.export_updates(marks[0]))["epoch"])
        marks[0] = d.oplog_vv()
        th.join(30)
        assert not th.is_alive()
        empty = r2.poll(timeout_s=0)
        st = pk.EphemeralStore(clock=lambda: PRESENCE_T0)
        st.set("cursor", [3, 7])
        r1.broadcast_presence(st.encode())
        pres = r2.poll(timeout_s=5)
        blob = bytearray(d.export_updates({}))
        blob[len(blob) // 2] ^= 0x5A
        with pytest.raises(pk.errors.PushRejected) as info:
            w.push(0, bytes(blob))
        poison = str(info.value)
        docs[1].get_text("t").insert(0, "after ")
        docs[1].commit()
        after = w.push(1, docs[1].export_updates(marks[1]))["epoch"]  # the connection lives
        # resume: a fresh connection carrying r2's frontiers pulls only the rest
        fvv = {di: vv.copy() for di, vv in r2.frontiers.items()}
        r2.close()
        again = pk.NetClient(HOST, net.port, "text", client_id="r2", timeout=TIMEOUT)
        for di, vv in fvv.items():
            again.set_frontier(di, vv)
        clis.append(again)
        resumed = again.connect()["resumed"]
        tail = [again.pull(di) for di in range(2)]
        assert wait_for(lambda: net.report()["connections"] == 3)
        rep = counts(net.report())
        return (hello, acks, pulls, ev, empty, pres, poison, after, resumed, tail, rep, srv.texts(),
                srv.report()["pushes"])
    finally:
        for c in clis:
            c.kill()
        net.close()
        srv.close()


def test_net_round_trip_matches_jax(monkeypatch):
    for pk in (JX, PT):
        monkeypatch.setattr(pk.presence, "time", types.SimpleNamespace(time=lambda: PRESENCE_T0))
    rec = both(_round_trip)
    assert rec[3]["docs"] == {0: rec[1][-1]} and len(rec[5]["presence"]) == 1
    assert rec[8] == 2 and rec[10]["resumes"] == 1 and rec[10]["accepted"] == 4


def _family_wire(pk, family):
    """Two docs, three epochs of seeded edits pushed in process; two
    socket clients pull every doc every epoch: each blob equal to the
    in-process pull at the client's frontier, then a fresh client's
    first sync."""
    rng = random.Random(0x9E7 + sum(map(ord, family)))
    base = [seed_doc(pk, 300 + i, i) for i in range(2)]
    srv = pk.SyncServer(family, 2, cid=cid_of(family, base[0]), **pk.dev, **CAPS[family])
    net = pk.NetServer(srv)
    clis, got = [], []
    try:
        writers = []
        for i in range(2):
            d = pk.LoroDoc(peer=400 + 10 * i)
            d.import_(base[i].export_snapshot())
            s = srv.connect()
            s.push(i, d.export_updates({})).epoch(60)
            writers.append((i, d, s, [d.oplog_vv()]))
        clis = [client(pk, net, f"diff-{k}", family) for k in range(2)]
        for e in range(3):
            for i, d, s, mark in writers:
                edit(d, rng, f"n{e}")
                s.push(i, d.export_updates(mark[0])).epoch(60)
                mark[0] = d.oplog_vv()
            for cli in clis:
                for i in range(2):
                    want = in_process_pull(srv, cli, i)
                    blob = cli.pull(i)
                    assert blob == want
                    got.append(blob)
            got.append(clis[0].pull(0))  # the empty delta
        fresh = client(pk, net, "fresh", family)
        clis.append(fresh)
        got.append(fresh.pull(0))
        got.append(fresh.last_pull["first_sync"])
        c = pk.LoroDoc(peer=999)
        c.import_(got[-2])
        assert plain(c.get_deep_value()) == plain(srv.oracle_doc(0).get_deep_value())
        return got, counts(net.report())
    finally:
        for c in clis:
            c.close()
        net.close()
        srv.close()


@pytest.mark.parametrize("family", FAMILIES)
def test_socket_pulls_equal_in_process_and_jax(family):
    both(_family_wire, family)


def _status(pk, with_plane):
    srv, _ = text_server(pk)
    plane = pk.health.HealthPlane(window_s=600.0).attach_sync(srv) if with_plane else None
    net = pk.NetServer(srv, health=plane)
    if plane is not None:
        plane.attach_net(net)
    prev = pk.health.install(None)
    try:
        if plane is not None:
            plane.tick()
        with pk.NetClient(HOST, net.port, "text", timeout=TIMEOUT) as cli:
            st = cli.status()
            alive = len(cli.pull(0))
        assert st["net"]["addr"] == net.addr
        return sorted(st), sorted(st["net"]), counts(st["net"]), st["verdict"], alive
    finally:
        pk.health.install(prev)
        net.close()
        srv.close()


@pytest.mark.parametrize("with_plane", [False, True], ids=["unknown", "plane"])
def test_status_frame_has_the_same_keys(with_plane):
    rec = both(_status, with_plane)
    assert (rec[3] == "unknown") != with_plane


def _refusals(pk):
    """A future protocol version and a wrong family are refused typed on
    their own connection; the server keeps serving."""
    srv, _ = text_server(pk)
    net = pk.NetServer(srv)
    try:
        frames = raw_frames(pk, net.port, [pk.wire.encode_hello("text", "future", version=pk.wire.PROTO_VERSION + 1)])
        bad_first = raw_frames(pk, net.port, [pk.wire.encode_pull(1, 0)])
        cli = pk.NetClient(HOST, net.port, "tree", timeout=TIMEOUT)
        with pytest.raises(pk.errors.NetProtocolError) as info:
            cli.connect()
        cli.kill()
        with pk.NetClient(HOST, net.port, "text", timeout=TIMEOUT) as ok:
            n = ok.hello_info["n_docs"]
        assert wait_for(lambda: net.report()["connections"] == 0)
        return frames, bad_first, str(info.value), n, counts(net.report())
    finally:
        net.close()
        srv.close()


def test_protocol_refusals_match_jax():
    rec = both(_refusals)
    assert rec[0][0][1]["code"] == JX.wire.E_BAD_VERSION and rec[4]["frame_errors"] == 3


# -- the three fault sites ----------------------------------------------------


def _net_frame(pk):
    srv, _ = text_server(pk)
    net = pk.NetServer(srv)
    a = b = None
    try:
        a, b = client(pk, net, "a"), client(pk, net, "b")
        first = (a.pull(0), b.pull(0))
        pk.fi.inject("net_frame", action="bitflip", flip_at=2, times=1)
        try:
            with pytest.raises((pk.errors.CodecDecodeError, pk.errors.NetError)) as info:
                a.pull(0)
        finally:
            pk.fi.clear()
        other = b.pull(0)
        assert wait_for(lambda: net.report()["frame_errors"] == 1)
        resumed = a.reconnect()["resumed"]
        again = a.pull(0)
        return first, type(info.value).__name__, str(info.value), other, resumed, again, counts(net.report())
    finally:
        for c in (a, b):
            if c is not None:
                c.kill()
        net.close()
        srv.close()


def test_net_frame_fault_fails_only_that_connection():
    rec = both(_net_frame)
    assert rec[4] == 1 and rec[6]["frame_errors"] == 1


def _net_accept(pk):
    srv, _ = text_server(pk)
    net = pk.NetServer(srv)
    a = late = None
    try:
        a = client(pk, net, "a")
        a.pull(0)
        pk.fi.inject("net_accept", times=1)
        try:
            with pytest.raises(pk.errors.NetError) as info:
                client(pk, net, "refused")
        finally:
            pk.fi.clear()
        refused = net.report()["refused"]
        live = a.pull(0)
        late = client(pk, net, "late")
        # a refused connection is closed unanswered: the client reads a
        # close or a reset, so only the error's type is recorded
        return type(info.value).__name__, refused, live, late.pull(0), counts(net.report())
    finally:
        for c in (a, late):
            if c is not None:
                c.kill()
        net.close()
        srv.close()


def test_net_accept_fault_refuses_new_keeps_live():
    rec = both(_net_accept)
    assert rec[1] == 1 and rec[4]["accepted"] == 2


def _conn_stall(pk, action):
    srv, _ = text_server(pk)
    net = pk.NetServer(srv)
    a = b = None
    try:
        a, b = client(pk, net, "a"), client(pk, net, "b")
        a.pull(0)
        b.pull(0)
        if action == "delay":
            pk.fi.inject("conn_stall", action="delay", delay_s=0.4, times=1)
        else:
            pk.fi.inject("conn_stall", action="raise", exc=RuntimeError("injected writer stall"), times=1)
        try:
            t0 = time.perf_counter()
            if action == "delay":
                out = (a.pull(0), time.perf_counter() - t0 >= 0.3)
            else:
                with pytest.raises(pk.errors.NetError) as info:
                    a.pull(0)
                out = (type(info.value).__name__,)  # a close or a reset: the type only
        finally:
            pk.fi.clear()
        other = b.pull(0)
        if action == "raise":
            a.reconnect()
        return out, other, a.pull(0)
    finally:
        for c in (a, b):
            if c is not None:
                c.kill()
        net.close()
        srv.close()


@pytest.mark.parametrize("action", ["delay", "raise"])
def test_conn_stall_fault(action):
    rec = both(_conn_stall, action)
    if action == "delay":
        assert rec[0][1]


# -- the read-only follower front: NOT_LEADER ----------------------------------


def _not_leader(pk, leader_id, leader_addr):
    base = seed_doc(pk, 62, 0)
    ro = pk.ReadOnly("text", 1, cid=cid_of("text", base), leader_id=leader_id, **pk.dev, **CAPS["text"])
    net = pk.NetServer(ro, leader_addr=leader_addr)
    cli = None
    try:
        cli = client(pk, net, "reader")
        first = cli.pull(0)
        d = pk.LoroDoc(peer=900)
        d.get_text("t").insert(0, "from the client")
        d.commit()
        with pytest.raises(pk.errors.NotLeader) as info:
            cli.push(0, d.export_updates({}))
        return first, str(info.value), info.value.leader, cli.pull(0)
    finally:
        if cli is not None:
            cli.kill()
        net.close()
        ro.close()


@pytest.mark.parametrize("leader_id,leader_addr", [("10.0.0.9:7007", None), (None, "10.1.1.1:9")],
                         ids=["follower_id", "addr_fallback"])
def test_not_leader_carries_the_leader_address(leader_id, leader_addr):
    rec = both(_not_leader, leader_id, leader_addr)
    assert rec[2] == (leader_id or leader_addr)


# -- idle reaping and the connection cap --------------------------------------


def _idle(pk):
    fake = [0.0]
    srv, _ = text_server(pk)
    net = pk.NetServer(srv, idle_timeout=1.0, clock=lambda: fake[0])
    cli = again = None
    try:
        n0 = pk.obs.counter("net.idle_closes_total").get(family="text")
        cli = client(pk, net, "idler")
        cli.pull(0)
        fake[0] += 100.0
        assert wait_for(lambda: net.report()["connections"] == 0)
        with pytest.raises(pk.errors.NetError) as info:
            cli.pull(0)
        again = client(pk, net, "again")
        # the type only: whether the client reads a clean close or a reset
        # depends on when the server's close reaches the socket
        return (pk.obs.counter("net.idle_closes_total").get(family="text") - n0, type(info.value).__name__,
                again.pull(0), counts(net.report()))
    finally:
        for c in (cli, again):
            if c is not None:
                c.kill()
        net.close()
        srv.close()


def test_idle_timeout_reaps_on_the_injected_clock():
    assert both(_idle)[0] == 1


def _cap(pk):
    srv, _ = text_server(pk)
    net = pk.NetServer(srv, max_connections=1)
    a = b = None
    try:
        a = client(pk, net, "a")
        with pytest.raises(pk.errors.NetError) as info:
            client(pk, net, "over-cap")
        refused = net.report()["refused"]
        live = a.pull(0)
        a.close()
        assert wait_for(lambda: net.report()["connections"] == 0)
        b = client(pk, net, "b")
        return type(info.value).__name__, refused, live, b.pull(0), counts(net.report())  # a close or a reset
    finally:
        for c in (a, b):
            if c is not None:
                c.kill()
        net.close()
        srv.close()


def test_connection_cap_refuses_then_frees():
    assert both(_cap)[1] == 1


# -- the port only: real device failures, the lock witness, the card ----------


def test_real_push_failure_reaches_the_client_typed(monkeypatch):
    """A real device error in the resident ingest fails the push's
    ticket with DeviceFailure(injected=False); the acker sends that
    request an E_INTERNAL ERROR frame, the client raises NetError with no
    ack, and the connection stays open for pulls."""
    srv, base = text_server(PT, 2, pipeline=False)
    net = PT.NetServer(srv)
    w = None
    try:
        w = client(PT, net, "writer")
        w.pull(0)

        def fail(*a, **k):
            raise PT.errors.KernelLaunchError("append launch failed: cudaError 700 (an illegal memory access)")

        monkeypatch.setattr(srv.resident.batch, "append_payloads", fail)
        d = PT.LoroDoc(peer=71)
        d.import_(base.export_snapshot())
        mark = d.oplog_vv()
        d.get_text("t").insert(0, "lost ")
        d.commit()
        with pytest.raises(PT.errors.NetError) as info:
            w.push(0, d.export_updates(mark))
        assert "INTERNAL" in str(info.value) and "device failure" in str(info.value)
        assert w.last_push is None and w.connected
        assert not srv.resident.degraded
        assert srv.oracle_doc(0).get_text("t").to_string() == base.get_text("t").to_string()
        assert isinstance(w.pull(1), bytes)  # the connection serves on
        assert net.report()["connections"] == 1
    finally:
        if w is not None:
            w.kill()
        net.close()
        with pytest.raises(RuntimeError):
            srv.close()  # the fan-in's commit error, as in the JAX package


def test_real_pull_failure_reaches_the_client_typed(monkeypatch):
    """A real device error in the read plane's selection raises
    DeviceFailure(injected=False) in the pull; the server's last-resort
    branch counts it in net.internal_errors_total and fails that
    connection with E_INTERNAL; the client raises NetError with no bytes
    and its frontier unmoved; other connections keep serving."""
    srv, _ = text_server(PT)
    net = PT.NetServer(srv)
    a = b = None
    try:
        a, b = client(PT, net, "a"), client(PT, net, "b")
        index = srv._readbatch.plane.index
        real = index.select

        def fail(requests):
            raise torch.AcceleratorError("CUDA error: an illegal memory access was encountered")

        monkeypatch.setattr(index, "select", fail)
        n0 = PT.obs.counter("net.internal_errors_total").get(family="text")
        with pytest.raises(PT.errors.NetError) as info:
            a.pull(0)
        assert "INTERNAL" in str(info.value) and "device failure" in str(info.value)
        assert a.last_pull is None and a.frontiers == {}
        assert PT.obs.counter("net.internal_errors_total").get(family="text") == n0 + 1
        assert srv.report()["readbatch"]["degraded_windows"] == 0
        monkeypatch.setattr(index, "select", real)
        assert wait_for(lambda: net.report()["connections"] == 1)
        assert b.pull(0) == srv.oracle_doc(0).export(PT.ExportMode.Updates(PT.VV()))
    finally:
        for c in (a, b):
            if c is not None:
                c.kill()
        net.close()
        srv.close()


def test_strict_lock_witness_over_the_net_edge():
    """Clients pushing, pulling and polling from threads under a strict
    lock witness: every acquisition follows the declared order, and
    net.accept sits above sync.server."""
    lw = PT.lockwitness.witness()
    lw.reset()
    lw.enable(strict=True)
    errors = []
    try:
        srv, base = text_server(PT, 2)
        net = PT.NetServer(srv)
        clis = []
        try:
            clis = [client(PT, net, f"w{k}") for k in range(4)]

            def work(k):
                try:
                    d = PT.LoroDoc(peer=700 + k)
                    d.import_(base.export_snapshot())
                    mark = d.oplog_vv()
                    for r in range(3):
                        d.get_text("t").insert(0, f"w{k}r{r} ")
                        d.commit()
                        clis[k].push(k % 2, d.export_updates(mark))
                        mark = d.oplog_vv()
                        clis[k].pull(k % 2)
                    clis[k].poll(timeout_s=0.05)
                except BaseException as e:  # noqa: BLE001 — collected for the assert
                    errors.append(e)

            ths = [threading.Thread(target=work, args=(k,)) for k in range(4)]
            for t in ths:
                t.start()
            for t in ths:
                t.join(60)
        finally:
            for c in clis:
                c.kill()
            net.close()
            srv.close()
    finally:
        lw.disable()
    assert errors == []
    assert lw.check_declared() == [] and lw.violations() == []
    lw.assert_acyclic()
    assert PT.lockorder.level("net.accept") < PT.lockorder.level("sync.server")
    lw.reset()


def test_net_server_needs_a_card_or_cpu(monkeypatch):
    """The server under a NetServer runs on the card by default: without
    one it raises DeviceUnavailable; asked for the CPU, the edge serves."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(PT.errors.DeviceUnavailable):
        PT.SyncServer("counter", 1)
    srv = PT.SyncServer("counter", 1, device="cpu")
    net = PT.NetServer(srv)
    try:
        with PT.NetClient(HOST, net.port, "counter", timeout=TIMEOUT) as cli:
            assert cli.pull(0) == srv.oracle_doc(0).export(PT.ExportMode.Updates(PT.VV()))
        assert srv.resident.batch.device == torch.device("cpu")
        assert json.loads(net._status_payload())["net"]["accepted"] == 1
    finally:
        net.close()
        srv.close()
