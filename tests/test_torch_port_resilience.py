"""PyTorch port: the retry ladder, the serve wire and the config knobs
against the reference.

Stdlib paths, no model: the port keeps its own copies of
``native/resilience.py`` and ``serve/wire.py`` (importing
``horovod_tpu`` imports JAX), so each is held to the reference's:

* the classifier (``TestClassifier``) and the seeded backoff ladder
  (``TestRetryPolicy``): the same delays for the same (seed, rank), the
  same absorb / exhaust / fatal / short-circuit behaviour and counters;
* the knobs (``TestConfigKnobs``): ``HOROVOD_NET_*``,
  ``HOROVOD_SERVE_WIRE_MAX_FRAME`` and ``HOROVOD_SERVE_BUCKETS`` (fault
  C3: the port did not check the buckets) parse and fail with the
  reference's messages;
* wire frames over a ``socket.socketpair``: the port's ``send_msg`` /
  ``send_bin`` are read by the reference's ``recv_any`` and the reverse,
  byte for byte, and both refuse the same corrupt, oversized and
  truncated frames;
* the metrics plane the fleet reads: ``merge_snapshots`` /
  ``snapshot_to_prometheus`` and ``HistogramWindow`` give the
  reference's results, and the exporter serves the registry and writes
  timeline rows.
"""
import json
import socket
import struct
import threading
import zlib

import pytest

from horovod_tpu.chaos import detector as jdetector
from horovod_tpu.core.config import Config as JConfig
from horovod_tpu.native import resilience as jres
from horovod_tpu.obs.metrics import get_registry as jregistry
from horovod_tpu.serve import wire as jwire
from horovod_tpu_torch.chaos import detector as tdetector
from horovod_tpu_torch.core.config import Config as TConfig
from horovod_tpu_torch.native import resilience as tres
from horovod_tpu_torch.obs.metrics import get_registry as tregistry
from horovod_tpu_torch.serve import wire as twire

_PKGS = {"port": (tres, tregistry, tdetector, twire),
         "ref": (jres, jregistry, jdetector, jwire)}


def _retry_count(registry, site, outcome):
    return sum(c["value"] for c in registry().snapshot()["counters"]
               if c["name"] == "hvd_net_retries_total"
               and c["labels"].get("site") == site
               and c["labels"].get("outcome") == outcome)


# ---------------------------------------------------------------------------
# the classifier
# ---------------------------------------------------------------------------

class _Marked(Exception):
    pass


@pytest.mark.parametrize("make", [
    lambda res, wire: wire.DispatchConnError("x"),
    lambda res, wire: wire.DispatchError("x"),
    lambda res, wire: ConnectionResetError(),
    lambda res, wire: ConnectionRefusedError(),
    lambda res, wire: ConnectionAbortedError(),
    lambda res, wire: BrokenPipeError(),
    lambda res, wire: socket.timeout(),
    lambda res, wire: ValueError("x"),
    lambda res, wire: OSError("disk"),
    lambda res, wire: type("C", (RuntimeError, res.Retryable), {})("x"),
])
def test_classifier_as_the_reference(make):
    assert tres.is_retryable(make(tres, twire)) == \
        jres.is_retryable(make(jres, jwire))


def test_classifier_retryable_vs_fatal():
    assert tres.is_retryable(twire.DispatchConnError("x"))
    assert tres.is_retryable(ConnectionResetError())
    assert not tres.is_retryable(twire.DispatchError("x"))
    assert not tres.is_retryable(socket.timeout())
    e = _Marked("blip")
    assert not tres.is_retryable(e)
    e.retryable = True
    assert tres.is_retryable(e)
    e.retryable = False
    assert not tres.is_retryable(e)


# ---------------------------------------------------------------------------
# the seeded backoff ladder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(retries=6, backoff_base_ms=25, budget_s=10, seed=3, rank=1),
    dict(retries=6, backoff_base_ms=25, budget_s=10, seed=3, rank=2),
    dict(retries=10, backoff_base_ms=100, budget_s=0.75, seed=7, rank=0),
    dict(retries=0, backoff_base_ms=1, budget_s=5),
])
def test_backoff_delays_equal_the_reference(kw):
    p = tres.RetryPolicy(**kw)
    assert p.delays == jres.RetryPolicy(**kw).delays
    assert sum(p.delays) <= kw["budget_s"] + 1e-9
    assert len(p.delays) == kw["retries"]


def test_backoff_deterministic_per_seed_rank_and_within_budget():
    a = tres.RetryPolicy(retries=6, seed=3, rank=1)
    assert a.delays == tres.RetryPolicy(retries=6, seed=3, rank=1).delays
    assert a.delays != tres.RetryPolicy(retries=6, seed=3, rank=2).delays
    for seed in range(20):
        p = tres.RetryPolicy(retries=10, backoff_base_ms=100,
                             budget_s=0.75, seed=seed)
        assert sum(p.delays) <= 0.75 + 1e-9 and p.delays[0] >= 0.1


def _ladder_script(name):
    res, registry, det, wire = _PKGS[name]
    out = []
    p = res.RetryPolicy(retries=3, backoff_base_ms=1, budget_s=5)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise wire.DispatchConnError("blip")
        return "ok"

    base = _retry_count(registry, "t", "absorbed")
    out.append((p.run(flaky, what="t", site="t", plane="serve"), len(calls),
                _retry_count(registry, "t", "absorbed") - base))
    p = res.RetryPolicy(retries=2, backoff_base_ms=1, budget_s=5)
    base = _retry_count(registry, "tx", "exhausted")
    with pytest.raises(wire.DispatchConnError, match="blip"):
        p.run(lambda: (_ for _ in ()).throw(wire.DispatchConnError("blip")),
              what="tx", site="tx", plane="serve")
    out.append(_retry_count(registry, "tx", "exhausted") - base)
    calls.clear()

    def fatal():
        calls.append(1)
        raise wire.DispatchError("gone")

    with pytest.raises(wire.DispatchError):
        res.RetryPolicy(retries=5, backoff_base_ms=1,
                        budget_s=5).run(fatal, what="t", site="t",
                                        plane="serve")
    out.append(len(calls))

    class _Fake:
        def suspects(self):
            return {2: 9.9}

    calls.clear()

    def blip():
        calls.append(1)
        raise wire.DispatchConnError("blip")

    p = res.RetryPolicy(retries=5, backoff_base_ms=1, budget_s=5)
    det._DETECTOR = _Fake()
    try:
        base = _retry_count(registry, "sc", "short_circuit")
        with pytest.raises(wire.DispatchConnError):
            p.run(blip, what="t", site="sc", plane="serve", peer=2)
        out.append((len(calls), _retry_count(registry, "sc",
                                             "short_circuit") - base))
        with pytest.raises(wire.DispatchConnError):
            p.run(blip, what="t", site="sc", plane="serve", peer=0)
        out.append(len(calls))
        with pytest.raises(wire.DispatchConnError):
            p.run(blip, what="t", site="sc", plane="serve",
                  abort=lambda: True)
        out.append(len(calls))
    finally:
        det._DETECTOR = None
    calls.clear()
    with pytest.raises(wire.DispatchConnError):
        res.RetryPolicy(retries=0).run(blip, what="t", site="t",
                                       plane="serve")
    out.append(len(calls))
    for bad, match in ((dict(retries=-1), "retries"),
                       (dict(backoff_base_ms=0), "backoff"),
                       (dict(budget_s=0), "budget")):
        with pytest.raises(ValueError, match=match):
            res.RetryPolicy(**bad)
    return out


def test_ladder_absorbs_exhausts_and_short_circuits_as_the_reference():
    """``TestRetryPolicy``'s run tests on both packages: absorbed then
    succeeds, exhausts and re-raises the original, fatal never retried,
    a suspected peer (and an aborting caller) short-circuits, retries 0
    passes through; the counters move alike."""
    got = _ladder_script("port")
    assert got == _ladder_script("ref")
    assert got == [("ok", 3, 2), 1, 1, (1, 1), 7, 8, 1]
    assert tdetector.current_suspects() == {}


def test_process_policy_reads_the_knobs(monkeypatch):
    monkeypatch.setenv("HOROVOD_NET_RETRIES", "2")
    monkeypatch.setenv("HOROVOD_NET_BACKOFF_BASE_MS", "5")
    monkeypatch.setenv("HOROVOD_RANK", "3")
    tres.reset_policy()
    jres.reset_policy()
    try:
        p = tres.policy()
        assert p is tres.policy()
        assert (p.retries, p.backoff_base_ms, p.rank) == (2, 5.0, 3)
        assert p.delays == jres.policy().delays
    finally:
        tres.reset_policy()
        jres.reset_policy()


# ---------------------------------------------------------------------------
# the knobs
# ---------------------------------------------------------------------------

def _error(cls):
    try:
        cls.from_env()
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("env,value", [
    ("HOROVOD_NET_RETRIES", "many"), ("HOROVOD_NET_RETRIES", "-1"),
    ("HOROVOD_NET_BACKOFF_BASE_MS", "many"),
    ("HOROVOD_NET_BACKOFF_BASE_MS", "0"),
    ("HOROVOD_NET_RETRY_BUDGET_S", "many"),
    ("HOROVOD_NET_RETRY_BUDGET_S", "0"),
    ("HOROVOD_SERVE_WIRE_MAX_FRAME", "big"),
    ("HOROVOD_SERVE_WIRE_MAX_FRAME", "1024"),
    ("HOROVOD_SERVE_WIRE_MAX_FRAME", str(1 << 31)),
    # fault C3: the port accepted these
    ("HOROVOD_SERVE_BUCKETS", "0,8"), ("HOROVOD_SERVE_BUCKETS", ""),
    ("HOROVOD_SERVE_BUCKETS", "16,8"), ("HOROVOD_SERVE_BUCKETS", "8,8"),
    ("HOROVOD_SERVE_BUCKETS", "-4"),
])
def test_knobs_fail_fast_with_the_reference_message(monkeypatch, env,
                                                    value):
    monkeypatch.setenv(env, value)
    msg = _error(TConfig)
    assert msg is not None and env in msg
    assert msg == _error(JConfig)


def test_valid_knobs_land_as_the_reference(monkeypatch):
    for env, value in (("HOROVOD_NET_RETRIES", "7"),
                       ("HOROVOD_NET_BACKOFF_BASE_MS", "12.5"),
                       ("HOROVOD_NET_RETRY_BUDGET_S", "3.5"),
                       ("HOROVOD_SERVE_WIRE_MAX_FRAME", str(1 << 20)),
                       ("HOROVOD_SERVE_BUCKETS", "8,16")):
        monkeypatch.setenv(env, value)
    t, j = TConfig.from_env(), JConfig.from_env()
    for k in ("net_retries", "net_backoff_base_ms", "net_retry_budget_s",
              "serve_wire_max_frame", "serve_buckets"):
        assert getattr(t, k) == getattr(j, k)
    assert (t.net_retries, t.net_backoff_base_ms, t.net_retry_budget_s,
            t.serve_wire_max_frame, t.serve_buckets) == \
        (7, 12.5, 3.5, 1 << 20, (8, 16))


def test_budget_stays_below_the_collective_timeout(monkeypatch):
    monkeypatch.setenv("HOROVOD_GLOO_TIMEOUT_SECONDS", "30")
    monkeypatch.setenv("HOROVOD_NET_RETRY_BUDGET_S", "30")
    msg = _error(TConfig)
    assert "BELOW" in msg and msg == _error(JConfig)
    monkeypatch.setenv("HOROVOD_NET_RETRY_BUDGET_S", "5")
    assert TConfig.from_env().net_retry_budget_s == 5.0
    monkeypatch.setenv("HOROVOD_NET_RETRIES", "0")
    monkeypatch.setenv("HOROVOD_NET_RETRY_BUDGET_S", "30")
    TConfig.from_env()                  # retries off: the bound is vacuous
    # unset, the budget adapts to a short collective timeout
    monkeypatch.delenv("HOROVOD_NET_RETRIES")
    monkeypatch.delenv("HOROVOD_NET_RETRY_BUDGET_S")
    monkeypatch.setenv("HOROVOD_GLOO_TIMEOUT_SECONDS", "2")
    assert TConfig.from_env().net_retry_budget_s == 1.0 == \
        tres.default_budget_s(2.0) == JConfig.from_env().net_retry_budget_s
    monkeypatch.setenv("HOROVOD_GLOO_TIMEOUT_SECONDS", "300")
    assert TConfig.from_env().net_retry_budget_s == 10.0


# ---------------------------------------------------------------------------
# wire frames across packages
# ---------------------------------------------------------------------------

_HEADER = {"op": "kvtier_pull", "tokens": [3, 1, 4, 1], "block_size": 4,
           "weights_version": None, "blocks": [{"filled": 4}]}


def _exchange(send, recv):
    """One frame written by ``send(sock)`` and read by ``recv(sock)``
    over a socketpair; returns the reader's result and the raw bytes."""
    a, b = socket.socketpair()
    try:
        raw = []
        orig = a.sendall
        send(type("S", (), {"sendall": lambda self, d: (raw.append(d),
                                                        orig(d))[1]})())
        return recv(b), b"".join(raw)
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port"),
                                          ("port", "port")])
def test_wire_frames_cross_read_byte_for_byte(writer, reader):
    w, r = _PKGS[writer][3], _PKGS[reader][3]
    payload = bytes(range(256)) * 9
    head = dict(_HEADER, payload_crc=zlib.crc32(payload))
    for send, want in (
            (lambda s: w.send_msg(s, {"ack": "accepted", "n": 3}),
             ({"ack": "accepted", "n": 3}, None)),
            (lambda s: w.send_bin(s, head, payload), (head, payload))):
        got, raw = _exchange(send, lambda s: r.recv_any(s, timeout=5))
        assert got == want
        # the other package writes the same bytes for the same frame
        other = _PKGS["ref" if writer == "port" else "port"][3]
        _, raw2 = _exchange(
            lambda s: (other.send_msg(s, want[0]) if want[1] is None
                       else other.send_bin(s, want[0], want[1])),
            lambda s: r.recv_any(s, timeout=5))
        assert raw == raw2


def _refusal(wire, frame):
    a, b = socket.socketpair()
    try:
        a.sendall(frame)
        a.close()
        try:
            wire.recv_any(b, timeout=5)
        except Exception as e:  # noqa: BLE001 — the class is the answer
            return type(e).__name__, wire.resilience.is_retryable(e)
        return None
    finally:
        b.close()


@pytest.mark.parametrize("case", ["crc", "oversize", "truncated",
                                  "garbage", "header_len", "not_object"])
def test_wire_refuses_bad_frames_as_the_reference(case):
    payload = b"kv" * 64
    head = json.dumps(dict(_HEADER, payload_crc=zlib.crc32(payload))
                      ).encode()
    flag = 0x80000000
    frame = {
        "crc": struct.pack(">II", (4 + len(head) + len(payload)) | flag,
                           len(head)) + head + b"kV" + payload[2:],
        "oversize": struct.pack(">I", (64 << 20)),
        "truncated": struct.pack(">I", 100) + b"{}",
        "garbage": struct.pack(">I", 5) + b"{nope",
        "header_len": struct.pack(">II", 8 | flag, 99) + b"abcd",
        "not_object": struct.pack(">I", 2) + b"[]",
    }[case]
    got = _refusal(twire, frame)
    assert got is not None and got == _refusal(jwire, frame)
    assert got[1] == (case == "truncated")    # only an EOF is retryable


def test_oversized_send_refused_before_the_wire(monkeypatch):
    monkeypatch.setenv("HOROVOD_SERVE_WIRE_MAX_FRAME", str(1 << 16))
    twire._reset_max_frame_cache()
    try:
        a, b = socket.socketpair()
        with pytest.raises(twire.DispatchError,
                           match="HOROVOD_SERVE_WIRE_MAX_FRAME"):
            twire.send_bin(a, {"op": "x"}, b"\0" * (1 << 16))
        a.close()
        b.close()
    finally:
        twire._reset_max_frame_cache()


def test_a_refused_dial_is_retryable():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()                          # nothing listens there now
    with pytest.raises(twire.DispatchConnError):
        twire.connect(("127.0.0.1", port), timeout=2.0)


def test_two_frame_request_against_a_reference_peer():
    """The dispatch exchange (``two_frame_request``) of the port against
    a peer speaking the reference's frames: the control ack, then the
    reply."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    seen = {}

    def peer():
        c, _ = srv.accept()
        seen["req"] = jwire.recv_msg(c, timeout=5)
        jwire.send_msg(c, {"ack": "accepted"})
        jwire.send_msg(c, {"tokens": [7, 8], "status": "ok"})
        c.close()

    t = threading.Thread(target=peer)
    t.start()
    acked = []
    try:
        kind, reply = twire.two_frame_request(
            srv.getsockname(), {"op": "submit", "fid": 1},
            on_ack=lambda: acked.append(1))
    finally:
        t.join(timeout=10)
        srv.close()
    assert (kind, reply) == ("ok", {"tokens": [7, 8], "status": "ok"})
    assert seen["req"] == {"op": "submit", "fid": 1} and acked == [1]


# ---------------------------------------------------------------------------
# the metrics plane the fleet reads (obs/metrics.py, obs/exporter.py)
# ---------------------------------------------------------------------------

def _registries():
    from horovod_tpu.obs import metrics as jm
    from horovod_tpu_torch.obs import metrics as tm
    return tm, jm


def _fill(mod, seed):
    """A fresh registry with the same seeded series in either package."""
    import numpy as np
    rng = np.random.RandomState(seed)
    R = mod.MetricsRegistry()
    for rid in ("0", "1"):
        R.counter("hvd_serve_requeued_total", "re-queued",
                  {"replica": rid}).inc(int(rng.randint(1, 9)))
        R.gauge("hvd_serve_replica_up", "up", {"replica": rid}).set(
            float(rng.randint(0, 2)))
        h = R.histogram("hvd_serve_router_ms", "router legs",
                        {"leg": "e2e", "replica": rid})
        for x in rng.exponential(40.0, 50):
            h.observe(float(x))
    return R


def test_merge_and_render_snapshots_as_the_reference():
    tm, jm = _registries()
    snaps_t = [_fill(tm, s).snapshot() for s in (1, 2, 3)]
    snaps_j = [_fill(jm, s).snapshot() for s in (1, 2, 3)]
    assert snaps_t == snaps_j
    merged = tm.merge_snapshots(snaps_t)
    assert merged == jm.merge_snapshots(snaps_j)
    help_t, help_j = _fill(tm, 9), _fill(jm, 9)
    text = tm.snapshot_to_prometheus(merged, help_from=help_t)
    assert text == jm.snapshot_to_prometheus(merged, help_from=help_j)
    assert "# HELP hvd_serve_router_ms router legs" in text
    bad = dict(merged, histograms=[dict(merged["histograms"][0],
                                        bounds=[1.0])])
    with pytest.raises(ValueError, match="not mergeable"):
        tm.merge_snapshots([merged, bad])


def test_histogram_window_as_the_reference():
    tm, jm = _registries()
    got = []
    for mod in (tm, jm):
        R = mod.MetricsRegistry()
        h = R.histogram("x_ms", "x")
        w = mod.HistogramWindow(q=0.99, alpha=0.5)
        seq = [w.sample(None), w.sample(h)]
        for burst in ((1.0, 2.0, 3.0), (), (500.0, 700.0), (5.0,)):
            for x in burst:
                h.observe(x)
            seq.append(w.sample(h))
        got.append(seq)
    assert got[0] == got[1]
    # no series yet, then the first window's baseline; a quiet poll
    # carries the last value
    assert got[0][:2] == [None, None] and got[0][2] is not None
    assert got[0][3] == got[0][2]
    with pytest.raises(ValueError):
        tm.HistogramWindow(q=1.5)


def test_exporter_serves_the_registry_and_the_timeline_gets_rows():
    import urllib.request
    from horovod_tpu_torch.obs import exporter
    tm, _ = _registries()
    R = _fill(tm, 4)
    exp = exporter.start_exporter(port=0, registry=R)
    try:
        base = "http://%s:%d" % (exp.host, exp.port)
        with urllib.request.urlopen(base + "/metrics?x=1", timeout=10) as r:
            assert r.headers["Content-Type"] == \
                exporter.PROMETHEUS_CONTENT_TYPE
            assert r.read().decode() == R.to_prometheus()
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            assert json.loads(r.read()) == {"ok": True}
    finally:
        exp.stop()
    rows, seen = [], threading.Event()

    class _Timeline:
        def instant(self, name, payload):
            rows.append((name, payload))
            seen.set()

    em = exporter.TimelineEmitter(_Timeline(), 0.01, registry=R)
    try:
        assert seen.wait(10)
    finally:
        em.stop()
    name, payload = rows[0]
    assert name == "METRICS"
    assert payload == exporter.timeline_summary(R)
    assert payload['hvd_serve_router_ms{leg=e2e,replica=0}']["count"] == 50
    with pytest.raises(ValueError):
        exporter.TimelineEmitter(_Timeline(), 0)
