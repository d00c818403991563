"""The port's serving fleet (``paddle_tpu_torch.serving.fleet``) against
the JAX reference's (``paddle_tpu/serving/fleet.py``) on the CPU:

* ``merge_scrapes`` gives the same page; the ``CircuitBreaker`` walks the
  same states under an injected clock; ``_affinity_key`` and ``_pick``
  choose the same backend for the same backends and gauges;
* each package's ``latest_artifact`` finds the other's
  ``publish_artifact`` serial, plain and weight-quantized, with equal
  manifests apart from the timestamp;
* both packages' ``ServingClient`` fail over from a dead endpoint to a
  live one;
* the router over in-process stub backends: failover without a client
  failure, draining and overload 503s, answers passed through, the
  deadline's 504 before any replica, the tenant passed on, the prefill hop's
  outcomes, health ejection and readmission, and its endpoints
  (``/fleet/trace`` merging a dead replica's spool);
* the supervisor over the reference's stdlib stub replica
  (``tests/serving/_stub_replica.py``): crash restart, a rolling hot-swap
  under load, scaling and the prefill namespace;
* and one end-to-end run of two real port
  replicas (``--device cpu``, a tiny decoder) under the router with one
  SIGKILLed mid-load: zero failed requests, streams equal to an in-process
  engine, and ``/fleet/trace`` merging the request.

Fleet HA (the registry, the lease, standby takeover) is held in
``tests/test_torch_fleet_ha.py``.
"""

from tests import torch_threads  # noqa: F401  (first)
import json
import os
import signal
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from paddle_tpu import flags as jflags
from paddle_tpu import serving as jserving
from paddle_tpu.serving import fleet as jfleet
from paddle_tpu.serving import registry as jregistry
from paddle_tpu_torch import flags
from paddle_tpu_torch.observability import catalog, tracing
from paddle_tpu_torch.observability.http import BackgroundHTTPServer, \
    JsonHTTPHandler, free_port
from paddle_tpu_torch.serving import ServingClient, fleet
from paddle_tpu_torch.serving.registry import resolve_fleet_knobs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUB_REPLICA = os.path.join(REPO, "tests", "serving", "_stub_replica.py")


# -- pure functions against the reference ------------------------------------

def test_merge_scrapes_matches_the_reference():
    from paddle_tpu_torch.serving.metrics import render_prometheus
    catalog.FLEET_REQUESTS.inc()
    a = render_prometheus(gauges={"serving_queue_depth": 3,
                                  "fleet_replicas_live": 2})
    b = ("# HELP paddle_tpu_x_total things\n# TYPE paddle_tpu_x_total "
         "counter\npaddle_tpu_x_total{outcome=\"ok\"} 4\n\n"
         "# EXEMPLAR paddle_tpu_x_total trace_id=abc\n"
         "paddle_tpu_lat_seconds{quantile=\"0.5\"} 0.1\n"
         "paddle_tpu_lat_seconds_sum 1.5\npaddle_tpu_lat_seconds_count 3\n"
         "bad line without value\n# TYPE\nnot{valid 1\n")
    pages = [("router", a), ("replica0", b), ("replica1", a)]
    got = fleet.merge_scrapes(pages)
    assert got == jfleet.merge_scrapes(pages)
    assert 'paddle_tpu_x_total{replica="replica0",outcome="ok"} 4' in got
    assert not any(ln.startswith("# EXEMPLAR") for ln in got.splitlines())


def test_circuit_breaker_walks_the_reference_states():
    now = [0.0]
    mine = fleet.CircuitBreaker(fail_threshold=3, reset_after_s=2.0,
                                clock=lambda: now[0])
    ref = jfleet.CircuitBreaker(fail_threshold=3, reset_after_s=2.0,
                                clock=lambda: now[0])
    rng = np.random.RandomState(5)
    seen = set()
    for _ in range(400):
        op = rng.choice(["fail", "ok", "allow", "tick"],
                        p=[0.4, 0.1, 0.3, 0.2])
        if op == "tick":
            now[0] += float(rng.choice([0.5, 1.0, 2.5]))
            outs = (None, None)
        elif op == "fail":
            outs = (mine.record_failure(), ref.record_failure())
        elif op == "ok":
            outs = (mine.record_success(), ref.record_success())
        else:
            outs = (mine.allow(), ref.allow())
        assert outs[0] == outs[1]
        assert (mine.state, mine.admits()) == (ref.state, ref.admits())
        seen.add(mine.state)
    assert seen == {"closed", "open", "half_open"}


def _routers():
    mine = fleet.FleetRouter(("127.0.0.1", 0))
    ref = jfleet.FleetRouter(("127.0.0.1", 0))
    return mine, ref


def test_affinity_and_pick_choose_as_the_reference():
    mine, ref = _routers()
    try:
        rng = np.random.RandomState(11)
        names = ["replica%d" % i for i in range(4)] + ["prefill0"]
        for r in (mine, ref):
            for i, name in enumerate(names):
                r.add_backend("http://127.0.0.1:%d" % (9000 + i), name=name,
                              role="prefill" if name.startswith("prefill")
                              else "both")
        prefix = [int(t) for t in rng.randint(0, 100, 20)]
        picks = 0
        for trial in range(200):
            health = rng.choice(["ok", "ok", "ok", "unknown", "dead",
                                 "draining"], size=len(names))
            depth = rng.randint(0, 10, size=len(names)).astype(float)
            slots = rng.randint(0, 4, size=len(names)).astype(float)
            for r in (mine, ref):
                for b, h, d, s in zip(sorted(r.backends(),
                                             key=lambda b: b.name),
                                      health, depth, slots):
                    b.health, b.queue_depth, b.active_slots = str(h), d, s
            n = int(rng.randint(1, 40))
            prompt = (prefix[:n] if trial % 2 else
                      [int(t) for t in rng.randint(0, 100, n)])
            key = mine._affinity_key(prompt)
            assert key == ref._affinity_key(prompt)
            excluded = {"http://127.0.0.1:%d" % (9000 + int(i))
                        for i in rng.randint(0, 5, size=rng.randint(0, 3))}
            for path, aff in (("/v1/generate", key), ("/v1/infer", None),
                              ("/v1/prefill", None)):
                a = mine._pick(excluded, path=path, affinity_key=aff)
                b = ref._pick(excluded, path=path, affinity_key=aff)
                assert (a and a.url) == (b and b.url)
                picks += a is not None
        assert picks > 300
    finally:
        mine.server_close()
        ref.server_close()


def test_prefill_knob_is_validated_as_the_reference(monkeypatch):
    assert resolve_fleet_knobs(which=("prefill_min_prompt",)) == \
        {"prefill_min_prompt": 0}
    for kw in ({"prefill_min_prompt": -1}, {"prefill_min_prompt": "x"}):
        with pytest.raises(ValueError) as mine:
            resolve_fleet_knobs(which=("prefill_min_prompt",), **kw)
        with pytest.raises(ValueError) as ref:
            jregistry.resolve_fleet_knobs(which=("prefill_min_prompt",),
                                          **kw)
        assert str(mine.value) == str(ref.value)
    monkeypatch.setattr(flags, "fleet_prefill_min_prompt", -3)
    monkeypatch.setattr(jflags, "fleet_prefill_min_prompt", -3)
    with pytest.raises(ValueError, match="FLAGS_fleet_prefill_min_prompt"):
        fleet.FleetRouter(("127.0.0.1", 0))


def _decoder(path):
    from paddle_tpu_torch.serving import TransformerDecoderModel, \
        save_decoder
    m = TransformerDecoderModel(64, dim=32, n_heads=2, n_layers=2)
    save_decoder(path, m, m.init_params(0, device="cpu"))
    return path


@pytest.mark.parametrize("wq", ["off", "int8"])
def test_publish_artifact_crosses_the_packages(tmp_path, wq):
    src = _decoder(str(tmp_path / "decoder"))
    with open(os.path.join(src, "notes.txt"), "w") as f:
        f.write("sidecar")
    roots = {"port": str(tmp_path / "port"), "ref": str(tmp_path / "ref")}
    mine = fleet.publish_artifact(roots["port"], src, weight_quant_dtype=wq)
    ref = jfleet.publish_artifact(roots["ref"], src, weight_quant_dtype=wq)
    assert mine[0] == ref[0] == 0
    # each package finds the other's serial
    assert jfleet.latest_artifact(roots["port"]) == mine
    assert fleet.latest_artifact(roots["ref"]) == ref
    man = []
    for _, d in (mine, ref):
        with open(os.path.join(d, "_MANIFEST")) as f:
            man.append(json.load(f))
    assert sorted(man[0]) == sorted(man[1])
    assert ("weight_quant" in man[0]) == (wq != "off")
    for key in man[0]:
        if key == "timestamp":
            continue
        if key == "md5" and wq != "off":
            # the npz's zip entries carry their write time: its arrays
            # are compared instead
            assert sorted(man[0]["md5"]) == sorted(man[1]["md5"])
            assert {k: v for k, v in man[0]["md5"].items()
                    if k != "params.npz"} == \
                {k: v for k, v in man[1]["md5"].items()
                 if k != "params.npz"}
            with np.load(os.path.join(mine[1], "params.npz")) as a, \
                    np.load(os.path.join(ref[1], "params.npz")) as b:
                assert sorted(a.files) == sorted(b.files)
                for k in a.files:
                    np.testing.assert_array_equal(a[k], b[k])
            continue
        assert man[0][key] == man[1][key], key
    # a second publish, trimmed to the newest one
    s1, _ = fleet.publish_artifact(roots["port"], src, keep=1,
                                   weight_quant_dtype="off")
    assert s1 == 1 and os.listdir(roots["port"]) == ["1"]
    assert jfleet.latest_artifact(roots["port"])[0] == 1


def test_publish_artifact_reads_the_weight_quant_flag(tmp_path, monkeypatch):
    src = _decoder(str(tmp_path / "decoder"))
    other = tmp_path / "plain"
    other.mkdir()
    (other / "payload.bin").write_bytes(b"\x01\x02")
    monkeypatch.setattr(flags, "weight_quant_dtype", "int8")
    _, d = fleet.publish_artifact(str(tmp_path / "root"), src)
    with open(os.path.join(d, "config.json")) as f:
        assert json.load(f)["weight_quant"]["dtype"] == "int8"
    # the flag's default publishes a non-decoder source plain; an explicit
    # mode on it raises
    _, d = fleet.publish_artifact(str(tmp_path / "root"), str(other))
    assert sorted(os.listdir(d)) == ["_MANIFEST", "payload.bin"]
    with pytest.raises(ValueError, match="config.json"):
        fleet.publish_artifact(str(tmp_path / "root"), str(other),
                               weight_quant_dtype="int8")
    monkeypatch.setattr(flags, "weight_quant_dtype", "int4")
    with pytest.raises(ValueError, match="FLAGS_weight_quant_dtype"):
        fleet.publish_artifact(str(tmp_path / "root"), src)


# -- in-process stub backends -------------------------------------------------

class _StubHandler(JsonHTTPHandler):

    def do_GET(self):
        srv = self.server
        if self.path == "/healthz":
            st = srv.health_state
            self._send_json(200 if st == "ok" else 503,
                            {"status": st, "ready": st == "ok",
                             "serving": {"pid": os.getpid()}})
        elif self.path == "/metrics":
            self._send(200, "paddle_tpu_serving_queue_depth %g\n"
                       "paddle_tpu_generation_active_slots 1\n"
                       % srv.queue_depth,
                       content_type="text/plain; version=0.0.4")
        elif self.path == "/trace":
            self._send_json(200, {"traceEvents": srv.events})
        else:
            self._send_json(404, {"error": "?"})

    def do_POST(self):
        srv = self.server
        body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
        srv.seen.append((self.path, dict(self.headers.items()), body))
        rid = self.headers.get("X-Request-Id")
        srv.events.append({"name": "http.request", "ph": "X", "ts": 1.0,
                           "dur": 1.0, "pid": srv.fake_pid, "tid": 1,
                           "args": {"request_id": rid,
                                    "trace_id": self.headers.get(
                                        "X-Trace-Id")}})
        if srv.mode == "reset":
            self.connection.close()
        elif srv.mode == "overload":
            self._send_json(503, {"error": "queue full"},
                            extra_headers={"Retry-After": "0.01"})
        elif srv.mode == "draining":
            self._send_json(503, {"error": "draining"})
        elif srv.mode == "e400":
            self._send_json(400, {"error": "bad prompt"})
        else:
            self._send_json(200, {"tokens": [srv.tag], "n_pages": 2,
                                  "key": "ab" * 8, "outputs": [[srv.tag]],
                                  "request_id": rid})


class _Stub:
    def __init__(self, tag=0, mode="ok", health="ok", queue_depth=0.0):
        self.server = BackgroundHTTPServer(("127.0.0.1", 0), _StubHandler)
        self.server.tag, self.server.mode = tag, mode
        self.server.health_state, self.server.queue_depth = health, \
            queue_depth
        self.server.seen, self.server.events = [], []
        self.server.fake_pid = 50000 + tag
        self.server.start_background("stub-backend")
        self.url = self.server.url

    @property
    def seen(self):
        return self.server.seen

    def stop(self):
        self.server.stop(5)


@pytest.fixture
def router():
    r = fleet.FleetRouter(("127.0.0.1", 0), check_interval_s=30.0,
                          route_timeout_s=5.0, backoff_base_s=0.01,
                          backoff_cap_s=0.05, prefill_min_prompt=4)
    r.start_background()
    yield r
    r.stop(5)


def _post(url, body, headers=None):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers=dict({"Content-Type":
                                               "application/json"},
                                              **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def test_client_fails_over_from_a_dead_endpoint():
    live = _Stub(tag=7)
    dead = "http://127.0.0.1:%d" % free_port()
    try:
        for cls in (ServingClient, jserving.ServingClient):
            c = cls([dead, live.url], backoff_base_s=0.01,
                    connect_retries=2)
            assert c.generate([1, 2, 3])["tokens"] == [7]
            assert c.base_url == live.url
            n = len(live.seen)
            assert c.generate([1, 2])["tokens"] == [7]   # no retry now
            assert len(live.seen) == n + 1
        c = ServingClient([dead, dead + "/"], backoff_base_s=0.01,
                          connect_retries=1)
        with pytest.raises(urllib.error.URLError) as e:
            c.generate([1], request_id="rid42")
        assert e.value.request_id == "rid42"
        with pytest.raises(ValueError):
            ServingClient([])
    finally:
        live.stop()


def test_router_fails_over_and_passes_answers_through(router):
    dead, draining, live = _Stub(1, "reset"), _Stub(2, "draining"), \
        _Stub(3)
    try:
        for s in (dead, draining, live):
            router.add_backend(s.url)
        retries = catalog.FLEET_ROUTER_RETRIES.value(reason="connection")
        # equal loads take turns: every backend is tried in three requests
        for _ in range(6):
            st, doc, hdr = _post(router.url + "/v1/infer", {"feeds": {}},
                                 {"X-Tenant-Id": "team-a",
                                  "X-Request-Id": "req1"})
            assert st == 200 and doc["outputs"] == [[3]]
            assert hdr["X-Request-Id"] == "req1"
        assert catalog.FLEET_ROUTER_RETRIES.value(reason="connection") == \
            retries + 1
        assert router.get_backend(dead.url).health == "dead"
        assert router.get_backend(draining.url).health == "draining"
        assert all(h["X-Tenant-Id"] == "team-a" for _, h, _ in live.seen)
        live.server.mode = "e400"
        st, doc, _ = _post(router.url + "/v1/generate", {"prompt": [1]})
        assert st == 400 and doc["error"] == "bad prompt"
        # the whole fleet draining: its 503 relayed without Retry-After
        live.server.mode = "draining"
        router.get_backend(live.url).health = "ok"
        router.route_timeout_s = 0.3
        st, _, hdr = _post(router.url + "/v1/generate", {"prompt": [1]})
        assert st == 503 and "Retry-After" not in hdr
        # a spent deadline: 504 before any replica is reached
        n = len(live.seen)
        st, doc, _ = _post(router.url + "/v1/generate", {"prompt": [1]},
                           {"X-Deadline-Ms": "0"})
        assert st == 504 and doc["deadline_exceeded"]
        assert len(live.seen) == n
        # overload 503s are retried on another replica
        live.server.mode, draining.server.mode = "overload", "ok"
        for s in (live, draining):
            router.get_backend(s.url).health = "ok"
        st, doc, _ = _post(router.url + "/v1/infer", {"feeds": {}})
        assert st == 200 and doc["outputs"] == [[2]]
    finally:
        for s in (dead, draining, live):
            s.stop()


def test_prefill_hop_outcomes(router):
    pre, dec = _Stub(1), _Stub(2)
    try:
        router.add_backend(pre.url, name="prefill0", role="prefill")
        router.add_backend(dec.url, name="replica0")

        def hops():
            return {o: catalog.HANDOFF_PREFILLS.value(outcome=o)
                    for o in ("ok", "failed", "unavailable", "skipped")}
        h0 = hops()
        _post(router.url + "/v1/generate", {"prompt": [1, 2, 3, 4, 5]})
        _post(router.url + "/v1/generate", {"prompt": [1, 2]})
        assert [p for p, _, _ in pre.seen] == ["/v1/prefill"]
        assert [p for p, _, _ in dec.seen] == ["/v1/generate"] * 2
        pre.server.mode = "reset"
        st, _, _ = _post(router.url + "/v1/generate", {"prompt": [9] * 6})
        assert st == 200
        st, _, _ = _post(router.url + "/v1/generate", {"prompt": [9] * 6})
        assert st == 200
        h1 = hops()
        assert {k: h1[k] - h0[k] for k in h0} == \
            {"ok": 1, "failed": 1, "unavailable": 1, "skipped": 1}
        names = [e["args"].get("outcome") for e in tracing.trace_events()
                 if e["name"] == "handoff.prefill"]
        assert names[-3:] == ["ok", "failed", "unavailable"]
        status = router.fleet_status()
        assert status["roles"]["prefill"]["backends"] == ["prefill0"]
        assert status["handoff"]["failed"] >= 1
    finally:
        pre.stop()
        dec.stop()


def test_health_checks_eject_readmit_and_scrape(router):
    a, b = _Stub(1, queue_depth=5.0), _Stub(2)
    try:
        router.add_backend(a.url, name="replica0")
        router.add_backend(b.url, name="replica1")
        readmits = catalog.FLEET_READMISSIONS.value()
        a.server.health_state = "draining"
        router.check_once()
        assert router.get_backend(a.url).health == "draining"
        assert router.rotation_counts() == (1, 2)
        a.server.health_state = "ok"
        router.check_once()
        ba = router.get_backend(a.url)
        assert ba.health == "ok" and ba.queue_depth == 5.0
        assert ba.active_slots == 1.0
        assert catalog.FLEET_READMISSIONS.value() == readmits + 1
        b.stop()
        router.check_once()
        assert router.get_backend(b.url).health == "dead"
        # the least loaded in rotation: the only one left
        assert router._pick(set()).url == a.url
    finally:
        a.stop()


def test_router_endpoints_and_the_fleet_trace(tmp_path):
    spool = str(tmp_path / "spool")
    os.makedirs(spool)
    r = fleet.FleetRouter(("127.0.0.1", 0), check_interval_s=30.0,
                          trace_spool_dir=spool, prefix_tier_url="")
    r.start_background()
    live = _Stub(1)
    try:
        r.add_backend(live.url, name="replica0")
        st, doc, hdr = _post(r.url + "/v1/generate", {"prompt": [4, 5]},
                             {"X-Request-Id": "rq-trace"})
        assert st == 200
        # a dead replica's spooled span of the same request
        with open(os.path.join(spool, "spans_4242.jsonl"), "w") as f:
            f.write(json.dumps({"name": "gen.prefill", "ph": "X",
                                "ts": 2.0, "dur": 1.0, "pid": 4242,
                                "tid": 1, "args": {
                                    "request_id": "rq-trace",
                                    "trace_id": "rq-trace"}}) + "\n")
        trace = ServingClient(r.url).fetch_trace("rq-trace")
        lanes = {e["pid"]: e["args"]["name"] for e in trace["traceEvents"]
                 if e["ph"] == "M"}
        assert lanes[os.getpid()].startswith("router")
        assert lanes[50001].startswith("replica0")
        assert lanes[4242].startswith("spool")
        names = {e["name"] for e in trace["traceEvents"]}
        assert {"router.request", "router.attempt", "http.request",
                "gen.prefill"} <= names
        with pytest.raises(RuntimeError, match="HTTP 404"):
            ServingClient(r.url).fetch_trace("nobody")
        with urllib.request.urlopen(r.url + "/healthz") as resp:
            assert json.loads(resp.read())["replicas_live"] == 1
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(r.url + "/fleet/trace")
        assert e.value.code == 400
        m = ServingClient(r.url).metrics()
        assert m["paddle_tpu_fleet_replicas_live"] == 1.0
        text = urllib.request.urlopen(r.url + "/fleet/metrics").read() \
            .decode()
        assert 'paddle_tpu_serving_queue_depth{replica="replica0"} 0' in \
            text
        assert 'paddle_tpu_fleet_replicas_total{replica="router"} 1' in text
        status = json.loads(urllib.request.urlopen(
            r.url + "/fleet/status").read())
        assert status["replicas"][0]["version"] == {"pid": os.getpid()}
        assert status["trace_spool_dir"] == spool
    finally:
        live.stop()
        r.stop(5)


def _exited_pid():
    """The pid of a process that has exited (and been reaped)."""
    import subprocess
    p = subprocess.Popen([sys.executable, "-c", "pass"])
    p.wait()
    return p.pid


def test_prune_spool_keeps_live_writers(tmp_path):
    d = tmp_path / "spool"
    d.mkdir()
    dead = _exited_pid()
    for name in ("spans_%d.jsonl" % os.getpid(), "spans_%d.jsonl" % dead,
                 "spans_%d.jsonl.1" % dead, "other.txt"):
        (d / name).write_text("{}\n")
    fleet.prune_spool(str(d))
    assert sorted(os.listdir(d)) == ["other.txt",
                                     "spans_%d.jsonl" % os.getpid()]


# -- the supervisor over stdlib stub replicas ---------------------------------

def _stub_argv(port, serial_dir):
    argv = [sys.executable, STUB_REPLICA, "--port", str(port)]
    if serial_dir:
        argv += ["--artifact", serial_dir]
    return argv


def _wait(predicate, timeout=15.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError("timed out waiting for " + msg)


def test_supervisor_restarts_rolls_and_scales(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    (src / "weights.bin").write_bytes(b"v0")
    root = str(tmp_path / "serials")
    fleet.publish_artifact(root, str(src))
    router = fleet.FleetRouter(("127.0.0.1", 0), check_interval_s=0.1,
                               route_timeout_s=10.0, backoff_base_s=0.01,
                               backoff_cap_s=0.1)
    router.start_background()
    sup = fleet.ReplicaSupervisor(
        _stub_argv, replicas=2, prefill_replicas=1, router=router,
        artifact_root=root, check_interval_s=0.1, ready_timeout_s=20.0,
        drain_timeout_s=10.0, restart_backoff_s=0.05,
        restart_backoff_cap_s=0.2, hot_swap_poll_s=3600.0,
        log_dir=str(tmp_path / "logs"))
    try:
        sup.start()
        assert sup.current_serial == 0
        assert sorted(b.name for b in router.backends()) == \
            ["prefill0", "replica0", "replica1"]
        assert all(r.ready_s > 0 for r in sup.replicas())
        client = ServingClient(router.url)
        assert client.infer({"w": [1]})[0].tolist() == [0]
        # crash restart: the slot and its label survive
        victim = [r for r in sup.replicas() if r.slot == 0][0]
        restarts = catalog.FLEET_RESTARTS.value()
        victim.proc.kill()
        for _ in range(5):
            client.infer({"w": [1]})
        _wait(lambda: victim not in sup.replicas() and
              len(sup.replicas()) == 3, msg="replacement ready")
        assert catalog.FLEET_RESTARTS.value() == restarts + 1
        assert sorted(b.name for b in router.backends()) == \
            ["prefill0", "replica0", "replica1"]
        # a rolling hot-swap under closed-loop load: no failed request
        (src / "weights.bin").write_bytes(b"v1")
        s1, _ = fleet.publish_artifact(root, str(src))
        seen, errors, stop = [], [], threading.Event()

        def load():
            c = ServingClient(router.url)
            while not stop.is_set():
                try:
                    seen.append(int(c.infer({"w": [1]})[0][0]))
                except Exception as e:
                    errors.append(e)
        threads = [threading.Thread(target=load) for _ in range(3)]
        for t in threads:
            t.start()
        swaps = catalog.FLEET_HOT_SWAPS.value()
        old = sup.replicas()
        assert sup.hot_swap() == 3
        stop.set()
        for t in threads:
            t.join(10)
        assert not errors and set(seen) <= {0, 1} and seen
        assert all(r.proc.returncode == 0 for r in old)
        assert catalog.FLEET_HOT_SWAPS.value() == swaps + 3
        assert sup.current_serial == s1 == 1
        assert client.infer({"w": [1]})[0].tolist() == [1]
        # scaling counts decode replicas; the prefill one stays
        assert sup.scale_to(3) == 3
        assert sorted(b.name for b in router.backends()) == \
            ["prefill0", "replica0", "replica1", "replica2"]
        assert sup.scale_to(1) == 1
        assert sorted(b.name for b in router.backends()) == \
            ["prefill0", "replica0"]
        assert sup.describe()["serial"] == 1
    finally:
        sup.stop()
        router.stop(5)


def test_supervisor_start_reports_a_replica_that_never_gets_ready(
        tmp_path):
    def argv(port, serial_dir):
        return [sys.executable, "-c", "import sys; print('no card'); "
                "sys.exit(3)"]
    sup = fleet.ReplicaSupervisor(argv, replicas=1, ready_timeout_s=10.0,
                                  log_dir=str(tmp_path / "logs"))
    with pytest.raises(RuntimeError, match="no card"):
        sup.start()
    assert sup.replicas() == []


# -- two real port replicas, one SIGKILLed ------------------------------------

def test_real_replicas_survive_a_sigkill_and_merge_the_trace(tmp_path):
    from paddle_tpu_torch.serving import PagedDecodeEngine, \
        greedy_generate, load_decoder
    d = _decoder(str(tmp_path / "decoder"))
    spool = str(tmp_path / "spool")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["PADDLE_TPU_TRACE_SPOOL"] = spool
    geometry = ["--gen-max-slots", "4", "--gen-max-len", "64",
                "--gen-prefill-buckets", "16,32", "--gen-page-size", "8",
                "--gen-paged"]

    def argv(port, serial_dir):
        return [sys.executable, "-m", "paddle_tpu_torch.serving.serve",
                "--generation-model", d, "--device", "cpu", "--port",
                str(port)] + geometry

    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, 64, int(n)).astype(np.int32)
               for n in rng.randint(3, 20, size=6)]
    model, params = load_decoder(d, device="cpu")
    eng = PagedDecodeEngine(model, params, max_slots=6, max_len=64,
                            prefill_buckets=(16, 32), page_size=8,
                            device="cpu")
    ref = greedy_generate(eng, prompts, 6)
    router = fleet.FleetRouter(("127.0.0.1", 0), check_interval_s=0.2,
                               route_timeout_s=60.0, backoff_base_s=0.02,
                               backoff_cap_s=0.2, trace_spool_dir=spool)
    router.start_background()
    sup = fleet.ReplicaSupervisor(argv, replicas=2, router=router,
                                  check_interval_s=0.2, ready_timeout_s=60.0,
                                  drain_timeout_s=20.0, env=env,
                                  log_dir=str(tmp_path / "logs"))
    try:
        sup.start()
        got, errors, done = [], [], [0]
        jobs = list(range(24))
        lock = threading.Lock()

        def load():
            c = ServingClient([router.url], timeout=60.0)
            while True:
                with lock:
                    if not jobs:
                        return
                    k = jobs.pop(0)
                try:
                    r = c.generate(prompts[k % 6], max_new_tokens=6)
                    got.append((k % 6, r))
                except Exception as e:
                    errors.append(e)
                with lock:
                    done[0] += 1
        threads = [threading.Thread(target=load) for _ in range(3)]
        for t in threads:
            t.start()
        _wait(lambda: done[0] >= 4, timeout=60.0, msg="first answers")
        victim = sup.replicas()[0]
        os.kill(victim.proc.pid, signal.SIGKILL)
        for t in threads:
            t.join(120)
        assert not errors, errors[0]
        assert len(got) == 24
        assert all(r["tokens"] == ref[i] for i, r in got)
        _wait(lambda: victim not in sup.replicas() and
              len(sup.replicas()) == 2, timeout=60.0,
              msg="the killed replica replaced")
        rid = got[-1][1]["request_id"]
        trace = ServingClient(router.url).fetch_trace(rid)
        lanes = {e["pid"]: e["args"]["name"] for e in trace["traceEvents"]
                 if e["ph"] == "M"}
        pids = {r.proc.pid for r in sup.replicas()} | {victim.proc.pid}
        assert os.getpid() in lanes and pids & set(lanes)
        assert {"router.request", "http.request"} <= \
            {e["name"] for e in trace["traceEvents"]}
    finally:
        sup.stop()
        router.stop(5)
    logs = "".join(open(os.path.join(tmp_path / "logs", fn)).read()
                   for fn in os.listdir(tmp_path / "logs"))
    assert "serve: kernel launches k3=0 k3_quant=0 device=cpu" in logs
