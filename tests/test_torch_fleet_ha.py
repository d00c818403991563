"""Fleet HA in the port (``paddle_tpu_torch.serving.registry`` and the HA
half of ``serving.fleet``) against the JAX reference on the CPU, case for
case with ``tests/serving/test_fleet_ha.py``:

* the knobs: defaults, validation and messages equal the reference's,
  ``which=`` scoping, and a router that never resolves the lease knob;
* the registry: round trip, torn and bit-flipped records invisible, stale
  heartbeats filtered, a stale writer rejected;
* the lease: hold/renew/release, expiry and the loser's demotion, renewal
  after expiry re-contending, and the settle race with one winner;
* records and leases cross the packages BITWISE both ways;
* the router's membership sync, its ``/fleet/status`` control-plane view
  and the tier URL taken from a ``role=cache`` record;
* the supervisor over the reference's stdlib stub replica: standby
  takeover and adoption by the same pids, backoff gates kept and dead
  records replaced, an unready replica declined and signalled, a scale-down
  withdrawal, a stale supervisor dropping a taken-over replica unharmed;
  ``_AdoptedProc`` counting a zombie as dead;
* the CLIs: ``--standby`` needs ``--registry-dir``; the tier publishes and
  withdraws its ``role=cache`` record;
* one end-to-end run: two port fleet CLIs over one registry in front of
  two real ``--device cpu`` replicas (a 2-layer 64-wide decoder), the
  active CLI SIGKILLed under load, the standby adopting the same pids with
  zero failed requests and streams equal to an in-process engine.
"""

from tests import torch_threads  # noqa: F401  (first)
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

from paddle_tpu import flags as jflags
from paddle_tpu.serving import registry as jregistry
from paddle_tpu_torch import flags
from paddle_tpu_torch.observability import catalog
from paddle_tpu_torch.observability.http import BackgroundHTTPServer, \
    JsonHTTPHandler, free_port
from paddle_tpu_torch.serving import ServingClient, fleet, prefix_tier
from paddle_tpu_torch.serving import registry as pregistry
from paddle_tpu_torch.serving.registry import Lease, ReplicaRegistry, \
    StaleIncarnationError, resolve_fleet_knobs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUB_REPLICA = os.path.join(REPO, "tests", "serving", "_stub_replica.py")


class _FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


# -- knobs ---------------------------------------------------------------------

def test_resolve_fleet_knobs_defaults_and_validation():
    knobs = resolve_fleet_knobs()
    ref = jregistry.resolve_fleet_knobs()
    assert knobs["registry_dir"] == ref["registry_dir"] == ""
    assert knobs["lease_secs"] == ref["lease_secs"] == 5.0
    assert set(knobs) == set(ref)
    for bad in ({"lease_secs": 0.0}, {"lease_secs": "x"},
                {"registry_dir": 3}, {"shed_high_watermark": 1.5},
                {"shed_token_cap": 0}, {"deadline_default_ms": -1}):
        with pytest.raises(ValueError) as got:
            resolve_fleet_knobs(**bad)
        with pytest.raises(ValueError) as want:
            jregistry.resolve_fleet_knobs(**bad)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="fleet_lease_secs"):
        resolve_fleet_knobs(lease_secs=0.0)


def test_resolve_fleet_knobs_which_scopes_validation(monkeypatch):
    # a broken SUPERVISOR-only flag must not fail a process that reads
    # only other knobs...
    monkeypatch.setattr(flags, "fleet_lease_secs", 0.0)
    monkeypatch.setattr(jflags, "fleet_lease_secs", 0.0)
    which = ("shed_retry_floor_s", "shed_retry_cap_s", "registry_dir")
    assert resolve_fleet_knobs(which=which) == \
        jregistry.resolve_fleet_knobs(which=which)
    # ...while an in-scope violation raises, naming the flag, and an
    # unknown name is an error, not a silent no-op
    for pkg in (pregistry, jregistry):
        with pytest.raises(ValueError, match="FLAGS_fleet_lease_secs"):
            pkg.resolve_fleet_knobs(which=("lease_secs",))
        with pytest.raises(ValueError, match="unknown fleet knob"):
            pkg.resolve_fleet_knobs(which=("lease_seconds",))


def test_lease_reader_and_router_skip_lease_knob(tmp_path, monkeypatch):
    """A router DISPLAYS the lease and never contends: a broken lease flag
    does not fail its construction (``Lease.reader``)."""
    monkeypatch.setattr(flags, "fleet_lease_secs", 0.0)
    reg = ReplicaRegistry(str(tmp_path), ttl_s=30.0, holder="sup:1")
    Lease(reg.lease_path(), lease_secs=2.0, holder="sup:1",
          settle_s=0.0).try_acquire()
    router = fleet.FleetRouter(("127.0.0.1", 0), check_interval_s=30.0,
                               registry=reg)
    router.start_background()
    try:
        with urllib.request.urlopen(router.url + "/fleet/status",
                                    timeout=10) as r:
            doc = json.loads(r.read())
        assert doc["lease"]["holder"] == "sup:1"
    finally:
        router.stop(5)


# -- registry ------------------------------------------------------------------

def test_registry_roundtrip_and_torn_record_invisible(tmp_path):
    clock = _FakeClock()
    reg = ReplicaRegistry(str(tmp_path), ttl_s=10.0, clock=clock,
                          holder="sup:1")
    reg.publish(0, "http://127.0.0.1:1000", pid=111, serial=3)
    reg.publish(1, "http://127.0.0.1:1001", state="backoff", failures=2,
                not_before_unix=clock() + 30.0)
    recs = reg.records()
    assert [r["slot"] for r in recs] == [0, 1]
    assert recs[0]["pid"] == 111 and recs[0]["serial"] == 3
    assert recs[1]["failures"] == 2
    with pytest.raises(ValueError, match="role"):
        reg.publish(2, "http://x", role="router")
    # a torn record (truncated JSON that bypassed the tmp protocol) is
    # invisible, and so is a bit-flipped one (md5 mismatch)
    torn = os.path.join(str(tmp_path), "replicas", "slot_2.json")
    with open(torn, "w") as f:
        f.write('{"payload": {"slot": 2, "url": "http')
    assert reg.read(2) is None
    assert [r["slot"] for r in reg.records()] == [0, 1]
    with open(torn, "w") as f:
        json.dump({"payload": {"slot": 2, "url": "x"}, "md5": "0" * 32}, f)
    assert reg.read(2) is None
    doc = reg.describe()
    assert doc["age_s"] == 0.0
    backoff = [r for r in doc["records"] if r["state"] == "backoff"][0]
    assert backoff["not_before_in_s"] == pytest.approx(30.0)


def test_registry_stale_heartbeats_filtered_and_stale_writer_rejected(
        tmp_path):
    clock = _FakeClock()
    old = ReplicaRegistry(str(tmp_path), ttl_s=5.0, clock=clock,
                          holder="old:1")
    nonce_old = old.publish(0, "http://127.0.0.1:1000")
    clock.t += 6.0
    assert old.records() and not old.records(live_only=True)
    assert old.age_s() == pytest.approx(6.0)
    new = ReplicaRegistry(str(tmp_path), ttl_s=5.0, clock=clock,
                          holder="new:2")
    new.publish(0, "http://127.0.0.1:1000", failures=1)
    with pytest.raises(StaleIncarnationError, match="new:2"):
        old.heartbeat(0, nonce_old)
    with pytest.raises(StaleIncarnationError):
        old.withdraw(0, nonce_old)
    assert new.read(0)["holder"] == "new:2"
    new.withdraw(0)
    assert new.read(0) is None
    with pytest.raises(StaleIncarnationError, match="gone"):
        old.heartbeat(0, nonce_old)


# -- lease ---------------------------------------------------------------------

def _pair(tmp_path, clock, secs):
    path = str(tmp_path / "supervisor.lease")
    return [Lease(path, lease_secs=secs, holder=h, clock=clock,
                  settle_s=0.0) for h in ("a:1", "b:2")]


def test_lease_hold_renew_release_cycle(tmp_path):
    clock = _FakeClock()
    a, b = _pair(tmp_path, clock, 2.0)
    assert a.expired() and a.try_acquire() and a.held()
    assert a.read()["seq"] == 1
    assert not b.try_acquire() and not b.held()
    assert a.try_acquire()
    clock.t += 1.5
    assert a.renew()
    clock.t += 1.5
    assert a.held()
    assert a.describe()["expires_in_s"] == pytest.approx(0.5)
    a.release()
    assert b.try_acquire() and b.held() and not a.held()
    assert b.read()["seq"] == 2


def test_expired_lease_acquirable_and_loser_demoted(tmp_path):
    clock = _FakeClock()
    a, b = _pair(tmp_path, clock, 1.0)
    assert a.try_acquire()
    clock.t += 1.01
    assert a.expired()
    assert b.try_acquire()
    assert b.read()["holder"] == "b:2"
    assert not a.renew() and not a.held()


def test_lease_renew_after_expiry_recontends(tmp_path):
    clock = _FakeClock()
    a, b = _pair(tmp_path, clock, 1.0)
    assert a.try_acquire()
    nonce1 = a.read()["nonce"]
    clock.t += 1.5
    assert a.renew() and a.held()
    assert a.read()["nonce"] != nonce1
    assert a.read()["seq"] == 2
    clock.t += 1.5
    assert b.try_acquire()
    assert not a.renew() and not a.held() and b.held()


def test_lease_settle_race_exactly_one_winner(tmp_path):
    path = str(tmp_path / "supervisor.lease")
    barrier = threading.Barrier(3)
    leases = [Lease(path, lease_secs=5.0, holder="h%d" % i, settle_s=0.5)
              for i in range(3)]
    results = [None] * 3

    def contend(i):
        barrier.wait(10)
        results[i] = leases[i].try_acquire()

    threads = [threading.Thread(target=contend, args=(i,))
               for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert sum(bool(r) for r in results) == 1
    winner = results.index(True)
    assert leases[winner].held()
    assert leases[winner].read()["holder"] == "h%d" % winner


# -- records across the packages -----------------------------------------------

def _write_all(pkg, root, clock):
    reg = pkg.ReplicaRegistry(root, ttl_s=10.0, clock=clock, holder="h:7")
    reg.publish(0, "http://127.0.0.1:1000", pid=111, serial=3,
                incarnation="feedfacecafebeef")
    reg.publish(1001, "http://127.0.0.1:1001", state="backoff", failures=2,
                not_before_unix=1030.5, incarnation="0123456789abcdef",
                role="prefill")
    reg.publish(2000, "http://127.0.0.1:8700", pid=5, role="cache",
                incarnation="00000000000000aa")
    reg.heartbeat(0, "feedfacecafebeef", state="ready", failures=1)
    lease = pkg.Lease(reg.lease_path(), lease_secs=2.0, holder="h:7",
                      clock=clock, settle_s=0.0)
    assert lease.try_acquire()
    clock.t += 0.5
    assert lease.renew()
    return reg


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_records_and_leases_cross_the_packages_bitwise(tmp_path, writer,
                                                        monkeypatch):
    """Both packages write the same bytes for the same records and lease
    (nonces pinned), and each reads what the other wrote."""
    for pkg in (jregistry, pregistry):
        monkeypatch.setattr(pkg, "_new_nonce", lambda: "5eed5eed5eed5eed")
    roots = {}
    for name, pkg in (("reference", jregistry), ("port", pregistry)):
        roots[name] = str(tmp_path / name)
        _write_all(pkg, roots[name], _FakeClock())
    files = sorted(os.path.relpath(os.path.join(d, f), roots["port"])
                   for d, _, fs in os.walk(roots["port"]) for f in fs)
    assert files == ["replicas/slot_0.json", "replicas/slot_1001.json",
                     "replicas/slot_2000.json", "supervisor.lease"]
    for rel in files:
        with open(os.path.join(roots["reference"], rel), "rb") as f:
            want = f.read()
        with open(os.path.join(roots["port"], rel), "rb") as f:
            assert f.read() == want, rel
    reader = pregistry if writer == "reference" else jregistry
    clock = _FakeClock(1000.5)
    reg = reader.ReplicaRegistry(roots[writer], ttl_s=10.0, clock=clock,
                                 holder="other:9")
    recs = reg.records(live_only=True)
    assert [(r["slot"], r["role"], r["state"]) for r in recs] == \
        [(0, "both", "ready"), (1001, "prefill", "backoff"),
         (2000, "cache", "ready")]
    assert recs[0]["failures"] == 1 and recs[0]["pid"] == 111
    # the other package's writer guard holds across the packages too
    reg.heartbeat(0, "feedfacecafebeef")
    with pytest.raises(reader.StaleIncarnationError):
        reg.heartbeat(1001, "not-the-owner")
    lease = reader.Lease(reg.lease_path(), lease_secs=2.0,
                         holder="other:9", clock=clock, settle_s=0.0)
    assert lease.read()["holder"] == "h:7" and lease.read()["seq"] == 1
    assert not lease.try_acquire()
    clock.t += 2.5
    assert lease.try_acquire() and lease.read()["seq"] == 2


# -- the router ----------------------------------------------------------------

class _Healthy(JsonHTTPHandler):

    def do_GET(self):
        if self.path == "/healthz":
            self._send_json(200, {"status": "ok", "ready": True})
        elif self.path == "/v1/prefix/stats":
            self._send_json(200, {"entries": 7})
        else:
            self._send(200, "", content_type="text/plain")


def _healthy():
    srv = BackgroundHTTPServer(("127.0.0.1", 0), _Healthy)
    srv.start_background("healthy-stub")
    return srv


def _dead_url():
    return "http://127.0.0.1:%d" % free_port()


def test_router_syncs_membership_and_status_shows_control_plane(tmp_path):
    reg = ReplicaRegistry(str(tmp_path), ttl_s=30.0, holder="sup:1")
    lease = Lease(reg.lease_path(), lease_secs=5.0, holder="sup:1",
                  settle_s=0.0)
    assert lease.try_acquire()
    stub, tier = _healthy(), _healthy()
    router = fleet.FleetRouter(("127.0.0.1", 0), check_interval_s=30.0,
                               registry=reg,
                               prefix_tier_url="http://127.0.0.1:9")
    router.start_background()
    try:
        reg.publish(0, stub.url, pid=4242, state="ready")
        reg.publish(1, "http://127.0.0.1:9", state="backoff", failures=3,
                    not_before_unix=time.time() + 45.0)
        reg.publish(prefix_tier.CACHE_SLOT, tier.url, pid=77, role="cache")
        router.check_once()
        # ready records become backends named by slot; backoff and cache
        # records route nothing; the cache record names the tier
        assert [b.name for b in router.backends()] == ["replica0"]
        assert router.tier_url() == tier.url
        with urllib.request.urlopen(router.url + "/fleet/status",
                                    timeout=10) as r:
            doc = json.loads(r.read())
        assert doc["lease"]["holder"] == "sup:1"
        assert doc["lease"]["expires_in_s"] > 0
        assert doc["registry"]["age_s"] is not None
        assert doc["roles"]["cache_tier"]["url"] == tier.url
        assert doc["roles"]["cache_tier"]["stats"] == {"entries": 7}
        by_slot = {rec["slot"]: rec for rec in doc["registry"]["records"]}
        assert by_slot[0]["pid"] == 4242
        assert 0 < by_slot[1]["not_before_in_s"] <= 45.0
        assert by_slot[1]["failures"] == 3
        # a takeover re-publishes under a NEW incarnation: the router
        # keeps the SAME backend object (health state and breaker)
        backend = router.backends()[0]
        backend.breaker.record_failure()
        ReplicaRegistry(str(tmp_path), ttl_s=30.0,
                        holder="sup:2").publish(0, stub.url, pid=4242)
        router.sync_registry()
        assert router.backends()[0] is backend
        assert backend.breaker._failures == 1
        # withdrawn records leave rotation; a withdrawn tier record falls
        # back to the configured URL
        reg.withdraw(1)
        reg.withdraw(prefix_tier.CACHE_SLOT)
        ReplicaRegistry(str(tmp_path), ttl_s=30.0,
                        holder="sup:2").withdraw(0)
        router.sync_registry()
        assert router.backends() == []
        assert router.tier_url() == "http://127.0.0.1:9"
        # a backend the co-located supervisor added becomes registry-owned
        # once a record names it, and leaves with the record
        router.add_backend(stub.url, name="replica0")
        reg.publish(0, stub.url, pid=4242)
        router.sync_registry()
        assert [b.name for b in router.backends()] == ["replica0"]
        reg.withdraw(0)
        router.sync_registry()
        assert router.backends() == []
    finally:
        stub.stop(5)
        tier.stop(5)
        router.stop(5)


def test_stale_tier_record_ages_out(tmp_path):
    clock = _FakeClock(time.time() - 60.0)
    old = ReplicaRegistry(str(tmp_path), ttl_s=10.0, clock=clock,
                          holder="tier:1")
    old.publish(prefix_tier.CACHE_SLOT, "http://127.0.0.1:9", role="cache")
    reg = ReplicaRegistry(str(tmp_path), ttl_s=10.0)
    router = fleet.FleetRouter(("127.0.0.1", 0), registry=reg)
    try:
        router.sync_registry()
        assert router.tier_url() is None
    finally:
        router.server_close()


# -- the supervisor ------------------------------------------------------------

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


def _make_ha_sup(tmp_path, reg, router=None, n=2, standby=False,
                 lease_secs=0.6, check_interval_s=0.05):
    return fleet.ReplicaSupervisor(
        _stub_argv, replicas=n, router=router, registry=reg,
        lease_secs=lease_secs, standby=standby,
        check_interval_s=check_interval_s, ready_timeout_s=20.0,
        drain_timeout_s=10.0, restart_backoff_s=0.05,
        restart_backoff_cap_s=0.2, hot_swap_poll_s=3600.0,
        adopt_ready_timeout_s=2.0, log_dir=str(tmp_path / "logs"))


def test_standby_needs_a_registry():
    with pytest.raises(ValueError, match="registry"):
        fleet.ReplicaSupervisor(_stub_argv, standby=True)


def test_standby_takes_over_lease_and_adopts_fleet(tmp_path):
    root = str(tmp_path / "registry")
    reg_a = ReplicaRegistry(root, ttl_s=30.0, holder="supA:1")
    reg_b = ReplicaRegistry(root, ttl_s=30.0, holder="supB:2")
    router_b = fleet.FleetRouter(("127.0.0.1", 0), check_interval_s=30.0)
    router_b.start_background()
    sup_a = _make_ha_sup(tmp_path, reg_a, n=2)
    sup_b = _make_ha_sup(tmp_path, reg_b, router=router_b, n=2,
                         standby=True)
    try:
        sup_a.start()
        assert not sup_a.is_standby()
        pids = sorted(r.proc.pid for r in sup_a.replicas())
        sup_a.replicas()[0].failures = 2
        _wait(lambda: any((reg_a.read(s) or {}).get("failures") == 2
                          for s in (0, 1)),
              msg="heartbeat to publish the crash counter")
        sup_b.start()
        assert sup_b.is_standby() and sup_b.replicas() == []
        takeovers = catalog.LEASE_TAKEOVERS.value()
        adopted = catalog.REPLICAS_ADOPTED.value()
        restarts = catalog.FLEET_RESTARTS.value()
        # supA "dies": its watch thread stops renewing (the replicas, its
        # children, keep serving)
        sup_a._stop.set()
        sup_a._watch_thread.join(10)
        _wait(lambda: not sup_b.is_standby(), timeout=20.0,
              msg="standby to win the expired lease")
        _wait(lambda: len(sup_b.replicas()) == 2, timeout=20.0,
              msg="standby to adopt both replicas")
        assert sorted(r.proc.pid for r in sup_b.replicas()) == pids
        assert sorted(r.failures for r in sup_b.replicas()) == [0, 2]
        assert catalog.LEASE_TAKEOVERS.value() == takeovers + 1
        assert catalog.REPLICAS_ADOPTED.value() == adopted + 2
        assert catalog.FLEET_RESTARTS.value() == restarts
        assert sup_b.lease.held()
        assert sorted(b.name for b in router_b.backends()) == \
            ["replica0", "replica1"]
        assert all(reg_b.read(s)["holder"] == "supB:2" for s in (0, 1))
        doc = sup_b.describe()
        assert doc["standby"] is False
        assert doc["lease"]["holder"] == "supB:2"
    finally:
        sup_b.stop()
        sup_a.stop()
        router_b.stop(5)


def test_adoption_preserves_backoff_gate_and_replaces_dead(tmp_path):
    root = str(tmp_path / "registry")
    prev = ReplicaRegistry(root, ttl_s=30.0, holder="dead:9")
    prev.publish(0, "http://127.0.0.1:9", state="backoff", failures=3,
                 not_before_unix=time.time() + 30.0)
    prev.publish(1, _dead_url(), pid=None, state="ready")
    reg = ReplicaRegistry(root, ttl_s=30.0, holder="supC:3")
    restarts = catalog.FLEET_RESTARTS.value()
    adopted = catalog.REPLICAS_ADOPTED.value()
    sup = _make_ha_sup(tmp_path, reg, n=2)
    sup.adopt_ready_timeout_s = 0.3
    try:
        sup.start()
        pending = sup.describe()["pending_respawn"]
        assert [p["slot"] for p in pending] == [0]
        assert pending[0]["failures"] == 3
        assert 0 < pending[0]["not_before_in_s"] <= 30.0
        live = sup.replicas()
        assert len(live) == 1 and live[0].slot == 1
        assert catalog.REPLICAS_ADOPTED.value() == adopted
        assert catalog.FLEET_RESTARTS.value() == restarts
        assert reg.read(1)["holder"] == "supC:3"
        assert reg.read(0)["failures"] == 3
    finally:
        sup.stop()


def test_adoption_signals_unready_replica_it_declines(tmp_path):
    root = str(tmp_path / "registry")
    straggler = subprocess.Popen([sys.executable, "-c",
                                  "import time; time.sleep(120)"])
    prev = ReplicaRegistry(root, ttl_s=30.0, holder="dead:9")
    prev.publish(0, _dead_url(), pid=straggler.pid, state="ready")
    reg = ReplicaRegistry(root, ttl_s=30.0, holder="supG:7")
    sup = _make_ha_sup(tmp_path, reg, n=1)
    sup.adopt_ready_timeout_s = 0.3
    try:
        sup.start()
        assert straggler.wait(10) == -signal.SIGTERM
        assert len(sup.replicas()) == 1
    finally:
        if straggler.poll() is None:
            straggler.kill()
            straggler.wait(10)
        sup.stop()


def test_scale_down_drop_of_pending_respawn_withdraws_record(tmp_path):
    root = str(tmp_path / "registry")
    reg = ReplicaRegistry(root, ttl_s=30.0, holder="supF:6")
    sup = _make_ha_sup(tmp_path, reg, n=2, check_interval_s=0.05)
    sup.restart_backoff_s = 0.6
    sup.restart_backoff_cap_s = 0.6
    try:
        sup.start()
        victim = sup.replicas()[0]
        victim.proc.kill()
        _wait(lambda: any(p["state"] == "backoff" for p in
                          sup.describe()["pending_respawn"]) or
              (reg.read(victim.slot) or {}).get("state") == "backoff",
              msg="crash to queue a pending respawn")
        sup.scale_to(1)
        _wait(lambda: not sup.describe()["pending_respawn"] and
              reg.read(victim.slot) is None, timeout=20.0,
              msg="dropped pending respawn to withdraw its record")
        assert len(sup.replicas()) == 1
    finally:
        sup.stop()


def test_stale_supervisor_drops_taken_over_replica_unharmed(tmp_path):
    root = str(tmp_path / "registry")
    reg = ReplicaRegistry(root, ttl_s=30.0, holder="supD:4")
    sup = _make_ha_sup(tmp_path, reg, n=1, check_interval_s=3600.0)
    rep = None
    try:
        sup.start()
        (rep,) = sup.replicas()
        ReplicaRegistry(root, ttl_s=30.0, holder="supE:5").publish(
            0, rep.url, pid=rep.proc.pid)
        sup._publish_registry()
        assert sup.replicas() == []
        assert rep.proc.poll() is None
        assert reg.read(0)["holder"] == "supE:5"
    finally:
        if rep is not None and rep.proc.poll() is None:
            rep.proc.kill()
            rep.proc.wait(10)
        sup.stop()


def test_adopted_proc_counts_a_zombie_as_dead():
    child = subprocess.Popen([sys.executable, "-c", "pass"])
    proc = fleet._AdoptedProc(child.pid)
    # the child exits unreaped: a zombie that kill(pid, 0) still finds
    _wait(lambda: open("/proc/%d/stat" % child.pid).read().rsplit(
        ")", 1)[1].split()[0] == "Z", msg="the child to exit")
    os.kill(child.pid, 0)
    assert proc.poll() == -1 and proc.wait(1) == -1
    child.wait(10)
    assert fleet._AdoptedProc(None).poll() == -1


# -- the CLIs ------------------------------------------------------------------

def test_fleet_cli_standby_requires_registry_dir(tmp_path, capsys):
    with pytest.raises(SystemExit):
        fleet.main(["--generation-model", str(tmp_path), "--standby"])
    assert "--standby requires --registry-dir" in capsys.readouterr().err


def test_tier_cli_publishes_and_withdraws_its_cache_record(tmp_path):
    reg_dir = str(tmp_path / "registry")
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving.prefix_tier",
         "--store-dir", str(tmp_path / "store"), "--port", "0",
         "--registry-dir", reg_dir, "--sweep-interval-s", "1"],
        env=_env(), stderr=subprocess.PIPE, text=True)
    try:
        reg = ReplicaRegistry(reg_dir)
        _wait(lambda: reg.read(prefix_tier.CACHE_SLOT) is not None,
              timeout=60.0, msg="the tier's record")
        rec = reg.read(prefix_tier.CACHE_SLOT)
        assert rec["role"] == "cache" and rec["pid"] == proc.pid
        beat = rec["heartbeat_unix"]
        _wait(lambda: reg.read(prefix_tier.CACHE_SLOT)["heartbeat_unix"]
              > beat, timeout=10.0, msg="a heartbeat")
        with urllib.request.urlopen(rec["url"] + "/healthz",
                                    timeout=10) as r:
            assert r.status == 200
        # the reference's reader sees the same record
        assert jregistry.ReplicaRegistry(reg_dir).read(
            prefix_tier.CACHE_SLOT)["url"] == rec["url"]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(30) == 0
        assert reg.read(prefix_tier.CACHE_SLOT) is None
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)


# -- two fleet CLIs over one registry, the active one SIGKILLed ----------------

def _status(url):
    with urllib.request.urlopen(url + "/fleet/status", timeout=30) as r:
        return json.loads(r.read())


def _up(url, n):
    """Does the router at ``url`` answer, with ``n`` reachable replicas
    that the registry names?"""
    try:
        doc = _status(url)
    except OSError:
        return False
    return len(_record_pids(doc)) == n and \
        len([r for r in doc["replicas"] if r["reachable"]]) == n


def _record_pids(doc):
    return sorted(r["pid"] for r in doc["registry"]["records"]
                  if r.get("role") != "cache")


def test_standby_cli_adopts_the_fleet_of_a_sigkilled_cli(tmp_path):
    from paddle_tpu_torch.serving import PagedDecodeEngine, \
        TransformerDecoderModel, greedy_generate, load_decoder, save_decoder
    d = str(tmp_path / "decoder")
    m = TransformerDecoderModel(64, dim=64, n_heads=2, n_layers=2)
    save_decoder(d, m, m.init_params(0, device="cpu"))
    reg_dir = str(tmp_path / "registry")
    geometry = ["--gen-max-slots", "4", "--gen-max-len", "64",
                "--gen-prefill-buckets", "16,32", "--gen-page-size", "8"]
    ports = [free_port(), free_port()]
    urls = ["http://127.0.0.1:%d" % p for p in ports]

    def cli(i, extra):
        argv = [sys.executable, "-m", "paddle_tpu_torch.serving.fleet",
                "--generation-model", d, "--gen-paged", "--replicas", "2",
                "--device", "cpu", "--port", str(ports[i]),
                "--registry-dir", reg_dir, "--lease-secs", "2",
                "--check-interval-s", "0.2", "--trace-spool-dir", "off",
                "--log-dir", str(tmp_path / ("logs%d" % i))] + \
            ["--serve-arg=%s" % a for a in geometry] + extra
        return subprocess.Popen(argv, env=_env(), stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)

    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, 64, int(n)).astype(np.int32)
               for n in rng.randint(3, 20, size=6)]
    model, params = load_decoder(d, device="cpu")
    eng = PagedDecodeEngine(model, params, max_slots=6, max_len=64,
                            prefill_buckets=(16, 32), page_size=8,
                            device="cpu")
    ref = greedy_generate(eng, prompts, 6)
    procs = [cli(0, [])]
    replica_pids = []
    try:
        _wait(lambda: _up(urls[0], 2), timeout=120.0, msg="fleet A ready")
        doc = _status(urls[0])
        holder = doc["lease"]["holder"]
        replica_pids = _record_pids(doc)
        procs.append(cli(1, ["--standby"]))
        _wait(lambda: _up(urls[1], 2), timeout=60.0,
              msg="standby B to serve the registry's membership")
        assert _status(urls[1])["lease"]["holder"] == holder
        got, errors, done = [], [], [0]
        jobs = list(range(24))
        lock = threading.Lock()

        def load():
            c = ServingClient(urls, timeout=60.0)
            while True:
                with lock:
                    if not jobs:
                        return
                    k = jobs.pop(0)
                try:
                    got.append((k % 6, c.generate(prompts[k % 6],
                                                  max_new_tokens=6)))
                except Exception as e:
                    errors.append(e)
                with lock:
                    done[0] += 1

        threads = [threading.Thread(target=load) for _ in range(3)]
        for t in threads:
            t.start()
        _wait(lambda: done[0] >= 4, timeout=60.0, msg="first answers")
        os.kill(procs[0].pid, signal.SIGKILL)   # the CLI alone
        procs[0].wait(10)
        for t in threads:
            t.join(120)
        assert not errors, errors[0]
        assert len(got) == 24
        assert all(r["tokens"] == ref[i] for i, r in got)
        _wait(lambda: _status(urls[1])["lease"]["holder"].endswith(
            ":%d" % procs[1].pid), timeout=30.0, msg="B takes the lease")
        _wait(lambda: all(r["holder"].endswith(":%d" % procs[1].pid)
                          for r in _status(urls[1])["registry"]["records"]),
              timeout=30.0, msg="B re-publishes both records")
        doc = _status(urls[1])
        assert _record_pids(doc) == replica_pids
        metrics = ServingClient(urls[1]).metrics()
        assert metrics["paddle_tpu_lease_takeovers_total"] == 1.0
        assert metrics["paddle_tpu_replicas_adopted_total"] == 2.0
        assert metrics.get("paddle_tpu_fleet_restarts_total", 0.0) == 0.0
        out = ServingClient(urls[1]).generate(prompts[0], max_new_tokens=6)
        assert out["tokens"] == ref[0]
        # B's SIGTERM drains the adopted replicas it never spawned
        procs[1].send_signal(signal.SIGTERM)
        assert procs[1].wait(60) == 0
        _wait(lambda: all(fleet._AdoptedProc(p).poll() == -1
                          for p in replica_pids), timeout=30.0,
              msg="the adopted replicas to exit")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
        for pid in replica_pids:
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass
