"""The serving fleet — a health-checked router, a replica supervisor and
zero-downtime hot-swap (the port of ``paddle_tpu/serving/fleet.py`` and of
``tools/fleet.py``, with the control plane's HA).

One ``serve`` process is one process: its death drops every in-flight
request. The fleet runs N of them behind one router:

* replicas are ``python -m paddle_tpu_torch.serving.serve`` subprocesses
  whose ``/healthz`` tells ok from draining;
* the **router** (:class:`FleetRouter`) is a stdlib HTTP tier in front of
  them: it spreads ``/v1/infer`` and ``/v1/generate`` by the queue gauges
  scraped from each replica's ``/metrics``, prefers the replica a prompt's
  leading tokens hash to (prefix affinity), hands long prompts to a
  prefill replica first (the ``/v1/prefill`` hop), retries 503s and
  connection failures on another replica with capped, jittered backoff,
  and ejects and readmits replicas with a per-backend circuit breaker. It
  serves ``/healthz``, ``/metrics``, ``/fleet/metrics`` (every replica's
  page merged), ``/fleet/status`` and ``/fleet/trace?request_id=`` (one
  chrome-trace of the request across the router and every replica, dead
  ones included through the span spool);
* the **supervisor** (:class:`ReplicaSupervisor`) owns the processes:
  spawn and wait until ready, restart a crashed replica with capped
  backoff, scale, and roll the fleet onto a newer artifact serial
  (:func:`publish_artifact`) one replica at a time, replacement first, so
  capacity never dips below N.

Nothing in the router or the supervisor touches a tensor: the router
proxies bytes and the supervisor runs subprocesses. Every replica runs on
the device its argv names (``--device cuda`` by default from the CLI); a
replica that finds no card there exits non-zero and the supervisor reports
a failed start.

Fleet HA: with a shared replica registry (``registry=``, the CLI's
``--registry-dir``; ``serving/registry.py``) several fleet processes run
over one fleet. Every router syncs its membership from the registry's
records (and the prefix tier's URL from its ``role=cache`` record); exactly
one supervisor, the holder of the registry's lease, shapes the fleet and
heartbeats the records. The others stand by (``standby=True``,
``--standby``) and poll the lease; when the holder dies and its lease
(``lease_secs``, ``--lease-secs``) expires, a standby takes it over and
ADOPTS the registered replicas in place (same pids, crash counters and
backoff gates kept; no restart), so a supervisor's death costs no request.

CLI::

    python -m paddle_tpu_torch.serving.fleet --generation-model DIR \\
        --gen-paged --replicas 2 [--prefill-replicas 1 --kv-transfer-dir \\
        STORE] [--device cuda] [--port 8600] [--trace-spool-dir DIR] \\
        [--registry-dir REG [--lease-secs 5] [--standby]] \\
        [--serve-arg=--gen-max-slots=16 ...]

SIGTERM/SIGINT drains the whole fleet (each replica finishes its in-flight
work) and exits 0.
"""

import argparse
import hashlib
import json
import os
import random
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

from ..observability import catalog, tracing
from ..observability.http import BackgroundHTTPServer, JsonHTTPHandler, \
    free_port
from .registry import Lease, StaleIncarnationError, \
    parse_deadline_header, parse_tenant_header, resolve_fleet_knobs

__all__ = ["CircuitBreaker", "RouterBackend", "FleetRouter",
           "ReplicaSupervisor", "publish_artifact", "latest_artifact",
           "merge_scrapes", "slot_label", "PREFILL_SLOT_BASE", "main"]

# prefill-role replicas live in their own logical-slot namespace, so metric
# labels stay "replica0.." / "prefill0.." and respawns keep their role
PREFILL_SLOT_BASE = 1000

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def slot_label(slot):
    """Logical-slot metric label: replicaN for decode slots, prefillN for
    the prefill namespace."""
    slot = int(slot)
    if slot >= PREFILL_SLOT_BASE:
        return "prefill%d" % (slot - PREFILL_SLOT_BASE)
    return "replica%d" % slot


# ---------------------------------------------------------------------------
# Circuit breaker
# ---------------------------------------------------------------------------

class CircuitBreaker:
    """Per-backend breaker: CLOSED (traffic flows) → OPEN after
    ``fail_threshold`` consecutive failures (no traffic) → HALF_OPEN after
    ``reset_after_s`` (ONE probe allowed) → CLOSED on probe success, back
    to OPEN on probe failure. The health loop's probes count, so a dead
    replica that answers its next ``/healthz`` closes the breaker without
    risking a client request. ``clock`` is injectable for tests."""

    def __init__(self, fail_threshold=3, reset_after_s=2.0, clock=None):
        self.fail_threshold = int(fail_threshold)
        self.reset_after_s = float(reset_after_s)
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._state = "closed"
        self._failures = 0
        self._opened_at = None
        self._probing = False

    @property
    def state(self):
        with self._lock:
            return self._state

    def admits(self):
        """Side-effect-free: COULD a request be sent now? (Only
        :meth:`allow` consumes the half-open probe token.)"""
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open":
                return self._clock() - self._opened_at >= \
                    self.reset_after_s
            return not self._probing

    def allow(self):
        """Claim the right to send one request now: OPEN flips to
        HALF_OPEN once ``reset_after_s`` has passed; HALF_OPEN admits one
        probe at a time."""
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open":
                if self._clock() - self._opened_at >= self.reset_after_s:
                    self._state = "half_open"
                    self._probing = True
                    return True
                return False
            if self._probing:
                return False
            self._probing = True
            return True

    def record_success(self):
        with self._lock:
            self._state = "closed"
            self._failures = 0
            self._probing = False

    def record_failure(self):
        with self._lock:
            if self._state == "half_open":
                self._state = "open"
                self._opened_at = self._clock()
                self._probing = False
                return
            self._failures += 1
            if self._state == "closed" and \
                    self._failures >= self.fail_threshold:
                self._state = "open"
                self._opened_at = self._clock()


# ---------------------------------------------------------------------------
# Router
# ---------------------------------------------------------------------------

class RouterBackend:
    """One replica as the router sees it: health, scraped load, local
    in-flight count, circuit breaker, serving role."""

    def __init__(self, url, breaker=None, name=None, role="both"):
        self.url = url.rstrip("/")
        # the metric label: supervised replicas pass their logical slot
        # name, so labels stay bounded by the fleet size across respawns
        self.name = name or self.url.split("//", 1)[-1]
        # a "prefill" backend answers only the router's /v1/prefill hop;
        # unknown roles degrade to "both"
        self.role = role if role in ("both", "decode", "prefill") \
            else "both"
        self.breaker = breaker or CircuitBreaker()
        self.health = "unknown"   # ok | draining | stalled | dead | unknown
        self.queue_depth = 0.0    # scraped serving_queue_depth
        self.active_slots = 0.0   # scraped generation_active_slots
        self.inflight = 0         # requests this router has outstanding

    def serves(self, path):
        """Role capability filter for backend selection."""
        if self.role == "prefill":
            return path == "/v1/prefill"
        if path == "/v1/prefill":
            return self.role == "both"
        return True

    def in_rotation(self):
        """Routable: healthy (or not yet probed) and the breaker admits."""
        return self.health in ("ok", "unknown") and self.breaker.admits()

    def load(self):
        """Selection score: scraped queue pressure plus what this router
        already has outstanding there (the scrape is interval-stale)."""
        return self.queue_depth + self.active_slots + self.inflight

    def describe(self):
        return {"health": self.health, "breaker": self.breaker.state,
                "role": self.role, "queue_depth": self.queue_depth,
                "active_slots": self.active_slots,
                "inflight": self.inflight}


_SAMPLE_RE = re.compile(r"^([A-Za-z_:][A-Za-z0-9_:]*)(\{.*\})?$")


def _insert_label(name_with_labels, key, value):
    """``name{a="b"}`` → ``name{key="value",a="b"}``; the input unchanged
    when it does not parse as a sample name."""
    m = _SAMPLE_RE.match(name_with_labels)
    if not m:
        return name_with_labels
    name, labels = m.group(1), m.group(2)
    pair = '%s="%s"' % (key, value)
    if labels:
        return "%s{%s,%s" % (name, pair, labels[1:])
    return "%s{%s}" % (name, pair)


def _metric_group(name):
    """Summary ``_sum``/``_count`` rows belong to their base metric."""
    for suffix in ("_sum", "_count"):
        if name.endswith(suffix):
            return name[:-len(suffix)]
    return name


def merge_scrapes(pages):
    """Merge ``[(replica_label, prometheus_text), ...]`` into one page:
    every sample gains a ``replica`` label, samples of one metric are
    grouped under one # HELP/# TYPE block (first writer wins), other
    comments (# EXEMPLAR) are dropped."""
    from collections import OrderedDict
    meta = {}                   # ("HELP"|"TYPE", metric) -> line
    per_metric = OrderedDict()  # group key -> [sample lines]
    for label, text in pages:
        for line in text.splitlines():
            if not line.strip():
                continue
            if line.startswith("# HELP ") or line.startswith("# TYPE "):
                parts = line.split(" ", 3)
                if len(parts) < 3:
                    continue
                meta.setdefault((parts[1], parts[2]), line)
                per_metric.setdefault(_metric_group(parts[2]), [])
                continue
            if line.startswith("#"):
                continue
            name_labels, _, val = line.rpartition(" ")
            if not name_labels:
                continue
            name = name_labels.split("{", 1)[0]
            per_metric.setdefault(_metric_group(name), []).append(
                "%s %s" % (_insert_label(name_labels, "replica", label),
                           val))
    lines = []
    for metric, rows in per_metric.items():
        for kind in ("HELP", "TYPE"):
            if (kind, metric) in meta:
                lines.append(meta[(kind, metric)])
        lines.extend(rows)
    return "\n".join(lines) + "\n"


class _RouterHandler(JsonHTTPHandler):

    # response headers relayed verbatim from the replica (on top of
    # Content-Type); the id headers are the router's own
    _RELAY = ("Retry-After", "X-Trace-Summary")

    def do_GET(self):
        router = self.server
        url = urllib.parse.urlparse(self.path)
        if url.path == "/healthz":
            doc = router.health_doc()
            self._send_json(200 if doc["ready"] else 503, doc)
        elif url.path == "/metrics":
            self._send(200, router.router_metrics_text(),
                       content_type="text/plain; version=0.0.4")
        elif url.path == "/fleet/metrics":
            self._send(200, router.fleet_metrics_text(),
                       content_type="text/plain; version=0.0.4")
        elif url.path == "/fleet/status":
            self._send_json(200, router.fleet_status())
        elif url.path == "/fleet/trace":
            qs = urllib.parse.parse_qs(url.query)
            request_id = (qs.get("request_id") or [None])[0]
            trace_id = (qs.get("trace_id") or [None])[0]
            if not request_id and not trace_id:
                self._send_json(400, {"error": "need ?request_id= "
                                      "(or ?trace_id=)"})
                return
            doc = router.fleet_trace(request_id=request_id,
                                     trace_id=trace_id)
            if not doc["metadata"]["span_count"]:
                self._send_json(404, {
                    "error": "no spans found for request_id=%s "
                    "trace_id=%s (rings rotate and spools are optional — "
                    "old requests age out)" % (request_id, trace_id)})
                return
            self._send_json(200, doc)
        else:
            self._send_json(404, {"error": "unknown path %s" % self.path})

    def do_POST(self):
        if self.path not in ("/v1/infer", "/v1/generate"):
            self._send_json(404, {"error": "unknown path %s" % self.path})
            return
        # the router is the fleet's trace edge: every hop below (and every
        # retry) shares one trace id
        ctx = tracing.from_headers(self.headers) or tracing.make_context()
        # X-Deadline-Ms is the REMAINING budget at send time; the route
        # loop spends it across attempts
        deadline_ms = parse_deadline_header(
            self.headers.get("X-Deadline-Ms"))
        # a malformed tenant id degrades to anonymous, never to an error
        tenant = parse_tenant_header(self.headers.get("X-Tenant-Id"))
        length = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(length)
        status, raw, headers = self.server.route(
            self.path, body, ctx=ctx, deadline_ms=deadline_ms,
            tenant=tenant)
        extra = {k: v for k, v in headers.items() if k in self._RELAY}
        extra.update(ctx.headers())  # echo ids even on router-level 503s
        self._send(status, raw,
                   content_type=headers.get("Content-Type",
                                            "application/json"),
                   extra_headers=extra)


class FleetRouter(BackgroundHTTPServer):
    """Health-checked, queue-depth-weighted HTTP router over N replica
    servers.

    Request path: pick the in-rotation backend with the least load
    (scraped queue depth + active decode slots + local in-flight), with
    the prompt's rendezvous-hash backend preferred for ``/v1/generate``
    while its load is within ``affinity_slack`` of the fleet minimum;
    hand prompts of at least ``prefill_min_prompt`` tokens to a prefill
    backend first (when the fleet has one); forward, and on a connection
    failure or a 503 retry on ANOTHER backend with capped, jittered
    backoff until ``route_timeout_s``. Application answers
    (2xx/4xx/500/504) pass through verbatim.

    Health path: a background thread polls each backend's ``/healthz``
    and scrapes its ``/metrics`` gauges every ``check_interval_s``;
    transitions eject and readmit, probe successes close the breaker.
    With a ``registry`` (:class:`~.registry.ReplicaRegistry`) each sweep
    first syncs the backend set from the registry's records
    (:meth:`sync_registry`), so N routers over one registry serve one
    membership, each with its own health state and breakers.
    """

    def __init__(self, addr=("127.0.0.1", 0), backends=(),
                 check_interval_s=0.5, request_timeout=60.0,
                 route_timeout_s=None, health_timeout_s=2.0,
                 backoff_base_s=0.05, backoff_cap_s=0.5,
                 trace_spool_dir=None, registry=None,
                 prefix_tier_url=None, prefill_min_prompt=None,
                 affinity_block=16, affinity_slack=4.0, verbose=False):
        knobs = resolve_fleet_knobs(
            prefix_tier_url=prefix_tier_url,
            prefill_min_prompt=prefill_min_prompt,
            which=("prefix_tier_url", "prefill_min_prompt"))
        BackgroundHTTPServer.__init__(self, addr, _RouterHandler,
                                      verbose=verbose)
        # the prefix tier's URL (for /fleet/status and the tier's lane in
        # /fleet/metrics; a registry cache-role record overrides it), the
        # prefill-hop prompt gate and the affinity scheme: hash the
        # prompt's leading affinity_block tokens
        self.prefix_tier_url = knobs["prefix_tier_url"] or None
        self._registry_tier_url = None   # guarded-by: _lock
        self.prefill_min_prompt = knobs["prefill_min_prompt"]
        self.affinity_block = int(affinity_block)
        self.affinity_slack = float(affinity_slack)
        self._jitter = random.Random()
        # the span spool shared with the replicas: /fleet/trace reads it so
        # a SIGKILLed replica's spans still reach the merged trace
        self.trace_spool_dir = trace_spool_dir
        # the shared replica registry: the health loop syncs membership
        # from it; the lease is only displayed (a reader never contends)
        self.registry = registry
        self._registry_urls = set()   # guarded-by: _lock
        self._lease_view = None if registry is None else \
            Lease.reader(registry.lease_path())
        self.check_interval_s = float(check_interval_s)
        self.request_timeout = float(request_timeout)
        # the route budget covers one wedged attempt AND a retry on a
        # survivor: one stalled backend must not become a client 503
        self.route_timeout_s = float(2 * self.request_timeout + 10
                                     if route_timeout_s is None
                                     else route_timeout_s)
        self.health_timeout_s = float(health_timeout_s)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self._lock = threading.Lock()
        self._backends = {}       # url -> RouterBackend
        self._rr = 0              # tie-break rotation
        self._health_thread = None
        self._stop_health = threading.Event()
        for url in backends:
            self.add_backend(url)

    # -- backend set ---------------------------------------------------
    def add_backend(self, url, name=None, role="both"):
        b = RouterBackend(url, name=name, role=role)
        with self._lock:
            return self._backends.setdefault(b.url, b)

    def remove_backend(self, url):
        with self._lock:
            self._backends.pop(url.rstrip("/"), None)

    def backends(self):
        with self._lock:
            return list(self._backends.values())

    def get_backend(self, url):
        with self._lock:
            return self._backends.get(url.rstrip("/"))

    def mark_draining(self, url):
        """Take a backend out of rotation now (the supervisor calls this
        the instant it SIGTERMs a replica)."""
        b = self.get_backend(url)
        if b is not None:
            self._transition(b, "draining")

    def rotation_counts(self):
        bs = self.backends()
        return sum(1 for b in bs if b.in_rotation()), len(bs)

    def health_doc(self):
        live, total = self.rotation_counts()
        return {"status": "ok" if live else "no_backends",
                "ready": live > 0, "healthy": True,
                "replicas_live": live, "replicas_total": total,
                "backends": {b.name: b.describe() for b in self.backends()}}

    def router_metrics_text(self):
        """The router's own registry (fleet_* counters) with the rotation
        gauges."""
        from .metrics import render_prometheus
        live, total = self.rotation_counts()
        return render_prometheus(gauges={"fleet_replicas_live": live,
                                         "fleet_replicas_total": total})

    # -- fleet aggregation ---------------------------------------------
    def _http_get(self, url):
        """Best-effort GET of the decoded body (HTTPError bodies included:
        a draining replica's 503 /healthz carries its status document), or
        None when unreachable."""
        try:
            with urllib.request.urlopen(
                    url, timeout=self.health_timeout_s) as r:
                return r.read().decode("utf-8", "replace")
        except urllib.error.HTTPError as e:
            try:
                return e.read().decode("utf-8", "replace")
            except OSError:
                return None
        except (urllib.error.URLError, ConnectionError, OSError,
                ValueError):
            return None

    def _gather_get(self, items):
        """Fetch ``[(key, url), ...]`` CONCURRENTLY → {key: body|None}: a
        fleet page costs at most about one health timeout, also while
        replicas restart."""
        results = {}
        threads = []
        for key, url in items:
            t = threading.Thread(
                target=lambda k=key, u=url:
                    results.__setitem__(k, self._http_get(u)),
                name="fleet-gather", daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join(self.health_timeout_s + 1.0)
        return results

    def fleet_metrics_text(self):
        """One Prometheus page for the fleet: every replica's /metrics
        merged, each sample labelled ``replica="<logical slot>"``, plus the
        router's own under ``replica="router"`` and the prefix tier's under
        ``replica="prefix-tier"``. Unreachable replicas are skipped."""
        pages = [("router", self.router_metrics_text())]
        targets = [(b.name, b.url + "/metrics") for b in self.backends()]
        tier = self.tier_url()
        if tier is not None:
            targets.append(("prefix-tier", tier + "/metrics"))
        fetched = self._gather_get(targets)
        for name, _url in targets:
            text = fetched.get(name)
            if text is not None:
                pages.append((name, text))
        return merge_scrapes(pages)

    def fleet_status(self):
        """The fleet on one page: the router's view of each backend with
        the replica's own /healthz document (and its ``serving`` version
        stanza), the roles, the prefill hop's outcomes and the tier."""
        replicas = []
        bs = self.backends()
        fetched = self._gather_get([(b.name, b.url + "/healthz")
                                    for b in bs])
        for b in bs:
            entry = {"name": b.name, "url": b.url,
                     "router_view": b.describe()}
            raw = fetched.get(b.name)
            if raw is None:
                entry["healthz"] = None
                entry["reachable"] = False
            else:
                try:
                    doc = json.loads(raw)
                except ValueError:
                    doc = {"status": raw.strip()}
                entry["healthz"] = doc
                entry["reachable"] = True
                entry["version"] = doc.get("serving")
            replicas.append(entry)
        doc = {"router": self.health_doc(), "replicas": replicas,
               "trace_spool_dir": self.trace_spool_dir}
        doc["roles"] = {
            "decode": {"backends": [b.name for b in bs
                                    if b.role in ("both", "decode")],
                       "live": sum(1 for b in bs if b.in_rotation()
                                   and b.role in ("both", "decode"))},
            "prefill": {"backends": [b.name for b in bs
                                     if b.role == "prefill"],
                        "live": sum(1 for b in bs if b.in_rotation()
                                    and b.role == "prefill")},
        }
        doc["handoff"] = {
            outcome: catalog.HANDOFF_PREFILLS.value(outcome=outcome)
            for outcome in ("ok", "failed", "unavailable", "skipped")}
        tier = self.tier_url()
        if tier is not None:
            entry = {"url": tier}
            raw = self._http_get(tier + "/v1/prefix/stats")
            entry["reachable"] = raw is not None
            if raw is not None:
                try:
                    entry["stats"] = json.loads(raw)
                except ValueError:
                    pass
            doc["roles"]["cache_tier"] = entry
        if self.registry is not None:
            # the control plane at a glance: who holds the supervisor lease
            # (and for how much longer), how fresh the registry heartbeats
            # are, and any pending respawns' not_before gates
            doc["lease"] = self._lease_view.describe()
            doc["registry"] = self.registry.describe()
        return doc

    def tier_url(self):
        """The prefix tier's base URL: a live registry ``cache``-role
        record wins (it follows the live process), else the configured
        ``prefix_tier_url``; None when the fleet has no tier."""
        with self._lock:
            if self._registry_tier_url:
                return self._registry_tier_url
        return self.prefix_tier_url.rstrip("/") if self.prefix_tier_url \
            else None

    def fleet_trace(self, request_id=None, trace_id=None):
        """ONE chrome-trace for one request across the fleet: the router's
        own ring, every reachable replica's ring (``/trace``) and, with a
        span spool, the spooled spans of replicas that died holding their
        ring; filtered, deduplicated and laned per process
        (``tracing.merge_traces``)."""
        sources = [("router", tracing.trace_events())]
        bs = self.backends()
        fetched = self._gather_get([(b.name, b.url + "/trace") for b in bs])
        for b in bs:
            raw = fetched.get(b.name)
            if raw is None:
                continue
            try:
                events = json.loads(raw).get("traceEvents", [])
            except ValueError:
                continue
            sources.append((b.name, events))
        if self.trace_spool_dir:
            sources.append(("spool",
                            tracing.read_spool(self.trace_spool_dir)))
        return tracing.merge_traces(sources, request_id=request_id,
                                    trace_id=trace_id)

    # -- health checking ----------------------------------------------
    def _transition(self, backend, new_health):
        """Apply a health transition, counting ejections and readmissions
        on rotation changes."""
        with self._lock:
            was = backend.in_rotation()
            old = backend.health
            backend.health = new_health
            now = backend.in_rotation()
        if was and not now:
            catalog.FLEET_EJECTIONS.inc(reason=new_health)
        elif not was and now and old != "unknown":
            catalog.FLEET_READMISSIONS.inc()

    def _scrape_gauges(self, backend):
        """Best-effort /metrics scrape of the gauges the selection score
        weighs."""
        try:
            with urllib.request.urlopen(backend.url + "/metrics",
                                        timeout=self.health_timeout_s) as r:
                text = r.read().decode("utf-8", "replace")
        except (urllib.error.URLError, ConnectionError, OSError):
            return
        for line in text.splitlines():
            if line.startswith("#"):
                continue
            name, _, val = line.rpartition(" ")
            try:
                val = float(val)
            except ValueError:
                continue
            if name.endswith("serving_queue_depth"):
                backend.queue_depth = val
            elif name.endswith("generation_active_slots"):
                backend.active_slots = val

    def check_backend(self, backend):
        """One health probe of one backend; returns its new health."""
        try:
            with urllib.request.urlopen(backend.url + "/healthz",
                                        timeout=self.health_timeout_s) as r:
                doc = json.loads(r.read())
            status = doc.get("status", "ok")
        except urllib.error.HTTPError as e:
            try:
                doc = json.loads(e.read())
            except ValueError:
                doc = {}
            status = doc.get("status", "stalled")
        except (urllib.error.URLError, ConnectionError, OSError,
                ValueError):
            backend.breaker.record_failure()
            self._transition(backend, "dead")
            return "dead"
        if status == "ok":
            # an answered, ready healthz is the breaker's probe success
            backend.breaker.record_success()
            self._transition(backend, "ok")
        elif status == "draining":
            self._transition(backend, "draining")
        else:
            self._transition(backend, "stalled")
        return status

    def sync_registry(self):
        """Converge the backend set on the shared registry's membership:
        records in state ``ready`` become backends (named by logical slot,
        so metrics and breakers follow the slot across respawns); backends
        a sync added are dropped once their record is withdrawn. Manually
        added backends are never touched. Stale-heartbeat records are kept
        (the data plane outlives a dead supervisor; the health loop, not
        the registry, governs rotation) until the next lease holder
        reconciles the registry."""
        if self.registry is None:
            return
        all_recs = self.registry.records()
        # cache-role records name the prefix tier, not traffic backends:
        # the newest LIVE ready one wins. The tier has no health-loop
        # corrector, so a dead tier's stale record ages out here (by
        # heartbeat TTL) instead of overriding the configured URL
        now = time.time()
        tiers = [r for r in all_recs
                 if r.get("role") == "cache" and r.get("state") == "ready"
                 and r.get("url")
                 and now - r.get("heartbeat_unix", 0.0)
                 <= self.registry.ttl_s]
        with self._lock:
            self._registry_tier_url = \
                tiers[-1]["url"].rstrip("/") if tiers else None
        recs = {r["url"].rstrip("/"): r
                for r in all_recs
                if r.get("state") == "ready" and r.get("url")
                and r.get("role") != "cache"}
        with self._lock:
            known = set(self._backends)
            from_registry = set(self._registry_urls)
        for url, rec in recs.items():
            if url not in known:
                self.add_backend(url, name=slot_label(rec["slot"]),
                                 role=rec.get("role", "both"))
                with self._lock:
                    self._registry_urls.add(url)
            elif url not in from_registry:
                # a backend the co-located supervisor added that the
                # registry also names is registry-owned from now on: when
                # a later lease holder replaces the replica and withdraws
                # its record, this router drops the stale URL
                with self._lock:
                    self._registry_urls.add(url)
        for url in from_registry - set(recs):
            self.remove_backend(url)
            with self._lock:
                self._registry_urls.discard(url)

    def check_once(self):
        """One full health sweep (the health thread's body): the registry
        sync, then every backend's probe."""
        self.sync_registry()
        for b in self.backends():
            if self.check_backend(b) == "ok":
                self._scrape_gauges(b)

    def _health_loop(self):
        while not self._stop_health.wait(self.check_interval_s):
            try:
                self.check_once()
            except Exception as e:  # the health loop must survive
                sys.stderr.write("fleet router: health sweep failed: %s\n"
                                 % e)

    # -- lifecycle -----------------------------------------------------
    def start_background(self, name="fleet-router"):
        self._stop_health.clear()
        self._health_thread = threading.Thread(
            target=self._health_loop, name="fleet-health", daemon=True)
        self._health_thread.start()
        return BackgroundHTTPServer.start_background(self, name=name)

    def stop(self, timeout=None):
        self._stop_health.set()
        if self._health_thread is not None:
            self._health_thread.join(timeout)
            self._health_thread = None
        BackgroundHTTPServer.stop(self, timeout)

    # -- request path --------------------------------------------------
    def _affinity_key(self, prompt):
        """Stable digest of the prompt's leading tokens (the block-chain
        scheme's first link): identical prefixes land on one decode
        backend, whose local prefix cache serves them."""
        import numpy as np
        head = np.asarray(prompt[:self.affinity_block], np.int32)
        return hashlib.sha1(head.tobytes()).digest()

    def _pick(self, excluded, path="/v1/infer", affinity_key=None,
              count_affinity=False):
        """An in-rotation backend serving ``path`` and not in
        ``excluded``: the least loaded (round-robin among ties), or with
        an ``affinity_key`` the rendezvous-hash winner unless its load
        exceeds the fleet minimum by more than ``affinity_slack``. None
        when nothing is routable."""
        skip = set(excluded)
        while True:
            with self._lock:
                ready = [b for b in self._backends.values()
                         if b.url not in skip and b.in_rotation()
                         and b.serves(path)]
                if not ready:
                    return None
                choice = None
                if affinity_key is not None and len(ready) > 1:
                    target = max(
                        ready, key=lambda b: hashlib.sha1(
                            affinity_key + b.name.encode()).digest())
                    floor = min(b.load() for b in ready)
                    if target.load() <= floor + self.affinity_slack:
                        choice = target
                        if count_affinity:
                            catalog.FLEET_PREFIX_AFFINITY.inc(
                                outcome="affinity")
                    elif count_affinity:
                        catalog.FLEET_PREFIX_AFFINITY.inc(outcome="load")
                if choice is None:
                    # rotate the candidates so equal loads take turns
                    self._rr += 1
                    k = self._rr % len(ready)
                    choice = min(ready[k:] + ready[:k],
                                 key=RouterBackend.load)
            # the affinity decision counts once per request
            count_affinity = False
            # take the breaker token only for the backend chosen; a lost
            # race for a half-open probe skips it
            if choice.breaker.allow():
                return choice
            skip.add(choice.url)

    def _forward(self, backend, path, body, ctx=None, deadline_ms=None,
                 tenant=None):
        """One attempt on one backend: (status, raw, headers), or the
        connection-level error raised. ``deadline_ms`` (the REMAINING
        budget) rides ``X-Deadline-Ms`` and caps the socket timeout;
        ``tenant`` rides ``X-Tenant-Id`` unchanged."""
        headers = {"Content-Type": "application/json"}
        if ctx is not None:
            headers.update(ctx.headers())
        if tenant:
            headers["X-Tenant-Id"] = tenant
        timeout = self.request_timeout
        if deadline_ms is not None:
            headers["X-Deadline-Ms"] = str(int(deadline_ms))
            # +1 s grace: the replica's own 504 names the stage
            timeout = min(timeout, deadline_ms / 1e3 + 1.0)
        req = urllib.request.Request(backend.url + path, data=body,
                                     headers=headers, method="POST")
        with self._lock:
            backend.inflight += 1
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return r.status, r.read(), dict(r.headers)
        except urllib.error.HTTPError as e:
            return e.code, e.read(), dict(e.headers)
        finally:
            with self._lock:
                backend.inflight -= 1

    def _prefill_handoff(self, prompt, body, ctx, remaining_ms):
        """One best-effort prefill-worker hop for a generate request.
        Outcomes (``handoff_prefills_total`` and a ``handoff.prefill``
        span): ``ok`` — the worker prefilled and published the prompt's
        pages; ``failed`` — the attempt errored and the decode worker
        self-prefills; ``unavailable`` — prefill workers are registered but
        none is in rotation; ``skipped`` — the prompt is below
        ``prefill_min_prompt``. A fleet with no prefill backend records
        nothing."""
        if remaining_ms is not None and remaining_ms <= 0:
            return  # the route loop is about to 504 this request
        with self._lock:
            registered = [b for b in self._backends.values()
                          if b.role == "prefill"]
        if not registered:
            return
        if len(prompt) < self.prefill_min_prompt:
            catalog.HANDOFF_PREFILLS.inc(outcome="skipped")
            return
        ready = [b for b in registered if b.in_rotation()]
        backend = None
        if ready:
            backend = min(ready, key=RouterBackend.load)
            if not backend.breaker.allow():
                backend = None
        if backend is None:
            catalog.HANDOFF_PREFILLS.inc(outcome="unavailable")
            tracing.record("handoff.prefill", ctx=ctx,
                           outcome="unavailable")
            return
        t0 = time.perf_counter()
        try:
            status, raw, _headers = self._forward(
                backend, "/v1/prefill", body, ctx=ctx,
                deadline_ms=remaining_ms)
        except (urllib.error.URLError, ConnectionError, OSError) as e:
            # the worker died mid-handoff: eject it so the next request
            # skips it without a connection attempt
            backend.breaker.record_failure()
            self._transition(backend, "dead")
            catalog.HANDOFF_PREFILLS.inc(outcome="failed")
            tracing.span_from(t0, "handoff.prefill", ctx=ctx,
                              backend=backend.name, outcome="failed",
                              error="%s: %s" % (type(e).__name__, e))
            return
        backend.breaker.record_success()
        if status == 200:
            try:
                doc = json.loads(raw)
            except ValueError:
                doc = {}
            catalog.HANDOFF_PREFILLS.inc(outcome="ok")
            tracing.span_from(t0, "handoff.prefill", ctx=ctx,
                              backend=backend.name, outcome="ok",
                              key=str(doc.get("key", ""))[:12],
                              n_pages=doc.get("n_pages"))
        else:
            catalog.HANDOFF_PREFILLS.inc(outcome="failed")
            tracing.span_from(t0, "handoff.prefill", ctx=ctx,
                              backend=backend.name, outcome="failed",
                              status=status)

    def route(self, path, body, ctx=None, deadline_ms=None, tenant=None):
        """Route one request: (prefill hop →) pick → forward → retry across
        replicas on 503 or connection failure until ``route_timeout_s``.
        Returns (status, raw_body, headers). Every attempt is a
        ``router.attempt`` span under one ``router.request`` span — the
        router's lane of the merged fleet trace. ``deadline_ms`` (the
        client's ``X-Deadline-Ms``) tightens the budget: attempts stop at
        the deadline (504, ``deadline_exceeded_total{stage="route"}``) and
        each forward carries what remains of it."""
        catalog.FLEET_REQUESTS.inc()
        t0 = time.perf_counter()
        state = {"attempts": 0}
        prompt = None
        if path == "/v1/generate":
            # the prompt drives affinity and the prefill hop; an
            # unparseable body is the replica's to reject
            try:
                p = json.loads(body).get("prompt")
                if isinstance(p, list) and p and \
                        all(isinstance(t, int) and not isinstance(t, bool)
                            for t in p):
                    prompt = p
            except (ValueError, AttributeError):
                pass
            if prompt is None:
                catalog.FLEET_PREFIX_AFFINITY.inc(outcome="none")
        try:
            status, raw, headers = self._route(path, body, ctx, state,
                                               deadline_ms, prompt=prompt,
                                               tenant=tenant)
        except Exception as e:
            tracing.span_from(t0, "router.request", ctx=ctx, path=path,
                              status="exception",
                              attempts=state["attempts"],
                              error="%s: %s" % (type(e).__name__, e))
            raise
        tracing.span_from(t0, "router.request", ctx=ctx, path=path,
                          status=status, attempts=state["attempts"])
        return status, raw, headers

    def _route(self, path, body, ctx, state, deadline_ms=None, prompt=None,
               tenant=None):
        deadline = time.monotonic() + self.route_timeout_s
        req_deadline = None
        if deadline_ms is not None:
            req_deadline = time.monotonic() + deadline_ms / 1e3
            deadline = min(deadline, req_deadline)
        affinity_key = None
        count_affinity = False
        if prompt is not None:
            affinity_key = self._affinity_key(prompt)
            count_affinity = True

        def _remaining_ms():
            if req_deadline is None:
                return None
            return (req_deadline - time.monotonic()) * 1e3

        def _expired():
            """504 for a request whose end-to-end budget the route loop
            spent: not a 503, so the client does not retry it."""
            catalog.DEADLINE_EXCEEDED.inc(stage="route")
            tracing.record("router.deadline", ctx=ctx, path=path,
                           attempts=state["attempts"])
            return (504, json.dumps(
                {"error": "deadline of %d ms exhausted at the router "
                 "after %d attempt(s)" % (deadline_ms, state["attempts"]),
                 "deadline_exceeded": True}).encode("utf-8"), {})

        def _past(t):
            return time.monotonic() >= t

        backoff = self.backoff_base_s
        excluded = set()
        last_503 = None
        # the prefill hop first: its published pages make the decode
        # forward a map instead of a compute; every failure of the hop
        # falls through to the decode worker self-prefilling
        if prompt is not None:
            self._prefill_handoff(prompt, body, ctx, _remaining_ms())
        while True:
            if req_deadline is not None and _past(req_deadline):
                return _expired()
            backend = self._pick(excluded, path=path,
                                 affinity_key=affinity_key,
                                 count_affinity=count_affinity)
            count_affinity = False
            if backend is None:
                if _past(deadline):
                    if req_deadline is not None and _past(req_deadline):
                        return _expired()
                    if last_503 is not None:
                        return last_503
                    return (503, json.dumps(
                        {"error": "no replica available"}).encode("utf-8"),
                        {"Retry-After": "1"})
                # a full sweep failed (or nothing is in rotation yet): back
                # off with FULL jitter, then make every backend eligible
                # again — health may have recovered, a replacement joined
                time.sleep(min(self._jitter.uniform(0, backoff),
                               max(0.0, deadline - time.monotonic())))
                backoff = min(backoff * 2, self.backoff_cap_s)
                excluded.clear()
                continue
            state["attempts"] += 1
            t_att = time.perf_counter()
            try:
                status, raw, headers = self._forward(
                    backend, path, body, ctx=ctx,
                    deadline_ms=_remaining_ms(), tenant=tenant)
            except (urllib.error.URLError, ConnectionError, OSError) as e:
                # the replica died under us: eject it and retry the request
                # on a survivor
                tracing.span_from(t_att, "router.attempt", ctx=ctx,
                                  backend=backend.name, outcome="connection",
                                  error="%s: %s" % (type(e).__name__, e))
                backend.breaker.record_failure()
                self._transition(backend, "dead")
                catalog.FLEET_BACKEND_REQUESTS.inc(backend=backend.name,
                                                   outcome="connection")
                catalog.FLEET_ROUTER_RETRIES.inc(reason="connection")
                excluded.add(backend.url)
                if _past(deadline):
                    if req_deadline is not None and _past(req_deadline):
                        return _expired()
                    return (503, json.dumps(
                        {"error": "all replicas failing: %s" % e})
                        .encode("utf-8"), {"Retry-After": "1"})
                continue
            if status == 503:
                # an ANSWERED 503 proves connectivity: the breaker records
                # success
                backend.breaker.record_success()
                retry_after = headers.get("Retry-After")
                tracing.span_from(t_att, "router.attempt", ctx=ctx,
                                  backend=backend.name,
                                  outcome="draining" if retry_after is None
                                  else "overload", status=503)
                if retry_after is None:
                    # a 503 without Retry-After is a draining replica: out
                    # of rotation, but not dead
                    self._transition(backend, "draining")
                    catalog.FLEET_ROUTER_RETRIES.inc(reason="draining")
                else:
                    catalog.FLEET_ROUTER_RETRIES.inc(reason="overload")
                catalog.FLEET_BACKEND_REQUESTS.inc(backend=backend.name,
                                                   outcome="unavailable")
                # relayed verbatim w.r.t. Retry-After: a draining replica's
                # header-less 503 means "do not retry" to the client
                h = {"Content-Type": headers.get("Content-Type",
                                                 "application/json")}
                if retry_after is not None:
                    h["Retry-After"] = retry_after
                last_503 = (503, raw, h)
                excluded.add(backend.url)
                if _past(deadline):
                    if req_deadline is not None and _past(req_deadline):
                        return _expired()
                    return last_503
                continue
            outcome = "ok" if status < 400 else "http_error"
            tracing.span_from(t_att, "router.attempt", ctx=ctx,
                              backend=backend.name, outcome=outcome,
                              status=status)
            backend.breaker.record_success()
            catalog.FLEET_BACKEND_REQUESTS.inc(backend=backend.name,
                                               outcome=outcome)
            return status, raw, headers


# ---------------------------------------------------------------------------
# Artifact serials — the hot-swap source
# ---------------------------------------------------------------------------

def publish_artifact(root, src_dir, step=None, keep=None,
                     weight_quant_dtype=None):
    """Publish a serving artifact directory (an ``export_artifact`` or
    ``save_decoder`` output, either package's) as the next numbered serial
    under ``root``, committed with the checkpoint crash-consistency scheme
    (files fsynced, then an md5 ``_MANIFEST``), so :func:`latest_artifact`
    finds it and a half-copied publish is invisible. Returns ``(serial,
    serial_dir)``.

    ``weight_quant_dtype`` (default ``FLAGS_weight_quant_dtype``): fp8|int8
    weight-only-quantizes a ``save_decoder`` source at publish time
    (``quantize_decoder_dir``: ``*.qw``/``*.scale`` arrays, and a
    ``weight_quant`` stanza in config.json and in the manifest). Under the
    flag's default a source without config.json publishes plain; an
    explicit mode on such a source raises.

    ``keep``: trim serials older than the ``keep`` newest (leave None
    while replicas may still serve old serials)."""
    import shutil
    import tempfile
    from ..io import _checkpoint_manifest, _claim_serial_dir, \
        _commit_manifest, _fsync_path, _trim_old_serials
    from .kv_transfer import resolve_kv_transfer_knobs
    wq = resolve_kv_transfer_knobs(
        weight_quant_dtype=weight_quant_dtype,
        which=("weight_quant_dtype",))["weight_quant_dtype"]
    if wq != "off" and weight_quant_dtype is None and \
            not os.path.isfile(os.path.join(src_dir, "config.json")):
        wq = "off"
    os.makedirs(root, exist_ok=True)
    quant_tmp = None
    stanza = None
    if wq != "off":
        from .generation import quantize_decoder_dir
        quant_tmp = tempfile.mkdtemp(prefix="wq_publish_")
        stanza = quantize_decoder_dir(src_dir, quant_tmp, wq)
        src_dir = quant_tmp
    try:
        serial, cur = _claim_serial_dir(root)
        for fn in sorted(os.listdir(src_dir)):
            src = os.path.join(src_dir, fn)
            # this publish writes the manifest that vouches here
            if fn == "_MANIFEST" or not os.path.isfile(src):
                continue
            dst = os.path.join(cur, fn)
            shutil.copyfile(src, dst)
            _fsync_path(dst, strict=True)
        manifest = {"trainer_id": 0, "timestamp": time.time(),
                    "step": serial if step is None else int(step),
                    "md5": _checkpoint_manifest(cur)}
        if stanza is not None:
            manifest["weight_quant"] = stanza
        _commit_manifest(root, cur, manifest)
    finally:
        if quant_tmp is not None:
            shutil.rmtree(quant_tmp, ignore_errors=True)
    if keep:
        _trim_old_serials(root, serial, keep)
    return serial, cur


def latest_artifact(root):
    """The newest valid artifact serial under ``root``
    (``CheckpointManager.latest_valid()``: torn and corrupt publishes are
    skipped): ``(serial, serial_dir)`` or None."""
    if not os.path.isdir(root):
        return None
    from ..robustness.checkpoint import CheckpointManager
    found = CheckpointManager(dirname=root).latest_valid()
    if found is None:
        return None
    return found[0], os.path.join(root, str(found[0]))


# ---------------------------------------------------------------------------
# Replica supervisor
# ---------------------------------------------------------------------------

class _AdoptedProc:
    """Popen-compatible handle over a replica process this supervisor did
    NOT spawn — the adoption primitive. A standby that takes over the
    lease inherits replicas whose real parent (the dead supervisor) is
    gone, so there is no Popen to hold: liveness is probed with
    ``kill(pid, 0)`` and signals go through ``os.kill``. The exit status of
    a non-child is unknowable: poll() reports ``-1`` once the pid
    vanishes, which the repair loop treats like any crash."""

    def __init__(self, pid):
        self.pid = pid
        self._rc = None

    def poll(self):
        if self._rc is not None:
            return self._rc
        if not self.pid:
            self._rc = -1
            return self._rc
        try:
            os.kill(self.pid, 0)
        except ProcessLookupError:
            self._rc = -1     # gone; real status died with the parent
            return self._rc
        except PermissionError:
            return None       # alive under another uid
        # kill(pid, 0) succeeds on a ZOMBIE: a killed adoptee whose real
        # parent has not reaped it. Only that parent can; to us it is
        # dead, and treating it as alive would wedge stop()/wait()
        try:
            with open("/proc/%d/stat" % self.pid) as f:
                state = f.read().rsplit(")", 1)[1].split()[0]
            if state == "Z":
                self._rc = -1
                return self._rc
        except (OSError, IndexError):
            pass              # no procfs: the kill probe decides
        return None

    def send_signal(self, sig):
        if self.poll() is None:
            try:
                os.kill(self.pid, sig)
            except OSError:
                pass

    def terminate(self):
        self.send_signal(signal.SIGTERM)

    def kill(self):
        self.send_signal(signal.SIGKILL)

    def wait(self, timeout=None):
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.poll() is None:
            if deadline is not None and time.monotonic() >= deadline:
                raise subprocess.TimeoutExpired(
                    "<adopted pid %s>" % self.pid, timeout)
            time.sleep(0.02)
        return self._rc


class _Replica:
    """One supervised replica process."""

    def __init__(self, name, port, url, serial, proc, log_path, slot):
        self.name = name
        self.port = port
        self.url = url
        self.serial = serial          # artifact serial served (or None)
        self.proc = proc
        self.log_path = log_path
        self.slot = slot              # logical slot: stable metric label
        self.state = "starting"       # starting|ready|retiring|backoff
        self.failures = 0             # consecutive crash count
        self.not_before = 0.0         # monotonic respawn gate (backoff)
        self.started_mono = time.monotonic()
        self.ready_s = None           # spawn to ready, seconds
        self.incarnation = None       # registry record nonce (ours)

    @property
    def role(self):
        """Serving role, structural in the slot namespace; decode replicas
        are "both"."""
        return "prefill" if self.slot >= PREFILL_SLOT_BASE else "both"

    def describe(self):
        doc = {"name": self.name, "url": self.url, "state": self.state,
               "slot": self.slot, "role": self.role, "serial": self.serial,
               "pid": self.proc.pid if self.proc else None,
               "failures": self.failures, "ready_s": self.ready_s}
        if self.state == "backoff":
            doc["not_before_in_s"] = round(
                max(0.0, self.not_before - time.monotonic()), 3)
        return doc


class ReplicaSupervisor:
    """Own the replica processes behind a :class:`FleetRouter`.

    ``make_argv(port, serial_dir)`` builds one replica's command line
    (``serial_dir`` is the artifact serial to serve, or None when the argv
    names a fixed artifact). The supervisor:

    * spawns ``replicas`` decode and ``prefill_replicas`` prefill
      processes (``make_prefill_argv``, default ``make_argv``) on free
      ports and registers each with the router once its ``/healthz``
      answers ready, within ``ready_timeout_s`` (a 12-layer 512-wide
      decoder replica took 12.2-14.8 s from spawn to ready on an H100,
      five booting at once: ``chip_smoke.py`` phase 19);
    * restarts crashed replicas with capped exponential backoff
      (``fleet_restarts_total``); a replica up ``stable_after_s`` resets
      its crash counter;
    * watches ``artifact_root`` (when given) for a newer valid serial and
      rolls the fleet onto it (:meth:`hot_swap`): replacement first, then
      drain, so capacity never dips;
    * scales with :meth:`scale_to` / :meth:`autoscale_step`.

    Control-plane HA: with a shared ``registry``
    (:class:`~.registry.ReplicaRegistry`) the supervisor runs the
    fault-tolerant-master protocol over the registry's
    ``supervisor.lease`` file:

    * the ACTIVE supervisor publishes one registry record per replica
      (heartbeated every sweep; routers sync membership from them) and
      renews the lease (every sweep, and every ``lease_secs / 3`` while
      it waits for a replica to boot); losing a renewal demotes it on the
      spot: it abandons, never kills, its replicas and stands by;
    * a STANDBY (``standby=True``, or an active that lost the lease)
      supervises nothing and polls the lease; acquiring it over a dead
      holder (``lease_takeovers_total``) ADOPTS the fleet: every
      still-healthy registered replica is re-published under the new
      incarnation and managed in place (``replicas_adopted_total``) —
      same pid, same crash counter, no respawn — while ``backoff``
      records keep their respawn gate and dead or unready records are
      signalled and withdrawn so deficit repair replaces them.
    """

    def __init__(self, make_argv, *, replicas=2, prefill_replicas=0,
                 make_prefill_argv=None, router=None, host="127.0.0.1",
                 artifact_root=None, check_interval_s=0.5,
                 ready_timeout_s=120.0, drain_timeout_s=30.0,
                 restart_backoff_s=0.2, restart_backoff_cap_s=5.0,
                 stable_after_s=30.0, hot_swap_poll_s=2.0, min_replicas=1,
                 max_replicas=8, scale_up_depth=8.0,
                 scale_down_idle_sweeps=10, registry=None, lease_secs=None,
                 standby=False, adopt_ready_timeout_s=5.0, env=None,
                 log_dir=None, verbose=False):
        if standby and registry is None:
            raise ValueError("standby=True needs a registry (a standby "
                             "takes over through the registry's lease)")
        self.make_argv = make_argv
        self.n_replicas = int(replicas)
        self.n_prefill = int(prefill_replicas)
        self.make_prefill_argv = make_prefill_argv or make_argv
        self.router = router
        self.host = host
        self.artifact_root = artifact_root
        self.registry = registry
        self.lease = None if registry is None else \
            Lease(registry.lease_path(), lease_secs=lease_secs,
                  holder=registry.holder)
        self.adopt_ready_timeout_s = float(adopt_ready_timeout_s)
        self._standby = bool(standby)   # guarded-by: _lock
        self.check_interval_s = float(check_interval_s)
        self.ready_timeout_s = float(ready_timeout_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self.restart_backoff_s = float(restart_backoff_s)
        self.restart_backoff_cap_s = float(restart_backoff_cap_s)
        self.stable_after_s = float(stable_after_s)
        self.hot_swap_poll_s = float(hot_swap_poll_s)
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.scale_up_depth = float(scale_up_depth)
        self.scale_down_idle_sweeps = int(scale_down_idle_sweeps)
        self.env = env
        self.log_dir = log_dir
        self.verbose = verbose
        self.autoscale = False
        self.current_serial = None
        self._replicas = []           # [_Replica]
        self._pending = []            # crashed, waiting out not_before
        self._lock = threading.RLock()
        # serializes every fleet-SHAPE mutation (repair, scale_to,
        # hot_swap): two shapers would both count one deficit
        self._shape_lock = threading.Lock()
        self._seq = 0
        self._idle_sweeps = 0
        self._last_swap_poll = 0.0
        self._stop = threading.Event()
        self._watch_thread = None

    # -- logging -------------------------------------------------------
    def _log(self, msg):
        if self.verbose:
            sys.stderr.write("fleet: %s\n" % msg)

    def _log_tail(self, replica, n=2000):
        try:
            with open(replica.log_path, "rb") as f:
                f.seek(0, os.SEEK_END)
                f.seek(max(0, f.tell() - n))
                return f.read().decode("utf-8", "replace")
        except OSError:
            return "<no log>"

    # -- spawn / readiness --------------------------------------------
    def _serial_dir(self, serial):
        if serial is None or self.artifact_root is None:
            return None
        return os.path.join(self.artifact_root, str(serial))

    def _free_slot(self, prefill=False):
        """Lowest logical slot not occupied (live or pending respawn) in
        the role's namespace."""
        with self._lock:
            used = {r.slot for r in self._replicas} | \
                   {p.slot for p in self._pending}
        slot = PREFILL_SLOT_BASE if prefill else 0
        while slot in used:
            slot += 1
        return slot

    def _spawn(self, serial, slot):
        """Launch one replica process (not registered yet); the slot's
        namespace picks the argv function."""
        with self._lock:
            self._seq += 1
            name = "r%d" % self._seq
        port = free_port(self.host)
        url = "http://%s:%d" % (self.host, port)
        build = self.make_prefill_argv if slot >= PREFILL_SLOT_BASE \
            else self.make_argv
        argv = build(port, self._serial_dir(serial))
        log_dir = self.log_dir or os.path.join(
            os.environ.get("TMPDIR", "/tmp"), "paddle_tpu_torch_fleet")
        os.makedirs(log_dir, exist_ok=True)
        log_path = os.path.join(log_dir, "%s_%d.log" % (name, port))
        logf = open(log_path, "ab")
        try:
            proc = subprocess.Popen(argv, stdout=logf, stderr=logf,
                                    env=self.env)
        finally:
            logf.close()  # the child holds its own fd
        self._log("spawned %s pid=%d port=%d serial=%s slot=%d"
                  % (name, proc.pid, port, serial, slot))
        return _Replica(name, port, url, serial, proc, log_path, slot)

    def _wait_ready(self, replica, timeout=None):
        """Poll the replica's /healthz until it answers ready; False when
        the process dies or the deadline passes first. An ACTIVE
        supervisor renews its lease every ``lease_secs / 3`` while it
        waits: a replica's cold start on the card (9.6-14.8 s, H100 at
        700 W, ``chip_smoke.py`` phase 19) outlasts the default 5 s lease,
        and a lease left to expire mid-boot would hand the fleet to a
        standby over a routine repair."""
        deadline = time.monotonic() + (self.ready_timeout_s
                                       if timeout is None else timeout)
        last_renew = time.monotonic()
        renew_every = None if self.lease is None else \
            max(0.1, self.lease.lease_secs / 3.0)
        while time.monotonic() < deadline and not self._stop.is_set():
            if renew_every is not None and not self.is_standby() and \
                    time.monotonic() - last_renew >= renew_every:
                last_renew = time.monotonic()
                self.lease.renew()  # best-effort; the sweep demotes
            if replica.proc.poll() is not None:
                return False
            try:
                with urllib.request.urlopen(replica.url + "/healthz",
                                            timeout=2.0) as r:
                    if json.loads(r.read()).get("ready", True):
                        replica.ready_s = \
                            time.monotonic() - replica.started_mono
                        return True
            except (urllib.error.URLError, ConnectionError, OSError,
                    ValueError):
                pass
            time.sleep(0.1)
        return False

    def _register(self, replica):
        with self._lock:
            replica.state = "ready"
            replica.started_mono = time.monotonic()
            self._replicas.append(replica)
        if self.router is not None:
            self.router.add_backend(replica.url, name=slot_label(replica.slot),
                                    role=replica.role)
        if self.registry is not None and replica.incarnation is None:
            # adoption arrives here with a nonce already re-published under
            # OUR identity; a freshly spawned replica claims its slot's
            # record now (routers sync membership from it)
            replica.incarnation = self.registry.publish(
                replica.slot, replica.url,
                pid=replica.proc.pid if replica.proc else None,
                serial=replica.serial, state="ready",
                failures=replica.failures, role=replica.role)

    def _kill(self, replica):
        if replica.proc.poll() is None:
            replica.proc.kill()
            replica.proc.wait()

    # -- public lifecycle ---------------------------------------------
    def start(self):
        """Resolve the initial artifact serial, spawn the fleet (the
        processes boot concurrently), wait until every replica is ready
        and routed, start the watch thread. Raises RuntimeError with the
        failed replicas' log tails when the fleet cannot come up.

        With a ``registry``: first contend for the supervisor lease.
        Losing it (an unexpired holder stands), or ``standby=True``,
        starts this supervisor as a STANDBY: nothing is spawned, and the
        watch thread polls the lease and takes over (adopting the
        registered fleet) when the holder dies. Winning it adopts any
        still-healthy registered replicas first and spawns only the
        difference."""
        if self.artifact_root is not None:
            found = latest_artifact(self.artifact_root)
            if found is not None:
                self.current_serial = found[0]
        if self.lease is not None and (
                self.is_standby()  # standby=True: never contend at start
                or not self._try_become_active()):
            self._log("standby: lease held by %r — watching for expiry"
                      % ((self.lease.read() or {}).get("holder"),))
            self._start_watch()
            return self
        with self._lock:
            # adopted backoff records count too: their pending respawn owns
            # the slot behind its preserved gate
            adopted = {r.slot for r in self._replicas} | \
                      {p.slot for p in self._pending}
        slots = []
        for base, want in ((0, self.n_replicas),
                           (PREFILL_SLOT_BASE, self.n_prefill)):
            prefill_ns = base == PREFILL_SLOT_BASE
            have = sum(1 for s in adopted
                       if (s >= PREFILL_SLOT_BASE) == prefill_ns)
            need, slot = max(0, want - have), base
            while need > 0:
                if slot not in adopted:
                    slots.append(slot)
                    need -= 1
                slot += 1
        spawned = [self._spawn(self.current_serial, slot) for slot in slots]
        # one waiter a replica, so each one's ready_s is its own cold start
        ready = {}
        waiters = [threading.Thread(
            target=lambda r=rep: ready.__setitem__(r.name,
                                                   self._wait_ready(r)),
            name="fleet-ready", daemon=True) for rep in spawned]
        for t in waiters:
            t.start()
        for t in waiters:
            t.join()
        failed = []
        for rep in spawned:
            if ready.get(rep.name):
                self._register(rep)
            else:
                failed.append(rep)
        if failed:
            tails = "\n".join("--- %s (%s)\n%s" % (
                r.name, r.log_path, self._log_tail(r)) for r in failed)
            for rep in spawned:
                self._kill(rep)
            for rep in self.replicas():
                self._remove(rep)
            raise RuntimeError("fleet: %d/%d replicas failed to become "
                               "ready\n%s" % (len(failed), len(spawned),
                                              tails))
        self._start_watch()
        return self

    def _start_watch(self):
        self._stop.clear()
        self._last_swap_poll = time.monotonic()
        self._watch_thread = threading.Thread(
            target=self._watch_loop, name="fleet-supervisor", daemon=True)
        self._watch_thread.start()

    def stop(self, drain=True):
        """Stop supervising and stop every replica (SIGTERM drain by
        default, then SIGKILL stragglers)."""
        self._stop.set()
        if self._watch_thread is not None:
            self._watch_thread.join(self.drain_timeout_s)
            self._watch_thread = None
        with self._lock:
            replicas = list(self._replicas)
            self._pending = []  # dead already; nothing to respawn now
        for rep in replicas:
            rep.state = "retiring"
            if self.router is not None:
                self.router.mark_draining(rep.url)
            if drain and rep.proc.poll() is None:
                rep.proc.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + (self.drain_timeout_s if drain
                                       else 0.0)
        for rep in replicas:
            while rep.proc.poll() is None and time.monotonic() < deadline:
                time.sleep(0.05)
            self._kill(rep)
            self._remove(rep)
        if self.lease is not None:
            # clean shutdown: drop the lease now, so a standby takes over
            # at once instead of waiting out the expiry
            self.lease.release()

    def _remove(self, replica):
        with self._lock:
            if replica in self._replicas:
                self._replicas.remove(replica)
        if self.router is not None:
            self.router.remove_backend(replica.url)
        if self.registry is not None and replica.incarnation is not None:
            try:
                self.registry.withdraw(replica.slot, replica.incarnation)
            except StaleIncarnationError:
                pass  # re-published by a newer owner: theirs now
            # a crash-respawn of this replica claims a FRESH record
            replica.incarnation = None

    def replicas(self):
        with self._lock:
            return list(self._replicas)

    def describe(self):
        with self._lock:
            pending = [p.describe() for p in self._pending]
        doc = {"replicas": [r.describe() for r in self.replicas()],
               "pending_respawn": pending, "serial": self.current_serial}
        if self.lease is not None:
            doc["standby"] = self.is_standby()
            doc["lease"] = self.lease.describe()
        return doc

    def is_standby(self):
        """Is this supervisor standing by (not holding the lease,
        supervising nothing)?"""
        with self._lock:
            return self._standby

    # -- crash-restart loop -------------------------------------------
    def _backoff_for(self, failures):
        return min(self.restart_backoff_s * (2 ** max(0, failures - 1)),
                   self.restart_backoff_cap_s)

    def _watch_loop(self):
        while not self._stop.wait(self.check_interval_s):
            try:
                self._watch_once()
            except Exception as e:  # supervision must survive anything
                sys.stderr.write("fleet supervisor: sweep failed: %s\n" % e)

    def _watch_once(self):
        """One supervision sweep: contend for or renew the lease (with a
        registry), reap crashes, respawn after backoff, reset crash
        counters on stability, poll the artifact root for a newer serial,
        autoscale if enabled, heartbeat the registry."""
        if self.lease is not None and not self._lease_sweep():
            return  # standing by: supervise nothing this sweep
        now = time.monotonic()
        if self._shape_lock.acquire(blocking=False):
            try:
                self._repair_once(now)
            finally:
                self._shape_lock.release()
        if self.artifact_root is not None and \
                now - self._last_swap_poll >= self.hot_swap_poll_s:
            self._last_swap_poll = now
            found = latest_artifact(self.artifact_root)
            if found is not None and (self.current_serial is None
                                      or found[0] > self.current_serial):
                self.hot_swap(found[0])
        if self.autoscale:
            self.autoscale_step()
        if self.registry is not None:
            self._publish_registry()

    # -- control-plane HA ---------------------------------------------
    def _lease_sweep(self):
        """The lease half of one sweep. Returns True when this supervisor
        is (still or newly) ACTIVE."""
        if self.is_standby():
            if not self._try_become_active():
                return False
            self._log("standby promoted: lease acquired, fleet adopted")
            return True
        if not self.lease.renew():
            self._demote()
            return False
        return True

    def _try_become_active(self):
        """Contend for the lease. On success, count a takeover when a
        PRIOR holder's record stood (a first acquisition over an empty
        path is not a takeover), adopt the registered fleet, and return
        True."""
        prior = self.lease.read()
        if not self.lease.try_acquire():
            with self._lock:
                self._standby = True
            return False
        if prior is not None and \
                prior.get("holder") != self.lease.holder:
            catalog.LEASE_TAKEOVERS.inc()
            self._log("lease takeover from %r (seq %s)"
                      % (prior.get("holder"), prior.get("seq")))
        with self._lock:
            self._standby = False
        with self._shape_lock:
            self._adopt_registered()
        return True

    def _demote(self):
        """The lease was lost (expired and taken by a sibling while this
        supervisor was not renewing): stop shaping the fleet NOW. The
        replicas are ABANDONED, never killed: the new holder has adopted
        (or is adopting) them, and killing one here would be the
        split-brain double action the incarnation guard prevents."""
        with self._lock:
            orphans = len(self._replicas)
            self._replicas = []
            self._pending = []
            self._standby = True
        self._log("lease lost — demoted to standby, abandoned %d "
                  "replica(s) to the new holder" % orphans)

    def _adopt_registered(self):
        """Reconcile the fleet from the shared registry after winning the
        lease: still-healthy ``ready`` replicas are adopted IN PLACE (same
        pid, same crash counter; re-published under our incarnation, so
        the previous owner's late heartbeats are rejected), ``backoff``
        records keep their respawn gate, and dead, unready or retiring
        records are signalled and withdrawn so deficit repair replaces
        them. Returns the number adopted."""
        adopted = 0
        now_wall, now_mono = time.time(), time.monotonic()
        for rec in self.registry.records():
            slot, url = rec.get("slot"), rec.get("url")
            if slot is None or not url:
                continue
            if rec.get("role") == "cache":
                continue  # the prefix tier's record: not ours to own
            with self._lock:
                taken = {r.slot for r in self._replicas} | \
                        {p.slot for p in self._pending}
                if slot in taken:
                    continue
                self._seq += 1
                name = "r%d" % self._seq
            port = urllib.parse.urlsplit(url).port or 0
            rep = _Replica(name, port, url, rec.get("serial"),
                           _AdoptedProc(rec.get("pid")), os.devnull, slot)
            rep.failures = int(rec.get("failures", 0))
            if rec.get("state") == "ready" and self._wait_ready(
                    rep, timeout=self.adopt_ready_timeout_s):
                rep.incarnation = self.registry.publish(
                    slot, url, pid=rec.get("pid"), serial=rec.get("serial"),
                    state="ready", failures=rep.failures, role=rep.role)
                self._register(rep)
                catalog.REPLICAS_ADOPTED.inc()
                adopted += 1
                self._log("adopted replica slot=%d pid=%s url=%s "
                          "(failures=%d preserved)"
                          % (slot, rec.get("pid"), url, rep.failures))
            elif rec.get("state") == "backoff":
                # keep the crash count AND the wall-clock respawn gate: a
                # takeover must not turn one crash loop into a storm
                rep.state = "backoff"
                rep.not_before = now_mono + max(
                    0.0, rec.get("not_before_unix", 0.0) - now_wall)
                rep.incarnation = self.registry.publish(
                    slot, url, pid=rec.get("pid"), serial=rec.get("serial"),
                    state="backoff", failures=rep.failures, role=rep.role,
                    not_before_unix=rec.get("not_before_unix", 0.0))
                with self._lock:
                    self._pending.append(rep)
            else:
                # ready-but-dead, unready, or mid-retire: signal the
                # process (it may be live but slow; left alone it would
                # hold its card memory and port unsupervised) and withdraw
                # the record so deficit repair replaces it
                if rec.get("pid"):
                    try:
                        os.kill(int(rec["pid"]), signal.SIGTERM)
                    except (OSError, ValueError):
                        pass
                self.registry.withdraw(slot)
        return adopted

    def _publish_registry(self):
        """Heartbeat every owned record (routers judge freshness by it; a
        standby reads failures and backoff state at adoption). A
        :class:`StaleIncarnationError` means a newer holder re-published
        the record: that replica is no longer ours and is dropped WITHOUT
        being touched."""
        now_wall, now_mono = time.time(), time.monotonic()
        for rep in self.replicas():
            if rep.incarnation is None:
                continue
            try:
                self.registry.heartbeat(rep.slot, rep.incarnation,
                                        state=rep.state,
                                        failures=rep.failures,
                                        serial=rep.serial)
            except StaleIncarnationError:
                self._log("slot %d taken over — dropping %s unharmed"
                          % (rep.slot, rep.name))
                with self._lock:
                    if rep in self._replicas:
                        self._replicas.remove(rep)
        with self._lock:
            pending = list(self._pending)
        for rep in pending:
            nb_wall = now_wall + max(0.0, rep.not_before - now_mono)
            try:
                if rep.incarnation is None:
                    rep.incarnation = self.registry.publish(
                        rep.slot, rep.url,
                        pid=rep.proc.pid if rep.proc else None,
                        serial=rep.serial, state="backoff",
                        failures=rep.failures, role=rep.role,
                        not_before_unix=nb_wall)
                else:
                    self.registry.heartbeat(
                        rep.slot, rep.incarnation, state="backoff",
                        failures=rep.failures, not_before_unix=nb_wall)
            except StaleIncarnationError:
                with self._lock:
                    if rep in self._pending:
                        self._pending.remove(rep)

    def _repair_once(self, now):
        for rep in self.replicas():
            if self._stop.is_set():
                return
            rc = rep.proc.poll()
            if rc is None:
                if rep.state == "ready" and rep.failures and \
                        now - rep.started_mono > self.stable_after_s:
                    rep.failures = 0
                continue
            if rep.state == "retiring":
                self._remove(rep)
                continue
            # crashed: schedule a respawn behind the capped-backoff gate
            # (the sweep never sleeps out a backoff)
            sys.stderr.write("fleet: replica %s (pid %s) exited rc=%s — "
                             "restarting\n" % (rep.name, rep.proc.pid, rc))
            catalog.FLEET_RESTARTS.inc()
            self._remove(rep)
            rep.state = "backoff"
            rep.failures += 1
            rep.not_before = now + self._backoff_for(rep.failures)
            with self._lock:
                self._pending.append(rep)
        with self._lock:
            due = [p for p in self._pending
                   if p.not_before <= time.monotonic()]
        for prev in due:
            if self._stop.is_set():
                return
            with self._lock:
                self._pending.remove(prev)
                # the fleet may have been scaled down since this crash was
                # queued: drop, don't overshoot
                prefill_ns = prev.slot >= PREFILL_SLOT_BASE
                have = sum(1 for r in self._replicas + self._pending
                           if (r.slot >= PREFILL_SLOT_BASE) == prefill_ns)
                dropped = have >= (self.n_prefill if prefill_ns
                                   else self.n_replicas)
            if dropped:
                # withdraw the slot's backoff record too, or a later lease
                # takeover re-adopts the phantom and respawns a replica
                # the fleet shed on purpose
                if self.registry is not None and \
                        prev.incarnation is not None:
                    try:
                        self.registry.withdraw(prev.slot, prev.incarnation)
                    except StaleIncarnationError:
                        pass  # re-published by a newer owner: theirs
                continue
            fresh = self._spawn(self.current_serial, prev.slot)
            fresh.failures = prev.failures
            if self._wait_ready(fresh):
                self._register(fresh)
            else:
                sys.stderr.write("fleet: restarted replica %s not ready — "
                                 "will retry\n%s\n"
                                 % (fresh.name, self._log_tail(fresh)))
                self._kill(fresh)
                fresh.state = "backoff"
                fresh.failures += 1
                fresh.not_before = time.monotonic() + \
                    self._backoff_for(fresh.failures)
                with self._lock:
                    self._pending.append(fresh)
        # deficit repair per role namespace (scheduled respawns count)
        for prefill_ns, want in ((False, self.n_replicas),
                                 (True, self.n_prefill)):
            while not self._stop.is_set():
                with self._lock:
                    have = sum(
                        1 for r in self._replicas + self._pending
                        if (r.slot >= PREFILL_SLOT_BASE) == prefill_ns)
                if want - have <= 0:
                    break
                fresh = self._spawn(self.current_serial,
                                    self._free_slot(prefill=prefill_ns))
                if self._wait_ready(fresh):
                    self._register(fresh)
                else:
                    self._kill(fresh)
                    return  # no tight spawn-fail loop; next sweep

    # -- scaling -------------------------------------------------------
    def scale_to(self, n):
        """Grow or shrink the decode fleet to ``n`` replicas (clamped to
        [min_replicas, max_replicas]). Shrinking drains: the retiring
        replica leaves rotation first and finishes its in-flight work."""
        n = max(self.min_replicas, min(self.max_replicas, int(n)))
        with self._shape_lock:
            self.n_replicas = n
            while True:
                with self._lock:
                    live = [r for r in self._replicas
                            if r.state == "ready"
                            and r.slot < PREFILL_SLOT_BASE]
                    excess = len(live) - n
                if excess <= 0:
                    break
                self._retire(max(live, key=lambda r: r.slot))
            while True:
                with self._lock:
                    deficit = n - sum(
                        1 for r in self._replicas + self._pending
                        if r.slot < PREFILL_SLOT_BASE)
                if deficit <= 0:
                    break
                fresh = self._spawn(self.current_serial, self._free_slot())
                if not self._wait_ready(fresh):
                    self._kill(fresh)
                    raise RuntimeError(
                        "fleet: scale-up replica failed to become ready\n%s"
                        % self._log_tail(fresh))
                self._register(fresh)
        return n

    def autoscale_step(self):
        """One autoscale decision from the router's scraped gauges: every
        in-rotation backend at or above ``scale_up_depth`` → +1 replica;
        ``scale_down_idle_sweeps`` fully idle sweeps in a row → -1."""
        if self.router is None:
            return
        backends = [b for b in self.router.backends() if b.in_rotation()]
        if not backends:
            return
        depths = [b.queue_depth + b.active_slots for b in backends]
        # relative to the DESIRED size: with replicas transiently ejected,
        # the in-rotation count may be below n_replicas
        if min(depths) >= self.scale_up_depth and \
                self.n_replicas < self.max_replicas:
            self._idle_sweeps = 0
            self._log("autoscale: up to %d (depths %s)"
                      % (self.n_replicas + 1, depths))
            self.scale_to(self.n_replicas + 1)
        elif max(depths) == 0.0:
            self._idle_sweeps += 1
            if self._idle_sweeps >= self.scale_down_idle_sweeps and \
                    self.n_replicas > self.min_replicas:
                self._idle_sweeps = 0
                self._log("autoscale: down to %d" % (self.n_replicas - 1))
                self.scale_to(self.n_replicas - 1)
        else:
            self._idle_sweeps = 0

    # -- zero-downtime hot swap ---------------------------------------
    def _retire(self, replica):
        """Drain one replica out of the fleet: eject from routing, SIGTERM
        (the serve CLI's graceful drain), SIGKILL only on drain
        timeout."""
        replica.state = "retiring"
        if self.router is not None:
            self.router.mark_draining(replica.url)
        if replica.proc.poll() is None:
            replica.proc.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + self.drain_timeout_s
        while replica.proc.poll() is None and time.monotonic() < deadline:
            time.sleep(0.05)
        if replica.proc.poll() is None:
            sys.stderr.write("fleet: replica %s drain timed out — SIGKILL\n"
                             % replica.name)
            self._kill(replica)
        self._remove(replica)

    def hot_swap(self, serial=None):
        """Zero-downtime rolling upgrade onto ``serial`` (default: the
        newest valid serial under ``artifact_root``), one replica at a
        time, REPLACEMENT FIRST: spawn on the target serial, wait until it
        is ready and routed, then drain the old one
        (``fleet_hot_swaps_total`` counts each). Returns the number of
        replicas swapped; raises RuntimeError when a replacement cannot
        become ready (the old fleet keeps serving)."""
        if serial is None:
            found = latest_artifact(self.artifact_root or "")
            if found is None:
                raise ValueError("hot_swap: no valid artifact serial under "
                                 "%r" % self.artifact_root)
            serial = found[0]
        with self._shape_lock:
            swapped = 0
            while True:
                with self._lock:
                    stale = [r for r in self._replicas
                             if r.state == "ready" and r.serial != serial]
                if not stale:
                    break
                old = stale[0]
                # the replacement inherits the slot (label continuity)
                fresh = self._spawn(serial, old.slot)
                if not self._wait_ready(fresh):
                    tail = self._log_tail(fresh)
                    self._kill(fresh)
                    raise RuntimeError(
                        "hot_swap: replacement replica for %s never became "
                        "ready on serial %s — aborting (old fleet still "
                        "serving)\n%s" % (old.name, serial, tail))
                self._register(fresh)
                self._retire(old)
                catalog.FLEET_HOT_SWAPS.inc()
                swapped += 1
                self._log("hot-swap: %s → %s (serial %s)"
                          % (old.name, fresh.name, serial))
            self.current_serial = serial
            return swapped


# ---------------------------------------------------------------------------
# CLI — the port of tools/fleet.py
# ---------------------------------------------------------------------------

def prune_spool(spool_dir):
    """Delete the spool files of writers that are no longer alive (a fresh
    trace epoch); a live writer's file is kept, its fd still open."""
    if not spool_dir or not os.path.isdir(spool_dir):
        return
    for fn in os.listdir(spool_dir):
        if not (fn.startswith("spans_") and ".jsonl" in fn):
            continue
        try:
            pid = int(fn[len("spans_"):].split(".", 1)[0])
            os.kill(pid, 0)
            continue          # writer still alive — keep its lane
        except (ValueError, ProcessLookupError):
            pass              # malformed name or dead writer
        except PermissionError:
            continue          # alive under another uid
        try:
            os.unlink(os.path.join(spool_dir, fn))
        except OSError:
            pass


# replica flags passed on when given: (option, attribute, is_switch)
_PASSED = (("--gen-paged", "gen_paged", True),
           ("--gen-page-size", "gen_page_size", False),
           ("--gen-num-pages", "gen_num_pages", False),
           ("--gen-speculative-k", "gen_speculative_k", False),
           ("--gen-megastep-k", "gen_megastep_k", False),
           ("--kv-quant-dtype", "kv_quant_dtype", False),
           ("--kv-quant-group", "kv_quant_group", False),
           ("--gen-draft-model", "gen_draft_model", False),
           ("--kv-transfer-dir", "kv_transfer_dir", False),
           ("--prefix-tier-url", "prefix_tier_url", False),
           ("--tenant-token-budget", "tenant_token_budget", False),
           ("--tenant-token-budget-map", "tenant_token_budget_map", False),
           ("--tenant-budget-window-s", "tenant_budget_window_s", False),
           ("--tenant-held-depth", "tenant_held_depth", False),
           ("--slo-ttft-ms", "slo_ttft_ms", False),
           ("--slo-tpot-ms", "slo_tpot_ms", False),
           ("--slo-sustain-s", "slo_sustain_s", False))


def _parser():
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.serving.fleet",
        description="Run a serving fleet: a router in this process in "
                    "front of N supervised serve replicas.")
    ap.add_argument("--artifact",
                    help="fixed export_artifact dir every replica serves "
                         "(/v1/infer)")
    ap.add_argument("--artifact-root",
                    help="serial root (publish_artifact): replicas serve "
                         "the newest valid serial and hot-swap when a "
                         "newer one appears")
    ap.add_argument("--generation-model",
                    help="save_decoder dir for /v1/generate (fixed; not "
                         "hot-swapped)")
    ap.add_argument("--device", default="cuda",
                    help="torch device every replica serves on (default "
                         "cuda; a replica without a card exits non-zero)")
    ap.add_argument("--gen-paged", action="store_true",
                    help="replicas run the paged KV engine")
    ap.add_argument("--gen-page-size", type=int, default=None)
    ap.add_argument("--gen-num-pages", type=int, default=None,
                    help="replica page-pool capacity; give it explicitly "
                         "when several replicas share one card")
    ap.add_argument("--gen-speculative-k", type=int, default=None)
    ap.add_argument("--gen-megastep-k", type=int, default=None)
    ap.add_argument("--kv-quant-dtype", default=None,
                    choices=("off", "fp8", "int8"))
    ap.add_argument("--kv-quant-group", type=int, default=None)
    ap.add_argument("--gen-draft-model", default=None)
    ap.add_argument("--tenant-token-budget", type=int, default=None)
    ap.add_argument("--tenant-token-budget-map", default=None)
    ap.add_argument("--tenant-budget-window-s", type=float, default=None)
    ap.add_argument("--tenant-held-depth", type=int, default=None)
    ap.add_argument("--slo-ttft-ms", default=None)
    ap.add_argument("--slo-tpot-ms", default=None)
    ap.add_argument("--slo-sustain-s", type=float, default=None)
    ap.add_argument("--trace-sample-rate", type=float, default=None,
                    help="fraction of request traces recorded on every "
                         "replica and the router (error/5xx spans always)")
    ap.add_argument("--serve-arg", action="append", default=[],
                    metavar="ARG",
                    help="extra argument for every replica (repeatable, "
                         "e.g. --serve-arg=--gen-max-slots=16)")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--prefill-replicas", type=int, default=0,
                    help="prefill-role replicas: the router hands long "
                         "prompts to one first and decode replicas map "
                         "the published pages; needs --kv-transfer-dir "
                         "and --generation-model")
    ap.add_argument("--prefill-min-prompt", type=int, default=None,
                    help="prompts of at least this many tokens take the "
                         "prefill hop (default FLAGS_fleet_prefill_min_"
                         "prompt)")
    ap.add_argument("--kv-transfer-dir", default=None,
                    help="shared KV-page store root for every replica "
                         "(default FLAGS_kv_transfer_dir)")
    ap.add_argument("--prefix-tier-url", default=None,
                    help="prefix-tier index URL for every replica and the "
                         "router (default FLAGS_fleet_prefix_tier_url)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8600,
                    help="router port (replicas get free ports)")
    ap.add_argument("--check-interval-s", type=float, default=1.0)
    ap.add_argument("--hot-swap-poll-s", type=float, default=5.0)
    ap.add_argument("--drain-timeout", type=float, default=30.0)
    ap.add_argument("--request-timeout", type=float, default=60.0)
    ap.add_argument("--autoscale", action="store_true")
    ap.add_argument("--min-replicas", type=int, default=1)
    ap.add_argument("--max-replicas", type=int, default=8)
    ap.add_argument("--log-dir", default=None,
                    help="replica logs (default $TMPDIR/"
                         "paddle_tpu_torch_fleet)")
    ap.add_argument("--trace-spool-dir", default=None,
                    help="span spool shared by the router and the replicas "
                         "(default <log-dir>/trace; 'off' disables)")
    ap.add_argument("--registry-dir", default=None,
                    help="shared fleet registry root: run several fleet "
                         "processes over the SAME dir and every router "
                         "serves the same membership while exactly one "
                         "supervisor (the lease holder) shapes the fleet; "
                         "the rest stand by and adopt its replicas if it "
                         "dies (default FLAGS_fleet_registry_dir)")
    ap.add_argument("--lease-secs", type=float, default=None,
                    help="supervisor lease duration (default "
                         "FLAGS_fleet_lease_secs); a dead supervisor is "
                         "taken over within this many seconds")
    ap.add_argument("--standby", action="store_true",
                    help="start the supervisor as a standby even if the "
                         "lease is free (requires --registry-dir); the "
                         "router still serves the registry's membership")
    ap.add_argument("--verbose", action="store_true")
    return ap


def main(argv=None):
    ap = _parser()
    args = ap.parse_args(argv)
    if args.standby and not args.registry_dir:
        ap.error("--standby requires --registry-dir")
    if args.prefill_replicas and not args.generation_model:
        ap.error("--prefill-replicas requires --generation-model")
    if args.prefill_replicas and not args.kv_transfer_dir:
        from .. import flags
        if not flags.kv_transfer_dir:
            ap.error("--prefill-replicas requires --kv-transfer-dir (or "
                     "FLAGS_kv_transfer_dir)")
    if not args.artifact and not args.artifact_root \
            and not args.generation_model:
        ap.error("need --artifact, --artifact-root, and/or "
                 "--generation-model")
    if args.artifact and args.artifact_root:
        ap.error("--artifact and --artifact-root are exclusive")

    log_dir = args.log_dir or os.path.join(
        os.environ.get("TMPDIR", "/tmp"), "paddle_tpu_torch_fleet")
    spool_dir = args.trace_spool_dir
    if spool_dir is None:
        spool_dir = os.path.join(log_dir, "trace")
    elif spool_dir == "off":
        spool_dir = None
    prune_spool(spool_dir)
    # replicas find the package from the checkout and the spool in the env
    replica_env = dict(os.environ)
    replica_env["PYTHONPATH"] = _REPO + (
        os.pathsep + replica_env["PYTHONPATH"]
        if replica_env.get("PYTHONPATH") else "")
    if spool_dir:
        replica_env["PADDLE_TPU_TRACE_SPOOL"] = spool_dir
        tracing.enable_spool(spool_dir)   # the router's own spans too
    if args.trace_sample_rate is not None:
        from .. import flags
        flags.trace_sample_rate = args.trace_sample_rate
    if args.device.startswith("cuda") and args.generation_model:
        # K3 builds here once, before the first spawn: N cold replicas
        # would each run nvcc otherwise
        import torch
        if torch.cuda.is_available():
            from .. import _build
            _build.build(["paged_decode"])

    def make_argv(port, serial_dir):
        rep = [sys.executable, "-m", "paddle_tpu_torch.serving.serve",
               "--host", args.host, "--port", str(port),
               "--device", args.device]
        artifact = serial_dir or args.artifact
        if artifact:
            rep += ["--artifact", artifact]
        if args.generation_model:
            # the engine knobs ride the argv, so a crash restart or a roll
            # respawns a replica with the same configuration
            rep += ["--generation-model", args.generation_model]
            for opt, attr, switch in _PASSED:
                value = getattr(args, attr)
                if switch and value:
                    rep.append(opt)
                elif not switch and value is not None:
                    rep += [opt, str(value)]
        if args.trace_sample_rate is not None:
            rep += ["--trace-sample-rate", str(args.trace_sample_rate)]
        return rep + list(args.serve_arg)

    def make_prefill_argv(port, serial_dir):
        return make_argv(port, serial_dir) + ["--role", "prefill"]

    # control-plane HA: a shared registry dir makes this process one of N
    # interchangeable control planes. Its router serves the registry's
    # membership; its supervisor contends for the lease (the active one
    # shapes the fleet; standbys adopt on takeover)
    from .registry import ReplicaRegistry
    registry = None
    knobs = resolve_fleet_knobs(registry_dir=args.registry_dir,
                                lease_secs=args.lease_secs,
                                which=("registry_dir", "lease_secs"))
    if knobs["registry_dir"]:
        # records heartbeat once a supervision sweep; slow sweeps get
        # slack before routers treat the membership as stale
        registry = ReplicaRegistry(
            knobs["registry_dir"], ttl_s=max(3.0 * args.check_interval_s,
                                             knobs["lease_secs"]))
    router = FleetRouter(
        (args.host, args.port), check_interval_s=args.check_interval_s,
        request_timeout=args.request_timeout, trace_spool_dir=spool_dir,
        registry=registry, prefix_tier_url=args.prefix_tier_url,
        prefill_min_prompt=args.prefill_min_prompt, verbose=args.verbose)
    supervisor = ReplicaSupervisor(
        make_argv, replicas=args.replicas,
        prefill_replicas=args.prefill_replicas,
        make_prefill_argv=make_prefill_argv, router=router, host=args.host,
        artifact_root=args.artifact_root,
        check_interval_s=args.check_interval_s,
        drain_timeout_s=args.drain_timeout,
        hot_swap_poll_s=args.hot_swap_poll_s,
        min_replicas=args.min_replicas, max_replicas=args.max_replicas,
        registry=registry, lease_secs=args.lease_secs,
        standby=args.standby, env=replica_env, log_dir=log_dir,
        verbose=args.verbose)
    supervisor.autoscale = args.autoscale

    router.start_background()
    try:
        supervisor.start()
    except RuntimeError as e:
        print("fleet: startup failed: %s" % e, file=sys.stderr)
        router.stop(5.0)
        return 1

    done = threading.Event()

    def _drain(signum, frame):
        print("fleet: draining...", file=sys.stderr)
        done.set()

    signal.signal(signal.SIGINT, _drain)
    signal.signal(signal.SIGTERM, _drain)
    host, port = router.server_address[:2]
    role = ""
    if registry is not None:
        role = "  role=%s" % ("standby" if supervisor.is_standby()
                              else "active")
    print("fleet: router http://%s:%d  replicas=%s serial=%s ready_s=%s%s"
          % (host, port, [r.url for r in supervisor.replicas()],
             supervisor.current_serial,
             {slot_label(r.slot): round(r.ready_s, 3)
              for r in supervisor.replicas() if r.ready_s is not None},
             role),
          file=sys.stderr, flush=True)
    done.wait()
    supervisor.stop()
    router.stop(args.drain_timeout)
    print("fleet: stopped", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
