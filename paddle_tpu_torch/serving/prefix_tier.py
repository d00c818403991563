"""Fleet-wide content-addressed prefix-cache tier — the port of
``paddle_tpu/serving/prefix_tier.py``.

The per-process :class:`~.paged_kv.PrefixCache` amortizes a popular
system prompt WITHIN one replica; every other replica still re-prefills
it. This module makes a prefix prefilled anywhere reusable everywhere:

* the STORE is a shared directory of committed page entries in the
  ``serving/kv_transfer.py`` wire form (md5-manifest commits, so the
  disk is crash-consistent all by itself);
* the TIER SERVER (:class:`PrefixTierServer`, ``python -m
  paddle_tpu_torch.serving.prefix_tier``) is an INDEX + lease manager
  over that store: it maps every intermediate block-chain key to the
  longest committed entry covering it (one round trip answers "what is
  my longest cached prefix"), grants TTL leases to readers, and evicts
  LRU unleased entries past the capacity watermark. Its whole state is
  rebuilt from the store on startup — SIGKILL the tier and its restart
  recovers by scanning for manifests;
* the CLIENT (:class:`PrefixTierClient`) is what engines talk to. It
  degrades instead of failing: tier calls ride a short timeout and a
  consecutive-failure breaker, and when the server is unreachable the
  client falls back to DIRECT-DISK discovery (scanning the store for
  committed entries by key) — so killing the tier process costs index
  latency and partial-chain matches, never a request.

Lease semantics survive a publisher's SIGKILL by construction: the
publisher holds no lock the tier must reclaim — a torn publish has no
manifest (invisible), a committed-but-unannounced one is adopted by the
server's periodic store sweep, and a reader's lease is a TTL record in
the server that simply expires if the reader dies.

The tier reads and writes files and answers HTTP; it holds no tensor and
uses no device. With ``--registry-dir`` the tier publishes a ``role=cache``
record into the fleet registry (at :data:`CACHE_SLOT`) and heartbeats it,
so routers discover the tier's URL the way they discover replicas.

    python -m paddle_tpu_torch.serving.prefix_tier --store-dir DIR \
        [--host 127.0.0.1] [--port 8700] [--capacity-mb 512] \
        [--lease-ttl-s 30] [--sweep-interval-s 2] [--registry-dir REG]
"""

import argparse
import http.client
import json
import os
import queue
import shutil
import signal
import sys
import threading
import time
import urllib.error
import urllib.request
import uuid

from ..observability import catalog, tracing
from ..observability.http import BackgroundHTTPServer, JsonHTTPHandler
from . import kv_transfer
from . import registry as registry_mod

__all__ = ["PrefixTierClient", "PrefixTierServer", "PrefixTierStore",
           "make_tier_server", "main", "CACHE_SLOT"]

# the tier's registry record lives above both replica slot namespaces
CACHE_SLOT = 2000


# what a tier call raises when the tier is unreachable or dies mid-answer
# (a truncated body is an IncompleteRead, an HTTPException, not an OSError)
_TIER_ERRORS = (urllib.error.URLError, ConnectionError, OSError, ValueError,
                http.client.HTTPException)


def _tier_knobs(timeout_s=None, capacity_mb=None, which=None):
    from .registry import resolve_fleet_knobs
    return resolve_fleet_knobs(
        prefix_tier_timeout_s=timeout_s,
        prefix_tier_capacity_mb=capacity_mb,
        which=which or ("prefix_tier_timeout_s",
                        "prefix_tier_capacity_mb"))


# ---------------------------------------------------------------------------
# Server side: index + leases over the shared store
# ---------------------------------------------------------------------------

class _Entry:
    __slots__ = ("path", "keys", "bytes", "last_used", "leases")

    def __init__(self, path, keys, nbytes, now):
        self.path = path
        self.keys = list(keys)   # chain keys, shortest..longest
        self.bytes = nbytes
        self.last_used = now
        self.leases = {}     # lease id -> expiry (monotonic-ish clock)

    @property
    def n_pages(self):
        return len(self.keys)


class PrefixTierStore:
    """Index + lease manager over a ``kv_transfer`` store directory.

    Thread-safe (HTTP handler threads + the sweep thread); all state is
    derivable from the store, so :meth:`scan` is both cold-start
    recovery and the adoption path for entries whose publisher died
    between commit and announcement."""

    def __init__(self, root, capacity_mb=None, lease_ttl_s=30.0,
                 clock=None):
        knobs = _tier_knobs(capacity_mb=capacity_mb,
                            which=("prefix_tier_capacity_mb",))
        self.root = root
        self.capacity_bytes = int(knobs["prefix_tier_capacity_mb"]
                                  * 1024 * 1024)
        self.lease_ttl_s = float(lease_ttl_s)
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._entries = {}   # entry path -> _Entry        guarded-by: _lock
        self._by_key = {}    # chain key hex -> (path, usable pages)  guarded-by: _lock
        os.makedirs(root, exist_ok=True)
        self.scan()

    # -- recovery / adoption ------------------------------------------
    def _register_locked(self, path, meta, now):
        if path in self._entries:
            return False
        keys = meta.get("keys") or []
        if not keys:
            return False
        ent = _Entry(path, keys, kv_transfer.entry_bytes(path), now)
        self._entries[path] = ent
        for i, key_hex in enumerate(keys):
            known = self._by_key.get(key_hex)
            # the longest chain covering a key wins its index slot
            if known is None or known[1] < i + 1:
                self._by_key[key_hex] = (path, i + 1)
        return True

    def _reindex_locked(self):
        """Rebuild the key index from the surviving entries — eviction
        must not leave holes for keys that ANOTHER committed entry
        still covers (filtering out only the evicted path would)."""
        self._by_key = {}
        for path, ent in self._entries.items():
            for i, key_hex in enumerate(ent.keys):
                known = self._by_key.get(key_hex)
                if known is None or known[1] < i + 1:
                    self._by_key[key_hex] = (path, i + 1)

    def scan(self):
        """Walk the store for committed entries not yet indexed (cold
        start, or publishers that died between commit and announce).
        Torn dirs are skipped; unreadable metas ignored. Returns the
        number of entries adopted."""
        adopted = 0
        now = self._clock()
        try:
            shards = sorted(os.listdir(self.root))
        except OSError:
            return 0
        for shard in shards:
            sdir = os.path.join(self.root, shard)
            if not os.path.isdir(sdir):
                continue
            for name in sorted(os.listdir(sdir)):
                path = os.path.join(sdir, name)
                if not os.path.isfile(os.path.join(path, "_MANIFEST")):
                    continue
                with self._lock:
                    if path in self._entries:
                        continue
                try:
                    with open(os.path.join(path, "meta.json")) as f:
                        meta = json.load(f)
                except (OSError, ValueError):
                    continue
                with self._lock:
                    if self._register_locked(path, meta, now):
                        adopted += 1
        if adopted:
            self._evict_to_capacity()
        return adopted

    # -- index operations ---------------------------------------------
    def publish(self, path):
        """Announce one committed entry (the publisher already wrote
        and manifest-committed it). Verifies the manifest is present
        and the meta parseable; returns True when (newly) indexed."""
        root = os.path.abspath(self.root) + os.sep
        if not os.path.abspath(path).startswith(root):
            raise ValueError("entry %r is outside the store root %r"
                             % (path, self.root))
        if not os.path.isfile(os.path.join(path, "_MANIFEST")):
            raise ValueError("entry %r is not committed (no _MANIFEST)"
                             % path)
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        with self._lock:
            fresh = self._register_locked(path, meta, self._clock())
        self._evict_to_capacity()
        return fresh

    def lookup(self, keys_hex):
        """Longest indexed chain among ``keys_hex`` (the reader's own
        chain digests, shortest..longest). Grants a TTL lease on the
        winning entry and returns ``{"key", "path", "n_pages",
        "lease"}`` or None."""
        now = self._clock()
        with self._lock:
            for key_hex in reversed(list(keys_hex)):
                found = self._by_key.get(key_hex)
                if found is None:
                    continue
                path, usable = found
                ent = self._entries.get(path)
                if ent is None:
                    continue
                lease = uuid.uuid4().hex[:12]
                ent.leases[lease] = now + self.lease_ttl_s
                ent.last_used = now
                return {"key": key_hex, "path": path,
                        "n_pages": usable, "lease": lease,
                        "lease_ttl_s": self.lease_ttl_s}
        return None

    def release(self, path, lease):
        with self._lock:
            ent = self._entries.get(path)
            if ent is not None:
                ent.leases.pop(lease, None)
                return True
        return False

    # -- capacity / leases --------------------------------------------
    def _expire_leases_locked(self, now):
        for ent in self._entries.values():
            dead = [l for l, exp in ent.leases.items() if exp <= now]
            for l in dead:
                del ent.leases[l]

    def _evict_to_capacity(self):
        """Drop LRU UNLEASED entries until total payload bytes fit the
        capacity watermark; the entry dirs are deleted from the store
        too (the index is authoritative for liveness — direct-disk
        readers racing a delete hit a vanished manifest and fall back,
        the same path as a torn entry)."""
        removed = []
        with self._lock:
            now = self._clock()
            self._expire_leases_locked(now)
            total = sum(e.bytes for e in self._entries.values())
            if total <= self.capacity_bytes:
                return 0
            for path, ent in sorted(self._entries.items(),
                                    key=lambda kv: kv[1].last_used):
                if total <= self.capacity_bytes:
                    break
                if ent.leases:
                    continue
                del self._entries[path]
                total -= ent.bytes
                removed.append(path)
            if removed:
                self._reindex_locked()
        for path in removed:
            shutil.rmtree(path, ignore_errors=True)
            catalog.PREFIX_TIER_EVICTIONS.inc()
        return len(removed)

    def sweep(self):
        """One maintenance pass: adopt new store entries, expire
        leases, evict past capacity."""
        self.scan()
        with self._lock:
            self._expire_leases_locked(self._clock())
        self._evict_to_capacity()

    def stats(self):
        with self._lock:
            nbytes = sum(e.bytes for e in self._entries.values())
            leased = sum(1 for e in self._entries.values() if e.leases)
            return {"entries": len(self._entries),
                    "indexed_keys": len(self._by_key),
                    "bytes": nbytes, "leased_entries": leased,
                    "capacity_bytes": self.capacity_bytes,
                    "root": self.root}


class _TierHandler(JsonHTTPHandler):

    def do_GET(self):
        store = self.server.store
        if self.path == "/healthz":
            self._send_json(200, {
                "status": "ok", "ready": True, "healthy": True,
                "role": "cache", "serving": {"pid": os.getpid(),
                                             "store": store.root}})
        elif self.path == "/metrics":
            from .metrics import render_prometheus
            st = store.stats()
            self._send(200, render_prometheus(gauges={
                "prefix_tier_entries": st["entries"],
                "prefix_tier_bytes": st["bytes"],
            }), content_type="text/plain; version=0.0.4")
        elif self.path == "/v1/prefix/stats":
            self._send_json(200, store.stats())
        else:
            self._send_json(404, {"error": "unknown path %s" % self.path})

    def do_POST(self):
        store = self.server.store
        length = int(self.headers.get("Content-Length", 0))
        try:
            payload = json.loads(self.rfile.read(length) or b"{}")
        except ValueError as e:
            self._send_json(400, {"error": "bad json: %s" % e})
            return
        if self.path == "/v1/prefix/lookup":
            keys = payload.get("keys")
            if not isinstance(keys, list) or \
                    not all(isinstance(k, str) for k in keys):
                self._send_json(400, {"error": "'keys' must be a list "
                                      "of hex chain digests"})
                return
            found = store.lookup(keys)
            if found is None:
                catalog.PREFIX_TIER_REQUESTS.inc(op="lookup",
                                                 outcome="miss")
                self._send_json(404, {"error": "no cached chain"})
            else:
                catalog.PREFIX_TIER_REQUESTS.inc(op="lookup",
                                                 outcome="hit")
                self._send_json(200, found)
        elif self.path == "/v1/prefix/publish":
            try:
                fresh = store.publish(payload.get("path", ""))
            except (ValueError, OSError) as e:
                catalog.PREFIX_TIER_REQUESTS.inc(op="publish",
                                                 outcome="error")
                self._send_json(400, {"error": str(e)})
                return
            catalog.PREFIX_TIER_REQUESTS.inc(op="publish", outcome="ok")
            self._send_json(200, {"ok": True, "fresh": fresh})
        elif self.path == "/v1/prefix/release":
            ok = store.release(payload.get("path", ""),
                               payload.get("lease", ""))
            self._send_json(200, {"ok": bool(ok)})
        else:
            self._send_json(404, {"error": "unknown path %s" % self.path})


class PrefixTierServer(BackgroundHTTPServer):
    """The tier's HTTP face + background maintenance sweep."""

    def __init__(self, addr, store, sweep_interval_s=2.0, verbose=False):
        BackgroundHTTPServer.__init__(self, addr, _TierHandler,
                                      verbose=verbose)
        self.store = store
        self.sweep_interval_s = float(sweep_interval_s)
        self._stop_sweep = threading.Event()
        self._sweep_thread = None

    def start_background(self, name="prefix-tier"):
        self._stop_sweep.clear()
        self._sweep_thread = threading.Thread(
            target=self._sweep_loop, name="prefix-tier-sweep",
            daemon=True)
        self._sweep_thread.start()
        return BackgroundHTTPServer.start_background(self, name=name)

    def _sweep_loop(self):
        while not self._stop_sweep.wait(self.sweep_interval_s):
            try:
                self.store.sweep()
            except Exception as e:  # maintenance must survive anything
                sys.stderr.write("prefix tier: sweep failed: %s\n" % e)

    def stop(self, timeout=None):
        self._stop_sweep.set()
        if self._sweep_thread is not None:
            self._sweep_thread.join(timeout)
            self._sweep_thread = None
        BackgroundHTTPServer.stop(self, timeout)


def make_tier_server(store_root, host="127.0.0.1", port=0,
                     capacity_mb=None, lease_ttl_s=30.0,
                     sweep_interval_s=2.0, verbose=False):
    """Bind a :class:`PrefixTierServer` over ``store_root`` (created if
    absent); ``port=0`` picks a free port."""
    store = PrefixTierStore(store_root, capacity_mb=capacity_mb,
                            lease_ttl_s=lease_ttl_s)
    return PrefixTierServer((host, port), store,
                            sweep_interval_s=sweep_interval_s,
                            verbose=verbose)


# ---------------------------------------------------------------------------
# Client side: what engines and routers talk to
# ---------------------------------------------------------------------------

class PrefixTierClient:
    """Engine-side access to the store + tier index, built to DEGRADE:

    * every tier HTTP call rides ``FLAGS_fleet_prefix_tier_timeout_s``
      and a consecutive-failure breaker (``fail_threshold`` failures →
      skip the server for ``backoff_s``), so a dead tier adds bounded
      latency ONCE and then nothing;
    * with the server down (or none configured), :meth:`lookup_chain`
      falls back to DIRECT-DISK discovery: probing the store for
      committed entries by chain key, longest first. The fallback
      resolves only keys an entry was PUBLISHED under (its final
      chain) — exactly the prefill→decode handoff path, which is what
      must survive a tier outage; partial cross-prompt sharing needs
      the server's intermediate-chain index;
    * publishing is crash-safe at every step (the store commit is the
      durability point; the announce POST is best-effort — the
      server's sweep adopts unannounced entries).

    ``publish_now()`` (the prefill worker) commits synchronously;
    ``publish_async()`` (decode workers' cold prefills) host-copies the
    pages on the calling thread and writes/announces on a single
    background worker so the decode loop never blocks on store IO."""

    def __init__(self, store_root=None, tier_url=None, timeout_s=None,
                 fail_threshold=3, backoff_s=5.0, publish_queue=16):
        from .. import flags
        knobs = kv_transfer.resolve_kv_transfer_knobs(
            transfer_dir=store_root, which=("transfer_dir",))
        self.store_root = knobs["transfer_dir"]
        if tier_url is None:
            tier_url = flags.fleet_prefix_tier_url
        self.tier_url = (tier_url or "").rstrip("/")
        self.timeout_s = _tier_knobs(timeout_s=timeout_s)[
            "prefix_tier_timeout_s"]
        self.fail_threshold = int(fail_threshold)
        self.backoff_s = float(backoff_s)
        self._lock = threading.Lock()
        self._failures = 0        # guarded-by: _lock
        self._skip_until = 0.0    # guarded-by: _lock
        self._pub_q = queue.Queue(maxsize=int(publish_queue))
        self._pub_thread = None
        self._pub_stop = threading.Event()

    def enabled(self):
        """Anything to do at all? (No store and no server = pure local.)"""
        return bool(self.store_root or self.tier_url)

    # -- tier HTTP with breaker ---------------------------------------
    def _server_available(self):
        if not self.tier_url:
            return False
        with self._lock:
            return time.monotonic() >= self._skip_until

    def _server_ok(self):
        with self._lock:
            self._failures = 0

    def _server_failed(self):
        with self._lock:
            self._failures += 1
            if self._failures >= self.fail_threshold:
                self._skip_until = time.monotonic() + self.backoff_s
                self._failures = 0

    def _post(self, path, payload):
        """One tier POST; returns (status, doc) or raises OSError-family
        on connection failure."""
        body = json.dumps(payload).encode("utf-8")
        req = urllib.request.Request(
            self.tier_url + path, data=body,
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.timeout_s) as r:
                return r.status, json.loads(r.read() or b"{}")
        except urllib.error.HTTPError as e:
            try:
                doc = json.loads(e.read() or b"{}")
            except ValueError:
                doc = {}
            return e.code, doc

    # -- lookup --------------------------------------------------------
    def lookup_chain(self, keys_hex):
        """Longest reusable cached chain for the reader's own chain
        digests (shortest..longest). Returns ``{"key", "path",
        "n_pages"}`` or None; NEVER raises — every failure path is a
        miss plus a counter."""
        if not keys_hex or not self.enabled():
            return None
        t0 = time.perf_counter()
        if self._server_available():
            try:
                status, doc = self._post("/v1/prefix/lookup",
                                         {"keys": list(keys_hex)})
            except _TIER_ERRORS as e:
                self._server_failed()
                catalog.PREFIX_TIER_REQUESTS.inc(op="lookup",
                                                 outcome="error")
                tracing.record("prefix_tier.unreachable",
                               error="%s: %s" % (type(e).__name__, e))
            else:
                self._server_ok()
                if status == 200 and doc.get("path"):
                    catalog.PREFIX_TIER_REQUESTS.inc(op="lookup",
                                                     outcome="hit")
                    tracing.span_from(t0, "prefix_tier.lookup",
                                      outcome="hit",
                                      n_pages=doc.get("n_pages"))
                    return doc
                catalog.PREFIX_TIER_REQUESTS.inc(op="lookup",
                                                 outcome="miss")
                tracing.span_from(t0, "prefix_tier.lookup",
                                  outcome="miss")
                # fall through to disk: a just-committed handoff whose
                # announce raced the lookup is on disk already; the
                # sweep will index it shortly
        # direct-disk fallback: the store is crash-consistent on its
        # own, so a dead tier index degrades to fs probes, not misses
        if self.store_root:
            for key_hex in reversed(list(keys_hex)):
                path = kv_transfer.find_committed(self.store_root,
                                                  key_hex)
                if path is not None:
                    catalog.PREFIX_TIER_REQUESTS.inc(op="lookup",
                                                     outcome="disk")
                    tracing.span_from(t0, "prefix_tier.lookup",
                                      outcome="disk")
                    return {"key": key_hex, "path": path,
                            "n_pages": list(keys_hex).index(key_hex) + 1}
        return None

    def release(self, found):
        """Drop the TTL lease a :meth:`lookup_chain` hit granted (the
        reader is done with the entry — eviction may have it). Purely
        best-effort: an unreleased lease simply expires."""
        if not self.tier_url or not found or not found.get("lease"):
            return
        try:
            self._post("/v1/prefix/release",
                       {"path": found.get("path", ""),
                        "lease": found["lease"]})
        except _TIER_ERRORS:
            return
        catalog.PREFIX_TIER_REQUESTS.inc(op="release", outcome="ok")

    # -- publish -------------------------------------------------------
    def _meta_for(self, engine, keys):
        geo = engine.geometry()
        meta = {"keys": [k.hex() for k in keys],
                "created_unix": time.time()}
        meta.update(geo)
        return meta

    def _commit_and_announce(self, meta, ks, vs, kss=None, vss=None):
        try:
            path = kv_transfer.export_prefix(self.store_root, meta,
                                             ks, vs, k_scales=kss,
                                             v_scales=vss)
        except OSError as e:
            catalog.PREFIX_TIER_REQUESTS.inc(op="publish",
                                             outcome="error")
            tracing.record("kv.transfer_export_failed",
                           error="%s: %s" % (type(e).__name__, e))
            return None
        if self._server_available():
            try:
                self._post("/v1/prefix/publish", {"path": path})
                self._server_ok()
                catalog.PREFIX_TIER_REQUESTS.inc(op="publish",
                                                 outcome="ok")
            except _TIER_ERRORS:
                # the commit IS the durability point; the sweep adopts
                self._server_failed()
                catalog.PREFIX_TIER_REQUESTS.inc(op="publish",
                                                 outcome="error")
        return path

    def publish_now(self, engine, keys, page_ids):
        """Synchronous export + announce (the prefill worker's path —
        the ack must imply the decode worker can look the key up)."""
        if not self.store_root:
            return None
        ks, vs, kss, vss = engine.export_pages(page_ids)
        return self._commit_and_announce(self._meta_for(engine, keys),
                                         ks, vs, kss, vss)

    def publish_async(self, engine, keys, page_ids):
        """Host-copy the pages NOW (the pool is only stable this
        instant on the engine's owning thread), write + announce on the
        background worker. A full publish queue drops the publish — a
        busy decode worker sheds sharing work before decode work."""
        if not self.store_root:
            return False
        ks, vs, kss, vss = engine.export_pages(page_ids)
        item = (self._meta_for(engine, keys), ks, vs, kss, vss)
        if self._pub_thread is None:
            self._pub_thread = threading.Thread(
                target=self._pub_loop, name="prefix-tier-publish",
                daemon=True)
            self._pub_thread.start()
        try:
            self._pub_q.put_nowait(item)
            return True
        except queue.Full:
            catalog.PREFIX_TIER_REQUESTS.inc(op="publish",
                                             outcome="dropped")
            return False

    def _pub_loop(self):
        while True:
            try:
                item = self._pub_q.get(timeout=0.5)
            except queue.Empty:
                # drain-then-stop: close() must not drop queued
                # publishes that were accepted before it was called
                if self._pub_stop.is_set():
                    return
                continue
            try:
                self._commit_and_announce(*item)
            except Exception as e:  # publishing must never kill anything
                sys.stderr.write("prefix tier publish failed: %s\n" % e)

    def close(self, timeout=2.0):
        self._pub_stop.set()
        if self._pub_thread is not None:
            self._pub_thread.join(timeout)
            self._pub_thread = None


def main(argv=None):
    """``python -m paddle_tpu_torch.serving.prefix_tier``: run the tier
    index over a store directory until SIGINT/SIGTERM (the reference's
    ``tools/prefix_tier.py``). Endpoints: POST /v1/prefix/lookup
    {"keys": [hex...]} (longest cached chain + a TTL lease), POST
    /v1/prefix/publish {"path": entry}, POST /v1/prefix/release, GET
    /v1/prefix/stats, GET /healthz, GET /metrics."""
    ap = argparse.ArgumentParser(
        description="Run the fleet prefix-cache tier: the "
                    "content-addressed index + lease manager over a "
                    "shared KV-page store")
    ap.add_argument("--store-dir", default=None,
                    help="shared KV-page store root (default "
                         "FLAGS_kv_transfer_dir)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8700)
    ap.add_argument("--capacity-mb", type=float, default=None,
                    help="LRU eviction watermark over entry payload "
                         "bytes (default FLAGS_fleet_prefix_tier_"
                         "capacity_mb)")
    ap.add_argument("--lease-ttl-s", type=float, default=30.0,
                    help="reader lease duration; leased entries are "
                         "never evicted")
    ap.add_argument("--sweep-interval-s", type=float, default=2.0,
                    help="store re-scan / lease-expiry / eviction "
                         "cadence")
    ap.add_argument("--registry-dir", default=None,
                    help="fleet registry root: publish + heartbeat a "
                         "role=cache record so routers discover this "
                         "tier (default FLAGS_fleet_registry_dir)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    store_dir = kv_transfer.resolve_kv_transfer_knobs(
        transfer_dir=args.store_dir, which=("transfer_dir",))[
        "transfer_dir"]
    if not store_dir:
        ap.error("need --store-dir (or FLAGS_kv_transfer_dir)")
    server = make_tier_server(
        store_dir, host=args.host, port=args.port,
        capacity_mb=args.capacity_mb, lease_ttl_s=args.lease_ttl_s,
        sweep_interval_s=args.sweep_interval_s, verbose=args.verbose)
    server.start_background()
    registry = incarnation = None
    reg_dir = registry_mod.resolve_fleet_knobs(
        registry_dir=args.registry_dir, which=("registry_dir",))[
        "registry_dir"]
    if reg_dir:
        registry = registry_mod.ReplicaRegistry(reg_dir)
        incarnation = registry.publish(CACHE_SLOT, server.url,
                                       pid=os.getpid(), role="cache")
    done = threading.Event()

    def _stop(signum, frame):
        print("prefix tier: stopping...", file=sys.stderr)
        done.set()

    signal.signal(signal.SIGINT, _stop)
    signal.signal(signal.SIGTERM, _stop)
    st = server.store.stats()
    print("prefix tier: %s store=%s entries=%d bytes=%d"
          % (server.url, store_dir, st["entries"], st["bytes"]),
          file=sys.stderr, flush=True)
    while not done.wait(max(1.0, args.sweep_interval_s)):
        if registry is not None:
            try:
                registry.heartbeat(CACHE_SLOT, incarnation)
            except registry_mod.StaleIncarnationError:
                # another tier took the slot over: serve on, but stop
                # advertising (routers follow the registry's choice)
                registry = None
    if registry is not None:
        try:
            registry.withdraw(CACHE_SLOT, incarnation)
        except registry_mod.StaleIncarnationError:
            pass
    server.stop(5.0)
    print("prefix tier: stopped", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
