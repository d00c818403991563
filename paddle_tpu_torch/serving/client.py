"""Stdlib client of the serving HTTP API — the port of
``paddle_tpu/serving/client.py`` (urllib only; no framework import needed
beyond this module), with failover across a list of endpoints (fleet
routers or replicas) and the fleet router's merged trace."""

import json
import random
import socket
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
import uuid

import numpy as np

from .batcher import DeadlineExceededError, OverloadedError

__all__ = ["ServingClient"]


def _new_request_id():
    return uuid.uuid4().hex[:16]


class ServingClient:
    """Talk to a ``ServingServer``: ``infer(feeds)`` → list of numpy
    arrays in fetch order; ``generate(prompt)`` → the generation result
    dict; ``healthy()``. Dense samples go as arrays or nested lists,
    ragged samples and prompts as flat lists.

    Every POST carries an ``X-Request-Id`` (minted here unless the caller
    passes ``request_id=``) and a matching ``X-Trace-Id``; the id is in
    every raised error and retry line. A 503 with ``Retry-After`` is
    retried up to ``overload_retries`` times, sleeping the server's hint
    (capped at ``backoff_cap_s``, equal-jittered) before
    :class:`OverloadedError`; a 503 without it (a draining server) is
    not. A refused or reset connection (or a read timeout) is retried up
    to ``connect_retries`` times with jittered exponential backoff.
    ``deadline_ms`` is the end-to-end budget: each attempt sends what
    remains of it as ``X-Deadline-Ms``, and an exhausted budget raises
    :class:`DeadlineExceededError` without another attempt.

    ``base_url`` may be a LIST of endpoints. A connection-level failure
    gates the failing endpoint behind a per-endpoint exponential backoff
    and rotates to the next eligible sibling at once, so a dead endpoint
    costs one failed attempt, not the request; a recovered endpoint
    rejoins when its gate expires (a success resets the gate)."""

    def __init__(self, base_url, timeout=60.0, overload_retries=3,
                 backoff_base_s=0.05, backoff_cap_s=2.0,
                 connect_retries=None, verbose=False, tenant=None):
        urls = [base_url] if isinstance(base_url, str) else list(base_url)
        if not urls:
            raise ValueError("base_url must name at least one endpoint")
        self.endpoints = [u.rstrip("/") for u in urls]
        self.timeout = timeout
        self.tenant = None if tenant is None else str(tenant)
        self.overload_retries = int(overload_retries)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.connect_retries = (self.overload_retries
                                if connect_retries is None
                                else int(connect_retries))
        self.verbose = bool(verbose)
        # pure backoffs get FULL jitter, Retry-After hints EQUAL jitter: N
        # clients that failed together must not re-arrive together
        self._jitter = random.Random()
        # per-endpoint failover state: the current endpoint, and per
        # endpoint a monotonic not-before gate and its next backoff
        self._ep_lock = threading.Lock()
        self._ep_idx = 0                              # guarded-by: _ep_lock
        self._ep_not_before = [0.0] * len(self.endpoints)
        self._ep_backoff = [self.backoff_base_s] * len(self.endpoints)

    @property
    def base_url(self):
        """The endpoint currently in use."""
        with self._ep_lock:
            return self.endpoints[self._ep_idx]

    def _current_endpoint(self):
        with self._ep_lock:
            return self._ep_idx, self.endpoints[self._ep_idx]

    def _endpoint_failed(self, idx):
        """Gate a failing endpoint behind its (exponential, capped) backoff
        and rotate to the next eligible sibling. Returns the seconds to
        sleep before the next attempt: 0.0 when a sibling is eligible now,
        otherwise the wait until the soonest gate opens."""
        now = time.monotonic()
        with self._ep_lock:
            self._ep_not_before[idx] = now + self._ep_backoff[idx]
            self._ep_backoff[idx] = min(self._ep_backoff[idx] * 2,
                                        self.backoff_cap_s)
            n = len(self.endpoints)
            for step in range(1, n + 1):
                cand = (idx + step) % n
                if self._ep_not_before[cand] <= now:
                    self._ep_idx = cand
                    return 0.0
            soonest = min(range(n), key=self._ep_not_before.__getitem__)
            self._ep_idx = soonest
            return max(0.0, self._ep_not_before[soonest] - now)

    def _endpoint_ok(self, idx):
        with self._ep_lock:
            self._ep_not_before[idx] = 0.0
            self._ep_backoff[idx] = self.backoff_base_s

    def _log(self, msg, always=False):
        if always or self.verbose:
            sys.stderr.write("paddle_tpu_torch serving client: %s\n" % msg)

    def _request(self, path, data=None, request_id=None, deadline_ms=None,
                 url=None, tenant=None):
        headers = {}
        if data is not None:
            headers["Content-Type"] = "application/json"
            if request_id:
                headers["X-Request-Id"] = request_id
                headers["X-Trace-Id"] = request_id
            if deadline_ms is not None:
                # the REMAINING budget at send time
                headers["X-Deadline-Ms"] = str(int(deadline_ms))
            tid = self.tenant if tenant is None else str(tenant)
            if tid:
                headers["X-Tenant-Id"] = tid
        timeout = self.timeout
        if deadline_ms is not None:
            timeout = min(timeout, deadline_ms / 1e3 + 1.0)
        req = urllib.request.Request(
            (url or self.base_url) + path, data=data, headers=headers,
            method="POST" if data is not None else "GET")
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return r.status, r.read(), r.headers
        except urllib.error.HTTPError as e:
            return e.code, e.read(), e.headers

    def _post_with_retry(self, path, payload, request_id=None,
                         deadline_ms=None, tenant=None):
        """POST with the overload and connection retries, rotating across
        ``endpoints`` with per-endpoint backoff gates on connection
        failures; (status, raw body, request id), the status never a
        retryable 503."""
        rid = request_id or _new_request_id()
        body = json.dumps(payload).encode("utf-8")
        t0 = time.monotonic()
        backoff = self.backoff_base_s
        attempts = conn_attempts = 0

        def _check_budget(wait_s=0.0):
            if deadline_ms is None:
                return None
            rem = float(deadline_ms) - (time.monotonic() - t0) * 1e3
            if rem - wait_s * 1e3 <= 0:
                raise DeadlineExceededError(
                    "deadline of %d ms exhausted after %d attempt(s) "
                    "(request_id=%s)" % (deadline_ms,
                                         attempts + conn_attempts, rid))
            return rem

        while True:
            rem = _check_budget()
            idx, url = self._current_endpoint()
            try:
                status, raw, headers = self._request(
                    path, data=body, request_id=rid, deadline_ms=rem,
                    url=url, tenant=tenant)
            except (urllib.error.URLError, ConnectionError, TimeoutError,
                    socket.timeout) as e:
                if conn_attempts >= self.connect_retries:
                    self._log("POST %s request_id=%s failed after %d "
                              "connection retries: %s"
                              % (path, rid, conn_attempts, e), always=True)
                    e.request_id = rid
                    raise
                conn_attempts += 1
                # rotate first: with an eligible sibling the retry goes
                # there now (wait 0); only an all-gated endpoint set costs
                # a sleep, full-jittered
                wait = self._endpoint_failed(idx)
                wait = max(wait, self._jitter.uniform(0.0, backoff)
                           if wait else 0.0)
                _check_budget(wait)
                self._log("POST %s request_id=%s connection retry %d/%d "
                          "in %.2fs (endpoint %s): %s"
                          % (path, rid, conn_attempts, self.connect_retries,
                             wait, url, e), always=True)
                if wait:
                    time.sleep(wait)
                backoff = min(backoff * 2, self.backoff_cap_s)
                continue
            self._endpoint_ok(idx)
            if status != 503:
                return status, raw, rid
            retry_after = headers.get("Retry-After") if headers else None
            if retry_after is None or attempts >= self.overload_retries:
                raise OverloadedError("%s (request_id=%s)"
                                      % (self._error_of(raw), rid))
            try:
                delay = float(retry_after)
            except ValueError:
                delay = backoff
            delay = max(0.0, min(delay, self.backoff_cap_s))
            # equal jitter: mostly honor the hint, but never let every
            # rejected client return at the same tick
            delay = delay / 2 + self._jitter.uniform(0.0, delay / 2)
            _check_budget(delay)
            self._log("POST %s request_id=%s overloaded (503), retry %d/%d "
                      "in %.2fs" % (path, rid, attempts + 1,
                                    self.overload_retries, delay))
            time.sleep(delay)
            backoff = min(backoff * 2, self.backoff_cap_s)
            attempts += 1

    @staticmethod
    def _jsonable(value):
        if isinstance(value, np.ndarray):
            return value.tolist()
        if isinstance(value, (list, tuple)):
            return [ServingClient._jsonable(v) for v in value]
        if isinstance(value, (np.integer, np.floating)):
            return value.item()
        return value

    @staticmethod
    def _error_of(raw):
        try:
            return json.loads(raw).get("error",
                                       raw.decode("utf-8", "replace"))
        except ValueError:
            return raw.decode("utf-8", "replace")

    @staticmethod
    def _raise_for_status(path, status, raw, rid, deadline_ms):
        """A 504 is :class:`DeadlineExceededError` when the body says
        ``deadline_exceeded`` or the caller set a budget; any other
        non-200 a ``RuntimeError`` with the server's message."""
        if status == 200:
            return
        if status == 504:
            is_policy = deadline_ms is not None
            try:
                is_policy = is_policy or \
                    json.loads(raw).get("deadline_exceeded") is True
            except (TypeError, ValueError):
                pass
            if is_policy:
                raise DeadlineExceededError(
                    "%s deadline exceeded (request_id=%s): %s"
                    % (path, rid, ServingClient._error_of(raw)))
        raise RuntimeError("%s HTTP %d (request_id=%s): %s"
                           % (path, status, rid,
                              ServingClient._error_of(raw)))

    def infer(self, feeds, request_id=None, deadline_ms=None, outcome=None):
        """Outputs in fetch order. ``outcome`` (the client's feedback
        label) makes the server log a ``serving_event`` record."""
        payload = {"feeds": {k: self._jsonable(v) for k, v in feeds.items()}}
        if outcome is not None:
            payload["outcome"] = self._jsonable(outcome)
        status, raw, rid = self._post_with_retry(
            "/v1/infer", payload, request_id=request_id,
            deadline_ms=deadline_ms)
        self._raise_for_status("/v1/infer", status, raw, rid, deadline_ms)
        return [np.asarray(o) for o in json.loads(raw)["outputs"]]

    def generate(self, prompt, max_new_tokens=None, temperature=0.0,
                 request_id=None, deadline_ms=None, priority=None,
                 tenant=None):
        """Generation from a flat list of token ids: the server's result
        dict (``tokens``, ``finish_reason``, ``n_prompt``,
        ``latency_ms``, ``request_id``, ``slo``)."""
        payload = {"prompt": [int(t) for t in
                              np.asarray(prompt).reshape(-1)]}
        if max_new_tokens is not None:
            payload["max_new_tokens"] = int(max_new_tokens)
        if temperature:
            payload["temperature"] = float(temperature)
        if priority is not None:
            payload["priority"] = priority
        status, raw, rid = self._post_with_retry(
            "/v1/generate", payload, request_id=request_id,
            deadline_ms=deadline_ms, tenant=tenant)
        self._raise_for_status("/v1/generate", status, raw, rid,
                               deadline_ms)
        result = json.loads(raw)
        result.setdefault("request_id", rid)
        return result

    def healthy(self):
        """Whether /healthz answers 200 with status ok (an unreachable or
        draining server is not healthy)."""
        try:
            status, raw, _ = self._request("/healthz")
        except OSError:
            return False
        if status != 200:
            return False
        try:
            return json.loads(raw).get("status") == "ok"
        except ValueError:
            return False

    def health(self):
        """The /healthz document with its ``http_status``; raises on an
        unreachable server."""
        status, raw, _ = self._request("/healthz")
        try:
            doc = json.loads(raw)
        except ValueError:
            doc = {"status": raw.decode("utf-8", "replace").strip()}
        doc["http_status"] = status
        return doc

    def metrics_text(self):
        status, raw, _ = self._request("/metrics")
        if status != 200:
            raise RuntimeError("/metrics HTTP %d" % status)
        return raw.decode("utf-8")

    def metrics(self):
        """/metrics as {metric: value} (quantile lines keyed as
        ``name{quantile="x"}``)."""
        out = {}
        for line in self.metrics_text().splitlines():
            if not line or line.startswith("#"):
                continue
            name, _, val = line.rpartition(" ")
            try:
                out[name] = float(val)
            except ValueError:
                pass
        return out

    def fetch_trace(self, request_id):
        """GET the fleet router's merged trace for ``request_id``
        (/fleet/trace): from a failed request id to its cross-process
        chrome-trace in one call. Raises RuntimeError (with the id) on a
        non-200."""
        status, raw, _ = self._request(
            "/fleet/trace?request_id=%s"
            % urllib.parse.quote(str(request_id), safe=""))
        if status != 200:
            raise RuntimeError("/fleet/trace HTTP %d (request_id=%s): %s"
                               % (status, request_id, self._error_of(raw)))
        return json.loads(raw)
