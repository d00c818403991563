"""Request tracing for the port — the in-process half of
``paddle_tpu/observability/tracing.py``.

* **Trace context** — ``(trace_id, request_id)`` taken from the
  ``X-Trace-Id`` / ``X-Request-Id`` headers (validated: charset and
  length) or minted at the server edge, and echoed on every response.
* **Spans** — chrome-trace ``X`` events recorded into a bounded,
  thread-safe ring (the reference's flight recorder), with the trace ids
  attached as ``args``. ``span()`` wraps a body, ``span_from()`` records
  a span whose start was stamped earlier, ``record()`` a point event.
  Code below the request plumbing (page eviction) uses the AMBIENT
  context (``use()``/``current()``, a thread-local).
* **Exemplars** — the newest trace per ``(path, outcome)``, rendered as
  ``# EXEMPLAR`` comments beside ``requests_finished_total``.

Not ported yet: the span spool, fleet trace merge and head sampling
(every span records).
"""

import collections
import os
import re
import threading
import time
import uuid

__all__ = [
    "TraceContext", "make_context", "from_headers", "new_id", "current",
    "use", "span", "record", "span_from", "note_outcome", "exemplars",
    "trace_events", "TRACE_HEADER", "REQUEST_HEADER",
]

TRACE_HEADER = "X-Trace-Id"
REQUEST_HEADER = "X-Request-Id"

_ID_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")
_RING_CAPACITY = 4096


def new_id():
    """A fresh 16-hex-char id (trace or request)."""
    return uuid.uuid4().hex[:16]


class TraceContext:
    """One request's identity: ``trace_id`` names the end-to-end journey,
    ``request_id`` the client-visible request."""

    __slots__ = ("trace_id", "request_id")

    def __init__(self, trace_id, request_id):
        self.trace_id = trace_id
        self.request_id = request_id

    def headers(self):
        return {TRACE_HEADER: self.trace_id,
                REQUEST_HEADER: self.request_id}

    def args(self):
        return {"trace_id": self.trace_id, "request_id": self.request_id}

    def __repr__(self):
        return "TraceContext(trace=%s, request=%s)" % (self.trace_id,
                                                       self.request_id)


def _valid(value):
    return value if value and _ID_RE.match(value) else None


def make_context(trace_id=None, request_id=None):
    """Mint a context, keeping any VALID ids handed in."""
    request_id = _valid(request_id) or new_id()
    return TraceContext(_valid(trace_id) or request_id, request_id)


def from_headers(headers):
    """Context from an HTTP header mapping; None when NEITHER header is
    present (the caller mints)."""
    trace_id = _valid(headers.get(TRACE_HEADER))
    request_id = _valid(headers.get(REQUEST_HEADER))
    if trace_id is None and request_id is None:
        return None
    return make_context(trace_id, request_id)


# -- ambient context (thread-local) -----------------------------------------

_tls = threading.local()


def current():
    """The calling thread's ambient context (None outside ``use()``)."""
    return getattr(_tls, "ctx", None)


class use:
    """``with tracing.use(ctx):`` — set the ambient context; restores the
    prior one on exit."""

    def __init__(self, ctx):
        self._ctx = ctx
        self._prev = None

    def __enter__(self):
        self._prev = current()
        _tls.ctx = self._ctx
        return self._ctx

    def __exit__(self, *exc):
        _tls.ctx = self._prev
        return False


# -- span ring --------------------------------------------------------------

_ring_lock = threading.Lock()
_ring = collections.deque(maxlen=_RING_CAPACITY)


def _emit(name, ts_s, dur_s, ctx, args):
    ev_args = {}
    if ctx is not None:
        ev_args.update(ctx.args())
    if args:
        ev_args.update(args)
    ev = {"name": name, "cat": "trace", "ph": "X", "ts": ts_s * 1e6,
          "dur": max(0.0, dur_s) * 1e6, "pid": os.getpid(),
          "tid": threading.get_ident(), "args": ev_args}
    with _ring_lock:
        _ring.append(ev)


def trace_events():
    """Oldest-to-newest copy of the recorded spans."""
    with _ring_lock:
        return list(_ring)


def record(name, ts_s=None, dur_s=0.0, ctx=None, **args):
    """Record one span; ``ctx`` defaults to the ambient context, ``ts_s``
    (wall seconds) to now."""
    _emit(name, time.time() if ts_s is None else ts_s, dur_s,
          ctx if ctx is not None else current(), args)


def span_from(t0_perf, name, ctx=None, **args):
    """Record a span that started at ``t0_perf`` (a
    ``time.perf_counter()`` stamp) and ends now."""
    dur = time.perf_counter() - t0_perf
    _emit(name, time.time() - dur, dur,
          ctx if ctx is not None else current(), args)


class span:
    """``with tracing.span("engine.prefill", slot=3):`` — records the body
    as one span (also when it raises, with an ``error`` arg)."""

    def __init__(self, name, ctx=None, **args):
        self.name = name
        self.ctx = ctx
        self.args = dict(args)

    def __enter__(self):
        self._t0_wall = time.time()
        self._t0 = time.perf_counter()
        if self.ctx is None:
            self.ctx = current()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc is not None:
            self.args.setdefault(
                "error", "%s: %s" % (type(exc).__name__, exc))
        _emit(self.name, self._t0_wall, time.perf_counter() - self._t0,
              self.ctx, self.args)
        return False


# -- trace exemplars for per-outcome counters -------------------------------

_exemplar_lock = threading.Lock()
_exemplars = {}  # (path, outcome) -> (trace_id, request_id)


def note_outcome(path, outcome, ctx):
    """Remember the newest trace per (path, outcome)."""
    if ctx is None:
        return
    with _exemplar_lock:
        _exemplars[(str(path), str(outcome))] = (ctx.trace_id,
                                                 ctx.request_id)


def exemplars():
    with _exemplar_lock:
        return dict(_exemplars)
