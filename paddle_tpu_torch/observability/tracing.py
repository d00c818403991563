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

* **Head sampling** — ``FLAGS_trace_sample_rate`` keeps a deterministic
  share of the request traces (a hash of the trace id, so every hop and
  every process agrees without coordination); spans carrying an
  ``error``, a 5xx ``status`` or an ``exception`` status always record.
* **Span spool** — optionally, every span is also appended (one JSON
  line, flushed per record) to ``<spool_dir>/spans_<pid>.jsonl``: the
  ring dies with a SIGKILLed replica, the spool is how its spans still
  reach the merged fleet trace. Enabled by ``FLAGS_trace_spool_dir`` /
  the ``PADDLE_TPU_TRACE_SPOOL`` env var / ``enable_spool()``; the file
  is size-capped (one rotation).
* **Merge** — ``merge_traces()`` takes per-process event sources (rings
  fetched over ``/trace``, spool files, the router's own ring), filters
  to one request, drops ring/spool double reports and emits ONE
  chrome-trace with a named lane per process — the router's
  ``/fleet/trace?request_id=`` answer.

The disaggregated path records the reference's spans too:
``kv.transfer_export``, ``kv.transfer_import`` (its ``outcome``),
``prefix_tier.lookup`` (hit, miss or disk), ``prefix_tier.unreachable`` and
``handoff.prefill_work``; the fleet router records ``router.request``,
``router.attempt`` and ``handoff.prefill``.
"""

import collections
import hashlib
import json
import os
import re
import threading
import time
import uuid

__all__ = [
    "TraceContext", "make_context", "from_headers", "new_id", "current",
    "use", "span", "record", "span_from", "note_outcome", "exemplars",
    "trace_events", "trace_dict", "enable_spool", "spool_dir",
    "spool_path", "read_spool", "event_matches", "merge_traces",
    "TRACE_HEADER", "REQUEST_HEADER",
]

TRACE_HEADER = "X-Trace-Id"
REQUEST_HEADER = "X-Request-Id"

_ID_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")
_RING_CAPACITY = 4096
_SPOOL_MAX_BYTES = 32 * 1024 * 1024  # per-process cap, one rotation


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


def _sampled(ctx):
    """Head-based sampling decision for one trace: DETERMINISTIC in the
    trace id — a hash of it is compared against
    ``FLAGS_trace_sample_rate`` — so every hop and every process a request
    crosses agrees without coordination, and a sampled trace is always
    complete. Ids still mint, propagate and echo when a trace is
    unsampled; only span recording is skipped."""
    try:
        from .. import flags
        rate = float(flags.trace_sample_rate)
    except Exception:
        return True  # sampling must never take tracing down
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    h = int(hashlib.sha1(ctx.trace_id.encode("utf-8",
                                             "replace")).hexdigest()[:8],
            16)
    return h / float(0xFFFFFFFF) < rate


def _must_record(args):
    """Error spans bypass sampling: a span carrying a truthy ``error``
    arg, a 5xx ``status`` or an exception outcome."""
    if not args:
        return False
    if args.get("error"):
        return True
    st = args.get("status")
    if st is None:
        return False
    try:
        return int(st) >= 500
    except (TypeError, ValueError):
        return st == "exception"


def _emit(name, ts_s, dur_s, ctx, args):
    if ctx is not None and not _must_record(args) and not _sampled(ctx):
        # an unsampled request trace skips the ring AND the spool; spans
        # with no context (the process's own story) always record
        return
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
    _spool_write(ev)


def trace_events():
    """Oldest-to-newest copy of the recorded spans."""
    with _ring_lock:
        return list(_ring)


def trace_dict():
    """The ring as a chrome-trace document (what ``GET /trace`` serves)."""
    return {"traceEvents": trace_events(), "displayTimeUnit": "ms",
            "metadata": {"pid": os.getpid(),
                         "capacity": _RING_CAPACITY}}


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


# -- span spool (survives the process) --------------------------------------

_spool_lock = threading.Lock()
_spool_file = None
_spool_dir = None
_spool_resolved = False


def enable_spool(dirname):
    """Route every future span to ``<dirname>/spans_<pid>.jsonl`` as well
    as the ring (None/"" disables). The file is opened at the first span
    and flushed per record, so the spans a SIGKILLed process recorded are
    on disk."""
    global _spool_dir, _spool_file, _spool_resolved
    with _spool_lock:
        if _spool_file is not None:
            _spool_file.close()
            _spool_file = None
        _spool_dir = dirname or None
        _spool_resolved = True


def spool_dir():
    _resolve_spool()
    return _spool_dir


def spool_path(pid=None, dirname=None):
    d = dirname if dirname is not None else spool_dir()
    if d is None:
        return None
    return os.path.join(d, "spans_%d.jsonl" % (pid or os.getpid()))


def _resolve_spool():
    """First-use resolution of the spool dir from the env var or the flag
    (so subprocesses configure themselves without argv plumbing)."""
    global _spool_dir, _spool_resolved
    if _spool_resolved:
        return
    with _spool_lock:
        if _spool_resolved:
            return
        d = os.environ.get("PADDLE_TPU_TRACE_SPOOL")
        if not d:
            try:
                from .. import flags
                d = flags.trace_spool_dir
            except Exception:
                d = None
        _spool_dir = d or None
        _spool_resolved = True


def _spool_write(event):
    _resolve_spool()
    if _spool_dir is None:
        return
    global _spool_file
    line = json.dumps(event, default=str)
    with _spool_lock:
        try:
            if _spool_file is None:
                os.makedirs(_spool_dir, exist_ok=True)
                _spool_file = open(spool_path(dirname=_spool_dir), "a")
            if _spool_file.tell() > _SPOOL_MAX_BYTES:
                # one rotation: the newest window survives, disk is bounded
                _spool_file.close()
                path = spool_path(dirname=_spool_dir)
                os.replace(path, path + ".1")
                _spool_file = open(path, "a")
            _spool_file.write(line + "\n")
            _spool_file.flush()
        except OSError:
            pass  # tracing must never take the serving path down


def read_spool(dirname, pid=None):
    """Load spooled spans (all processes, or one pid), tolerating a torn
    final line (the writer may have died mid-write)."""
    events = []
    if not dirname or not os.path.isdir(dirname):
        return events
    for fn in sorted(os.listdir(dirname)):
        m = re.match(r"spans_(\d+)\.jsonl(\.1)?$", fn)
        if not m or (pid is not None and int(m.group(1)) != pid):
            continue
        try:
            with open(os.path.join(dirname, fn)) as f:
                for line in f:
                    try:
                        events.append(json.loads(line))
                    except ValueError:
                        continue  # torn tail
        except OSError:
            continue
    return events


# -- request filtering + fleet merge ----------------------------------------

def event_matches(event, request_id=None, trace_id=None):
    """Whether a chrome-trace event belongs to the request/trace: its args
    carry the id directly, or list it in ``request_ids`` / ``trace_ids``
    (batch-shaped spans carry every rider)."""
    args = event.get("args") or {}
    if request_id is not None:
        if args.get("request_id") == request_id:
            return True
        if request_id in (args.get("request_ids") or ()):
            return True
    if trace_id is not None:
        if args.get("trace_id") == trace_id:
            return True
        if trace_id in (args.get("trace_ids") or ()):
            return True
    return False


def _dedupe_key(event):
    return (event.get("pid"), event.get("tid"), event.get("ts"),
            event.get("name"), event.get("dur"))


def merge_traces(sources, request_id=None, trace_id=None):
    """Merge per-process span sources into ONE chrome-trace dict.

    ``sources``: iterable of ``(label, events)``. With ``request_id`` /
    ``trace_id`` given, only matching spans are kept — and when only the
    request id is known, the trace id is recovered from the matched spans
    and used for a second sweep, so spans recorded under a sibling
    request id of the same trace still land. Events duplicated across
    sources (a live replica's ring AND its spool) are dropped; each
    contributing pid becomes one named process lane (``label (pid
    N)``)."""
    sources = [(label, list(events)) for label, events in sources]
    tids = {trace_id} if trace_id else set()
    if request_id and not trace_id:
        for _label, events in sources:
            for ev in events:
                if event_matches(ev, request_id=request_id):
                    t = (ev.get("args") or {}).get("trace_id")
                    if t:
                        tids.add(t)
    merged, seen, lanes = [], set(), {}
    for label, events in sources:
        for ev in events:
            if ev.get("ph") == "M":
                continue  # lane metadata is rebuilt below
            if request_id or tids:
                if not (event_matches(ev, request_id=request_id) or
                        any(event_matches(ev, trace_id=t)
                            for t in tids)):
                    continue
            key = _dedupe_key(ev)
            if key in seen:
                continue
            seen.add(key)
            lanes.setdefault(ev.get("pid", 0), label)
            merged.append(ev)
    merged.sort(key=lambda e: e.get("ts", 0))
    meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": "%s (pid %s)" % (label, pid)}}
            for pid, label in sorted(lanes.items())]
    return {
        "traceEvents": meta + merged,
        "displayTimeUnit": "ms",
        "metadata": {
            "request_id": request_id,
            "trace_ids": sorted(tids),
            "sources": [label for label, _ in sources],
            "span_count": len(merged),
        },
    }


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
