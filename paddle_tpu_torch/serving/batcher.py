"""Dynamic micro-batcher — the queue half of ``/v1/infer``, the port of
``paddle_tpu/serving/batcher.py``, with the admission primitives the
generation scheduler shares (the knob resolver, the error types the HTTP
layer maps to status codes, the drain-rate Retry-After estimator, the
per-request future).

Adaptive batching in front of an :class:`~.session.InferenceSession`:

  request → bounded queue → [batcher thread] window (flush on
  ``max_batch_size`` OR ``max_wait_ms``) → assemble (host) → dispatch
  (the device, no sync) → in-flight queue → [completion thread] sync +
  split → per-request futures resolve

While window N runs on the device, the batcher thread assembles window
N+1. The in-flight queue holds at most ``max_inflight`` windows (device
backpressure); a full admission queue rejects with
:class:`OverloadedError` (HTTP 503) instead of letting latency grow.

Metrics (profiler counters and histograms, the reference's names):
``serving_requests_total``, ``serving_rejected_total``,
``serving_batches_total``, ``serving_batched_requests_total``
(occupancy = batched / batches), ``serving_queue_wait_s``,
``serving_device_wait_s``, ``serving_latency_ms`` and
``serving_batch_size`` histograms.
"""

import collections
import queue
import threading
import time

from .. import profiler
from ..observability import catalog, tracing

__all__ = ["MicroBatcher", "OverloadedError", "ServingClosedError",
           "DeadlineExceededError", "DrainRateEstimator", "PendingResult",
           "resolve_serving_knobs"]


def resolve_serving_knobs(max_batch_size=None, max_wait_ms=None,
                          queue_depth=None, which=None):
    """Resolve ``(max_batch_size, max_wait_ms, queue_depth)`` from the
    explicit values or the ``FLAGS_serving_*`` defaults, validating each
    (batch size and depth ints >= 1, wait a number >= 0). ``which``
    limits resolution to the named knobs (the generation scheduler
    resolves only ``queue_depth``, so a bad batcher-only flag cannot fail
    a generation process); the others come back None. Errors name the
    flag when the value came from the flag, the argument when it was
    passed explicitly."""

    def _num(value, flag_value, flag, lo, cast=int):
        explicit = value is not None
        label = flag[len("serving_"):] if explicit else "FLAGS_" + flag
        if not explicit:
            value = flag_value
        try:
            v = cast(value)
        except (TypeError, ValueError):
            raise ValueError(
                "%s must be a number (got %r)" % (label, value)) from None
        if v < lo:
            raise ValueError(
                "%s must be >= %s (got %s)" % (label, lo, v))
        return v

    from .. import flags
    which = frozenset(which) if which is not None else frozenset(
        ("max_batch_size", "max_wait_ms", "queue_depth"))
    return (
        _num(max_batch_size, flags.serving_max_batch_size,
             "serving_max_batch_size", 1)
        if "max_batch_size" in which else None,
        _num(max_wait_ms, flags.serving_max_wait_ms,
             "serving_max_wait_ms", 0.0, float)
        if "max_wait_ms" in which else None,
        _num(queue_depth, flags.serving_queue_depth,
             "serving_queue_depth", 1)
        if "queue_depth" in which else None,
    )


class OverloadedError(RuntimeError):
    """Admission queue full — the explicit backpressure signal (HTTP 503
    + Retry-After). ``retry_after`` (seconds), when set by the raiser,
    comes from the OBSERVED drain rate."""

    retry_after = None


class ServingClosedError(RuntimeError):
    """submit() after close() began."""


class DeadlineExceededError(RuntimeError):
    """The request's end-to-end deadline (``X-Deadline-Ms``) expired —
    HTTP 504. Raised at admission (dead on arrival, before any compute)
    or by the scheduler's between-step eviction."""


class DrainRateEstimator:
    """Observed drain rate → Retry-After hints for overload 503s: a
    backlog of N requests drains in ~``N / rate`` seconds, clamped to
    ``[floor_s, cap_s]``."""

    def __init__(self, floor_s, cap_s, window=64, clock=None):
        self.floor_s = float(floor_s)
        self.cap_s = float(cap_s)
        self._clock = clock or time.monotonic
        self._lock = threading.Lock()
        self._finishes = collections.deque(maxlen=int(window))

    def note_finish(self, n=1):
        with self._lock:
            self._finishes.append((self._clock(), int(n)))

    def rate(self):
        """Finishes per second over the retained window; None before two
        observations exist (the first only anchors the span)."""
        with self._lock:
            if len(self._finishes) < 2:
                return None
            t0, n0 = self._finishes[0]
            total = sum(n for _, n in self._finishes) - n0
        span = self._clock() - t0
        if span <= 0 or total <= 0:
            return None
        return total / span

    def retry_after(self, backlog):
        """Seconds a client should wait before retrying; a conservative
        1 s (clamped) before any drain data exists."""
        r = self.rate()
        est = 1.0 if not r else max(0, backlog) / r
        return min(self.cap_s, max(self.floor_s, est))


class PendingResult:
    """One request's future. ``wait()`` blocks for the result or re-raises
    the failure. ``trace`` carries the request's ``TraceContext``;
    ``summary`` is filled at resolution (the ``X-Trace-Summary``
    header); ``deadline`` is an absolute ``perf_counter`` stamp or None;
    ``priority`` is the request's class ("high" or "low") and ``tenant``
    its ``X-Tenant-Id`` (None = anonymous), both set by the generation
    scheduler's ``submit``."""

    __slots__ = ("_event", "_result", "_error", "t_enqueue", "t_done",
                 "trace", "summary", "deadline", "priority", "tenant")

    def __init__(self, trace=None):
        self._event = threading.Event()
        self._result = None
        self._error = None
        self.t_enqueue = time.perf_counter()
        self.t_done = None
        self.trace = trace
        self.summary = None
        self.deadline = None
        self.priority = "high"
        self.tenant = None

    def _resolve(self, result):
        self._result = result
        self.t_done = time.perf_counter()
        self._event.set()

    def _fail(self, error):
        self._error = error
        self.t_done = time.perf_counter()
        self._event.set()

    def done(self):
        return self._event.is_set()

    def wait(self, timeout=None):
        if not self._event.wait(timeout):
            raise TimeoutError("result not ready within %ss" % timeout)
        if self._error is not None:
            raise self._error
        return self._result


class _STOP:
    pass


class MicroBatcher:
    """Dynamic micro-batching in front of one session (``assemble`` /
    ``dispatch`` / ``collect``). ``max_batch_size`` / ``max_wait_ms`` /
    ``queue_depth`` default to the ``serving_*`` flags; ``max_inflight``
    bounds the windows on the device at once (2 = double buffering)."""

    def __init__(self, session, max_batch_size=None, max_wait_ms=None,
                 queue_depth=None, max_inflight=2):
        from .registry import resolve_fleet_knobs
        self.session = session
        max_batch_size, max_wait_ms, depth = resolve_serving_knobs(
            max_batch_size=max_batch_size, max_wait_ms=max_wait_ms,
            queue_depth=queue_depth)
        # only the Retry-After clamps
        fleet_knobs = resolve_fleet_knobs(
            which=("shed_retry_floor_s", "shed_retry_cap_s"))
        self.drain_rate = DrainRateEstimator(
            fleet_knobs["shed_retry_floor_s"],
            fleet_knobs["shed_retry_cap_s"])
        self.max_batch_size = max_batch_size
        self.max_wait_s = max_wait_ms / 1000.0
        self._q = queue.Queue(maxsize=depth)
        self._inflight = queue.Queue(maxsize=max(1, int(max_inflight)))
        self._syncing = 0  # requests in the window being synced now
        self._closed = False
        # serializes submit()'s closed-check-then-enqueue against
        # close()'s sentinel push, so no request lands behind the drain
        self._admit_lock = threading.Lock()
        self._close_lock = threading.Lock()
        self._inflight_stop_sent = False
        self._drained = threading.Event()
        self._batcher = threading.Thread(target=self._batch_loop,
                                         name="serving-batcher",
                                         daemon=True)
        self._completer = threading.Thread(target=self._complete_loop,
                                           name="serving-completer",
                                           daemon=True)
        self._batcher.start()
        self._completer.start()

    # -- client surface ------------------------------------------------
    def submit(self, feeds, trace=None, deadline_ms=None):
        """Enqueue one request (a dict of single-sample feeds); a
        :class:`PendingResult`. Raises :class:`OverloadedError` when the
        queue is full, :class:`ServingClosedError` after ``close()``.
        ``deadline_ms`` (the remaining budget) fails a request still
        queued when it passes with :class:`DeadlineExceededError`."""
        pending = PendingResult(trace=trace)
        if deadline_ms is not None:
            pending.deadline = pending.t_enqueue + \
                max(0.0, float(deadline_ms)) / 1e3
        with self._admit_lock:
            if self._closed:
                raise ServingClosedError("serving is shut down")
            try:
                self._q.put_nowait((pending, feeds))
            except queue.Full:
                profiler.incr_counter("serving_rejected_total")
                err = OverloadedError(
                    "request queue full (depth %d) — retry later"
                    % self._q.maxsize)
                err.retry_after = self.drain_rate.retry_after(
                    self._q.qsize())
                raise err from None
        profiler.incr_counter("serving_requests_total")
        return pending

    def infer(self, feeds, timeout=None, trace=None):
        """Blocking submit → wait."""
        return self.submit(feeds, trace=trace).wait(timeout)

    def queue_depth(self):
        """Live admission-queue depth (the /metrics gauge)."""
        return self._q.qsize()

    def residue(self):
        """What is in flight now (a timed-out drain reports it): queued
        requests, windows on the device, the requests being synced."""
        return {"queued": self._q.qsize(),
                "inflight_batches": self._inflight.qsize()
                + (1 if self._syncing else 0),
                "syncing_requests": self._syncing}

    def close(self, timeout=None):
        """Graceful drain: stop admitting, flush every queued request (a
        short final window included), stop the workers. True when
        drained; False when ``timeout`` expired with a window still on
        the device (call again to finish)."""
        with self._close_lock:
            if self._drained.is_set():
                return True
            if not self._closed:
                with self._admit_lock:
                    self._closed = True
                # behind every admitted request
                self._q.put((_STOP, None))
            self._batcher.join(timeout)
            if self._batcher.is_alive():
                # the completer must outlive the batcher, or windows in
                # flight would never resolve
                return False
            if not self._inflight_stop_sent:
                self._inflight_stop_sent = True
                self._inflight.put(_STOP)
            self._completer.join(timeout)
            if self._completer.is_alive():
                return False
            while True:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    break
                if item[0] is not _STOP:
                    item[0]._fail(ServingClosedError("serving shut down"))
            self._drained.set()
            return True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- batcher thread: window collection + assemble + dispatch -------
    def _collect_window(self):
        """Block for the first request, then fill the window until
        ``max_batch_size`` or the ``max_wait_ms`` deadline. Returns
        (window, saw_stop)."""
        first = self._q.get()
        if first[0] is _STOP:
            return [], True
        window = [first]
        deadline = time.perf_counter() + self.max_wait_s
        while len(window) < self.max_batch_size:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                item = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if item[0] is _STOP:
                return window, True
            window.append(item)
        return window, False

    def _drain_after_stop(self):
        """Flush what was admitted before the stop sentinel (a racing
        submit can land behind it) in full windows."""
        leftovers = []
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item[0] is not _STOP:
                leftovers.append(item)
        for i in range(0, len(leftovers), self.max_batch_size):
            self._dispatch_window(leftovers[i:i + self.max_batch_size])

    def _dispatch_window(self, window):
        # a request whose deadline passed while queued gets its 504 now
        # and no share of a dispatch
        now = time.perf_counter()
        live = []
        for p, f in window:
            if p.deadline is not None and now > p.deadline:
                catalog.DEADLINE_EXCEEDED.inc(stage="queue")
                self._finish_metrics(p, "deadline")
                p._fail(DeadlineExceededError(
                    "deadline exceeded while queued (%.0f ms over) — "
                    "rejected before batch assembly"
                    % ((now - p.deadline) * 1e3)))
            else:
                live.append((p, f))
        window = live
        if not window:
            return
        pendings = [p for p, _ in window]
        t0 = time.perf_counter()
        for p in pendings:
            profiler.incr_counter("serving_queue_wait_s", t0 - p.t_enqueue)
            if p.trace is not None:
                tracing.span_from(p.t_enqueue, "infer.queue_wait",
                                  ctx=p.trace)
        traced = [p.trace.request_id for p in pendings
                  if p.trace is not None]
        try:
            with tracing.span("infer.batch", n=len(window),
                              request_ids=traced):
                plan = self.session.assemble([f for _, f in window])
                handle = self.session.dispatch(plan)
        except Exception as e:  # bad request data fails only its window
            for p in pendings:
                self._finish_metrics(p, "error")
                p._fail(e)
            # error completions free queue capacity too
            self.drain_rate.note_finish(len(pendings))
            return
        profiler.incr_counter("serving_batches_total")
        profiler.incr_counter("serving_batched_requests_total",
                              float(len(window)))
        profiler.record_histogram("serving_batch_size", len(window))
        # blocks while max_inflight windows are on the device
        self._inflight.put((handle, pendings))

    @staticmethod
    def _finish_metrics(pending, outcome, batch_size=None):
        """Per-request resolution: the outcome counter (with its trace
        exemplar) and the summary the HTTP layer returns as
        ``X-Trace-Summary``."""
        catalog.REQUESTS_FINISHED.inc(path="infer", outcome=outcome)
        tracing.note_outcome("infer", outcome, pending.trace)
        pending.summary = {
            "outcome": outcome,
            "latency_ms": round((time.perf_counter() - pending.t_enqueue)
                                * 1e3, 3),
        }
        if batch_size is not None:
            pending.summary["batch_size"] = batch_size
        if pending.trace is not None:
            tracing.span_from(pending.t_enqueue, "infer.request",
                              ctx=pending.trace, outcome=outcome,
                              batch_size=batch_size)

    def _batch_loop(self):
        while True:
            try:
                window, saw_stop = self._collect_window()
            except Exception:
                break  # queue torn down
            if window:
                self._dispatch_window(window)
            if saw_stop:
                self._drain_after_stop()
                break

    # -- completion thread: sync + split + resolve ---------------------
    def _complete_loop(self):
        while True:
            item = self._inflight.get()
            if item is _STOP:
                break
            handle, pendings = item
            self._syncing = len(pendings)
            traced = [p.trace.request_id for p in pendings
                      if p.trace is not None]
            try:
                with tracing.span("infer.sync", n=len(pendings),
                                  request_ids=traced):
                    results = self.session.collect(handle)
            except Exception as e:
                for p in pendings:
                    self._finish_metrics(p, "error",
                                         batch_size=len(pendings))
                    p._fail(e)
                self.drain_rate.note_finish(len(pendings))
                self._syncing = 0
                continue
            now = time.perf_counter()
            for p, res in zip(pendings, results):
                profiler.record_histogram("serving_latency_ms",
                                          (now - p.t_enqueue) * 1e3)
                self._finish_metrics(p, "ok", batch_size=len(pendings))
                p._resolve(res)
            self.drain_rate.note_finish(len(pendings))
            self._syncing = 0
