"""Admission primitives shared by the serving front ends — the part of
``paddle_tpu/serving/batcher.py`` (its lines 42-210) the generation slice
uses: the serving-knob resolver, the error types the HTTP layer maps to
status codes, the drain-rate Retry-After estimator and the per-request
future. The micro-batcher itself (``/v1/infer``) is not ported yet."""

import collections
import threading
import time

__all__ = ["OverloadedError", "ServingClosedError", "DeadlineExceededError",
           "DrainRateEstimator", "PendingResult", "resolve_serving_knobs"]


def resolve_serving_knobs(queue_depth=None):
    """Resolve the admission queue depth from the explicit value or
    ``FLAGS_serving_queue_depth`` and validate it (an int >= 1). Errors
    name the flag when the value came from the flag, the constructor
    argument when it was passed explicitly."""
    from .. import flags
    explicit = queue_depth is not None
    label = "queue_depth" if explicit else "FLAGS_serving_queue_depth"
    value = queue_depth if explicit else flags.serving_queue_depth
    try:
        depth = int(value)
    except (TypeError, ValueError):
        raise ValueError(
            "%s must be a number (got %r)" % (label, value)) from None
    if depth < 1:
        raise ValueError("%s must be >= 1 (got %s)" % (label, depth))
    return depth


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
