"""Always-on trace flight recorder — the last N spans, always recoverable
(the port of ``paddle_tpu/observability/flight_recorder.py``).

The profiler's chrome-trace spans used to exist only while
``start_profiler`` was active: a crash three hours into an untraced run
left nothing. The flight recorder is a bounded ring buffer that EVERY
``profiler.record_event`` span lands in unconditionally (cost: one dict
+ one locked deque append per span — spans here are executor-level
compile/dispatch events, a handful per step, not per-op). The last
``flags.flight_recorder_events`` spans are therefore always exportable
as chrome://tracing JSON:

* on demand — ``dump()``;
* on ``SIGUSR1`` — ``install_signal_handler()``;
* automatically when an executor step raises — ``dump_on_crash`` writes
  ``paddle_tpu_flight_<pid>_<reason>.trace.json`` under
  ``flags.trace_dump_dir`` (default: the system temp dir) so the spans
  leading up to the failure survive the process.

View dumps at chrome://tracing or ui.perfetto.dev.
"""

import collections
import json
import os
import tempfile
import threading
import time

__all__ = ["FlightRecorder", "get_recorder", "record_span", "dump",
           "dump_on_crash", "install_signal_handler", "trace_dict"]


class FlightRecorder:
    """Bounded, thread-safe ring buffer of chrome-trace ``X`` events."""

    def __init__(self, capacity=None):
        if capacity is None:
            from .. import flags
            capacity = int(flags.flight_recorder_events)
        self._lock = threading.Lock()
        self._buf = collections.deque(maxlen=max(1, int(capacity)))
        self._dropped = 0

    @property
    def capacity(self):
        return self._buf.maxlen

    @property
    def dropped(self):
        """Spans evicted so far (ring overwrites, not an error)."""
        with self._lock:
            return self._dropped

    def set_capacity(self, capacity):
        """Resize the ring, keeping the newest spans."""
        with self._lock:
            old = list(self._buf)
            self._buf = collections.deque(
                old[-max(1, int(capacity)):], maxlen=max(1, int(capacity)))
            self._dropped += len(old) - len(self._buf)

    def append_event(self, event):
        """Record one pre-built chrome-trace event dict (the profiler's
        record_event path — avoids re-stamping time)."""
        dropped = False
        with self._lock:
            if len(self._buf) == self._buf.maxlen:
                self._dropped += 1
                dropped = True
            self._buf.append(event)
        if dropped:
            from . import catalog
            catalog.FLIGHT_DROPPED.inc()

    def record(self, name, category="flight", ts_us=None, dur_us=0.0,
               args=None):
        """Record a span directly (ts defaults to now)."""
        ev = {"name": name, "cat": category, "ph": "X",
              "ts": time.time() * 1e6 if ts_us is None else ts_us,
              "dur": dur_us, "pid": os.getpid(),
              "tid": threading.get_ident()}
        if args:
            ev["args"] = dict(args)
        self.append_event(ev)

    def snapshot(self):
        """Oldest-to-newest copy of the buffered spans."""
        with self._lock:
            return list(self._buf)

    def clear(self):
        with self._lock:
            self._buf.clear()
            self._dropped = 0

    def trace_dict(self):
        """chrome://tracing JSON object for the current buffer."""
        events = self.snapshot()
        meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                 "args": {"name": "paddle_tpu flight recorder (pid %s)"
                          % pid}}
                for pid in sorted({e.get("pid", 0) for e in events})]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms",
                "metadata": {"dropped_spans": self.dropped,
                             "capacity": self.capacity}}

    def export(self, path):
        """Write the buffer as chrome-tracing JSON; returns ``path``."""
        with open(path, "w") as f:
            json.dump(self.trace_dict(), f)
        return path


_recorder = None
_recorder_lock = threading.Lock()


def get_recorder():
    """The process-wide flight recorder (created on first use)."""
    global _recorder
    if _recorder is None:
        with _recorder_lock:
            if _recorder is None:
                _recorder = FlightRecorder()
    return _recorder


def record_span(name, category="flight", ts_us=None, dur_us=0.0, args=None):
    get_recorder().record(name, category, ts_us, dur_us, args)


def trace_dict():
    return get_recorder().trace_dict()


def _dump_dir():
    from .. import flags
    return flags.trace_dump_dir or tempfile.gettempdir()


def dump(reason="manual", path=None):
    """Export the ring buffer to ``path`` (default:
    ``<trace_dump_dir>/paddle_tpu_flight_<pid>_<reason>.trace.json``)."""
    from . import catalog
    if path is None:
        path = os.path.join(
            _dump_dir(),
            "paddle_tpu_flight_%d_%s.trace.json" % (os.getpid(), reason))
    out = get_recorder().export(path)
    catalog.FLIGHT_DUMPS.inc(reason=reason)
    return out


def dump_on_crash(reason="crash"):
    """Best-effort dump from an exception handler: never raises, returns
    the written path or None. The executor calls this when a step fails
    so the spans leading up to the crash are on disk before the
    exception reaches user code."""
    try:
        return dump(reason=reason)
    except Exception:
        return None


def install_signal_handler(signum=None):
    """Dump the flight recorder on SIGUSR1 (kill -USR1 <pid> while a run
    is live). Returns True when installed; False where signals are
    unavailable (non-main thread, platforms without SIGUSR1)."""
    import signal
    if signum is None:
        signum = getattr(signal, "SIGUSR1", None)
    if signum is None:
        return False

    def _handler(sig, frame):
        dump(reason="signal")

    try:
        signal.signal(signum, _handler)
        return True
    except ValueError:  # not the main thread
        return False
