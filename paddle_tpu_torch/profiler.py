"""Host-side counters and histograms — the always-on metric storage of
``paddle_tpu/profiler.py`` (its lines 62-189), copied for the port —
and ``record_event``, the executor-level span: a
``torch.profiler.record_function`` range (so a ``torch.profiler`` trace
shows it beside the device kernels) that also lands in the flight
recorder's ring (``observability.flight_recorder``).

Thread-safe: the scheduler loop thread and every HTTP handler thread
record concurrently, and a bare ``d[k] = d.get(k, 0) + v`` would lose
increments. Histograms keep a bounded window of recent observations, so
a long-running server's memory stays flat; percentiles are over that
window.
"""

import collections
import contextlib
import os
import threading
import time

import torch

__all__ = ["incr_counter", "set_counter", "get_counters", "reset_counters",
           "pipeline_counters", "record_histogram", "get_histogram",
           "get_histograms", "histogram_percentiles", "histogram_summary",
           "reset_histograms", "record_event"]

_counters = {}
_metrics_lock = threading.RLock()

_HISTOGRAM_CAP = 16384
_histograms = {}


def incr_counter(name, value=1.0):
    """Accumulate into a named counter (thread-safe)."""
    with _metrics_lock:
        _counters[name] = _counters.get(name, 0.0) + value


def set_counter(name, value):
    """Overwrite a counter slot (gauge semantics — the typed
    ``catalog.Gauge`` uses this; plain counters never should)."""
    with _metrics_lock:
        _counters[name] = float(value)


def get_counters():
    """Snapshot of all counters (a copy)."""
    with _metrics_lock:
        return dict(_counters)


def reset_counters():
    with _metrics_lock:
        _counters.clear()


def record_histogram(name, value):
    """Record one observation into a named bounded histogram."""
    with _metrics_lock:
        h = _histograms.get(name)
        if h is None:
            h = _histograms[name] = collections.deque(maxlen=_HISTOGRAM_CAP)
        h.append(float(value))


def get_histogram(name):
    """Snapshot (a list copy) of a histogram's observation window."""
    with _metrics_lock:
        return list(_histograms.get(name, ()))


def get_histograms():
    """Locked snapshot of all histograms: {name: [observations]}."""
    with _metrics_lock:
        return {k: list(v) for k, v in _histograms.items()}


def histogram_percentiles(name, pcts=(50.0, 95.0, 99.0)):
    """Percentiles over the histogram's current window, linearly
    interpolated: ``{50.0: v, ...}``. Empty histogram -> {}."""
    vals = sorted(get_histogram(name))
    if not vals:
        return {}
    out = {}
    n = len(vals)
    for p in pcts:
        rank = (min(max(p, 0.0), 100.0) / 100.0) * (n - 1)
        lo = int(rank)
        hi = min(lo + 1, n - 1)
        out[p] = vals[lo] + (vals[hi] - vals[lo]) * (rank - lo)
    return out


def reset_histograms():
    with _metrics_lock:
        _histograms.clear()


def histogram_summary(name, pcts=(50.0, 95.0, 99.0)):
    """count/sum/min/max + requested percentiles for one histogram."""
    vals = get_histogram(name)
    if not vals:
        return {"count": 0, "sum": 0.0}
    s = {"count": len(vals), "sum": float(sum(vals)),
         "min": min(vals), "max": max(vals)}
    s["percentiles"] = histogram_percentiles(name, pcts)
    return s


def pipeline_counters():
    """The derived input-pipeline report: raw counters plus
    ``pad_waste_frac`` when token counts were recorded."""
    out = get_counters()
    tot = out.get("pad_tokens", 0.0) + out.get("real_tokens", 0.0)
    if tot:
        out["pad_waste_frac"] = out.get("pad_tokens", 0.0) / tot
    return out


@contextlib.contextmanager
def record_event(name, category="executor"):
    """A span around executor-level work (a capture, a round of replays):
    a ``torch.profiler.record_function`` range, and a chrome-trace event
    in the always-on flight recorder, recorded even when the body raises
    — the failing span itself is part of the story."""
    t0 = time.time()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        ev = {"name": name, "cat": category, "ph": "X",
              "ts": t0 * 1e6, "dur": (time.time() - t0) * 1e6,
              "pid": os.getpid(), "tid": threading.get_ident()}
        from .observability import flight_recorder
        flight_recorder.get_recorder().append_event(ev)
