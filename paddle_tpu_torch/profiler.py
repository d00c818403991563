"""Host-side counters and histograms — the always-on metric storage of
``paddle_tpu/profiler.py`` (its lines 62-139), copied for the port.

Thread-safe: the scheduler loop thread and every HTTP handler thread
record concurrently, and a bare ``d[k] = d.get(k, 0) + v`` would lose
increments. Histograms keep a bounded window of recent observations, so
a long-running server's memory stays flat; percentiles are over that
window.
"""

import collections
import threading

__all__ = ["incr_counter", "get_counters", "reset_counters",
           "record_histogram", "get_histogram", "get_histograms",
           "histogram_percentiles", "reset_histograms"]

_counters = {}
_metrics_lock = threading.RLock()

_HISTOGRAM_CAP = 16384
_histograms = {}


def incr_counter(name, value=1.0):
    """Accumulate into a named counter (thread-safe)."""
    with _metrics_lock:
        _counters[name] = _counters.get(name, 0.0) + value


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
