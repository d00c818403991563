"""Per-step telemetry — what ``Executor.run`` and ``Executor.run_steps``
emit (the port of ``paddle_tpu/observability/steps.py``).

Every step lands in the metric registry (counters + the ``step_seconds``
histogram) and, when a run log is active (``runlog.start_run_log``), as
one JSONL record — so a multi-hour run is scrapeable live via the
monitor endpoint AND replayable post-mortem from the log.

``attribute_cache_miss`` answers the question the bare hit/miss counter
can't: WHY did this step need a new executable? In the port a miss is a
new CUDA-graph capture (``run_steps`` on the card) or a new cached step
plan (``run``). It diffs the step's config against the last config of
the same program and names the first field that changed
(feed_signature = a new padded shape walked in; program_version = the
program was mutated; mode = is_test/amp flipped...).
"""

from . import catalog, liveness, runlog
from .. import profiler

__all__ = ["attribute_cache_miss", "emit_step", "emit_step_error",
           "step_summary"]

# diff priority: the common/interesting causes first
_CAUSE_FIELDS = ("program_version", "feed_signature", "fetch_list",
                 "param_set", "mode", "n_steps")


def attribute_cache_miss(prev, cur):
    """Cause string for a compile-cache miss. ``prev``/``cur`` are dicts
    over _CAUSE_FIELDS (prev=None -> first compile of this program)."""
    if prev is None:
        return "first_compile"
    for f in _CAUSE_FIELDS:
        if prev.get(f) != cur.get(f):
            return f
    return "cache_evicted"


def emit_step(step, n_steps=1, feed_wait_s=0.0, compile_s=None,
              dispatch_s=0.0, cache=None, cause=None, real_tokens=0.0,
              pad_tokens=0.0, executor="executor"):
    """Record one executed step (or one run_steps device loop of
    ``n_steps``) into the registry + the active run log. ``cache`` is
    "hit"/"miss"/None (None: eager/host-op path, nothing compiled)."""
    catalog.STEPS_TOTAL.inc(n_steps)
    # /healthz truthfulness: every executed step stamps the liveness
    # record, so "last step + age" is accurate for any run
    liveness.report_progress(step + n_steps - 1)
    if cache == "hit":
        catalog.COMPILE_CACHE_HITS.inc()
    elif cache == "miss":
        catalog.COMPILE_CACHE_MISSES.inc(cause=cause or "unknown")
        if compile_s:
            catalog.COMPILE_SECONDS.inc(compile_s)
    catalog.STEP_SECONDS.observe(dispatch_s + feed_wait_s +
                                 (compile_s or 0.0))
    log = runlog.get_run_log()
    if log is not None:
        rec = {"kind": "step", "step": int(step), "n_steps": int(n_steps),
               "executor": executor,
               "feed_wait_s": round(float(feed_wait_s), 6),
               "dispatch_s": round(float(dispatch_s), 6),
               "cache": cache}
        if cache == "miss":
            rec["cause"] = cause or "unknown"
            rec["compile_s"] = round(float(compile_s or 0.0), 6)
        tot = float(real_tokens) + float(pad_tokens)
        if tot:
            rec["real_tokens"] = int(real_tokens)
            rec["pad_tokens"] = int(pad_tokens)
            rec["pad_waste_frac"] = round(float(pad_tokens) / tot, 4)
        log.write(rec)


def emit_step_error(step, error, trace_dump=None, executor="executor"):
    """Record a failed step in the run log (the flight-recorder dump the
    executor just wrote is referenced by path)."""
    log = runlog.get_run_log()
    if log is not None:
        log.write({"kind": "error", "step": int(step),
                   "executor": executor,
                   "error": "%s: %s" % (type(error).__name__, error),
                   "trace_dump": trace_dump})


def step_summary():
    """The derived training-run report (what benches and
    tools/profile_* print instead of keeping private accounting):
    pipeline counters + step/compile-cache stats, misses keyed by
    cause."""
    counters = profiler.get_counters()

    def _passthrough(key):
        # keep pipeline/ad-hoc counters; drop label-encoded keys (re-
        # grouped below) and canonical-named registry storage (either
        # re-derived below — steps_total & co — or foreign to a training
        # report, like serving_*), so nothing appears twice
        if catalog.parse_storage_key(key)[0] != key:
            return False
        m = catalog.resolve(key)
        return m is None or m.storage_key != m.name

    out = {k: v for k, v in profiler.pipeline_counters().items()
           if _passthrough(k)}
    by_cause = {}
    for key, v in counters.items():
        base, labels = catalog.parse_storage_key(key)
        if base == catalog.COMPILE_CACHE_MISSES.storage_key:
            by_cause[labels.get("cause", "unknown")] = v
    out["steps"] = counters.get(catalog.STEPS_TOTAL.storage_key, 0.0)
    out["compile_cache_hits"] = counters.get(
        catalog.COMPILE_CACHE_HITS.storage_key, 0.0)
    out["compile_cache_misses"] = sum(by_cause.values())
    if by_cause:
        out["compile_cache_misses_by_cause"] = by_cause
    out["compile_s"] = counters.get(
        catalog.COMPILE_SECONDS.storage_key, 0.0)
    s = profiler.histogram_summary(catalog.STEP_SECONDS.storage_key)
    if s.get("count"):
        out["step_seconds"] = s
    return out
