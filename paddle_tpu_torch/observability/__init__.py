"""Observability for the port — trimmed copies of
``paddle_tpu/observability``:

- ``catalog`` — the typed metric catalogue (``Counter``/``Gauge``/
  ``Histogram`` over ``profiler``'s storage) that serving and training
  record into;
- ``steps`` — per-step telemetry emitted by ``Executor.run`` /
  ``run_steps`` (wait times, cache hit/miss with the miss's cause) and
  ``step_summary``, the report the bench prints;
- ``runlog`` — the opt-in JSONL run log opened by a run manifest;
- ``flight_recorder`` — the always-on ring of ``record_event`` spans,
  dumped when a step raises;
- ``liveness`` — the last step, checkpoint and watchdog deadline that
  /healthz reports;
- ``tracing`` — request tracing (head sampling, the span spool and the
  fleet trace merge); ``trace_tool`` — its command line (``python -m
  paddle_tpu_torch.observability.trace_tool``); ``http`` — the stdlib HTTP
  plumbing.

The training monitor is not ported yet.
"""
