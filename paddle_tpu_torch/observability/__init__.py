"""Observability for the port: the metric catalogue the serving slice
records into (``catalog``), request tracing (``tracing``) and the stdlib
HTTP plumbing (``http``). Trimmed copies of ``paddle_tpu/observability``;
the span spool, fleet trace merge and the training monitor are not
ported yet."""
