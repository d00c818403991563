"""Stdlib HTTP frontend of the port's serving — the port of
``paddle_tpu/serving/server.py``:

  POST /v1/infer   {"feeds": {name: sample}, "outcome": ...} →
                   {"names": [...], "outputs": [...], "latency_ms": t,
                   "request_id": id}
                   400 for a bad body or a named-feed error
                   503 + Retry-After when the admission queue is full
                   504 when the request's X-Deadline-Ms budget expires
  POST /v1/generate {"prompt": [ids], "max_new_tokens": n,
                   "temperature": t, "priority": "high"|"low"} →
                   {"tokens": [...], "finish_reason": "eos"|"length",
                   "n_prompt": n, "latency_ms": t, "request_id": id,
                   "slo": {ttft_ms, tpot_ms, decode_steps, ...}}
                   400 bad body (a bad priority included), or a request
                   that can never fit the pool
                   503 + Retry-After when the admission queue is full or
                   brownout sheds a low-priority request
                   504 when the request's X-Deadline-Ms budget expires
  POST /v1/prefill {"prompt": [ids]} → {"key": hex, "n_pages": m,
                   "n_tokens": n, "first_token": t, "request_id": id,
                   "latency_ms": t} — the disaggregated prefill hop: the
                   prompt's full pages are committed to the shared store
                   for a decode replica to map (a prefill-role server)
                   400 bad prompt, 404 when there is no prefill worker,
                   503 + Retry-After when the page pool is exhausted
  GET  /healthz    200 {"status": "ok"} while serving, 503 "draining"
                   after shutdown began; ``brownout_level`` with a
                   generation scheduler; with ``version_info`` set (the
                   serve CLI sets it) also ``"serving": {...}``
  GET  /metrics    Prometheus text (counters, the admission queue depth,
                   live slot / held-lane / brownout / page gauges,
                   p50/p95/p99)
  GET  /trace      this process's ring of request-trace spans as
                   chrome://tracing JSON (the fleet router merges them
                   into ``/fleet/trace``)

``make_server(batcher, generator=None, prefill_worker=None, ...)``: the
``MicroBatcher`` serves ``/v1/infer``, the ``GenerationScheduler``
``/v1/generate``, the ``kv_transfer.PrefillWorker`` ``/v1/prefill``; any
may be None (its route then answers 404). Every POST ingests
``X-Trace-Id`` / ``X-Request-Id`` (minting a context when absent) and
echoes the ids on every response, errors included, plus
``X-Trace-Summary`` (the per-request summary) on success.
``X-Tenant-Id`` names a generation request's tenant (a malformed id is
served as the anonymous tenant). An infer request carrying an
``outcome`` writes a ``serving_event`` run-log record when
``FLAGS_online_log_events`` is set. Samples are JSON: dense feeds as
(nested) lists in the model's feature shape, ragged feeds as flat lists;
outputs come back as nested lists in fetch order.
"""

import json
import math
import sys
import time

import numpy as np

from ..observability import runlog, tracing
from ..observability.http import BackgroundHTTPServer, JsonHTTPHandler
from .batcher import DeadlineExceededError, OverloadedError, \
    ServingClosedError
from .metrics import render_prometheus
from .registry import parse_deadline_header, parse_tenant_header

__all__ = ["ServingServer", "make_server", "summary_header",
           "parse_deadline_header"]


def summary_header(summary):
    """Compact ``k=v;k2=v2`` form of a summary for ``X-Trace-Summary``."""
    if not summary:
        return None
    return ";".join("%s=%s" % (k, summary[k]) for k in sorted(summary))


class _Handler(JsonHTTPHandler):

    def do_GET(self):
        gen = self.server.generator
        if self.path == "/healthz":
            if self.server.draining:
                st = {"status": "draining", "ready": False}
            else:
                st = {"status": "ok", "ready": True}
            if self.server.version_info:
                st["serving"] = self.server.version_info
            if gen is not None:
                # the shed-ladder position rides every health answer
                st["brownout_level"] = gen.brownout_level()
            self._send_json(503 if self.server.draining else 200, st)
        elif self.path == "/metrics":
            gauges = {}
            if self.server.batcher is not None:
                gauges["serving_queue_depth"] = \
                    self.server.batcher.queue_depth()
            if gen is not None:
                gauges.update({
                    "generation_active_slots": gen.active_slots(),
                    "generation_held_requests": gen.held_depth(),
                    "brownout_level": gen.brownout_level()})
                if hasattr(gen.engine, "page_stats"):   # a paged engine
                    st = gen.engine.page_stats()
                    for k in ("kv_pages_in_use", "kv_pages_total",
                              "kv_pool_effective_capacity"):
                        gauges[k] = st[k]
            self._send(200, render_prometheus(gauges=gauges),
                       content_type="text/plain; version=0.0.4")
        elif self.path == "/trace":
            self._send_json(200, tracing.trace_dict())
        else:
            self._send_json(404, {"error": "unknown path %s" % self.path})

    def do_POST(self):
        ctx = tracing.from_headers(self.headers) or tracing.make_context()
        routes = {"/v1/infer": (self.server.batcher, self._handle_infer,
                                "inference"),
                  "/v1/generate": (self.server.generator,
                                   self._handle_generate, "generation"),
                  "/v1/prefill": (self.server.prefill_worker,
                                  self._handle_prefill, "prefill")}
        if self.path not in routes:
            self._reply(ctx, 404, {"error": "unknown path %s" % self.path})
            return
        worker, handle, what = routes[self.path]
        if worker is None:
            self._reply(ctx, 404, {"error": "%s is not enabled on this "
                                   "server" % what})
            return
        t0 = time.perf_counter()
        status = 500
        try:
            status = handle(ctx, t0)
        finally:
            tracing.span_from(t0, "http.request", ctx=ctx, path=self.path,
                              status=status)

    def _reply(self, ctx, code, obj, extra_headers=None):
        """JSON reply with the trace ids echoed (errors too)."""
        headers = dict(ctx.headers())
        if extra_headers:
            headers.update(extra_headers)
        if code >= 400 and isinstance(obj, dict):
            obj.setdefault("request_id", ctx.request_id)
        self._send_json(code, obj, extra_headers=headers)
        return code

    def _wait_s(self, deadline_ms):
        """How long the handler waits: the server's request timeout, or
        the request's own deadline plus a grace (so the worker's 504,
        which names the stage, normally comes first)."""
        wait_s = self.server.request_timeout
        if deadline_ms is not None:
            wait_s = min(wait_s, deadline_ms / 1e3 + 0.5)
        return wait_s

    def _overloaded(self, ctx, e):
        # RFC 9110 delta-seconds is a non-negative integer: round the
        # drain-rate hint up, never below 1 s
        ra = getattr(e, "retry_after", None)
        return self._reply(ctx, 503, {"error": str(e)}, extra_headers={
            "Retry-After": "1" if ra is None
            else "%d" % max(1, math.ceil(ra))})

    def _deadline_exceeded(self, ctx, e):
        tracing.record("http.error", ctx=ctx, path=self.path, status=504,
                       error="%s: %s" % (type(e).__name__, e))
        return self._reply(ctx, 504, {"error": str(e),
                                      "deadline_exceeded": True})

    def _server_error(self, ctx, e):
        tracing.record("http.error", ctx=ctx, path=self.path, status=500,
                       error="%s: %s" % (type(e).__name__, e))
        return self._reply(ctx, 500, {"error": "%s: %s"
                                      % (type(e).__name__, e)})

    def _handle_infer(self, ctx, t0):
        deadline_ms = parse_deadline_header(
            self.headers.get("X-Deadline-Ms"))
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
            feeds = payload["feeds"]
            if not isinstance(feeds, dict):
                raise ValueError("'feeds' must be an object")
        except (ValueError, KeyError, TypeError) as e:
            return self._reply(ctx, 400, {"error": "bad request body: %s"
                                          % e})
        batcher = self.server.batcher
        try:
            pending = batcher.submit(feeds, trace=ctx,
                                     deadline_ms=deadline_ms)
            result = pending.wait(self._wait_s(deadline_ms))
        except OverloadedError as e:
            return self._overloaded(ctx, e)
        except ServingClosedError as e:
            return self._reply(ctx, 503, {"error": str(e)})
        except DeadlineExceededError as e:
            return self._deadline_exceeded(ctx, e)
        except (ValueError, KeyError) as e:
            # a named-feed error is the client's
            return self._reply(ctx, 400, {"error": str(e)})
        except TimeoutError as e:
            if deadline_ms is not None:
                return self._deadline_exceeded(ctx, e)
            tracing.record("http.error", ctx=ctx, path=self.path,
                           status=504, error="TimeoutError: %s" % e)
            return self._reply(ctx, 504, {"error": str(e)})
        except Exception as e:
            return self._server_error(ctx, e)
        reply = {
            "names": list(batcher.session.fetch_names),
            "outputs": [np.asarray(o).tolist() for o in result],
            "latency_ms": (time.perf_counter() - t0) * 1e3,
            "request_id": ctx.request_id,
        }
        self._log_serving_event(ctx, payload, reply)
        extra = {}
        hdr = summary_header(pending.summary)
        if hdr:
            extra["X-Trace-Summary"] = hdr
        return self._reply(ctx, 200, reply, extra_headers=extra)

    def _log_serving_event(self, ctx, payload, reply):
        """An infer request carrying an ``outcome`` label (the client's
        feedback join) goes to the open run log as a ``serving_event``
        record when ``FLAGS_online_log_events`` is set; never fails the
        request."""
        from .. import flags
        if not flags.online_log_events or "outcome" not in payload:
            return
        log = runlog.get_run_log()
        if log is None:
            return
        try:
            log.write({"kind": "serving_event", "time": time.time(),
                       "request_id": ctx.request_id,
                       "feeds": payload.get("feeds"),
                       "outcome": payload["outcome"],
                       "prediction": reply.get("outputs"),
                       "latency_ms": reply.get("latency_ms")})
        except Exception:
            pass  # feedback logging is best-effort by contract

    def _handle_generate(self, ctx, t0):
        deadline_ms = parse_deadline_header(
            self.headers.get("X-Deadline-Ms"))
        # a malformed tenant id degrades to anonymous: tenancy is an
        # accounting dimension, not authentication
        tenant = parse_tenant_header(self.headers.get("X-Tenant-Id"))
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
            prompt = payload["prompt"]
            # bool is an int subclass: [true, false] must be a 400
            if not isinstance(prompt, list) or not prompt or \
                    not all(isinstance(t, int) and not isinstance(t, bool)
                            for t in prompt):
                raise ValueError(
                    "'prompt' must be a non-empty list of token ids")
            max_new = payload.get("max_new_tokens")
            if max_new is not None:
                max_new = int(max_new)
            temperature = float(payload.get("temperature", 0.0))
            # validated by the scheduler's submit (its ValueError is a
            # 400 below): one list of classes
            priority = payload.get("priority", "high")
        except (ValueError, KeyError, TypeError) as e:
            return self._reply(ctx, 400, {"error": "bad request body: %s"
                                          % e})
        wait_s = self._wait_s(deadline_ms)
        try:
            pending = self.server.generator.submit(
                np.asarray(prompt, np.int32), max_new_tokens=max_new,
                temperature=temperature, trace=ctx, deadline_ms=deadline_ms,
                priority=priority, tenant=tenant)
            result = pending.wait(wait_s)
        except OverloadedError as e:
            return self._overloaded(ctx, e)
        except ServingClosedError as e:
            return self._reply(ctx, 503, {"error": str(e)})
        except DeadlineExceededError as e:
            return self._deadline_exceeded(ctx, e)
        except ValueError as e:
            return self._reply(ctx, 400, {"error": str(e)})
        except TimeoutError as e:
            tracing.record("http.error", ctx=ctx, path=self.path,
                           status=504, error="TimeoutError: %s" % e)
            return self._reply(ctx, 504, {"error": str(e)})
        except Exception as e:
            return self._server_error(ctx, e)
        extra = {}
        hdr = summary_header(pending.summary)
        if hdr:
            extra["X-Trace-Summary"] = hdr
        result = dict(result)
        result["request_id"] = ctx.request_id
        result["latency_ms"] = (time.perf_counter() - t0) * 1e3
        return self._reply(ctx, 200, result, extra_headers=extra)


    def _handle_prefill(self, ctx, t0):
        """The disaggregated prefill hop: prefill the prompt on this
        worker's paged engine, publish its full pages to the shared
        store/tier, answer with the chain key the decode worker maps."""
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
            prompt = payload["prompt"]
            if not isinstance(prompt, list) or not prompt or \
                    not all(isinstance(t, int) and not isinstance(t, bool)
                            for t in prompt):
                raise ValueError(
                    "'prompt' must be a non-empty list of token ids")
        except (ValueError, KeyError, TypeError) as e:
            return self._reply(ctx, 400, {"error": "bad request body: %s"
                                          % e})
        try:
            result = self.server.prefill_worker.prefill(
                np.asarray(prompt, np.int32), trace=ctx)
        except OverloadedError as e:
            return self._overloaded(ctx, e)
        except ValueError as e:
            return self._reply(ctx, 400, {"error": str(e)})
        except Exception as e:
            return self._server_error(ctx, e)
        result = dict(result)
        result["request_id"] = ctx.request_id
        result["latency_ms"] = (time.perf_counter() - t0) * 1e3
        return self._reply(ctx, 200, result)


class ServingServer(BackgroundHTTPServer):
    """BackgroundHTTPServer + the serving wiring (the micro-batcher, the
    generation scheduler and/or the prefill worker, the drain flag, the
    per-request timeout)."""

    def __init__(self, addr, batcher, generator=None, prefill_worker=None,
                 request_timeout=60.0, verbose=False):
        if batcher is None and generator is None and prefill_worker is None:
            raise ValueError("ServingServer needs a batcher, a generator, "
                             "and/or a prefill worker")
        BackgroundHTTPServer.__init__(self, addr, _Handler, verbose=verbose)
        self.batcher = batcher
        self.generator = generator
        self.prefill_worker = prefill_worker    # /v1/prefill
        self.request_timeout = request_timeout
        self.draining = False
        self.version_info = None  # what this process serves (serve CLI)

    def start_background(self, name="serving-http"):
        return BackgroundHTTPServer.start_background(self, name=name)

    def shutdown_gracefully(self, timeout=None):
        """Flip /healthz to draining, drain the batcher and the scheduler
        (queued and in-flight requests still complete), stop the
        listener. Returns ``{"drained": bool, "residue": {...}}``, the
        residue naming what was still in flight when ``timeout``
        expired."""
        self.draining = True
        result = {"drained": True, "residue": {}}
        for name, worker in (("batcher", self.batcher),
                             ("generator", self.generator)):
            if worker is not None and not worker.close(timeout):
                result["drained"] = False
                result["residue"][name] = worker.residue()
        self.stop(timeout)
        if not result["drained"]:
            sys.stderr.write("serving: drain timed out with work in "
                             "flight: %s\n" % json.dumps(result["residue"]))
        log = runlog.get_run_log()
        if log is not None:
            log.write({"kind": "serving_shutdown",
                       "drained": result["drained"],
                       "residue": result["residue"]})
        return result


def make_server(batcher, generator=None, prefill_worker=None,
                host="127.0.0.1", port=0, request_timeout=60.0,
                verbose=False):
    """Bind a :class:`ServingServer`: ``batcher`` (a ``MicroBatcher``)
    serves /v1/infer, ``generator`` (a ``GenerationScheduler``)
    /v1/generate, ``prefill_worker`` (a ``kv_transfer.PrefillWorker``) the
    disaggregated /v1/prefill hop; any may be None. ``port=0`` picks a
    free port (``server.server_address`` has the final one)."""
    return ServingServer((host, port), batcher, generator=generator,
                         prefill_worker=prefill_worker,
                         request_timeout=request_timeout, verbose=verbose)
