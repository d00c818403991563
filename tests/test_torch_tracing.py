"""The port's request tracing against the JAX reference's
(``paddle_tpu/observability/tracing.py``) on the CPU:

* head sampling: ``_sampled`` takes the same decision as the reference for
  1,000 seeded trace ids at each rate, and error / 5xx / exception spans
  record whatever the rate (``_must_record``);
* the span spool: spans the port writes read back with the reference's
  ``read_spool`` as they are in the ring, unsampled traces skip it, and a
  torn tail or a rotated file reads the same in both packages;
* ``read_spool`` + ``merge_traces`` give the same chrome-trace on one spool
  directory and ring dumps (request filter, trace filter, no filter), one
  lane per process, double reports dropped;
* ``GET /trace`` on the serving server, and the trace CLI
  (``python -m paddle_tpu_torch.observability.trace_tool``) against the
  reference's ``tools/trace.py``: the same document and exit codes.
"""

from tests import torch_threads  # noqa: F401  (first)
import importlib.util
import json
import os
import urllib.request

import numpy as np
import pytest

from paddle_tpu import flags as jflags
from paddle_tpu.observability import tracing as jtracing
from paddle_tpu_torch import flags
from paddle_tpu_torch.observability import trace_tool, tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def spool(tmp_path, monkeypatch):
    """The port's spool pointed at a fresh directory for the test, and
    closed and reset after it."""
    d = str(tmp_path / "spool")
    tracing.enable_spool(d)
    yield d
    tracing.enable_spool(None)
    monkeypatch.setattr(tracing, "_spool_resolved", False)


def _ids(n, seed):
    rng = np.random.RandomState(seed)
    return ["%016x" % int(v) for v in rng.randint(0, 2 ** 62, size=n,
                                                  dtype=np.int64)]


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_sampling_decides_as_the_reference(rate, monkeypatch):
    monkeypatch.setattr(flags, "trace_sample_rate", rate)
    monkeypatch.setattr(jflags, "trace_sample_rate", rate)
    ids = _ids(1000, 7)
    mine = [tracing._sampled(tracing.make_context(t)) for t in ids]
    ref = [jtracing._sampled(jtracing.make_context(t)) for t in ids]
    assert mine == ref
    assert abs(sum(mine) / 1000.0 - rate) < 0.05
    for args in ({"error": "boom"}, {"status": 503}, {"status": "500"},
                 {"status": "exception"}, {"status": 200}, {"status": "x"},
                 {"outcome": "ok"}, {}):
        assert tracing._must_record(args) == jtracing._must_record(args)


def test_spool_holds_what_the_ring_holds_and_skips_unsampled(spool,
                                                             monkeypatch):
    monkeypatch.setattr(flags, "trace_sample_rate", 0.5)
    ids = _ids(40, 3)
    kept = [t for t in ids if tracing._sampled(tracing.make_context(t))]
    start = len(tracing.trace_events())
    for t in ids:
        ctx = tracing.make_context(t)
        tracing.record("router.attempt", ctx=ctx, backend="replica0")
        tracing.record("http.error", ctx=ctx, status=504,
                       error="TimeoutError")
    tracing.record("engine.step")         # no context: always recorded
    ring = tracing.trace_events()[start:]
    spooled = jtracing.read_spool(spool)
    assert spooled == json.loads(json.dumps(ring))
    attempts = [e["args"]["trace_id"] for e in spooled
                if e["name"] == "router.attempt"]
    errors = [e["args"]["trace_id"] for e in spooled
              if e["name"] == "http.error"]
    assert attempts == kept and errors == ids
    assert os.listdir(spool) == ["spans_%d.jsonl" % os.getpid()]
    assert tracing.spool_path() == os.path.join(spool, os.listdir(spool)[0])


def _write_spool(d):
    """Two writers' files, a rotated one and a torn tail."""
    os.makedirs(d)
    ev = []
    for pid, names in ((101, ("router.request", "router.attempt")),
                       (202, ("http.request", "gen.prefill")),
                       (303, ("http.request", "handoff.prefill_work"))):
        for k, name in enumerate(names):
            rid = "req%d" % (k % 2)
            ev.append({"name": name, "cat": "trace", "ph": "X",
                       "ts": 1000.0 * pid + k, "dur": 5.0, "pid": pid,
                       "tid": 1, "args": {"trace_id": "tr" + rid,
                                          "request_id": rid}})
    batch = {"name": "gen.decode_step", "cat": "trace", "ph": "X",
             "ts": 202500.0, "dur": 2.0, "pid": 202, "tid": 2,
             "args": {"request_ids": ["req0", "req9"],
                      "trace_ids": ["trreq0"]}}
    ev.append(batch)
    by_pid = {}
    for e in ev:
        by_pid.setdefault(e["pid"], []).append(e)
    for pid, evs in by_pid.items():
        with open(os.path.join(d, "spans_%d.jsonl" % pid), "w") as f:
            for e in evs[1:]:
                f.write(json.dumps(e) + "\n")
            if pid == 303:
                f.write('{"name": "torn')           # the writer died here
        with open(os.path.join(d, "spans_%d.jsonl.1" % pid), "w") as f:
            f.write(json.dumps(evs[0]) + "\n")
    with open(os.path.join(d, "spans_x.jsonl"), "w") as f:
        f.write("not a spool file\n")
    return ev


@pytest.mark.parametrize("which", ["request", "trace", "all"])
def test_read_spool_and_merge_match_the_reference(tmp_path, which):
    d = str(tmp_path / "spool")
    ev = _write_spool(d)
    mine, ref = tracing.read_spool(d), jtracing.read_spool(d)
    assert mine == ref and len(mine) == len(ev)
    assert tracing.read_spool(d, pid=202) == jtracing.read_spool(d, pid=202)
    ring = [e for e in ev if e["pid"] == 202]     # a live replica's ring
    sources = [("router", [e for e in ev if e["pid"] == 101]),
               ("replica0", ring + [{"name": "process_name", "ph": "M",
                                     "pid": 202, "args": {}}]),
               ("spool", mine)]
    kw = {"request": {"request_id": "req0"}, "trace": {"trace_id":
                                                       "trreq1"},
          "all": {}}[which]
    got = tracing.merge_traces(sources, **kw)
    assert got == jtracing.merge_traces(sources, **kw)
    spans = [e for e in got["traceEvents"] if e["ph"] == "X"]
    assert len(spans) == got["metadata"]["span_count"]
    assert len({tracing._dedupe_key(e) for e in spans}) == len(spans)
    lanes = {e["pid"]: e["args"]["name"] for e in got["traceEvents"]
             if e["ph"] == "M"}
    assert lanes[101].startswith("router") and \
        lanes[202].startswith("replica0")
    if which == "request":
        assert got["metadata"]["trace_ids"] == ["trreq0"]
        assert any(e["name"] == "gen.decode_step" for e in spans)
    for e in ev:
        for rid in ("req0", "req1", "req9"):
            assert tracing.event_matches(e, request_id=rid) == \
                jtracing.event_matches(e, request_id=rid)
        assert tracing.event_matches(e, trace_id="trreq0") == \
            jtracing.event_matches(e, trace_id="trreq0")


def test_trace_endpoint_serves_the_ring():
    from paddle_tpu_torch.serving.server import make_server

    class _Idle:
        def queue_depth(self):
            return 0
    ctx = tracing.make_context("endpointtrace")
    tracing.record("probe", ctx=ctx)
    server = make_server(_Idle(), port=0).start_background()
    try:
        with urllib.request.urlopen(server.url + "/trace", timeout=10) as r:
            doc = json.loads(r.read())
    finally:
        server.stop(5)
    assert doc["metadata"]["pid"] == os.getpid()
    assert any(tracing.event_matches(e, trace_id="endpointtrace")
               for e in doc["traceEvents"])


def _reference_trace_cli():
    spec = importlib.util.spec_from_file_location(
        "reference_trace_cli", os.path.join(REPO, "tools", "trace.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("argv", [["--request-id", "req1"],
                                  ["--trace-id", "trreq1"], [],
                                  ["--request-id", "nobody"]])
def test_trace_cli_matches_the_reference_offline(tmp_path, argv):
    d = str(tmp_path / "spool")
    _write_spool(d)
    ring = str(tmp_path / "ring.json")
    with open(ring, "w") as f:
        json.dump({"traceEvents": [{"name": "router.request", "ph": "X",
                                    "ts": 1.0, "dur": 1.0, "pid": 7,
                                    "tid": 1, "args": {
                                        "request_id": "req0",
                                        "trace_id": "trreq0"}}]}, f)
    outs = []
    for name, main in (("port", trace_tool.main),
                       ("ref", _reference_trace_cli().main)):
        out = str(tmp_path / (name + ".json"))
        rc = main(["--spool-dir", d, "--ring", ring, "-o", out] + argv)
        outs.append((rc, json.load(open(out)) if rc == 0 else None))
    assert outs[0] == outs[1]
    assert outs[0][0] == (1 if "nobody" in argv else 0)
    if outs[0][0] == 0:
        for e in outs[0][1]["traceEvents"]:
            assert e.get("cname") == next(
                (c for p, c in trace_tool._HANDOFF_COLORS
                 if e.get("name", "").startswith(p)), None)
        assert argv[:1] != ["--request-id"] or any(
            e.get("cname") == "yellow" for e in outs[0][1]["traceEvents"])
    with pytest.raises(SystemExit):
        trace_tool.main(["--router", "http://127.0.0.1:9"])  # no id
    assert trace_tool.main(["--router", "http://127.0.0.1:9",
                            "--request-id", "x", "--timeout", "2"]) == 1
