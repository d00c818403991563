"""``/v1/infer`` on the port, on the CPU: ``InferenceSession`` over an
exported artifact and over a pruned program, the ``MicroBatcher`` (the
reference's ``tests/serving/test_batcher.py`` cases over a stub session),
the HTTP route with concurrent ``ServingClient``s, its error paths and
drain, and the ``serve --artifact`` CLI.

A request's output from a padded window is held to the same request run
alone within 1e-6, not bitwise: the reference's own bitwise tests of this
(``tests/serving/test_session.py``, ``test_server_e2e.py``) fail by one
fp32 ulp on XLA's CPU, and cuDNN/cuBLAS pick their algorithms by batch
size.
"""

from tests import torch_threads  # noqa: F401  (first)
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

import paddle_tpu_torch as fluid
from paddle_tpu_torch import profiler, serving
from paddle_tpu_torch.executor import Scope, scope_guard
from paddle_tpu_torch.serving import (MicroBatcher, OverloadedError,
                                      ServingClosedError)
from paddle_tpu_torch.serving.batcher import PendingResult

MAX_SEQ_LEN = 8
DEPAD = dict(rtol=1e-6, atol=1e-7)


def ragged_model():
    """The reference's session model: embedding → sum pool → softmax fc,
    with its startup run in a scope of its own."""
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        words = fluid.layers.data(name="w", shape=[1], dtype="int64",
                                  lod_level=1)
        emb = fluid.layers.embedding(words, size=[32, 4])
        pool = fluid.layers.sequence_pool(emb, "sum")
        pred = fluid.layers.fc(pool, 3, act="softmax")
    exe = fluid.Executor(fluid.CPUPlace())
    scope = Scope()
    with scope_guard(scope):
        exe.run(startup)
    return prog, pred, exe, scope


@pytest.fixture(scope="module")
def artifact_dir(tmp_path_factory):
    prog, pred, exe, scope = ragged_model()
    d = str(tmp_path_factory.mktemp("art"))
    fluid.io.export_artifact(d, ["w"], [pred], exe, main_program=prog,
                             scope=scope, max_seq_len=MAX_SEQ_LEN)
    return d


def ragged_requests(rng, n, max_len=MAX_SEQ_LEN):
    return [{"w": rng.randint(0, 32, size=rng.randint(1, max_len + 1))
             .astype(np.int32)} for _ in range(n)]


# -- the session -------------------------------------------------------------

def test_artifact_session_depads_each_request(artifact_dir):
    art = fluid.io.load_artifact(artifact_dir)
    sess = serving.InferenceSession.from_artifact(art)
    rng = np.random.RandomState(0)
    reqs = ragged_requests(rng, 5)
    outs = sess.run_many(reqs)
    assert len(outs) == 5
    for r, o in zip(reqs, outs):
        (ref,) = art.run({"w": [r["w"]]})
        np.testing.assert_allclose(o[0], ref[0], **DEPAD)


def test_artifact_session_pow2_batch_padding(artifact_dir):
    """5 requests pad to batch 8; a later 3-request window takes the
    batch-4 shape; an exact power of two adds none."""
    sess = serving.InferenceSession.from_artifact(artifact_dir)
    rng = np.random.RandomState(1)
    sess.run_many(ragged_requests(rng, 5))
    assert sess.compiled_shapes == {(8, 8)}  # (bucket_len, padded_batch)
    sess.run_many(ragged_requests(rng, 3))
    assert (8, 4) in sess.compiled_shapes
    sess.run_many(ragged_requests(rng, 4))
    assert len(sess.compiled_shapes) == 2
    nopad = serving.InferenceSession.from_artifact(artifact_dir,
                                                   pad_batch_pow2=False)
    nopad.run_many(ragged_requests(rng, 3))
    assert nopad.compiled_shapes == {(8, 3)}


def test_program_session_bucketed_lengths():
    prog, pred, exe, scope = ragged_model()
    infer = prog.clone(for_test=True)
    sess = serving.InferenceSession.from_program(
        exe, infer, ["w"], [pred], scope=scope, bucket_multiple=4)
    rng = np.random.RandomState(2)
    reqs = [{"w": rng.randint(0, 32, size=n).astype(np.int32)}
            for n in (2, 3, 1)]                       # max 3 → bucket 4
    outs = sess.run_many(reqs)
    assert sess.compiled_shapes == {(4, 4)}
    for r, o in zip(reqs, outs):
        (ref,) = exe.run(infer, feed={"w": fluid.LoDArray.from_sequences(
            [r["w"]], dtype=np.int32, max_len=4)}, fetch_list=[pred],
            scope=scope)
        np.testing.assert_allclose(o[0], ref[0], **DEPAD)
    sess.run_many([{"w": rng.randint(0, 32, size=6).astype(np.int32)}])
    assert (8, 1) in sess.compiled_shapes


def test_dense_session_and_validation():
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        pred = fluid.layers.fc(x, 2)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = Scope()
    with scope_guard(scope):
        exe.run(startup)
    infer = prog.clone(for_test=True)
    sess = serving.InferenceSession.from_program(exe, infer, ["x"], [pred],
                                                 scope=scope)
    rng = np.random.RandomState(3)
    reqs = [{"x": rng.rand(4).astype(np.float32)} for _ in range(3)]
    outs = sess.run_many(reqs)
    (ref,) = exe.run(infer, feed={"x": reqs[0]["x"][None]},
                     fetch_list=[pred], scope=scope)
    np.testing.assert_allclose(outs[0][0], ref[0], **DEPAD)
    with pytest.raises(KeyError, match="missing feed 'x'"):
        sess.run_many([{"y": np.zeros(4, np.float32)}])
    with pytest.raises(ValueError, match="feed 'x' \\(request 0\\)"):
        sess.run_many([{"x": np.zeros(5, np.float32)}])


def test_program_session_max_seq_len_off_bucket_grid():
    prog, pred, exe, scope = ragged_model()
    sess = serving.InferenceSession.from_program(
        exe, prog.clone(for_test=True), ["w"], [pred], scope=scope,
        bucket_multiple=4, max_seq_len=6)
    rng = np.random.RandomState(4)
    outs = sess.run_many([{"w": rng.randint(0, 32, size=5)
                           .astype(np.int32)}])
    assert outs[0][0].shape == (3,)
    assert (6, 1) in sess.compiled_shapes          # capped at max_seq_len
    with pytest.raises(ValueError, match="exceeds session max_seq_len"):
        sess.run_many([{"w": rng.randint(0, 32, size=7).astype(np.int32)}])


def test_artifact_session_overlong_sequence_errors(artifact_dir):
    sess = serving.InferenceSession.from_artifact(artifact_dir)
    with pytest.raises(ValueError, match="feed 'w'"):
        sess.run_many([{"w": np.arange(9, dtype=np.int32)}])


# -- the micro-batcher (the reference's cases over a stub session) ----------

class StubSession:
    """Echoes each request's 'x' back, recording window sizes; ``gate``
    (an Event) holds ``collect`` so a test can pile up a queue."""

    fetch_names = ["y"]

    def __init__(self, delay_s=0.0, gate=None):
        self.batch_sizes = []
        self.delay_s = delay_s
        self.gate = gate
        self.lock = threading.Lock()

    def assemble(self, requests):
        with self.lock:
            self.batch_sizes.append(len(requests))
        return [r["x"] for r in requests]

    def dispatch(self, plan):
        return plan

    def collect(self, plan):
        if self.gate is not None:
            assert self.gate.wait(30)
        if self.delay_s:
            time.sleep(self.delay_s)
        return [[np.asarray(x)] for x in plan]


def test_flush_on_size():
    sess = StubSession()
    with MicroBatcher(sess, max_batch_size=4, max_wait_ms=10_000,
                      queue_depth=64) as b:
        t0 = time.perf_counter()
        outs = [p.wait(30) for p in [b.submit({"x": i}) for i in range(4)]]
        assert time.perf_counter() - t0 < 5.0       # not the 10 s window
    assert [int(o[0]) for o in outs] == [0, 1, 2, 3]
    assert 4 in sess.batch_sizes


def test_flush_on_deadline():
    sess = StubSession()
    with MicroBatcher(sess, max_batch_size=64, max_wait_ms=30,
                      queue_depth=64) as b:
        out = b.infer({"x": 7}, timeout=30)
    assert int(out[0]) == 7 and sess.batch_sizes == [1]


def test_short_final_batch_on_drain():
    gate = threading.Event()
    sess = StubSession(gate=gate)
    b = MicroBatcher(sess, max_batch_size=4, max_wait_ms=10_000,
                     queue_depth=64)
    pend = [b.submit({"x": i}) for i in range(3)]
    gate.set()
    closer = threading.Thread(target=b.close, args=(30,))
    closer.start()
    outs = [p.wait(30) for p in pend]
    closer.join(30)
    assert [int(o[0]) for o in outs] == [0, 1, 2]
    assert sess.batch_sizes == [3]


def test_overload_rejection_and_counter():
    profiler.reset_counters()
    gate = threading.Event()
    b = MicroBatcher(StubSession(gate=gate), max_batch_size=1,
                     max_wait_ms=1, queue_depth=2, max_inflight=1)
    accepted, rejected = [], 0
    for i in range(32):
        try:
            accepted.append(b.submit({"x": i}))
        except OverloadedError as e:
            assert e.retry_after is not None
            rejected += 1
    assert rejected > 0
    assert profiler.get_counters()["serving_rejected_total"] == rejected
    gate.set()
    for p in accepted:
        p.wait(30)
    assert b.close(30)


def test_submit_after_close_raises():
    b = MicroBatcher(StubSession(), max_batch_size=2, max_wait_ms=5)
    b.close(30)
    with pytest.raises(ServingClosedError):
        b.submit({"x": 1})


def test_bad_request_poisons_only_its_window():
    class Flaky(StubSession):
        def assemble(self, requests):
            if any(r["x"] == "bad" for r in requests):
                raise ValueError("feed 'x': bogus sample")
            return StubSession.assemble(self, requests)

    with MicroBatcher(Flaky(), max_batch_size=1, max_wait_ms=5) as b:
        bad = b.submit({"x": "bad"})
        with pytest.raises(ValueError, match="bogus"):
            bad.wait(30)
        assert int(b.infer({"x": 5}, timeout=30)[0]) == 5


def test_occupancy_metrics_accumulate():
    profiler.reset_counters()
    profiler.reset_histograms()
    with MicroBatcher(StubSession(), max_batch_size=4, max_wait_ms=50) as b:
        for p in [b.submit({"x": i}) for i in range(8)]:
            p.wait(30)
    c = profiler.get_counters()
    assert c["serving_requests_total"] == 8
    assert c["serving_batched_requests_total"] == 8
    assert c["serving_batches_total"] >= 2
    assert c["serving_batched_requests_total"] / \
        c["serving_batches_total"] > 1.0
    lat = profiler.histogram_percentiles("serving_latency_ms")
    assert lat and lat[50.0] >= 0.0
    assert profiler.get_histogram("serving_batch_size")


def test_pending_result_timeout():
    p = PendingResult()
    with pytest.raises(TimeoutError):
        p.wait(0.01)
    p._resolve([np.float32(1.0)])
    assert p.done() and p.t_done is not None
    assert p.wait(1) == [np.float32(1.0)]


def test_serving_knobs_resolve_and_name_their_source(monkeypatch):
    from paddle_tpu_torch import flags
    assert serving.resolve_serving_knobs() == (8, 5.0, 128)
    assert serving.resolve_serving_knobs(max_batch_size=32,
                                         max_wait_ms=0) == (32, 0.0, 128)
    with pytest.raises(ValueError, match="^max_batch_size must be >= 1"):
        MicroBatcher(StubSession(), max_batch_size=0)
    monkeypatch.setattr(flags, "serving_max_wait_ms", -1)
    with pytest.raises(ValueError, match="^FLAGS_serving_max_wait_ms"):
        serving.resolve_serving_knobs()
    # the generation scheduler's share ignores the batcher-only flags
    assert serving.resolve_serving_knobs(which=("queue_depth",)) == \
        (None, None, 128)


# -- the HTTP route ----------------------------------------------------------

@pytest.fixture()
def stack(artifact_dir):
    art = fluid.io.load_artifact(artifact_dir)
    batcher = MicroBatcher(serving.InferenceSession.from_artifact(art),
                           max_batch_size=8, max_wait_ms=40, queue_depth=128)
    server = serving.make_server(batcher).start_background()
    try:
        yield art, server
    finally:
        if not server.draining:
            server.shutdown_gracefully(30)


def test_concurrent_clients_match_single_runs_and_metrics(stack):
    art, server = stack
    profiler.reset_counters()
    profiler.reset_histograms()
    url = server.url
    assert serving.ServingClient(url).healthy()
    serving.ServingClient(url).infer({"w": [1, 2, 3]})
    rng = np.random.RandomState(0)
    inputs = [[rng.randint(0, 32, size=rng.randint(1, MAX_SEQ_LEN + 1))
               .astype(np.int32) for _ in range(4)] for _ in range(6)]
    results = [[None] * 4 for _ in range(6)]
    errors = []
    barrier = threading.Barrier(6)

    def client(ci):
        c = serving.ServingClient(url)
        try:
            barrier.wait(30)
            for ri, seq in enumerate(inputs[ci]):
                (results[ci][ri],) = c.infer({"w": seq})
        except Exception as e:
            errors.append((ci, e))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors, errors
    for ci in range(6):
        for ri, seq in enumerate(inputs[ci]):
            (ref,) = art.run({"w": [seq]})
            np.testing.assert_allclose(results[ci][ri], ref[0], **DEPAD)
    m = serving.ServingClient(url).metrics()
    batches = m["paddle_tpu_serving_batches_total"]
    batched = m["paddle_tpu_serving_batched_requests_total"]
    assert batched == 6 * 4 + 1
    assert batched / batches > 1.0
    p50 = m['paddle_tpu_serving_latency_ms{quantile="0.5"}']
    p99 = m['paddle_tpu_serving_latency_ms{quantile="0.99"}']
    assert 0.0 < p50 <= p99 < 60_000.0
    assert m["paddle_tpu_serving_queue_depth"] >= 0.0


def post(url, payload, headers=None):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers=dict(headers or {}))
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, e.headers, json.loads(e.read())


def test_http_error_paths_reply_and_drain(stack, tmp_path):
    art, server = stack
    url = server.url
    c = serving.ServingClient(url)
    code, hdrs, body = post(url + "/v1/infer", {"feeds": {"w": [4, 5]}},
                            headers={"X-Request-Id": "r-1"})
    assert code == 200 and set(body) == {"names", "outputs", "latency_ms",
                                         "request_id"}
    assert body["request_id"] == "r-1" == hdrs["X-Request-Id"]
    assert body["names"] == art.fetch_names
    assert "outcome=ok" in hdrs["X-Trace-Summary"]
    with pytest.raises(RuntimeError, match="HTTP 400.*'w'"):
        c.infer({"not_w": [1, 2]})
    with pytest.raises(RuntimeError, match="HTTP 400"):
        c.infer({"w": np.arange(MAX_SEQ_LEN + 1, dtype=np.int32)})
    code, _, body = post(url + "/v1/infer", {"feeds": [1]})
    assert code == 400 and "'feeds' must be an object" in body["error"]
    code, _, body = post(url + "/v1/generate", {"prompt": [1]})
    assert code == 404 and "generation is not enabled" in body["error"]
    # an expired deadline is a 504
    code, _, body = post(url + "/v1/infer", {"feeds": {"w": [1]}},
                         headers={"X-Deadline-Ms": "0"})
    assert code == 504 and body["deadline_exceeded"]
    # a labelled request lands in the run log
    from paddle_tpu_torch.observability import runlog
    log_path = str(tmp_path / "run.jsonl")
    runlog.start_run_log(log_path)
    try:
        c.infer({"w": [3]}, outcome="clicked")
    finally:
        runlog.stop_run_log()
    events = [json.loads(line) for line in open(log_path)
              if '"serving_event"' in line]
    assert len(events) == 1 and events[0]["outcome"] == "clicked"
    (out,) = c.infer({"w": [4, 5, 6]})
    assert out.shape == (3,)
    status = server.shutdown_gracefully(30)
    assert status == {"drained": True, "residue": {}}
    assert not c.healthy()
    with pytest.raises((RuntimeError, OverloadedError, OSError)):
        c.infer({"w": [1]})


def test_overload_is_503_with_retry_after(artifact_dir):
    gate = threading.Event()
    batcher = MicroBatcher(StubSession(gate=gate), max_batch_size=1,
                           max_wait_ms=1, queue_depth=1, max_inflight=1)
    server = serving.make_server(batcher).start_background()
    try:
        for i in range(32):     # fill the flight, the window, the queue
            try:
                batcher.submit({"x": i})
            except OverloadedError:
                time.sleep(0.2)           # the batcher has stalled when
                if batcher.queue_depth():  # the queue stays full
                    break
        else:
            pytest.fail("the queue never filled")
        code, hdrs, _ = post(server.url + "/v1/infer", {"feeds": {"x": 1}})
        assert code == 503 and int(hdrs["Retry-After"]) >= 1
        with pytest.raises(OverloadedError):
            serving.ServingClient(server.url, overload_retries=0).infer(
                {"x": 1})
    finally:
        gate.set()
        server.shutdown_gracefully(30)


def test_serve_cli_serves_the_artifact_and_drains_on_sigterm(artifact_dir):
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving.serve",
         "--artifact", artifact_dir, "--port", "0", "--max-batch-size", "4",
         "--max-wait-ms", "20"], env=env, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stderr.readline()
        assert line.startswith("serve: http://"), line
        assert "infer: %s feeds=['w']" % artifact_dir in line
        url = line.split()[1]
        c = serving.ServingClient(url)
        assert c.healthy()
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            assert json.loads(r.read())["serving"]["artifact"] == \
                artifact_dir
        art = fluid.io.load_artifact(artifact_dir)
        (out,) = c.infer({"w": [1, 2, 3]})
        np.testing.assert_allclose(out, art.run({"w": [[1, 2, 3]]})[0][0],
                                   **DEPAD)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
        proc.stderr.close()
