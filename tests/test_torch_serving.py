"""The port's continuous-batching scheduler, HTTP server and serve CLI on
the CPU: more requests than slots drain with greedy streams identical to
full recompute; page pressure holds a request at the queue head instead
of failing it; deadlines 504; the server answers /v1/generate,
/healthz and /metrics, and maps client errors to 400, a full queue to
503 + Retry-After and an expired deadline to 504."""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from paddle_tpu_torch import profiler
from paddle_tpu_torch.observability import catalog, tracing
from paddle_tpu_torch.serving import (DeadlineExceededError,
                                      GenerationScheduler, OverloadedError,
                                      PagedDecodeEngine,
                                      TransformerDecoderModel,
                                      full_recompute_generate, make_server,
                                      save_decoder)

VOCAB, DIM, HEADS, LAYERS = 61, 16, 2, 2
MAX_LEN, BUCKETS, PAGE = 32, (4, 8), 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def model_and_params(seed=0):
    model = TransformerDecoderModel(VOCAB, dim=DIM, n_heads=HEADS,
                                    n_layers=LAYERS)
    return model, model.init_params(seed, device="cpu")


def engine(slots=4, num_pages=None, cls=PagedDecodeEngine):
    model, params = model_and_params()
    return cls(model, params, max_slots=slots, max_len=MAX_LEN,
               prefill_buckets=BUCKETS, page_size=PAGE,
               num_pages=num_pages, device="cpu")


def prompts_and_budgets(n, seed):
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(2, VOCAB, size=int(k)).astype(np.int32)
               for k in rng.randint(1, 9, size=n)]
    return prompts, [int(b) for b in rng.randint(1, 13, size=n)]


def post(url, body, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers=dict({"Content-Type": "application/json"}, **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


class GatedEngine(PagedDecodeEngine):
    """Prefill blocks until the test opens the gate: the scheduler loop
    sits inside an admission while requests pile up behind it."""
    gate = None       # threading.Event: prefill runs while it is set
    entered = None    # threading.Event: a prefill reached the gate

    def prefill(self, *a, **k):
        self.entered.set()
        self.gate.wait(30)
        return PagedDecodeEngine.prefill(self, *a, **k)


def gated_engine(slots):
    eng = engine(slots=slots, cls=GatedEngine)
    eng.gate, eng.entered = threading.Event(), threading.Event()
    return eng


def wait_for(cond, timeout=30):
    deadline = time.time() + timeout
    while not cond():
        assert time.time() < deadline, "condition not reached"
        time.sleep(0.01)


def test_scheduler_drains_more_requests_than_slots():
    eng = engine(slots=4)
    prompts, budgets = prompts_and_budgets(14, seed=1)
    ref = full_recompute_generate(eng.model, eng.params, prompts, budgets,
                                  max_len=MAX_LEN)
    profiler.reset_counters()
    with GenerationScheduler(eng, queue_depth=64) as sched:
        pend = [sched.submit(p, max_new_tokens=b)
                for p, b in zip(prompts, budgets)]
        res = [p.wait(60) for p in pend]
    assert [r["tokens"] for r in res] == ref
    assert all(r["finish_reason"] == "length" for r in res)
    assert [r["n_prompt"] for r in res] == [len(p) for p in prompts]
    assert catalog.GENERATION_PREFILLS.value() == 14
    assert catalog.GENERATION_TOKENS.value() == sum(budgets)
    assert catalog.REQUESTS_FINISHED.value(path="generate",
                                           outcome="length") == 14
    assert not eng.active.any() and sched.active_slots() == 0


def test_eos_finishes_early_and_sampling_is_seeded():
    eng = engine(slots=2)
    prompt = np.array([5, 9, 11], np.int32)
    greedy = full_recompute_generate(eng.model, eng.params, [prompt], 8,
                                     max_len=MAX_LEN)[0]
    eos = greedy[2]
    with GenerationScheduler(eng, eos_id=eos) as sched:
        out = sched.generate(prompt, max_new_tokens=8, timeout=60)
    assert out["tokens"] == greedy[:greedy.index(eos) + 1]
    assert out["finish_reason"] == "eos"
    draws = []
    for _ in range(2):
        with GenerationScheduler(engine(slots=2), seed=7) as sched:
            draws.append(sched.generate(prompt, max_new_tokens=10,
                                        temperature=1.5,
                                        timeout=60)["tokens"])
    assert draws[0] == draws[1] and len(draws[0]) == 10
    assert all(0 <= t < VOCAB for t in draws[0])


def test_page_pressure_holds_the_queue_head_until_pages_free():
    # 10 pages: one 32-token reservation takes 8, so a second request
    # waits at the head of the queue for the first to finish
    eng = engine(slots=4, num_pages=10)
    prompts, _ = prompts_and_budgets(3, seed=2)
    budgets = [MAX_LEN] * 3
    ref = full_recompute_generate(eng.model, eng.params, prompts, budgets,
                                  max_len=MAX_LEN)
    with GenerationScheduler(eng) as sched:
        pend = [sched.submit(p, max_new_tokens=b)
                for p, b in zip(prompts, budgets)]
        res = [p.wait(60) for p in pend]
    assert [r["tokens"] for r in res] == ref
    assert any(r["slo"].get("hold_ms", 0) > 0 for r in res)


def test_deadline_rejects_dead_on_arrival_requests():
    with GenerationScheduler(engine(slots=2)) as sched:
        with pytest.raises(DeadlineExceededError):
            sched.generate([3, 4], max_new_tokens=4, deadline_ms=0,
                           timeout=60)
        assert len(sched.generate([3, 4], max_new_tokens=3,
                                  timeout=60)["tokens"]) == 3
    assert catalog.DEADLINE_EXCEEDED.value(stage="admission") >= 1


def test_submit_validates_and_full_queue_overloads():
    eng = gated_engine(slots=1)
    sched = GenerationScheduler(eng, queue_depth=1)
    try:
        with pytest.raises(ValueError):
            sched.submit([3], max_new_tokens=0)
        with pytest.raises(ValueError):
            sched.submit([3], temperature=float("nan"))
        first = sched.submit([3, 4], max_new_tokens=2)
        wait_for(eng.entered.is_set)   # the loop holds `first` in the gate
        second = sched.submit([5], max_new_tokens=2)
        with pytest.raises(OverloadedError) as exc:
            sched.submit([6], max_new_tokens=2)
        assert exc.value.retry_after is not None
    finally:
        eng.gate.set()
        assert sched.close(60)
    assert len(first.wait(1)["tokens"]) == 2
    assert len(second.wait(1)["tokens"]) == 2


def test_queue_depth_knob_is_validated_naming_its_source(monkeypatch):
    from paddle_tpu_torch import flags
    from paddle_tpu_torch.serving import resolve_serving_knobs
    assert resolve_serving_knobs(queue_depth=3,
                                 which=("queue_depth",)) == (None, None, 3)
    monkeypatch.setattr(flags, "serving_queue_depth", 7)
    assert resolve_serving_knobs()[2] == 7
    with pytest.raises(ValueError, match="^queue_depth must be >= 1"):
        GenerationScheduler(engine(), queue_depth=0)
    monkeypatch.setattr(flags, "serving_queue_depth", "many")
    with pytest.raises(ValueError, match="FLAGS_serving_queue_depth must "
                                         "be a number"):
        resolve_serving_knobs()


def test_server_generate_health_metrics_and_errors():
    eng = gated_engine(slots=2)
    eng.gate.set()
    sched = GenerationScheduler(eng, queue_depth=1)
    server = make_server(None, generator=sched, port=0).start_background()
    url = server.url
    try:
        prompt = [7, 8, 9, 10, 11]
        ref = full_recompute_generate(eng.model, eng.params, [prompt], 6,
                                      max_len=MAX_LEN)[0]
        profiler.reset_counters()
        code, hdrs, body = post(url + "/v1/generate",
                                {"prompt": prompt, "max_new_tokens": 6},
                                headers={"X-Request-Id": "req-1"})
        assert code == 200 and body["tokens"] == ref
        assert body["request_id"] == "req-1" and hdrs["X-Request-Id"] == \
            "req-1"
        assert "ttft_ms=" in hdrs["X-Trace-Summary"]

        def req1_spans():
            return {e["name"] for e in tracing.trace_events()
                    if e["args"].get("request_id") == "req-1"}
        # the server thread records http.request once the reply is out,
        # so the client can read the trace before it lands: wait for it
        wait_for(lambda: {"gen.request", "gen.queue_wait", "engine.prefill",
                          "http.request"} <= req1_spans())
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            assert r.status == 200 and json.loads(r.read())["ready"]
        with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
            text = r.read().decode()
        assert "paddle_tpu_generation_tokens_total 6" in text
        assert "paddle_tpu_kv_pages_total" in text
        assert 'paddle_tpu_requests_finished_total{outcome="length",' \
            'path="generate"}' in text
        # client errors: a malformed body, a prompt past every bucket
        for bad in ({"prompt": "abc"}, {"prompt": [True, 1]},
                    {"prompt": list(range(2, 14))}):
            code, hdrs, body = post(url + "/v1/generate", bad)
            assert code == 400, (bad, body)
            assert body["request_id"] == hdrs["X-Request-Id"]
        code, _, body = post(url + "/v1/generate", {"prompt": [3]},
                             headers={"X-Deadline-Ms": "0"})
        assert code == 504 and body["deadline_exceeded"]
        # full queue: the loop holds one request in the gate, the queue
        # (depth 1) holds another, the third is refused with Retry-After
        eng.gate.clear()
        eng.entered.clear()
        results = []

        def client(p):
            results.append(post(url + "/v1/generate",
                                {"prompt": p, "max_new_tokens": 2}))
        t1 = threading.Thread(target=client, args=([3, 4],))
        t1.start()
        wait_for(eng.entered.is_set)
        t2 = threading.Thread(target=client, args=([5],))
        t2.start()
        wait_for(lambda: sched.queue_depth() == 1)
        code, hdrs, body = post(url + "/v1/generate", {"prompt": [6]})
        assert code == 503 and int(hdrs["Retry-After"]) >= 1
        eng.gate.set()
        t1.join(60)
        t2.join(60)
        assert sorted(r[0] for r in results) == [200, 200]
    finally:
        eng.gate.set()
        status = server.shutdown_gracefully(60)
    assert status["drained"]


def _serve_cli(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving.serve"] + args,
        cwd=str(tmp_path), env=env, stderr=subprocess.PIPE, text=True)


def test_serve_cli_serves_and_drains_on_sigterm(tmp_path):
    model, params = model_and_params()
    save_decoder(str(tmp_path / "dec"), model, params)
    ref = full_recompute_generate(model, params, [[4, 5, 6]], 5,
                                  max_len=MAX_LEN)[0]
    proc = _serve_cli(["--generation-model", str(tmp_path / "dec"),
                       "--device", "cpu", "--port", "0",
                       "--gen-max-slots", "2", "--gen-max-len", "32",
                       "--gen-prefill-buckets", "4,8",
                       "--gen-page-size", "4"], tmp_path)
    try:
        line = proc.stderr.readline()
        assert line.startswith("serve: http://"), line
        url = line.split()[1]
        code, _, body = post(url + "/v1/generate",
                             {"prompt": [4, 5, 6], "max_new_tokens": 5})
        assert code == 200 and body["tokens"] == ref
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
        proc.stderr.close()


def test_serve_cli_refuses_to_start_without_the_card(tmp_path):
    """The CLI's default device is cuda: on a machine without a GPU it
    exits non-zero instead of serving on the CPU."""
    model, params = model_and_params()
    save_decoder(str(tmp_path / "dec"), model, params)
    proc = _serve_cli(["--generation-model", str(tmp_path / "dec"),
                       "--port", "0"], tmp_path)
    _, err = proc.communicate(timeout=120)
    if torch.cuda.is_available():
        assert proc.returncode is not None   # served and was stopped
        return
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in err
