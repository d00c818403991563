"""Megastep decoding in the port against the JAX reference on the CPU
(sizes of tests/serving/test_megastep.py): with the same weights, the
port's greedy megastep emits the JAX megastep's tokens and the JAX
step-at-a-time tokens, with the same trips, emitted counts, lengths and
live masks, at k_eff 1, 2 and 5; a temperature cohort's megastep equals
the port's own step-at-a-time stream under the same seed (the port's
draws are not jax.random's); slots freeze on EOS and caps without bleed;
chained dispatch equals unchained; int8 and fp8 pools decode bit for bit
as the eager step does; the scheduler at K=8 emits the K=1 streams; the
serve CLI takes --gen-megastep-k. On the CPU every trip runs eagerly; the
captured graph runs on the card only (chip_smoke.py phase 12)."""

import json
import os
import signal
import subprocess
import sys
import time
import types
import urllib.request

import jax
import numpy as np
import pytest
import torch

from paddle_tpu import serving as jserving
from paddle_tpu.observability import catalog as jcatalog
from paddle_tpu_torch import profiler
from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.observability import catalog
from paddle_tpu_torch.serving import generation as pgen
from paddle_tpu_torch.serving import paged_kv as pkv

VOCAB, DIM, HEADS, LAYERS = 61, 16, 2, 2
MAX_LEN, BUCKETS, SLOTS, PAGE = 32, (4, 8), 4, 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIXED = np.array([0.0, 0.9, 0.0, 0.7], np.float32)


def np_tree(params):
    return {k: ([{n: np.asarray(a) for n, a in b.items()} for b in v]
                if k == "blocks" else np.asarray(v))
            for k, v in params.items()}


@pytest.fixture(scope="module")
def weights():
    """(JAX model, JAX params, port model, port params): one set of
    weights in both packages."""
    jm = jserving.TransformerDecoderModel(VOCAB, dim=DIM, n_heads=HEADS,
                                          n_layers=LAYERS)
    jp = jm.init_params(0)
    pm = pgen.TransformerDecoderModel(VOCAB, dim=DIM, n_heads=HEADS,
                                      n_layers=LAYERS)
    return jm, jp, pm, params_from_jax(np_tree(jp), device="cpu")


def port_engine(weights, megastep_k=8, **kw):
    kw.setdefault("max_slots", SLOTS)
    return pkv.PagedDecodeEngine(weights[2], weights[3], max_len=MAX_LEN,
                                 prefill_buckets=BUCKETS, page_size=PAGE,
                                 megastep_k=megastep_k, device="cpu", **kw)


def jax_engine(weights, megastep_k=8):
    return jserving.PagedDecodeEngine(weights[0], weights[1],
                                      max_slots=SLOTS, max_len=MAX_LEN,
                                      prefill_buckets=BUCKETS,
                                      page_size=PAGE, megastep_k=megastep_k)


def random_prompts(n, seed, lo=1, hi=8):
    rng = np.random.RandomState(seed)
    return [rng.randint(2, VOCAB, size=int(k)).astype(np.int32)
            for k in rng.randint(lo, hi + 1, size=n)]


def prefilled(eng, prompts, budget=12):
    for s, p in enumerate(prompts):
        eng.prefill(s, p, max_new_tokens=budget)
    return eng


def stream(res, slot):
    return [int(t) for t in res["out"][:, slot] if t >= 0]


def port_steps(weights, prompts, steps, temps, seed, **kw):
    """The port's step-at-a-time stream: step t draws under (seed, t)."""
    eng = prefilled(port_engine(weights, **kw), prompts, budget=steps + 2)
    out = [[] for _ in prompts]
    for t in range(steps):
        toks = eng.decode_step(temps, seed=seed, step=t)
        for s in range(len(prompts)):
            out[s].append(int(toks[s]))
    return out


# -- the engine against the reference --------------------------------------

@pytest.mark.parametrize("case", ["plain", "eos", "caps"])
def test_greedy_megastep_matches_the_reference(weights, case):
    """k_eff 1, 2 and 5 in turn (8 trips): out, trips, n_emitted, live and
    the host lengths equal the JAX megastep's after every megastep, and
    the streams equal the JAX step-at-a-time tokens (truncated at EOS /
    the caps)."""
    prompts = random_prompts(SLOTS, seed=3, lo=2, hi=7)
    je = prefilled(jax_engine(weights), prompts)
    ref_steps = [[] for _ in prompts]
    for t in range(8):
        toks = je.decode_step(jax.random.PRNGKey(0))
        for s in range(SLOTS):
            ref_steps[s].append(int(toks[s]))
    eos = ref_steps[0][2] if case == "eos" else None
    caps = np.array([1, 3, 8, 5], np.int32) if case == "caps" else None
    je = prefilled(jax_engine(weights), prompts)
    pe = prefilled(port_engine(weights), prompts)
    rng0 = jax.random.PRNGKey(17)
    got = [[] for _ in prompts]
    step0, jcaps, pcaps = 0, caps, caps
    for kk in (1, 2, 5):
        jr = je.megastep_decode(rng0, step0, k_eff=kk, caps=jcaps,
                                eos_id=eos)
        pr = pe.megastep_decode(17, step0, k_eff=kk, caps=pcaps,
                                eos_id=eos)
        assert pr["trips"] == jr["trips"]
        np.testing.assert_array_equal(pr["out"], np.asarray(jr["out"]))
        np.testing.assert_array_equal(pr["n_emitted"], jr["n_emitted"])
        np.testing.assert_array_equal(pr["live"], jr["live"])
        np.testing.assert_array_equal(pe.lengths, je.lengths)
        for s in range(SLOTS):
            got[s].extend(stream(pr, s))
        step0 += pr["trips"]
        if caps is not None:
            # the remaining caps of the slots still live
            done = np.array([len(g) for g in got])
            jcaps = pcaps = np.maximum(caps - done, 0).astype(np.int32)
        # frozen slots (EOS, caps) stay frozen: the next megastep's live
        # mask is the host's active set minus them
        if case != "plain":
            keep = np.asarray(pr["live"])
            for s in np.flatnonzero(~keep):
                je.release(int(s))
                pe.release(int(s))
            if not keep.any():
                break
    for s in range(SLOTS):
        want = ref_steps[s]
        if eos is not None and eos in want:
            want = want[:want.index(eos) + 1]
        if caps is not None:
            want = want[:int(caps[s])]
        assert got[s] == want, s


def test_temperature_megastep_equals_the_ports_step_stream(weights):
    """A mixed cohort (temperatures 0, 0.9, 0, 0.7): megasteps of 1, 2
    and 5 trips emit the step-at-a-time stream of the same seed, and the
    sampled slots leave the greedy stream."""
    prompts = random_prompts(SLOTS, seed=3, lo=2, hi=7)
    ref = port_steps(weights, prompts, 8, MIXED, seed=17)
    greedy = port_steps(weights, prompts, 8, np.zeros(SLOTS), seed=17)
    eng = prefilled(port_engine(weights), prompts, budget=10)
    got, step0 = [[] for _ in prompts], 0
    for kk in (1, 2, 5):
        res = eng.megastep_decode(17, step0, k_eff=kk, temperatures=MIXED)
        assert res["trips"] == kk
        for s in range(SLOTS):
            got[s].extend(stream(res, s))
        step0 += res["trips"]
    assert got == ref
    assert got[0] == greedy[0] and got[2] == greedy[2]
    assert got[1] != greedy[1] or got[3] != greedy[3]


def test_draws_are_a_pure_function_of_seed_step_and_slot():
    """The same (seed, step) gives the same draws whether passed as ints
    or as device tensors, whatever the other slots hold; another step or
    seed gives others; the draw follows softmax(logits / t)."""
    torch.manual_seed(0)
    logits = torch.randn(4, VOCAB)
    temps = torch.tensor([0.0, 0.9, 0.0, 0.7])
    a = pgen.draw_tokens(logits, temps, 7, 3)
    b = pgen.draw_tokens(logits, temps, torch.tensor([7]), torch.tensor([3]))
    assert torch.equal(a, b)
    other = logits.clone()
    other[3] = torch.randn(VOCAB)
    assert torch.equal(pgen.draw_tokens(other, temps, 7, 3)[:3], a[:3])
    assert torch.equal(a[[0, 2]], torch.argmax(logits, -1)[[0, 2]])
    draws = torch.stack([pgen.draw_tokens(logits, temps, 7, s)
                         for s in range(64)])
    assert len(set(draws[:, 1].tolist())) > 1
    row = torch.tensor([[0.0, 1.0, 2.0]])
    n = 4000
    counts = np.bincount([int(pgen.draw_tokens(row, torch.ones(1), 1, s)[0])
                          for s in range(n)], minlength=3) / n
    np.testing.assert_allclose(counts, torch.softmax(row, -1)[0].numpy(),
                               atol=0.03)


def test_eos_freezes_a_slot_without_bleed(weights):
    prompts = random_prompts(SLOTS, seed=11, lo=2, hi=7)
    ref = port_steps(weights, prompts, 8, np.zeros(SLOTS), seed=5)
    eos = ref[0][2]
    eng = prefilled(port_engine(weights), prompts, budget=10)
    res = eng.megastep_decode(5, 0, k_eff=8, eos_id=eos)
    for s in range(SLOTS):
        want = ref[s][:ref[s].index(eos) + 1] if eos in ref[s] else ref[s]
        assert stream(res, s) == want, s
        assert int(res["n_emitted"][s]) == len(want)
        assert bool(res["live"][s]) == (eos not in want)
        assert int(eng.lengths[s]) == len(prompts[s]) + len(want)


def test_caps_freeze_and_all_frozen_ends_the_trips_early(weights):
    prompts = random_prompts(SLOTS, seed=4, lo=2, hi=6)
    ref = port_steps(weights, prompts, 3, np.zeros(SLOTS), seed=2)
    eng = prefilled(port_engine(weights), prompts, budget=10)
    caps = np.array([1, 2, 3, 2], np.int32)
    res = eng.megastep_decode(2, 0, k_eff=8, caps=caps)
    assert res["trips"] == 3 and res["out"].shape == (3, SLOTS)
    assert eng.trip_stats["trips_dispatched"] == 8
    for s in range(SLOTS):
        assert stream(res, s) == ref[s][:int(caps[s])]
        assert int(res["n_emitted"][s]) == int(caps[s])
        assert not res["live"][s]


def test_chained_dispatch_equals_unchained(weights):
    """Megastep N+1 dispatched from N's device outputs before N is synced
    emits what one megastep of N+1's trips would."""
    prompts = random_prompts(SLOTS, seed=9, lo=2, hi=7)
    temps = np.array([0.0, 0.8, 0.0, 0.0], np.float32)
    ref = port_steps(weights, prompts, 8, temps, seed=23)
    eng = prefilled(port_engine(weights), prompts, budget=10)
    h1 = eng.megastep_dispatch(23, 0, 4, temperatures=temps)
    h2 = eng.megastep_dispatch(23, h1["step0"] + h1["trips"], 4,
                               temperatures=temps,
                               caps=h1["caps"] - h1["n_emitted"],
                               live=h1["live"], tokens=h1["tokens"],
                               lengths=h1["lengths"])
    r1, r2 = eng.megastep_sync(h1), eng.megastep_sync(h2)
    assert [stream(r1, s) + stream(r2, s) for s in range(SLOTS)] == ref
    step = prefilled(port_engine(weights), prompts, budget=10)
    for t in range(8):
        step.decode_step(temps, seed=23, step=t)
    np.testing.assert_array_equal(eng.lengths, step.lengths)
    np.testing.assert_array_equal(eng._in_tokens, step._in_tokens)


def test_sync_applies_only_the_tracked_slots(weights):
    prompts = random_prompts(2, seed=6, lo=2, hi=5)
    eng = prefilled(port_engine(weights), prompts, budget=10)
    before = eng.lengths.copy()
    res = eng.megastep_sync(eng.megastep_dispatch(0, 0, 3), only=[1])
    assert res["trips"] == 3 and list(res["n_emitted"][:2]) == [3, 3]
    assert eng.lengths[0] == before[0] and eng.lengths[1] == before[1] + 3


def test_k_eff_bounds_and_live_checks(weights):
    eng = port_engine(weights, megastep_k=4)
    with pytest.raises(RuntimeError, match="no live slots"):
        eng.megastep_dispatch(0, 0, 2)
    eng.prefill(0, np.array([3, 4], np.int32), max_new_tokens=4)
    for bad in (0, 5):
        with pytest.raises(ValueError, match="k_eff"):
            eng.megastep_dispatch(0, 0, bad)
    assert eng.megastep_decode(0, 0, k_eff=4)["trips"] == 4
    with pytest.raises(RuntimeError, match="reserved page budget"):
        eng.megastep_dispatch(0, 4, 1)


@pytest.mark.parametrize("kw,flag", [
    ({"megastep_k": -1}, "FLAGS_generation_megastep_k"),
    ({"megastep_k": "nope"}, "FLAGS_generation_megastep_k"),
    ({"max_len": 8, "prefill_buckets": (4,), "megastep_k": 8},
     "FLAGS_generation_megastep_k"),
])
def test_knob_errors_name_the_flag_as_the_reference_does(kw, flag):
    with pytest.raises(ValueError, match=flag) as ref:
        jserving.resolve_generation_knobs(paged=True, **kw)
    with pytest.raises(ValueError, match=flag) as got:
        pgen.resolve_generation_knobs(paged=True, **kw)
    assert str(got.value) == str(ref.value)


def test_knob_resolves_as_the_reference_does(weights):
    for kw in ({"megastep_k": 6}, {"megastep_k": 0}, {},
               {"max_len": 6, "prefill_buckets": (4,), "megastep_k": 0}):
        ref = jserving.resolve_generation_knobs(paged=True, **kw)
        got = pgen.resolve_generation_knobs(paged=True, **kw)
        assert got[-1] == ref[-1], kw
    assert pgen.resolve_generation_knobs(paged=True, max_len=6,
                                         prefill_buckets=(4,),
                                         megastep_k=0)[-1] == 5
    assert port_engine(weights, megastep_k=4).megastep_k == 4
    assert port_engine(weights, megastep_k=None).megastep_k == 1


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantized_pools_megastep_equals_decode_step(weights, mode):
    """Greedy and temperature cohorts on int8/fp8 pages: the tokens, the
    pools and the scales after a megastep equal the eager steps' bit for
    bit."""
    prompts = random_prompts(SLOTS, seed=5, lo=2, hi=7)
    for temps in (np.zeros(SLOTS, np.float32), MIXED):
        ref = port_steps(weights, prompts, 7, temps, seed=3,
                         kv_quant_dtype=mode)
        step = prefilled(port_engine(weights, kv_quant_dtype=mode), prompts,
                         budget=9)
        for t in range(7):
            step.decode_step(temps, seed=3, step=t)
        eng = prefilled(port_engine(weights, kv_quant_dtype=mode), prompts,
                        budget=9)
        r1 = eng.megastep_decode(3, 0, k_eff=2, temperatures=temps)
        r2 = eng.megastep_decode(3, 2, k_eff=5, temperatures=temps)
        assert [stream(r1, s) + stream(r2, s) for s in range(SLOTS)] == ref
        scratch = eng.scratch_page
        for a, b in zip(eng._kp + eng._vp + eng._ks + eng._vs,
                        step._kp + step._vp + step._ks + step._vs):
            assert torch.equal(a[:scratch].view(torch.uint8)
                               if a.dtype == torch.float8_e4m3fn else
                               a[:scratch],
                               b[:scratch].view(torch.uint8)
                               if b.dtype == torch.float8_e4m3fn else
                               b[:scratch])


def test_a_failed_trip_marks_the_engine_dead_and_reset_drops_the_state(
        weights, monkeypatch):
    prompts = random_prompts(2, seed=8, lo=2, hi=5)
    eng = prefilled(port_engine(weights), prompts, budget=8)
    eng.megastep_decode(0, 0, k_eff=2)
    assert eng._ms is not None

    def boom(*a, **k):
        raise RuntimeError("device fault")
    monkeypatch.setattr(eng.model, "paged_decode_logits", boom)
    with pytest.raises(pgen.DeviceStateError, match="device fault"):
        eng.megastep_dispatch(0, 2, 2)
    monkeypatch.undo()
    with pytest.raises(pgen.DeviceStateError):
        eng.megastep_dispatch(0, 2, 2)
    eng.reset()
    assert eng._ms is None and not eng.active.any()
    prefilled(eng, prompts, budget=8)
    assert eng.megastep_decode(0, 0, k_eff=3)["trips"] == 3


def test_megastep_metrics_carry_the_reference_names():
    for name in ("GENERATION_MEGASTEPS", "GENERATION_MEGASTEP_TRIPS",
                 "DECODE_HOST_GAP_SECONDS", "DECODE_HOST_GAP"):
        got, ref = getattr(catalog, name), getattr(jcatalog, name)
        assert (got.name, got.kind, got.help) == (ref.name, ref.kind,
                                                  ref.help)


# -- the scheduler ----------------------------------------------------------

def run_sched(weights, prompts, megastep_k, temperature=0.0, max_new=12,
              seed=0):
    eng = port_engine(weights, megastep_k=megastep_k)
    with pgen.GenerationScheduler(eng, eos_id=1, queue_depth=64,
                                  default_max_new_tokens=max_new,
                                  seed=seed) as sched:
        pend = [sched.submit(p, temperature=temperature) for p in prompts]
        res = [p.wait(120) for p in pend]
    return res, eng


def test_scheduler_at_k8_emits_the_k1_streams_and_counts_megasteps(
        weights):
    prompts = random_prompts(2 * SLOTS, seed=7, lo=2, hi=8)
    profiler.reset_counters()
    profiler.reset_histograms()
    r1, _ = run_sched(weights, prompts, 1)
    assert catalog.GENERATION_MEGASTEPS.value() == 0
    steps1 = catalog.GENERATION_DECODE_STEPS.value()
    assert "decode_host_gap_seconds_total" in profiler.get_counters()
    profiler.reset_counters()
    profiler.reset_histograms()
    r8, eng = run_sched(weights, prompts, 8)
    assert [r["tokens"] for r in r8] == [r["tokens"] for r in r1]
    megasteps = catalog.GENERATION_MEGASTEPS.value()
    trips = profiler.get_histogram("generation_megastep_trips")
    assert megasteps == len(trips) > 0
    # a chained megastep whose riders all finished in the one before it
    # is synced and dropped, uncounted
    assert eng.trip_stats["megasteps"] >= megasteps
    assert all(1 <= t <= 8 for t in trips)
    # trips executed, plus any K = 1 steps the clamp chose, are the steps
    assert catalog.GENERATION_DECODE_STEPS.value() == \
        sum(trips) + eng.trip_stats["decode_steps"]
    assert megasteps < steps1
    assert catalog.GENERATION_TOKENS.value() == \
        sum(len(r["tokens"]) for r in r8)
    assert "decode_host_gap_seconds_total" in profiler.get_counters()
    assert "decode_host_gap_seconds" in profiler.get_histograms()
    for r in r8:
        slo = r["slo"]
        assert slo["tokens"] == len(r["tokens"])
        assert slo["decode_steps"] >= slo["tokens"] - 1
        if slo["tokens"] >= 2:
            assert slo["tpot_ms"] > 0


def test_scheduler_temperature_traffic_rides_megasteps(weights):
    """Sampled requests decode to the end in megasteps; one request's
    stream is pinned by the seed (a cohort's depends on the step each
    request was admitted at, as in the reference)."""
    prompts = random_prompts(SLOTS, seed=7, lo=2, hi=8)
    res, eng = run_sched(weights, prompts, 8, temperature=0.9, seed=4)
    assert eng.trip_stats["megasteps"] > 0
    for r in res:
        assert 1 <= len(r["tokens"]) <= 12
        assert r["slo"]["outcome"] in ("eos", "length")
    one = [run_sched(weights, prompts[:1], 8, temperature=0.9, seed=4)[0]
           for _ in range(2)]
    assert one[0][0]["tokens"] == one[1][0]["tokens"]


def test_clamp_k_by_budget_and_deadline(weights):
    eng = port_engine(weights, megastep_k=8)
    with pgen.GenerationScheduler(eng, eos_id=1) as sched:
        sched._step_ewma_s = 0.01   # 10 ms a trip observed

        def st(budget=50, done=0, slack_s=None):
            dl = None if slack_s is None else time.perf_counter() + slack_s
            return types.SimpleNamespace(
                budget=budget, generated=[0] * done,
                pending=types.SimpleNamespace(deadline=dl))

        assert sched._clamp_k({0: st()}) == 8
        assert sched._clamp_k({0: st(), 1: st(slack_s=0.025)}) <= 2
        assert sched._clamp_k({0: st(slack_s=-1.0)}) == 1
        assert sched._clamp_k({0: st(budget=5, done=2),
                               1: st(budget=3, done=2)}) == 3
        sched._step_ewma_s = None   # nothing observed: budgets only
        assert sched._clamp_k({0: st(slack_s=0.001)}) == 8


def test_chain_gate_requires_every_slot_rode_the_previous_megastep(
        weights):
    eng = port_engine(weights, megastep_k=8)
    with pgen.GenerationScheduler(eng, eos_id=1) as sched:
        a, b = object(), object()
        state = {"saw_stop": False}
        assert sched._ms_can_chain({0: a}, state, {0: a})
        assert not sched._ms_can_chain({0: a, 1: b}, state, {0: a})
        assert not sched._ms_can_chain({0: b}, state, {0: a})
        assert not sched._ms_can_chain({}, state, {})
        assert not sched._ms_can_chain({0: a}, {"saw_stop": True}, {0: a})
        sched._held_q.append({"req": None})   # a parked admission
        assert not sched._ms_can_chain({0: a}, state, {0: a})
        sched._held_q.clear()
    eng1 = port_engine(weights, megastep_k=1)
    with pgen.GenerationScheduler(eng1) as sched:
        assert not sched._ms_can_chain({0: a}, {"saw_stop": False},
                                       {0: a})


def test_staggered_admissions_drain_with_the_reference_streams(weights):
    """Requests that arrive while megasteps fly decode to the end, with
    the JAX package's greedy streams."""
    prompts = random_prompts(10, seed=21, lo=2, hi=7)
    je = jax_engine(weights)
    refs = [jserving.greedy_generate(je, [p], 8, eos_id=1)[0]
            for p in prompts]
    eng = port_engine(weights, megastep_k=8)
    with pgen.GenerationScheduler(eng, eos_id=1, queue_depth=64,
                                  default_max_new_tokens=8) as sched:
        pend = []
        for i, p in enumerate(prompts):
            pend.append(sched.submit(p))
            if i % 3 == 2:
                time.sleep(0.05)
        res = [p.wait(120) for p in pend]
    assert [r["tokens"] for r in res] == refs
    assert eng.trip_stats["megasteps"] > 0


# -- the serve CLI ----------------------------------------------------------

def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def test_serve_cli_megastep_k_answers_the_k1_tokens(weights, tmp_path):
    pgen.save_decoder(str(tmp_path / "dec"), weights[2], weights[3])
    prompts = [[4, 5, 6], [7, 8], [9, 10, 11, 12, 13]]
    out = {}
    for k in ("1", "4"):
        env = dict(os.environ, PYTHONPATH=REPO)
        proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.serving.serve",
             "--generation-model", str(tmp_path / "dec"), "--device", "cpu",
             "--port", "0", "--gen-max-slots", "2", "--gen-max-len", "32",
             "--gen-prefill-buckets", "4,8", "--gen-page-size", "4",
             "--gen-paged", "--gen-megastep-k", k], cwd=str(tmp_path),
            env=env, stderr=subprocess.PIPE, text=True)
        try:
            line = proc.stderr.readline()
            assert line.startswith("serve: http://"), line
            assert "megastep_k=%s" % k in line
            url = line.split()[1]
            out[k] = [_post(url + "/v1/generate",
                            {"prompt": p, "max_new_tokens": 9})["tokens"]
                      for p in prompts]
            with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
                assert json.loads(r.read())["serving"]["megastep_k"] == \
                    int(k)
            with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
                text = r.read().decode()
            megasteps = [float(ln.split()[-1]) for ln in text.splitlines()
                         if ln.startswith(
                             "paddle_tpu_generation_megasteps_total ")]
            assert bool(megasteps and megasteps[0] > 0) == (k == "4"), \
                megasteps
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(60) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(30)
            proc.stderr.close()
    assert out["4"] == out["1"]
    assert all(len(t) == 9 for t in out["1"])
