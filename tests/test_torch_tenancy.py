"""Tenants, priorities, brownout, SLO control and preemption to the held
lane in the port's scheduler, held against the JAX reference on the CPU
(2 layers, 16 wide, vocab 61, max_len 40, pages of 4):

- ``resolve_tenant_knobs`` defaults, parsing and errors (same text as the
  reference's, naming the flag); ``parse_tenant_header``; the deadline
  and shed knobs of ``resolve_fleet_knobs``, which the scheduler reads;
- ``BrownoutController`` level sequences under an injected clock, equal
  to the reference's;
- the held lane's class order and FIFO, its budget and page blocks and
  the deadline sweep, equal to the reference scheduler's on the same
  entries; the SLO loop under injected times;
- budget preemption resuming token-identically with a prefix hit, with
  and without megasteps; tenant isolation; page-pressure preemption;
- brownout shedding and clamping, and the HTTP surface: a shed
  low-priority request answered 503 with Retry-After, ``X-Tenant-Id``,
  ``/healthz`` and ``/metrics``; the serve CLI's engine choice.

Token streams are compared exactly; no numeric tolerance applies.
"""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from paddle_tpu import flags as jflags
from paddle_tpu import serving as js
from paddle_tpu.serving.generation import _SlotState as JSlotState
from paddle_tpu_torch import flags as pflags
from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.observability import catalog, tracing
from paddle_tpu_torch.serving import (DeadlineExceededError, OverloadedError,
                                      PendingResult, make_server,
                                      parse_tenant_header,
                                      resolve_fleet_knobs)
from paddle_tpu_torch.serving import generation as pgen
from paddle_tpu_torch.serving import paged_kv as pkv

VOCAB, DIM, HEADS, LAYERS = 61, 16, 2, 2
MAX_LEN, BUCKETS, PAGE = 40, (8, 16, 32), 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def np_tree(params):
    return {k: ([{n: np.asarray(a) for n, a in b.items()} for b in v]
                if k == "blocks" else np.asarray(v))
            for k, v in params.items()}


@pytest.fixture(scope="module")
def weights():
    jm = js.TransformerDecoderModel(VOCAB, dim=DIM, n_heads=HEADS,
                                    n_layers=LAYERS)
    jp = jm.init_params(0)
    pm = pgen.TransformerDecoderModel(VOCAB, dim=DIM, n_heads=HEADS,
                                      n_layers=LAYERS)
    return jm, jp, pm, params_from_jax(np_tree(jp), device="cpu")


def paged(weights, max_slots=2, num_pages=None, **kw):
    return pkv.PagedDecodeEngine(weights[2], weights[3], max_slots=max_slots,
                                 max_len=MAX_LEN, prefill_buckets=BUCKETS,
                                 page_size=PAGE, num_pages=num_pages,
                                 device="cpu", **kw)


def dense(weights, max_slots=2):
    return pgen.DecodeEngine(weights[2], weights[3], max_slots=max_slots,
                             max_len=MAX_LEN, prefill_buckets=BUCKETS,
                             device="cpu")


def solo(weights, prompt, n):
    """The uninterrupted greedy stream of the JAX reference."""
    eng = js.PagedDecodeEngine(weights[0], weights[1], max_slots=1,
                               max_len=MAX_LEN, prefill_buckets=BUCKETS,
                               page_size=PAGE)
    return js.greedy_generate(eng, [prompt], n, eos_id=None)[0]


def pinned(level, cls=pgen.BrownoutController):
    """A controller frozen at ``level`` (no observation moves it within
    the dwell)."""
    bc = cls(high=0.99, low=0.0, dwell_s=3600.0)
    bc._level, bc._last_change = level, time.monotonic()
    return bc


# -- knobs and headers --------------------------------------------------------

def test_resolve_tenant_knobs_defaults_and_parsing_equal_the_reference():
    for kw in ({}, {"token_budget_map": "a=5, b=0",
                    "slo_ttft_ms": "high=250,low=0",
                    "slo_tpot_ms": {"high": 50}},
               {"token_budget": 7, "budget_window_s": 0.5, "held_depth": 3,
                "slo_sustain_s": 0}):
        got = pgen.resolve_tenant_knobs(**kw)
        assert got == js.resolve_tenant_knobs(**kw), kw
    assert pgen.resolve_tenant_knobs() == {
        "token_budget": 0, "token_budget_map": {}, "budget_window_s": 1.0,
        "held_depth": 8, "slo_ttft_ms": {}, "slo_tpot_ms": {},
        "slo_sustain_s": 1.0}
    assert pgen.resolve_tenant_knobs(slo_ttft_ms="high=250,low=0")[
        "slo_ttft_ms"] == {"high": 250.0}   # a 0 target is no target


@pytest.mark.parametrize("kw,flag", [
    (dict(token_budget=-1), "FLAGS_tenant_token_budget"),
    (dict(token_budget="x"), "FLAGS_tenant_token_budget"),
    (dict(token_budget_map="oops"), "FLAGS_tenant_token_budget_map"),
    (dict(token_budget_map="a=-2"), "FLAGS_tenant_token_budget_map"),
    (dict(token_budget_map="=3"), "FLAGS_tenant_token_budget_map"),
    (dict(budget_window_s=0), "FLAGS_tenant_budget_window_s"),
    (dict(held_depth=0), "FLAGS_tenant_held_depth"),
    (dict(slo_ttft_ms="mid=5"), "FLAGS_slo_ttft_ms"),
    (dict(slo_tpot_ms="high=nan"), "FLAGS_slo_tpot_ms"),
    (dict(slo_sustain_s=-1), "FLAGS_slo_sustain_s"),
])
def test_tenant_knob_errors_name_the_flag_as_the_reference_does(kw, flag):
    with pytest.raises(ValueError, match=flag) as ref:
        js.resolve_tenant_knobs(**kw)
    with pytest.raises(ValueError, match=flag) as got:
        pgen.resolve_tenant_knobs(**kw)
    assert str(got.value) == str(ref.value)


def test_tenant_flags_carry_the_reference_defaults():
    for name in ("tenant_token_budget", "tenant_token_budget_map",
                 "tenant_budget_window_s", "tenant_held_depth",
                 "slo_ttft_ms", "slo_tpot_ms", "slo_sustain_s",
                 "shed_high_watermark", "shed_low_watermark",
                 "shed_token_cap", "speculative_k"):
        assert getattr(pflags, name) == getattr(jflags, name), name


def test_parse_tenant_header_as_the_reference():
    assert parse_tenant_header("team-a.prod_1") == "team-a.prod_1"
    for raw in (None, "", "a b", "a/b", "x" * 65, "x" * 64, 7, "ok"):
        assert parse_tenant_header(raw) == js.parse_tenant_header(raw)


@pytest.mark.parametrize("kw,flag", [
    (dict(shed_high_watermark=1.5), "shed_high_watermark"),
    (dict(shed_high_watermark=0.5, shed_low_watermark=0.5), "hysteresis"),
    (dict(shed_retry_floor_s=2.0, shed_retry_cap_s=1.0),
     "shed_retry_cap_s"),
    (dict(shed_token_cap=0), "shed_token_cap"),
    (dict(deadline_default_ms=-1), "deadline_default_ms"),
    (dict(deadline_admit_min_ms="soon"), "deadline_admit_min_ms"),
])
def test_fleet_knob_errors_as_the_reference(kw, flag):
    with pytest.raises(ValueError, match=flag) as ref:
        js.resolve_fleet_knobs(**kw)
    with pytest.raises(ValueError, match=flag) as got:
        resolve_fleet_knobs(**kw)
    assert str(got.value) == str(ref.value)
    ref_knobs = js.resolve_fleet_knobs()
    assert resolve_fleet_knobs() == {k: ref_knobs[k]
                                     for k in resolve_fleet_knobs()}


def test_scheduler_reads_the_deadline_and_shed_flags_through_one_resolver(
        weights, monkeypatch):
    for name, bad in (("deadline_default_ms", -1.0),
                      ("shed_token_cap", 0), ("shed_retry_cap_s", 0.01)):
        monkeypatch.setattr(pflags, name, bad)
        with pytest.raises(ValueError, match="FLAGS_%s" % name):
            pgen.GenerationScheduler(paged(weights))
        monkeypatch.undo()
    monkeypatch.setattr(pflags, "shed_high_watermark", 2.0)
    with pytest.raises(ValueError, match="FLAGS_shed_high_watermark"):
        pgen.BrownoutController()


# -- the brownout ladder -----------------------------------------------------

class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def test_brownout_level_sequences_equal_the_reference():
    rng = np.random.RandomState(4)
    pressures = np.concatenate([[0.9, 0.99, 0.9, 0.65, 0.9, 1.0, 0.5, 0.0],
                                rng.rand(200)])
    steps = np.concatenate([[0, 0, 1, 1, 1, 1, 1, 0],
                            rng.choice([0.0, 0.3, 1.0], size=200)])
    seqs = []
    for cls in (pgen.BrownoutController, js.BrownoutController):
        clock = FakeClock()
        bc = cls(high=0.8, low=0.5, dwell_s=1.0, clock=clock)
        seq = []
        for p, dt in zip(pressures, steps):
            clock.t += dt
            seq.append(bc.update(p))
        seqs.append(seq)
    assert seqs[0] == seqs[1]
    assert seqs[0][:8] == [1, 1, 2, 2, 3, 3, 2, 2]   # one step a dwell
    assert set(seqs[0]) == {0, 1, 2, 3}
    changes = [e for e in tracing.trace_events()
               if e.get("name") == "shed.brownout"]
    assert changes and changes[-1]["args"]["level"] == seqs[0][-1]


# -- the held lane (unit: closed schedulers driven directly) ----------------

@pytest.fixture(scope="module")
def unit_scheds(weights):
    """A CLOSED port scheduler and a CLOSED reference scheduler: their
    loop threads are gone, so the tests own the loop-private state."""
    jm, jp = weights[:2]
    jeng = js.PagedDecodeEngine(jm, jp, max_slots=2, max_len=MAX_LEN,
                                prefill_buckets=BUCKETS, page_size=PAGE,
                                num_pages=16)
    scheds = (pgen.GenerationScheduler(paged(weights, num_pages=16), eos_id=1,
                                       queue_depth=8,
                                       default_max_new_tokens=4),
              js.GenerationScheduler(jeng, eos_id=1, queue_depth=8,
                                     default_max_new_tokens=4))
    for s in scheds:
        assert s.close(timeout=60)
    yield scheds


@pytest.fixture(autouse=True)
def _reset_unit_state(request):
    yield
    if "unit_scheds" in request.fixturenames:
        for sched in request.getfixturevalue("unit_scheds"):
            sched._held_q.clear()
            sched._tenant_used.clear()
            sched._tenant["token_budget_map"].clear()
            sched._slo_bad_since.clear()
            sched._slo_pressed = False
            sched._slo_ttft = {}
            sched._slo_tpot = {}


def _pending(priority="high", tenant=None, deadline=None):
    p = PendingResult()
    p.priority, p.tenant, p.deadline = priority, tenant, deadline
    return p


def _entry(pending, prompt_len=4, budget=4):
    req = (pending, np.arange(2, 2 + prompt_len, dtype=np.int32), budget,
           0.0)
    return {"req": req, "resume": None, "resume_prompt": None,
            "since": None, "reason": None}


def _lane_script(sched):
    """Park, pick and pull the same entries as the reference's held-lane
    tests do; returns the labels in the order they came out."""
    state = {"saw_stop": False}
    out = []
    ents = {}

    def park(label, cls, tenant, reason, resume=False):
        e = _entry(_pending(cls, tenant=tenant))
        if resume:
            e["resume"] = object()
        ents[label] = e
        sched._park(e, reason)

    def pick(snap_slots=None, stop=False):
        e = sched._held_pick(None, snap_slots or {},
                             {"saw_stop": True} if stop else state)
        out.append(next((k for k, v in ents.items() if v is e), None))

    park("a", "low", "a", "pages")
    park("b", "low", "b", "pages")
    park("h", "high", None, "pages")
    park("r", "low", None, "slo", resume=True)
    out.append(sched._held_q[0] is ents["r"])
    for _ in range(5):
        pick()
    sched._tenant["token_budget_map"]["agg"] = 2
    sched._tenant_used["agg"] = 2
    park("x", "low", "agg", "budget")
    park("y", "low", "y", "pages")
    pick()                      # the budget block is bypassable
    pick(stop=True)             # draining lifts the budget gate
    # fresh pulls: FIFO behind parked work of the class, except another
    # tenant's budget park
    park("z", "low", "agg", "budget")
    for label, cls, tenant in (("f1", "low", "agg"), ("f2", "low", "other"),
                               ("f3", "high", None)):
        e = _entry(_pending(cls, tenant=tenant))
        sched._admit_held_behind(e, e["req"])
        out.append((label, e["since"] is not None))
    sched._held_q.clear()
    park("p", "low", "x", "pages")
    e = _entry(_pending("low", tenant="other"))
    sched._admit_held_behind(e, e["req"])
    out.append(("f4", e["since"] is not None))
    return out


def test_held_lane_order_equals_the_reference(unit_scheds):
    got, ref = (_lane_script(s) for s in unit_scheds)
    assert got == ref
    assert got[:6] == [True, "h", "r", "a", "b", None]
    assert got[6:8] == ["y", "x"]
    assert got[8:] == [("f1", True), ("f2", False), ("f3", False),
                       ("f4", True)]


def test_a_page_blocked_head_holds_its_class(unit_scheds, monkeypatch):
    sched = unit_scheds[0]
    state = {"saw_stop": False}
    c = _entry(_pending("low", tenant="c"))
    d = _entry(_pending("low", tenant="d"))
    sched._park(c, "pages")
    sched._park(d, "pages")
    monkeypatch.setattr(sched.engine, "can_admit", lambda *a, **k: False)
    assert sched._held_pick(None, {0: object()}, state) is None
    monkeypatch.setattr(sched.engine, "can_admit", lambda *a, **k: True)
    assert sched._held_pick(None, {0: object()}, state) is c


def test_deadline_passing_while_held_504s_before_a_prefill(unit_scheds,
                                                            monkeypatch):
    sched = unit_scheds[0]
    calls = []
    monkeypatch.setattr(sched.engine, "prefill",
                        lambda *a, **k: calls.append(a))
    p = _pending("low", deadline=time.perf_counter() - 0.01)
    sched._park(_entry(p), "pages")
    before = catalog.DEADLINE_EXCEEDED.value(stage="held")
    sched._sweep_held_deadlines()
    assert not sched._held_q and not calls
    assert catalog.DEADLINE_EXCEEDED.value(stage="held") == before + 1
    with pytest.raises(DeadlineExceededError, match="held lane"):
        p.wait(1)


def _slo_script(sched, slot_state):
    """The reference's SLO scenarios at injected times: a queued high
    request past its TTFT target presses after the sustain and releases
    when the lane drains; a starving high slot's live TPOT presses."""
    out = []
    sched._slo_ttft = {"high": 50.0}
    sched._tenant["slo_sustain_s"] = 0.05
    p = _pending("high")
    p.t_enqueue = time.perf_counter() - 1.0
    sched._park(_entry(p), "pages")
    now = time.perf_counter()
    sched._slo_update({}, now)
    out.append(sched._slo_pressed)         # violating, not yet sustained
    sched._slo_update({}, now + 0.1)
    out += [sched._slo_pressed, sched._pressure(), sched._clamp_k({})]
    sched._held_q.clear()
    sched._slo_update({}, now + 0.2)
    out.append(sched._slo_pressed)
    sched._slo_ttft = {}
    sched._slo_tpot = {"high": 50.0}
    st = slot_state(_pending("high"), np.arange(2, 6, dtype=np.int32), 8,
                    0.0)
    st.generated = [3, 4, 5]
    st.t_first = now - 10.0     # 3 tokens in 10 s: far past 50 ms a token
    sched._slo_update({0: st}, now + 1.0)
    sched._slo_update({0: st}, now + 1.1)
    out.append(sched._slo_pressed)
    return out


def test_slo_loop_equals_the_reference(unit_scheds):
    before = catalog.SLO_VIOLATION_SECONDS.value(**{"class": "high"})
    got = _slo_script(unit_scheds[0], pgen._SlotState)
    assert got == _slo_script(unit_scheds[1], JSlotState)
    assert got == [False, True, 1.0, 1, False, True]
    assert catalog.SLO_VIOLATION_SECONDS.value(**{"class": "high"}) > before


# -- preemption to the held lane (integration) -----------------------------

@pytest.mark.parametrize("megastep_k", [1, 8])
def test_budget_preemption_resumes_token_identical_with_a_prefix_hit(
        weights, megastep_k):
    """A tenant past its window budget is preempted between (mega)steps:
    its pages park in the prefix cache, the window rolls, the
    re-admission prefills prompt + generated with the parked pages
    mapped, and the stream equals the reference's uninterrupted one. The
    window (1.5 s) outlasts the iterations that charge the first 9 tokens
    (the prefill's and K = 8's megastep, or 8 steps), so the budget of 8
    is over before it rolls. At K = 8 the preemption first applies the
    megastep chained behind the first (17 tokens), so that stream asks
    for 20."""
    prompt = np.array([5, 9, 12, 3], np.int32)
    n = 12 if megastep_k == 1 else 20
    ref = solo(weights, prompt, n)
    eng = paged(weights, num_pages=24, megastep_k=megastep_k)
    calls = []
    orig = eng.prefill

    def spy(slot, prm, max_new_tokens=None):
        out = orig(slot, prm, max_new_tokens=max_new_tokens)
        calls.append((len(prm), dict(eng.last_prefill_stats)))
        return out

    eng.prefill = spy
    before = catalog.PREEMPTIONS_TO_HELD.value(reason="budget")
    with pgen.GenerationScheduler(eng, queue_depth=8,
                                  default_max_new_tokens=n,
                                  tenant_token_budget_map={"capped": 8},
                                  tenant_budget_window_s=1.5) as sched:
        got = sched.generate(prompt, timeout=120, tenant="capped")
    assert got["tokens"] == ref
    assert catalog.PREEMPTIONS_TO_HELD.value(reason="budget") >= before + 1
    assert len(calls) >= 2
    (n0, _), (n1, stats1) = calls[0], calls[1]
    assert n0 == len(prompt) and n1 > n0
    assert stats1["prefix_hit_pages"] >= 1
    assert got["slo"]["prefix_hit_pages"] >= 1
    assert not eng.active.any()


def test_budget_throttle_isolates_tenants(weights):
    """One tenant over budget slows only itself: the other tenant's
    stream and the throttled one both equal their solo references, and
    tokens are charged by class."""
    p_agg = np.array([7, 11, 3, 2], np.int32)
    p_vip = np.array([4, 8, 15, 16], np.int32)
    refs = solo(weights, p_agg, 6), solo(weights, p_vip, 6)
    lo0 = catalog.TENANT_TOKENS.value(**{"class": "low"})
    hi0 = catalog.TENANT_TOKENS.value(**{"class": "high"})
    with pgen.GenerationScheduler(paged(weights, max_slots=4, num_pages=32),
                                  queue_depth=16, default_max_new_tokens=6,
                                  tenant_token_budget_map={"agg": 2},
                                  tenant_budget_window_s=0.3) as sched:
        a = sched.submit(p_agg, tenant="agg", priority="low")
        b = sched.submit(p_vip, tenant="vip")
        rb, ra = b.wait(120), a.wait(120)
    assert (ra["tokens"], rb["tokens"]) == refs
    assert catalog.TENANT_TOKENS.value(**{"class": "low"}) - lo0 == 6
    assert catalog.TENANT_TOKENS.value(**{"class": "high"}) - hi0 == 6


def test_page_pressure_preempts_low_class_work_for_a_high_request(weights):
    """A pool too small for both: a high-class arrival preempts the
    low-class one in flight (reason pages); both streams are solo."""
    low_p = np.array([3, 4, 5, 6], np.int32)
    high_p = np.array([9, 8, 7], np.int32)
    refs = solo(weights, low_p, 32), solo(weights, high_p, 8)
    # the low request reserves 9 pages, the high one needs 3 of the 1 left
    eng = paged(weights, num_pages=10)
    go = threading.Event()
    step = eng.decode_step

    def gated(*a, **k):          # the low request decodes until `go`
        go.wait(60)
        return step(*a, **k)

    eng.decode_step = gated
    before = catalog.PREEMPTIONS_TO_HELD.value(reason="pages")
    with pgen.GenerationScheduler(eng, queue_depth=8) as sched:
        low = sched.submit(low_p, max_new_tokens=32, priority="low")
        high = sched.submit(high_p, max_new_tokens=8)
        go.set()
        assert high.wait(120)["tokens"] == refs[1]
        assert low.wait(120)["tokens"] == refs[0]
    assert catalog.PREEMPTIONS_TO_HELD.value(reason="pages") >= before + 1


def test_slo_preemption_with_a_chained_megastep_in_flight(weights):
    """SLO pressure preempts low-class work while a chained megastep is in
    flight: every request is admitted in the first iteration, so megastep
    N+1 is chained before N syncs; the next iteration's SLO loop (a high
    TPOT target no stream can meet, no sustain) preempts the youngest low
    rider, and the lane re-admits it into the slot it left. Every stream
    equals its uninterrupted reference."""
    # prompts whose streams do not settle into a repeat before token 14
    prompts = [np.array([5, 9, 12, 3], np.int32),
               np.array([23, 3, 3, 2, 52, 27], np.int32),
               np.array([60, 16, 49, 38, 21], np.int32)]
    classes, budget = ("high", "low", "low"), 20
    refs = [solo(weights, p, budget) for p in prompts]
    eng = paged(weights, max_slots=len(prompts), num_pages=64, megastep_k=8)
    go = threading.Event()
    prefill = eng.prefill

    def gated(*a, **k):          # the first admission waits for the rest
        go.wait(60)
        return prefill(*a, **k)

    eng.prefill = gated
    before = catalog.PREEMPTIONS_TO_HELD.value(reason="slo")
    with pgen.GenerationScheduler(eng, queue_depth=8,
                                  slo_tpot_ms={"high": 1e-6},
                                  slo_sustain_s=0) as sched:
        pend = [sched.submit(p, max_new_tokens=budget, priority=c)
                for p, c in zip(prompts, classes)]
        go.set()
        got = [p.wait(120)["tokens"] for p in pend]
    assert catalog.PREEMPTIONS_TO_HELD.value(reason="slo") >= before + 1
    assert got == refs
    assert not eng.active.any()


# -- brownout in the scheduler and over HTTP --------------------------------

def test_brownout_level3_sheds_low_and_level2_clamps(weights, monkeypatch):
    knobs = resolve_fleet_knobs()
    with pgen.GenerationScheduler(dense(weights), queue_depth=16,
                                  default_max_new_tokens=4,
                                  brownout=pinned(3)) as sched:
        shed = catalog.REQUESTS_SHED.value(**{"class": "low"})
        with pytest.raises(OverloadedError) as ei:
            sched.submit([5, 6], priority="low")
        assert knobs["shed_retry_floor_s"] <= ei.value.retry_after <= \
            knobs["shed_retry_cap_s"]
        assert catalog.REQUESTS_SHED.value(**{"class": "low"}) == shed + 1
        assert len(sched.generate([5, 6], max_new_tokens=3,
                                  timeout=60)["tokens"]) == 3
        assert sched.brownout_level() == 3
    monkeypatch.setattr(pflags, "shed_token_cap", 3)
    eng = paged(weights)
    asked = []
    orig = eng.can_admit
    eng.can_admit = lambda prompt, budget, **kw: (
        asked.append(budget), orig(prompt, budget, **kw))[1]
    with pgen.GenerationScheduler(eng, queue_depth=8,
                                  brownout=pinned(2)) as sched:
        a = sched.submit([5, 6], max_new_tokens=20, priority="low")
        b = sched.submit([7, 8], max_new_tokens=20)
        assert len(a.wait(60)["tokens"]) == len(b.wait(60)["tokens"]) == 3
    # the clamp came before the page gate
    assert all(budget <= 3 for budget in asked)


def _post(url, body, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers=dict({"Content-Type": "application/json"}, **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def test_http_sheds_low_priority_with_retry_after_and_reads_the_tenant(
        weights):
    sched = pgen.GenerationScheduler(
        paged(weights), queue_depth=8, brownout=pinned(3),
        tenant_token_budget_map={"capped": 1000})
    server = make_server(None, generator=sched, port=0).start_background()
    url = server.url
    try:
        shed = catalog.REQUESTS_SHED.value(**{"class": "low"})
        code, headers, body = _post(url + "/v1/generate",
                                    {"prompt": [4, 5], "priority": "low"})
        assert code == 503 and "shed" in body["error"]
        assert int(headers["Retry-After"]) >= 1
        assert catalog.REQUESTS_SHED.value(**{"class": "low"}) == shed + 1
        code, _, body = _post(url + "/v1/generate",
                              {"prompt": [4, 5], "priority": "urgent"})
        assert code == 400 and "priority" in body["error"]
        code, _, body = _post(url + "/v1/generate",
                              {"prompt": [4, 5], "max_new_tokens": 3},
                              headers={"X-Tenant-Id": "capped"})
        assert code == 200 and len(body["tokens"]) == 3
        assert sched._tenant_used.get("capped") == 3
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            assert json.loads(r.read())["brownout_level"] == 3
        with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
            text = r.read().decode()
        for line in ("paddle_tpu_brownout_level 3",
                     "paddle_tpu_generation_held_requests 0",
                     'paddle_tpu_requests_shed_total{class="low"}'):
            assert line in text, line
    finally:
        assert server.shutdown_gracefully(60)["drained"]


def test_serve_cli_picks_the_engine_as_the_reference_does(weights,
                                                          tmp_path):
    """Dense unless paging is asked for; a draft model implies the paged
    engine with speculative_k 4, and its greedy streams are solo."""
    pgen.save_decoder(str(tmp_path / "dec"), weights[2], weights[3])
    ref = solo(weights, np.array([4, 5, 6], np.int32), 7)
    env = dict(os.environ, PYTHONPATH=REPO)
    for extra, want in (([], "dense"),
                        (["--gen-draft-model", str(tmp_path / "dec"),
                          "--tenant-token-budget", "100"],
                         "speculative_k=4")):
        proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.serving.serve",
             "--generation-model", str(tmp_path / "dec"), "--device", "cpu",
             "--port", "0", "--gen-max-slots", "2", "--gen-max-len",
             str(MAX_LEN), "--gen-prefill-buckets", "8,16"] + extra,
            cwd=str(tmp_path), env=env, stderr=subprocess.PIPE, text=True)
        try:
            line = proc.stderr.readline()
            assert line.startswith("serve: http://") and want in line, line
            url = line.split()[1]
            code, _, body = _post(url + "/v1/generate",
                                  {"prompt": [4, 5, 6], "max_new_tokens": 7},
                                  headers={"X-Tenant-Id": "t1"})
            assert code == 200 and body["tokens"] == ref
            if extra:
                assert body["slo"]["spec_rounds"] >= 1
            with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
                doc = json.loads(r.read())
            assert doc["serving"]["paged"] == bool(extra)
            assert doc["brownout_level"] == 0
        finally:
            proc.terminate()
            proc.wait(60)
            proc.stderr.close()
