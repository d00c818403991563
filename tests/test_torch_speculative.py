"""Speculative decoding and the dense engine in the port against the JAX
reference on the CPU, with one set of weights carried across from numpy
(2 layers, 64 wide, vocab 61, max_len 40, pages of 4):

- ``decode_cache_attention``, the function and the graph op, with GQA;
- the dense ``DecodeEngine``'s prefill logits and greedy streams;
- ``verify_step``'s greedy outputs on fp32 and int8 pools, for chunks
  that straddle a page and chunks that run past a slot's reservation;
- ``speculative_greedy_generate`` with a good draft (the target itself)
  and a bad one (other weights) at k in {1, 2, 4} on fp32 and int8 pools:
  equal to the reference's streams and to plain ``greedy_generate``;
- the accept/reject counters; the scheduler's speculative rounds beside a
  sampled co-rider; a draft engine forcing megastep K to 1; brownout
  level 1 turning speculation off.

Tolerances: attention outputs and logits in fp32 within 1e-5 absolute +
1e-5 relative (summation order only); bf16 attention within 1e-2 (two
units in the last place of bf16's 8-bit mantissa); token streams exact.
"""

from tests import torch_threads  # noqa: F401  (first)
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  registers the reference lowerings
import paddle_tpu_torch  # noqa: F401  registers the port's
from paddle_tpu import registry as jreg
from paddle_tpu import serving as js
from paddle_tpu.observability import catalog as jcatalog
from paddle_tpu.ops import attention_ops as jattn
from paddle_tpu_torch import layers, registry as preg
from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.observability import catalog
from paddle_tpu_torch.ops import attention as pattn
from paddle_tpu_torch.serving import generation as pgen
from paddle_tpu_torch.serving import paged_kv as pkv

VOCAB, DIM, HEADS, LAYERS = 61, 64, 4, 2
MAX_LEN, BUCKETS, SLOTS, PAGE = 40, (8, 16), 4, 4
NEW_TOKENS = 16
FP32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=1e-2, rtol=1e-2)


def np_tree(params):
    return {k: ([{n: np.asarray(a) for n, a in b.items()} for b in v]
                if k == "blocks" else np.asarray(v))
            for k, v in params.items()}


def random_prompts(n, seed, lo=1, hi=12):
    rng = np.random.RandomState(seed)
    return [rng.randint(2, VOCAB, size=int(k)).astype(np.int32)
            for k in rng.randint(lo, hi + 1, size=n)]


@pytest.fixture(scope="module")
def weights():
    """Target and bad-draft weights in both packages:
    ``{"jm", "jp", "jbad", "pm", "pp", "pbad"}``."""
    jm = js.TransformerDecoderModel(VOCAB, dim=DIM, n_heads=HEADS,
                                    n_layers=LAYERS)
    pm = pgen.TransformerDecoderModel(VOCAB, dim=DIM, n_heads=HEADS,
                                      n_layers=LAYERS)
    jp, jbad = jm.init_params(0), jm.init_params(9)
    return {"jm": jm, "jp": jp, "jbad": jbad, "pm": pm,
            "pp": params_from_jax(np_tree(jp), device="cpu"),
            "pbad": params_from_jax(np_tree(jbad), device="cpu")}


def port_paged(w, k=0, mode="off", slots=SLOTS, **kw):
    return pkv.PagedDecodeEngine(w["pm"], w["pp"], max_slots=slots,
                                 max_len=MAX_LEN, prefill_buckets=BUCKETS,
                                 page_size=PAGE, speculative_k=k,
                                 kv_quant_dtype=mode, device="cpu", **kw)


def port_dense(w, params="pp", slots=SLOTS):
    return pgen.DecodeEngine(w["pm"], w[params], max_slots=slots,
                             max_len=MAX_LEN, prefill_buckets=BUCKETS,
                             device="cpu")


_JAX_ENGINES = {}


def jax_paged(w, k=0, mode="off", slots=SLOTS):
    """A reference paged engine, one per (pool, slots) and reused: its
    compiled bodies are what the CPU run pays for. ``speculative_k`` is
    set per use (the verify body compiles once per chunk width)."""
    key = ("paged", mode, slots)
    if key not in _JAX_ENGINES:
        _JAX_ENGINES[key] = js.PagedDecodeEngine(
            w["jm"], w["jp"], max_slots=slots, max_len=MAX_LEN,
            prefill_buckets=BUCKETS, page_size=PAGE, kv_quant_dtype=mode)
    eng = _JAX_ENGINES[key]
    eng.reset()
    eng.speculative_k = k
    return eng


def jax_dense(w, params="jp", slots=SLOTS):
    key = ("dense", params, slots)
    if key not in _JAX_ENGINES:
        _JAX_ENGINES[key] = js.DecodeEngine(
            w["jm"], w[params], max_slots=slots, max_len=MAX_LEN,
            prefill_buckets=BUCKETS)
    _JAX_ENGINES[key].reset()
    return _JAX_ENGINES[key]


# -- decode_cache_attention --------------------------------------------------

@pytest.mark.parametrize("kv_heads", [4, 2, 1])
@pytest.mark.parametrize("bf16", [False, True])
def test_decode_cache_attention_matches_the_reference(kv_heads, bf16):
    rng = np.random.RandomState(kv_heads)
    S, T, H, D = 3, 12, 4, 16
    q = rng.randn(S, H, D).astype(np.float32)
    kc = rng.randn(S, T, kv_heads, D).astype(np.float32)
    vc = rng.randn(S, T, kv_heads, D).astype(np.float32)
    lens = np.array([1, 7, T], np.int32)
    jt = (lambda a: jnp.asarray(a, jnp.bfloat16)) if bf16 else jnp.asarray
    pt = (lambda a: torch.from_numpy(a).to(torch.bfloat16)) if bf16 \
        else torch.from_numpy
    tol = BF16 if bf16 else FP32
    ref = jattn.decode_cache_attention(jt(q), jt(kc), jt(vc),
                                       jnp.asarray(lens))
    got = pattn.decode_cache_attention(pt(q), pt(kc), pt(vc),
                                       torch.from_numpy(lens))
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), **tol)
    # the graph op, through each package's registry (scale attr set)
    ins_j = {"Q": [jt(q)], "KCache": [jt(kc)], "VCache": [jt(vc)],
             "CacheLengths": [jnp.asarray(lens)]}
    ins_p = {"Q": [pt(q)], "KCache": [pt(kc)], "VCache": [pt(vc)],
             "CacheLengths": [torch.from_numpy(lens)]}
    op = types.SimpleNamespace(type="decode_cache_attention",
                               attrs={"scale": 0.3}, op_uid=1, inputs={},
                               outputs={}, forward_op=None)
    ref_op = jreg.get_op_info("decode_cache_attention").lowering(
        jreg.LoweringContext(op, step_key=None), ins_j)["Out"][0]
    got_op = preg.get_op_info("decode_cache_attention").lowering(
        preg.LoweringContext(op, step_key=(0, 0)), ins_p)["Out"][0]
    np.testing.assert_allclose(got_op.float().numpy(),
                               np.asarray(ref_op, np.float32), **tol)
    assert preg.get_op_info("decode_cache_attention").no_grad


def test_decode_cache_attention_layer_runs_the_op():
    """``layers.decode_cache_attention`` appends the op, and a program of
    it run by the port's Executor on the CPU gives the function's
    output."""
    import paddle_tpu_torch as fluid
    rng = np.random.RandomState(0)
    feed = {"q": rng.randn(3, 4, 16).astype(np.float32),
            "kc": rng.randn(3, 12, 2, 16).astype(np.float32),
            "vc": rng.randn(3, 12, 2, 16).astype(np.float32),
            "ln": np.array([[1], [5], [12]], np.int32)}
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        q = layers.data("q", shape=[4, 16], dtype="float32")
        kc = layers.data("kc", shape=[12, 2, 16], dtype="float32")
        vc = layers.data("vc", shape=[12, 2, 16], dtype="float32")
        ln = layers.data("ln", shape=[1], dtype="int32")
        out = layers.decode_cache_attention(q, kc, vc, ln, scale=0.5)
    op = main.global_block().ops[-1]
    assert op.type == "decode_cache_attention" and op.attr("scale") == 0.5
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    got, = exe.run(main, feed=feed, fetch_list=[out])
    want = pattn.decode_cache_attention(
        *(torch.from_numpy(feed[n]) for n in ("q", "kc", "vc", "ln")),
        scale=0.5)
    np.testing.assert_allclose(np.asarray(got), want.numpy(), **FP32)


# -- the dense engine --------------------------------------------------------

def test_dense_prefill_logits_and_greedy_streams_match_the_reference(
        weights):
    w = weights
    prompts = random_prompts(SLOTS, seed=3)
    je, pe = jax_dense(w), port_dense(w)
    for i, p in enumerate(prompts):
        np.testing.assert_allclose(pe.prefill(i, p),
                                   np.asarray(je.prefill(i, p)), **FP32)
        je.release(i)
        pe.release(i)
    ref = js.greedy_generate(je, prompts, NEW_TOKENS, eos_id=1)
    got = pgen.greedy_generate(pe, prompts, NEW_TOKENS, eos_id=1)
    assert got == ref
    # the dense and the paged engine decode the same streams, and so does
    # full recompute
    assert pgen.greedy_generate(port_paged(w), prompts, NEW_TOKENS,
                                eos_id=1) == ref
    assert pgen.full_recompute_generate(w["pm"], w["pp"], prompts,
                                        NEW_TOKENS, eos_id=1,
                                        max_len=MAX_LEN) == ref
    assert not pe.active.any() and pe.lengths.sum() == 0


def test_dense_engine_rewinds_by_lengths_alone(weights):
    """A rewound slot's stale rows past its length are masked: decoding on
    from a rewound length gives what a fresh engine gives there."""
    w = weights
    p = random_prompts(1, seed=5, lo=6, hi=6)[0]
    a, b = port_dense(w, slots=1), port_dense(w, slots=1)
    for e in (a, b):
        e.set_input_token(0, int(np.argmax(e.prefill(0, p))))
    for _ in range(5):
        a.decode_step()       # five rows past the prompt, then rewind 3
    a.lengths[0] -= 3
    b.decode_step()
    b.decode_step()
    a.set_input_token(0, int(b._in_tokens[0]))
    assert a.lengths[0] == b.lengths[0]
    assert int(a.decode_step()[0]) == int(b.decode_step()[0])


# -- verify_step -------------------------------------------------------------

@pytest.mark.parametrize("mode", ["off", "int8"])
def test_verify_step_matches_the_reference(weights, mode):
    """Prompts of 3..9 tokens put the frontier at every page offset, so a
    4-token chunk straddles a page; slot 3's budget of 2 puts its chunk
    past the reservation (those positions write scratch)."""
    w = weights
    T = 4
    prompts = [np.arange(2, 2 + n, dtype=np.int32) + s
               for s, n in enumerate((3, 5, 6, 9))]
    budgets = [12, 12, 12, 2]
    je, pe = jax_paged(w, T, mode), port_paged(w, T, mode)
    for s, (p, b) in enumerate(zip(prompts, budgets)):
        for e in (je, pe):
            e.set_input_token(s, int(np.argmax(
                np.asarray(e.prefill(s, p, max_new_tokens=b)))))
    rng = np.random.RandomState(1)
    for _ in range(2):
        chunk = rng.randint(2, VOCAB, size=(SLOTS, T)).astype(np.int32)
        chunk[:, 0] = pe._in_tokens
        ref = np.asarray(je.verify_step(chunk))
        got = pe.verify_step(chunk)
        assert got.dtype == np.int32 and got.shape == (SLOTS, T)
        # column j is defined while its position lies in the reservation
        # (past it the chunk writes scratch and reads garbage)
        valid = pe.lengths[:, None] + np.arange(T)[None, :] < \
            pe._reserved[:, None]
        assert not valid.all() and valid[:, 0].all()
        np.testing.assert_array_equal(got[valid], ref[valid])
        # commit a ragged accepted prefix in both, then verify again
        for s in range(SLOTS):
            m = min(1 + s % 3, int(pe._reserved[s] - pe.lengths[s]))
            for e in (je, pe):
                e.commit_tokens(s, m, int(ref[s, m - 1]))
    # a plain decode step after the verifies reads the pages they wrote
    for e in (je, pe):
        e.release(3)          # at its reservation
    np.testing.assert_array_equal(
        pe.decode_step()[:3],
        np.asarray(je.decode_step(jax.random.PRNGKey(0)))[:3])


def test_verify_step_validates_its_chunk(weights):
    pe = port_paged(weights, 2)
    with pytest.raises(RuntimeError, match="no active slots"):
        pe.verify_step(np.zeros((SLOTS, 2), np.int32))
    with pytest.raises(ValueError, match=r"\[max_slots, T\]"):
        pe.verify_step(np.zeros((SLOTS + 1, 2), np.int32))


# -- speculative_greedy_generate -------------------------------------------

CASES = [(k, draft, mode) for mode in ("off", "int8") for k in (1, 2, 4)
         for draft in ("good", "bad")]


@pytest.fixture(scope="module")
def reference_streams(weights):
    """The reference's speculative streams for every case, and its plain
    greedy streams per pool: one JAX paged engine per (k, pool), two
    dense drafts, all reused across runs."""
    w = weights
    prompts = random_prompts(SLOTS, seed=11)
    drafts = {"good": jax_dense(w), "bad": jax_dense(w, "jbad")}
    out = {"prompts": prompts}
    for mode in ("off", "int8"):
        out[mode] = js.greedy_generate(jax_paged(w, 0, mode), prompts,
                                       NEW_TOKENS, eos_id=1)
        for k in (1, 2, 4):
            for draft in ("good", "bad"):
                out[(k, draft, mode)] = js.speculative_greedy_generate(
                    jax_paged(w, k, mode), drafts[draft], prompts,
                    NEW_TOKENS, eos_id=1)
    return out


@pytest.mark.parametrize("k,draft,mode", CASES)
def test_speculative_streams_match_the_reference_and_plain_greedy(
        weights, reference_streams, k, draft, mode):
    w = weights
    prompts = reference_streams["prompts"]
    eng = port_paged(w, k, mode)
    got = pkv.speculative_greedy_generate(
        eng, port_dense(w, "pp" if draft == "good" else "pbad"), prompts,
        NEW_TOKENS, eos_id=1)
    assert got == reference_streams[(k, draft, mode)]
    plain = pgen.greedy_generate(port_paged(w, 0, mode), prompts,
                                 NEW_TOKENS, eos_id=1)
    assert got == plain == reference_streams[mode]
    assert not eng.active.any() and eng.pool.free_pages() + \
        len(eng.prefix_cache) == eng.num_pages


COUNTERS = {"drafted": catalog.SPECULATIVE_DRAFTED,
            "accepted": catalog.SPECULATIVE_ACCEPTED,
            "j_drafted": jcatalog.SPECULATIVE_DRAFTED,
            "j_accepted": jcatalog.SPECULATIVE_ACCEPTED}


def test_accept_reject_counters(weights):
    """Budget 13 = the prefill token and 4 whole k=3 rounds, so no round
    is budget-truncated: the self-draft accepts every proposal; the bad
    draft fewer; each exactly as many as the reference's."""
    w = weights
    prompts = random_prompts(2, seed=6, lo=4, hi=8)
    counts = {}
    for draft in ("good", "bad"):
        before = {n: c.value() for n, c in COUNTERS.items()}
        pkv.speculative_greedy_generate(
            port_paged(w, 3, slots=2),
            port_dense(w, "pp" if draft == "good" else "pbad", slots=2),
            prompts, 13)
        js.speculative_greedy_generate(
            jax_paged(w, 3, slots=2),
            jax_dense(w, "jp" if draft == "good" else "jbad", slots=2),
            prompts, 13)
        counts[draft] = {n: c.value() - before[n]
                         for n, c in COUNTERS.items()}
    good, bad = counts["good"], counts["bad"]
    assert good["drafted"] == 2 * 4 * 3 and good["accepted"] == \
        good["drafted"]
    assert bad["accepted"] < bad["drafted"]
    for c in (good, bad):
        assert (c["drafted"], c["accepted"]) == (c["j_drafted"],
                                                 c["j_accepted"])


# -- the scheduler -----------------------------------------------------------

def test_scheduler_speculative_rounds_match_solo_greedy(weights):
    """Continuous batching with ragged accepts and EOS finishes emits the
    solo streams; a sampled co-rider falls the batch back to synced plain
    steps (counted by reason) without corrupting later greedy traffic."""
    w = weights
    prompts = random_prompts(2 * SLOTS, seed=7, lo=2, hi=8)
    solo = pgen.DecodeEngine(w["pm"], w["pp"], max_slots=1, max_len=MAX_LEN,
                             prefill_buckets=BUCKETS, device="cpu")
    refs = [pgen.greedy_generate(solo, [p], 12, eos_id=1)[0]
            for p in prompts]
    eng = port_paged(w, 3)
    drafted = catalog.SPECULATIVE_DRAFTED.value()
    sampled = catalog.SPECULATIVE_FALLBACK.value(reason="sampled")
    with pgen.GenerationScheduler(eng, eos_id=1, queue_depth=64,
                                  default_max_new_tokens=12,
                                  draft_engine=port_dense(w, "pbad")) as s:
        res = [p.wait(120) for p in [s.submit(p) for p in prompts]]
        assert [r["tokens"] for r in res] == refs
        assert any(r["slo"].get("spec_rounds", 0) > 0 for r in res)
        slow = s.submit(prompts[0], temperature=0.7, max_new_tokens=12)
        fast = s.submit(prompts[1])
        assert 1 <= len(slow.wait(120)["tokens"]) <= 12
        assert fast.wait(120)["tokens"] == refs[1]
        assert s.generate(prompts[2], timeout=120)["tokens"] == refs[2]
    assert catalog.SPECULATIVE_DRAFTED.value() > drafted
    assert catalog.SPECULATIVE_FALLBACK.value(reason="sampled") > sampled


def test_draft_engine_forces_megastep_k_to_one(weights):
    w = weights
    eng = port_paged(w, 2, megastep_k=8)
    assert eng.megastep_k == 8
    with pgen.GenerationScheduler(eng, draft_engine=port_dense(w)) as s:
        assert s._megastep_k == 1
        assert s.generate([5, 6, 7], max_new_tokens=9, timeout=60)
    assert eng.trip_stats["megasteps"] == 0
    with pgen.GenerationScheduler(port_paged(w, 0, megastep_k=8)) as s:
        assert s._megastep_k == 8


def test_speculation_requires_a_draft_of_the_same_geometry(weights):
    w = weights
    with pytest.raises(ValueError, match="FLAGS_speculative_k"):
        pgen.GenerationScheduler(port_paged(w, 2))
    with pytest.raises(ValueError, match="geometry"):
        pgen.GenerationScheduler(port_paged(w, 2),
                                 draft_engine=port_dense(w, slots=SLOTS + 1))
    with pytest.raises(ValueError, match="speculative_k=0"):
        pgen.GenerationScheduler(port_paged(w, 0),
                                 draft_engine=port_dense(w))


def test_brownout_level1_turns_speculation_off(weights):
    w = weights
    # pinned at level 1: no observation can move it within the dwell
    bc = pgen.BrownoutController(high=0.99, low=0.0, dwell_s=3600.0)
    bc._level, bc._last_change = 1, time.monotonic()
    ref = pgen.greedy_generate(port_dense(w, slots=1), [[7, 8, 9]], 6)[0]
    drafted = catalog.SPECULATIVE_DRAFTED.value()
    off = catalog.SPECULATIVE_FALLBACK.value(reason="brownout")
    with pgen.GenerationScheduler(port_paged(w, 3), brownout=bc,
                                  draft_engine=port_dense(w)) as s:
        got = s.generate([7, 8, 9], max_new_tokens=6, timeout=60)
    assert got["tokens"] == ref
    assert catalog.SPECULATIVE_DRAFTED.value() == drafted
    assert catalog.SPECULATIVE_FALLBACK.value(reason="brownout") > off


@pytest.mark.parametrize("kw", [{"speculative_k": -1},
                                {"max_len": 8, "prefill_buckets": "4",
                                 "speculative_k": 7}])
def test_speculative_knob_errors_name_the_flag_as_the_reference_does(kw):
    with pytest.raises(ValueError, match="FLAGS_speculative_k") as ref:
        js.resolve_generation_knobs(paged=True, **kw)
    with pytest.raises(ValueError, match="FLAGS_speculative_k") as got:
        pgen.resolve_generation_knobs(paged=True, **kw)
    assert str(got.value) == str(ref.value)
    assert pgen.resolve_generation_knobs(paged=True, speculative_k=3)[5] \
        == js.resolve_generation_knobs(paged=True, speculative_k=3)[5] == 3
