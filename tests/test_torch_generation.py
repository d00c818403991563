"""The port's decoder, paged engine and on-disk form against the JAX
reference on the CPU (sizes of tests/serving/test_paged_generation.py):
the same weights — carried by ``params_from_jax``, by ``load_decoder`` on
a directory the JAX ``save_decoder`` wrote, or drawn by the port's own
``init_params`` from the same seed — give the same prefill and decode
logits (fp32, atol 1e-4) and identical greedy token streams, including a
prefix-cache hit. Also: page accounting, failure plumbing, the default
device rule and import hygiene."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import serving as jserving
from paddle_tpu_torch import profiler
from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.observability import catalog
from paddle_tpu_torch.serving import generation as pgen
from paddle_tpu_torch.serving import paged_kv as pkv

VOCAB, DIM, HEADS, LAYERS = 61, 16, 2, 2
MAX_LEN, BUCKETS, SLOTS, PAGE = 32, (4, 8), 4, 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_pair(seed=0):
    model = jserving.TransformerDecoderModel(VOCAB, dim=DIM, n_heads=HEADS,
                                             n_layers=LAYERS)
    return model, model.init_params(seed)


def port_model(dtype=torch.float32):
    return pgen.TransformerDecoderModel(VOCAB, dim=DIM, n_heads=HEADS,
                                        n_layers=LAYERS, dtype=dtype)


def np_tree(params):
    return {k: ([{n: np.asarray(a) for n, a in b.items()} for b in v]
                if k == "blocks" else np.asarray(v))
            for k, v in params.items()}


def port_engine(model, params, **kw):
    kw.setdefault("max_slots", SLOTS)
    return pkv.PagedDecodeEngine(model, params, max_len=MAX_LEN,
                                 prefill_buckets=BUCKETS, page_size=PAGE,
                                 device="cpu", **kw)


def jax_engine(model, params):
    return jserving.PagedDecodeEngine(model, params, max_slots=SLOTS,
                                      max_len=MAX_LEN,
                                      prefill_buckets=BUCKETS,
                                      page_size=PAGE)


def random_prompts(n, seed, lo=1, hi=8):
    rng = np.random.RandomState(seed)
    return [rng.randint(2, VOCAB, size=int(k)).astype(np.int32)
            for k in rng.randint(lo, hi + 1, size=n)]


def _assert_params_equal(port, jax_params):
    ref = np_tree(jax_params)
    for key, value in ref.items():
        if key == "blocks":
            for pb, rb in zip(port["blocks"], value):
                assert set(pb) == set(rb)
                for n in rb:
                    np.testing.assert_array_equal(pb[n].numpy(), rb[n])
        else:
            np.testing.assert_array_equal(port[key].numpy(), value)


@pytest.mark.parametrize("route", ["params_from_jax", "load_decoder",
                                   "init_params"])
def test_weights_carried_across_match_the_reference(tmp_path, route):
    jm, jp = jax_pair(seed=3)
    if route == "params_from_jax":
        params = params_from_jax(np_tree(jp), device="cpu")
    elif route == "load_decoder":
        jserving.save_decoder(str(tmp_path), jm, jp)
        model, params = pgen.load_decoder(str(tmp_path), device="cpu")
        assert (model.vocab_size, model.dim, model.n_heads, model.n_layers,
                model.ffn_dim) == (VOCAB, DIM, HEADS, LAYERS, 4 * DIM)
    else:
        params = port_model().init_params(3, device="cpu")
    _assert_params_equal(params, jp)


def test_port_save_decoder_round_trips_and_loads_in_the_reference(tmp_path):
    model = port_model()
    params = model.init_params(1, device="cpu")
    pgen.save_decoder(str(tmp_path / "p"), model, params)
    _, back = pgen.load_decoder(str(tmp_path / "p"), device="cpu")
    jm, jp = jserving.load_decoder(str(tmp_path / "p"))
    _assert_params_equal(back, jp)
    _assert_params_equal(params, jp)
    # a bf16 model writes float32 arrays (exact) and names its dtype
    m16 = port_model(torch.bfloat16)
    p16 = {k: ([{n: t.to(torch.bfloat16) for n, t in b.items()} for b in v]
               if k == "blocks" else v.to(torch.bfloat16))
           for k, v in params.items()}
    pgen.save_decoder(str(tmp_path / "b"), m16, p16)
    m_b, back16 = pgen.load_decoder(str(tmp_path / "b"), device="cpu")
    assert m_b.dtype == torch.bfloat16
    assert torch.equal(back16["head"], p16["head"])
    jm16, _ = jserving.load_decoder(str(tmp_path / "b"))
    assert np.dtype(jm16.dtype).name == "bfloat16"


def test_load_decoder_reads_a_reference_bf16_directory(tmp_path):
    """The JAX save_decoder stores bf16 arrays as 2-byte void records; the
    port reads their bits back exactly."""
    jm = jserving.TransformerDecoderModel(VOCAB, dim=DIM, n_heads=HEADS,
                                          n_layers=LAYERS,
                                          dtype=jnp.bfloat16)
    jp = jm.init_params(2)
    jserving.save_decoder(str(tmp_path), jm, jp)
    model, params = pgen.load_decoder(str(tmp_path), device="cpu")
    assert model.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        params["blocks"][1]["w1"].float().numpy(),
        np.asarray(jp["blocks"][1]["w1"], np.float32))


def test_load_decoder_names_missing_parameters(tmp_path):
    model = port_model()
    params = model.init_params(0, device="cpu")
    del params["blocks"][1]["w2"]
    pgen.save_decoder(str(tmp_path), model, params)
    with pytest.raises(ValueError, match="blocks.1.w2"):
        pgen.load_decoder(str(tmp_path), device="cpu")


def test_full_forward_logits_match_the_reference():
    jm, jp = jax_pair()
    pm, pp = port_model(), params_from_jax(np_tree(jp), device="cpu")
    rng = np.random.RandomState(0)
    toks = rng.randint(0, VOCAB, size=(3, 9)).astype(np.int32)
    lens = np.array([9, 4, 1], np.int32)
    ref = np.asarray(jm.last_logits_and_kv(jp, jnp.asarray(toks),
                                           jnp.asarray(lens))[0])
    got = pm.last_logits_and_kv(pp, torch.from_numpy(toks),
                                torch.from_numpy(lens))[0].numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def _jax_step_logits(eng):
    wpids, woffs = eng._step_write_coords(eng.lengths)
    logits, _, _ = eng.model.paged_decode_logits(
        eng.params, jnp.asarray(eng._in_tokens),
        jnp.asarray(eng.lengths.astype(np.int32)), jnp.asarray(eng.active),
        jnp.asarray(wpids), jnp.asarray(woffs),
        jnp.asarray(eng._page_table), eng._kp, eng._vp)
    return np.asarray(logits)


def _port_step_logits(eng):
    wpids, woffs = eng._step_write_coords(eng.lengths)
    with torch.no_grad():
        logits = eng.model.paged_decode_logits(
            eng.params, eng._tensor(eng._in_tokens),
            eng._tensor(eng.lengths), eng._tensor(eng.active),
            eng._tensor(wpids), eng._tensor(woffs),
            eng._tensor(eng._page_table), eng._kp, eng._vp)
    return logits.numpy()


def test_paged_prefill_and_decode_logits_match_the_reference():
    """Prefill logits, then the decode-step logits over several steps,
    with both engines fed the same tokens (fp32, atol 1e-4)."""
    jm, jp = jax_pair()
    je = jax_engine(jm, jp)
    pe = port_engine(port_model(), params_from_jax(np_tree(jp),
                                                   device="cpu"))
    prompts = random_prompts(3, seed=4, lo=2, hi=8)
    for i, p in enumerate(prompts):
        ref = je.prefill(i, p, max_new_tokens=6)
        got = pe.prefill(i, p, max_new_tokens=6)
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
        tok = int(np.argmax(ref))
        je.set_input_token(i, tok)
        pe.set_input_token(i, tok)
    np.testing.assert_array_equal(pe._page_table, je._page_table)
    for _ in range(5):
        ref = _jax_step_logits(je)
        got = _port_step_logits(pe)
        live = je.active
        np.testing.assert_allclose(got[live], ref[live], atol=1e-4, rtol=0)
        jt = je.decode_step(jax.random.PRNGKey(0))
        pt = pe.decode_step()
        np.testing.assert_array_equal(pt[live], np.asarray(jt)[live])
        np.testing.assert_array_equal(pe.lengths, je.lengths)


def test_greedy_streams_identical_to_reference_and_full_recompute():
    """The slice as a whole on the CPU: the port's paged engine, the JAX
    paged engine and the port's full recompute emit the same greedy
    tokens; prompts sharing a one-page prefix map the cached page, in
    the first pass and again in a second, and still emit the same
    tokens."""
    jm, jp = jax_pair()
    pm, pp = port_model(), params_from_jax(np_tree(jp), device="cpu")
    rng = np.random.RandomState(5)
    shared = rng.randint(2, VOCAB, size=PAGE).astype(np.int32)
    prompts = [np.concatenate([shared, rng.randint(
        2, VOCAB, size=k).astype(np.int32)]) for k in (0, 1, 3, 4)]
    budgets = [6, 9, 4, 12]
    ref = jserving.greedy_generate(jax_engine(jm, jp), prompts, budgets)
    profiler.reset_counters()
    pe = port_engine(pm, pp)
    first = pgen.greedy_generate(pe, prompts, budgets)
    assert catalog.PREFIX_CACHE_HITS.value() > 0   # later prompts share
    hits = catalog.PREFIX_CACHE_HITS.value()
    again = pgen.greedy_generate(pe, prompts, budgets)
    assert catalog.PREFIX_CACHE_HITS.value() > hits
    recompute = pgen.full_recompute_generate(pm, pp, prompts, budgets,
                                             max_len=MAX_LEN)
    assert first == ref
    assert again == ref
    assert recompute == ref
    assert pe.pages_in_use() == len(pe.prefix_cache)   # only the cache


def test_page_pool_and_prefix_cache_refcounts():
    pool = pkv.PagePool(6)
    cache = pkv.PrefixCache(pool, page_size=2, capacity=4)
    prompt = np.arange(7, dtype=np.int32)
    pids = pool.alloc(4)
    cache.insert(prompt, 7, pids)           # 3 full pages cached
    assert len(cache) == 3 and list(pool.refs[pids]) == [2, 2, 2, 1]
    keys, hit = cache.match(prompt, 3)
    assert hit == pids[:3]
    cache.acquire(keys, hit)
    assert list(pool.refs[pids[:3]]) == [3, 3, 3]
    pool.decref(hit)
    pool.decref(pids)                        # both slots released
    assert pool.free_pages() == 3 and cache.evictable() == 3
    assert cache.evictable(protect=keys[:1]) == 2
    assert cache.evict_for(2) == 2
    assert pool.free_pages() == 5 and len(cache) == 1
    with pytest.raises(pkv.PoolExhaustedError):
        pool.alloc(6)


def test_admission_accounting_credits_the_cached_prefix():
    pm = port_model()
    pe = port_engine(pm, pm.init_params(0, device="cpu"), num_pages=10)
    prompt = np.arange(2, 10, dtype=np.int32)       # 8 tokens
    other = np.arange(30, 38, dtype=np.int32)
    assert pe.fits_ever(8, 20) and pe.can_admit(prompt, 20)
    pe.prefill(0, prompt, max_new_tokens=20)        # 7 pages reserved
    assert pe.pages_in_use() == 7
    assert not pe.can_admit(other, 20)
    # the same prompt maps its cached first page: needs 6, 3 are free
    assert not pe.can_admit(prompt, 20)
    assert pe.can_admit(prompt, 1)
    snap = pe.admission_state()
    assert pe.can_admit(prompt, 1, snapshot=snap) == pe.can_admit(prompt, 1)
    pe.release(0)
    assert pe.can_admit(other, 20)


def test_failed_step_marks_the_engine_dead_until_reset(monkeypatch):
    pm = port_model()
    pe = port_engine(pm, pm.init_params(0, device="cpu"))
    pe.prefill(0, np.array([3, 4, 5], np.int32), max_new_tokens=4)

    def boom(*a, **k):
        raise RuntimeError("device fault")
    monkeypatch.setattr(pm, "paged_decode_logits", boom)
    with pytest.raises(pgen.DeviceStateError, match="device fault"):
        pe.decode_step()
    with pytest.raises(pgen.DeviceStateError):
        pe.prefill(1, np.array([3], np.int32))
    monkeypatch.undo()
    pe.reset()
    assert not pe.active.any() and pe.pages_in_use() == 0
    pe.prefill(0, np.array([3, 4, 5], np.int32), max_new_tokens=4)
    assert pe.decode_step().shape == (SLOTS,)


def test_prefill_validates_before_allocating():
    pm = port_model()
    pe = port_engine(pm, pm.init_params(0, device="cpu"))
    with pytest.raises(ValueError, match="largest usable prefill bucket"):
        pe.prefill(0, np.arange(2, 12, dtype=np.int32))
    with pytest.raises(ValueError, match="token ids"):
        pe.prefill(0, np.array([VOCAB], np.int32))
    assert pe.pages_in_use() == 0


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pm = port_model()
    params = pm.init_params(0, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        pkv.PagedDecodeEngine(pm, params, max_slots=2, max_len=MAX_LEN,
                              prefill_buckets=BUCKETS, page_size=PAGE)
    with pytest.raises(RuntimeError, match="cuda"):
        pm.init_params(0)


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port, and chip_smoke.py, imported in a fresh
    interpreter, leaves no jax and no paddle_tpu module loaded."""
    code = (
        "import pkgutil, sys, importlib\n"
        "import paddle_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,\n"
        "                               'paddle_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'paddle_tpu'))\n"
        "n = sum(m.startswith('paddle_tpu_torch') for m in sys.modules)\n"
        "print(n, bad)\n"
        "sys.exit(1 if bad or n < 15 else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
