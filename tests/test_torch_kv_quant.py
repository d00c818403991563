"""Quantized generation serving on the port against the JAX reference on
the CPU, at the reference's probe size (tests/serving/test_kv_quant.py:
vocab 61, dim 32, 2 heads, 2 layers, page 4):

* the knobs, ``KVQuantConfig`` and ``equal_memory_pages`` — the same
  values and errors naming the same flags;
* ``paged_quant_append``, ``dequant_pages`` and ``quantize_weight`` —
  BITWISE equal for int8 and fp8 at group = page and a sub-page group,
  including the monotone-scale contract;
* K3-quant's plain version against the reference's Pallas kernel in
  interpret mode and its gather lowering (rtol 1e-4, atol 1e-5: fp32,
  summation order only);
* port and JAX engines with int8/fp8 pages from the same weights: prefill
  logits within 1e-5 relative, identical greedy streams; the token-match
  guard against the unquantized engine and the 1.9x equal-memory
  admission bar;
* weight-quantized directories written by either package load in the
  other with the same logits.

The CUDA kernel is held against the same plain version on the card by
chip_smoke.py.
"""

import functools
import json
import os
import signal
import subprocess
import sys
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import serving as jserving
from paddle_tpu.ops import kv_quant as jq
from paddle_tpu.ops import pallas_paged_attention as ppa
from paddle_tpu.ops.attention_ops import decode_paged_attention
from paddle_tpu_torch import flags as pflags
from paddle_tpu_torch import profiler
from paddle_tpu_torch.convert import params_from_jax
from paddle_tpu_torch.observability import catalog
from paddle_tpu_torch.ops import kv_quant as pq
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch.serving import generation as pgen
from paddle_tpu_torch.serving import paged_kv as pkv

TOKEN_MATCH_MIN = 0.95          # the reference's documented guard
VOCAB, DIM, HEADS, LAYERS = 61, 32, 2, 2
MAX_LEN, BUCKETS, SLOTS, PAGE = 64, (8, 16), 4, 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _bytes(x):
    """Raw bytes of a JAX array or tensor, for bitwise comparisons."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy() \
            if x.element_size() == 1 else x.numpy()
    a = np.asarray(x)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a


@pytest.fixture(scope="module")
def jax_model_params():
    model = jserving.TransformerDecoderModel(VOCAB, dim=DIM, n_heads=HEADS,
                                             n_layers=LAYERS)
    return model, model.init_params(0)


def np_tree(params):
    def leaf(v):
        if isinstance(v, dict):
            return {k: np.asarray(a) for k, a in v.items()}
        return np.asarray(v)
    return {k: ([{n: leaf(a) for n, a in b.items()} for b in v]
                if k == "blocks" else leaf(v)) for k, v in params.items()}


def port_pair(jax_params):
    model = pgen.TransformerDecoderModel(VOCAB, dim=DIM, n_heads=HEADS,
                                         n_layers=LAYERS)
    return model, params_from_jax(np_tree(jax_params), device="cpu")


def port_engine(model, params, mode="int8", group=None, **kw):
    kw.setdefault("max_slots", SLOTS)
    return pkv.PagedDecodeEngine(model, params, max_len=MAX_LEN,
                                 prefill_buckets=BUCKETS, page_size=PAGE,
                                 kv_quant_dtype=mode, kv_quant_group=group,
                                 device="cpu", **kw)


def jax_engine(model, params, mode="int8", group=None):
    return jserving.PagedDecodeEngine(model, params, max_slots=SLOTS,
                                      max_len=MAX_LEN,
                                      prefill_buckets=BUCKETS,
                                      page_size=PAGE, kv_quant_dtype=mode,
                                      kv_quant_group=group)


def random_prompts(n, seed, lo=2, hi=16):
    rng = np.random.RandomState(seed)
    return [rng.randint(2, VOCAB, size=int(k)).astype(np.int32)
            for k in rng.randint(lo, hi + 1, size=n)]


def match_fraction(ref, got):
    m = t = 0
    for a, b in zip(ref, got):
        n = min(len(a), len(b))
        t += n
        m += sum(int(x == y) for x, y in zip(a[:n], b[:n]))
    return m / max(t, 1)


# -- knobs and geometry ------------------------------------------------------

@pytest.mark.parametrize("kw,flag", [
    ({"kv_quant_dtype": "fp4"}, "FLAGS_kv_quant_dtype"),
    ({"page_size": 4, "kv_quant_group": 3}, "FLAGS_kv_quant_group"),
    ({"kv_quant_group": -1}, "FLAGS_kv_quant_group"),
    ({"kv_quant_group": "wide"}, "FLAGS_kv_quant_group"),
])
def test_knob_errors_name_the_same_flags(kw, flag):
    with pytest.raises(ValueError, match=flag) as ref:
        jserving.resolve_generation_knobs(paged=True, **kw)
    with pytest.raises(ValueError, match=flag) as got:
        pgen.resolve_generation_knobs(paged=True, **kw)
    assert str(got.value) == str(ref.value)


def test_quant_knobs_resolve_as_the_reference_does():
    for mode in ("off", "int8", "fp8"):
        ref = jserving.resolve_generation_knobs(
            max_slots=4, max_len=64, page_size=16, kv_quant_dtype=mode,
            kv_quant_group=0, paged=True)
        got = pgen.resolve_generation_knobs(
            max_slots=4, max_len=64, page_size=16, kv_quant_dtype=mode,
            kv_quant_group=0, paged=True)
        # (.., page_size, num_pages, speculative_k, kv_quant_dtype,
        # kv_quant_group, megastep_k)
        assert got[3:] == ref[3:]
    assert got[4] == 2 * 16          # the auto-sized pool doubles


@pytest.mark.parametrize("mode,group", [("int8", 0), ("int8", 4),
                                        ("fp8", 8), ("fp8", 16)])
def test_quant_config_and_equal_memory_pages_match(mode, group):
    ref, got = jq.KVQuantConfig(mode, 16, group), \
        pq.KVQuantConfig(mode, 16, group)
    for attr in ("mode", "page_size", "group", "groups_per_page", "qmax"):
        assert getattr(got, attr) == getattr(ref, attr)
    assert got.scale_shape(65, 2) == ref.scale_shape(65, 2)
    assert got.page_bytes(8, 64) == ref.page_bytes(8, 64)
    assert got.describe() == ref.describe()
    assert got.storage_dtype == pq.storage_dtype(mode)
    assert str(got.storage_dtype).split(".")[-1] == \
        np.dtype(ref.storage_dtype).name
    for dense in (64, 2048):
        assert pq.equal_memory_pages(dense, 16, 8, 64, got) == \
            jq.equal_memory_pages(dense, 16, 8, 64, ref)
    for bad in (("int4", 16, 0), ("int8", 16, 3)):
        with pytest.raises(ValueError) as r:
            jq.KVQuantConfig(*bad)
        with pytest.raises(ValueError) as g:
            pq.KVQuantConfig(*bad)
        assert str(g.value) == str(r.value)


# -- append, dequant and weight quantizer: bitwise --------------------------

def _windows(rng, S, W, T, P, page, scratch):
    """A decode- or prefill-like write window per slot: W - 1 distinct
    pages of the slot plus the scratch page; chunk positions write
    distinct (page, offset) pairs, padded ones go to the scratch column."""
    perm = rng.permutation(P)[:S * (W - 1)].reshape(S, W - 1)
    win = np.concatenate([perm, np.full((S, 1), scratch)], 1)
    w_idx = np.zeros((S, T), np.int64)
    offs = np.zeros((S, T), np.int64)
    for s in range(S):
        cells = rng.permutation((W - 1) * page)[:T]
        pad = rng.rand(T) < 0.25
        w_idx[s] = np.where(pad, W - 1, cells // page)
        offs[s] = np.where(pad, 0, cells % page)
    return win.astype(np.int64), w_idx, offs


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("group", [PAGE, 2])
def test_paged_quant_append_and_dequant_are_bitwise_the_reference(mode,
                                                                  group):
    """Repeated appends into one pool (values of growing and shrinking
    magnitude, so scales grow on some appends and not others): every page
    but scratch and every scale equal the reference's bit for bit."""
    rng = np.random.RandomState(11)
    P, H, D, S, W, T = 23, 2, 8, 3, 3, 6
    ref_cfg = jq.KVQuantConfig(mode, PAGE, group)
    cfg = pq.KVQuantConfig(mode, PAGE, group)
    jpool = jnp.zeros((P + 1, PAGE, H, D), ref_cfg.storage_dtype)
    jsc = jnp.zeros(ref_cfg.scale_shape(P + 1, H), jnp.float32)
    pool = torch.zeros((P + 1, PAGE, H, D), dtype=cfg.storage_dtype)
    sc = torch.zeros(cfg.scale_shape(P + 1, H))
    for step in range(8):
        win, w_idx, offs = _windows(rng, S, W, T, P, PAGE, P)
        vals = (rng.randn(S, T, H, D) * [0.3, 3.0, 1.0, 40.0][step % 4]) \
            .astype(np.float32)
        jpool, jsc = jq.paged_quant_append(
            jpool, jsc, jnp.asarray(win, jnp.int32),
            jnp.asarray(w_idx, jnp.int32), jnp.asarray(offs, jnp.int32),
            jnp.asarray(vals), ref_cfg)
        rows, new = pq.paged_quant_append(pool, sc, _t(win), _t(w_idx),
                                          _t(offs), _t(vals), cfg)
        pq.write_window(pool, sc, _t(win), rows, new)
        np.testing.assert_array_equal(_bytes(pool)[:P], _bytes(jpool)[:P])
        np.testing.assert_array_equal(sc.numpy()[:P], np.asarray(jsc)[:P])
        assert torch.isfinite(pq.dequant_pages(pool, sc, cfg)).all()
    pids = rng.randint(0, P, size=(2, 5))
    ref = np.asarray(jq.dequant_pages(jpool[pids], jsc[pids], ref_cfg))
    got = pq.dequant_pages(pq.gather_rows(pool, _t(pids).long()),
                           sc[_t(pids).long()], cfg)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_monotone_scale_contract_matches_the_reference(mode):
    """(a) one quantization stays within half a scale step (int8) or
    e4m3's relative step (fp8); (b) a smaller second append leaves the
    scale and the first token's bytes unchanged; (c) an untouched window
    page round-trips bitwise — and each state equals the reference's."""
    ref_cfg, cfg = jq.KVQuantConfig(mode, 4), pq.KVQuantConfig(mode, 4)
    jpool = jnp.zeros((6, 4, 2, 8), ref_cfg.storage_dtype)
    jsc = jnp.zeros((6, 1, 2), jnp.float32)
    pool = torch.zeros((6, 4, 2, 8), dtype=cfg.storage_dtype)
    sc = torch.zeros((6, 1, 2))
    vals = np.random.RandomState(0).randn(1, 1, 2, 8).astype(np.float32)
    win = np.array([[2, 5]])
    w_idx = np.zeros((1, 1), np.int64)
    before5 = _bytes(pool[5]).copy()

    def append(offs, v):
        nonlocal jpool, jsc
        jpool, jsc = jq.paged_quant_append(
            jpool, jsc, jnp.asarray(win, jnp.int32),
            jnp.asarray(w_idx, jnp.int32), jnp.asarray(offs, jnp.int32),
            jnp.asarray(v), ref_cfg)
        rows, new = pq.paged_quant_append(pool, sc, _t(win), _t(w_idx),
                                          _t(offs), _t(v), cfg)
        pq.write_window(pool, sc, _t(win), rows, new)
        np.testing.assert_array_equal(_bytes(pool), _bytes(jpool))
        np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc))

    append(np.zeros((1, 1), np.int64), vals)
    deq = pq.dequant_pages(pool[2], sc[2], cfg).numpy()
    s = float(sc[2].max())
    assert s > 0
    tol = s / 2 + 1e-7 if mode == "int8" else \
        np.abs(vals).max() * 2.0 ** -4 + 1e-7
    np.testing.assert_allclose(deq[0], vals[0, 0], atol=tol)      # (a)
    np.testing.assert_array_equal(_bytes(pool[5]), before5)      # (c)
    assert float(sc[5].max()) == 0.0
    tok0, scale0 = _bytes(pool[2][0]).copy(), sc[2].clone()
    append(np.ones((1, 1), np.int64), vals * 0.1)
    assert torch.equal(sc[2], scale0)                             # (b)
    np.testing.assert_array_equal(_bytes(pool[2][0]), tok0)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_quantize_weight_is_bitwise_the_reference(mode):
    rng = np.random.RandomState(3)
    w = (rng.randn(48, 40) * rng.rand(40) * 3).astype(np.float32)
    w[:, 2] = 0.0                       # an all-zero column
    rq, rs = jq.quantize_weight(w, mode)
    qw, scale = pq.quantize_weight(w, mode)
    assert qw.dtype == pq.storage_dtype(mode) and scale.shape == (40,)
    np.testing.assert_array_equal(_bytes(qw), _bytes(rq))
    np.testing.assert_array_equal(scale.numpy(), rs)
    assert scale[2] == 0 and not qw[:, 2].float().any()
    np.testing.assert_array_equal(
        pq.dequantize_weight(qw, scale).numpy(),
        np.asarray(jq.dequantize_weight(jnp.asarray(rq), jnp.asarray(rs))))
    # a tensor input (bf16 widened exactly) quantizes the same
    qb, sb = pq.quantize_weight(torch.from_numpy(w).to(torch.bfloat16), mode)
    rb, rsb = jq.quantize_weight(np.asarray(jnp.asarray(w, jnp.bfloat16)),
                                 mode)
    np.testing.assert_array_equal(sb.numpy(), rsb)
    with pytest.raises(ValueError, match="2-D"):
        pq.quantize_weight(np.zeros(4, np.float32), mode)


# -- K3-quant's plain version -----------------------------------------------

def _quant_pool_case(seed, mode, S=4, P=12, MP=5, page=4, H=2, HKV=None,
                     D=8, group=None, lengths=None):
    """The reference's fixture (test_kv_quant.py:153) with lengths 0, 1, a
    mid-page frontier and the full window (or the given ``lengths``)."""
    rng = np.random.RandomState(seed)
    HKV = H if HKV is None else HKV
    cfg = pq.KVQuantConfig(mode, page, group or 0)
    if mode == "int8":
        kq = rng.randint(-127, 128, size=(P + 1, page, HKV, D)).astype(
            np.int8)
        vq = rng.randint(-127, 128, size=(P + 1, page, HKV, D)).astype(
            np.int8)
        jk, jv = jnp.asarray(kq), jnp.asarray(vq)
        tk, tv = _t(kq), _t(vq)
    else:
        kf = rng.randn(P + 1, page, HKV, D).astype(np.float32)
        vf = rng.randn(P + 1, page, HKV, D).astype(np.float32)
        jk, jv = (jnp.asarray(a, jnp.float8_e4m3fn) for a in (kf, vf))
        tk, tv = (_t(a).to(torch.float8_e4m3fn) for a in (kf, vf))
        np.testing.assert_array_equal(_bytes(tk), _bytes(jk))
    G = cfg.groups_per_page
    ks = (np.abs(rng.randn(P + 1, G, HKV)) * 0.05).astype(np.float32)
    vs = (np.abs(rng.randn(P + 1, G, HKV)) * 0.05).astype(np.float32)
    ks[3] = 0.0                          # a virgin page: exact zeros
    pt = rng.randint(0, P, size=(S, MP)).astype(np.int32)
    q = rng.randn(S, H, D).astype(np.float32)
    if lengths is None:
        lengths = [0, 1, 2 * page + 3, MP * page]
    lengths = np.array(lengths, np.int32)[:S]
    ref_cfg = jq.KVQuantConfig(mode, page, group or 0)
    jax_args = (jnp.asarray(q), jk, jv, pt, lengths)
    jax_kw = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
                  quant=ref_cfg)
    port_args = (_t(q), tk, tv, _t(pt), _t(lengths))
    port_kw = dict(k_scale=_t(ks), v_scale=_t(vs), quant=cfg)
    return jax_args, jax_kw, port_args, port_kw


QUANT_GRID = [("int8", 2, 2, None), ("int8", 4, 2, 2), ("fp8", 2, 2, None),
              ("fp8", 4, 1, 2), ("int8", 8, 2, 1), ("fp8", 8, 8, 4)]


@pytest.mark.parametrize("mode,H,HKV,group", QUANT_GRID)
def test_plain_k3_quant_matches_the_reference_pallas_kernel(
        monkeypatch, mode, H, HKV, group):
    """The Pallas kernel K3-quant replaces, in interpret mode as the
    reference's own test runs it, over mode x H x KVH x group."""
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    jax_args, jax_kw, port_args, port_kw = _quant_pool_case(
        8, mode, H=H, HKV=HKV, group=group)
    ref = np.asarray(ppa.paged_flash_decode(*jax_args, **jax_kw))
    got = pa.paged_decode_attention(*port_args, **port_kw).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    gather = np.asarray(decode_paged_attention(*jax_args, **jax_kw))
    np.testing.assert_allclose(got, gather, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mode,MP,group,pallas", [
    ("int8", 20, None, False), ("fp8", 20, 4, False),
    ("int8", 256, 4, True), ("fp8", 256, None, True)])
def test_plain_k3_quant_matches_the_reference_at_the_split_edges(
        monkeypatch, mode, MP, group, pallas):
    """The plain version at the edges of the kernel's split plan (a
    split's tokens - 1, them, + 1, and one token short of the table), at
    the serving page size, on a 20-page and a 256-page table (32 splits
    a slot on one-byte pools), against the reference's gather lowering and, on the wide
    table, its Pallas kernel in interpret mode."""
    page = 16
    C = pa.split_plan(MP, page, quant=True)[0] * page
    lengths = [min(n, MP * page) for n in (C - 1, C, C + 1, MP * page - 1)]
    jax_args, jax_kw, port_args, port_kw = _quant_pool_case(
        11, mode, P=4 * MP, MP=MP, page=page, H=4, HKV=2, group=group,
        lengths=lengths)
    got = pa.paged_decode_attention(*port_args, **port_kw).numpy()
    gather = np.asarray(decode_paged_attention(*jax_args, **jax_kw))
    np.testing.assert_allclose(got, gather, rtol=1e-4, atol=1e-5)
    if pallas:
        from jax.experimental import pallas as pl
        monkeypatch.setattr(pl, "pallas_call", functools.partial(
            pl.pallas_call, interpret=True))
        ref = np.asarray(ppa.paged_flash_decode(*jax_args, **jax_kw))
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_plain_k3_quant_dequantizes_in_fp32_and_counts_no_launch():
    """The plain version dequantizes in fp32 (equal to K3's plain version
    over the dequantized pools) for bf16 q too, and CPU tensors count no
    launch of either kernel."""
    _, _, (q, kq, vq, pt, ln), kw = _quant_pool_case(5, "int8", H=4, HKV=2,
                                                     group=2)
    kd = pq.dequant_pages(kq, kw["k_scale"], kw["quant"])
    vd = pq.dequant_pages(vq, kw["v_scale"], kw["quant"])
    before = (pa.launches, pa.launches_quant)
    for qq in (q, q.to(torch.bfloat16)):
        got = pa.paged_decode_attention(qq, kq, vq, pt, ln, **kw)
        ref = pa.paged_decode_attention_plain(qq.float(), kd, vd, pt, ln)
        torch.testing.assert_close(got, ref.to(qq.dtype), rtol=0, atol=0)
    assert (pa.launches, pa.launches_quant) == before


def test_quant_wrapper_rules():
    _, _, (q, kq, vq, pt, ln), kw = _quant_pool_case(5, "int8")
    with pytest.raises(ValueError, match="need quant"):
        pa.paged_decode_attention(q, kq, vq, pt, ln)
    with pytest.raises(ValueError, match="k_scale must be float32"):
        pa.paged_decode_attention(q, kq, vq, pt, ln, k_scale=None,
                                  v_scale=kw["v_scale"], quant=kw["quant"])
    with pytest.raises(TypeError, match="storage dtype"):
        pa.paged_decode_attention(q, kq.to(torch.float8_e4m3fn),
                                  vq.to(torch.float8_e4m3fn), pt, ln, **kw)
    with pytest.raises(ValueError, match="span devices"):
        pa.paged_decode_attention(q, kq, vq, pt, ln, k_scale=kw[
            "k_scale"].to("meta"), v_scale=kw["v_scale"], quant=kw["quant"])


def test_quantized_prefill_gather_matches_the_reference():
    jax_args, jax_kw, port_args, port_kw = _quant_pool_case(
        9, "fp8", H=4, HKV=2, group=2)
    rng = np.random.RandomState(2)
    q = rng.randn(4, 3, 4, 8).astype(np.float32)
    base = np.array([4, 9, 0, 1], np.int32)
    from paddle_tpu.ops.attention_ops import paged_chunk_attention
    from paddle_tpu_torch.ops.attention import paged_chunk_attention as pca
    ref = np.asarray(paged_chunk_attention(
        jnp.asarray(q), jax_args[1], jax_args[2], jax_args[3], base,
        **jax_kw))
    got = pca(_t(q), port_args[1], port_args[2], port_args[3], _t(base),
              **port_kw).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


# -- engines ----------------------------------------------------------------

def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("mode,group", [("int8", None), ("fp8", None),
                                        ("int8", 2)])
def test_quantized_engines_match_the_reference(jax_model_params, mode,
                                               group):
    """The same weights carried across: prefill logits within 1e-5
    relative (fp32), the pools' scales equal, greedy streams identical."""
    jm, jp = jax_model_params
    pm, pp = port_pair(jp)
    je, pe = jax_engine(jm, jp, mode, group), port_engine(pm, pp, mode,
                                                          group)
    for i, p in enumerate(random_prompts(SLOTS, seed=21, lo=2, hi=16)):
        ref = je.prefill(i, p, max_new_tokens=8)
        got = pe.prefill(i, p, max_new_tokens=8)
        assert _rel(got, ref) <= 1e-5
    np.testing.assert_array_equal(pe._page_table, je._page_table)
    for layer in range(LAYERS):
        np.testing.assert_allclose(pe._ks[layer].numpy(),
                                   np.asarray(je._ks[layer]), rtol=1e-5)
    prompts = random_prompts(2 * SLOTS, seed=31)
    for chunk in (prompts[:SLOTS], prompts[SLOTS:]):
        ref = jserving.greedy_generate(jax_engine(jm, jp, mode, group),
                                       chunk, 16, eos_id=1)
        got = pgen.greedy_generate(port_engine(pm, pp, mode, group), chunk,
                                   16, eos_id=1)
        assert got == ref


@pytest.mark.parametrize("mode,group", [("int8", None), ("int8", 2),
                                        ("fp8", None)])
def test_kv_quant_greedy_token_match_guard(jax_model_params, mode, group):
    """The reference's guard, on the port alone: quantized pages against
    the port's unquantized engine, token match >= 0.95."""
    pm, pp = port_pair(jax_model_params[1])
    prompts = random_prompts(2 * SLOTS, seed=31)
    ref, got = [], []
    for chunk in (prompts[:SLOTS], prompts[SLOTS:]):
        ref += pgen.greedy_generate(port_engine(pm, pp, "off"), chunk, 24,
                                    eos_id=1)
        got += pgen.greedy_generate(port_engine(pm, pp, mode, group), chunk,
                                    24, eos_id=1)
    assert match_fraction(ref, got) >= TOKEN_MATCH_MIN


def test_quant_pool_admits_1p9x_sequences_at_equal_memory(jax_model_params):
    pm, pp = port_pair(jax_model_params[1])
    page, dense_pages = 16, 64
    cfg = pq.KVQuantConfig("int8", page)
    q_pages = pq.equal_memory_pages(dense_pages, page, pm.n_heads,
                                    pm.head_dim, cfg)
    assert q_pages / dense_pages >= 1.9

    def engine(**kw):
        return pkv.PagedDecodeEngine(pm, pp, max_slots=1, max_len=64,
                                     prefill_buckets=(16,), page_size=page,
                                     device="cpu", **kw)
    ref = engine(num_pages=dense_pages, kv_quant_dtype="off")
    quant = engine(num_pages=q_pages, kv_quant_dtype="int8")
    prompt = np.arange(2, 18, dtype=np.int32)

    def admitted(eng):
        n = 0
        while eng.can_admit(prompt, 48):
            eng.pool.alloc(eng._pages_for(16 + 48))
            n += 1
        eng.pool.reset()
        return n

    a_ref, a_quant = admitted(ref), admitted(quant)
    assert a_quant >= 1.9 * a_ref, (a_quant, a_ref)
    ratio = quant.page_stats()["kv_pool_effective_capacity"] / \
        float(ref.page_stats()["kv_pool_effective_capacity"])
    assert ratio >= 1.9


def test_quant_engine_state_metrics_and_scheduler(jax_model_params):
    """Pools in the storage dtype, scales reset on reclaim, the counter and
    gauges, and the scheduler's streams equal solo runs."""
    pm, pp = port_pair(jax_model_params[1])
    eng = port_engine(pm, pp, "fp8", max_slots=1)
    assert eng._kp[0].dtype == torch.float8_e4m3fn
    assert eng._ks[0].shape == (eng.num_pages + 1, 1, HEADS)
    c0 = profiler.get_counters().get("kv_quant_pages_total", 0.0)
    eng.prefill(0, np.arange(2, 10, dtype=np.int32), max_new_tokens=4)
    grew = profiler.get_counters()["kv_quant_pages_total"] - c0
    assert grew == eng.last_prefill_stats["pages_reserved"] > 0
    st = eng.page_stats()
    assert st["kv_quant_dtype"] == "fp8" and \
        st["kv_pool_effective_capacity"] == eng.num_pages * eng.page_size
    used = list(eng._slot_pages[0])
    assert all(float(eng._ks[0][p].max()) > 0 for p in used[:2])
    eng.release(0)
    eng.prefix_cache.evict_for(len(used))
    eng.prefill(0, np.array([5], np.int32), max_new_tokens=2)
    # the reclaimed pages past the one written position start at scale 0
    assert all(float(eng._ks[0][p].max()) == 0
               for p in eng._slot_pages[0][1:])
    eng.release(0)
    prompts = random_prompts(2 * SLOTS, seed=17, lo=2, hi=8)
    solo = [pgen.greedy_generate(port_engine(pm, pp, max_slots=1), [p], 12,
                                 eos_id=1)[0] for p in prompts]
    with pgen.GenerationScheduler(port_engine(pm, pp), eos_id=1,
                                  queue_depth=64,
                                  default_max_new_tokens=12) as sched:
        results = [p.wait(120) for p in [sched.submit(p) for p in prompts]]
    assert [r["tokens"] for r in results] == solo


def test_quant_flags_feed_the_engine_and_off_is_untouched(jax_model_params):
    pm, pp = port_pair(jax_model_params[1])
    prompts = random_prompts(2, seed=9)
    off = pgen.greedy_generate(port_engine(pm, pp, "off", max_slots=2),
                               prompts, 12, eos_id=1)
    saved = (pflags.kv_quant_dtype, pflags.kv_quant_group)
    pflags.kv_quant_dtype, pflags.kv_quant_group = "int8", 2
    try:
        inherits = pkv.PagedDecodeEngine(pm, pp, max_slots=2,
                                         max_len=MAX_LEN,
                                         prefill_buckets=BUCKETS,
                                         page_size=PAGE, device="cpu")
        assert inherits.kv_quant_dtype == "int8"
        assert inherits.kv_quant.group == 2
        again = pgen.greedy_generate(port_engine(pm, pp, "off", max_slots=2),
                                     prompts, 12, eos_id=1)
    finally:
        pflags.kv_quant_dtype, pflags.kv_quant_group = saved
    assert again == off


# -- weight-quantized artifacts ---------------------------------------------

@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_weight_quantized_dirs_load_across_packages(jax_model_params,
                                                    tmp_path, mode):
    """A directory quantized by either package holds the same arrays and
    loads in the other; logits agree within 1e-5, the quantized engines'
    greedy streams are identical."""
    jm, jp = jax_model_params
    src = str(tmp_path / "dec")
    jserving.save_decoder(src, jm, jp)
    with open(os.path.join(src, "vocab.txt"), "w") as f:
        f.write("a b c\n")
    jdir, pdir = str(tmp_path / "jq"), str(tmp_path / "pq")
    c0 = catalog.WEIGHT_QUANT_ARTIFACTS.value()
    assert jserving.quantize_decoder_dir(src, jdir, mode) == \
        pgen.quantize_decoder_dir(src, pdir, mode)
    assert catalog.WEIGHT_QUANT_ARTIFACTS.value() == c0 + 1
    with np.load(os.path.join(jdir, "params.npz")) as a, \
            np.load(os.path.join(pdir, "params.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key])
    with open(os.path.join(pdir, "vocab.txt")) as f:
        assert f.read() == "a b c\n"
    toks = np.random.RandomState(0).randint(0, VOCAB, size=(3, 9)).astype(
        np.int32)
    lens = np.array([9, 4, 1], np.int32)
    for written, read in ((jdir, pdir), (pdir, jdir)):
        jm2, jp2 = jserving.load_decoder(read)
        pm2, pp2 = pgen.load_decoder(written, device="cpu")
        assert pm2.weight_quant == jm2.weight_quant == mode
        assert pp2["blocks"][0]["wq"]["qw"].dtype == pq.storage_dtype(mode)
        ref = np.asarray(jm2.last_logits_and_kv(
            jp2, jnp.asarray(toks), jnp.asarray(lens))[0])
        got = pm2.last_logits_and_kv(pp2, _t(toks), _t(lens))[0].numpy()
        assert _rel(got, ref) <= 1e-5
    # the reference's in-memory quantizer, carried across, gives the
    # loaded leaves bit for bit
    mem = params_from_jax(np_tree(jserving.quantize_decoder_params(jp, mode)),
                          device="cpu")
    for name in ("wq", "w2"):
        np.testing.assert_array_equal(_bytes(mem["blocks"][1][name]["qw"]),
                                      _bytes(pp2["blocks"][1][name]["qw"]))
    # carried as a pytree (params_from_jax) the quantized leaves agree too
    carried = params_from_jax(np_tree(jp2), device="cpu")
    np.testing.assert_array_equal(_bytes(carried["head"]["qw"]),
                                  _bytes(pp2["head"]["qw"]))
    prompts = random_prompts(SLOTS, seed=23)
    ref = jserving.greedy_generate(jax_engine(jm2, jp2, "int8"), prompts,
                                   12, eos_id=1)
    got = pgen.greedy_generate(port_engine(pm2, pp2, "int8"), prompts, 12,
                               eos_id=1)
    assert got == ref
    with pytest.raises(ValueError, match="already weight-quantized"):
        pgen.quantize_decoder_dir(pdir, str(tmp_path / "again"), mode)
    for bad in ("off", "int4"):
        with pytest.raises(ValueError, match="must be fp8|int8"):
            pgen.quantize_decoder_dir(src, str(tmp_path / "off"), bad)


def test_serve_cli_serves_quantized_and_reports_it(jax_model_params,
                                                   tmp_path):
    """``--kv-quant-dtype int8`` on a weight-quantized directory: the
    server answers as the engine does and /healthz names both modes."""
    jm, jp = jax_model_params
    src, qdir = str(tmp_path / "dec"), str(tmp_path / "q")
    jserving.save_decoder(src, jm, jp)
    pgen.quantize_decoder_dir(src, qdir, "int8")
    pm, pp = pgen.load_decoder(qdir, device="cpu")
    ref = pgen.greedy_generate(port_engine(pm, pp, "int8", max_slots=2),
                               [[4, 5, 6]], 5)[0]
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving.serve",
         "--generation-model", qdir, "--device", "cpu", "--port", "0",
         "--gen-max-slots", "2", "--gen-max-len", str(MAX_LEN),
         "--gen-prefill-buckets", "8,16", "--gen-page-size", str(PAGE),
         "--kv-quant-dtype", "int8"],
        cwd=str(tmp_path), env=env, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stderr.readline()
        assert line.startswith("serve: http://"), line
        assert "kv_quant=int8" in line and "weight_quant=int8" in line
        url = line.split()[1]
        req = urllib.request.Request(
            url + "/v1/generate", data=json.dumps(
                {"prompt": [4, 5, 6], "max_new_tokens": 5}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert json.loads(r.read())["tokens"] == ref
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            doc = json.loads(r.read())
        assert doc["serving"]["kv_quant"] == "int8"
        assert doc["serving"]["weight_quant"] == "int8"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
        proc.stderr.close()


def test_quantize_decoder_dir_reads_a_reference_bf16_directory(
        jax_model_params, tmp_path):
    """The JAX save_decoder stores bf16 arrays as 2-byte void records; the
    port widens them exactly before quantizing, so the payload equals the
    quantized bf16 weights."""
    jm, jp = jax_model_params
    m16 = jserving.TransformerDecoderModel(VOCAB, dim=DIM, n_heads=HEADS,
                                           n_layers=LAYERS,
                                           dtype=jnp.bfloat16)
    p16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
    src, dst = str(tmp_path / "b"), str(tmp_path / "q")
    jserving.save_decoder(src, m16, p16)
    pgen.quantize_decoder_dir(src, dst, "int8")
    model, params = pgen.load_decoder(dst, device="cpu")
    assert model.dtype == torch.bfloat16 and model.weight_quant == "int8"
    rq, rs = jq.quantize_weight(np.asarray(p16["head"], np.float32), "int8")
    np.testing.assert_array_equal(params["head"]["qw"].numpy(), rq)
    np.testing.assert_array_equal(params["head"]["scale"].numpy(), rs)
    assert params["lnf_s"].dtype == torch.bfloat16
