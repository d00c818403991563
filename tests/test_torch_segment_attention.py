"""The port's packed-segment pieces against the JAX package on the CPU:
``segment_mask`` (windows and the dense form, exact), the packer and its
labels (exact arrays), the K5 plain versions against the reference's
segment Pallas kernels in interpret mode and against its densified
``dot_product_attention``, and the ``fused_attention`` op with
``QSegIds``/``KSegIds`` against the reference op forced onto its
saved-lse Pallas path.

Tolerances: fp32 within 1e-5 of each tensor's largest magnitude (both
sides compute in fp32 and differ in summation order only; the worst
case read 4.2e-7); bf16 within 2^-8 of the largest magnitude, half a
bf16 unit in the last place at the top of the range: both sides round
the same fp32 values once, so they differ only where the fp32 sums
straddle a rounding boundary (the worst case read 1.1e-3).
"""

from tests import torch_threads  # noqa: F401  (first)
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.data import decorator as jdec
from paddle_tpu.ops import attention_ops as jattn
from paddle_tpu.ops import pallas_attention as jpa
from paddle_tpu.ops import segment_mask as jseg
from paddle_tpu_torch.data import decorator as pdec
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import segment_mask as pseg
from tests.test_torch_train_ops import (compare, rand,  # noqa: F401
                                        reference_saved_path, to_np)

B, S, H, HKV, D = 2, 512, 4, 2, 32


def make_segments(b, s, max_seg=5, seed=0):
    """Random packed rows: non-decreasing ids 0..n-1, the last segment
    doubling as padding (tests/ops/test_segment_attention.py's maker)."""
    rng = np.random.RandomState(seed)
    out = np.zeros((b, s), np.int32)
    for i in range(b):
        n = rng.randint(2, max_seg + 1)
        cuts = np.sort(rng.choice(np.arange(1, s), n - 1, replace=False))
        bounds = np.concatenate([[0], cuts, [s]])
        for si in range(n):
            out[i, bounds[si]:bounds[si + 1]] = si
    return out


@pytest.fixture
def interpret(monkeypatch):
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("block_q,block_k", [(64, 32), (32, 64), (128, 128),
                                             (256, 16)])
def test_segment_block_windows_match_the_reference(block_q, block_k):
    seg = make_segments(3, 256, max_seg=7, seed=1)
    seg[2] = 0                                    # one segment
    for causal in (False, True):
        for for_dkv in (False, True):
            want = jseg.segment_block_windows(seg, seg, block_q, block_k,
                                              causal, for_dkv=for_dkv)
            got = pseg.segment_block_windows(torch.from_numpy(seg),
                                             torch.from_numpy(seg), block_q,
                                             block_k, causal,
                                             for_dkv=for_dkv)
            for g, w in zip(got, want):
                assert g.dtype == torch.int32
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_densify_segment_mask_matches_the_reference():
    seg = make_segments(2, 40, seed=2)
    want = jseg.densify_segment_mask(jseg.SegmentIds(seg, seg))
    got = pseg.densify_segment_mask(pseg.SegmentIds(torch.from_numpy(seg),
                                                    torch.from_numpy(seg)))
    assert tuple(got.shape) == (2, 1, 40, 40)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not pseg.is_segment_mask((seg, seg))


def _docs(seed, n_min, n_max, total, vocab=1000):
    rng = np.random.RandomState(seed)
    docs = []
    while sum(len(d) for d in docs) < total:
        docs.append(rng.randint(1, vocab, size=int(
            rng.randint(n_min, n_max))).astype(np.int32))
    return docs


@pytest.mark.parametrize("seq,n_min,n_max", [(1024, 128, 512), (64, 1, 30),
                                             (32, 32, 33)],
                         ids=["bench-lm", "short", "exact-fit"])
def test_pack_segments_and_labels_match_the_reference(seq, n_min, n_max):
    docs = _docs(0, n_min, n_max, int(8 * seq * 1.05))
    docs.append(np.zeros(0, np.int32))            # an empty sample: dropped
    want = jdec.pack_segments(docs, seq)
    got = pdec.pack_segments(docs, seq)
    assert len(got) == len(want)
    for (gt, gs), (wt, ws) in zip(got, want):
        assert gt.dtype == wt.dtype and gs.dtype == ws.dtype == np.int32
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gs, ws)
    ids = np.stack([t for t, _ in got])
    seg = np.stack([s for _, s in got])
    for kw in ({}, {"ignore_id": 0}):
        w = jdec.packed_next_token_labels(ids, seg, **kw)
        g = pdec.packed_next_token_labels(ids, seg, **kw)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        pdec.pack_segments([np.ones(seq + 1, np.int32)], seq)


def _inputs(dtype, seed=0):
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(*shape).astype(np.float32)
              for shape in ((B, S, H, D), (B, S, HKV, D), (B, S, HKV, D),
                            (B, S, H, D))]
    seg = make_segments(B, S, seed=seed + 3)
    jx = [jnp.asarray(a).astype(dtype) for a in arrays]
    tx = [torch.from_numpy(np.array(x.astype(jnp.float32)))
          .to(torch.float32 if dtype == jnp.float32 else torch.bfloat16)
          for x in jx]
    return jx, tx, seg


def assert_close(name, got, want, bf16):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=(2 ** -8 if bf16 else 1e-5) * scale,
                               err_msg=name)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_plain_versions_match_the_pallas_segment_kernels(interpret, dtype,
                                                         causal):
    (jq, jk, jv, jdo), (q, k, v, do), seg = _inputs(dtype)
    scale = 1.0 / np.sqrt(D)
    jmask = jseg.SegmentIds(jnp.asarray(seg), jnp.asarray(seg))
    jo, jlse = jpa._flash_fwd_segment(jq, jk, jv, jmask, scale, causal)
    jgrads = jpa._flash_bwd_segment(jq, jk, jv, jo, jlse, jdo, jmask, scale,
                                    causal)
    tseg = torch.from_numpy(seg)
    pmask = pseg.SegmentIds(tseg, tseg)
    before = dict(fa.launches)
    o, lse = fa.flash_fwd_segment(q, k, v, pmask, scale, causal)
    grads = fa.flash_bwd_segment(q, k, v, o, lse, do, pmask, scale, causal)
    assert fa.launches == before                 # CPU tensors launch nothing
    assert tuple(lse.shape) == (B * H, S, fa.LSE_LANES)
    assert o.dtype == q.dtype and all(g.dtype == q.dtype for g in grads)
    bf16 = dtype == jnp.bfloat16
    for name, got, want in zip(("o", "lse", "dq", "dk", "dv"),
                               (o, lse) + grads, (jo, jlse) + tuple(jgrads)):
        assert_close(name, got, want.astype(jnp.float32), bf16)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_plain_versions_match_densified_attention(causal):
    """fp32: the K5 plain versions against autodiff of the reference's XLA
    composition under the densified segment mask."""
    import jax
    (jq, jk, jv, jdo), (q, k, v, do), seg = _inputs(jnp.float32, seed=5)
    jmask = jseg.SegmentIds(jnp.asarray(seg), jnp.asarray(seg))

    def ref(q, k, v):
        return jattn.dot_product_attention(q, k, v, causal=causal,
                                           mask=jmask, layout="bshd")
    want_o, vjp = jax.vjp(ref, jq, jk, jv)
    want = (want_o,) + vjp(jdo)
    tseg = torch.from_numpy(seg)
    pmask = pseg.SegmentIds(tseg, tseg)
    o, lse = fa.flash_fwd_segment_plain(q, k, v, pmask, None, causal)
    grads = fa.flash_bwd_segment_plain(q, k, v, o, lse, do, pmask, None,
                                       causal)
    for name, got, w in zip(("o", "dq", "dk", "dv"), (o,) + grads, want):
        assert_close(name, got, w, False)
    # the mask genuinely constrained attention
    free = fa.flash_fwd_plain(q, k, v, None, causal)[0]
    assert (free - o).abs().max() > 1e-2


def test_single_segment_equals_plain_causal():
    _, (q, k, v, do), _ = _inputs(jnp.float32, seed=7)
    zeros = torch.zeros((B, S), dtype=torch.int32)
    seg = pseg.SegmentIds(zeros, zeros)
    o, lse = fa.flash_fwd_segment(q, k, v, seg, None, True)
    o1, lse1 = fa.flash_fwd(q, k, v, None, True)
    np.testing.assert_array_equal(o.numpy(), o1.numpy())
    np.testing.assert_array_equal(lse.numpy(), lse1.numpy())
    for a, b in zip(fa.flash_bwd_segment(q, k, v, o, lse, do, seg, None,
                                         True),
                    fa.flash_bwd(q, k, v, o1, lse1, do, None, True)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_autograd_function_matches_the_plain_backward():
    _, (q, k, v, do), seg = _inputs(jnp.float32, seed=9)
    tseg = torch.from_numpy(seg)
    mask = pseg.SegmentIds(tseg, tseg)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o, lse = fa.flash_fwd_saving_lse(*leaves, None, True, mask)
    assert not lse.requires_grad
    got = torch.autograd.grad(o, leaves, do)
    want = fa.flash_bwd_segment_plain(q, k, v, o.detach(), lse, do, mask,
                                      None, True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert all(torch.equal(a, b) for a, b in zip(
        fa.flash_bwd_from_saved(q, k, v, o.detach(), lse, do, None, True,
                                mask), want))


def test_segment_wrappers_raise_on_inputs_the_kernels_do_not_take():
    meta = dict(device="meta")
    q = torch.empty(1, S, H, D, **meta)
    k = torch.empty(1, S, HKV, D, **meta)
    lse = torch.empty(H, S, fa.LSE_LANES, **meta)
    delta = torch.empty(1, S, H, **meta)
    ids = torch.zeros(1, S, dtype=torch.int32, **meta)
    seg = pseg.SegmentIds(ids, ids)
    before = dict(fa.launches)
    with pytest.raises(TypeError):               # int64 ids
        fa.flash_fwd_segment(q, k, k, pseg.SegmentIds(ids.long(),
                                                      ids.long()))
    with pytest.raises(ValueError):              # ids of the wrong shape
        fa.flash_fwd_segment(q, k, k, pseg.SegmentIds(ids[:, 1:], ids))
    with pytest.raises(TypeError):               # a factored mask
        fa.flash_fwd_segment(q, k, k, (ids, ids))
    with pytest.raises(ValueError):              # ids on another device
        fa.flash_fwd_segment(q, k, k, pseg.SegmentIds(
            torch.zeros(1, S, dtype=torch.int32), ids))
    with pytest.raises(ValueError):              # not a CUDA device
        fa.flash_bwd_segment_dkv(q, k, k, q, lse, delta, seg)
    assert fa.launches == before


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp"])
def test_fused_attention_op_with_segment_ids(reference_saved_path, amp):
    b, s, h, hkv, d = 2, 256, 4, 2, 32
    seg = make_segments(b, s, seed=11)
    ins = {"Q": [rand(b, s, h, d)], "K": [rand(b, s, hkv, d, seed=1)],
           "V": [rand(b, s, hkv, d, seed=2)], "QSegIds": [seg],
           "KSegIds": [seg]}
    jout, pout = compare(
        "fused_attention", ins,
        {"causal": True, "layout": "bshd", "scale": 1.0 / np.sqrt(d)},
        amp=amp, grads=("Q", "K", "V"))
    lse = to_np(pout["Lse"][0])
    assert lse.shape == (b * h, s, 8) and np.isfinite(lse).all()
    assert np.abs(to_np(jout["Lse"][0])).max() > 0   # the reference's is real
    # the padding segment attends itself: its rows are not zeroed
    assert np.abs(to_np(pout["Out"][0])[:, -1]).max() > 0


def test_fused_attention_needs_both_segment_inputs():
    from tests.test_torch_train_ops import lower
    q = torch.zeros(1, 8, 2, 4)
    with pytest.raises(ValueError, match="BOTH"):
        lower("port", "fused_attention",
              {"Q": [q], "K": [q], "V": [q],
               "QSegIds": [torch.zeros(1, 8, dtype=torch.int32)]},
              {"causal": True, "layout": "bshd"}, False)
