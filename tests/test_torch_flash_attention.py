"""The port's flash attention (K1 forward, K2 backward) against the JAX
package's bshd Pallas kernels on the CPU.

The JAX side runs ``_flash_fwd_bshd`` / ``_flash_bwd_bshd`` in Pallas
interpret mode at one 256-block (as tests/ops/test_fused_attention_
saved.py runs them); the port side runs the kernels' plain versions,
which CPU tensors take. Same numpy inputs, fp32, seq 256, heads 2 and 4
over kv heads 1 and 2, head_dim 32 and 64, causal and not, with and
without a factored padding mask (a padded tail and a fully padded row).
o, lse ([b*h, s, 8]), dq, dk and dv agree within 5e-6 of each tensor's
largest magnitude (both compute in fp32 and differ in summation order
only; the worst case read 7.5e-7), and a fully padded row's lse is the
same -1e30 in both. The same cases in bf16 (the inputs cast to bf16; the
TPU's K1/K2 keep P and dS in fp32, and so do the plain versions, which
the bf16 kernels are held against on the card): o, dq, dk and dv within
2 bf16 ulps of each reference tensor's largest magnitude with at most
1% of the elements differing at all, lse as in fp32; the backward takes
the reference's (o, lse), so both sides start from the same residuals.

Also: the ``autograd.Function`` (K1 with K2 as its backward) against
autograd of a naive attention, and the wrappers' device rule — CPU
tensors take the plain version and count no launch, tensors on another
device with a dtype or shape the kernels do not take raise before any
launch.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_attention as jpa
from paddle_tpu_torch.ops import flash_attention as fa

S = 256
TOL = dict(atol=2e-5, rtol=1e-5)


def assert_bf16_close(name, got, want):
    """bf16 results as float32 arrays: every element within 2 bf16 ulps of
    the reference tensor's largest magnitude (as the fp32 cases bound each
    tensor at its largest magnitude: an element that cancels to near zero
    moves by many of its own ulps when one rounding of P or dS flips with
    the summation order), and at most 1% of the elements differing at
    all."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    worst = float(np.abs(got - want).max() / ulp)
    differ = float((got != want).mean())
    assert worst <= 2 and differ <= 0.01, \
        "%s: %.2f bf16 ulps off, %.2f%% differ" % (name, worst, 100 * differ)


def assert_close(name, got, want):
    """Within 5e-6 of ``want``'s largest finite magnitude; entries at the
    -1e30 mask value (a fully padded row's lse) equal."""
    got, want = np.asarray(got), np.asarray(want)
    finite = np.abs(want) < 1e29
    np.testing.assert_array_equal(got[~finite], want[~finite], err_msg=name)
    np.testing.assert_allclose(got[finite], want[finite], rtol=0,
                               atol=5e-6 * np.abs(want[finite]).max(),
                               err_msg=name)


@pytest.fixture
def interpret(monkeypatch):
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    with jpa._block_ctx(S, S):
        yield


def inputs(b, h, hkv, d, masked, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, S, h, d).astype(np.float32)
    k = rng.randn(b, S, hkv, d).astype(np.float32)
    v = rng.randn(b, S, hkv, d).astype(np.float32)
    do = rng.randn(b, S, h, d).astype(np.float32)
    valid = None
    if masked:
        valid = np.ones((b, S), bool)
        valid[1, S - 70:] = False       # a padded tail
        valid[2, :] = False             # a fully padded row
    return q, k, v, do, valid


CASES = [(2, 2, 32), (4, 1, 64), (4, 2, 32), (2, 1, 64)]


@pytest.mark.parametrize(
    "masked,bf16", [(False, False), (True, False), (False, True),
                    (True, True)],
    ids=["nomask", "factored", "nomask-bf16", "factored-bf16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("h,hkv,d", CASES)
def test_plain_versions_match_the_pallas_kernels(interpret, h, hkv, d,
                                                 causal, masked, bf16):
    q, k, v, do, valid = inputs(3, h, hkv, d, masked)
    scale = 1.0 / np.sqrt(d)
    jmask = None if valid is None else (jnp.asarray(valid),
                                        jnp.asarray(valid))
    jin = [jnp.asarray(x) for x in (q, k, v, do)]
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    if bf16:
        jin = [x.astype(jnp.bfloat16) for x in jin]
        t = [x.to(torch.bfloat16) for x in t]
    jo, jlse = jpa._flash_fwd_bshd(*jin[:3], scale, causal, save_lse=True,
                                   mask=jmask)
    jgrads = jpa._flash_bwd_bshd(*jin[:3], jo, jlse, jin[3], scale, causal,
                                 mask=jmask)
    kv = None if valid is None else torch.from_numpy(valid)
    before = dict(fa.launches)
    o, lse = fa.flash_fwd(t[0], t[1], t[2], scale, causal, kv)
    res = (o, lse)
    if bf16:     # the reference's residuals: the backward on equal inputs
        res = (torch.from_numpy(np.asarray(jo.astype(jnp.float32)))
               .to(torch.bfloat16), torch.from_numpy(np.asarray(jlse)))
    grads = fa.flash_bwd(t[0], t[1], t[2], *res, t[3], scale, causal, kv)
    assert fa.launches == before        # CPU tensors launch nothing
    assert tuple(lse.shape) == (3 * h, S, fa.LSE_LANES)
    for name, got, want in zip(("o", "lse", "dq", "dk", "dv"),
                               (o, lse) + grads,
                               (jo, jlse) + tuple(jgrads)):
        if bf16 and name != "lse":
            assert got.dtype == torch.bfloat16
            assert_bf16_close(name, got.float().numpy(),
                              want.astype(jnp.float32))
        else:
            assert_close(name, got.numpy(), want)
    if masked and not bf16:   # a fully padded row is V's average, not NaN
        vbar = v[2].mean(axis=0).repeat(h // hkv, axis=0)
        np.testing.assert_allclose(o[2].numpy(), np.broadcast_to(
            vbar, o[2].shape), atol=1e-5)


def naive(q, k, v, causal, valid, scale):
    b, s, h, d = q.shape
    kr = k.repeat_interleave(h // k.shape[2], dim=2)
    vr = v.repeat_interleave(h // k.shape[2], dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, kr) * scale
    hidden = torch.zeros(s, s, dtype=torch.bool)
    if causal:
        hidden = torch.ones(s, s, dtype=torch.bool).triu(1)
    hidden = hidden[None, None] | ~valid[:, None, None, :]
    p = torch.softmax(logits.masked_fill(hidden, fa.NEG_INF), -1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vr)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_autograd_function_matches_naive_attention(causal):
    q, k, v, do, valid = inputs(3, 4, 2, 32, True, seed=1)
    scale = 1.0 / np.sqrt(32)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    kv = torch.from_numpy(valid)
    g = torch.from_numpy(do) * kv[:, :, None, None]   # padded rows: 0
    o, lse = fa.flash_fwd_saving_lse(*leaves, scale, causal, (kv, kv))
    assert not lse.requires_grad
    got = torch.autograd.grad(o, leaves, g)
    ref_o = naive(*leaves, causal, kv, scale)
    want = torch.autograd.grad(ref_o, leaves, g)
    np.testing.assert_allclose(o.detach().numpy(), ref_o.detach().numpy(),
                               **TOL)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name,
                                   **TOL)


def test_wrappers_raise_on_inputs_the_kernels_do_not_take():
    b, h, hkv, d = 1, 4, 2, 32
    meta = dict(device="meta")
    q = torch.empty(b, S, h, d, **meta)
    k = torch.empty(b, S, hkv, d, **meta)
    lse = torch.empty(b * h, S, fa.LSE_LANES, **meta)
    delta = torch.empty(b, S, h, **meta)
    before = dict(fa.launches)
    with pytest.raises(TypeError):               # fp16 is not taken
        fa.flash_fwd(q.half(), k.half(), k.half())
    with pytest.raises(TypeError):               # mixed dtypes
        fa.flash_fwd(q, k.bfloat16(), k)
    with pytest.raises(ValueError):              # k/v shapes differ
        fa.flash_fwd(q, k, k[:, :, :1])
    with pytest.raises(ValueError):              # heads % kv heads
        fa.flash_fwd(q[:, :, :3], k, k)
    with pytest.raises(ValueError):              # head_dim > 256
        fa.flash_fwd(torch.empty(b, S, h, 264, **meta),
                     torch.empty(b, S, hkv, 264, **meta),
                     torch.empty(b, S, hkv, 264, **meta))
    with pytest.raises(ValueError):              # non-contiguous
        fa.flash_fwd(q.transpose(1, 2).contiguous().transpose(1, 2), k, k)
    with pytest.raises(ValueError):              # lse of the wrong shape
        fa.flash_bwd_dq(q, k, k, q, lse[:, :, :1], delta)
    with pytest.raises(ValueError):              # not a CUDA device
        fa.flash_bwd_dkv(q, k, k, q, lse, delta)
    with pytest.raises(ValueError):              # inputs span devices
        fa.flash_fwd(q, torch.empty(k.shape), k)
    assert fa.launches == before
