"""K6-dQ/dKV's plain versions against the reference's Pallas backward on
the CPU: the backward half of ``test_torch_bhsd_attention.py``'s kernel
comparisons, with its inputs, helpers and tolerances (its docstring).

- K6-dQ/dKV against ``_flash_bwd_impl(layout="bhsd")`` (full heads, as the
  reference's bhsd backward takes them), fp32 and bf16, with and without a
  factored mask, causal and not, the reference's blocks at the port's key
  tile or pinned to 32 and 128;
- the GQA backward against ``flash_attention``'s vjp (its expand-and-sum
  path).
"""

from tests import torch_threads  # noqa: F401  (first)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import pallas_attention as jpa
from paddle_tpu_torch.ops import flash_attention as fa
from tests.test_torch_bhsd_attention import (  # noqa: F401
    S, assert_close, inputs, interpret, jnp_all, pin_blocks, to_bf16,
    torch_all)
from tests.test_torch_flash_attention import assert_bf16_close


@pytest.mark.parametrize(
    "masked,bf16,block",
    [(False, False, None), (True, False, None), (False, True, None),
     (True, True, None), (False, True, 32), (True, True, 32),
     (False, True, 128), (True, True, 128)],
    ids=["nomask", "factored", "nomask-bf16", "factored-bf16",
         "nomask-bf16-block32", "factored-bf16-block32",
         "nomask-bf16-block128", "factored-bf16-block128"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("h,d", [(2, 32), (4, 16)])
def test_k6_backward_plain_matches_the_pallas_kernels(interpret, monkeypatch,
                                                      h, d, causal, masked,
                                                      bf16, block):
    """``block``: the reference's blocks pinned to that width instead of
    the port's key tile. The backward rounds P and dS elementwise, so its
    rounding does not follow the tile width (which the tensor-core
    bodies' 16-wide chunks rely on), and the bound holds at any width."""
    q, k, v, do, valid = inputs(2 if bf16 else 3, h, h, d, seed=2)
    scale = 1.0 / np.sqrt(d)
    jm = (jnp.asarray(valid), jnp.asarray(valid)) if masked else None
    jq, jk, jv, jdo = jnp_all(q, k, v, do)
    t = torch_all(q, k, v, do)
    if bf16:
        if block is None:
            pin_blocks(monkeypatch, d)
        else:
            monkeypatch.setattr(jpa, "_BQ_ENV", str(block))
            monkeypatch.setattr(jpa, "_BK_ENV", str(block))
        jq, jk, jv, jdo = (x.astype(jnp.bfloat16) for x in (jq, jk, jv, jdo))
        t = [x.to(torch.bfloat16) for x in t]
    jo, jlse = jpa._flash_fwd_impl(jq, jk, jv, scale, causal, save_lse=True,
                                   mask=jm, layout="bhsd")
    jgrads = jpa._flash_bwd_impl(jq, jk, jv, jo, jlse, jdo, scale, causal,
                                 layout="bhsd", mask=jm)
    kv = torch.from_numpy(valid) if masked else None
    if bf16:     # the reference's residuals: the backward on equal inputs
        o, lse = to_bf16(jo.astype(jnp.float32)), torch_all(jlse)[0]
    else:
        o, lse = fa.flash_fwd(*t[:3], scale, causal, kv, layout="bhsd")
    grads = fa.flash_bwd(*t[:3], o, lse, t[3], scale, causal, kv,
                         layout="bhsd")
    for name, got, want in zip(("dq", "dk", "dv"), grads, jgrads):
        if bf16:
            assert_bf16_close(name, got.float().numpy(),
                              want.astype(jnp.float32))
        else:
            assert_close(name, got.numpy(), want)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_k6_gqa_backward_matches_the_reference_vjp(interpret, monkeypatch,
                                                   causal):
    """The reference's bhsd GQA backward repeats K/V over each group, runs
    the full-head kernels and sums dK/dV (``_bwd`` with a saved Lse: its
    threshold lowered to this length); K6 folds the group instead."""
    monkeypatch.setattr(jpa, "PALLAS_BWD_MIN_SEQ_BHSD", S)
    h, hkv, d = 4, 2, 32
    q, k, v, do, _ = inputs(2, h, hkv, d, seed=3)
    scale = 1.0 / np.sqrt(d)
    jq, jk, jv, jdo = jnp_all(q, k, v, do)
    _, vjp = jax.vjp(lambda a, b_, c: jpa.flash_attention(
        a, b_, c, scale, causal, None, "bhsd"), jq, jk, jv)
    jgrads = vjp(jdo)
    t = torch_all(q, k, v, do)
    o, lse = fa.flash_fwd(*t[:3], scale, causal, layout="bhsd")
    grads = fa.flash_bwd(*t[:3], o, lse, t[3], scale, causal, layout="bhsd")
    for name, got, want in zip(("dq", "dk", "dv"), grads, jgrads):
        assert got.shape == t["qkv".index(name[1])].shape
        assert_close(name, got.numpy(), want)
