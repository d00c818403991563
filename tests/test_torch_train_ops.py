"""Each op lowering of the port's training slice against the JAX
package's, through each package's registry, on the same numpy inputs:
the forward lowering, and the grad lowering (registered, or the generic
vjp of the forward) on the same upstream gradients.

Tolerances: fp32 results within 1e-5 absolute + 1e-5 relative (the two
differ in summation order only); results of ops run under amp (bf16
operands) within 1e-2 absolute + 1e-2 relative, about two units in the
last place of bf16 (8 bits of mantissa), since the packages round at
other places. Random ops draw from different generators (jax.random vs
torch.Generator), so those compare shape, dtype and moments. The
fused_attention case forces the reference's Pallas kernels on, in
interpret mode, with its seq threshold lowered to 256 so the reference
takes its saved-lse path too and both Lse outputs are real.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu  # noqa: F401  registers the reference lowerings
import paddle_tpu_torch  # noqa: F401  registers the port's
from paddle_tpu import registry as jreg
from paddle_tpu.ops import attention_ops, pallas_attention
from paddle_tpu_torch import registry as preg

FP32 = dict(atol=1e-5, rtol=1e-5)
BF16 = dict(atol=1e-2, rtol=1e-2)


def fake_op(op_type, attrs, inputs=None, outputs=None):
    return types.SimpleNamespace(type=op_type, attrs=dict(attrs), op_uid=3,
                                 inputs=inputs or {}, outputs=outputs or {},
                                 forward_op=None)


def to_jax(a, bf16):
    x = jnp.asarray(a)
    return x.astype(jnp.bfloat16) if bf16 else x


def to_torch(a, bf16):
    x = torch.from_numpy(np.ascontiguousarray(a))
    return x.to(torch.bfloat16) if bf16 else x


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.is_floating_point() \
            else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.kind == "V" or \
        x.dtype == jnp.bfloat16 else x


def lower(pkg, op_type, ins, attrs, amp, outputs=None, step=0):
    """Run ``op_type``'s lowering (``<fwd>_grad`` resolved like
    append_backward does) in one package."""
    reg = jreg if pkg == "jax" else preg
    if reg.is_registered(op_type):
        fn = reg.get_op_info(op_type).lowering
    else:
        fn = reg.make_generic_grad_lowering(op_type[:-len("_grad")])
    op = fake_op(op_type, attrs, outputs=outputs)
    if pkg == "jax":
        ctx = jreg.LoweringContext(op, step_key=jax.random.PRNGKey(0),
                                   amp=amp)
    else:
        ctx = preg.LoweringContext(op, step_key=(0, step), amp=amp)
    return fn(ctx, ins)


def compare(op_type, inputs, attrs=None, amp=False, bf16=(), grads=(),
            seed=0):
    """Forward and grad of ``op_type`` in both packages. ``inputs``: slot
    → list of numpy arrays; ``bf16``: slots fed as bf16; ``grads``: input
    slots to differentiate."""
    attrs = attrs or {}
    tol = BF16 if amp or bf16 else FP32
    jins = {s: [to_jax(a, s in bf16) for a in v] for s, v in inputs.items()}
    pins = {s: [to_torch(a, s in bf16) for a in v] for s, v in inputs.items()}
    jout = lower("jax", op_type, jins, attrs, amp)
    pout = lower("port", op_type, pins, attrs, amp)
    for slot in jout:
        for j, (a, b) in enumerate(zip(pout[slot], jout[slot])):
            np.testing.assert_allclose(to_np(a).reshape(np.shape(b)),
                                       to_np(b), err_msg="%s %s[%d]"
                                       % (op_type, slot, j), **tol)
    if not grads:
        return jout, pout
    rng = np.random.RandomState(seed + 1)
    gattrs = dict(attrs, __fwd_input_slots__=list(inputs),
                  __fwd_output_slots__=list(jout), __fwd_op_uid__=3)
    outputs = {s + "@GRAD": ["%s%d@GRAD" % (s, i)
                             for i in range(len(inputs[s]))] for s in grads}
    gnp = {s + "@GRAD": [np.asarray(rng.randn(*np.shape(y)), np.float32)
                         for y in jout[s]] for s in jout}
    jg = dict(jins, **{s: list(v) for s, v in jout.items()})
    pg = dict(pins, **{s: list(v) for s, v in pout.items()})
    for s, gs in gnp.items():
        ys = jout[s[:-len("@GRAD")]]
        jg[s] = [to_jax(g, False).astype(y.dtype) for g, y in zip(gs, ys)]
        pg[s] = [to_torch(g, False).to(x.dtype) for g, x in
                 zip(gs, pout[s[:-len("@GRAD")]])]
    jgrad = lower("jax", op_type + "_grad", jg, gattrs, amp, outputs)
    pgrad = lower("port", op_type + "_grad", pg, gattrs, amp, outputs)
    for slot in outputs:
        for j, (a, b) in enumerate(zip(pgrad[slot], jgrad[slot])):
            assert a.dtype == getattr(torch, str(b.dtype)), (slot, a.dtype)
            np.testing.assert_allclose(to_np(a), to_np(b), err_msg="%s %s[%d]"
                                       % (op_type, slot, j), **tol)
    return jout, pout


def rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp"])
def test_mul(amp):
    compare("mul", {"X": [rand(2, 3, 8)], "Y": [rand(8, 5, seed=1)]},
            {"x_num_col_dims": 2, "y_num_col_dims": 1}, amp=amp,
            grads=("X", "Y"))


@pytest.mark.parametrize("y_shape,axis,bf16", [
    ((2, 3, 4), -1, ()), ((3, 4), 1, ()), ((4,), 2, ()), ((4,), 2, ("X",))],
    ids=["same", "pos-table", "bias", "bf16-x-fp32-bias"])
def test_elementwise_add(y_shape, axis, bf16):
    compare("elementwise_add", {"X": [rand(2, 3, 4)],
                                "Y": [rand(*y_shape, seed=1)]},
            {"axis": axis}, amp=bool(bf16), bf16=bf16, grads=("X", "Y"))


def test_sum_scale_mean():
    xs = [rand(3, 4, seed=i) for i in range(3)]
    compare("sum", {"X": xs}, grads=("X",))
    for after in (True, False):
        compare("scale", {"X": [xs[0]]}, {"scale": 0.5, "bias": 0.25,
                                          "bias_after_scale": after},
                grads=("X",))
    compare("mean", {"X": [xs[1]]}, grads=("X",))


@pytest.mark.parametrize("amp,padding_idx", [(False, -1), (True, -1),
                                             (False, 2)],
                         ids=["fp32", "amp", "padding-idx"])
def test_lookup_table(amp, padding_idx):
    ids = np.array([[1, 2, 9], [0, 2, 2]], np.int32)
    compare("lookup_table", {"W": [rand(10, 4)], "Ids": [ids]},
            {"padding_idx": padding_idx, "is_sparse": False}, amp=amp,
            grads=("W",))


def test_tensor_ops():
    x = rand(2, 3, 4)
    compare("reshape", {"X": [x]}, {"shape": [0, 12]}, grads=("X",))
    compare("reshape", {"X": [x]}, {"shape": [-1, 4]}, grads=("X",))
    compare("split", {"X": [x]}, {"sections": [1, 3], "axis": 2},
            grads=("X",))
    compare("split", {"X": [x]}, {"num": 3, "axis": 1}, grads=("X",))
    compare("slice", {"Input": [rand(5, 4)]},
            {"axes": [0], "starts": [1], "ends": [3]}, grads=("Input",))
    compare("cast", {"X": [x]}, {"in_dtype": "float32",
                                 "out_dtype": "bfloat16"}, grads=("X",))
    for dtype, value in (("float32", 1.5), ("int64", 3)):
        jout, pout = compare("fill_constant", {},
                             {"shape": [2, 3], "dtype": dtype,
                              "value": value})
        assert str(pout["Out"][0].dtype) == "torch." + dtype


@pytest.mark.parametrize("op_type,attrs,mean,std", [
    ("uniform_random", {"min": -0.5, "max": 1.5}, 0.5, 2 / np.sqrt(12)),
    ("gaussian_random", {"mean": 0.25, "std": 2.0}, 0.25, 2.0)])
def test_random_ops_draw_the_same_distribution(op_type, attrs, mean, std):
    attrs = dict(attrs, shape=[200, 100], dtype="float32", seed=0)
    a = to_np(lower("jax", op_type, {}, attrs, False)["Out"][0])
    b = to_np(lower("port", op_type, {}, attrs, False)["Out"][0])
    for x in (a, b):     # 20000 draws: moments within ~4 standard errors
        assert x.shape == (200, 100) and x.dtype == np.float32
        assert abs(x.mean() - mean) < 4 * std / np.sqrt(x.size)
        assert abs(x.std() - std) < 0.03 * std
    if op_type == "uniform_random":
        assert b.min() >= -0.5 and b.max() <= 1.5
    # the stream is fixed by (program seed, step, op uid, call #): the
    # same step draws the same numbers, the next step new ones; a seed
    # attr pins it across steps
    assert np.array_equal(
        to_np(lower("port", op_type, {}, attrs, False)["Out"][0]), b)
    assert not np.array_equal(
        to_np(lower("port", op_type, {}, attrs, False, step=1)["Out"][0]), b)
    pinned = dict(attrs, seed=11)
    assert np.array_equal(
        to_np(lower("port", op_type, {}, pinned, False)["Out"][0]),
        to_np(lower("port", op_type, {}, pinned, False, step=1)["Out"][0]))


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp"])
def test_layer_norm(amp):
    compare("layer_norm", {"X": [rand(2, 3, 8)], "Scale": [rand(8, seed=1)],
                           "Bias": [rand(8, seed=2)]},
            {"epsilon": 1e-5, "begin_norm_axis": 2}, amp=amp,
            bf16=("X",) if amp else (), grads=("X", "Scale", "Bias"))


@pytest.mark.parametrize("approximate", [False, True], ids=["erf", "tanh"])
def test_gelu(approximate):
    compare("gelu", {"X": [rand(4, 16)]}, {"approximate": approximate},
            grads=("X",))


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp"])
def test_softmax_with_cross_entropy(amp):
    label = np.random.RandomState(3).randint(0, 10, (6, 1)).astype(np.int32)
    compare("softmax_with_cross_entropy",
            {"Logits": [rand(6, 10) * 3], "Label": [label]},
            {"soft_label": False}, amp=amp,
            bf16=("Logits",) if amp else (), grads=("Logits",))


def test_optimizer_ops():
    p, g = rand(4, 5), rand(4, 5, seed=1)
    lr = np.array([0.1], np.float32)
    compare("sgd", {"Param": [p], "Grad": [g], "LearningRate": [lr]})
    m1, m2 = rand(4, 5, seed=2) * 0.1, np.abs(rand(4, 5, seed=3)) * 0.01
    compare("adam", {"Param": [p], "Grad": [g], "LearningRate": [lr],
                     "Moment1": [m1], "Moment2": [m2],
                     "Beta1Pow": [np.array([0.9 ** 3], np.float32)],
                     "Beta2Pow": [np.array([0.999 ** 3], np.float32)]},
            {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8})


@pytest.fixture
def reference_saved_path(monkeypatch):
    """The reference's Pallas kernels in interpret mode, with its bshd
    saved-path threshold at 256 (tests/ops/test_fused_attention_saved.py)."""
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(attention_ops, "_use_pallas", lambda *a, **k: True)
    monkeypatch.setattr(pallas_attention, "PALLAS_BWD_MIN_SEQ_BSHD", 256)


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "factored"])
def test_fused_attention(reference_saved_path, amp, masked):
    b, s, h, hkv, d = 2, 256, 4, 2, 32
    ins = {"Q": [rand(b, s, h, d)], "K": [rand(b, s, hkv, d, seed=1)],
           "V": [rand(b, s, hkv, d, seed=2)]}
    if masked:
        valid = np.ones((b, s), np.float32)
        valid[1, 180:] = 0.0
        ins["QValid"] = [valid]
        ins["KValid"] = [valid]
    jout, pout = compare(
        "fused_attention", ins,
        {"causal": True, "layout": "bshd", "scale": 1.0 / np.sqrt(d)},
        amp=amp, grads=("Q", "K", "V"))
    lse = to_np(pout["Lse"][0])
    assert lse.shape == (b * h, s, 8) and np.isfinite(lse).all()
    assert np.abs(to_np(jout["Lse"][0])).max() > 0   # the reference's is real
    if masked:   # padded query rows come out as exact zeros
        assert not to_np(pout["Out"][0])[1, 180:].any()


def test_dense_mask_and_bhsd_inputs_match_the_reference():
    """A dense Mask and the bhsd layout lower and compute the reference's
    Out."""
    rng = np.random.RandomState(5)
    q = rng.randn(1, 8, 2, 4).astype(np.float32)
    mask = rng.rand(1, 1, 8, 8) > 0.3
    base = {"causal": True, "layout": "bshd"}
    for extra, attrs in (({"Mask": [mask]}, base),
                         ({}, dict(base, layout="bhsd"))):
        ins = dict({"Q": [q], "K": [q], "V": [q]}, **extra)
        jout = lower("jax", "fused_attention",
                     {s: [jnp.asarray(a) for a in v] for s, v in ins.items()},
                     attrs, False)
        pout = lower("port", "fused_attention",
                     {s: [torch.from_numpy(a) for a in v]
                      for s, v in ins.items()}, attrs, False)
        np.testing.assert_allclose(to_np(pout["Out"][0]),
                                   to_np(jout["Out"][0]), **FP32)
