"""Ragged values (``core.LoDArray``) through the lowerings that pass them
through, against the JAX package on the CPU.

Each op on a ragged input with one sequence of length 1 and one filling
the window, in both packages' lowerings on the same numpy inputs:
``mean`` averages the valid tokens only — bit for bit in fp32, and in
bf16 with its count kept in fp32 (301 valid tokens of 1.0 average to
exactly 1.0, where a bf16 count would not); ``scale``, ``cast``,
``dropout`` (test mode bit for bit; training: ``Out = X * Mask`` with
the lengths kept, the mask dense), ``relu`` and ``gelu`` keep the
lengths; ``layer_norm`` normalizes the padded data and returns a dense
``Y``, as the reference does. The ``mean`` cases feed dyadic values
(their fp32 sums are exact in any order), so bit for bit holds the
valid-token rule, not the summation order; random values agree within
2 fp32 ulps. The other ops: bit for bit, except ``gelu`` and
``layer_norm`` (1e-6 relative: erf and the fp32 statistics of two
libraries). Then a program on a ``lod_level=1`` var fed two sequences
(lengths 2 and 3 of 4 features) in both packages, forward and one SGD
step; and an op without a pass-through refuses a ragged input by name.
"""

from tests import torch_threads  # noqa: F401  (first)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jfluid
from paddle_tpu import unique_name as junique
from paddle_tpu.core import LoDArray as JLoD
from paddle_tpu.executor import Scope as JScope
from paddle_tpu.executor import global_scope as jglobal_scope
from paddle_tpu.executor import scope_guard as jscope_guard

import paddle_tpu_torch as pfluid
from paddle_tpu_torch import unique_name as punique
from paddle_tpu_torch.convert import scope_from_jax
from paddle_tpu_torch.core import LoDArray

from test_torch_train_ops import lower

LENGTHS = np.array([1, 6], np.int32)        # one token; the full window


def ragged(data, dtype="float32"):
    """(jax LoDArray, port LoDArray) of numpy ``data`` [2, 6, ...]."""
    jd = jnp.asarray(data).astype(getattr(jnp, dtype))
    pd = torch.from_numpy(np.ascontiguousarray(data)).to(getattr(torch,
                                                                dtype))
    return (JLoD(jd, jnp.asarray(LENGTHS)),
            LoDArray(pd, torch.from_numpy(LENGTHS.copy())))


def np32(v):
    if isinstance(v, torch.Tensor):
        return v.detach().float().numpy()
    return np.asarray(jnp.asarray(v).astype(jnp.float32))


def run(op_type, x, attrs, amp=False):
    jx, px = x
    return (lower("jax", op_type, {"X": [jx]}, attrs, amp),
            lower("port", op_type, {"X": [px]}, attrs, amp))


def assert_ragged_out(jv, pv, exact=True):
    assert isinstance(pv, LoDArray), type(pv)
    np.testing.assert_array_equal(pv.length.numpy(), np.asarray(jv.length))
    assert pv.data.dtype == getattr(torch, str(jv.data.dtype))
    if exact:
        np.testing.assert_array_equal(np32(pv.data), np32(jv.data))
    else:
        np.testing.assert_allclose(np32(pv.data), np32(jv.data), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("feat", [(), (4,)], ids=["tokens", "features"])
def test_mean_of_ragged_is_the_valid_token_mean_bitwise(feat):
    rng = np.random.RandomState(0)
    data = (rng.randint(-64, 65, (2, 6) + feat) / 16).astype(np.float32)
    jout, pout = run("mean", ragged(data), {})
    got, want = pout["Out"][0], jout["Out"][0]
    np.testing.assert_array_equal(np32(got), np32(want))
    # the padding does not dilute it
    valid = np.concatenate([data[0, :1].ravel(), data[1].ravel()])
    np.testing.assert_allclose(np32(got), valid.mean(), rtol=1e-6)
    # random values: within 2 fp32 ulps (another summation order)
    data = rng.randn(2, 6, *feat).astype(np.float32)
    jout, pout = run("mean", ragged(data), {})
    np.testing.assert_allclose(np32(pout["Out"][0]), np32(jout["Out"][0]),
                               rtol=2.4e-7)


def test_mean_of_ragged_bf16_counts_in_fp32():
    rng = np.random.RandomState(1)
    data = (rng.randint(-64, 65, (2, 6, 4)) / 16).astype(np.float32)
    jout, pout = run("mean", ragged(data, "bfloat16"), {})
    got = pout["Out"][0]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(np32(got), np32(jout["Out"][0]))
    # 301 valid tokens of 1.0 (a bf16 count would be 300 or 302)
    lens = np.array([1, 300], np.int32)
    ones = np.ones((2, 300), np.float32)
    ones[0, 1:] = 7.0                                   # padding
    x = LoDArray(torch.from_numpy(ones).to(torch.bfloat16),
                 torch.from_numpy(lens))
    out = lower("port", "mean", {"X": [x]}, {}, False)["Out"][0]
    assert float(out) == 1.0
    jx = JLoD(jnp.asarray(ones).astype(jnp.bfloat16), jnp.asarray(lens))
    assert float(lower("jax", "mean", {"X": [jx]}, {}, False)["Out"][0]) \
        == 1.0


@pytest.mark.parametrize("op_type,attrs,dtype", [
    ("scale", {"scale": 2.5, "bias": -1.0}, "float32"),
    ("scale", {"scale": 0.5, "bias": 3.0, "bias_after_scale": False},
     "bfloat16"),
    ("cast", {"out_dtype": "bfloat16"}, "float32"),
    ("cast", {"out_dtype": "float32"}, "bfloat16"),
    ("relu", {}, "float32"),
    ("relu", {}, "bfloat16"),
    ("dropout", {"dropout_prob": 0.3, "is_test": True}, "float32"),
    ("gelu", {"approximate": False}, "float32"),
], ids=["scale", "scale-before-bf16", "cast-bf16", "cast-fp32", "relu",
        "relu-bf16", "dropout-test", "gelu"])
def test_pass_through_keeps_the_lengths(op_type, attrs, dtype):
    rng = np.random.RandomState(2)
    data = rng.randn(2, 6, 4).astype(np.float32)
    jout, pout = run(op_type, ragged(data, dtype), attrs)
    assert_ragged_out(jout["Out"][0], pout["Out"][0],
                      exact=op_type != "gelu")
    if op_type == "dropout":
        np.testing.assert_array_equal(np32(pout["Mask"][0]),
                                      np32(jout["Mask"][0]))


def test_dropout_training_keeps_the_lengths():
    """The masks are each package's own draws: Out = X * Mask, the
    lengths kept, the mask dense; its grad keeps the lengths too."""
    rng = np.random.RandomState(3)
    _, px = ragged(rng.randn(2, 6, 32).astype(np.float32))
    out = lower("port", "dropout", {"X": [px]}, {"dropout_prob": 0.5}, False)
    o, mask = out["Out"][0], out["Mask"][0]
    assert isinstance(o, LoDArray) and isinstance(mask, torch.Tensor)
    np.testing.assert_array_equal(o.length.numpy(), LENGTHS)
    np.testing.assert_array_equal(o.data.numpy(),
                                  (px.data * mask).numpy())
    assert 0.3 < float(mask.mean()) < 0.7
    g = LoDArray(torch.ones_like(px.data), px.length)
    dx = lower("port", "dropout_grad", {"X": [px], "Mask": [mask],
                                        "Out@GRAD": [g]}, {}, False,
               {"X@GRAD": ["x@GRAD"]})["X@GRAD"][0]
    assert isinstance(dx, LoDArray)
    np.testing.assert_array_equal(dx.data.numpy(), mask.numpy())


@pytest.mark.parametrize("begin", [1, 2])
def test_layer_norm_of_ragged_returns_a_dense_y(begin):
    rng = np.random.RandomState(4)
    x = ragged(rng.randn(2, 6, 8).astype(np.float32))
    shape = 6 * 8 if begin == 1 else 8
    ins = {"Scale": (1 + 0.1 * rng.randn(shape)).astype(np.float32),
           "Bias": (0.1 * rng.randn(shape)).astype(np.float32)}
    attrs = {"begin_norm_axis": begin, "epsilon": 1e-5}
    jout = lower("jax", "layer_norm", {"X": [x[0]], **{
        s: [jnp.asarray(v)] for s, v in ins.items()}}, attrs, False)
    pout = lower("port", "layer_norm", {"X": [x[1]], **{
        s: [torch.from_numpy(v)] for s, v in ins.items()}}, attrs, False)
    for s in ("Y", "Mean", "Variance"):
        got, want = pout[s][0], jout[s][0]
        assert isinstance(got, torch.Tensor) and not isinstance(want, JLoD)
        np.testing.assert_allclose(np32(got), np32(want), rtol=1e-6,
                                   atol=1e-6)


def _program(fluid, unique):
    """A ``lod_level=1`` var of 4 features through the repaired ops, and
    an fc + mean loss trained by SGD."""
    with unique.guard():
        prog, startup = fluid.Program(), fluid.Program()
        prog.random_seed = startup.random_seed = 3
        with fluid.program_guard(prog, startup):
            x = fluid.layers.data(name="x", shape=[4], dtype="float32",
                                  lod_level=1)
            s = fluid.layers.scale(x, scale=2.0, bias=0.5)
            r = fluid.layers.relu(fluid.layers.gelu(s))
            d = fluid.layers.dropout(r, dropout_prob=0.25, is_test=True)
            c = fluid.layers.cast(d, "float32")
            h = fluid.layers.fc(input=c, size=3, act="tanh")
            loss = fluid.layers.mean(h)
            plain = fluid.layers.mean(x)
            fluid.optimizer.SGD(learning_rate=0.5).minimize(loss)
    return prog, startup, [loss, plain, d]


def test_ragged_program_matches_the_reference():
    seqs = [np.arange(8, dtype=np.float32).reshape(2, 4) / 8 - 0.3,
            np.arange(12, dtype=np.float32).reshape(3, 4) / 12 - 0.4]
    jprog, jstart, jf = _program(jfluid, junique)
    pprog, _, pf = _program(pfluid, punique)
    assert [op.type for op in pprog.global_block().ops] == \
        [op.type for op in jprog.global_block().ops]
    with jscope_guard(JScope()):
        exe = jfluid.Executor(jfluid.TPUPlace())
        exe.run(jstart)
        state = {n: np.asarray(v) for n, v in jglobal_scope().vars.items()}
        jr = [exe.run(jprog, feed={"x": seqs}, fetch_list=jf)
              for _ in range(2)]
    scope = scope_from_jax(state, device="cpu")
    exe = pfluid.Executor(pfluid.CPUPlace())
    pr = [exe.run(pprog, feed={"x": seqs}, fetch_list=pf, scope=scope)
          for _ in range(2)]
    for (jl, jm, jd), (pl, pm, pd) in zip(jr, pr):
        np.testing.assert_allclose(pl, np.asarray(jl), rtol=1e-6)
        np.testing.assert_array_equal(pm, np.asarray(jm))
        np.testing.assert_allclose(pm, np.concatenate(seqs).mean(),
                                   rtol=1e-6)
        assert isinstance(pd, LoDArray)
        np.testing.assert_array_equal(pd.length, [2, 3])
        np.testing.assert_allclose(pd.data, np.asarray(jd.data), rtol=1e-6,
                                   atol=1e-7)
    # the SGD step moved the loss the same way
    assert float(pr[1][0]) != float(pr[0][0])


def test_an_op_without_a_pass_through_refuses_ragged_input_by_name():
    with punique.guard():
        prog, startup = pfluid.Program(), pfluid.Program()
        with pfluid.program_guard(prog, startup):
            x = pfluid.layers.data(name="x", shape=[4], dtype="float32",
                                   lod_level=1)
            y = pfluid.layers.transpose(x, perm=[1, 0])
    exe = pfluid.Executor(pfluid.CPUPlace())
    with pytest.raises(NotImplementedError,
                       match="'transpose'.*ragged"):
        exe.run(prog, feed={"x": [np.ones((2, 4), np.float32)]},
                fetch_list=[y])
