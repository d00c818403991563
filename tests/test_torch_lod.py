"""Ragged (LoD) values in the port against the JAX package on the CPU.

``LoDArray`` construction (``from_sequences`` with ``max_len`` and
``pad_to_multiple``, ``to_sequences``, the masks) is held bitwise to the
reference's. Then small programs built the same way in both packages
(``lod_level=1`` data, lengths of 1 and of the full window) run one
step each from the JAX startup program's state (``convert.
scope_from_jax``): feeds given as ``LoDArray`` and as lists of
sequences, ragged fetches, the inferred shapes of every var, and each
ragged op of the NMT path forward and through ``append_backward`` —
``sequence_pool`` in all six pooltypes, ``concat`` on axis 0 and 1,
``mul``/bias add (``fc``), ``tanh``, ``sigmoid``, ``lookup_table`` and
``softmax_with_cross_entropy``. Tolerance: fp32, rel 1e-5 + abs 1e-6
(the two packages sum in other orders); integer outputs and lengths
exactly.
"""

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import unique_name as junique
from paddle_tpu.backward import append_backward as j_append_backward
from paddle_tpu.core import LoDArray as JLoDArray
from paddle_tpu.executor import Scope as JScope
from paddle_tpu.executor import scope_guard as jscope_guard

import paddle_tpu_torch as pfluid
from paddle_tpu_torch import unique_name as punique
from paddle_tpu_torch.backward import append_backward as p_append_backward
from paddle_tpu_torch.convert import scope_from_jax
from paddle_tpu_torch.core import LoDArray as PLoDArray

RTOL, ATOL = 1e-5, 1e-6
# lengths of 1 and of the full window (5) in one batch
LENGTHS = (1, 5, 3, 5)
PKG = {"jax": (jfluid, junique, j_append_backward),
       "port": (pfluid, punique, p_append_backward)}


def ragged(rng, lengths, feat=(), ints=None):
    """Per-sequence arrays: floats, or ints in [1, ints)."""
    if ints:
        return [rng.randint(1, ints, size=(n,) + feat).astype(np.int64)
                for n in lengths]
    return [rng.randn(*((n,) + feat)).astype(np.float32) for n in lengths]


def to_port(feed):
    """A feed for the port: each ragged value as the port's LoDArray."""
    return {k: PLoDArray(v.data, v.length) if isinstance(v, JLoDArray)
            else v for k, v in feed.items()}


def run_both(build, feed, fetch, steps=1, port_feed=None):
    """``build(fluid)`` (under each package's unique-name guard) →
    (prog, startup, extra fetch vars); run ``steps`` steps of each
    package from the JAX startup state and fetch ``fetch`` (names) plus
    the extra vars. Returns ({pkg: [per-step fetch lists]}, programs)."""
    out, progs = {}, {}
    state = None
    for name in ("jax", "port"):
        fluid, unique, _ = PKG[name]
        with unique.guard():
            prog, startup = fluid.Program(), fluid.Program()
            with fluid.program_guard(prog, startup):
                extra = build(fluid)
        progs[name] = prog
        names = list(fetch) + [v.name for v in extra]
        if name == "jax":
            jscope = JScope()
            with jscope_guard(jscope):
                exe = jfluid.Executor(jfluid.TPUPlace())
                exe.run(startup)
                state = {n: np.asarray(v) for n, v in jscope.vars.items()
                         if v is not None}
                out[name] = [exe.run(prog, feed=feed, fetch_list=names)
                             for _ in range(steps)]
        else:
            scope = scope_from_jax(state, device="cpu")
            exe = pfluid.Executor(pfluid.CPUPlace())
            pf = to_port(feed) if port_feed is None else port_feed
            out[name] = [exe.run(prog, feed=pf, fetch_list=names,
                                 scope=scope) for _ in range(steps)]
    return out, progs


def assert_close(got, want, rtol=RTOL, atol=ATOL, what=""):
    """A port fetch against the reference's: LoDArrays field by field
    (lengths exactly; a grad's lengths are JAX's float0 cotangent in the
    reference and the input's lengths in the port), arrays within the
    tolerance (ints exactly)."""
    if isinstance(want, JLoDArray):
        assert isinstance(got, PLoDArray), what
        if np.asarray(want.length).dtype.kind != "V":
            np.testing.assert_array_equal(got.length,
                                          np.asarray(want.length),
                                          err_msg=what)
        got, want = got.data, want.data
    got, want = np.asarray(got), np.asarray(want, dtype=np.asarray(got).dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if got.dtype.kind in "iub":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=what)


def assert_runs_close(out, names, **tol):
    for step, (j, p) in enumerate(zip(out["jax"], out["port"])):
        for n, a, b in zip(names, p, j):
            assert_close(a, b, what="step %d %s" % (step, n), **tol)


# -- LoDArray -----------------------------------------------------------------

@pytest.mark.parametrize("max_len,multiple", [(None, None), (9, None),
                                              (None, 4), (3, 8), (None, 1)])
@pytest.mark.parametrize("feat", [(), (3,)])
def test_lod_array_construction_bitwise(max_len, multiple, feat):
    rng = np.random.RandomState(0)
    seqs = ragged(rng, LENGTHS, feat)
    want = JLoDArray.from_sequences(seqs, max_len=max_len,
                                    pad_to_multiple=multiple)
    got = PLoDArray.from_sequences(seqs, max_len=max_len,
                                   pad_to_multiple=multiple)
    assert got.data.dtype == want.data.dtype
    assert got.length.dtype == want.length.dtype
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.length, want.length)
    assert got.shape == tuple(want.shape) and got.max_len == want.max_len
    assert got.batch == want.batch
    for a, b in zip(got.to_sequences(), want.to_sequences()):
        np.testing.assert_array_equal(a, b)
    import torch
    tl = PLoDArray(torch.from_numpy(got.data), torch.from_numpy(got.length))
    np.testing.assert_array_equal(tl.mask().numpy(),
                                  np.asarray(want.mask()))
    np.testing.assert_array_equal(tl.bool_mask().numpy(),
                                  np.asarray(want.bool_mask()))
    for a, b in zip(tl.to_sequences(), want.to_sequences()):
        np.testing.assert_array_equal(a, b)


def test_lod_array_int_ids_and_empty_batch_bitwise():
    ids = [np.array([3, 1, 4], np.int32), np.array([1], np.int32)]
    for kw in ({}, {"dtype": np.int64}, {"max_len": 6, "dtype": np.int32}):
        want = JLoDArray.from_sequences(ids, **kw)
        got = PLoDArray.from_sequences(ids, **kw)
        assert got.data.dtype == want.data.dtype
        np.testing.assert_array_equal(got.data, want.data)
        np.testing.assert_array_equal(got.length, want.length)
    want, got = JLoDArray.from_sequences([]), PLoDArray.from_sequences([])
    assert got.data.shape == want.data.shape and got.data.dtype == \
        want.data.dtype


def test_lod_array_is_a_pytree_node():
    import torch
    import torch.utils._pytree as pytree
    x = PLoDArray(torch.ones(2, 3), torch.tensor([1, 3], dtype=torch.int32))
    leaves, spec = pytree.tree_flatten({"a": [x]})
    assert len(leaves) == 2
    y = pytree.tree_map(lambda t: t * 2, {"a": [x]})["a"][0]
    assert isinstance(y, PLoDArray)
    assert torch.equal(y.data, x.data * 2)
    assert pfluid.Tensor is PLoDArray and pfluid.LoDTensor is PLoDArray


def test_lod_level_two_raises_naming_it():
    with punique.guard():
        prog = pfluid.Program()
        with pfluid.program_guard(prog, pfluid.Program()):
            with pytest.raises(NotImplementedError, match="lod_level 2"):
                pfluid.layers.data(name="x", shape=[3], lod_level=2)


# -- feeds, fetches, shapes ---------------------------------------------------

def _fc_net(fluid, act="tanh"):
    x = fluid.layers.data(name="x", shape=[3], dtype="float32",
                          lod_level=1)
    y = fluid.layers.fc(input=x, size=4, act=act)
    return [y]


@pytest.mark.parametrize("as_list,act", [(False, "tanh"), (True, "tanh"),
                                         (False, "softmax")])
def test_ragged_feed_and_fetch(as_list, act):
    rng = np.random.RandomState(1)
    seqs = ragged(rng, LENGTHS, (3,))
    feed = {"x": seqs if as_list else JLoDArray.from_sequences(seqs)}
    out, progs = run_both(lambda fluid: _fc_net(fluid, act), feed, [],
                          port_feed={"x": seqs} if as_list else None)
    (j,), (p,) = out["jax"][0], out["port"][0]
    assert isinstance(p, PLoDArray) and isinstance(p.data, np.ndarray)
    assert p.length.dtype == np.int32
    assert_close(p, j)
    # the fetch is the caller's own copy, as the reference's
    assert [s.shape for s in p.to_sequences()] == \
        [(n, 4) for n in LENGTHS]


def test_ragged_fetch_handle_copies():
    rng = np.random.RandomState(2)
    feed = {"x": PLoDArray.from_sequences(ragged(rng, LENGTHS, (3,)))}
    with punique.guard():
        prog, startup = pfluid.Program(), pfluid.Program()
        with pfluid.program_guard(prog, startup):
            (y,) = _fc_net(pfluid)
    exe = pfluid.Executor(pfluid.CPUPlace())
    scope = pfluid.Scope()
    exe.run(startup, scope=scope)
    h = exe.run(prog, feed=feed, fetch_list=[y], scope=scope,
                return_numpy=False)
    (a,), (b,) = h.numpy(), h.numpy()
    assert isinstance(a, PLoDArray) and a.data is not b.data
    a.data[:] = 0
    assert np.abs(h.numpy()[0].data).sum() > 0
    (c,) = exe.run(prog, feed=feed, fetch_list=[y], scope=scope)
    np.testing.assert_array_equal(c.data, b.data)


def _shape_net(fluid):
    """Every ragged op of the NMT path (and the other pooltypes)."""
    ids = fluid.layers.data(name="ids", shape=[1], dtype="int64",
                            lod_level=1)
    lbl = fluid.layers.data(name="lbl", shape=[1], dtype="int64",
                            lod_level=1)
    emb = fluid.layers.embedding(input=ids, size=[20, 6])
    a = fluid.layers.fc(input=emb, size=8, act="sigmoid")
    h, _ = fluid.layers.dynamic_lstm(input=a, size=8)
    hr, _ = fluid.layers.dynamic_lstm(input=a, size=8, is_reverse=True,
                                      use_peepholes=False)
    c1 = fluid.layers.concat(input=[h, hr], axis=1)
    c0 = fluid.layers.concat(input=[h, hr], axis=0)
    pools = [fluid.layers.sequence_pool(c1, t) for t in
             ("sum", "average", "sqrt", "max", "first", "last")]
    logits = fluid.layers.fc(input=c1, size=20)
    cost = fluid.layers.softmax_with_cross_entropy(logits, lbl)
    loss = fluid.layers.mean(fluid.layers.sequence_pool(cost, "sum"))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return [c0] + pools


def test_shape_inference_of_ragged_vars():
    def shapes(fluid, unique):
        with unique.guard():
            prog = fluid.Program()
            with fluid.program_guard(prog, fluid.Program()):
                _shape_net(fluid)
        return {n: (v.shape, v.dtype, v.lod_level)
                for n, v in prog.global_block().vars.items()
                if v.shape is not None}
    want = shapes(jfluid, junique)
    got = shapes(pfluid, punique)
    assert set(got) == set(want)
    differ = {n: (got[n], want[n]) for n in want
              if (list(got[n][0]), got[n][1], got[n][2]) !=
              (list(want[n][0]), str(want[n][1]), want[n][2])}
    assert not differ, differ
    assert got["concat_0.tmp_0"][2] == 1 and got["lstm_0.tmp_0"][2] == 1
    assert got["sequence_pool_0.tmp_0"] == ([-1, 4], "float32", 0)


# -- ops forward and through append_backward ----------------------------------

POOLTYPES = ("SUM", "AVERAGE", "SQRT", "MAX", "FIRST", "LAST")


def _pool_net(ptype):
    def build(fluid):
        _, _, append_backward = PKG["jax" if fluid is jfluid else "port"]
        x = fluid.layers.data(name="x", shape=[3], dtype="float32",
                              lod_level=1, stop_gradient=False)
        y = fluid.layers.fc(input=x, size=4, act="tanh")
        pooled = fluid.layers.sequence_pool(y, ptype)
        loss = fluid.layers.mean(pooled)
        append_backward(loss)
        return [y, pooled, loss]
    return build


@pytest.mark.parametrize("ptype", POOLTYPES)
def test_sequence_pool_forward_and_grads(ptype):
    rng = np.random.RandomState(3)
    feed = {"x": JLoDArray.from_sequences(ragged(rng, LENGTHS, (3,)))}
    names = ["x@GRAD", "fc_0.w_0@GRAD", "fc_0.b_0@GRAD"]
    out, _ = run_both(_pool_net(ptype), feed, names)
    assert_runs_close(out, names + ["y", "pooled", "loss"])
    x_grad = out["port"][0][0]
    # padding gets no grad
    assert not x_grad.data[0, 1:].any()


def test_sequence_pool_max_index():
    """MAX's MaxIndex output (no grad flows through it) through both
    lowerings."""
    import types
    import torch
    from paddle_tpu.registry import LoweringContext as JCtx
    from paddle_tpu.registry import get_op_info as jinfo
    from paddle_tpu_torch import registry
    rng = np.random.RandomState(4)
    la = PLoDArray.from_sequences(ragged(rng, LENGTHS, (3,)))
    op = types.SimpleNamespace(type="sequence_pool", op_uid=1,
                               attrs={"pooltype": "MAX"}, inputs={},
                               outputs={}, forward_op=None)
    x = PLoDArray(torch.from_numpy(la.data), torch.from_numpy(la.length))
    outs = registry.get_op_info("sequence_pool").lowering(
        registry.LoweringContext(op), {"X": [x]})
    jouts = jinfo("sequence_pool").lowering(
        JCtx(op), {"X": [JLoDArray(la.data, la.length)]})
    np.testing.assert_array_equal(outs["MaxIndex"][0].numpy(),
                                  np.asarray(jouts["MaxIndex"][0]))
    np.testing.assert_allclose(outs["Out"][0].numpy(),
                               np.asarray(jouts["Out"][0]), rtol=RTOL)


def _concat_net(axis):
    def build(fluid):
        _, _, append_backward = PKG["jax" if fluid is jfluid else "port"]
        a = fluid.layers.data(name="a", shape=[3], dtype="float32",
                              lod_level=1, stop_gradient=False)
        b = fluid.layers.data(name="b", shape=[3], dtype="float32",
                              lod_level=1, stop_gradient=False)
        fa = fluid.layers.fc(input=a, size=2, act="sigmoid")
        fb = fluid.layers.fc(input=b, size=2, act="tanh")
        c = fluid.layers.concat(input=[fa, fb], axis=axis)
        loss = fluid.layers.mean(fluid.layers.sequence_pool(c, "sqrt"))
        append_backward(loss)
        return [c, loss]
    return build


@pytest.mark.parametrize("axis", [0, 1])
def test_concat_forward_and_grads(axis):
    rng = np.random.RandomState(5)
    la = LENGTHS
    lb = LENGTHS if axis == 1 else (6, 2)     # axis 0: another max_len
    feed = {"a": JLoDArray.from_sequences(ragged(rng, la, (3,))),
            "b": JLoDArray.from_sequences(ragged(rng, lb, (3,)))}
    names = ["a@GRAD", "b@GRAD", "fc_0.w_0@GRAD", "fc_1.w_0@GRAD"]
    out, _ = run_both(_concat_net(axis), feed, names)
    assert_runs_close(out, names + ["c", "loss"])
    c = out["port"][0][len(names)]
    assert c.data.shape == ((4, 5, 4) if axis == 1 else (6, 6, 2))


def _nmt_ops_net(fluid):
    """Embedding on ragged ids, fc with a bias (mul + elementwise_add),
    sigmoid, softmax_with_cross_entropy on ragged logits and labels, the
    SUM pool, and an embedding read twice (the grads' ``sum``)."""
    _, _, append_backward = PKG["jax" if fluid is jfluid else "port"]
    ids = fluid.layers.data(name="ids", shape=[1], dtype="int64",
                            lod_level=1)
    lbl = fluid.layers.data(name="lbl", shape=[1], dtype="int64",
                            lod_level=1)
    emb = fluid.layers.embedding(input=ids, size=[11, 4])
    h1 = fluid.layers.fc(input=emb, size=6, act="sigmoid")
    h2 = fluid.layers.fc(input=emb, size=6, act="tanh")
    logits = fluid.layers.fc(input=fluid.layers.concat([h1, h2], axis=1),
                             size=11)
    cost = fluid.layers.softmax_with_cross_entropy(logits, lbl)
    loss = fluid.layers.mean(fluid.layers.sequence_pool(cost, "sum"))
    append_backward(loss)
    return [emb, logits, cost, loss]


def test_ragged_math_ops_forward_and_grads():
    rng = np.random.RandomState(6)
    feed = {"ids": JLoDArray.from_sequences(ragged(rng, LENGTHS, ints=11)),
            "lbl": JLoDArray.from_sequences(ragged(rng, LENGTHS, ints=11))}
    names = ["embedding_0.w_0@GRAD", "fc_0.w_0@GRAD", "fc_0.b_0@GRAD",
             "fc_1.w_0@GRAD", "fc_2.w_0@GRAD", "fc_2.b_0@GRAD"]
    out, progs = run_both(_nmt_ops_net, feed, names)
    assert_runs_close(out, names + ["emb", "logits", "cost", "loss"])
    # the padding tokens' ids (0, a row no real token reads) add nothing
    # to the table's grad
    assert not out["port"][0][0][0].any()
    ops = [op.type for op in progs["port"].global_block().ops]
    assert "sum" in ops and "lookup_table_grad" in ops
