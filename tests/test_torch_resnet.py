"""The port's ResNet training path against the JAX package on the CPU.

Op by op, each through both packages' registries on the same numpy
inputs from a seed (the helpers of ``test_torch_train_ops``): ``conv2d``
(NCHW and NHWC; stride 1 and 2; padding 0, 1 and 3; dilation 2; groups
1 and 2) with its analytic ``conv2d_grad``, held against the reference's
grad and against the port's own generic vjp; ``pool2d`` (max and avg,
``exclusive`` on and off, padding, global pooling, both layouts) and
its generic grad; ``batch_norm`` in training and test, both layouts,
with a running mean away from the batch mean, and its grad (also
through ``append_backward`` in a one-op program); ``relu``
with its analytic grad, ``softmax``, ``cross_entropy`` (hard and soft
labels) and ``momentum`` with and without Nesterov.

Then the slice as a whole, as ``test_torch_train.run_both`` runs the LM:
one build script through both packages (names, dtypes and op types
asserted equal), the JAX startup state carried into the port with
``convert.scope_from_jax``, then training steps under
``Momentum(0.01, 0.9)`` in each. Case A: ``resnet_imagenet(depth=50,
class_dim=10)`` in NHWC at batch 4 and 64x64 images (the last stage
normalizes each channel over 4 x 2 x 2 = 16 values), 2 steps in fp32
and under amp. Case B: ``depth=18`` in NCHW, 1 fp32 step. The port's
``run_steps(n_steps=2)`` on the CPU equals two ``run()`` calls bit for
bit.

Tolerances:
- conv2d forward, and its grads against the reference's and against the
  generic vjp: 1e-5 relative L2 (summation order only).
- pool2d, batch_norm, softmax: 1e-5 absolute + 1e-5 relative, as the
  training ops' test holds fp32 ops (other summation orders).
- relu, relu_grad, momentum: bit for bit (elementwise arithmetic in the
  reference's order). cross_entropy: within 2 float32 ulps
  (rtol 2.4e-7): a log, whose two libm implementations may round the
  last bit apart.
- Whole model, fp32: per-step losses within 1e-4 relative, and each
  persistable's update (final − start) within 1e-3 relative L2 of the
  reference's; amp: losses within 5e-3, updates within 0.1. Case B and
  a one-block-a-stage bottleneck stack (``one_block_stack``, the same
  layer code as depth 50) hold the fp32 ones over their steps. Case A
  cannot: at 16 values a channel its training is chaotic in either
  package, so its steps are compared one at a time, each from the
  reference's state, at wider tolerances; the amp cases are wider
  again, because the reference keeps bf16 values unrounded inside XLA
  fusions. Each test's docstring gives its tolerance, the measured
  error and the measurement behind the widening. A persistable the
  reference leaves unchanged must be unchanged in the port.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import models as jmodels
from paddle_tpu import unique_name as junique
from paddle_tpu.executor import Scope as JScope
from paddle_tpu.executor import scope_guard as jscope_guard

import paddle_tpu_torch as pfluid
from paddle_tpu_torch import executor as pexecutor
from paddle_tpu_torch import models as pmodels
from paddle_tpu_torch import registry as preg
from paddle_tpu_torch import unique_name as punique
from paddle_tpu_torch.convert import scope_from_jax
from paddle_tpu_torch.flops import estimate_program_flops

from test_torch_train_ops import compare, fake_op, lower, rand, to_jax, \
    to_np, to_torch


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


# -- conv2d -------------------------------------------------------------------

CONV_CASES = {           # (stride, padding, dilation, groups, kernel)
    "s1-p0": (1, 0, 1, 1, 3),
    "s2-p1": (2, 1, 1, 1, 3),
    "s2-p3-k7": (2, 3, 1, 1, 7),
    "dil2-p1": (1, 1, 2, 1, 3),
    "groups2-s2-p1": (2, 1, 1, 2, 3),
    "1x1-s2": (2, 0, 1, 1, 1),
}


def conv_inputs(fmt, groups, k, seed=0):
    x = rand(2, 4, 11, 11, seed=seed)
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    return {"Input": [x], "Filter": [rand(6, 4 // groups, k, k,
                                          seed=seed + 1)]}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_conv2d_and_its_analytic_grad(fmt, case):
    stride, pad, dil, groups, k = CONV_CASES[case]
    attrs = {"strides": [stride] * 2, "paddings": [pad] * 2,
             "dilations": [dil] * 2, "groups": groups, "data_format": fmt}
    inputs = conv_inputs(fmt, groups, k)
    jins = {s: [to_jax(a, False) for a in v] for s, v in inputs.items()}
    pins = {s: [to_torch(a, False) for a in v] for s, v in inputs.items()}
    jout = lower("jax", "conv2d", jins, attrs, False)["Output"][0]
    pout = lower("port", "conv2d", pins, attrs, False)["Output"][0]
    assert tuple(pout.shape) == tuple(jout.shape)
    assert rel_l2(to_np(pout), to_np(jout)) <= 1e-5
    g = rand(*pout.shape, seed=5)
    gattrs = dict(attrs, __fwd_input_slots__=["Input", "Filter"],
                  __fwd_output_slots__=["Output"], __fwd_op_uid__=3)
    outputs = {"Input@GRAD": ["x@GRAD"], "Filter@GRAD": ["w@GRAD"]}
    jg = lower("jax", "conv2d_grad", dict(
        jins, Output=[jout], **{"Output@GRAD": [to_jax(g, False)]}),
        gattrs, False, outputs)
    pg_ins = dict(pins, Output=[pout], **{"Output@GRAD": [to_torch(g,
                                                                   False)]})
    analytic = lower("port", "conv2d_grad", pg_ins, gattrs, False, outputs)
    generic = preg.make_generic_grad_lowering("conv2d")(
        preg.LoweringContext(fake_op("conv2d_grad", gattrs,
                                     outputs=outputs)), pg_ins)
    for slot in outputs:
        got = to_np(analytic[slot][0])
        assert rel_l2(got, to_np(jg[slot][0])) <= 1e-5, slot
        assert rel_l2(got, to_np(generic[slot][0])) <= 1e-5, slot


def test_conv2d_grad_emits_only_the_grads_asked_for():
    attrs = {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1],
             "groups": 1, "data_format": "NHWC"}
    inputs = conv_inputs("NHWC", 1, 3)
    pins = {s: [to_torch(a, False) for a in v] for s, v in inputs.items()}
    out = lower("port", "conv2d", pins, attrs, False)["Output"][0]
    gattrs = dict(attrs, __fwd_input_slots__=["Input", "Filter"],
                  __fwd_output_slots__=["Output"], __fwd_op_uid__=3)
    got = lower("port", "conv2d_grad",
                dict(pins, Output=[out],
                     **{"Output@GRAD": [torch.ones_like(out)]}),
                gattrs, False, {"Filter@GRAD": ["w@GRAD"]})
    assert set(got) == {"Filter@GRAD"}
    assert got["Filter@GRAD"][0].shape == pins["Filter"][0].shape


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_conv2d_under_amp_is_bf16_out_with_fp32_filter_grads(fmt):
    attrs = {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1],
             "groups": 1, "data_format": fmt}
    jout, pout = compare("conv2d", conv_inputs(fmt, 1, 3), attrs, amp=True,
                         grads=("Input", "Filter"))
    assert pout["Output"][0].dtype == torch.bfloat16
    assert str(jout["Output"][0].dtype) == "bfloat16"


# -- pool2d -------------------------------------------------------------------

POOL_CASES = {
    "max-k3-s2-p1": dict(pooling_type="max", ksize=[3, 3], strides=[2, 2],
                         paddings=[1, 1]),
    "max-k2-s2": dict(pooling_type="max", ksize=[2, 2], strides=[2, 2],
                      paddings=[0, 0]),
    "avg-exclusive-p1": dict(pooling_type="avg", ksize=[3, 3],
                             strides=[2, 2], paddings=[1, 1],
                             exclusive=True),
    "avg-inclusive-p1": dict(pooling_type="avg", ksize=[3, 3],
                             strides=[1, 1], paddings=[1, 1],
                             exclusive=False),
    "avg-k2": dict(pooling_type="avg", ksize=[2, 2], strides=[2, 2],
                   paddings=[0, 0]),
    "avg-global": dict(pooling_type="avg", ksize=[1, 1],
                       global_pooling=True),
    "max-global": dict(pooling_type="max", ksize=[1, 1],
                       global_pooling=True),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_pool2d(fmt, case):
    x = rand(2, 3, 9, 9) if fmt == "NCHW" else rand(2, 9, 9, 3)
    compare("pool2d", {"X": [x]}, dict(POOL_CASES[case], data_format=fmt),
            grads=("X",))


# -- batch_norm ---------------------------------------------------------------

@pytest.mark.parametrize("is_test", [False, True], ids=["train", "test"])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_batch_norm(layout, is_test):
    c = 5
    shape = (4, c, 3, 3) if layout == "NCHW" else (4, 3, 3, c)
    x = rand(*shape) * 3.0 + 2.0
    ins = {"X": [x], "Scale": [1.0 + 0.1 * rand(c, seed=1)],
           "Bias": [0.1 * rand(c, seed=2)],
           "Mean": [0.5 * rand(c, seed=3)],
           "Variance": [1.0 + 0.2 * np.abs(rand(c, seed=4))]}
    jout, pout = compare("batch_norm", ins,
                         {"epsilon": 1e-5, "momentum": 0.9,
                          "is_test": is_test, "data_layout": layout},
                         grads=("X", "Scale", "Bias"))
    assert sorted(pout) == sorted(jout) == [
        "MeanOut", "SavedMean", "SavedVariance", "VarianceOut", "Y"]
    moved = not np.allclose(to_np(pout["MeanOut"][0]), ins["Mean"][0])
    assert moved != is_test


def bn_program(fluid, unique, layout):
    """data → batch_norm → mean, with ``append_backward``: a one-op
    program whose grads and moving statistics both packages compute."""
    shape = [5, 3, 3] if layout == "NCHW" else [3, 3, 5]
    with unique.guard():
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            x = fluid.layers.data(name="x", shape=shape, dtype="float32",
                                  stop_gradient=False)
            y = fluid.layers.batch_norm(x, data_layout=layout,
                                        moving_mean_name="mm",
                                        moving_variance_name="mv")
            loss = fluid.layers.mean(fluid.layers.elementwise_add(y, x))
            fluid.append_backward(loss)
    grads = sorted(n for n in prog.global_block().vars
                   if n.endswith("@GRAD") and "tmp" not in n)
    return prog, startup, loss, grads


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_batch_norm_grad_via_append_backward(layout):
    """The same one-op program in both packages, the port from the JAX
    startup state: the grads of x, Scale and Bias and the moving
    statistics within 1e-5 (fp32, other summation orders)."""
    jprog, jstart, jloss, jgrads = bn_program(jfluid, junique, layout)
    pprog, pstart, ploss, pgrads = bn_program(pfluid, punique, layout)
    assert jgrads == pgrads and "x@GRAD" in pgrads
    assert [op.type for op in jprog.global_block().ops] == \
        [op.type for op in pprog.global_block().ops]
    x = rand(4, 5, 3, 3) * 3.0 + 2.0
    if layout == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    fetch = [jloss.name] + jgrads + ["mm", "mv"]
    with jscope_guard(JScope()):
        jexe = jfluid.Executor(jfluid.TPUPlace())
        jexe.run(jstart)
        state = {n: np.asarray(jfluid.global_scope().find_var(n))
                 for n in ("mm", "mv", "batch_norm_0.w_0",
                           "batch_norm_0.b_0")}
        want = jexe.run(jprog, feed={"x": x}, fetch_list=fetch)
    got = pfluid.Executor(pfluid.CPUPlace()).run(
        pprog, feed={"x": x}, fetch_list=fetch,
        scope=scope_from_jax(state, device="cpu"))
    for name, a, b in zip(fetch, got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    assert not np.allclose(got[-2], 0.0)      # the moving mean moved


def test_batch_norm_keeps_bf16_activations_and_fp32_statistics():
    x = rand(4, 3, 3, 5)
    ins = {"X": [x], "Scale": [np.ones(5, np.float32)],
           "Bias": [np.zeros(5, np.float32)],
           "Mean": [np.zeros(5, np.float32)],
           "Variance": [np.ones(5, np.float32)]}
    jout, pout = compare("batch_norm", ins, {"data_layout": "NHWC"},
                         amp=True, bf16=("X",), grads=("X", "Scale"))
    assert pout["Y"][0].dtype == torch.bfloat16
    assert pout["SavedVariance"][0].dtype == torch.float32


# -- relu, softmax, cross_entropy, momentum -----------------------------------

def bitwise(pout, jout):
    for slot in jout:
        for a, b in zip(pout[slot], jout[slot]):
            np.testing.assert_array_equal(to_np(a), to_np(b), err_msg=slot)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_relu_and_its_analytic_grad_bitwise(bf16):
    x = rand(4, 7)
    x[0, :3] = 0.0
    slots = ("X",) if bf16 else ()
    jout, pout = compare("relu", {"X": [x]}, bf16=slots)
    bitwise(pout, jout)
    g = rand(4, 7, seed=1)
    ins = {"X": [x], "Out": [np.maximum(x, 0)], "Out@GRAD": [g]}
    outs = {"X@GRAD": ["x@GRAD"]}
    jg = lower("jax", "relu_grad", {s: [to_jax(a, bf16) for a in v]
                                    for s, v in ins.items()}, {}, False,
               outs)
    pg = lower("port", "relu_grad", {s: [to_torch(a, bf16) for a in v]
                                     for s, v in ins.items()}, {}, False,
               outs)
    bitwise(pg, jg)
    assert preg.get_op_info("relu_grad").generic_grad is False


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp"])
def test_softmax(amp):
    jout, pout = compare("softmax", {"X": [rand(6, 10)]}, amp=amp,
                         bf16=("X",) if amp else (), grads=("X",))
    assert pout["Out"][0].dtype == (torch.float32 if amp else torch.float32)


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_cross_entropy(soft):
    rng = np.random.RandomState(0)
    p = rng.rand(6, 10).astype(np.float32)
    p /= p.sum(-1, keepdims=True)
    if soft:
        label = rng.rand(6, 10).astype(np.float32)
        label /= label.sum(-1, keepdims=True)
    else:
        label = rng.randint(0, 10, (6, 1)).astype(np.int64)
    jins = {"X": [to_jax(p, False)], "Label": [to_jax(label, False)]}
    pins = {"X": [to_torch(p, False)], "Label": [to_torch(label, False)]}
    attrs = {"soft_label": soft}
    jy = lower("jax", "cross_entropy", jins, attrs, False)["Y"][0]
    py = lower("port", "cross_entropy", pins, attrs, False)["Y"][0]
    assert tuple(py.shape) == (6, 1)
    np.testing.assert_allclose(to_np(py), to_np(jy), rtol=2.4e-7, atol=0)
    g = rand(6, 1, seed=3)
    gattrs = dict(attrs, __fwd_input_slots__=["X", "Label"],
                  __fwd_output_slots__=["Y"], __fwd_op_uid__=3)
    outs = {"X@GRAD": ["x@GRAD"]}
    jg = lower("jax", "cross_entropy_grad", dict(
        jins, Y=[jy], **{"Y@GRAD": [to_jax(g, False)]}), gattrs, False, outs)
    pg = lower("port", "cross_entropy_grad", dict(
        pins, Y=[py], **{"Y@GRAD": [to_torch(g, False)]}), gattrs, False,
        outs)
    np.testing.assert_allclose(to_np(pg["X@GRAD"][0]),
                               to_np(jg["X@GRAD"][0]), rtol=1e-6, atol=0)


@pytest.mark.parametrize("nesterov", [False, True], ids=["plain", "nesterov"])
def test_momentum_bitwise(nesterov):
    ins = {"Param": [rand(5, 7)], "Grad": [rand(5, 7, seed=1)],
           "Velocity": [rand(5, 7, seed=2)],
           "LearningRate": [np.array([0.01], np.float32)]}
    attrs = {"mu": 0.9, "use_nesterov": nesterov}
    jout = lower("jax", "momentum", {s: [to_jax(a, False) for a in v]
                                     for s, v in ins.items()}, attrs, False)
    pout = lower("port", "momentum", {s: [to_torch(a, False) for a in v]
                                      for s, v in ins.items()}, attrs, False)
    bitwise(pout, jout)


# -- the slice ----------------------------------------------------------------

def one_block_stack(fluid, models, images, class_dim, fmt):
    """``resnet_imagenet``'s bottleneck path with one block a stage:
    the stem, then ``models.resnet.layer_warp(bottleneck, ...)`` at 64,
    128, 256 and 512 channels (each with its shortcut convolution)."""
    res = models.resnet
    x = fluid.layers.transpose(images, perm=[0, 2, 3, 1]) \
        if fmt == "NHWC" else images
    x = res.conv_bn_layer(x, 64, 7, 2, 3, data_format=fmt)
    x = fluid.layers.pool2d(x, pool_type="max", pool_size=3, pool_stride=2,
                            pool_padding=1, data_format=fmt)
    for ch, stride in ((64, 1), (128, 2), (256, 2), (512, 2)):
        x = res.layer_warp(res.bottleneck, x, ch, 1, stride, data_format=fmt)
    x = fluid.layers.pool2d(x, pool_type="avg", global_pooling=True,
                            data_format=fmt)
    return fluid.layers.fc(x, size=class_dim, act="softmax")


def build(fluid, models, unique, *, depth, fmt, batch, size, amp,
          class_dim=10):
    """``bench.py``'s program at ``depth`` (0: ``one_block_stack``)."""
    with unique.guard():
        prog, startup = fluid.Program(), fluid.Program()
        prog.random_seed = startup.random_seed = 7
        with fluid.program_guard(prog, startup):
            images = fluid.layers.data(name="images",
                                       shape=[3, size, size],
                                       dtype="float32")
            label = fluid.layers.data(name="label", shape=[1],
                                      dtype="int64")
            pred = one_block_stack(fluid, models, images, class_dim, fmt) \
                if depth == 0 else models.resnet_imagenet(
                    images, class_dim=class_dim, depth=depth,
                    data_format=fmt)
            loss = fluid.layers.mean(
                fluid.layers.cross_entropy(input=pred, label=label))
            fluid.optimizer.Momentum(learning_rate=0.01, momentum=0.9) \
                .minimize(loss)
        fluid.enable_mixed_precision(prog, amp)
    return prog, startup, loss


def image_feed(batch, size, class_dim=10, seed=0):
    rng = np.random.RandomState(seed)
    return {"images": rng.rand(batch, 3, size, size).astype(np.float32),
            "label": rng.randint(0, class_dim, (batch, 1)).astype(np.int64)}


def run_both(depth, fmt, amp, steps, forced, batch=4, size=64):
    """Both packages' builds (names and op types asserted equal), the JAX
    startup state carried into the port, ``steps`` steps in each. The
    reference's state before each step and after the last (``states``),
    its losses, and the port's losses and states after each step: all
    from the carried-in start, or — ``forced`` — each step from the
    reference's state before it."""
    kw = dict(depth=depth, fmt=fmt, batch=batch, size=size, amp=amp)
    jprog, jstart, jloss = build(jfluid, jmodels, junique, **kw)
    pprog, pstart, ploss = build(pfluid, pmodels, punique, **kw)
    for a, b in ((jprog, pprog), (jstart, pstart)):
        assert sorted(v.name for v in a.list_vars()) == \
            sorted(v.name for v in b.list_vars())
        assert [op.type for op in a.global_block().ops] == \
            [op.type for op in b.global_block().ops]
        assert {v.name: v.dtype for v in a.list_vars()} == \
            {v.name: v.dtype for v in b.list_vars()}
    feed = image_feed(batch, size)
    jscope, states, jl = JScope(), [], []
    with jscope_guard(jscope):
        jexe = jfluid.Executor(jfluid.TPUPlace())
        jexe.run(jstart)
        for _ in range(steps + 1):
            states.append({n: np.asarray(v, np.float32)
                           for n, v in jscope.vars.items() if v is not None})
            if len(jl) < steps:
                jl.append(float(np.asarray(jexe.run(
                    jprog, feed=feed, fetch_list=[jloss])[0]).ravel()[0]))
    pexe = pfluid.Executor(pfluid.CPUPlace())
    pscope = scope_from_jax(states[0], device="cpu")
    pl, pstates = [], []
    for k in range(steps):
        if forced:
            pscope = scope_from_jax(states[k], device="cpu")
        pl.append(float(pexe.run(pprog, feed=feed, fetch_list=[ploss],
                                 scope=pscope)[0].ravel()[0]))
        pstates.append({n: pscope.find_var(n).float().numpy()
                        for n in states[0]})
    return jl, pl, states, pstates


def update_errors(states, pstates, forced):
    """Per step, name → the relative L2 of the port's update of it
    against the reference's (each from the state the port started
    from); every persistable the reference left unchanged must be
    unchanged in the port."""
    out = []
    for k, pstate in enumerate(pstates):
        base = states[k if forced else 0]
        errs = {}
        for name, want in states[k + 1].items():
            want, got = want - base[name], pstate[name] - base[name]
            if not np.any(want):
                assert not np.any(got), name
                continue
            errs[name] = rel_l2(got, want)
        # parameters, velocities and moving statistics all moved
        assert any("_velocity_" in n for n in errs)
        assert any(n.startswith("batch_norm") and ".tmp" in n for n in errs)
        assert any(n.endswith(".w_0") for n in errs)
        out.append(errs)
    return out


def check(jl, pl, states, pstates, forced, loss_rtol, upd_rtol):
    assert all(np.isfinite(pl))
    np.testing.assert_allclose(pl, jl, rtol=loss_rtol)
    for errs in update_errors(states, pstates, forced):
        worst = max(errs, key=errs.get)
        assert errs[worst] <= upd_rtol, (worst, errs[worst])


def test_resnet50_nhwc_fp32_steps_match_the_reference_step_by_step():
    """Case A in fp32, each step from the reference's state before it.
    Wider than the slice's 1e-4 / 1e-3 (measured on the CPU): the port
    itself, given images perturbed by 1e-7 relative, moves its one-step
    update by 2.5% rel L2 and its two-step update by 120% — 53 batch
    norms over 16 values a channel (4 images, 2x2 at the last stage)
    amplify a rounding difference about 1.2x each, and relu masks flip
    on the elements that end up within it of zero. Measured against the
    reference: losses within 1.2e-4, updates within 0.072."""
    jl, pl, states, pstates = run_both(50, "NHWC", False, 2, forced=True)
    check(jl, pl, states, pstates, True, loss_rtol=1e-3, upd_rtol=0.15)


def test_resnet50_nhwc_amp_steps_match_the_reference_step_by_step():
    """Case A under amp, each step from the reference's state before it:
    every variable's name, type and dtype as the reference's, finite
    losses, and the first step's loss within 0.1 relative (measured
    0.045). Updates are not compared: at this size bf16 rounding
    decides them — the reference's own amp update has a cosine of 0.20
    with its fp32 update from the same state (the port's 0.09); the
    depth-18 build keeps 0.94 — and the reference keeps bf16 conv
    outputs unrounded inside XLA fusions (excess precision), where the
    port rounds each op's output."""
    jl, pl, states, pstates = run_both(50, "NHWC", True, 2, forced=True)
    assert all(np.isfinite(pl))
    assert abs(pl[0] - jl[0]) <= 0.1 * abs(jl[0])


def test_bottleneck_stack_two_fp32_steps_match_the_reference():
    """``one_block_stack`` (the depth-50 bottleneck and shortcut code, a
    block a stage) in NHWC, two steps from the carried-in start at the
    slice's fp32 tolerances: losses 1e-4, updates 1e-3 (measured 4e-6
    and 1.3e-4)."""
    jl, pl, states, pstates = run_both(0, "NHWC", False, 2, forced=False)
    check(jl, pl, states, pstates, False, loss_rtol=1e-4, upd_rtol=1e-3)


def test_bottleneck_stack_amp_steps_match_the_reference_step_by_step():
    """``one_block_stack`` under amp, each step from the reference's
    state: losses within 1e-2 (measured 4e-5 and 4e-3), updates within
    0.6 relative L2 (measured 0.45 on the first step, 0.05 on the
    second): wider than the slice's 5e-3 / 0.1 because the reference
    keeps bf16 conv outputs unrounded inside XLA fusions (excess
    precision) where the port rounds them — with that off
    (``--xla_allow_excess_precision=false``) the first batch norm's
    outputs agree within 8e-5 relative L2 instead of 3.7e-3."""
    jl, pl, states, pstates = run_both(0, "NHWC", True, 2, forced=True)
    check(jl, pl, states, pstates, True, loss_rtol=1e-2, upd_rtol=0.6)


def test_resnet18_nchw_one_step_matches_the_reference():
    """Case B at the slice's fp32 tolerances (measured: loss 2e-6,
    updates 1.7e-4)."""
    jl, pl, states, pstates = run_both(18, "NCHW", False, 1, forced=False)
    check(jl, pl, states, pstates, False, loss_rtol=1e-4, upd_rtol=1e-3)


def test_run_steps_on_the_cpu_equals_run_calls():
    prog, startup, loss = build(pfluid, pmodels, punique, depth=18,
                                fmt="NHWC", batch=2, size=32, amp=False)
    feed = image_feed(2, 32)
    exe = pfluid.Executor(pfluid.CPUPlace())
    init = pfluid.Scope()
    exe.run(startup, scope=init)
    scopes = []
    for _ in range(2):
        scope = pfluid.Scope()
        for n in init.local_var_names():
            scope.set_var(n, init.find_var(n).clone())
        scopes.append(scope)
    a = [exe.run(prog, feed=feed, fetch_list=[loss], scope=scopes[0])
         for _ in range(2)][-1]
    before = dict(pexecutor.graph_launches)
    b = exe.run_steps(prog, feed=feed, n_steps=2, fetch_list=[loss],
                      scope=scopes[1])
    assert pexecutor.graph_launches == before   # nothing to capture here
    np.testing.assert_array_equal(a[0], b[0])
    for n in init.local_var_names():
        assert torch.equal(scopes[0].find_var(n), scopes[1].find_var(n)), n


def test_run_steps_refuses_host_ops(monkeypatch):
    prog, startup, loss = build(pfluid, pmodels, punique, depth=18,
                                fmt="NHWC", batch=2, size=32, amp=False)
    monkeypatch.setattr(preg.get_op_info("mean"), "host", True)
    with pytest.raises(RuntimeError, match="host-side ops \\(mean\\)"):
        pfluid.Executor(pfluid.CPUPlace()).run_steps(
            prog, feed=image_feed(2, 32), n_steps=2, fetch_list=[loss])


def test_a_graphed_step_refuses_random_ops_by_name():
    ctx = preg.LoweringContext(fake_op("dropout", {}), step_key=(0, 0),
                               graphed=True)
    with pytest.raises(RuntimeError, match="'dropout'.*run_steps"):
        ctx.rng()
    assert preg.LoweringContext(fake_op("dropout", {}),
                                step_key=(0, 0)).rng() is not None


def test_liveness_drops_intermediates_but_keeps_state_and_fetches():
    prog, startup, loss = build(pfluid, pmodels, punique, depth=18,
                                fmt="NHWC", batch=2, size=32, amp=False)
    block = prog.global_block()
    persist = {n for n, v in block.vars.items() if v.persistable}
    keep = persist | {loss.name}
    drop = pexecutor.liveness(block, keep)
    dropped = [n for names in drop for n in names]
    assert len(dropped) == len(set(dropped))
    assert not set(dropped) & keep
    used = {n for op in block.ops for vs in list(op.inputs.values()) +
            list(op.outputs.values()) for n in vs if n}
    assert set(dropped) == used - keep
    # an env traced with the plan ends holding only what it keeps
    scope = pfluid.Scope()
    exe = pfluid.Executor(pfluid.CPUPlace())
    exe.run(startup, scope=scope)
    env = {n: scope.find_var(n) for n in persist}
    env.update(exe._convert_feed(prog, image_feed(2, 32)))
    with torch.no_grad():
        pexecutor.trace_ops(block, env, step_key=(0, 0), drop=drop)
    assert set(env) <= keep and loss.name in env


def test_flops_of_resnet50_match_the_reference():
    kw = dict(depth=50, fmt="NHWC", batch=256, size=224, amp=True,
              class_dim=1000)
    from paddle_tpu.flops import estimate_program_flops as jflops
    jprog = build(jfluid, jmodels, junique, **kw)[0]
    pprog = build(pfluid, pmodels, punique, **kw)[0]
    got = estimate_program_flops(pprog, 256, training=True)
    assert got == jflops(jprog, 256, training=True)
    # ResNet-50: 3.86 G multiply-adds an image forward, x2 x3 in training
    assert 5.8e12 < got < 6.0e12


def test_delayed_fp8_conv_scale_is_not_ported(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_FP8_CONV_OUT", "delayed")
    with pytest.raises(NotImplementedError, match="delayed"):
        build(pfluid, pmodels, punique, depth=18, fmt="NHWC", batch=2,
              size=32, amp=True)
