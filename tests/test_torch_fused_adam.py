"""The port's fused Adam (the ``fused_adam`` op, K4's plain version and
``FusedAdamOptimizer``) on the CPU: bitwise against the port's own
per-parameter ``adam`` ops, within 1e-6 relative of the JAX package's
``fused_adam`` fallback and of its Pallas kernel in interpret mode (the
same fp32 expressions; XLA may contract a multiply and an add into one
rounding where eager PyTorch rounds twice), with and without global-norm
clipping and a loss scale; and the optimizer's program against the
reference's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import unique_name as junique
from paddle_tpu.ops import pallas_optimizer

import paddle_tpu_torch as pfluid
from paddle_tpu_torch import unique_name as punique
from paddle_tpu_torch.ops import fused_adam as pfa
from tests.test_torch_train_ops import lower, to_np

SHAPES = [(16, 8), (8,), (4, 4), (1,), (3, 5, 7)]
ATTRS = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}


def state(seed=0, grad_scale=3.0):
    rng = np.random.RandomState(seed)
    p = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    g = [rng.randn(*s).astype(np.float32) * grad_scale for s in SHAPES]
    m1 = [rng.randn(*s).astype(np.float32) * 0.1 for s in SHAPES]
    m2 = [np.abs(rng.randn(*s)).astype(np.float32) * 0.01 for s in SHAPES]
    scalars = {"LearningRate": [np.array([0.01], np.float32)],
               "Beta1Pow": [np.array([0.9 ** 3], np.float32)],
               "Beta2Pow": [np.array([0.999 ** 3], np.float32)]}
    return {"Param": p, "Grad": g, "Moment1": m1, "Moment2": m2, **scalars}


def as_torch(ins):
    return {k: [torch.from_numpy(np.array(a)) for a in v]
            for k, v in ins.items()}


def as_jax(ins):
    return {k: [jnp.asarray(a) for a in v] for k, v in ins.items()}


OUTS = ("ParamOut", "Moment1Out", "Moment2Out")


def test_fused_adam_op_is_bitwise_the_per_parameter_adam_ops():
    ins = state()
    fused = lower("port", "fused_adam", as_torch(ins), ATTRS, False)
    before = dict(pfa.launches)
    for i in range(len(SHAPES)):
        one = {k: [v[i]] if k in ("Param", "Grad", "Moment1", "Moment2")
               else v for k, v in ins.items()}
        ref = lower("port", "adam", as_torch(one), ATTRS, False)
        for slot in OUTS:
            np.testing.assert_array_equal(fused[slot][i].numpy(),
                                          ref[slot][0].numpy(),
                                          err_msg="%s[%d]" % (slot, i))
    assert pfa.launches == before        # CPU tensors launch nothing


@pytest.mark.parametrize("clip,loss_scale", [(0.0, None), (1.0, None),
                                             (0.0, 1024.0), (1.0, 64.0)],
                         ids=["plain", "clip", "loss-scale", "both"])
def test_fused_adam_op_matches_the_reference(clip, loss_scale):
    ins = state(seed=1)
    if loss_scale:
        ins["Grad"] = [g * loss_scale for g in ins["Grad"]]
        ins["LossScale"] = [np.array([loss_scale], np.float32)]
    attrs = dict(ATTRS, clip_norm=clip)
    got = lower("port", "fused_adam", as_torch(ins), attrs, False)
    want = lower("jax", "fused_adam", as_jax(ins), attrs, False)
    for slot in OUTS:
        for i, (a, b) in enumerate(zip(got[slot], want[slot])):
            np.testing.assert_allclose(to_np(a), to_np(b), rtol=1e-6,
                                       atol=1e-7, err_msg="%s[%d]"
                                       % (slot, i))
    if clip:    # the clip engaged: the update differs from the unclipped one
        free = lower("port", "fused_adam", as_torch(ins),
                     dict(ATTRS, clip_norm=0.0), False)
        assert not np.allclose(to_np(free["Moment1Out"][0]),
                               to_np(got["Moment1Out"][0]))


def test_plain_version_matches_the_pallas_kernel_in_interpret_mode():
    rng = np.random.RandomState(3)
    n = pallas_optimizer.ROW_BLOCK * pallas_optimizer.LANE * 2
    p, g, m1, m2 = (rng.standard_normal(n).astype(np.float32)
                    for _ in range(4))
    m2 = np.abs(m2)
    lr_t, gs = 0.01, 0.7
    want = pallas_optimizer.fused_adam_flat(
        *(jnp.asarray(x) for x in (p, g, m1, m2)), lr_t, gs, beta1=0.9,
        beta2=0.999, epsilon=1e-8, interpret=True)
    # the same flat buffer cut into three tensors: one K4 call covers them
    cuts = [0, 5, 5000, n]
    parts = [[torch.from_numpy(x[a:b]) for a, b in zip(cuts, cuts[1:])]
             for x in (p, g, m1, m2)]
    got = pfa.fused_adam_update(*parts, torch.tensor(lr_t),
                                torch.tensor(gs), 0.9, 0.999, 1e-8)
    for out, w in zip(got, want):
        np.testing.assert_allclose(torch.cat(out).numpy(), np.asarray(w),
                                   rtol=1e-6, atol=5e-7)


def test_fused_adam_update_checks_its_inputs():
    t = torch.zeros(3)
    with pytest.raises(ValueError):                  # a missing moment
        pfa.fused_adam_update([t], [t], [t], [], t[:1], t[:1], 0.9, 0.999,
                              1e-8)
    with pytest.raises(ValueError):                  # shapes differ
        pfa.fused_adam_update([t], [torch.zeros(4)], [t], [t], t[:1],
                              t[:1], 0.9, 0.999, 1e-8)
    meta = torch.zeros(3, device="meta")
    with pytest.raises(ValueError):                  # not a CUDA device
        pfa.fused_adam_update([meta], [meta], [meta], [meta], meta[:1],
                              meta[:1], 0.9, 0.999, 1e-8)


def build(fluid, unique, opt, **kw):
    with unique.guard():
        prog, startup = fluid.Program(), fluid.Program()
        prog.random_seed = startup.random_seed = 3
        with fluid.program_guard(prog, startup):
            x = fluid.layers.data(name="x", shape=[8, 16], dtype="float32",
                                  append_batch_size=False)
            h = fluid.layers.fc(input=x, size=32)
            p = fluid.layers.fc(input=h, size=4)
            loss = fluid.layers.mean(p)
            getattr(fluid.optimizer, opt)(learning_rate=1e-2,
                                          **kw).minimize(loss)
    return prog, startup, loss


def test_optimizer_builds_the_reference_program():
    jprog = build(jfluid, junique, "FusedAdam", clip_global_norm=1.0)[0]
    pprog = build(pfluid, punique, "FusedAdam", clip_global_norm=1.0)[0]
    for prog in (jprog, pprog):
        assert [op.type for op in prog.global_block().ops].count(
            "fused_adam") == 1
        assert not [op for op in prog.global_block().ops
                    if op.type == "adam"]
    jop, pop = ([op for op in p.global_block().ops if op.type == "fused_adam"]
                [0] for p in (jprog, pprog))
    assert pop.inputs == jop.inputs and pop.outputs == jop.outputs
    assert pop.attrs["clip_norm"] == jop.attrs["clip_norm"] == 1.0
    assert sorted(v.name for v in pprog.list_vars()) == \
        sorted(v.name for v in jprog.list_vars())
    # the same accumulator names as Adam's, so state carries across
    aprog = build(pfluid, punique, "Adam")[0]
    assert sorted(v.name for v in aprog.list_vars() if v.persistable) == \
        sorted(v.name for v in pprog.list_vars() if v.persistable)


def test_fused_adam_steps_are_bitwise_adam_steps():
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(8, 16).astype(np.float32)}
    final = {}
    for opt in ("Adam", "FusedAdam"):
        prog, startup, loss = build(pfluid, punique, opt)
        scope = pfluid.Scope()
        exe = pfluid.Executor(pfluid.CPUPlace())
        exe.run(startup, scope=scope)
        losses = [float(exe.run(prog, feed=feed, fetch_list=[loss],
                                scope=scope)[0]) for _ in range(4)]
        final[opt] = (losses, {n: scope.find_var(n).clone()
                               for n in scope.local_var_names()})
    assert final["Adam"][0] == final["FusedAdam"][0]
    for n, v in final["Adam"][1].items():
        assert torch.equal(v, final["FusedAdam"][1][n]), n


def test_optimizer_rejects_what_one_fused_op_cannot_express():
    with punique.guard(), pfluid.program_guard(pfluid.Program(),
                                               pfluid.Program()):
        x = pfluid.layers.data(name="x", shape=[4, 8], dtype="float32",
                               append_batch_size=False)
        h = pfluid.layers.fc(input=x, size=4,
                             param_attr=pfluid.ParamAttr(learning_rate=0.5))
        with pytest.raises(ValueError, match="learning.rate"):
            pfluid.optimizer.FusedAdam(1e-2).minimize(pfluid.layers.mean(h))
    with punique.guard(), pfluid.program_guard(pfluid.Program(),
                                               pfluid.Program()):
        ids = pfluid.layers.data(name="ids", shape=[4, 1], dtype="int64",
                                 append_batch_size=False)
        emb = pfluid.layers.embedding(ids, size=[50, 8], is_sparse=True)
        with pytest.raises(ValueError, match="SelectedRows"):
            pfluid.optimizer.FusedAdam(1e-2).minimize(
                pfluid.layers.mean(emb))


def test_loss_scale_var_reaches_the_op():
    """A LossScale variable S divides the gradients: from zero moments,
    one step with S = 4 leaves moment1 / 4 and moment2 / 16, bitwise (a
    power of two scales without rounding)."""
    rng = np.random.RandomState(1)
    feed = {"x": rng.randn(8, 16).astype(np.float32)}
    moments = []
    for scale in (None, 4.0):
        with punique.guard():
            prog, startup = pfluid.Program(), pfluid.Program()
            prog.random_seed = startup.random_seed = 3
            with pfluid.program_guard(prog, startup):
                x = pfluid.layers.data(name="x", shape=[8, 16],
                                       dtype="float32",
                                       append_batch_size=False)
                loss = pfluid.layers.mean(pfluid.layers.fc(input=x, size=4))
                kw = {}
                if scale is not None:
                    kw["loss_scale_var"] = pfluid.layers.fill_constant(
                        [1], "float32", scale)
                pfluid.optimizer.FusedAdam(1e-2, **kw).minimize(loss)
        (op,) = [o for o in prog.global_block().ops
                 if o.type == "fused_adam"]
        assert ("LossScale" in op.inputs) == (scale is not None)
        scope = pfluid.Scope()
        exe = pfluid.Executor(pfluid.CPUPlace())
        exe.run(startup, scope=scope)
        exe.run(prog, feed=feed, scope=scope)
        moments.append({n: scope.find_var(n) for n in scope.local_var_names()
                        if "_moment" in n})
    assert moments[0]
    for n, v in moments[0].items():
        want = v / (4.0 if "_moment1" in n else 16.0)
        assert torch.equal(moments[1][n], want), n
