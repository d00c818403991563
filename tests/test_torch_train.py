"""The port's Fluid training path against the JAX package on the CPU: one
build script — ``transformer_lm`` (2 layers, d_model 64, 2 heads, vocab
64) at batch 2, seq 256, under ``Adam`` — run through both packages,
once with a factored padding mask (``valid=``), once with grouped-query
attention (``num_kv_heads=1``) and once on packed rows (``segment_ids=``
fed from ``pack_segments``), each in fp32 and under
``enable_mixed_precision``; and once in fp32 under ``FusedAdam``.

Both builds give identical variable names; the JAX startup program's
state is carried into the port with ``convert.scope_from_jax``; then
three steps run in each package. Tolerances:
- fp32: per-step losses within 1e-5 relative; every final persistable
  within 1e-5 relative + 5e-5 absolute (5% of one Adam step at lr 1e-3:
  Adam divides each gradient by its own magnitude, so a weight whose
  gradient is near zero moves by an amount its summation-order noise
  sets). The two packages differ in summation order only (the port's
  attention is the flash kernels' plain version, the JAX package's CPU
  path its XLA composition).
- amp: losses within 5e-3 relative; each persistable's three-step update
  (final − start) within 0.25 relative L2 of the reference's. bf16
  rounds at other places in the two packages (the XLA attention rounds
  the probabilities to bf16 before P·V, the flash path keeps them fp32;
  reductions accumulate in another order), and Adam turns that rounding
  into whole steps for small gradients.
The key projection's bias is left out of both: softmax is invariant to a
shift of a row's logits, so its gradient is zero in exact arithmetic and
Adam moves it by pure rounding noise (up to lr per step) in both.
Also the device rule of ``Executor`` and the places.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import models as jmodels
from paddle_tpu import unique_name as junique
from paddle_tpu.data import decorator as jdecorator
from paddle_tpu.executor import Scope as JScope
from paddle_tpu.executor import scope_guard as jscope_guard

import paddle_tpu_torch as pfluid
from paddle_tpu_torch import models as pmodels
from paddle_tpu_torch import unique_name as punique
from paddle_tpu_torch.convert import scope_from_jax

B, S, V, LAYERS, D, HEADS = 2, 256, 64, 2, 64, 2
STEPS, LR = 3, 1e-3


def build(fluid, models, unique, *, amp, valid, kv_heads, packed=False,
          opt="Adam"):
    with unique.guard():
        prog, startup = fluid.Program(), fluid.Program()
        prog.random_seed = startup.random_seed = 7
        with fluid.program_guard(prog, startup):
            ids = fluid.layers.data(name="ids", shape=[B, S], dtype="int64",
                                    append_batch_size=False)
            labels = fluid.layers.data(name="labels", shape=[B, S],
                                       dtype="int64",
                                       append_batch_size=False)
            mask = fluid.layers.data(name="valid", shape=[B, S],
                                     dtype="float32",
                                     append_batch_size=False) \
                if valid else None
            seg = fluid.layers.data(name="seg", shape=[B, S],
                                    dtype="int32",
                                    append_batch_size=False) \
                if packed else None
            logits = models.transformer_lm(
                ids, vocab_size=V, num_layers=LAYERS, d_model=D,
                num_heads=HEADS, max_len=S, num_kv_heads=kv_heads,
                valid=mask, segment_ids=seg)
            flat = fluid.layers.reshape(logits, [B * S, V])
            flat_lbl = fluid.layers.reshape(labels, [B * S, 1])
            loss = fluid.layers.mean(
                fluid.layers.softmax_with_cross_entropy(flat, flat_lbl))
            getattr(fluid.optimizer, opt)(learning_rate=LR).minimize(loss)
        fluid.enable_mixed_precision(prog, amp)
    return prog, startup, loss


def feeds(valid, packed=False):
    if packed:      # documents of 24-150 tokens, first-fit packed
        rng = np.random.RandomState(0)
        docs = [rng.randint(1, V, size=int(rng.randint(24, 150)))
                for _ in range(12)]
        rows = jdecorator.pack_segments(docs, S)[:B]
        ids = np.stack([t for t, _ in rows]).astype(np.int32)
        seg = np.stack([s for _, s in rows]).astype(np.int32)
        assert (seg.max(1) >= 2).all()     # several documents per row
        return {"ids": ids, "seg": seg, "labels": jdecorator
                .packed_next_token_labels(ids, seg, ignore_id=0)
                .astype(np.int32)}
    rng = np.random.RandomState(0)
    x = rng.randint(0, V, (B, S))
    feed = {"ids": x.astype(np.int32),
            "labels": np.roll(x, -1, 1).astype(np.int32)}
    if valid:
        mask = np.ones((B, S), np.float32)
        mask[1, S - 56:] = 0.0          # a padded tail in one row
        feed["valid"] = mask
    return feed


def run_both(amp, valid, kv_heads, packed=False, opt="Adam"):
    kw = dict(amp=amp, valid=valid, kv_heads=kv_heads, packed=packed,
              opt=opt)
    jprog, jstart, jloss = build(jfluid, jmodels, junique, **kw)
    pprog, pstart, ploss = build(pfluid, pmodels, punique, **kw)
    names = {n: sorted(v.name for v in p.list_vars())
             for n, p in (("jax", jprog), ("port", pprog))}
    assert names["jax"] == names["port"]
    assert [op.type for op in jprog.global_block().ops] == \
        [op.type for op in pprog.global_block().ops]
    feed = feeds(valid, packed)
    jscope = JScope()
    with jscope_guard(jscope):
        jexe = jfluid.Executor(jfluid.TPUPlace())
        jexe.run(jstart)
        state = {n: np.asarray(v) for n, v in jscope.vars.items()
                 if v is not None}
        jl = [float(np.asarray(jexe.run(jprog, feed=feed,
                                        fetch_list=[jloss])[0]).ravel()[0])
              for _ in range(STEPS)]
        jfinal = {n: np.asarray(jscope.find_var(n), np.float32)
                  for n in state}
    pscope = scope_from_jax(state, device="cpu")
    pexe = pfluid.Executor(pfluid.CPUPlace())
    pl = [float(pexe.run(pprog, feed=feed, fetch_list=[ploss],
                         scope=pscope)[0].ravel()[0]) for _ in range(STEPS)]
    pfinal = {n: pscope.find_var(n).float().numpy() for n in state}
    return jl, pl, state, jfinal, pfinal


def key_bias_columns(kv_heads):
    """bias name → the columns of it that project keys: each layer's
    second fc (three projections) or the key third of its fused one."""
    hd = D // HEADS
    if kv_heads is None:
        return {"fc_%d.b_0" % (6 * i + 1): slice(None)
                for i in range(LAYERS)}
    return {"fc_%d.b_0" % (4 * i): slice(D, D + kv_heads * hd)
            for i in range(LAYERS)}


def noise_free(name, noise, shape):
    """Index of ``name``'s elements outside the key bias (and its Adam
    moments)."""
    keep = np.ones(shape, bool)
    for bias, cols in noise.items():
        if name == bias or name.startswith(bias + "_moment"):
            keep[..., cols] = False
    return keep


@pytest.mark.parametrize("valid,kv_heads,packed", [
    (True, None, False), (False, 1, False), (False, None, True)],
    ids=["padding-mask", "gqa", "packed"])
@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp"])
def test_three_adam_steps_match_the_reference(amp, valid, kv_heads, packed):
    check_three_steps(amp, valid, kv_heads, packed, "Adam")


def test_three_fused_adam_steps_match_the_reference():
    check_three_steps(False, False, None, False, "FusedAdam")


def check_three_steps(amp, valid, kv_heads, packed, opt):
    jl, pl, start, jfinal, pfinal = run_both(amp, valid, kv_heads, packed,
                                             opt)
    assert all(np.isfinite(pl)) and pl[-1] < pl[0]
    np.testing.assert_allclose(pl, jl, rtol=5e-3 if amp else 1e-5)
    assert sorted(pfinal) == sorted(jfinal)
    noise = key_bias_columns(kv_heads)
    for name in sorted(jfinal):
        keep = noise_free(name, noise, jfinal[name].shape)
        got, want = pfinal[name][keep], jfinal[name][keep]
        if not amp:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=5e-5,
                                       err_msg=name)
        elif start[name].dtype.kind == "f":
            base = start[name].astype(np.float32)[keep]
            ref = np.linalg.norm(want - base)
            assert np.linalg.norm((got - base) - (want - base)) <= \
                0.25 * ref, name
    # the steps moved every weight matrix away from the carried-in start
    weights = [n for n in start if n.endswith(".w_0")]
    assert weights and all(not np.array_equal(pfinal[n], start[n])
                           for n in weights)


def test_executor_places_follow_the_device_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        pfluid.Executor()
    with pytest.raises(RuntimeError, match="cuda"):
        pfluid.Executor(pfluid.CUDAPlace(0))
    with pytest.raises(TypeError):
        pfluid.Executor("cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        scope_from_jax({"w": np.zeros(2, np.float32)})
    prog, startup = pfluid.Program(), pfluid.Program()
    with pfluid.program_guard(prog, startup):
        x = pfluid.layers.data(name="x", shape=[3], dtype="float32")
        y = pfluid.layers.fc(x, size=2)
        loss = pfluid.layers.mean(y)
        pfluid.optimizer.SGD(0.1).minimize(loss)
    exe = pfluid.Executor(pfluid.CPUPlace())
    with pfluid.scope_guard(pfluid.Scope()):
        exe.run(startup)
        out = exe.run(prog, feed={"x": np.ones((4, 3), np.float32)},
                      fetch_list=[loss, y])
    assert out[0].shape == () and out[1].shape == (4, 2)


def test_unported_options_raise():
    prog, startup = pfluid.Program(), pfluid.Program()
    with pfluid.program_guard(prog, startup):
        ids = pfluid.layers.data(name="ids", shape=[2, 8], dtype="int64",
                                 append_batch_size=False)
        for kw in ({"moe_experts": 2}, {"pipeline_stages": 2},
                   {"recompute": True}):
            with pytest.raises(NotImplementedError):
                pmodels.transformer_lm(ids, vocab_size=16, num_layers=1,
                                       d_model=16, num_heads=2, max_len=8,
                                       **kw)
