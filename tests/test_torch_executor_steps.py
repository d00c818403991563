"""The port's executor beside the JAX package's on the CPU: ``FetchHandle``,
the step telemetry (``step_summary``'s cache misses by cause), the step
counter, ``check_nan_inf``, ``run_steps`` against ``run`` with random
ops, ``dropout``, and the launch counts of kernels replayed inside a
CUDA graph (the bookkeeping, with the capture faked: no card here).

Programs: a 13 → 16 → 4 classifier (``fc``, relu, softmax
cross-entropy, ``Adam``) built in both packages under their
``unique_name.guard()``, the JAX startup state carried across with
``convert.scope_from_jax``. Values compare within 1e-5 relative (fp32,
summation order only); the cache-miss causes, counts and messages
exactly.
"""

import contextlib

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
from paddle_tpu import flags as jflags
from paddle_tpu import observability as jobs
from paddle_tpu import profiler as jprofiler
from paddle_tpu import unique_name as junique
from paddle_tpu.executor import Scope as JScope
from paddle_tpu.executor import scope_guard as jscope_guard
from paddle_tpu.layer_helper import LayerHelper as JLayerHelper

import paddle_tpu_torch as pfluid
from paddle_tpu_torch import executor as pexecutor
from paddle_tpu_torch import flags as pflags
from paddle_tpu_torch import profiler as pprofiler
from paddle_tpu_torch import unique_name as punique
from paddle_tpu_torch.convert import scope_from_jax
from paddle_tpu_torch.layer_helper import LayerHelper as PLayerHelper
from paddle_tpu_torch.observability import steps as psteps
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import fused_adam as pfa
from paddle_tpu_torch.ops import launch_count
from paddle_tpu_torch.ops import paged_attention as pa

B, IN, HID, CLASSES = 8, 13, 16, 4


def build(fluid, unique, dropout=None, uniform=False):
    """The classifier program: fc(16, relu), ``dropout`` (a probability)
    when given, fc(4); ``uniform`` adds a ``uniform_random`` draw to the
    logits; softmax cross-entropy, mean, ``Adam``."""
    with unique.guard():
        prog, startup = fluid.Program(), fluid.Program()
        prog.random_seed = startup.random_seed = 5
        with fluid.program_guard(prog, startup):
            x = fluid.layers.data(name="x", shape=[IN], dtype="float32")
            y = fluid.layers.data(name="y", shape=[1], dtype="int64")
            h = fluid.layers.fc(x, HID, act="relu")
            if dropout is not None:
                h = fluid.layers.dropout(h, dropout_prob=dropout)
            pred = fluid.layers.fc(h, CLASSES)
            if uniform:
                pred = fluid.layers.elementwise_add(
                    pred, _uniform(fluid, [B, CLASSES]))
            loss = fluid.layers.mean(
                fluid.layers.softmax_with_cross_entropy(pred, y))
            fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return prog, startup, loss, pred


def _uniform(fluid, shape):
    helper = LAYER_HELPERS[fluid]("uniform_random")
    out = helper.create_tmp_variable(dtype="float32")
    helper.append_op(type="uniform_random", outputs={"Out": [out]},
                     attrs={"shape": shape, "min": -0.1, "max": 0.1,
                            "dtype": "float32", "seed": 0})
    return out


LAYER_HELPERS = {jfluid: JLayerHelper, pfluid: PLayerHelper}


def feed(batch=B, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(batch, IN).astype(np.float32)
    y = (x[:, :CLASSES].argmax(1)[:, None]).astype(np.int64)
    return {"x": x, "y": y}


def jax_state(startup):
    scope = JScope()
    with jscope_guard(scope):
        jfluid.Executor(jfluid.TPUPlace()).run(startup)
    return {n: np.asarray(v) for n, v in scope.vars.items()
            if v is not None}


@pytest.fixture
def fresh_counters():
    for p in (jprofiler, pprofiler):
        p.reset_counters()
        p.reset_histograms()
    yield
    for p in (jprofiler, pprofiler):
        p.reset_counters()
        p.reset_histograms()


def test_fetch_handle_matches_the_reference(fresh_counters):
    jprog, jstart, jloss, jpred = build(jfluid, junique)
    pprog, _, ploss, ppred = build(pfluid, punique)
    state = jax_state(jstart)
    f = feed()
    jscope = JScope()
    for n, v in state.items():
        jscope.set_var(n, v)
    with jscope_guard(jscope):
        jh = jfluid.Executor(jfluid.TPUPlace()).run(
            jprog, feed=f, fetch_list=[jloss, jpred], return_numpy=False)
    pexe = pfluid.Executor(pfluid.CPUPlace())
    ph = pexe.run(pprog, feed=f, fetch_list=[ploss, ppred],
                  scope=scope_from_jax(state, device="cpu"),
                  return_numpy=False)
    assert isinstance(ph, pexecutor.FetchHandle)
    assert len(ph) == len(jh) == 2
    assert ph.names == jh.names
    assert all(isinstance(t, torch.Tensor) for t in ph)
    for i in range(2):
        np.testing.assert_allclose(ph[i].numpy(), np.asarray(jh[i]),
                                   rtol=1e-5, atol=1e-6)
    assert ph.block_until_ready() is ph
    a, b = ph.numpy(), ph.numpy()
    for got, want in zip(a, jh.numpy()):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert a[1] is not b[1] and np.array_equal(a[1], b[1])
    a[1][:] = 123.0                     # a caller's edit stays its own
    assert not np.array_equal(ph.numpy()[1], a[1])
    # the blocking path returns what numpy() does, bitwise
    scope = scope_from_jax(state, device="cpu")
    h = pfluid.Executor(pfluid.CPUPlace()).run(
        pprog, feed=f, fetch_list=[ploss], scope=scope, return_numpy=False)
    scope = scope_from_jax(state, device="cpu")
    blocking = pfluid.Executor(pfluid.CPUPlace()).run(
        pprog, feed=f, fetch_list=[ploss], scope=scope)
    assert np.array_equal(h.numpy()[0], blocking[0])
    assert "device_wait_s" in pprofiler.get_counters()


def _miss_sequence(fluid, unique, exe, scope_ctx, n_steps):
    """The same calls in either package: startup, a first run, a hit, a
    new feed shape, a new fetch list, a bumped program version, then two
    run_steps calls of ``n_steps``."""
    prog, startup, loss, pred = build(fluid, unique)
    with scope_ctx:
        exe.run(startup)
        exe.run(prog, feed=feed(), fetch_list=[loss])
        exe.run(prog, feed=feed(), fetch_list=[loss])
        exe.run(prog, feed=feed(4), fetch_list=[loss])
        exe.run(prog, feed=feed(4), fetch_list=[loss, pred])
        with fluid.program_guard(prog):
            extra = fluid.layers.mean(pred)
        exe.run(prog, feed=feed(4), fetch_list=[loss, pred, extra])
        for _ in range(2):
            exe.run_steps(prog, feed=feed(4), n_steps=n_steps,
                          fetch_list=[loss, pred, extra])
    return exe


def test_cache_miss_causes_match_the_reference(fresh_counters):
    _miss_sequence(jfluid, junique, jfluid.Executor(jfluid.TPUPlace()),
                   jscope_guard(JScope()), 3)
    _miss_sequence(pfluid, punique, pfluid.Executor(pfluid.CPUPlace()),
                   pfluid.scope_guard(pfluid.Scope()), 3)
    want, got = jobs.step_summary(), psteps.step_summary()
    assert got["compile_cache_misses_by_cause"] == \
        want["compile_cache_misses_by_cause"] == {
            "first_compile": 2.0, "feed_signature": 1.0, "fetch_list": 1.0,
            "program_version": 1.0, "n_steps": 1.0}
    for k in ("steps", "compile_cache_hits", "compile_cache_misses"):
        assert got[k] == want[k], k
    assert got["steps"] == 1 + 5 + 2 * 3
    assert got["step_seconds"]["count"] == 1 + 5 + 2


def test_step_counter_and_the_draws_that_read_it():
    prog, startup, loss, pred = build(pfluid, punique, dropout=0.5)
    exe = pfluid.Executor(pfluid.CPUPlace())
    scope = pfluid.Scope()
    exe.run(startup, scope=scope)
    assert exe.step_counter == 1
    init = {n: scope.find_var(n).clone() for n in scope.local_var_names()}
    exe.run(prog, feed=feed(), fetch_list=[loss], scope=scope)
    exe.run_steps(prog, feed=feed(), n_steps=3, fetch_list=[loss],
                  scope=scope)
    assert exe.step_counter == 5
    exe.set_step_counter(1)
    assert exe.step_counter == 1

    def first_loss(step):
        s = pfluid.Scope()
        for n, t in init.items():
            s.set_var(n, t.clone())
        exe.set_step_counter(step)
        return exe.run(prog, feed=feed(), fetch_list=[loss], scope=s)[0]

    # the same step draws the same mask; another step another one
    assert np.array_equal(first_loss(7), first_loss(7))
    assert not np.array_equal(first_loss(7), first_loss(8))


def test_check_nan_inf_names_the_variable_as_the_reference(monkeypatch):
    bad = feed()
    bad["x"][0, 0] = np.nan
    msgs = []
    for fluid, unique, flags, place in (
            (jfluid, junique, jflags, jfluid.TPUPlace()),
            (pfluid, punique, pflags, pfluid.CPUPlace())):
        prog, startup, loss, pred = build(fluid, unique)
        monkeypatch.setattr(flags, "check_nan_inf", True)
        exe = fluid.Executor(place)
        scope = JScope() if fluid is jfluid else pfluid.Scope()
        guard = jscope_guard if fluid is jfluid else pfluid.scope_guard
        with guard(scope):
            exe.run(startup)
            exe.run(prog, feed=feed(), fetch_list=[pred])   # finite: fine
            with pytest.raises(FloatingPointError) as err:
                exe.run(prog, feed=bad, fetch_list=[pred])
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1] == \
        "NaN/Inf detected in %r (FLAGS_check_nan_inf)" % pred.name


@pytest.mark.parametrize("random_ops", ["none", "dropout+uniform_random"])
def test_run_steps_equals_run_calls_on_the_cpu(random_ops):
    kw = {} if random_ops == "none" else {"dropout": 0.3, "uniform": True}
    prog, startup, loss, pred = build(pfluid, punique, **kw)
    exe = pfluid.Executor(pfluid.CPUPlace())
    init = pfluid.Scope()
    exe.run(startup, scope=init)
    scopes = []
    for _ in range(2):
        s = pfluid.Scope()
        for n in init.local_var_names():
            s.set_var(n, init.find_var(n).clone())
        scopes.append(s)
    a = pfluid.Executor(pfluid.CPUPlace())
    b = pfluid.Executor(pfluid.CPUPlace())
    ref = [a.run(prog, feed=feed(), fetch_list=[loss, pred],
                 scope=scopes[0]) for _ in range(6)]
    b.run(prog, feed=feed(), fetch_list=[loss, pred], scope=scopes[1])
    b.run_steps(prog, feed=feed(), n_steps=2, fetch_list=[loss, pred],
                scope=scopes[1])
    last = b.run_steps(prog, feed=feed(), n_steps=3,
                       fetch_list=[loss, pred], scope=scopes[1])
    for got, want in zip(last, ref[-1]):
        assert np.array_equal(got, want)
    assert a.step_counter == b.step_counter == 6
    for n in init.local_var_names():
        assert torch.equal(scopes[0].find_var(n), scopes[1].find_var(n)), n


def _dropout_program(fluid, unique, shape, p, is_test):
    with unique.guard():
        prog, startup = fluid.Program(), fluid.Program()
        prog.random_seed = 11
        with fluid.program_guard(prog, startup):
            x = fluid.layers.data(name="x", shape=shape, dtype="float32",
                                  append_batch_size=False)
            x.stop_gradient = False
            out = fluid.layers.dropout(x, dropout_prob=p, is_test=is_test)
            loss = fluid.layers.mean(out)
    return prog, x, out, loss


def test_dropout_in_test_mode_matches_the_reference():
    x = np.random.RandomState(3).randn(4, 33).astype(np.float32)
    outs = []
    for fluid, unique, place in ((jfluid, junique, jfluid.TPUPlace()),
                                 (pfluid, punique, pfluid.CPUPlace())):
        prog, xv, out, _ = _dropout_program(fluid, unique, [4, 33], 0.3,
                                            True)
        mask = prog.global_block().ops[-2].output("Mask")[0]
        exe = fluid.Executor(place)
        outs.append(exe.run(prog, feed={"x": x}, fetch_list=[out, mask]))
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    np.testing.assert_array_equal(outs[1][1], np.ones_like(x))
    np.testing.assert_array_equal(outs[1][0], x * np.float32(0.7))


def test_dropout_trains_through_its_mask_at_the_keep_rate():
    p, n = 0.3, 64 * 256
    prog, xv, out, loss = _dropout_program(pfluid, punique, [64, 256], p,
                                           False)
    pfluid.append_backward(loss)
    mask = [op for op in prog.global_block().ops
            if op.type == "dropout"][0].output("Mask")[0]
    x = np.random.RandomState(4).randn(64, 256).astype(np.float32)
    exe = pfluid.Executor(pfluid.CPUPlace())
    masks = []
    for _ in range(2):
        o, m, gx = exe.run(prog, feed={"x": x},
                           fetch_list=[out, mask, xv.name + "@GRAD"])
        assert set(np.unique(m)) <= {0.0, 1.0}
        np.testing.assert_array_equal(o, x * m)         # no rescale
        # the grad op reads the forward's mask: d mean(x*m)/dx = m / n
        np.testing.assert_array_equal(gx, m * np.float32(1.0 / n))
        kept = m.mean()
        assert abs(kept - (1 - p)) <= 4 * np.sqrt(p * (1 - p) / n)
        masks.append(m)
    assert not np.array_equal(masks[0], masks[1])       # a new draw a step


# -- launch counts through replays (the capture faked) ---------------------

@pytest.fixture
def zero_counts():
    saved = (dict(fa.launches), dict(pfa.launches), pa.launches,
             pa.launches_quant, dict(launch_count.recorded),
             dict(pexecutor.graph_launches))
    for d in (fa.launches, pfa.launches, pexecutor.graph_launches):
        for k in d:
            d[k] = 0
    launch_count.recorded.clear()
    pa.launches = pa.launches_quant = 0
    yield
    (la, lf, pa.launches, pa.launches_quant, rec, g) = saved
    for d, v in ((fa.launches, la), (pfa.launches, lf),
                 (pexecutor.graph_launches, g)):
        d.update(v)
    launch_count.recorded.clear()
    launch_count.recorded.update(rec)


def _capturing(monkeypatch, capturing):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing)


def test_a_call_under_capture_is_recorded_not_launched(monkeypatch,
                                                       zero_counts):
    class Lib:
        def paddle_flash_fwd(self, *args):
            return 0

    q = torch.zeros(1, 4, 2, 8)
    monkeypatch.setattr(torch.cuda, "device", lambda d:
                        contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: type("S", (), {"cuda_stream": 0}))
    for capturing, want in ((False, (1, 0)), (True, (1, 1))):
        _capturing(monkeypatch, capturing)
        fa._launch("flash_fwd", Lib(), (q, q, q), [None, 0], (q,), 1.0,
                   True)
        assert (fa.launches["flash_fwd"],
                launch_count.recorded.get("flash_fwd", 0)) == want


def test_replays_add_what_the_capture_recorded(monkeypatch, zero_counts):
    class Graph:
        replays = 0

        def replay(self):
            Graph.replays += 1

    # one LM step's capture: 12 layers of K1/K2 and one K4, whose
    # pinned table the graph reads
    table = torch.zeros(4)
    _capturing(monkeypatch, True)
    with launch_count.Capture() as rec:
        for _ in range(12):
            for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
                launch_count.launched(name, fa._add)
        launch_count.keep_alive(table)
        launch_count.launched("fused_adam", pfa._add)
    _capturing(monkeypatch, False)
    assert rec.per_replay == {"flash_fwd": 12, "flash_bwd_dq": 12,
                              "flash_bwd_dkv": 12, "fused_adam": 1}
    assert rec.kept == [table] and launch_count._kept == []
    assert fa.launches["flash_fwd"] == pfa.launches["fused_adam"] == 0
    launch_count.keep_alive(torch.zeros(1))     # not capturing: dropped
    assert launch_count._kept == []

    step = pexecutor._CapturedStep.__new__(pexecutor._CapturedStep)
    step.graph, step.fetches, step.recorded = Graph(), ["loss"], rec
    assert step.replays(7) == ["loss"]
    assert Graph.replays == 7
    assert pexecutor.graph_launches["replays"] == 7
    assert fa.launches["flash_fwd"] == fa.launches["flash_bwd_dkv"] == 84
    assert fa.launches["flash_segment_fwd"] == 0
    assert pfa.launches["fused_adam"] == 7
    assert pa.launches == pa.launches_quant == 0

    # a decode trip's capture: K3's counts are module ints
    _capturing(monkeypatch, True)
    with launch_count.Capture() as trip:
        launch_count.launched("k3", pa._add)
        launch_count.launched("k3", pa._add)
        launch_count.launched("k3_quant", pa._add)
    _capturing(monkeypatch, False)
    trip.replayed(3)
    assert (pa.launches, pa.launches_quant) == (6, 3)
    assert fa.launches["flash_fwd"] == 84


def test_capture_holds_the_collector_off():
    """No cyclic collection runs while a capture is open (its finalizers
    could release CUDA objects inside the capture); nested and
    concurrent captures restore the collector once, as it was, also
    when the capture raises."""
    import gc
    import threading
    assert gc.isenabled()
    with launch_count.Capture():
        assert not gc.isenabled()
        with launch_count.Capture():
            assert not gc.isenabled()
        assert not gc.isenabled()
    assert gc.isenabled()

    with pytest.raises(RuntimeError, match="capture failed"):
        with launch_count.Capture():
            raise RuntimeError("capture failed")
    assert gc.isenabled()

    inside, release = threading.Event(), threading.Event()

    def other():
        with launch_count.Capture():
            inside.set()
            release.wait(10)

    t = threading.Thread(target=other)
    t.start()
    inside.wait(10)
    with launch_count.Capture():
        pass
    assert not gc.isenabled()       # the other thread's capture is open
    release.set()
    t.join(10)
    assert gc.isenabled()

    gc.disable()
    try:
        with launch_count.Capture():
            pass
        assert not gc.isenabled()   # off before: stays off
    finally:
        gc.enable()
