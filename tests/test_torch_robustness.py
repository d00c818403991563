"""The port's fault-tolerant runtime (``paddle_tpu_torch.robustness``) on
the CPU, mirroring ``tests/test_robustness.py``: the chaos grammar (its
parsed rules and seeded draws equal to the JAX package's),
``CheckpointManager`` (round trip, torn and corrupt serials, trim,
``collect``), ``io.save_checkpoint``, ``train_loop`` (retries, the fatal
error, the fetch boundary, preemption inside a retry cycle, the
watchdog's pause) and liveness. Two proofs beyond the mirror:

- a serial written by either package's ``CheckpointManager`` restores
  through the other's with equal arrays (fp32 and int32) and an equal
  TRAIN_STATE;
- a child process running a 1-layer, 32-wide LM under ``train_loop``
  sends itself SIGTERM after two rounds, exits 42 with a valid serial,
  and its relaunch resumes to persistables and a loss bitwise those of
  an uninterrupted child (``chip_smoke.resume_gate`` on the CPU).
"""

from tests import torch_threads  # noqa: F401  (first)
import os
import time

import numpy as np
import pytest
import torch

import chip_smoke as cs
import paddle_tpu as jfluid
from paddle_tpu import robustness as jrobustness
from paddle_tpu import unique_name as junique
from paddle_tpu.executor import Scope as JScope
from paddle_tpu.executor import scope_guard as jscope_guard
from paddle_tpu.robustness import chaos as jchaos

import paddle_tpu_torch as fluid
from paddle_tpu_torch import io as pio
from paddle_tpu_torch import robustness
from paddle_tpu_torch import unique_name as punique
from paddle_tpu_torch.convert import scope_from_jax
from paddle_tpu_torch.executor import Scope, global_scope, scope_guard
from paddle_tpu_torch.observability import liveness
from paddle_tpu_torch.robustness import chaos as chaos_mod
from paddle_tpu_torch.serving.generation import DeviceStateError


@pytest.fixture(autouse=True)
def _fresh_liveness():
    liveness.reset()
    yield
    liveness.reset()


# -- chaos spec grammar -----------------------------------------------------

SPECS = ["step:37=raise, save:2=kill9, fetch:*=raise@0.25, step:5=hang30,"
         "step:1=sigterm, step:0=fatal", "", "handoff:3=hang",
         "save:*=raise@1", "fetch:0=fatal@0.5, step:12=hang2.5"]


@pytest.mark.parametrize("spec", SPECS)
def test_chaos_spec_parses_as_the_reference(spec):
    def fields(rules):
        return [(r.point, r.selector, r.action, r.hang_s, r.prob, repr(r))
                for r in rules]
    assert fields(chaos_mod.parse_chaos_spec(spec)) == \
        fields(jchaos.parse_chaos_spec(spec))


def test_chaos_spec_parses_documented_grammar():
    rules = chaos_mod.parse_chaos_spec(SPECS[0])
    assert [(r.point, r.selector, r.action) for r in rules] == [
        ("step", 37, "raise"), ("save", 2, "kill9"),
        ("fetch", "*", "raise"), ("step", 5, "hang"),
        ("step", 1, "sigterm"), ("step", 0, "fatal")]
    assert rules[2].prob == 0.25 and rules[3].hang_s == 30.0


@pytest.mark.parametrize("bad", [
    "nonsense", "step:x=raise", "tea:0=raise", "step:0=explode",
    "step:0=raise@1.5", "step:-1=raise"])
def test_chaos_spec_rejects_bad_rules(bad):
    with pytest.raises(ValueError):
        chaos_mod.parse_chaos_spec(bad)
    with pytest.raises(ValueError):
        jchaos.parse_chaos_spec(bad)


def test_chaos_injector_fires_at_exact_index():
    inj = chaos_mod.ChaosInjector("step:2=raise", seed=0)
    inj.fire("step")
    inj.fire("step")
    with pytest.raises(chaos_mod.ChaosError):
        inj.fire("step")
    inj.fire("step")  # index 3: past the rule, quiet again


def test_chaos_fatal_action_raises_device_state_error():
    inj = chaos_mod.ChaosInjector("step:0=fatal", seed=0)
    with pytest.raises(DeviceStateError):
        inj.fire("step")


def test_chaos_probabilistic_draws_match_the_reference():
    def draws(mod, seed):
        inj = mod.ChaosInjector("step:*=raise@0.5", seed=seed)
        hits = []
        for _ in range(40):
            try:
                inj.fire("step")
                hits.append(0)
            except mod.ChaosError:
                hits.append(1)
        return hits

    a, b, c = draws(chaos_mod, 7), draws(chaos_mod, 7), draws(chaos_mod, 8)
    assert a == b and a != c and 0 < sum(a) < 40
    assert a == draws(jchaos, 7) and c == draws(jchaos, 8)


def test_set_injector_pins_over_flag():
    inj = chaos_mod.ChaosInjector("step:0=raise", seed=0)
    chaos_mod.set_injector(inj)
    try:
        assert chaos_mod.get_injector() is inj
        with pytest.raises(chaos_mod.ChaosError):
            chaos_mod.maybe_fire("step")
    finally:
        chaos_mod.set_injector(None)
    assert chaos_mod.get_injector() is None


# -- CheckpointManager ------------------------------------------------------

def _train_program(pkg=fluid, unique=punique, batch=4, dim=3):
    """A 3 → 4 classifier (fc, softmax cross-entropy, Adam) and an int32
    persistable ``counter_i`` the program does not touch."""
    with unique.guard():
        prog, startup = pkg.Program(), pkg.Program()
        prog.random_seed = 0
        with pkg.program_guard(prog, startup):
            x = pkg.layers.data(name="x", shape=[batch, dim],
                                dtype="float32", append_batch_size=False)
            y = pkg.layers.data(name="y", shape=[batch, 1], dtype="int64",
                                append_batch_size=False)
            pred = pkg.layers.fc(x, size=4)
            loss = pkg.layers.mean(
                pkg.layers.softmax_with_cross_entropy(pred, y))
            pkg.optimizer.Adam(learning_rate=1e-2).minimize(loss)
            prog.global_block().create_var(name="counter_i", shape=[1],
                                           dtype="int32", persistable=True)
    return prog, startup, loss


def _feed(step, batch=4, dim=3):
    rng = np.random.RandomState(100 + step)
    x = rng.randn(batch, dim).astype(np.float32)
    return {"x": x, "y": (x.argmax(1)[:, None]).astype(np.int64)}


def _exe():
    return fluid.Executor(fluid.CPUPlace())


def test_checkpoint_manager_roundtrip_restores_trajectory(tmp_path):
    prog, startup, loss = _train_program()
    ck = robustness.CheckpointManager(dirname=str(tmp_path),
                                      every_steps=2, keep=3)
    with scope_guard(Scope()):
        exe = _exe()
        exe.run(startup)
        for i in range(3):
            exe.run(prog, feed=_feed(i), fetch_list=[loss])
        serial = ck.save(prog, global_scope(), step=3, executor=exe,
                         data_state={"next": 3}, block=True)
        (l3,) = exe.run(prog, feed=_feed(3), fetch_list=[loss])
    assert serial == 0
    found = ck.latest_valid()
    assert found is not None and found[0] == 0
    state = found[1]
    assert state["step"] == 3 and state["data_state"] == {"next": 3}
    assert state["executor_step"] == 4  # startup + 3 train steps
    with scope_guard(Scope()):
        exe2 = _exe()
        exe2.run(startup)  # re-init, then restore overwrites
        st = ck.restore(global_scope(), executor=exe2)
        assert st["serial"] == 0 and st["step"] == 3
        assert exe2.step_counter == 4
        (l3b,) = exe2.run(prog, feed=_feed(3), fetch_list=[loss])
    np.testing.assert_array_equal(l3, l3b)


def test_latest_valid_skips_torn_and_corrupt_serials(tmp_path):
    prog, startup, loss = _train_program()
    ck = robustness.CheckpointManager(dirname=str(tmp_path), keep=5)
    with scope_guard(Scope()):
        exe = _exe()
        exe.run(startup)
        for step in (1, 2, 3):
            exe.run(prog, feed=_feed(step), fetch_list=[loss])
            ck.save(prog, global_scope(), step=step, executor=exe,
                    block=True)
    os.remove(str(tmp_path / "2" / "_MANIFEST"))          # torn
    victim = next(p for p in (tmp_path / "1").iterdir()
                  if p.name != "_MANIFEST")
    victim.write_bytes(b"\x00rotten")                     # corrupt
    with pytest.warns(UserWarning):
        found = ck.latest_valid()
    assert found is not None and found[0] == 0 and found[1]["step"] == 1


def test_latest_valid_none_when_nothing_loadable(tmp_path):
    assert robustness.CheckpointManager(
        dirname=str(tmp_path)).latest_valid() is None


def test_checkpoint_background_write_and_trim(tmp_path):
    prog, startup, loss = _train_program()
    ck = robustness.CheckpointManager(dirname=str(tmp_path),
                                      every_steps=1, keep=2)
    with scope_guard(Scope()):
        exe = _exe()
        exe.run(startup)
        exe.run(prog, feed=_feed(0), fetch_list=[loss])
        for step in (1, 2, 3, 4):
            assert ck.should_save(step)
            ck.save(prog, global_scope(), step=step, executor=exe)
        ck.wait()
    remaining = sorted(int(s) for s in os.listdir(tmp_path) if s.isdigit())
    assert remaining == [2, 3]
    assert ck.latest_valid()[1]["step"] == 4
    ck.close()


def test_collect_skips_host_objects_in_persistable_slots(tmp_path):
    prog, startup, loss = _train_program()
    ck = robustness.CheckpointManager(dirname=str(tmp_path))
    with scope_guard(Scope()):
        exe = _exe()
        exe.run(startup)
        exe.run(prog, feed=_feed(0), fetch_list=[loss])
        victim = next(n for n in ck.collect(prog, global_scope()))
        global_scope().set_var(victim, object())
        snap = ck.collect(prog, global_scope())
        assert victim not in snap and snap
        ck.save(prog, global_scope(), step=1, executor=exe, block=True)
        assert ck.restore(Scope()) is not None


def test_sharded_serials_are_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="sharded"):
        robustness.CheckpointManager(dirname=str(tmp_path), sharded=True)


def test_resume_refuses_train_state_less_serial(tmp_path):
    prog, startup, loss = _train_program()
    with scope_guard(Scope()):
        exe = _exe()
        exe.run(startup)
        exe.run(prog, feed=_feed(0), fetch_list=[loss])
        pio.save_checkpoint(exe, str(tmp_path), main_program=prog)
        ck = robustness.CheckpointManager(dirname=str(tmp_path))
        assert ck.latest_valid()[1] is None
        with pytest.warns(UserWarning, match="no TRAIN_STATE"):
            assert robustness.resume_or_init(
                ck, scope=global_scope(), executor=exe) == (0, None)


def test_save_checkpoint_trims_only_older_serials_and_loads(tmp_path):
    prog, startup, loss = _train_program()
    with scope_guard(Scope()):
        exe = _exe()
        exe.run(startup)
        global_scope().set_var("counter_i",
                               torch.tensor([7], dtype=torch.int32))
        for _ in range(3):
            pio.save_checkpoint(exe, str(tmp_path), main_program=prog,
                                max_num_checkpoints=2)
        assert sorted(int(s) for s in os.listdir(tmp_path)
                      if s.isdigit()) == [1, 2]
        os.makedirs(str(tmp_path / "99"))
        pio.save_checkpoint(exe, str(tmp_path), main_program=prog,
                            max_num_checkpoints=2)
        want = {n: global_scope().find_var(n).clone()
                for n in global_scope().local_var_names()}
    assert sorted(int(s) for s in os.listdir(tmp_path)
                  if s.isdigit()) == [99, 100]
    with scope_guard(Scope()):
        exe = _exe()
        # 100 is newest; 99 (no manifest) is never tried
        assert pio.load_checkpoint(exe, str(tmp_path),
                                   main_program=prog) == 100
        for n, t in want.items():
            assert torch.equal(global_scope().find_var(n), t), n


def test_save_and_load_persistables_round_trip(tmp_path):
    prog, startup, loss = _train_program()
    with scope_guard(Scope()):
        exe = _exe()
        exe.run(startup)
        global_scope().set_var("counter_i",
                               torch.tensor([7], dtype=torch.int32))
        exe.run(prog, feed=_feed(0), fetch_list=[loss])
        pio.save_persistables(exe, str(tmp_path / "one"), prog)
        pio.save_params(exe, str(tmp_path / "comb"), prog,
                        filename="params")
        want = {n: global_scope().find_var(n).clone()
                for n in global_scope().local_var_names()}
    with scope_guard(Scope()):
        exe = _exe()
        pio.load_persistables(exe, str(tmp_path / "one"), prog)
        pio.load_params(exe, str(tmp_path / "comb"), prog, filename="params")
        got = global_scope()
        for n, t in want.items():
            assert torch.equal(got.find_var(n), t), n
    with pytest.raises(RuntimeError, match="host-side ops"):
        _exe().run_steps(pio._build_save_program(
            list(prog.list_vars())[:1], str(tmp_path)), n_steps=2)


# -- serials across the two packages ---------------------------------------

def _jax_run(tmp_path, steps):
    prog, startup, loss = _train_program(jfluid, junique)
    scope = JScope()
    with jscope_guard(scope):
        exe = jfluid.Executor(jfluid.TPUPlace())
        exe.run(startup)
        scope.set_var("counter_i", np.array([7], np.int32))
        for i in range(steps):
            exe.run(prog, feed=_feed(i), fetch_list=[loss])
    return prog, exe, scope


def test_a_port_serial_restores_in_the_reference_and_back(tmp_path):
    # reference → port
    jprog, jexe, jscope = _jax_run(tmp_path, 2)
    jck = jrobustness.CheckpointManager(dirname=str(tmp_path / "j"))
    jck.save(jprog, jscope, step=2, executor=jexe, data_state={"pos": 5},
             block=True)
    want = {n: np.asarray(v) for n, v in jscope.vars.items()
            if v is not None}
    pck = robustness.CheckpointManager(dirname=str(tmp_path / "j"))
    assert pck.latest_valid() == jck.latest_valid()
    pscope, pexe = Scope(), _exe()
    state = pck.restore(pscope, executor=pexe)
    assert state["step"] == 2 and state["data_state"] == {"pos": 5}
    assert pexe.step_counter == state["executor_step"] == 3
    assert sorted(pscope.local_var_names()) == sorted(want)
    for n, arr in want.items():
        got = pscope.find_var(n)
        assert got.numpy().dtype == arr.dtype, n
        np.testing.assert_array_equal(got.numpy(), arr, err_msg=n)
    assert pscope.find_var("counter_i").dtype == torch.int32

    # port → reference: train on in the port, save, restore in JAX
    pprog, _, ploss = _train_program()
    pexe.run(pprog, feed=_feed(2), fetch_list=[ploss], scope=pscope)
    pck2 = robustness.CheckpointManager(dirname=str(tmp_path / "p"))
    pck2.save(pprog, pscope, step=3, executor=pexe, data_state={"pos": 6},
              block=True)
    jck2 = jrobustness.CheckpointManager(dirname=str(tmp_path / "p"))
    assert jck2.latest_valid() == pck2.latest_valid()
    jscope2 = JScope()
    jexe2 = jfluid.Executor(jfluid.TPUPlace())
    jstate = jck2.restore(jscope2, executor=jexe2)
    assert jstate["step"] == 3 and jstate["data_state"] == {"pos": 6}
    assert jexe2.step_counter == 4
    for n in want:
        np.testing.assert_array_equal(np.asarray(jscope2.find_var(n)),
                                      pscope.find_var(n).numpy(),
                                      err_msg=n)
    # and the two packages continue from the restored state alike
    back = scope_from_jax({n: np.asarray(v) for n, v in
                           jscope2.vars.items()}, device="cpu")
    jprog2, _, jloss2 = _train_program(jfluid, junique)
    with jscope_guard(jscope2):
        jl = jexe2.run(jprog2, feed=_feed(3), fetch_list=[jloss2])[0]
    pl = pexe.run(pprog, feed=_feed(3), fetch_list=[ploss], scope=back)[0]
    np.testing.assert_allclose(pl, jl, rtol=1e-5)


# -- train_loop -------------------------------------------------------------

def test_train_loop_retries_transient_then_succeeds():
    calls = []

    def step_fn(i):
        calls.append(i)
        if len(calls) == 2:
            raise OSError("transient host weather")
        return i

    res = robustness.train_loop(step_fn, 3, retry_backoff_s=0.01,
                                max_retries=2, preempt_signals=())
    assert res.step == 3 and res.retries == 1
    assert calls == [0, 1, 1, 2]


def test_train_loop_retry_budget_exhausts():
    def step_fn(i):
        raise OSError("permanent weather")

    with pytest.raises(OSError):
        robustness.train_loop(step_fn, 2, retry_backoff_s=0.01,
                              max_retries=2, preempt_signals=())


def test_train_loop_fatal_never_retried():
    calls = []

    def step_fn(i):
        calls.append(i)
        raise DeviceStateError("buffers gone")

    with pytest.raises(DeviceStateError):
        robustness.train_loop(step_fn, 3, retry_backoff_s=0.01,
                              max_retries=5, preempt_signals=())
    assert calls == [0]


def test_fetch_boundary_failure_never_reruns_committed_step():
    calls = []

    def step_fn(i):
        calls.append(i)
        return i

    with pytest.raises(chaos_mod.ChaosError):
        robustness.train_loop(
            step_fn, 4, retry_backoff_s=0.01, max_retries=5,
            preempt_signals=(),
            chaos=chaos_mod.ChaosInjector("fetch:1=raise", seed=0))
    assert calls == [0, 1]


def test_classify_failure():
    assert robustness.classify_failure(OSError()) == "retryable"
    assert robustness.classify_failure(TimeoutError()) == "retryable"
    assert robustness.classify_failure(
        chaos_mod.ChaosError("x")) == "retryable"
    assert robustness.classify_failure(DeviceStateError("x")) == "fatal"
    assert robustness.classify_failure(FloatingPointError()) == "fatal"
    assert robustness.classify_failure(ValueError()) == "fatal"


def _loop_losses(prog, startup, loss, n_steps, checkpoint=None,
                 chaos=None, sink=None):
    sink = {} if sink is None else sink
    with scope_guard(Scope()):
        exe = _exe()
        exe.run(startup)

        def step_fn(i):
            (lv,) = exe.run(prog, feed=_feed(i), fetch_list=[loss])
            sink[i] = float(lv.ravel()[0])
            return sink[i]

        res = robustness.train_loop(
            step_fn, n_steps, program=prog, executor=exe,
            checkpoint=checkpoint, chaos=chaos, retry_backoff_s=0.01,
            preempt_signals=())
        if checkpoint is not None:
            checkpoint.wait()
        return res


def test_train_loop_chaos_injection_and_resume(tmp_path):
    prog, startup, loss = _train_program()
    first = {}
    ck = robustness.CheckpointManager(dirname=str(tmp_path),
                                      every_steps=2, keep=4)
    res = _loop_losses(prog, startup, loss, 4, checkpoint=ck,
                       chaos=chaos_mod.ChaosInjector("step:1=raise",
                                                     seed=0),
                       sink=first)
    assert res.retries == 1 and res.step == 4 and res.resumed_from is None
    resumed = {}
    res2 = _loop_losses(prog, startup, loss, 6,
                        checkpoint=robustness.CheckpointManager(
                            dirname=str(tmp_path), every_steps=2, keep=4),
                        sink=resumed)
    assert res2.resumed_from is not None and res2.step == 6
    assert sorted(resumed) == [4, 5]
    ref = {}
    _loop_losses(prog, startup, loss, 6, sink=ref)
    for i in range(4):
        assert first[i] == ref[i]
    for i in (4, 5):
        assert resumed[i] == ref[i]


def test_preemption_honored_during_retry_cycle():
    import signal
    calls = []

    def step_fn(i):
        calls.append(i)
        if i == 1:
            os.kill(os.getpid(), signal.SIGTERM)
            raise OSError("transient failure racing a preemption")
        return i

    res = robustness.train_loop(step_fn, 10, retry_backoff_s=30.0,
                                max_retries=5, exit_on_preempt=False)
    assert res.preempted and res.step == 1 and calls == [0, 1]


def test_watchdog_pause_disarms_liveness_deadline():
    wd = robustness.HangWatchdog(0.5)
    wd.start()
    try:
        wd.pause()
        time.sleep(1.2)
        assert liveness.status()["healthy"]
        assert liveness.status()["watchdog_deadline_s"] is None
        wd.resume()
        assert liveness.status()["watchdog_deadline_s"] == 0.5
        assert liveness.status()["healthy"]
    finally:
        wd.stop()
    assert liveness.status()["watchdog_deadline_s"] is None


def test_hang_watchdog_beats_keep_it_quiet():
    wd = robustness.HangWatchdog(0.2)
    wd.start()
    try:
        for _ in range(4):
            time.sleep(0.05)
            wd.beat()
        assert liveness.status()["watchdog_deadline_s"] == 0.2
    finally:
        wd.stop()


def test_liveness_status_and_executor_steps_stamp_it():
    st = liveness.status()
    assert st["healthy"] and st["last_step"] is None
    prog, startup, loss = _train_program()
    with scope_guard(Scope()):
        exe = _exe()
        exe.run(startup)
        exe.run_steps(prog, feed=_feed(0), n_steps=3, fetch_list=[loss])
    st = liveness.status()
    assert st["last_step"] == 3 and st["last_step_age_s"] < 60
    liveness.set_deadline(0.05)
    time.sleep(0.12)
    assert liveness.status()["status"] == "stalled"
    liveness.set_deadline(None)
    assert liveness.status()["healthy"]


# -- preemption in a child process ------------------------------------------

def test_a_sigtermed_child_exits_42_and_resumes_bitwise(tmp_path):
    """The preemption gate of ``chip_smoke.py`` on the CPU: a 1-layer,
    32-wide LM, 4 rounds of 2 ``run_steps`` steps; every child has its
    own timeout (``RESUME_TIMEOUT_S``)."""
    res = cs.resume_gate(str(tmp_path), device="cpu", sizes={
        "layers": 1, "dim": 32, "heads": 2, "vocab": 97, "batch": 2,
        "seq": 32, "rounds": 4, "round_steps": 2})
    assert res["exit_codes"] == {"whole": 0, "preempted": 42, "resumed": 0}
    assert res["serial_step"] == 2 and res["resumed_from"] == res["serial"]
    assert res["resumed_at_step_counter"] == 1 + 2 * 2
    assert res["loss_bitwise"] and res["persistables_differing"] == []
    assert res["persistables"] > 0
