"""The port's ``bench_lm.py`` (``paddle_tpu_torch.benchmarks.lm``) on the
CPU at a small size: 2 layers, 64 wide, 2 heads, vocab 97, batch 2, seq
64, 2-step rounds.

- With ``BENCH_FORCE_CPU=1`` it prints one JSON line with the keys the
  reference's ``main()`` / ``packed_main()`` print (read from
  ``bench_lm.py``'s source).
- Without a card and without that flag it prints the failure JSON line
  and exits 1: it never falls back to the CPU.
- From one state (the JAX startup's, carried with
  ``convert.scope_from_jax``), the port's ``_measure_rounds`` gives the
  losses the reference program (``bench_lm._build_lm``) gives through
  ``Executor.run_steps``, round by round: within 1e-5 relative in fp32
  (summation order only), and within 5e-3 relative under mixed
  precision (bf16 rounds at other places in the two packages, as in
  ``test_torch_train.py``).
"""

from tests import torch_threads  # noqa: F401  (first)
import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import bench_lm
import paddle_tpu as jfluid
from paddle_tpu import unique_name as junique
from paddle_tpu.executor import Scope as JScope
from paddle_tpu.executor import scope_guard as jscope_guard

import paddle_tpu_torch as pfluid
from paddle_tpu_torch import unique_name as punique
from paddle_tpu_torch.benchmarks import lm
from paddle_tpu_torch.convert import scope_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the model's sizes, which bench_lm.py fixes, cut in the module; the
# rounds' sizes through the environment knobs
SIZES = {"LAYERS": 2, "D_MODEL": 64, "HEADS": 2, "VOCAB": 97}
SMALL = {"BENCH_BATCH": "2", "BENCH_SEQ": "64", "BENCH_ITERS": "2",
         "BENCH_WARMUP": "2", "BENCH_ROUNDS": "3"}
ITERS, WARM_ROUNDS, ROUNDS = 2, 1, 3
# what ``python -m paddle_tpu_torch.benchmarks.lm`` runs, at SIZES
ENTRY = ("from paddle_tpu_torch.benchmarks import common, lm\n"
         "vars(lm).update(%r)\n"
         "common.run_guarded(lm.main, lm.METRIC, lm.UNIT)\n" % SIZES)


def reference_keys(function):
    """The keys of the dict ``function`` of bench_lm.py prints."""
    tree = ast.parse(open(os.path.join(REPO, "bench_lm.py")).read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == function)
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and \
                getattr(node.func, "attr", "") == "dumps" and \
                isinstance(node.args[0], ast.Dict):
            return {k.value for k in node.args[0].keys}
    raise AssertionError("no json.dumps dict in bench_lm.%s" % function)


def run_bench(args, **env):
    full = {k: v for k, v in os.environ.items()
            if not k.startswith("BENCH_")}
    full.update(PYTHONPATH=REPO, **env)
    return subprocess.run([sys.executable] + args, cwd=REPO,
                          env=full, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("packed", ["0", "1"], ids=["dense", "packed"])
def test_prints_the_reference_keys_on_the_forced_cpu(packed):
    out = run_bench(["-c", ENTRY], BENCH_FORCE_CPU="1", BENCH_PACKED=packed,
                    **SMALL)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    want = reference_keys("packed_main" if packed == "1" else "main")
    assert set(rec) == want
    assert rec["metric"] == bench_lm.METRIC and rec["unit"] == bench_lm.UNIT
    assert rec["value"] > 0
    if packed == "0":
        assert rec["mfu"] is None            # no card: no peak to divide by
        # startup + 4 rounds of 2 steps; misses: startup and step programs
        assert rec["steps"] == 1 + (WARM_ROUNDS + ROUNDS) * ITERS
        assert rec["compile_cache_misses"] == 2
        assert np.isfinite(rec["loss"]) and rec["device_wait_s"] >= 0
    else:
        assert rec["packed"] is True and rec["speedup_vs_padded_ragged"] > 0


def test_refuses_the_cpu_unless_asked():
    out = run_bench(["-m", "paddle_tpu_torch.benchmarks.lm"], **SMALL)
    assert out.returncode == 1
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1                   # no bench line before it
    rec = json.loads(lines[0])
    assert rec["value"] is None and rec["metric"] == bench_lm.METRIC
    assert "no CUDA device" in rec["error"]
    assert "BENCH_FORCE_CPU" in rec["error"]


class _Recording:
    """An executor that keeps each ``run_steps`` result."""

    def __init__(self, exe):
        self.exe, self.handles = exe, []

    def run_steps(self, *args, **kwargs):
        out = self.exe.run_steps(*args, **kwargs)
        self.handles.append(out)
        return out

    def __getattr__(self, name):
        return getattr(self.exe, name)


def _small(monkeypatch):
    for mod in (bench_lm, lm):
        for name, value in SIZES.items():
            monkeypatch.setattr(mod, name, value)


@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp"])
def test_measured_rounds_match_the_reference_program(monkeypatch, amp):
    _small(monkeypatch)
    b, s = 2, 64
    with junique.guard():
        jprog, jstart, jloss = bench_lm._build_lm(b, s)
    with punique.guard():
        pprog, _, ploss = lm._build_lm(b, s)
    jfluid.enable_mixed_precision(jprog, amp)
    pfluid.enable_mixed_precision(pprog, amp)
    rng = np.random.RandomState(0)
    ids = rng.randint(1, 97, (b, s)).astype(np.int32)
    valid = np.ones((b, s), np.int32)
    valid[1, 40:] = 0
    lab = np.roll(ids, -1, 1).astype(np.int32)
    feed = {"ids": ids, "labels": lab, "valid": valid}
    scope = JScope()
    with jscope_guard(scope):
        jexe = jfluid.Executor(jfluid.TPUPlace())
        jexe.run(jstart)
        state = {n: np.asarray(v) for n, v in scope.vars.items()
                 if v is not None}
        want = [float(np.asarray(jexe.run_steps(
            jprog, feed=feed, n_steps=ITERS, fetch_list=[jloss])[0])
            .ravel()[0]) for _ in range(WARM_ROUNDS + ROUNDS)]
    exe = _Recording(pfluid.Executor(pfluid.CPUPlace()))
    with pfluid.scope_guard(scope_from_jax(state, device="cpu")):
        dt, last = lm._measure_rounds(exe, pprog, ploss, feed, ITERS,
                                      WARM_ROUNDS, ROUNDS)
    got = [float(h.numpy()[0].ravel()[0]) for h in exe.handles]
    assert dt > 0 and last is exe.handles[-1]
    assert len(got) == WARM_ROUNDS + ROUNDS and got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=5e-3 if amp else 1e-5)
