"""``paddle_tpu_torch.benchmarks.resnet`` against ``bench.py``.

- The program, op for op and name for name, as the JAX package builds
  ``bench.py``'s (``bench.py:70-84``) under the pure-bf16 recipe, the
  default fp8 recipe (e5m2 conv outputs) and ``delayed`` (one scale var a
  conv), with the same FLOP estimate.
- The knobs and their defaults; the JSON keys of ``bench.py``'s line;
  the fp8 environment and ``precision`` string for every
  ``BENCH_FP8_ACTS`` x ``BENCH_FP8_CONV_OUT`` combination, against
  ``bench.py``'s own statements (read from its source and run).
- The three-line bench with its child commands pointed at stub
  scripts: the environment filter, the forwarded lines, a crash, a
  silent child, a timeout and non-JSON output recorded as ``error``, the
  ``submetrics`` fold.
- ``main()`` under ``BENCH_FORCE_CPU=1`` at depth 18 on 32x32 images:
  the three lines with stub children; without a card and
  ``BENCH_FORCE_CPU`` the module prints the failure line and exits 1.
"""

from tests import torch_threads  # noqa: F401  (first)
import ast
import importlib
import json
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

import paddle_tpu as jfluid
from paddle_tpu import models as jmodels
from paddle_tpu import unique_name as junique
from paddle_tpu.flops import estimate_program_flops as jflops

from paddle_tpu_torch import unique_name as punique
from paddle_tpu_torch.benchmarks import resnet
from paddle_tpu_torch.flops import estimate_program_flops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_PY = os.path.join(REPO, "bench.py")


def _bench_main():
    tree = ast.parse(open(BENCH_PY).read())
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                and n.name == "main")


def reference_keys():
    """The keys of ``bench.py``'s JSON line: its ``line = {...}`` dict and
    the ``submetrics`` it adds."""
    for node in ast.walk(_bench_main()):
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", "") == "line":
            return {k.value for k in node.value.keys} | {"submetrics"}
    raise AssertionError("no line dict in bench.py")


def reference_recipe(environ):
    """Run ``bench.py``'s fp8 statements (``fp8_acts = ...`` through the
    conv-out ``if``) and its ``precision`` expression on a copy of
    ``environ``: (environment after, precision)."""
    body = _bench_main().body
    first = next(i for i, n in enumerate(body) if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", "") == "fp8_acts")
    stmts = body[first:first + 4]
    env = dict(environ)
    ns = {"os": types.SimpleNamespace(environ=env)}
    exec(compile(ast.Module(body=stmts, type_ignores=[]), BENCH_PY, "exec"),
         ns)
    prec = next(v for n in ast.walk(_bench_main()) if isinstance(n, ast.Dict)
                for k, v in zip(n.keys, n.values)
                if getattr(k, "value", None) == "precision")
    ns["AMP"] = True
    return env, eval(compile(ast.Expression(prec), BENCH_PY, "eval"), ns)


def jax_program(depth, image, classes, layout):
    """``bench.py:70-84`` through the JAX package."""
    with junique.guard():
        prog, startup = jfluid.Program(), jfluid.Program()
        with jfluid.program_guard(prog, startup):
            images = jfluid.layers.data(name="images",
                                        shape=[3, image, image],
                                        dtype="float32")
            label = jfluid.layers.data(name="label", shape=[1],
                                       dtype="int64")
            pred = jmodels.resnet_imagenet(images, class_dim=classes,
                                           depth=depth, data_format=layout)
            loss = jfluid.layers.mean(
                jfluid.layers.cross_entropy(input=pred, label=label))
            jfluid.optimizer.Momentum(learning_rate=0.01, momentum=0.9) \
                .minimize(loss)
        jfluid.enable_mixed_precision(prog, True)
    return prog, startup, loss


@pytest.mark.parametrize("recipe", [{"BENCH_FP8_ACTS": "0"}, {},
                                    {"BENCH_FP8_CONV_OUT": "delayed"}],
                         ids=["bf16", "fp8-default", "fp8-delayed"])
def test_program_is_bench_pys(monkeypatch, recipe):
    for k in ("BENCH_FP8_ACTS", "BENCH_FP8_CONV_OUT"):
        monkeypatch.delenv(k, raising=False)
    for k in ("PADDLE_TPU_FP8_ACTS", "PADDLE_TPU_FP8_CONV_OUT"):
        monkeypatch.setenv(k, "")       # fp8_recipe sets them; restored
    for k, v in recipe.items():
        monkeypatch.setenv(k, v)
    resnet.fp8_recipe()
    with punique.guard():
        prog, startup, loss = resnet.build_program()
    jprog, jstart, jloss = jax_program(50, 224, 1000, "NHWC")
    for a, b in ((prog, jprog), (startup, jstart)):
        assert [op.type for op in a.global_block().ops] == \
            [op.type for op in b.global_block().ops]
        assert sorted(v.name for v in a.list_vars()) == \
            sorted(v.name for v in b.list_vars())
    assert loss.name == jloss.name and prog._amp
    scales = [op.inputs.get("Fp8Scale") for op in prog.global_block().ops
              if op.type == "conv2d"]
    assert len(scales) == 53
    assert all(scales) == (recipe.get("BENCH_FP8_CONV_OUT") == "delayed")
    assert estimate_program_flops(prog, 256, training=True) == \
        jflops(jprog, 256, training=True)


@pytest.mark.parametrize("depth,layout", [(18, "NCHW"), (34, "NHWC")])
def test_program_keywords_build_the_smaller_models(monkeypatch, depth,
                                                   layout):
    """``build_program``'s size keywords (what the tests train with) build
    ``bench.py``'s program at that depth, image size and layout."""
    for k in ("PADDLE_TPU_FP8_ACTS", "PADDLE_TPU_FP8_CONV_OUT"):
        monkeypatch.setenv(k, "")
    with punique.guard():
        prog, _, loss = resnet.build_program(depth=depth, image=32,
                                             classes=10, layout=layout)
    jprog, _, jloss = jax_program(depth, 32, 10, layout)
    assert [op.type for op in prog.global_block().ops] == \
        [op.type for op in jprog.global_block().ops]
    assert sorted(v.name for v in prog.list_vars()) == \
        sorted(v.name for v in jprog.list_vars())


def test_knobs_and_their_defaults(monkeypatch):
    for k in list(os.environ):
        if k.startswith("BENCH_"):
            monkeypatch.delenv(k)
    try:
        mod = importlib.reload(resnet)
        assert (mod.BATCH, mod.WARMUP, mod.ITERS, mod.ROUNDS, mod.LAYOUT) \
            == (256, 3, 100, 3, "NHWC")
        assert (mod.DEPTH, mod.IMAGE, mod.CLASSES) == (50, 224, 1000)
        assert mod.BASELINE_IMG_PER_SEC == 82.35
        for k, v in (("BENCH_BATCH", "8"), ("BENCH_WARMUP", "0"),
                     ("BENCH_ITERS", "2"), ("BENCH_ROUNDS", "1"),
                     ("BENCH_LAYOUT", "nchw")):
            monkeypatch.setenv(k, v)
        mod = importlib.reload(resnet)
        assert (mod.BATCH, mod.WARMUP, mod.ITERS, mod.ROUNDS, mod.LAYOUT) \
            == (8, 0, 2, 1, "NCHW")
        monkeypatch.setenv("BENCH_LAYOUT", "HWCN")
        with pytest.raises(AssertionError, match="NCHW or NHWC"):
            importlib.reload(resnet)
    finally:
        for k in list(os.environ):
            if k.startswith("BENCH_"):
                monkeypatch.delenv(k)
        importlib.reload(resnet)


@pytest.mark.parametrize("acts", [None, "1", "0"])
@pytest.mark.parametrize("conv", [None, "", "0", "1", "e4m3", "e5m2",
                                  "scaled", "delayed"])
def test_fp8_environment_and_precision_are_bench_pys(monkeypatch, acts,
                                                     conv):
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("BENCH_FP8", "PADDLE_TPU_FP8"))}
    if acts is not None:
        base["BENCH_FP8_ACTS"] = acts
    if conv is not None:
        base["BENCH_FP8_CONV_OUT"] = conv
    want_env, want_prec = reference_recipe(base)
    monkeypatch.setattr(os, "environ", dict(base))
    fp8_acts, fp8_conv = resnet.fp8_recipe()
    assert os.environ == want_env
    assert resnet.precision(fp8_acts, fp8_conv) == want_prec
    if acts is None and conv is None:
        assert want_prec == "bf16+fp8-acts+fp8-convout-e5m2"


STUB = textwrap.dedent('''
    import json, os, sys, time
    mode = sys.argv[1]
    if mode == "ok":
        print("a log line")
        print(json.dumps({"metric": "m_" + sys.argv[2], "value": 1.5,
                          "unit": "u", "mfu": 0.25, "extra": 7,
                          "env": sorted(k for k in os.environ
                                        if k.startswith("BENCH_"))}))
    elif mode == "crash":
        print("first\\nsecond\\nthird", file=sys.stderr)
        sys.exit(3)
    elif mode == "garbage":
        print("not json")
    elif mode == "sleep":
        time.sleep(30)
''')


def _stubs(tmp_path, monkeypatch, lm="ok", nmt="ok", timeout=None):
    path = tmp_path / "stub.py"
    path.write_text(STUB)
    monkeypatch.setattr(resnet, "SECONDARY", (
        ("lm", [sys.executable, str(path), lm, "lm"]),
        ("nmt", [sys.executable, str(path), nmt, "nmt"])))
    if timeout:
        monkeypatch.setattr(resnet, "SECONDARY_TIMEOUT_S", timeout)


def test_secondary_benches_filter_the_env_and_fold_submetrics(tmp_path, monkeypatch,
                                                      capsys):
    _stubs(tmp_path, monkeypatch)
    monkeypatch.delenv("BENCH_RESNET_ONLY", raising=False)
    for k, v in (("BENCH_ITERS", "2"), ("BENCH_ROUNDS", "1"),
                 ("BENCH_WARMUP", "1"), ("BENCH_FORCE_CPU", "1"),
                 ("BENCH_BATCH", "8"), ("BENCH_FP8_CONV_OUT", "1"),
                 ("BENCH_LAYOUT", "NCHW")):
        monkeypatch.setenv(k, v)
    subs = resnet._run_secondary_benches()
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["metric"] for ln in lines] == ["m_lm", "m_nmt"]
    # only the pacing and backend knobs reach the children
    assert lines[0]["env"] == ["BENCH_FORCE_CPU", "BENCH_ITERS",
                               "BENCH_ROUNDS", "BENCH_WARMUP"]
    assert subs == {name: {"metric": "m_" + name, "value": 1.5, "unit": "u",
                           "mfu": 0.25} for name in ("lm", "nmt")}
    monkeypatch.setenv("BENCH_RESNET_ONLY", "1")
    assert resnet._run_secondary_benches() == {}
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("lm,nmt,want", [
    ("crash", "garbage", ("rc=3, no stdout; stderr tail: first | second | "
                          "third", "JSONDecodeError")),
    ("sleep", "ok", ("timeout after 1s", None))])
def test_secondary_benches_record_child_failures_as_errors(tmp_path, monkeypatch,
                                                 capsys, lm, nmt, want):
    _stubs(tmp_path, monkeypatch, lm, nmt, timeout=1)
    monkeypatch.delenv("BENCH_RESNET_ONLY", raising=False)
    subs = resnet._run_secondary_benches()
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert len(lines) == 2
    assert subs["lm"] == {"error": want[0]} == lines[0]
    if want[1]:
        assert subs["nmt"]["error"].startswith(want[1])
    else:
        assert subs["nmt"]["value"] == 1.5 and "error" not in subs["nmt"]


@pytest.fixture
def tiny(monkeypatch):
    """``main()`` on the CPU at depth 18, batch 4 of 32x32 images, 10
    classes; 2-step dispatches, one warm, two timed. (At batch 2 the last
    stage's batch norms see 2 values a channel, and under fp8 conv
    outputs both packages' losses turn NaN by step 3.)"""
    for name, value in (("DEPTH", 18), ("IMAGE", 32), ("CLASSES", 10),
                        ("BATCH", 4), ("ITERS", 2), ("ROUNDS", 2),
                        ("WARMUP", 1)):
        monkeypatch.setattr(resnet, name, value)
    monkeypatch.setenv("BENCH_FORCE_CPU", "1")
    for k in ("BENCH_FP8_ACTS", "BENCH_FP8_CONV_OUT", "BENCH_RESNET_ONLY"):
        monkeypatch.delenv(k, raising=False)
    for k in ("PADDLE_TPU_FP8_ACTS", "PADDLE_TPU_FP8_CONV_OUT"):
        monkeypatch.setenv(k, "")       # restored after the test


def test_main_on_the_forced_cpu(tiny, tmp_path, monkeypatch, capsys):
    """The three lines (stub children): LM, NMT, then the ResNet line
    with ``bench.py``'s keys and both children as ``submetrics``."""
    _stubs(tmp_path, monkeypatch)
    with punique.guard():
        rec = resnet.main()
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["metric"] for ln in lines] == ["m_lm", "m_nmt",
                                              resnet.METRIC]
    line = lines[2]
    assert set(line) == reference_keys()
    assert line["value"] > 0 and line["mfu"] is None
    assert line["precision"] == "bf16+fp8-acts+fp8-convout-e5m2"
    assert (line["batch"], line["iters"], line["rounds"]) == (4, 2, 2)
    assert np.isfinite(line["loss"]) and len(rec["_round_s"]) == 2
    assert set(line["submetrics"]) == {"lm", "nmt"}
    assert line["submetrics"]["lm"]["value"] == 1.5
    assert os.environ["PADDLE_TPU_FP8_CONV_OUT"] == "e5m2"


def test_refuses_the_cpu_unless_asked():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("BENCH_")}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-m",
                          "paddle_tpu_torch.benchmarks.resnet"],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 1
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1               # no child ran before the check
    rec = json.loads(lines[0])
    assert rec["value"] is None and rec["metric"] == resnet.METRIC
    assert "no CUDA device" in rec["error"]
    assert (rec["layout"], rec["batch"]) == ("NHWC", 256)
