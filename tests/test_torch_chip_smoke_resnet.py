"""A CPU rehearsal of ``chip_smoke.py``'s ResNet phases (11 and 16) at a
tiny size, with the ``tiny_resnet`` and ``tiny_fp8`` fixtures of
``test_torch_chip_smoke.py``: ResNet's op checks, the card-vs-CPU and
``run_steps`` gates and bench.py's ResNet line through ``run_steps``, then
the fp8 gates, the fp8 replay gates, the fp8 ResNet line and the
three-line bench."""

from tests import torch_threads  # noqa: F401  (first)
import json
import os
import subprocess

import pytest

import chip_smoke as cs
from tests.test_torch_chip_smoke import tiny_fp8, tiny_resnet  # noqa: F401


def test_resnet_phase_rehearses_on_the_cpu(tiny_resnet, capsys):
    from paddle_tpu_torch import executor as pexe
    rows = cs.resnet_op_checks()
    assert len(rows) == 15 and all(r["ok"] for r in rows)
    gate = cs.resnet_gate()
    assert len(gate["steps"]) == cs.RGATE_STEPS
    assert gate["loss_rel_err"] == 0 and gate["update_rel_l2"] == 0
    assert all(r["updates"] > 0 for r in gate["steps"])
    replay = cs.resnet_replay_gate()
    assert replay["persistables_differing"] == []
    assert replay["persistables_differing_after_reload"] == []
    assert replay["losses_bitwise"] == [True, True, True]
    assert replay["graph_launches"] == {"captures": 0, "replays": 0}
    # the second feed is another batch: the reload compared real work
    assert replay["losses"][-1] != replay["losses"][-2]

    kernels_before = cs._kernel_counts()
    res = cs.resnet_path("card, 700 W")
    assert cs._kernel_counts() == kernels_before
    assert res["launches"] == {n: 0 for n in kernels_before}
    assert len(res["launches"]) == 15   # 14 entry points and the loop
    assert res["graph_launches"] == pexe.graph_launches
    assert res["final_loss"] < res["first_loss"]
    assert len(res["round_s"]) == cs.RESNET_ROUNDS
    assert res["images_per_s"] > 0 and res["mfu"] is None
    assert res["step_ms_captured"] > 0 and res["step_ms_eager_p50"] > 0
    assert res["flops_per_step"] > 0 and res["peak_memory_gb"] is None
    assert "cut" in res and res["card"] == "card, 700 W"
    for prof in (res["eager_profile"], res["replay_profile"]):
        assert {"device_busy_ms", "class_ms", "top_kernels_ms"} <= set(prof)
    assert res["eager_profile"]["ops"]["conv2d_grad"]["calls"] == 20
    assert res["eager_profile"]["ops"]["batch_norm_grad"]["calls"] == 20
    json.dumps(res, default=str)
    out = capsys.readouterr().out
    assert "resnet op checks" in out and "resnet gate" in out
    assert "run_steps vs run" in out and "resnet-18 NHWC b2" in out


def test_fp8_phase_rehearses_on_the_cpu(tiny_fp8, monkeypatch, capsys):
    from paddle_tpu_torch import executor as pexe
    from paddle_tpu_torch.benchmarks import resnet
    cs._zero_counts()
    gates = cs.fp8_gates()
    assert len(gates["cast"]) == 4
    assert all(r["differ"] == 0 for r in gates["cast"])
    assert gates["cast"][0]["plain_to_on_card"]["872.0"] == 448.0
    assert len(gates["conv2d"]) == 3 * 5
    assert all(r["ok"] and r["same_payload"] == 1.0
               for r in gates["conv2d"])
    assert [r["dtype"] for r in gates["conv2d"][:5]] == \
        ["float8_e4m3fn", "float8_e5m2"] + ["float8_e4m3fn"] * 3
    assert all("next_scale" in r for r in gates["conv2d"][3:5])
    assert len(gates["batch_norm"]) == 3 and \
        all(r["ok"] for r in gates["batch_norm"])
    grads = {r["conv_out"]: r for r in gates["no_fp8_grads"]}
    assert set(grads) == {"0", "1", "e5m2", "scaled", "delayed"}
    assert all(r["ok"] and not r["fp8_grads"] for r in grads.values())
    assert grads["e5m2"]["stored"] == {
        "relu": "Tensor torch.float8_e4m3fn",
        "conv2d": "Tensor torch.float8_e5m2"}
    assert grads["delayed"]["stored"]["conv2d"].startswith("ScaledFp8")
    for mode in ("e5m2", "delayed"):
        rep = cs.fp8_replay_gate(mode)
        assert rep["losses_bitwise"] == [True, True]
        assert rep["persistables_differing"] == []
        assert rep["graph_launches"] == {"captures": 0, "replays": 0}
        assert rep["fp8_scale_vars"] == (20 if mode == "delayed" else 0)
        assert rep["fp8_scale_vars_moved"] == rep["fp8_scale_vars"]
    phase11 = {"images_per_s": 1.0, "step_ms_captured": 2.0,
               "replay_device_busy_ms": 1.5, "mfu": None,
               "peak_memory_gb": None,
               "replay_profile": {"class_ms": {"conv": 1.0}}}
    res = cs.fp8_resnet_path("card, 700 W", phase11)
    assert res["bench"]["precision"] == "bf16+fp8-acts+fp8-convout-e5m2"
    assert res["bench"]["batch"] == 4 and res["bench"]["iters"] == 2
    assert res["final_loss"] < res["first_loss"]
    assert res["launches"] == {n: 0 for n in cs._kernel_counts()}
    assert res["graph_launches"] == pexe.graph_launches
    assert res["phase11_bf16"]["replay_class_ms"] == {"conv": 1.0}
    assert {"device_busy_ms", "class_ms", "wall_ms"} <= \
        set(res["replay_profile"])
    assert len(res["round_s"]) == cs.RESNET_ROUNDS
    # main() left neither the fp8 environment nor its knobs behind
    assert os.environ["PADDLE_TPU_FP8_ACTS"] == ""
    assert (resnet.BATCH, resnet.ITERS, resnet.DEPTH) == (256, 100, 50)
    json.dumps(res, default=str)

    lines = [{"metric": "lm", "value": 1.0},
             {"metric": "nmt", "value": 2.0},
             {"metric": resnet.METRIC, "value": 3.0,
              "submetrics": {"lm": {"metric": "lm", "value": 1.0},
                             "nmt": {"metric": "nmt", "value": 2.0}}}]
    seen = {}

    def fake_run(cmd, cwd, env, **kw):
        seen.update(cmd=cmd, env=env)
        out = "a log line\n" + "\n".join(json.dumps(ln) for ln in lines)
        return subprocess.CompletedProcess(cmd, 0, out, "")

    monkeypatch.setattr(cs.subprocess, "run", fake_run)
    drv = cs.three_line_bench()
    assert drv["lines"] == 3 and drv["submetrics"]["nmt"]["value"] == 2.0
    assert seen["cmd"][1:] == ["-m", "paddle_tpu_torch.benchmarks.resnet"]
    assert {k: v for k, v in seen["env"].items()
            if k.startswith("BENCH_")} == dict(cs.THREE_LINE_KNOBS,
                                              BENCH_FORCE_CPU="1")
    lines[2]["submetrics"]["lm"] = {"error": "timeout after 900s"}
    with pytest.raises(AssertionError, match="bad submetrics"):
        cs.three_line_bench()
    out = capsys.readouterr().out
    assert "fp8 gates" in out and "under fp8 (delayed" in out
    assert "bench.py's ResNet line (fp8 recipe)" in out
    assert "three-line bench" in out
