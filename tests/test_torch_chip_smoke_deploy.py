"""A CPU rehearsal of ``chip_smoke.py``'s phases 15 (NMT) and 17
(inference deployment) at a tiny size, with the ``tiny_nmt`` and
``tiny_infer`` fixtures of ``test_torch_chip_smoke.py``: the lstm op
checks, the NMT gates and bench_nmt.py's line; the classifier's export,
serving and HTTP gates and the LM artifact."""

from tests import torch_threads  # noqa: F401  (first)
import json

import chip_smoke as cs
import paddle_tpu_torch as fluid
from tests.test_torch_chip_smoke import (  # noqa: F401
    tiny, tiny_infer, tiny_nmt)


def test_nmt_phase_rehearses_on_the_cpu(tiny_nmt, capsys):
    from paddle_tpu_torch import executor as pexe
    cs._zero_counts()
    rows = cs.lstm_op_checks()
    assert len(rows) == len(cs.LSTM_CASES) and all(r["ok"] for r in rows)
    assert set(rows[2]["rel_l2"]) == {"Hidden", "Cell", "Input@GRAD",
                                      "Weight@GRAD", "Bias@GRAD",
                                      "H0@GRAD", "C0@GRAD"}
    gate = cs.nmt_gate()
    assert len(gate["steps"]) == cs.NGATE_STEPS
    assert gate["loss_rel_err"] == 0 and gate["update_rel_l2"] == 0
    assert all(r["updates"] > 0 for r in gate["steps"])
    for amp in (False, True):
        replay = cs.nmt_replay_gate(amp)
        assert replay["persistables_differing"] == []
        assert replay["losses_bitwise"] == [True] * 3
        assert replay["graph_launches"] == {"captures": 0, "replays": 0}
        shapes = replay["padded_shapes"]
        assert shapes[0] != shapes[1]
    res = cs.nmt_path("card, 700 W")
    bench = res["bench"]
    assert bench["metric"] == \
        "seq2seq_nmt_train_target_tokens_per_sec_per_chip"
    assert bench["value"] > 0 and bench["pooled_compile_cache_misses"] == 0
    assert res["launches"] == {n: 0 for n in cs._kernel_counts()}
    assert res["graph_launches"] == pexe.graph_launches
    assert len(res["schedules"]) == 2
    assert res["schedules"][0]["dispatches_a_sweep"] == 1
    assert res["schedules"][1]["dispatches_a_sweep"] == \
        bench["distinct_padded_shapes"]
    for losses in res["sweep_losses"].values():
        assert len(losses) == 3 and losses[-1] < losses[0]
    assert res["step_ms_eager_p50"] > 0 and res["peak_memory_gb"] is None
    assert {"device_busy_ms", "class_ms", "wall_ms"} <= \
        set(res["replay_profile"])
    json.dumps(res, default=str)
    out = capsys.readouterr().out
    assert "lstm op checks" in out and "nmt gate" in out
    assert "across padded shapes" in out
    assert "bench_nmt through the captured steps" in out
    # bench_nmt.py's JSON line, printed by the bench itself
    line = next(json.loads(ln) for ln in out.splitlines()
                if ln.startswith('{"metric": "seq2seq_nmt'))
    assert line["batch"] == 4 and line["iters"] == 4


def test_inference_phase_rehearses_on_the_cpu(tiny_infer, tmp_path, capsys):
    """The classifier through (a)-(c), the LM through (d); ResNet's
    build alone (its startup takes most of a minute on the CPU)."""
    prog, _, pred, feeds, max_len = cs.build_infer(fluid, "resnet")
    assert feeds == ["images"] and max_len is None
    assert pred.shape == [-1, 10]
    assert cs.infer_feed("resnet", cs.infer_samples("resnet", 3, 0))[
        "images"].shape == (3, 3, 64, 64)
    cs._zero_counts()
    res, art, d = cs.export_gate("lstm", str(tmp_path))
    assert d == str(tmp_path / "artifact_lstm")
    assert res["inference_model_bitwise"] and set(res["rel_l2"]) == {1, 3}
    assert res["rel_l2_vs_cpu"] <= cs.INFER_CPU_REL_L2
    assert cs.gate_lengths(3)[:2] == [1, 12] and cs.gate_lengths(1) == [1]
    res, alone = cs.serve_gate("lstm", art)
    assert res["requests"] == 32 and res["distinct_samples"] == 8
    assert res["mean_occupancy"] > 1.0 and res["drained"]
    assert res["worst_rel_l2_vs_alone"] <= cs.SERVE_REL_L2
    assert {"wall_ms", "device_busy_ms", "idle_share"} <= set(res["window"])
    assert all(s[0] == 12 and s[1] in (1, 2, 4, 8, 16)
               for s in res["compiled_shapes"])
    res = cs.http_gate(cs.start_serve_cli(d), *alone)
    assert res["requests"] == 6 and res["echo_mismatches"] == 0
    assert res["bad_feed"][0] == 400 and res["exit_code"] == 0
    assert 503 in res["healthz_after_sigterm"]
    assert res["drain_statuses"] == ["200"]
    cs._counts_gate("phase 17 (a)-(c)", cs._kernel_counts(), {})
    res = cs.lm_export_gate(str(tmp_path))
    assert res["flash_fwd_ops_in_graph"] == cs.INFER_LM_LAYERS
    # on the CPU the custom op takes the plain version
    assert res["launches"] == {} and res["plain_calls"] == cs.INFER_LM_LAYERS
    out = capsys.readouterr().out
    assert "phase 17 (a) lstm" in out and "phase 17 (d)" in out
