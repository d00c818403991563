"""A CPU rehearsal of ``chip_smoke.py``'s training phases (5-10 and 13) at
a tiny size, with the ``tiny`` fixture of ``test_torch_chip_smoke.py``
(its kernel shims and stubbed CUDA events): the flash, segment, K6 /
K1-dense and fused-Adam kernel checks, the fp32 card-vs-CPU gate, the
training run, the packed run with its padded baseline, the FusedAdam run,
the per-head (bhsd) and dense-mask runs with their gates, phase 13's
``run_steps`` gates and bench rounds, and the kernel timing report."""

from tests import torch_threads  # noqa: F401  (first)
import json

import numpy as np

import chip_smoke as cs
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import fused_adam as pfa
from tests.test_torch_chip_smoke import ROW_KEYS, tiny  # noqa: F401


def test_training_phases_rehearse_on_the_cpu(tiny, capsys):
    before = dict(fa.launches)
    rows = cs.flash_checks()
    assert len(rows) == 2 * 8 + 1 and all(r["ok"] for r in rows)
    assert fa.launches == before     # comparison launches are restored
    gate = cs.train_gate()
    assert gate["loss_rel_err"] <= cs.GATE_LOSS_RTOL
    res = cs.train_path()
    steps_x_layers = cs.LM_STEPS * cs.LM_LAYERS
    assert res["launches"] == dict({n: 0 for n in cs.FLASH_KERNELS},
                                   **{n: steps_x_layers for n in cs.K1K2})
    assert res["losses"][-1] < res["losses"][0]
    assert {"mul", "mul_grad", "fused_attention",
            "fused_attention_grad", "adam"} <= set(res["ops"])
    assert res["ops"]["fused_attention"]["calls"] == cs.LM_LAYERS
    timing = cs.flash_timing(res["launches"])
    assert [r["name"] for r in timing] == list(cs.K1K2)
    for row in timing:
        assert ROW_KEYS <= set(row) and row["launches"] == steps_x_layers
        assert row["bound_by"] in ("bytes", "operations")
    json.dumps(timing)
    assert "flash_fwd" in capsys.readouterr().out


def test_packed_and_fused_adam_phases_rehearse_on_the_cpu(tiny, capsys):
    before, before_adam = dict(fa.launches), dict(pfa.launches)
    data = cs.packed_data(cs.LM_BATCH, cs.LM_SEQ)
    seg = data["packed"]["seg"]
    assert (np.diff(seg, axis=1) >= 0).all() and (seg.max(1) >= 1).all()
    assert 0 < data["real_packed"] <= cs.LM_BATCH * cs.LM_SEQ
    assert data["baseline"]["ids"].shape[0] == data["docs"] > cs.LM_BATCH
    rows = cs.segment_checks(seg)
    assert len(rows) == 2 * 2 * 2 * len(cs.SEG_MAPS) + 1
    assert all(r["ok"] for r in rows)
    assert all("k1k2_max_abs_err" in r for r in rows if r["map"] == "one")
    adam_rows = cs.fused_adam_checks()
    assert len(adam_rows) == 5 and all(r["max_ulps"] == 0 for r in adam_rows)
    assert fa.launches == before and pfa.launches == before_adam

    res, scope = cs.packed_path(data)
    steps_x_layers = cs.LM_STEPS * cs.LM_LAYERS
    assert res["launches"] == dict({n: 0 for n in cs.FLASH_KERNELS},
                                   **{n: steps_x_layers for n in cs.K5})
    assert res["baseline"]["launches"] == dict(
        {n: 0 for n in cs.FLASH_KERNELS},
        **{n: cs.BASE_STEPS * cs.LM_LAYERS for n in cs.K1K2})
    assert res["losses"][-1] < res["losses"][0]
    assert 0 < res["pack_occupancy"] <= 1 and 0 < res["pad_waste_baseline"]
    assert res["speedup_vs_padded_ragged"] > 0
    assert [len(v) for v in res["alternating_step_ms"].values()] == \
        [cs.ALTERNATE_ROUNDS] * 2
    assert res["ops"]["fused_attention"]["calls"] == cs.LM_LAYERS
    timing = cs.flash_timing(res["launches"], seg)
    assert [r["name"] for r in timing] == list(cs.K5)

    fused = cs.fused_adam_path(data, scope, res)
    assert fused["one_step_vs_adam"]["max_ulps"] <= cs.ADAM_MAX_ULPS
    assert fused["launches"] == cs.LM_STEPS
    assert [len(v) for v in fused["alternating_step_ms"].values()] == \
        [cs.ALTERNATE_ROUNDS] * 2
    assert fused["adam_ops_calls"] == len(fused["param_shapes"])
    row = cs.fused_adam_timing(fused["param_shapes"], fused["launches"])
    assert row["launches"] == cs.LM_STEPS and row["max_ulps"] == 0
    for r in timing + [row]:
        assert ROW_KEYS <= set(r) and r["bound_by"] in ("bytes",
                                                         "operations")
    json.dumps(timing + [row])
    out = capsys.readouterr().out
    assert "flash_segment_fwd" in out and "fused_adam" in out
    assert "packed path, profiled flash kernels" in out    # PACKED_BODIES


def test_layout_and_dense_mask_phases_rehearse_on_the_cpu(tiny, capsys):
    before = dict(fa.launches)
    rows = cs.layout_checks()
    masks = len(cs.BHSD_MASKS) + len(cs.K1_DENSE_MASKS)
    assert len(rows) == len(cs.BHSD_GEOMS) * 2 * 2 * masks
    assert all(r["ok"] for r in rows)
    assert {r["kernel"] for r in rows} == {"flash_bhsd_fwd",
                                           "flash_bhsd_fwd_dense",
                                           "flash_fwd_dense"}
    assert all("dq" in r["max_abs_err"] for r in rows
               if r["kernel"] == "flash_bhsd_fwd")
    assert fa.launches == before     # comparison launches are restored

    zero = {n: 0 for n in cs.FLASH_KERNELS}
    res = cs.bhsd_path()
    assert res["launches"] == dict(zero, **{
        n: cs.LM_STEPS * cs.LM_LAYERS for n in cs.K6})
    gate = res["layout_gate"]
    assert gate["loss_rel_err"] <= cs.GATE_LOSS_RTOL
    assert gate["update_rel_l2"] <= cs.GATE_UPDATE_REL_L2
    assert res["losses"][-1] < res["losses"][0]
    assert res["ops"]["fused_attention"]["calls"] == cs.LM_LAYERS
    # 3 into the op and 1 out of it per layer, forward and backward
    assert res["ops"]["transpose"]["calls"] == 4 * cs.LM_LAYERS
    assert res["ops"]["transpose_grad"]["calls"] == 4 * cs.LM_LAYERS
    assert [len(v) for v in res["alternating_step_ms"].values()] == \
        [cs.ALTERNATE_ROUNDS] * 2 and res["step_ratio_vs_bshd"] > 0

    dense = cs.dense_path()
    for layout, kernel in (("bhsd", "flash_bhsd_fwd_dense"),
                           ("bshd", "flash_fwd_dense")):
        run = dense[layout]
        assert run["launches"] == dict(zero, **{
            kernel: cs.DENSE_STEPS * cs.LM_LAYERS})
        assert run["losses"][-1] < run["losses"][0]
        assert dense["gate"][layout]["loss_rel_err"] <= cs.GATE_LOSS_RTOL
    assert dense["gate"]["first_loss_bhsd_vs_bshd_rel_err"] <= \
        cs.GATE_LOSS_RTOL
    assert 0.5 < dense["visible_share"] < 1

    before = dict(fa.launches)
    timing = cs.layout_timing(res["launches"], dense)
    assert fa.launches == before     # comparison launches are restored
    assert [r["name"] for r in timing] == list(cs.K6) + list(cs.DENSE)
    assert [r["launches"] for r in timing] == \
        [cs.LM_STEPS * cs.LM_LAYERS] * 3 + [cs.DENSE_STEPS * cs.LM_LAYERS] * 2
    for r in timing:
        assert ROW_KEYS <= set(r) and r["bound_by"] in ("bytes",
                                                         "operations")
    json.dumps(timing)
    out = capsys.readouterr().out
    assert "layout-parity gate" in out and "dense-mask bhsd gate" in out


def test_phase13_gates_and_bench_rounds_rehearse_on_the_cpu(tiny, capsys):
    """The run_steps ≡ run() gates (dense and packed, with the launch
    arithmetic counted through the steps), the dropout gate and the
    bench's rounds through ``benchmarks.lm`` at the tiny size."""
    total = cs.REPLAY_RUN_CALLS + 2 * cs.REPLAY_N_STEPS
    for mask, kernels in ((None, cs.K1K2), ("packed", cs.K5)):
        gate = cs.lm_replay_gate(mask)
        assert all(gate["losses_bitwise"])
        assert gate["persistables_differing"] == []
        assert gate["graph_launches"] == {"captures": 0, "replays": 0}
        assert gate["launches"] == {n: total * cs.GATE_LAYERS
                                    for n in kernels}
    drop = cs.dropout_gate()
    assert drop["loss_bitwise"] and drop["masks_differ"]
    assert all(abs(k - 0.5) <= 4 * drop["sigma"] for k in drop["kept_share"])
    bench = cs.bench_lm_rounds({"dense": 10.0, "packed": 12.0})
    steps = (1 + cs.BENCH_ROUNDS) * cs.BENCH_ITERS
    dense, packed = bench["dense"], bench["packed"]
    assert {"metric", "value", "unit", "config", "mfu", "loss", "steps",
            "compile_cache_misses", "device_wait_s"} <= set(dense)
    assert dense["steps"] == 1 + steps
    assert dense["compile_cache_misses_by_cause"] == {"first_compile": 2.0}
    assert packed["compile_cache_misses_by_cause"] == {"first_compile": 4.0}
    assert dense["launches"] == dict(
        {n: 0 for n in dense["launches"]},
        **{n: steps * cs.LM_LAYERS for n in cs.K1K2})
    assert packed["launches"] == dict(
        {n: 0 for n in packed["launches"]},
        **{n: steps * cs.LM_LAYERS for n in cs.K1K2 + cs.K5})
    for rec in (dense, packed):
        assert len(rec["round_losses"]) == 1 + cs.BENCH_ROUNDS
        assert rec["replay_device_busy_ms"] >= 0
        assert rec["replay_wall_ms"] > 0
    assert dense["eager_step_ms_p50"] == 10.0
    assert set(packed["step_ms_captured"]) == {"baseline", "packed"}
    out = capsys.readouterr().out
    assert '"metric": "transformer_lm_train_tokens_per_sec_per_chip"' in out
    assert "bench_lm packed through the captured step" in out
