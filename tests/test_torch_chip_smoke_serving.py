"""A CPU rehearsal of ``chip_smoke.py``'s serving phases (4, 12 and 14) at
a tiny size, with the ``serving_patches`` of ``test_torch_chip_smoke.py``
(the constants shrunk, a shim counting K3 / K3-quant launches): the
serving phase with its quantized runs and the equal-bytes admission,
phase 12's megasteps after it, and phase 14's speculative, dense, tenant
and shedding runs. Phase 4 runs once for the module (``phase4_run``): the
serving rehearsal holds it and the megastep rehearsal starts from it, as
phase 12 starts from phase 4 on the card."""

from tests import torch_threads  # noqa: F401  (first)
import contextlib
import io
import json

import pytest
import torch

import chip_smoke as cs
from paddle_tpu_torch.ops import paged_attention as pa
from tests.test_torch_chip_smoke import (  # noqa: F401
    ROW_KEYS, serving_patches, tiny_serving)


@pytest.fixture(scope="module")
def phase4_run(tmp_path_factory):
    """``cs.main_path`` at the tiny size, once: its report and what it
    printed."""
    saved = (pa.launches, pa.launches_quant)
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, \
            contextlib.redirect_stdout(out):
        serving_patches(mp)
        res = cs.main_path(str(tmp_path_factory.mktemp("phase4")))
    pa.launches, pa.launches_quant = saved
    return res, out.getvalue()


def test_serving_phase_with_quantized_runs_rehearses_on_the_cpu(
        tiny_serving, phase4_run):
    res, out = phase4_run
    steps = {k: res[k]["decode_steps"] for k in ("fp32", "bf16")}
    assert set(res["quant"]) == {"int8", "fp8", "weights_int8_kv_int8"}
    total = 0
    for label, st in res["quant"].items():
        assert st["k3_quant_launches"] == st["decode_steps"] * cs.LAYERS > 0
        assert st["k3_launches"] == 0
        assert st["kv_pages_total"] == 2 * cs.SLOTS * cs.MAX_LEN // cs.PAGE
        assert st["kv_pool_effective_capacity"] == \
            st["kv_pages_total"] * cs.PAGE
        assert st["prefill_logit_rel_l2"] <= cs.QUANT_LOGIT_REL_L2
        assert 0 <= st["token_match_vs_bf16"] <= 1
        total += st["k3_quant_launches"]
    assert res["quant"]["fp8"]["kv_quant_dtype"] == "fp8"
    assert res["quant"]["weights_int8_kv_int8"]["weight_quant"] == "int8"
    assert res["quant"]["int8"]["weight_quant"] == "off"
    row = res["k3_quant"]
    assert row["name"] == cs.K3Q["name"]
    assert ROW_KEYS <= set(row) and row["bound_by"] in ("bytes",
                                                        "operations")
    assert res["k3_quant_step"]["bytes"] < res["k3_step"]["bytes"]
    cap = res["capacity"]
    assert cap["runs"]["int8"]["pool_bytes"] <= \
        cap["runs"]["bf16"]["pool_bytes"]
    assert (cap["runs"]["bf16"]["peak_slots"],
            cap["runs"]["int8"]["peak_slots"]) == (16, 31)
    assert cap["admission_ratio"] >= cs.ADMISSION_RATIO
    assert cap["runs"]["bf16"]["k3_launches"] > 0 and \
        cap["runs"]["int8"]["k3_launches"] == 0
    assert res["k3"]["launches"] == (sum(steps.values()) + cap["runs"][
        "bf16"]["decode_steps"]) * cs.LAYERS
    assert row["launches"] == total + cap["runs"]["int8"]["k3_quant_launches"]
    assert res["fp8_step_max_abs_err"] <= 1e-5
    json.dumps([res["k3"], row])
    assert "K3-quant at a decode step" in out and "token match" in out
    assert "admission at equal pool bytes" in out
    assert "fp8 engine's decode step" in out


def test_megastep_phase_rehearses_on_the_cpu(tiny_serving, phase4_run,
                                            monkeypatch, capsys):
    """Phase 12 at a tiny size after phase 4: every megastep trip runs
    eagerly on the CPU, with the card's gates and launch arithmetic
    (layers x (eager steps + trips + warm-up trips))."""
    monkeypatch.setattr(cs, "MEGASTEP_K", 4)
    monkeypatch.setattr(cs, "MS_GATE_KS", (4, 4, 3))
    monkeypatch.setattr(cs, "MS_PROFILE_MEGASTEPS", 1)
    res = cs.megastep_path(phase4_run[0])
    labels = {"fp32", "bf16", "int8", "fp8"}
    assert set(res["runs"]) == set(res["gates"]) == set(res["profiles"]) \
        == labels
    n = cs.N_CLIENTS * cs.PER_CLIENT
    launches = {"k3": 0, "k3_quant": 0}
    for label, st in res["runs"].items():
        trip = st["trip_stats"]
        assert trip["loop_launches"] == trip["warmups"] == 0
        assert 0 < trip["eager_trips"] == trip["iterations"] <= \
            trip["trips_dispatched"]
        assert trip["iterations"] == sum(int(t) * n for t, n in
                                         st["trips_histogram"].items())
        assert st["megasteps"] == sum(st["trips_histogram"].values()) > 0
        assert all(1 <= int(t) <= 4 for t in st["trips_histogram"])
        path, other = ("k3_launches", "k3_quant_launches")[::(
            1 if label in ("fp32", "bf16") else -1)]
        assert st[path] == cs.launch_want(trip, cs.LAYERS) > 0
        assert st[other] == 0
        launches[path[:-len("_launches")]] += st[path]
        assert st["streams_equal_k1"] == n
        assert st["host_gap_ms_per_token"] >= 0 and st["tpot_ms_p50"] > 0
        gate = res["gates"][label]
        for cohort in ("greedy", "sampling"):
            c = gate["cohorts"][cohort]
            assert c["identical"] == c["of"] == cs.SLOTS
            assert c["trips"] == [4, 4, 3] and c["host_state_equal"]
        assert gate["trip_stats"]["eager_trips"] == 22
        prof = res["profiles"][label]
        assert prof["trip_wall_ms"] > 0 and prof["megastep_k"] == 4
        assert prof["k3_launched"] == {path[:-len("_launches")]:
                                       prof["trips"] * cs.LAYERS,
                                       other[:-len("_launches")]: 0}
        assert prof["k3_replayed"][path[:-len("_launches")]] == \
            4 * cs.LAYERS
    assert res["runs"]["fp32"]["streams_equal_recompute"] == n
    # (d): every slot frozen after 2 trips, by caps and by EOS
    assert set(res["exit"]) == {"bf16", "int8"}
    for label, ex in res["exit"].items():
        path, other = ("k3", "k3_quant")[::1 if label == "bf16" else -1]
        for case in ("caps", "eos"):
            assert ex[case]["trips"] == ex[case]["iterations"] == 2
            assert ex[case]["streams_equal_k1"]
        assert ex["full"]["trips"] == ex["full"]["iterations"] == 4
        # on the CPU the ms are host wall times, which a loaded machine
        # may order either way: the early exit's smaller work is held by
        # the counts
        assert ex["exit_over_full"] > 0
        assert ex["caps"]["k3_launched"][path] == 2 * cs.LAYERS
        assert ex["full"]["k3_launched"][path] == 4 * cs.LAYERS
        assert ex["launches"][path] > 0 and ex["launches"][other] == 0
        launches[path] += ex["launches"][path]
        assert ex["bound"]["bytes"] > ex["bound"]["param_bytes"] > 0
    assert res["loop_launches"] == 0 and "loop_row" not in res
    assert res["launches"] == launches
    assert "k1_step_wall_ms" in res["profiles"]["int8"]
    out = capsys.readouterr().out
    for text in ("megastep engine gate", "vs K=1 (phase 4)", "megastep at",
                 "fp8 megastep serving", "phase 12 (d) int8 pages"):
        assert text in out


def test_spec_phase_rehearses_on_the_cpu(tiny_serving, tmp_path,
                                         monkeypatch, capsys):
    """Phase 14 at a tiny size from one K = 1 run (standing in for phases
    4 and 12): the engine gates' launch arithmetic (K3 = layers x the
    synced fallback steps), the served speculative runs (the self draft
    accepting), the dense engine's served run without K3, the tenant
    run's budget preemption with a prefix hit, and shedding to level
    3."""
    from paddle_tpu_torch.serving import (TransformerDecoderModel,
                                          full_recompute_generate,
                                          save_decoder)
    # a 1 s budget window: the tenant's first iteration (4 prefills and a
    # 4-trip megastep, > 16 tokens) ends before it rolls, even on a
    # loaded CPU
    for name, value in (("SPEC_NEW_TOKENS", 12), ("SERVED_SPEC_K", 3),
                        ("MEGASTEP_K", 4), ("TENANT_WINDOW_S", 1.0),
                        ("SHED_DWELL_S", 0.01), ("SHED_SPACING_S", 0.02),
                        ("NEW_TOKENS", (6, 12))):
        monkeypatch.setattr(cs, name, value)
    dirs = {}
    for label, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        m = TransformerDecoderModel(cs.VOCAB, dim=cs.DIM, n_heads=cs.HEADS,
                                    n_layers=cs.LAYERS, dtype=dtype)
        dirs[label] = str(tmp_path / label)
        save_decoder(dirs[label], m, m.init_params(0, device="cpu"))
    prompts, budgets = cs._requests()
    run = cs.serve_run(dirs["fp32"], prompts, budgets)
    k1 = cs._serving_stats(run)
    ref = full_recompute_generate(run["model"], run["engine"].params,
                                  prompts, budgets, max_len=cs.MAX_LEN)
    res = cs.spec_path({"fp32": k1, "_recompute": ref, "_dirs": dirs},
                       {"runs": {"fp32": k1}}, str(tmp_path))
    assert set(res["engine_gates"]) == {"fp32", "bf16", "int8"}
    for label, gate in res["engine_gates"].items():
        want = {"self_k1", "self_k4", "2-layer_k1", "2-layer_k4"} \
            if label != "int8" else {"self_k4", "2-layer_k4"}
        assert set(gate) == want
        for rec in gate.values():
            assert rec["launches"] == rec["fallback_steps"] * cs.LAYERS
            assert 0 <= rec["accepted"] <= rec["drafted"]
    for rec in res["engine_gates"]["fp32"].values():   # the gated dtype
        assert rec["streams_equal_plain"] == cs.SLOTS
    fp32 = res["engine_gates"]["fp32"]["self_k4"]
    # 12 tokens at k 4: each of the SLOTS streams ends on a round of 3
    assert fp32["truncation_loss"] == cs.SLOTS * (4 - 11 % 4)
    assert fp32["accepted"] == fp32["drafted"] - fp32["truncation_loss"] > 0
    n = cs.N_CLIENTS * cs.PER_CLIENT
    for key in ("served", "served_self"):
        served = res[key]
        assert served["streams_equal_recompute"] == n
        assert served["counters"]["drafted"] > 0
        assert served["k3_launches"] == \
            served["trip_stats"]["decode_steps"] * cs.LAYERS
    assert res["served_self"]["counters"]["accepted"] > 0
    dense = res["served_dense"]
    assert dense["streams_equal_recompute"] == n
    assert dense["k3_launches"] == dense["k3_quant_launches"] == 0
    tenants = res["tenants"]
    assert tenants["streams_equal_recompute"] == n
    assert tenants["counters"]["preempted"]["budget"] >= 1
    assert tenants["capped_prefix_hit_pages_max"] >= 1
    shed = res["shedding"]
    assert shed["low_shed"] >= 1 and shed["high_served"] == n // 2
    assert shed["counters"]["shed_low"] == shed["low_shed"]
    assert res["launches"]["k3"] > 0 and res["launches"]["k3_quant"] > 0
    out = capsys.readouterr().out
    for text in ("speculative engine gate", "speculative serving",
                 "dense DecodeEngine serving", "tenant serving", "shedding",
                 "vs K=1 (phase 4)"):
        assert text in out
