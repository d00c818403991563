"""A CPU rehearsal of ``chip_smoke.py``'s phases 18 (disaggregated
serving) and 19 (the serving fleet) at a tiny size, with the
``tiny_serving`` fixture of ``test_torch_chip_smoke.py`` and child
processes started with ``--device cpu``."""

from tests import torch_threads  # noqa: F401  (first)
import chip_smoke as cs
from tests.test_torch_chip_smoke import tiny_serving  # noqa: F401


def test_disagg_phase_rehearses_on_the_cpu(tiny_serving, tmp_path,
                                           monkeypatch, capsys):
    """Phase 18 (a)-(c) at a tiny size: the in-process engine gates (the
    trip runs eagerly on the CPU, so nothing is captured), then the tier,
    prefill and decode children with ``--device cpu``: the handoff over
    HTTP, the torn export of the chaos child and the tier's SIGKILL."""
    for name, value in (("DIS_LAYERS", 2), ("DIS_PREFIX", 16),
                        ("DIS_SUFFIX", (5, 12)), ("DIS_KILL_SUFFIX", (5, 12)),
                        ("DIS_NEW", (3, 6)), ("DIS_REQUESTS", 4),
                        ("DIS_KILL_REQUESTS", 4), ("DIS_SLOTS", 4),
                        ("DIS_BUCKETS", "16,32"), ("DIS_MEGASTEP_K", 4),
                        ("DIS_CHECK_PAGES", 16)):
        monkeypatch.setattr(cs, name, value)
    res = cs.disagg_path(str(tmp_path), "cpu")
    gates = res["engine_gates"]
    n = gates["prompts"]
    assert gates["streams_equal_recompute"] == gates[
        "pages_bitwise_prompts"] == n == 4
    assert gates["imported_pages"] > 0 and gates["cold_prefix_computes"] == 0
    assert gates["pool_addresses_kept"] and not gates["recaptured"]
    assert gates["int8"]["pages_bitwise_prompts"] == n
    assert {k: (t["bitwise"], t["dtype"]) for k, t in
            gates["transit"].items()} == {"bf16": (True, "bfloat16"),
                                          "fp8": (True, "float8_e4m3fn")}
    assert gates["trip_stats_after"]["eager_trips"] > 0
    http = res["http"]
    assert http["streams_equal_self_prefill"] == 4
    assert http["cold_prefix_computes"] == 0
    assert min(http["pages_imported_by_replica"].values()) > 0
    torn = res["degradation"]["torn_handoff"]
    assert torn["imported_pages"] == 0 and torn["stream_equal"]
    assert not torn["torn_manifest"] and not torn["visible"]
    killed = res["degradation"]["tier_killed"]
    assert killed["streams_equal_recompute"] == 4
    assert killed["disk_fallback_lookups"] > 0
    # the in-process launches: the gates' engines and the self-prefill run
    assert res["launches"]["k3"] > gates["launches"]["k3"] > 0
    assert res["launches"]["k3_quant"] == gates["launches"]["k3_quant"] > 0
    out = capsys.readouterr().out
    for text in ("phase 18 (a)", "phase 18 (b)", "phase 18 (c)",
                 "disaggregated serving in"):
        assert text in out


def test_fleet_phase_rehearses_on_the_cpu(tiny_serving, tmp_path,
                                          monkeypatch, capsys):
    """Phase 19 at a tiny size: the fleet CLI (two decode replicas, a
    prefill replica, the tier; ``--device cpu``) with one decode replica
    SIGKILLed under load, then one replica of the API fleet rolled by
    ``hot_swap`` onto an int8-weight serial. On the CPU the replicas take
    K3's plain version, so their drain lines count no launch."""
    for name, value in (("DIS_LAYERS", 2), ("FLEET_PREFIX", 16),
                        ("FLEET_SUFFIX", (4, 8)), ("FLEET_SHORT", (3, 8)),
                        ("FLEET_NEW", (3, 6)), ("FLEET_PROMPTS", 6),
                        ("FLEET_CLIENTS", 3), ("FLEET_WAVE", 9),
                        ("FLEET_MIN_PROMPT", 12), ("FLEET_SLOTS", 4),
                        ("FLEET_BUCKETS", "16,32"), ("FLEET_PAGES", 64),
                        ("FLEET_OVERHEAD_PAIRS", 2), ("ROLL_REPLICAS", 1),
                        ("ROLL_WAVE", 6), ("FLEET_BOOT_S", 120),
                        ("FLEET_DRAIN_S", 30)):
        monkeypatch.setattr(cs, name, value)
    res = cs.fleet_path(str(tmp_path), "cpu")
    cli, roll = res["cli"], res["roll"]
    assert cli["failed"] == 0 and cli["requests"] == 9 + 6
    assert cli["streams_equal_engine"] == cli["requests"]
    assert cli["restarts"] == 1 and cli["fleet_exit"] == 0
    assert cli["handoff"]["ok"] > 0 and cli["handoff"]["skipped"] > 0
    assert all(cli["trace"][k] for k in ("router", "prefill", "decode"))
    assert set(cli["cold_start_s"]) == {"replica0", "replica1", "prefill0"}
    assert cli["kill_to_readmission_s"] > 0
    assert cli["drained"] == {"k3": 0, "drained_decode_replicas": 2}
    assert roll["failed"] == 0 and roll["swapped"] == 1
    assert roll["old_exit_codes"] == [0] and roll["serials"] == [0, 1]
    assert roll["streams_in_either_weight_set"] == roll["requests"] > 0
    assert roll["streams_equal_quantized_after_roll"] == 6
    assert roll["weight_quant_after_roll"] == ["int8"]
    assert roll["drained"] == {"k3_quant": 0, "drained_decode_replicas": 2}
    # the in-process reference engines launched through the shim
    assert res["launches"]["k3"] > 0 and res["launches"]["k3_quant"] > 0
    assert res["replica_launches"] == {"k3": 0, "k3_quant": 0}
    out = capsys.readouterr().out
    for text in ("phase 19 (a)", "phase 19 (b)", "the serving fleet in"):
        assert text in out
