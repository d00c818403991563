"""A CPU rehearsal of ``chip_smoke.py``'s phases at a tiny size: the
K3-quant and quantized-append checks, the serving phase with its three
quantized runs, the flash, segment, K6 / K1-dense and fused-Adam kernel
checks, the fp32 card-vs-CPU gate, the training run, the packed run with
its padded baseline, the FusedAdam run, the per-head (bhsd) and
dense-mask runs with their gates, and the kernel timing report, with
every tensor on the CPU.

CPU tensors take the kernels' plain versions and count no launch, and
the backward kernels exist only on CUDA, so the rehearsal swaps in shims
that compute through the plain versions and count one launch each. CUDA
events are stubbed (a fixed 0.5 ms). What it shows: the phases' control
flow, shapes, launch accounting and report keys hold together; it
cannot show that a kernel compiles or how fast anything runs.
"""

import json
import os
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke as cs
import paddle_tpu_torch as fluid
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.ops import fused_adam as pfa
from paddle_tpu_torch.ops import paged_attention as pa

ROW_KEYS = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}


@pytest.fixture
def tiny(monkeypatch):
    for name, value in (("DEVICE", "cpu"), ("LM_VOCAB", 97), ("LM_DIM", 32),
                        ("LM_HEADS", 2), ("LM_LAYERS", 2), ("LM_BATCH", 2),
                        ("LM_SEQ", 64), ("LM_STEPS", 3), ("LM_LR", 1e-2),
                        ("LM_PROFILE_STEPS", 1), ("GATE_BATCH", 2),
                        ("GATE_SEQ", 32),
                        ("FLASH_GEOMS", [(3, 64, 4, 4, 16),
                                         (3, 50, 4, 2, 16)]),
                        ("BASE_STEPS", 2), ("K4_SIZES", (1, 1023, 5000)),
                        ("K4_ODD_SIZES", (5, 101, 3333)),
                        ("ALTERNATE_ROUNDS", 2),
                        ("BHSD_GEOMS", [(3, 64, 4, 4, 16),
                                        (3, 50, 4, 2, 16)]),
                        ("DENSE_STEPS", 3), ("CAPTURED_STEPS", 2),
                        ("CAPTURED_ROUNDS", 1), ("BENCH_ITERS", 2),
                        ("BENCH_ROUNDS", 1), ("BENCH_PROFILE_STEPS", 1),
                        ("DROPOUT_ROWS", 16), ("DROPOUT_WIDTH", 256)):
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(cs, "_timed", lambda fn, args, reps, flush:
                        (fn(*args), 0.5)[1])
    monkeypatch.setattr(fluid, "CUDAPlace", lambda i=0: fluid.CPUPlace())
    real_fwd = fa.flash_fwd

    def fwd(q, k, v, scale=None, causal=False, k_valid=None, mask=None,
            layout="bshd"):
        fa.launches[fa.kernel_name("fwd", layout, mask is not None)] += 1
        return real_fwd(q, k, v, scale, causal, k_valid, mask, layout)

    def grads(q, k, v, do, lse, scale, causal, k_valid, layout):
        o = fa.flash_fwd_plain(q, k, v, scale, causal, k_valid,
                               layout=layout)[0]
        return fa.flash_bwd_plain(q, k, v, o, lse, do, scale, causal,
                                  k_valid, layout)

    def dq(q, k, v, do, lse, delta, scale=None, causal=False, k_valid=None,
           layout="bshd"):
        fa.launches[fa.kernel_name("bwd_dq", layout)] += 1
        return grads(q, k, v, do, lse, scale, causal, k_valid, layout)[0]

    def dkv(q, k, v, do, lse, delta, scale=None, causal=False, k_valid=None,
            layout="bshd"):
        fa.launches[fa.kernel_name("bwd_dkv", layout)] += 1
        return grads(q, k, v, do, lse, scale, causal, k_valid, layout)[1:]

    def bwd(q, k, v, o, lse, do, scale=None, causal=False, k_valid=None,
            layout="bshd"):
        delta = (do.float() * o.float()).sum(-1)
        return (fa.flash_bwd_dq(q, k, v, do, lse, delta, scale, causal,
                                k_valid, layout),) + \
            fa.flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal, k_valid,
                             layout)

    real_seg_fwd = fa.flash_fwd_segment

    def seg_fwd(*a, **k):
        fa.launches["flash_segment_fwd"] += 1
        return real_seg_fwd(*a, **k)

    def seg_grads(q, k, v, do, lse, seg, scale, causal):
        o = fa.flash_fwd_segment_plain(q, k, v, seg, scale, causal)[0]
        return fa.flash_bwd_segment_plain(q, k, v, o, lse, do, seg, scale,
                                          causal)

    def seg_dq(q, k, v, do, lse, delta, seg, scale=None, causal=False):
        fa.launches["flash_segment_bwd_dq"] += 1
        return seg_grads(q, k, v, do, lse, seg, scale, causal)[0]

    def seg_dkv(q, k, v, do, lse, delta, seg, scale=None, causal=False):
        fa.launches["flash_segment_bwd_dkv"] += 1
        return seg_grads(q, k, v, do, lse, seg, scale, causal)[1:]

    def seg_bwd(q, k, v, o, lse, do, seg, scale=None, causal=False):
        delta = (do.float() * o.float()).sum(-1)
        return (fa.flash_bwd_segment_dq(q, k, v, do, lse, delta, seg, scale,
                                        causal),) + \
            fa.flash_bwd_segment_dkv(q, k, v, do, lse, delta, seg, scale,
                                     causal)

    real_adam = pfa.fused_adam_update

    def adam(*a, **k):
        pfa.launches["fused_adam"] += 1
        return real_adam(*a, **k)

    for name, fn in (("flash_fwd", fwd), ("flash_bwd_dq", dq),
                     ("flash_bwd_dkv", dkv), ("flash_bwd", bwd),
                     ("flash_fwd_segment", seg_fwd),
                     ("flash_bwd_segment_dq", seg_dq),
                     ("flash_bwd_segment_dkv", seg_dkv),
                     ("flash_bwd_segment", seg_bwd)):
        monkeypatch.setattr(fa, name, fn)
    monkeypatch.setattr(pfa, "fused_adam_update", adam)
    saved, saved_adam = dict(fa.launches), dict(pfa.launches)
    yield
    fa.launches.update(saved)
    pfa.launches.update(saved_adam)


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


def test_prefix_mask_and_kernel_classes():
    m = cs.prefix_mask(3, 64)
    assert m.shape == (3, 1, 64, 64) and m.dtype == bool
    lo, hi = 64 // 8, 64 * 7 // 8
    for row in m[:, 0]:
        p = int(row[0].sum())          # the first query sees the prefix
        assert lo <= p <= hi
        assert row[:, :p].all()        # the prefix is visible to all
        assert (row[:, p:] == np.tril(np.ones((64, 64), bool))[:, p:]).all()
    names = [
        ("k1", "void (anonymous namespace)::flash_fwd_kernel<__nv_bfloat16, "
               "64, 64, 2, false>((anonymous namespace)::Args)"),
        ("k2", "flash_bwd_dkv_kernel<float, 64, 64, 0, false>(Args)"),
        # the tensor-core bodies of bf16 K2 (csrc/flash_mma.cuh)
        ("k2", "void (anonymous namespace)::flash_bwd_dq_mma_kernel<"
               "__nv_bfloat16, 64, 64, 0, false>((anonymous namespace)::"
               "Args)"),
        ("k2", "flash_bwd_dkv_mma_kernel<__nv_bfloat16, 128, 64, 0, false>"
               "(Args)"),
        ("k5", "flash_bwd_dq_kernel<__nv_bfloat16, 64, 64, 1, false>(Args)"),
        ("k6", "flash_fwd_kernel<__nv_bfloat16, 128, 64, 0, true>(Args)"),
        # K1's tensor-core forward and K6's tensor-core backward
        ("k1", "void (anonymous namespace)::flash_fwd_mma_kernel<"
               "__nv_bfloat16, 64, 64, 0, false>((anonymous namespace)::"
               "Args)"),
        ("k6", "flash_bwd_dq_mma_kernel<__nv_bfloat16, 64, 64, 0, true>"
               "(Args)"),
        ("k6", "void (anonymous namespace)::flash_bwd_dkv_mma_kernel<"
               "__nv_bfloat16, 128, 64, 0, true>((anonymous namespace)::"
               "Args)"),
        # K6's tensor-core forward and K1-dense's
        ("k6", "void (anonymous namespace)::flash_fwd_mma_kernel<"
               "__nv_bfloat16, 64, 64, 0, true>((anonymous namespace)::"
               "Args)"),
        ("k1", "void (anonymous namespace)::flash_fwd_mma_kernel<"
               "__nv_bfloat16, 64, 64, 2, false>((anonymous namespace)::"
               "Args)")]
    for want, key in names:
        assert cs.flash_class(key) == want
    assert cs.flash_class("ampere_bf16_s16816gemm_bf16") is None


def test_body_gate_reads_the_profiled_flash_bodies(monkeypatch):
    """Phases 6, 7, 9 and 10 hold the profiled flash kernels to exactly
    the bodies they must run: K1 and K2 on the tensor cores in bshd; K5's
    tensor-core forward and backward under segment ids; K6's tensor-core
    forward and backward in bhsd; the tensor-core forwards of K1-dense in
    the bshd prefix-mask program and of K6-fwd-dense in the bhsd one."""
    ns = "void (anonymous namespace)::"
    args = "((anonymous namespace)::Args)"
    train = {ns + "flash_fwd_mma_kernel<__nv_bfloat16, 64, 64, 0, false>" +
             args: 1.1,
             ns + "flash_bwd_dq_mma_kernel<__nv_bfloat16, 64, 64, 0, false>" +
             args: 2.0,
             ns + "flash_bwd_dkv_mma_kernel<__nv_bfloat16, 64, 64, 0, "
             "false>" + args: 2.5,
             "ampere_bf16_s16816gemm_bf16_128x64": 9.0}
    bhsd = {ns + "flash_fwd_mma_kernel<__nv_bfloat16, 64, 64, 0, true>" +
            args: 1.0,
            ns + "flash_bwd_dq_mma_kernel<__nv_bfloat16, 64, 64, 0, true>" +
            args: 2.0,
            ns + "flash_bwd_dkv_mma_kernel<__nv_bfloat16, 64, 64, 0, true>" +
            args: 2.0}
    packed = {ns + "flash_fwd_mma_kernel<__nv_bfloat16, 64, 64, 1, false>" +
              args: 0.3,
              ns + "flash_bwd_dq_mma_kernel<__nv_bfloat16, 64, 64, 1, "
              "false>" + args: 0.5,
              ns + "flash_bwd_dkv_mma_kernel<__nv_bfloat16, 64, 64, 1, "
              "false>" + args: 0.6,
              "ampere_bf16_s16816gemm_bf16_128x64": 9.0}
    assert cs.flash_bodies(train) == cs.TRAIN_BODIES
    assert cs.flash_bodies(bhsd) == cs.BHSD_BODIES
    assert cs.flash_bodies(packed) == cs.PACKED_BODIES
    monkeypatch.setattr(cs, "DEVICE", "cuda")
    cs.body_gate("training path", train, cs.TRAIN_BODIES)
    cs.body_gate("bhsd path", bhsd, cs.BHSD_BODIES)
    cs.body_gate("packed path", packed, cs.PACKED_BODIES)
    # K5's CUDA-core backward where its tensor-core one must run
    old_k5 = dict(packed)
    del old_k5[ns + "flash_bwd_dq_mma_kernel<__nv_bfloat16, 64, 64, 1, "
               "false>" + args]
    old_k5[ns + "flash_bwd_dq_kernel<__nv_bfloat16, 64, 64, 1, false>" +
           args] = 1.07
    with pytest.raises(AssertionError):
        cs.body_gate("packed path", old_k5, cs.PACKED_BODIES)
    # K5's CUDA-core forward where its tensor-core forward must run
    cuda_fwd = dict(packed)
    del cuda_fwd[ns + "flash_fwd_mma_kernel<__nv_bfloat16, 64, 64, 1, "
                 "false>" + args]
    cuda_fwd[ns + "flash_fwd_kernel<__nv_bfloat16, 64, 64, 1, false>" +
             args] = 2.7
    with pytest.raises(AssertionError):
        cs.body_gate("packed path", cuda_fwd, cs.PACKED_BODIES)
    with pytest.raises(AssertionError):          # K1/K2 in the packed step
        cs.body_gate("packed path", dict(packed, **train),
                     cs.PACKED_BODIES)
    # a CUDA-core body where the tensor-core one must run
    cuda_core = dict(train)
    cuda_core[ns + "flash_fwd_kernel<__nv_bfloat16, 64, 64, 0, false>" +
              args] = 13.0
    with pytest.raises(AssertionError):
        cs.body_gate("training path", cuda_core, cs.TRAIN_BODIES)
    with pytest.raises(AssertionError):          # a body missing
        cs.body_gate("bhsd path", dict(list(bhsd.items())[:2]),
                     cs.BHSD_BODIES)
    # K6's CUDA-core forward where its tensor-core forward must run
    old_k6 = dict(list(bhsd.items())[1:])
    old_k6[ns + "flash_fwd_kernel<__nv_bfloat16, 64, 64, 0, true>" +
           args] = 12.7
    with pytest.raises(AssertionError):
        cs.body_gate("bhsd path", old_k6, cs.BHSD_BODIES)
    # phase 10: one forward body per program, the backward recomputed
    gemm = {"ampere_bf16_s16816gemm_bf16_128x64": 9.0}
    dense = {"bshd": {ns + "flash_fwd_mma_kernel<__nv_bfloat16, 64, 64, 2, "
                      "false>" + args: 0.5},
             "bhsd": {ns + "flash_fwd_mma_kernel<__nv_bfloat16, 64, 64, 2, "
                      "true>" + args: 0.6}}
    for layout, names in dense.items():
        assert cs.flash_bodies(names) == cs.DENSE_BODIES[layout]
        cs.body_gate("dense-mask %s path" % layout, dict(names, **gemm),
                     cs.DENSE_BODIES[layout])
    wrong = [("bshd", {ns + "flash_fwd_kernel<__nv_bfloat16, 64, 64, 2, "
                       "false>" + args: 2.0}),   # K1-dense's CUDA-core body
             ("bhsd", {ns + "flash_fwd_mma_kernel<__nv_bfloat16, 64, 64, 0, "
                       "true>" + args: 0.4}),    # K6-fwd, not the dense one
             ("bhsd", {ns + "flash_fwd_kernel<__nv_bfloat16, 64, 64, 2, "
                       "true>" + args: 1.9})]    # K6-fwd-dense's CUDA-core
    for layout, names in wrong:
        with pytest.raises(AssertionError):
            cs.body_gate("dense-mask %s path" % layout, names,
                         cs.DENSE_BODIES[layout])
    with pytest.raises(AssertionError):          # a flash backward runs
        cs.body_gate("dense-mask bshd path", dict(dense["bshd"], **{
            ns + "flash_bwd_dq_mma_kernel<__nv_bfloat16, 64, 64, 0, false>" +
            args: 0.3}), cs.DENSE_BODIES["bshd"])
    monkeypatch.setattr(cs, "DEVICE", "cpu")     # no kernel runs there
    cs.body_gate("training path", {}, cs.TRAIN_BODIES)


def _smem_report(cuda_core=1000, mma=600, mask_tile=10240):
    """Shared memory per (kernel, head_dim, dtype) as the libraries report
    it: ``cuda_core`` bytes per head_dim unit for a CUDA-core body (fp32
    tiles, either input dtype), ``mma`` for a tensor-core one, whose
    dense-mask forward adds ``mask_tile`` bytes (the staged mask)."""
    out = {}
    for name in cs.FLASH_KERNELS:
        for d in cs.SMEM_HEAD_DIMS:
            mma_body = name in cs.MMA_FLASH and d <= 128
            out[(name, d, "float32")] = cuda_core * d
            out[(name, d, "bfloat16")] = \
                mma * d + mask_tile * (name in cs.DENSE) if mma_body \
                else cuda_core * d
    return out


def test_smem_gate_holds_each_kernel_to_the_body_it_launches():
    """The build phase's shared-memory check: every bf16 tensor-core
    body (K1, K1-dense, K2, K5, K6, K6-fwd-dense at head_dim <= 128)
    reports other bytes than its fp32 CUDA-core twin, every other call
    (head_dim 256) the fp32 bytes, and each bf16 dense-mask forward more
    than the unmasked forward of its layout. The per-head dense forward
    reporting K6-fwd's tensor-core bytes (one size for both bhsd
    forwards: a library that ignores the mask kind) fails it, and so do
    a K6-fwd that reports the CUDA-core body's, a K5 backward that
    reports its CUDA-core body's and a K5 forward that reports its
    fp32 CUDA-core body's under bf16."""
    good = _smem_report()
    assert {n for n in cs.FLASH_KERNELS if good[(n, 64, "bfloat16")] !=
            good[(n, 64, "float32")]} == set(cs.MMA_FLASH)
    assert {"flash_bhsd_fwd_dense", "flash_segment_fwd",
            "flash_segment_bwd_dq", "flash_segment_bwd_dkv"} <= \
        set(cs.MMA_FLASH)
    assert all(good[(n, 256, "bfloat16")] == good[(n, 256, "float32")]
               for n in cs.FLASH_KERNELS)
    cs.smem_gate(good)
    one_size = dict(good)
    for d in cs.SMEM_HEAD_DIMS:
        one_size[("flash_bhsd_fwd_dense", d, "bfloat16")] = \
            good[("flash_bhsd_fwd", d, "bfloat16")]
    with pytest.raises(AssertionError, match="flash_bhsd_fwd_dense d64"):
        cs.smem_gate(one_size)
    stale = dict(good)
    stale[("flash_bhsd_fwd", 64, "bfloat16")] = \
        good[("flash_bhsd_fwd", 64, "float32")]
    with pytest.raises(AssertionError, match="flash_bhsd_fwd d64"):
        cs.smem_gate(stale)
    for name, d, nbytes in (
            ("flash_segment_bwd_dq", 64,
             good[("flash_segment_bwd_dq", 64, "float32")]),
            ("flash_segment_bwd_dkv", 128,
             good[("flash_segment_bwd_dkv", 128, "float32")]),
            ("flash_segment_fwd", 64,
             good[("flash_segment_fwd", 64, "float32")]),
            ("flash_segment_fwd", 128,
             good[("flash_segment_fwd", 128, "float32")])):
        wrong = dict(good)
        wrong[(name, d, "bfloat16")] = nbytes
        with pytest.raises(AssertionError, match="%s d%d" % (name, d)):
            cs.smem_gate(wrong)


def test_mma_spills_reads_ptxas_output():
    """The build's spill gate reads ptxas -v per tensor-core kernel and
    nothing else."""
    dq = "_ZN12_GLOBAL__N_123flash_bwd_dq_mma_kernelI13__nv_bfloat16" \
         "Li64ELi64ELi0ELb0EEEvNS_4ArgsE"
    fwd = "_ZN12_GLOBAL__N_116flash_fwd_kernelIfLi64ELi64ELi0ELb0EEEvNS_4ArgsE"
    mma_fwd = "_ZN12_GLOBAL__N_120flash_fwd_mma_kernelI13__nv_bfloat16" \
              "Li128ELi64ELi0ELb0EEEvNS_4ArgsE"
    text = "\n".join([
        "ptxas info    : Compiling entry function '%s' for 'sm_90a'" % dq,
        "ptxas info    : Function properties for %s" % dq,
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 168 registers, 384 bytes cmem[0]",
        "ptxas info    : Function properties for %s" % fwd,
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Function properties for %s" % mma_fwd,
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 168 registers, 384 bytes cmem[0]"])
    assert cs.mma_spills(text) == {dq: (8, 4), mma_fwd: (0, 0)}
    assert cs.mma_spills("") == {}


@pytest.fixture
def tiny_serving(monkeypatch):
    """The serving phase's constants shrunk, and a shim that counts a
    launch of K3 or K3-quant where the kernel would launch."""
    # head_dim 32 at page 4: an int8 page with its scale takes 0.516 of a
    # bf16 page, so equal bytes admit 31 sequences of 8 pages against 16;
    # budgets of 20+ tokens keep the first admitted decoding until every
    # request has arrived
    for name, value in (("DEVICE", "cpu"), ("VOCAB", 97), ("DIM", 64),
                        ("HEADS", 2), ("LAYERS", 2), ("SLOTS", 8),
                        ("MAX_LEN", 64), ("BUCKETS", "16,32"), ("PAGE", 4),
                        ("SUB_GROUP", 2), ("N_CLIENTS", 2),
                        ("PER_CLIENT", 4), ("PROMPT_LEN", (3, 30)),
                        ("NEW_TOKENS", (3, 8)), ("CAP_SLOTS", 32),
                        ("CAP_TOKENS", 32), ("CAP_BUCKETS", "16,32"),
                        ("CAP_CLIENTS", 8), ("CAP_PER_CLIENT", 6),
                        ("CAP_NEW_TOKENS", (20, 28))):
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(cs, "_timed", lambda fn, args, reps, flush:
                        (fn(*args), 0.5)[1])
    real = pa.paged_decode_attention

    def k3(*args, **kw):
        out = real(*args, **kw)
        if kw.get("quant") is None:
            pa.launches += 1
        else:
            pa.launches_quant += 1
        return out
    monkeypatch.setattr(pa, "paged_decode_attention", k3)
    saved = (pa.launches, pa.launches_quant)
    yield
    pa.launches, pa.launches_quant = saved


def test_quant_kernel_and_append_checks_rehearse_on_the_cpu(tiny_serving):
    before = (pa.launches, pa.launches_quant)
    rows = cs.quant_kernel_checks()
    # 5 geometries x 2 length lists x 2 modes x 2 groups x 2 q dtypes
    assert len(rows) == 80 and all(r["ok"] for r in rows)
    assert rows[0]["pool"] == 2 * cs.SLOTS * cs.MAX_LEN // cs.PAGE + 1
    _assert_split_edges(rows, 8)
    assert {(r["mode"], r["group"]) for r in rows if r["geometry"][4] ==
            cs.PAGE} == {(m, g) for m in cs.KV_MODES
                         for g in (cs.PAGE, cs.SUB_GROUP)}
    assert (pa.launches, pa.launches_quant) == before
    append = cs.quant_append_checks()
    assert len(append) == 4 and all(r["ok"] for r in append)


def _assert_split_edges(rows, per_list):
    """Each geometry of a K3 case list runs both length lists (0, 1,
    mid-page, full; then the split plan's edges), ``per_list`` cases
    each, and the wide table (8 splits a slot, 32 on one-byte pools) is
    among them."""
    lists = {}
    quant = "mode" in rows[0]      # K3-quant's rows: int8/fp8 pools
    for r in rows:
        S, H, KVH, D, page, mp = r["geometry"]
        lists.setdefault((S, H, KVH, D, page, mp), []).append(
            tuple(r["lengths"][:4]))
    for (S, H, KVH, D, page, mp), got in lists.items():
        C = pa.split_plan(mp, page, quant)[0] * page
        T = mp * page
        edges = tuple(min(n, T) for n in (C - 1, C, C + 1, T - 1))
        assert sorted(set(got)) == sorted({(0, 1, 2 * page + 3, T), edges})
        assert got.count(edges) == per_list
    assert tuple(cs.K3_WIDE) in lists
    assert pa.split_plan(cs.K3_WIDE[5], cs.K3_WIDE[4], quant)[1] == \
        (32 if quant else 8)


def test_k3_checks_cover_the_split_edges_and_a_wide_table(tiny_serving,
                                                          monkeypatch):
    """Phase 3's K3 case list: the serving geometry, the reference's
    tuning grid and the wide table, each with lengths 0, 1, a mid-page
    frontier and the full window, and again at the edges of the kernel's
    split plan (a split's tokens - 1, them, + 1, one token short of the
    table); the comparison launches leave the main path's count alone."""
    shim = pa.paged_decode_attention

    def typed(*args, **kw):     # the card's dtype rule for the table
        if args[3].dtype != torch.int32:
            raise TypeError("page_table must be int32")
        return shim(*args, **kw)
    monkeypatch.setattr(pa, "paged_decode_attention", typed)
    rows = cs.kernel_checks()
    # 7 geometries x 2 length lists x 2 q dtypes
    assert len(rows) == 28 and all(r["ok"] for r in rows)
    _assert_split_edges(rows, 2)


def test_serving_phase_with_quantized_runs_rehearses_on_the_cpu(
        tiny_serving, tmp_path, capsys):
    res = cs.main_path(str(tmp_path))
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
    out = capsys.readouterr().out
    assert "K3-quant at a decode step" in out and "token match" in out
    assert "admission at equal pool bytes" in out
    assert "fp8 engine's decode step" in out


def test_megastep_phase_rehearses_on_the_cpu(tiny_serving, tmp_path,
                                            monkeypatch, capsys):
    """Phase 12 at a tiny size after phase 4: every megastep trip runs
    eagerly on the CPU, with the card's gates and launch arithmetic
    (layers x (eager steps + trips + warm-up trips))."""
    monkeypatch.setattr(cs, "MEGASTEP_K", 4)
    monkeypatch.setattr(cs, "MS_GATE_KS", (4, 4, 3))
    monkeypatch.setattr(cs, "MS_PROFILE_MEGASTEPS", 1)
    phase4 = cs.main_path(str(tmp_path))
    res = cs.megastep_path(phase4)
    labels = {"fp32", "bf16", "int8", "fp8"}
    assert set(res["runs"]) == set(res["gates"]) == set(res["profiles"]) \
        == labels
    n = cs.N_CLIENTS * cs.PER_CLIENT
    launches = {"k3": 0, "k3_quant": 0}
    for label, st in res["runs"].items():
        trip = st["trip_stats"]
        assert trip["replays"] == trip["warmups"] == 0
        assert trip["eager_trips"] == trip["trips_dispatched"] > 0
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
    assert res["runs"]["fp32"]["streams_equal_recompute"] == n
    assert res["launches"] == launches
    assert "k1_step_wall_ms" in res["profiles"]["int8"]
    out = capsys.readouterr().out
    for text in ("megastep engine gate", "vs K=1 (phase 4)", "megastep at",
                 "fp8 megastep serving"):
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


def test_trip_gate_and_the_launch_arithmetic(monkeypatch):
    """On the card: one capture and one warm-up trip per variant used,
    every dispatched trip a replay; K3 owes a launch a layer for every
    eager step, trip and warm-up trip; the profile's K3 instances."""
    trip = {"decode_steps": 3, "megasteps": 4, "trips_dispatched": 20,
            "replays": 20, "eager_trips": 0, "warmups": 1,
            "captures_greedy": 1, "captures_sampling": 0}
    monkeypatch.setattr(cs, "DEVICE", "cuda")
    cs.trip_gate("served", trip, {"greedy"})
    cs.trip_gate("gate", dict(trip, captures_sampling=1, warmups=2),
                 {"greedy", "sampling"})
    assert cs.launch_want(trip, 12) == 12 * (3 + 20 + 1)
    for bad in ({"captures_greedy": 2, "warmups": 2}, {"replays": 19},
                {"eager_trips": 20, "replays": 0}, {"warmups": 0},
                {"captures_sampling": 1, "warmups": 2},
                {"trips_dispatched": 0, "replays": 0}):
        with pytest.raises(AssertionError):
            cs.trip_gate("served", dict(trip, **bad), {"greedy"})
    monkeypatch.setattr(cs, "DEVICE", "cpu")
    cs.trip_gate("served", dict(trip, replays=0, eager_trips=20, warmups=0,
                                captures_greedy=0), {"greedy"})
    with pytest.raises(AssertionError):
        cs.trip_gate("served", trip, {"greedy"})
    for key, want in (
            ("void paged_decode_kernel<float, float, 8>(Params)", "k3"),
            ("void paged_decode_kernel<__nv_bfloat16, __nv_bfloat16, 4>"
             "(Params)", "k3"),
            ("void paged_decode_kernel<__nv_bfloat16, signed char, 4>"
             "(Params)", "k3_quant"),
            ("void paged_decode_kernel<__nv_bfloat16, __nv_fp8_e4m3, 4>"
             "(Params)", "k3_quant")):
        assert cs.k3_instance(key) == want
    temps = cs.ms_temperatures(6)
    assert temps.tolist() == [0.0, np.float32(0.9), 0.0, np.float32(0.7),
                              0.0, np.float32(0.9)]


def test_smoke_exits_nonzero_without_a_gpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cs.main([]) != 0
    assert capsys.readouterr().out == ""


def test_flash_case_zeroes_the_cotangent_of_padded_rows(monkeypatch):
    monkeypatch.setattr(cs, "DEVICE", "cpu")
    q, k, v, do, valid = cs._flash_case(np.random.RandomState(0), 3, 40, 2,
                                        1, 8, torch.float32, True)
    assert valid[0].all() and not valid[2].any()
    assert valid[1, :30].all() and not valid[1, 30:].any()
    assert not do[2].any() and not do[1, 30:].any() and do[0].all()


def test_ab_script_carries_this_trees_k3_helpers(tiny_serving,
                                                 monkeypatch):
    """``--ab`` runs this tree's K3 helpers over either tree's kernels:
    the script compiles, and its K3 source and constants, run in a
    module without them (an older tree's ``chip_smoke``), give the K3
    rows there."""
    script = cs._ab_script()
    compile(script, "ab", "exec")
    consts = script.split("vars(cs).update(")[1].split(")\n")[0]
    src = script.split("exec(")[1].split(", vars(cs))")[0]
    older = dict(vars(cs))
    for name in ("k3_step_inputs", "k3_long_timing", "k3_ab_rows",
                 "LONG_SLOTS", "LONG_TOKENS"):
        del older[name]
    older.update(eval(consts), LONG_SLOTS=2, LONG_TOKENS=64)
    exec(eval(src), older)
    rows = older["k3_ab_rows"]()
    assert [r["name"] for r in rows] == [
        cs.K3["name"], cs.K3Q["name"], cs.K3["name"] + "_long"]
    assert all(r["max_abs_err"] == 0.0 and r["ms"] == 0.5 for r in rows)


def test_ab_timing_runs_in_turns_and_reads_each_run(monkeypatch, tmp_path):
    """``--ab``: parent, this tree, this tree, parent, each from its own
    root, one row list per run; a run that fails raises."""
    calls = []

    def fake_run(cmd, cwd, **kw):
        calls.append(cwd)
        ms = 2.0 if cwd == str(tmp_path) else 1.0
        rows = [{"name": "flash_bwd_dq", "ms": ms, "bound_ms": 0.1,
                 "plain_ms": 3.0, "library_ms": 0.5, "max_abs_err": 0.0}]
        return subprocess.CompletedProcess(
            cmd, 0, "noise\nAB_ROWS " + json.dumps(rows) + "\n", "")
    monkeypatch.setattr(cs.subprocess, "run", fake_run)
    runs = cs.ab_timing(str(tmp_path))
    assert calls == [str(tmp_path), cs.REPO, cs.REPO, str(tmp_path)]
    assert [r["tree"] for r in runs] == ["parent", "this", "this", "parent"]
    assert [r["rows"][0]["ms"] for r in runs] == [2.0, 1.0, 1.0, 2.0]
    monkeypatch.setattr(cs.subprocess, "run", lambda cmd, cwd, **kw:
                        subprocess.CompletedProcess(cmd, 1, "", "boom"))
    with pytest.raises(RuntimeError):
        cs.ab_timing(str(tmp_path))


@pytest.fixture
def tiny_resnet(monkeypatch):
    """Phase 11 at a tiny size on the CPU: depth 18, batch 2 of 32x32
    images (the gates: batch 4 of 32x32), 2-step dispatches."""
    for name, value in (("DEVICE", "cpu"), ("RESNET_DEPTH", 18),
                        ("RESNET_BATCH", 2), ("RESNET_SIZE", 32),
                        ("RESNET_CLASSES", 10), ("RESNET_STEPS", 2),
                        ("RESNET_ROUNDS", 2), ("RESNET_EAGER_STEPS", 1),
                        ("RESNET_PROFILE_STEPS", 1), ("RGATE_BATCH", 4),
                        ("RGATE_SIZE", 32), ("RGATE_STEPS", 2),
                        ("RGATE_RUN_CALLS", 1), ("RGATE_N_STEPS", 2)):
        monkeypatch.setattr(cs, name, value)
    monkeypatch.setattr(fluid, "CUDAPlace", lambda i=0: fluid.CPUPlace())


def test_resnet_feed_is_bench_pys():
    feed = cs.resnet_feed(3, 8, 1000)
    rng = np.random.RandomState(0)
    images = rng.rand(3, 3, 8, 8).astype(np.float32)
    label = rng.randint(0, 1000, (3, 1)).astype(np.int64)
    assert feed["images"].dtype == torch.float32
    assert feed["label"].dtype == torch.int64
    np.testing.assert_array_equal(feed["images"].numpy(), images)
    np.testing.assert_array_equal(feed["label"].numpy(), label)


def test_resnet_build_is_bench_pys_program():
    """``build_resnet`` at bench.py's size: the JAX package's program
    (``bench.py:70-84``), op for op and name for name, bf16 under amp,
    and its FLOPs the reference's estimate."""
    import paddle_tpu as jfluid
    from paddle_tpu import models as jmodels
    from paddle_tpu import unique_name as junique
    from paddle_tpu.flops import estimate_program_flops as jflops
    from paddle_tpu_torch.flops import estimate_program_flops
    prog, startup, loss = cs.build_resnet(fluid, 50, 256, 224, 1000, True)
    with junique.guard():
        jprog, jstart = jfluid.Program(), jfluid.Program()
        with jfluid.program_guard(jprog, jstart):
            images = jfluid.layers.data(name="images", shape=[3, 224, 224],
                                        dtype="float32")
            label = jfluid.layers.data(name="label", shape=[1],
                                       dtype="int64")
            pred = jmodels.resnet_imagenet(images, class_dim=1000, depth=50,
                                           data_format="NHWC")
            jloss = jfluid.layers.mean(
                jfluid.layers.cross_entropy(input=pred, label=label))
            jfluid.optimizer.Momentum(learning_rate=0.01, momentum=0.9) \
                .minimize(jloss)
        jfluid.enable_mixed_precision(jprog, True)
    assert [op.type for op in prog.global_block().ops] == \
        [op.type for op in jprog.global_block().ops]
    assert sorted(v.name for v in prog.list_vars()) == \
        sorted(v.name for v in jprog.list_vars())
    assert loss.name == jloss.name and prog._amp
    assert estimate_program_flops(prog, 256) == jflops(jprog, 256)


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
    assert len(res["launches"]) == 14
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


def test_resnet_profile_classes():
    assert cs.resnet_class(
        "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc") == \
        "conv"
    assert cs.resnet_class("cudnn::bn_fw_tr_1C11_kernel_NCHW") == "conv"
    assert cs.resnet_class("void at::native::reduce_kernel<512, 1>") == \
        "reduce"
    assert cs.resnet_class(
        "void at::native::vectorized_elementwise_kernel<4>") == \
        "elementwise"
    assert cs.resnet_class("Memcpy DtoD (Device -> Device)") == "copy"
    assert cs.resnet_class("max_pool_forward_nhwc") == "pool"
    assert cs.resnet_class("nvjet_tst_128x64") == "gemm"


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


def test_phase13_launches_sum_the_main_path_runs():
    runs = {"a": {"launches": {"flash_fwd": 24, "fused_adam": 2}},
            "b": {"launches": {"flash_fwd": 6}}}
    report = {"bench_lm": {"dense": runs["a"], "packed": runs["b"]},
              "fused_adam_path": {"captured": runs["b"]},
              "bhsd_path": {"captured": {"launches": {}}},
              "dense_path": {"bhsd": {"captured": runs["a"]},
                             "bshd": {"captured": {"launches": {}}}}}
    assert cs.phase13_launches(report) == {"flash_fwd": 60,
                                           "fused_adam": 4}


def test_resume_child_arguments():
    args = cs._child_args(["--resume-child", "ck", "out.npz"])
    assert (args.resume_child, args.device, args.layers, args.dim,
            args.heads, args.vocab, args.batch, args.seq) == \
        (["ck", "out.npz"], "cuda", cs.GATE_LAYERS, cs.LM_DIM, cs.LM_HEADS,
         cs.LM_VOCAB, cs.GATE_BATCH, cs.GATE_SEQ)
    assert (args.rounds, args.round_steps, args.preempt_after) == \
        (cs.RESUME_ROUNDS, cs.RESUME_ROUND_STEPS, 0)
    args = cs._child_args(["--resume-child", "ck", "o", "--device", "cpu",
                           "--layers", "1", "--round-steps", "2",
                           "--preempt-after", "2"])
    assert (args.device, args.layers, args.round_steps,
            args.preempt_after) == ("cpu", 1, 2, 2)
    for bad in (["--device", "tpu"], ["--layers", "0"],
                ["--preempt-after", str(cs.RESUME_ROUNDS)],
                ["--preempt-after", "-1"]):
        with pytest.raises(SystemExit):
            cs._child_args(["--resume-child", "ck", "o"] + bad)
    with pytest.raises(SystemExit):
        cs._child_args(["--device", "cpu"])        # no --resume-child


@pytest.fixture
def tiny_nmt(monkeypatch):
    """Phase 15 at a tiny size on the CPU: the lstm checks at b4 t6 h8,
    the gates at batch 2 of length 8, the bench at batch 4, length 12,
    16 wide, vocab 50, 4-step sweeps (one warm, 2 timed)."""
    from paddle_tpu_torch.benchmarks import nmt
    for name, value in (("DEVICE", "cpu"), ("LSTM_BATCH", 4),
                        ("LSTM_STEPS", 6), ("LSTM_WIDTH", 8),
                        ("NGATE_BATCH", 2), ("NGATE_SEQ", 8),
                        ("NMT_EAGER_STEPS", 1), ("NMT_PROFILE_STEPS", 1)):
        monkeypatch.setattr(cs, name, value)
    for name, value in (("BATCH", 4), ("SEQ", 12), ("ITERS", 4),
                        ("ROUNDS", 2), ("WARMUP", 2), ("SRC_VOCAB", 50),
                        ("TRG_VOCAB", 50), ("EMB", 16), ("HID", 16),
                        ("POOL_FACTOR", 2), ("POOL_BUCKET", 4)):
        monkeypatch.setattr(nmt, name, value)
    monkeypatch.setenv("BENCH_FORCE_CPU", "1")
    monkeypatch.setattr(fluid, "CUDAPlace", lambda i=0: fluid.CPUPlace())


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


def test_nmt_profile_classes():
    assert cs.nmt_class("void cutlass::Kernel2<cutlass_80_simt_sgemm_64x64"
                        "_8x5_nn_align1>") == "gemm"
    assert cs.nmt_class("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n") == "gemm"
    assert cs.nmt_class("nvjet_tst_128x64") == "gemm"
    assert cs.nmt_class("void at::native::reduce_kernel<128, 4>") == \
        "reduction"
    assert cs.nmt_class("void at::native::vectorized_elementwise_kernel<4, "
                        "at::native::CUDAFunctor_add<float>>") == \
        "elementwise"
    assert cs.nmt_class("Memcpy DtoD (Device -> Device)") == "copy"
    assert cs.nmt_class("void at::native::(anonymous namespace)::"
                        "CatArrayBatchedCopy<float>") == "copy"


@pytest.fixture
def tiny_fp8(tiny_resnet, monkeypatch):
    """Phase 16 at a tiny size on the CPU: phase 11's sizes at depth 18
    (the bench at batch 4: at batch 2 the last stage's batch norms see 2
    values a channel and fp8 conv outputs turn both packages' losses
    NaN), the three-line bench's child process replaced by its lines."""
    for name, value in (("RESNET_BATCH", 4), ("FP8_STEPS", 2)):
        monkeypatch.setattr(cs, name, value)
    for k in ("PADDLE_TPU_FP8_ACTS", "PADDLE_TPU_FP8_CONV_OUT",
              "BENCH_RESNET_ONLY"):
        monkeypatch.setenv(k, "")       # restored after the test


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
