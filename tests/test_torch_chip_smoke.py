"""``chip_smoke.py`` on the CPU: the fixtures that shrink each phase to a
tiny size (``tiny`` for training, ``serving_patches`` / ``tiny_serving``,
``tiny_resnet``, ``tiny_nmt``, ``tiny_fp8``, ``tiny_infer``), which the
phase rehearsals in ``test_torch_chip_smoke_*.py`` import, and the fast
tests: the K3 / K3-quant and quantized-append checks, the capture gate,
the gates and classifiers over profiled kernel names and ptxas output,
the launch arithmetic, the ``--ab`` script and the argument parsers.

CPU tensors take the kernels' plain versions and count no launch, and
the backward kernels exist only on CUDA, so the rehearsal swaps in shims
that compute through the plain versions and count one launch each. CUDA
events are stubbed (a fixed 0.5 ms). What it shows: the phases' control
flow, shapes, launch accounting and report keys hold together; it
cannot show that a kernel compiles or how fast anything runs.
"""

from tests import torch_threads  # noqa: F401  (first)
import json
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


def test_capture_gc_gate_rehearses_on_the_cpu(tiny, monkeypatch, capsys):
    """On the CPU nothing is captured: the dead executors are collected
    after, no collection counts as inside, the gate's patches are undone."""
    import gc
    from paddle_tpu_torch.ops import launch_count
    monkeypatch.setattr(cs, "CGC_SEQ", 32)
    enter, threshold = launch_count.Capture.__enter__, gc.get_threshold()
    res = cs.capture_gc_gate()
    assert res["captures"] == res["collections_inside"] == 0
    assert res["collected_after"] == res["dead_executors"] == cs.CGC_DEAD
    assert np.isfinite(res["loss"])
    assert launch_count.Capture.__enter__ is enter
    assert gc.get_threshold() == threshold and gc.isenabled()
    assert "captures under the collector" in capsys.readouterr().out


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


def serving_patches(mp):
    """The serving phase's constants shrunk on ``mp`` (a ``MonkeyPatch``),
    and a shim that counts a launch of K3 or K3-quant where the kernel
    would launch."""
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
        mp.setattr(cs, name, value)
    mp.setattr(cs, "_timed", lambda fn, args, reps, flush:
               (fn(*args), 0.5)[1])
    real = pa.paged_decode_attention

    def k3(*args, **kw):
        out = real(*args, **kw)
        if kw.get("quant") is None:
            pa.launches += 1
        else:
            pa.launches_quant += 1
        return out
    mp.setattr(pa, "paged_decode_attention", k3)


@pytest.fixture
def tiny_serving(monkeypatch):
    """``serving_patches`` for one test; the launch counts restored
    after it."""
    serving_patches(monkeypatch)
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


def test_trip_gate_and_the_launch_arithmetic(monkeypatch):
    """On the card: one capture and one warm-up trip per variant used, one
    loop launch per megastep and the trips run (body iterations) within
    the trips dispatched and equal to the synced trips; K3 owes a launch
    a layer for every eager step, trip run and warm-up trip; the
    profile's K3 instances."""
    trip = {"decode_steps": 3, "megasteps": 4, "trips_dispatched": 20,
            "loop_launches": 4, "iterations": 17, "eager_trips": 0,
            "warmups": 1, "captures_greedy": 1, "captures_sampling": 0}
    monkeypatch.setattr(cs, "DEVICE", "cuda")
    cs.trip_gate("served", trip, {"greedy"})
    cs.trip_gate("served", trip, {"greedy"}, trips=17)
    cs.trip_gate("gate", dict(trip, captures_sampling=1, warmups=2),
                 {"greedy", "sampling"})
    assert cs.launch_want(trip, 12) == 12 * (3 + 17 + 1)
    for bad in ({"captures_greedy": 2, "warmups": 2}, {"loop_launches": 3},
                {"eager_trips": 17, "loop_launches": 0}, {"warmups": 0},
                {"captures_sampling": 1, "warmups": 2},
                {"megasteps": 0, "loop_launches": 0}, {"iterations": 0},
                {"iterations": 21}):
        with pytest.raises(AssertionError):
            cs.trip_gate("served", dict(trip, **bad), {"greedy"})
    with pytest.raises(AssertionError):
        cs.trip_gate("served", trip, {"greedy"}, trips=16)
    monkeypatch.setattr(cs, "DEVICE", "cpu")
    cs.trip_gate("served", dict(trip, loop_launches=0, eager_trips=17,
                                warmups=0, captures_greedy=0), {"greedy"})
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
    images (the gates: batch 4 of 32x32), 2-step dispatches, one timed
    round."""
    for name, value in (("DEVICE", "cpu"), ("RESNET_DEPTH", 18),
                        ("RESNET_BATCH", 2), ("RESNET_SIZE", 32),
                        ("RESNET_CLASSES", 10), ("RESNET_STEPS", 2),
                        ("RESNET_ROUNDS", 1), ("RESNET_EAGER_STEPS", 1),
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


@pytest.fixture
def tiny_infer(tiny, monkeypatch):
    """Phase 17 at a tiny size on the CPU: ResNet-18 on 64x64 images, the
    classifier at dict 50, emb 8, hid 16 and 12 ids, the LM of ``tiny``,
    a few requests through the batcher, the CLI child and the drain."""
    for name, value in (
            ("INFER_RESNET", {"depth": 18, "size": 64, "classes": 10}),
            ("INFER_LSTM", {"dict_dim": 50, "emb": 8, "hid": 16,
                            "stacked": 3, "classes": 2, "max_len": 12}),
            ("INFER_BATCHES", (1, 3)),
            ("SERVE_RUNS", {"resnet": {"requests": 16, "distinct": 8,
                                       "max_batch": 8, "bucket": None},
                            "lstm": {"requests": 32, "distinct": 8,
                                     "max_batch": 16, "bucket": 4}}),
            ("SERVE_THREADS", 4), ("HTTP_CLIENTS", 2),
            ("HTTP_PER_CLIENT", 3), ("HTTP_DRAIN_REQUESTS", 8),
            ("INFER_LM_CALLS", 1)):
        monkeypatch.setattr(cs, name, value)
