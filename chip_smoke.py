#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``paddle_tpu_torch``).

    python3 chip_smoke.py [--out REPORT.json] [--kernels-only]

Run from the root of a checkout on a machine with one NVIDIA GPU (built
for the H100: the kernels compile for sm_90a). Phases, each of which
raises on failure (the script then exits non-zero and prints no result):

1. Card: require CUDA; print ``nvidia-smi`` name and power limit.
2. Build: compile every kernel of both slices from
   ``paddle_tpu_torch/csrc`` (one nvcc per source, in parallel).
3. Kernels against their plain versions on the card. K3 in fp32 and
   bf16, at the serving geometry and the reference's tuning grid,
   lengths 0, 1, a mid-page frontier and the full window. K1, K2-dQ and
   K2-dKV (flash attention) in fp32 and bf16, causal and not, h = hkv
   and h = 2 hkv, without a mask and with a factored padding mask (a
   padded tail and a fully padded row), s in {256, 1024, 300}, d in
   {64, 128}, and at the training step's shape (b16 s1024 h8 d64 bf16
   causal): o, lse, dq, dk and dv elementwise.
4. Serving path: the 12-layer, 512-wide decoder (vocab 32000, 8 heads) in
   fp32 and in bf16 with the same random weights, written with
   ``save_decoder`` and served by ``load_decoder`` → ``PagedDecodeEngine``
   → ``GenerationScheduler`` → ``make_server`` on 127.0.0.1. Eight
   clients send six concurrent greedy ``/v1/generate`` requests each
   (48 in flight > 32 slots). fp32 streams must be token-identical to
   ``full_recompute_generate`` on the card; bf16 responses must be well
   formed and the bf16 first-step logits must match the fp32 twin's.
   The K3 launch count must equal decode steps × layers. Prints TTFT
   p50/p99 and decode tokens/s. Then, outside the served window, a
   decode-step profile with all 32 slots busy, and K3 at that step's
   layer-0 inputs: held against the plain version (it fails past the
   stated tolerance) and timed beside its bound, the plain version and
   ``F.scaled_dot_product_attention`` over the same tokens (a yardstick
   only: the port never calls it).
5. Training gate, fp32 with TF32 off: a 2-layer transformer LM at full
   width (512d, 8 heads, vocab 32000), batch 2, seq 512, from one
   initial state, 3 Adam steps through ``Executor.run`` on the card
   (kernels) and on the CPU (plain versions); losses and the first
   attention projection's weights must agree.
6. Training path: ``bench_lm.py``'s step at full size — ``transformer_lm``
   12 layers, 512d, 8 heads, vocab 32000, batch 16, seq 1024, bf16 mixed
   precision, ``Adam(1e-4)`` — built with the layers DSL, startup on the
   card, then 10 steps through ``Executor.run``: the loss must be finite
   and lower at the last step than the first, and K1, K2-dQ and K2-dKV
   must each launch steps x 12 times. Prints step ms p50, tokens/s and a
   ``torch.profiler`` breakdown (device-busy ms per step, idle share,
   the shares of K1, K2 and the GEMMs). Then K1, K2-dQ and K2-dKV at the
   step's attention shape, L2 flushed before each call: each kernel
   beside its bound, its plain version and the library yardstick
   (``F.scaled_dot_product_attention`` forward for K1, its autograd
   backward for K2).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.
"""

import argparse
import concurrent.futures
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
import urllib.error
import urllib.request

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# the serving slice's model: the flagship LM widths
VOCAB, DIM, HEADS, LAYERS, FFN_MULT = 32000, 512, 8, 12, 4
SLOTS, MAX_LEN, BUCKETS, PAGE = 32, 1024, "64,128,256,512", 16
N_CLIENTS, PER_CLIENT = 8, 6
PROMPT_LEN, NEW_TOKENS = (16, 480), (32, 128)   # seeded, inclusive
SEED = 0
DEVICE = "cuda"

# the training slice: bench_lm.py's transformer LM step
LM_VOCAB, LM_DIM, LM_HEADS, LM_LAYERS = 32000, 512, 8, 12
LM_BATCH, LM_SEQ, LM_LR, LM_STEPS, LM_PROFILE_STEPS = 16, 1024, 1e-4, 10, 2
GATE_LAYERS, GATE_BATCH, GATE_SEQ, GATE_STEPS = 2, 2, 512, 3
# (b, s, h, hkv, d) of the flash checks; b = 3 rows: full, padded tail,
# fully padded under the mask
FLASH_GEOMS = [(3, 256, 4, 4, 64), (3, 256, 4, 2, 128),
               (3, 1024, 8, 8, 128), (3, 1024, 8, 4, 64),
               (3, 300, 4, 2, 64), (3, 300, 2, 2, 128)]
# fp32 training gate, card (kernels, cuBLAS) vs CPU (plain versions):
# the same arithmetic in fp32 in another summation order
GATE_LOSS_RTOL = 1e-5
GATE_UPDATE_REL_L2 = 1e-3      # of the weight's 3-step update

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor cores
# Kernel and plain version both compute in fp32 and round once to the
# output's dtype (K3 and K1/K2 alike), so they differ by summation order
# only: ~1e-7 relative in fp32 (the flash grid read <= 1.5e-5 on dv,
# whose sums over 2048 query rows reach tens),
# and in bf16 at most one unit in the last place of the output (<= 2^-7
# relative) where the fp32 values straddle a rounding boundary.
FP32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=1e-3, rtol=1e-2)
BF16_LOGIT_REL_L2 = 5e-2       # bf16 vs fp32 twin, first-step logits

K3 = {"name": "paged_decode_attention", "route": "cuda",
      "source": "paddle_tpu_torch/csrc/paged_decode.cu",
      "replaces": "paddle_tpu/ops/pallas_paged_attention.py:239"}


_FLASH_SRC = "paddle_tpu_torch/csrc/flash_attention.cu"
K1 = {"name": "flash_fwd", "route": "cuda", "source": _FLASH_SRC,
      "replaces": "paddle_tpu/ops/pallas_attention.py:616"}
K2_DQ = {"name": "flash_bwd_dq", "route": "cuda", "source": _FLASH_SRC,
         "replaces": "paddle_tpu/ops/pallas_attention.py:959"}
K2_DKV = {"name": "flash_bwd_dkv", "route": "cuda", "source": _FLASH_SRC,
          "replaces": "paddle_tpu/ops/pallas_attention.py:977"}


def log(msg):
    print(msg, flush=True)


def _sync():
    import torch
    if DEVICE == "cuda":
        torch.cuda.synchronize()


# -- phase 1-2 -------------------------------------------------------------

def card():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        raise RuntimeError("nvidia-smi failed: %s" % smi.stderr.strip())
    line = smi.stdout.strip().splitlines()[0]
    log(line)
    return {"nvidia_smi": line, "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def build():
    from paddle_tpu_torch import _build
    secs = _build.build()
    for name, text in sorted(_build.build_logs.items()):
        for ln in text.splitlines():
            if "registers" in ln or "spill" in ln or "error" in ln:
                log("  nvcc %s: %s" % (name, ln.strip()))
    log("build: %s in %.2f s" % (", ".join(sorted(_build.SOURCES)), secs))
    return secs


# -- phase 3 ---------------------------------------------------------------

def _pool_case(rng, S, MP, page, H, KVH, D, dtype, lengths):
    """Pools of S * MP pages plus the scratch row: at S=SLOTS and
    MP=MAX_LEN/PAGE that is the engine's auto-sized pool."""
    import torch
    P = S * MP
    kp = torch.from_numpy(rng.randn(P + 1, page, KVH, D).astype(np.float32))
    vp = torch.from_numpy(rng.randn(P + 1, page, KVH, D).astype(np.float32))
    pt = torch.from_numpy(rng.randint(0, P, size=(S, MP)).astype(np.int32))
    q = torch.from_numpy(rng.randn(S, H, D).astype(np.float32))
    ln = torch.from_numpy(np.asarray(lengths, np.int32))
    return [t.to(DEVICE) for t in (q.to(dtype), kp.to(dtype), vp.to(dtype),
                               pt, ln)]


def _against_plain(got, ref):
    """(max |err|, ok) of a kernel result against its plain version,
    elementwise within the tolerance of the result's dtype."""
    import torch
    tol = BF16_TOL if got.dtype == torch.bfloat16 else FP32_TOL
    err = (got.float() - ref.float()).abs()
    lim = tol["atol"] + tol["rtol"] * ref.float().abs()
    ok = bool((err <= lim).all()) and bool(torch.isfinite(got).all())
    return float(err.max()), ok


def kernel_checks():
    import torch
    from paddle_tpu_torch.ops import paged_attention as pa
    rng = np.random.RandomState(SEED)
    # (S, H, KVH, D, page, MP): the serving geometry at the engine's slot
    # count and pool size, then the tuning grid of
    # tests/serving/test_paged_generation.py
    geoms = [(SLOTS, HEADS, HEADS, DIM // HEADS, PAGE, MAX_LEN // PAGE),
             (4, 4, 4, 32, 8, 6), (4, 4, 2, 64, 16, 6), (4, 8, 2, 128, 16, 6),
             (4, 4, 2, 192, 8, 6), (4, 4, 1, 256, 8, 6)]
    rows = []
    for S, H, KVH, D, page, MP in geoms:
        # 0 (one live position), 1, a mid-page frontier, the full window,
        # then seeded lengths for the remaining slots
        lengths = [0, 1, 2 * page + 3, MP * page] + [
            int(n) for n in rng.randint(1, MP * page + 1, size=S - 4)]
        for dtype in (torch.float32, torch.bfloat16):
            args = _pool_case(rng, S, MP, page, H, KVH, D, dtype, lengths)
            got = pa.paged_decode_attention(*args)
            _sync()
            err, ok = _against_plain(got,
                                     pa.paged_decode_attention_plain(*args))
            rows.append({"geometry": [S, H, KVH, D, page, MP],
                         "dtype": str(dtype).split(".")[-1],
                         "lengths": lengths, "max_abs_err": err, "ok": ok})
            log("  K3 S=%d H=%d KVH=%d D=%d page=%d pool=%d %s: max|err| "
                "%.3g %s" % (S, H, KVH, D, page, S * MP + 1,
                             rows[-1]["dtype"], err, "ok" if ok else "FAIL"))
    # what the kernel does not take must raise, never fall back
    q, kp, vp, pt, ln = _pool_case(rng, 2, 2, 8, 2, 2, 8, torch.float32,
                                   [3, 5])
    for bad in ((q, kp.to(torch.int8), vp.to(torch.int8), pt, ln),
                (q, kp, vp, pt.long(), ln)):
        try:
            pa.paged_decode_attention(*bad)
        except (TypeError, ValueError):
            continue
        raise AssertionError("K3 accepted inputs it does not take")
    log(json.dumps({"kernel_checks": [{
        "name": K3["name"], "cases": len(rows),
        "ok": all(r["ok"] for r in rows),
        "max_abs_err": max(r["max_abs_err"] for r in rows)}]}))
    if not all(r["ok"] for r in rows):
        raise AssertionError("K3 disagrees with its plain version: %s"
                             % [r for r in rows if not r["ok"]])
    return rows


def _flash_case(rng, b, s, h, hkv, d, dtype, masked):
    """Inputs of one flash check on the card: q, k, v, dO, k_valid. Under
    the mask, row 1 has a padded tail and row 2 no valid key at all; dO
    is zero on padded query rows, as the op hands K2 its cotangent."""
    import torch
    t = [torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(DEVICE)
         .to(dtype) for shape in ((b, s, h, d), (b, s, hkv, d),
                                  (b, s, hkv, d), (b, s, h, d))]
    valid = None
    if masked:
        valid = torch.ones((b, s), dtype=torch.bool, device=DEVICE)
        valid[1, s - s // 4:] = False
        valid[2:] = False
        t[3] = t[3] * valid[:, :, None, None].to(dtype)
    return t + [valid]


def _flash_check(q, k, v, do, valid, causal):
    """K1, then K2-dQ and K2-dKV on the plain forward's (o, lse), each held
    against its plain version elementwise; (max |err| per output, ok)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    o, lse = fa.flash_fwd(q, k, v, None, causal, valid)
    po, plse = fa.flash_fwd_plain(q, k, v, None, causal, valid)
    delta = (do.float() * po.float()).sum(-1)
    dq = fa.flash_bwd_dq(q, k, v, do, plse, delta, None, causal, valid)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, plse, delta, None, causal, valid)
    _sync()
    ref = fa.flash_bwd_plain(q, k, v, po, plse, do, None, causal, valid)
    errs, ok = {}, True
    for name, got, want in zip(("o", "lse", "dq", "dk", "dv"),
                               (o, lse, dq, dk, dv), (po, plse) + ref):
        err, good = _against_plain(got, want)
        errs[name] = err
        ok = ok and good
    return errs, ok


def flash_checks():
    """K1, K2-dQ and K2-dKV against their plain versions on the card over
    the grid of FLASH_GEOMS x dtype x causal x mask, then at the training
    step's shape. Comparison launches do not count as the main path's."""
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    rng = np.random.RandomState(SEED + 2)
    saved = dict(fa.launches)
    rows = []
    cases = [(g, dt, c, m) for g in FLASH_GEOMS
             for dt in (torch.float32, torch.bfloat16)
             for c in (False, True) for m in (False, True)]
    cases.append(((LM_BATCH, LM_SEQ, LM_HEADS, LM_HEADS, LM_DIM // LM_HEADS),
                  torch.bfloat16, True, False))
    for (b, s, h, hkv, d), dtype, causal, masked in cases:
        q, k, v, do, valid = _flash_case(rng, b, s, h, hkv, d, dtype, masked)
        errs, ok = _flash_check(q, k, v, do, valid, causal)
        rows.append({"shape": [b, s, h, hkv, d],
                     "dtype": str(dtype).split(".")[-1], "causal": causal,
                     "masked": masked, "max_abs_err": errs, "ok": ok})
        if not ok or len(rows) == len(cases):
            log("  flash b=%d s=%d h=%d hkv=%d d=%d %s causal=%s mask=%s: "
                "max|err| %s %s" % (b, s, h, hkv, d, rows[-1]["dtype"],
                                   causal, masked, json.dumps(
                                       {n: float("%.3g" % e)
                                        for n, e in errs.items()}),
                                   "ok" if ok else "FAIL"))
    fa.launches.update(saved)
    worst = {n: max(r["max_abs_err"][n] for r in rows)
             for n in ("o", "lse", "dq", "dk", "dv")}
    log(json.dumps({"flash_checks": {"cases": len(rows),
                                     "ok": all(r["ok"] for r in rows),
                                     "max_abs_err": worst}}))
    if not all(r["ok"] for r in rows):
        raise AssertionError("flash kernels disagree with their plain "
                             "versions: %s" % [r for r in rows
                                               if not r["ok"]])
    return rows


# -- phase 4 ---------------------------------------------------------------

def _requests():
    rng = np.random.RandomState(SEED + 1)
    n = N_CLIENTS * PER_CLIENT
    lens = rng.randint(PROMPT_LEN[0], PROMPT_LEN[1] + 1, size=n)
    budgets = rng.randint(NEW_TOKENS[0], NEW_TOKENS[1] + 1, size=n)
    prompts = [rng.randint(0, VOCAB, size=int(k)).astype(np.int32)
               for k in lens]
    return prompts, [int(b) for b in budgets]


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def serve_run(model_dir, prompts, budgets):
    """Serve ``model_dir`` through the port's entry points and send every
    request concurrently; returns the responses, wall seconds, decode
    steps and K3 launches of this run."""
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.observability import catalog
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.serving import (GenerationScheduler,
                                          PagedDecodeEngine, load_decoder,
                                          make_server)

    model, params = load_decoder(model_dir, device=DEVICE)
    engine = PagedDecodeEngine(model, params, max_slots=SLOTS,
                               max_len=MAX_LEN, prefill_buckets=BUCKETS,
                               page_size=PAGE, num_pages=0, device=DEVICE)
    sched = GenerationScheduler(engine, queue_depth=128, seed=SEED)
    server = make_server(sched, host="127.0.0.1", port=0,
                         request_timeout=300.0).start_background()
    url = server.url + "/v1/generate"
    try:
        profiler.reset_counters()
        profiler.reset_histograms()
        pa.launches = 0           # counts from here are the main path's
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(prompts)) as ex:
            futs = [ex.submit(_post, url, {"prompt": p.tolist(),
                                           "max_new_tokens": b,
                                           "temperature": 0.0})
                    for p, b in zip(prompts, budgets)]
            responses = [f.result() for f in futs]
        _sync()
        wall = time.perf_counter() - t0
        launches = pa.launches
        steps = int(catalog.GENERATION_DECODE_STEPS.value())
        hist = {name: profiler.histogram_percentiles(name, (50.0, 99.0))
                for name in ("generation_decode_step_ms",
                             "generation_prefill_ms")}
        metrics = urllib.request.urlopen(server.url + "/metrics",
                                         timeout=60).read().decode()
        health = _get_status(server.url + "/healthz")
    finally:
        status = server.shutdown_gracefully(60.0)
    if not status["drained"]:
        raise RuntimeError("server did not drain: %s" % status)
    if health != 200 or "generation_decode_steps_total" not in metrics:
        raise AssertionError("healthz %s / metrics incomplete" % health)
    if launches <= 0 or launches != steps * model.n_layers:
        raise AssertionError("K3 launches %d != decode steps %d x %d layers"
                             % (launches, steps, model.n_layers))
    return {"model": model, "engine": engine, "responses": responses,
            "wall_s": wall, "steps": steps, "launches": launches,
            "hist": hist}


def _get_status(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def _serving_stats(run):
    ttft = np.array([r["slo"]["ttft_ms"] for r in run["responses"]])
    decode_tokens = sum(len(r["tokens"]) - 1 for r in run["responses"])
    return {"ttft_ms_p50": float(np.percentile(ttft, 50)),
            "ttft_ms_p99": float(np.percentile(ttft, 99)),
            "decode_tokens_per_s": decode_tokens / run["wall_s"],
            "tokens": int(decode_tokens + len(run["responses"])),
            "wall_s": run["wall_s"], "decode_steps": run["steps"],
            "decode_step_ms_p50": run["hist"]["generation_decode_step_ms"][50.0],
            "decode_step_ms_p99": run["hist"]["generation_decode_step_ms"][99.0],
            "prefill_ms_p50": run["hist"]["generation_prefill_ms"][50.0],
            "k3_launches": run["launches"]}


def _timed(fn, args, reps, flush):
    """Mean ms of ``fn(*args)`` over ``reps`` launches, each timed alone
    with CUDA events after the L2 cache was flushed (the serving loop
    touches 12 layers' pools between two calls of one layer)."""
    import torch
    for _ in range(3):
        fn(*args)
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(*args)
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / reps


def k3_timing(step_args, launches):
    """K3 at the layer-0 inputs of a decode step with every slot busy
    (``step_profile``): checked against the plain version, then timed
    beside its bound, the plain version and the SDPA yardstick on the
    same tokens."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import paged_attention as pa
    q, kp, vp, pt, lengths = step_args
    S, H, D = q.shape
    _, page, KVH, _ = kp.shape
    n = lengths.clamp(min=1).long()
    elem = q.element_size()
    tokens = int(n.sum())
    pages = int(((n + page - 1) // page).sum())
    nbytes = (tokens * KVH * D * 2 * elem + 2 * q.numel() * elem
              + pages * 4 + S * 4)
    flops = tokens * H * D * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    saved = pa.launches
    got = pa.paged_decode_attention(q, kp, vp, pt, lengths)
    _sync()
    err, ok = _against_plain(
        got, pa.paged_decode_attention_plain(q, kp, vp, pt, lengths))
    if not ok:
        raise AssertionError("K3 disagrees with its plain version at the "
                             "decode step's inputs: max|err| %.3g" % err)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device=DEVICE)
    ms = _timed(pa.paged_decode_attention, (q, kp, vp, pt, lengths), 200,
                flush)
    plain_ms = _timed(pa.paged_decode_attention_plain,
                      (q, kp, vp, pt, lengths), 50, flush)
    # yardstick: the same live tokens pre-gathered into a dense cache
    L = int(n.max())
    idx = pt.long()
    kd = kp[idx].reshape(S, -1, KVH, D)[:, :L].permute(0, 2, 1, 3).contiguous()
    vd = vp[idx].reshape(S, -1, KVH, D)[:, :L].permute(0, 2, 1, 3).contiguous()
    mask = (torch.arange(L, device=DEVICE)[None, :] < n[:, None])[:, None,
                                                                 None, :]
    q4 = q[:, :, None, :]

    def sdpa(q4, kd, vd, mask):
        return F.scaled_dot_product_attention(q4, kd, vd, attn_mask=mask)

    library_ms = _timed(sdpa, (q4, kd, vd, mask), 200, flush)
    pa.launches = saved   # comparison launches are not the main path's
    row = dict(K3)
    row.update({"launches": launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": library_ms})
    log("K3 at a decode step with every slot busy: S=%d H=%d KVH=%d D=%d "
        "page=%d %s, %d live tokens, %.1f MB: %.4f ms (bound %.4f ms, %.1f%% of it; "
        "plain %.4f ms; sdpa %.4f ms); max|err| vs plain %.3g"
        % (S, H, KVH, D, page, str(q.dtype).split(".")[-1], tokens,
           nbytes / 1e6, ms, row["bound_ms"], 100 * row["bound_ms"] / ms,
           plain_ms, library_ms, err))
    return row, {"live_tokens": tokens, "bytes": nbytes, "flops": flops}


def step_profile(engine, prompts, steps=20):
    """Where a decode step's time goes at 32 busy slots: host wall per
    step (unprofiled), device-busy time per step and K3's share of it
    (``torch.profiler``), and the device kernels taking the most time.
    Also returns copies of the K3 inputs of layer 0 of one more step,
    for ``k3_timing``."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.ops import paged_attention as pa
    for i, p in enumerate(prompts[:engine.max_slots]):
        engine.prefill(i, p, max_new_tokens=2 * steps + 8)
        engine.set_input_token(i, 1)
    for _ in range(3):
        engine.decode_step()
    _sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        engine.decode_step()
    _sync()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    acts = [ProfilerActivity.CPU]
    if DEVICE == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        for _ in range(steps):
            engine.decode_step()
        _sync()
    real, captured = pa.paged_decode_attention, []

    def capture(*args, **kw):
        if not captured:
            captured.extend(t.clone() for t in args)
        return real(*args, **kw)
    pa.paged_decode_attention = capture
    try:
        engine.decode_step()
    finally:
        pa.paged_decode_attention = real
    for i in range(engine.max_slots):
        if engine.active[i]:
            engine.release(i)

    def dev_us(e):
        return e.self_device_time_total
    # kernel rows only: operator rows repeat their kernels' device time
    events = [e for e in prof.key_averages()
              if str(e.device_type) == "DeviceType.CUDA" and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in events) / steps / 1e3
    k3 = sum(dev_us(e) for e in events
             if "paged_decode_kernel" in e.key) / steps / 1e3
    top = sorted(events, key=dev_us, reverse=True)[:6]
    out = {"slots": int(min(len(prompts), engine.max_slots)),
           "step_wall_ms": wall_ms, "device_busy_ms": busy,
           "device_idle_share": 1.0 - busy / wall_ms if wall_ms else None,
           "k3_ms": k3,
           "top_kernels_ms": {e.key[:60]: dev_us(e) / steps / 1e3
                              for e in top}}
    log("decode step at %d slots: %.3f ms wall, %.3f ms device-busy "
        "(idle %.0f%%), K3 %.3f ms; top: %s"
        % (out["slots"], wall_ms, busy, 100 * (out["device_idle_share"]
                                                or 0), k3,
           json.dumps(out["top_kernels_ms"])))
    return out, tuple(captured)


def main_path(workdir):
    import torch
    from paddle_tpu_torch.serving import (TransformerDecoderModel,
                                          full_recompute_generate,
                                          save_decoder)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("main path: TF32 off for matmuls and cuDNN (fp32 means fp32)")
    m32 = TransformerDecoderModel(VOCAB, dim=DIM, n_heads=HEADS,
                                  n_layers=LAYERS, ffn_mult=FFN_MULT)
    m16 = TransformerDecoderModel(VOCAB, dim=DIM, n_heads=HEADS,
                                  n_layers=LAYERS, ffn_mult=FFN_MULT,
                                  dtype=torch.bfloat16)
    p32 = m32.init_params(SEED, device="cpu")
    p16 = {k: ([{n: t.to(torch.bfloat16) for n, t in b.items()} for b in v]
               if k == "blocks" else v.to(torch.bfloat16))
           for k, v in p32.items()}
    d32, d16 = os.path.join(workdir, "fp32"), os.path.join(workdir, "bf16")
    save_decoder(d32, m32, p32)
    save_decoder(d16, m16, p16)
    del p32, p16
    prompts, budgets = _requests()

    run32 = serve_run(d32, prompts, budgets)
    s32 = _serving_stats(run32)
    log("fp32 serving: %s" % json.dumps(s32))
    run16 = serve_run(d16, prompts, budgets)
    s16 = _serving_stats(run16)
    log("bf16 serving: %s" % json.dumps(s16))
    launches = run32["launches"] + run16["launches"]

    # fp32 streams: token-identical to full recompute on the card
    t0 = time.perf_counter()
    ref = full_recompute_generate(m32, run32["engine"].params, prompts,
                                  budgets, max_len=MAX_LEN)
    bad = [i for i, r in enumerate(run32["responses"])
           if r["tokens"] != ref[i]]
    log("fp32 full recompute of %d streams in %.1f s: %d differ"
        % (len(ref), time.perf_counter() - t0, len(bad)))
    if bad:
        i = bad[0]
        got = run32["responses"][i]["tokens"]
        j = next(k for k in range(min(len(got), len(ref[i])))
                 if got[k] != ref[i][k]) if got[:len(ref[i])] != ref[i] \
            else len(ref[i])
        raise AssertionError(
            "fp32 stream %d differs from full recompute at token %d "
            "(served %s, recomputed %s)" % (i, j, got[j:j + 4],
                                            ref[i][j:j + 4]))
    for r, b in zip(run32["responses"] + run16["responses"], budgets * 2):
        if r["finish_reason"] != "length" or len(r["tokens"]) != b or \
                not all(0 <= t < VOCAB for t in r["tokens"]):
            raise AssertionError("malformed response: %s" % {
                k: r[k] for k in ("finish_reason", "n_prompt")})

    # bf16: first-step logits against the fp32 twin on the same prompts
    k = 8
    buf = np.zeros((k, max(len(p) for p in prompts[:k])), np.int32)
    for i, p in enumerate(prompts[:k]):
        buf[i, :len(p)] = p
    toks = torch.from_numpy(buf).to(DEVICE)
    lens = torch.tensor([len(p) for p in prompts[:k]], device=DEVICE)
    with torch.no_grad():
        l32 = m32.last_logits_and_kv(run32["engine"].params, toks, lens,
                                     need_kv=False)[0].float()
        l16 = m16.last_logits_and_kv(run16["engine"].params, toks, lens,
                                     need_kv=False)[0].float()
    rel = float((l16 - l32).norm() / l32.norm())
    agree = int((l16.argmax(-1) == l32.argmax(-1)).sum())
    log("bf16 vs fp32 first-step logits: rel L2 %.4g (limit %g), argmax "
        "agrees on %d/%d, max|diff| %.4g"
        % (rel, BF16_LOGIT_REL_L2, agree, k, (l16 - l32).abs().max()))
    if not (rel <= BF16_LOGIT_REL_L2 and torch.isfinite(l16).all()):
        raise AssertionError("bf16 logits off the fp32 twin: rel L2 %.4g"
                             % rel)
    prof, step_args = step_profile(run16["engine"], prompts)
    row, shape = k3_timing(step_args, launches)
    return {"fp32": s32, "bf16": s16, "k3": row, "k3_step": shape,
            "bf16_step_profile": prof,
            "bf16_logit_rel_l2": rel, "bf16_argmax_agree": agree}


# -- phases 5-6: training -------------------------------------------------

def build_lm(fluid, layers, batch, seq, amp):
    """bench_lm.py's program: transformer_lm, softmax cross-entropy on the
    next token, mean, Adam(LM_LR); bf16 mixed precision when ``amp``."""
    from paddle_tpu_torch import models, unique_name
    with unique_name.guard():
        prog, startup = fluid.Program(), fluid.Program()
        prog.random_seed = startup.random_seed = SEED
        with fluid.program_guard(prog, startup):
            ids = fluid.layers.data(name="ids", shape=[batch, seq],
                                    dtype="int64", append_batch_size=False)
            labels = fluid.layers.data(name="labels", shape=[batch, seq],
                                       dtype="int64",
                                       append_batch_size=False)
            logits = models.transformer_lm(
                ids, vocab_size=LM_VOCAB, num_layers=layers,
                d_model=LM_DIM, num_heads=LM_HEADS, max_len=seq)
            flat = fluid.layers.reshape(logits, [batch * seq, LM_VOCAB])
            flat_lbl = fluid.layers.reshape(labels, [batch * seq, 1])
            loss = fluid.layers.mean(
                fluid.layers.softmax_with_cross_entropy(flat, flat_lbl))
            fluid.optimizer.Adam(learning_rate=LM_LR).minimize(loss)
        fluid.enable_mixed_precision(prog, amp)
    return prog, startup, loss


def lm_feed(batch, seq):
    """bench_lm.py's feed: ids from seed 0, labels the ids rolled by one."""
    rng = np.random.RandomState(SEED)
    x = rng.randint(0, LM_VOCAB, (batch, seq))
    return {"ids": x.astype(np.int32),
            "labels": np.roll(x, -1, 1).astype(np.int32)}


def train_gate():
    """fp32 card-vs-CPU gate: the 2-layer full-width LM from one initial
    state (the CPU startup's, copied to the card), 3 Adam steps on each;
    losses within GATE_LOSS_RTOL, the first attention projection's
    3-step update within GATE_UPDATE_REL_L2."""
    import torch
    import paddle_tpu_torch as fluid
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("training gate: fp32, TF32 off for matmuls and cuDNN")
    prog, startup, loss = build_lm(fluid, GATE_LAYERS, GATE_BATCH,
                                   GATE_SEQ, amp=False)
    feed = lm_feed(GATE_BATCH, GATE_SEQ)
    cpu = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=cpu)
    card_scope = fluid.Scope()
    for n in cpu.local_var_names():
        card_scope.set_var(n, cpu.find_var(n).to(DEVICE))
    weight = "fc_0.w_0"          # layer 0's query projection
    start = cpu.find_var(weight).clone()
    out = {}
    for tag, scope, place in (("card", card_scope, fluid.CUDAPlace(0)),
                              ("cpu", cpu, fluid.CPUPlace())):
        exe = fluid.Executor(place)
        t0 = time.perf_counter()
        losses = [float(exe.run(prog, feed=feed, fetch_list=[loss],
                                scope=scope)[0]) for _ in range(GATE_STEPS)]
        out[tag] = {"losses": losses, "s": time.perf_counter() - t0,
                    "w": scope.find_var(weight).float().cpu()}
    rel = [abs(a - b) / abs(b) for a, b in zip(out["card"]["losses"],
                                                out["cpu"]["losses"])]
    upd_card = out["card"]["w"] - start
    upd_cpu = out["cpu"]["w"] - start
    upd_rel = float((upd_card - upd_cpu).norm() / upd_cpu.norm())
    wmax = float((out["card"]["w"] - out["cpu"]["w"]).abs().max())
    res = {"losses_card": out["card"]["losses"],
           "losses_cpu": out["cpu"]["losses"], "loss_rel_err": max(rel),
           "weight": weight, "update_rel_l2": upd_rel,
           "weight_max_abs_diff": wmax, "card_s": out["card"]["s"],
           "cpu_s": out["cpu"]["s"]}
    log("training gate: %s" % json.dumps(res))
    if not (max(rel) <= GATE_LOSS_RTOL and upd_rel <= GATE_UPDATE_REL_L2
            and all(np.isfinite(out["card"]["losses"]))):
        raise AssertionError("card and CPU training disagree: loss rel err "
                             "%.3g (limit %g), %s update rel L2 %.3g "
                             "(limit %g)" % (max(rel), GATE_LOSS_RTOL,
                                             weight, upd_rel,
                                             GATE_UPDATE_REL_L2))
    return res


def _profile_steps(exe, prog, feed, loss, steps):
    """Over ``steps`` profiled training steps (``torch.profiler``):
    device-busy ms per step and kernel time by class (kernel rows only),
    and per op type the host ms and device ms of its lowering (the
    executor's per-op ranges). The generic-vjp recompute estimate is the
    device time of the forwards whose grad ops re-run them."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.registry import OP_REGISTRY
    acts = [ProfilerActivity.CPU]
    if DEVICE == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        for _ in range(steps):
            exe.run(prog, feed=feed, fetch_list=[loss])
        _sync()
    averages = prof.key_averages()
    # kernel rows only: the per-op ranges also show on the device
    # timeline as user annotations, which would count their kernels twice
    events = [e for e in averages
              if str(e.device_type) == "DeviceType.CUDA"
              and not getattr(e, "is_user_annotation", False)
              and e.key not in OP_REGISTRY
              and e.self_device_time_total > 0]

    def ms(pred):
        return sum(e.self_device_time_total for e in events
                   if pred(e.key)) / steps / 1e3
    busy = ms(lambda k: True)
    k1 = ms(lambda k: "flash_fwd_kernel" in k)
    k2 = ms(lambda k: "flash_bwd_" in k)
    gemm = ms(lambda k: any(t in k.lower() for t in
                            ("gemm", "nvjet", "xmma", "cutlass")))
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    ops = {e.key: {"host_ms": e.cpu_time_total / steps / 1e3,
                   "device_ms": e.device_time_total / steps / 1e3,
                   "calls": e.count // steps}
           for e in averages if e.key in OP_REGISTRY
           and str(e.device_type) == "DeviceType.CPU"}
    generic = [t[:-len("_grad")] for t, info in OP_REGISTRY.items()
               if info.generic_grad and t in ops]
    return {"device_busy_ms": busy, "k1_ms": k1, "k2_ms": k2,
            "gemm_ms": gemm, "other_ms": busy - k1 - k2 - gemm,
            "top_kernels_ms": {e.key[:70]: e.self_device_time_total
                               / steps / 1e3 for e in top},
            "ops_host_ms": sum(o["host_ms"] for o in ops.values()),
            "ops": dict(sorted(ops.items(),
                               key=lambda kv: -kv[1]["host_ms"])),
            "generic_vjp_recompute_ms": sum(ops[t]["device_ms"]
                                            for t in generic if t in ops)}


def train_path():
    """The training slice at full size on the card: startup, LM_STEPS
    steps through Executor.run with the flash launch counts set to 0
    just before and read just after, then a profiled window."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import flash_attention as fa
    prog, startup, loss = build_lm(fluid, LM_LAYERS, LM_BATCH, LM_SEQ,
                                   amp=True)
    feed = lm_feed(LM_BATCH, LM_SEQ)
    n_params = sum(int(np.prod(p.shape))
                   for p in prog.global_block().all_parameters())
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup)
        for name in fa.launches:
            fa.launches[name] = 0      # counts from here are the main path's
        losses, step_ms = [], []
        for _ in range(LM_STEPS):
            t0 = time.perf_counter()
            losses.append(float(exe.run(prog, feed=feed,
                                        fetch_list=[loss])[0]))
            step_ms.append((time.perf_counter() - t0) * 1e3)
        launches = dict(fa.launches)
        prof = _profile_steps(exe, prog, feed, loss, LM_PROFILE_STEPS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 \
        if DEVICE == "cuda" else None
    want = LM_STEPS * LM_LAYERS
    p50 = float(np.percentile(step_ms[1:], 50))
    res = {"params": n_params, "losses": losses, "step_ms": step_ms,
           "step_ms_p50": p50,
           "tokens_per_s": LM_BATCH * LM_SEQ / (p50 / 1e3),
           "launches": launches, "peak_memory_gb": peak_gb}
    res.update(prof)
    res["device_idle_share"] = 1.0 - prof["device_busy_ms"] / p50
    busy = prof["device_busy_ms"] or float("nan")
    res["shares_of_busy"] = {k: prof[k + "_ms"] / busy
                             for k in ("k1", "k2", "gemm", "other")}
    log("training %dL-%dd b%d s%d bf16, %d params: %s"
        % (LM_LAYERS, LM_DIM, LM_BATCH, LM_SEQ, n_params, json.dumps(res)))
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError("training loss not finite and falling: %s"
                             % losses)
    if any(launches[n] != want for n in launches):
        raise AssertionError("flash launches %s != steps %d x layers %d"
                             % (launches, LM_STEPS, LM_LAYERS))
    return res


def flash_timing(launches):
    """K1, K2-dQ and K2-dKV at the training step's attention shape (b16
    s1024 h8 d64 bf16 causal), each call timed alone with L2 flushed,
    beside its bound, its plain version and the library yardstick."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import flash_attention as fa
    b, s, h, d = LM_BATCH, LM_SEQ, LM_HEADS, LM_DIM // LM_HEADS
    rng = np.random.RandomState(SEED + 3)
    q, k, v, do, _ = _flash_case(rng, b, s, h, h, d, torch.bfloat16, False)
    saved = dict(fa.launches)
    errs, ok = _flash_check(q, k, v, do, None, True)
    if not ok:
        raise AssertionError("flash kernels disagree with their plain "
                             "versions at the step's shape: %s" % errs)
    o, lse = fa.flash_fwd(q, k, v, None, True)
    delta = (do.float() * o.float()).sum(-1)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device=DEVICE)
    ms = {"K1": _timed(fa.flash_fwd, (q, k, v, None, True), 20, flush),
          "dq": _timed(fa.flash_bwd_dq, (q, k, v, do, lse, delta, None,
                                         True), 20, flush),
          "dkv": _timed(fa.flash_bwd_dkv, (q, k, v, do, lse, delta, None,
                                           True), 20, flush)}
    plain = {"K1": _timed(fa.flash_fwd_plain, (q, k, v, None, True), 5,
                          flush),
             "bwd": _timed(fa.flash_bwd_plain, (q, k, v, o, lse, do, None,
                                                True), 5, flush)}
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    lib_fwd = _timed(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), (), 20, flush)
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    g = do.transpose(1, 2)
    lib_bwd = _timed(lambda: torch.autograd.grad(out, (qt, kt, vt), g,
                                                 retain_graph=True),
                     (), 20, flush)
    fa.launches.update(saved)   # comparison launches are not the path's
    # bound: the larger of the causal work at the bf16 tensor-core rate
    # and each input read once plus each output written once
    pairs = b * h * s * (s + 1) // 2
    act = b * s * h * d * 2                   # one bf16 [b, s, h, d]
    lse_b, delta_b = b * h * s * 8 * 4, b * s * h * 4
    work = {"K1": (4 * d * pairs, 4 * act + lse_b),
            "dq": (6 * d * pairs, 5 * act + lse_b + delta_b),
            "dkv": (8 * d * pairs, 6 * act + lse_b + delta_b)}
    rows = []
    for key, base, err, plain_ms, lib in (
            ("K1", K1, errs["o"], plain["K1"], lib_fwd),
            ("dq", K2_DQ, errs["dq"], plain["bwd"], lib_bwd),
            ("dkv", K2_DKV, max(errs["dk"], errs["dv"]), plain["bwd"],
             lib_bwd)):
        flops, nbytes = work[key]
        t_ops, t_bytes = flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S
        row = dict(base)
        row.update({"launches": launches[base["name"]], "max_abs_err": err,
                    "ms": ms[key], "plain_ms": plain_ms,
                    "bound_ms": max(t_ops, t_bytes) * 1e3,
                    "bound_by": "bytes" if t_bytes >= t_ops
                    else "operations", "library_ms": lib,
                    "gflop": flops / 1e9, "mb": nbytes / 1e6})
        rows.append(row)
        log("%s at b%d s%d h%d d%d bf16 causal: %.4f ms (bound %.4f ms by "
            "%s, %.1f%% of it; plain %.4f ms; library %.4f ms); %.1f GFLOP "
            "%.1f MB; max|err| vs plain %.3g"
            % (base["name"], b, s, h, d, row["ms"], row["bound_ms"],
               row["bound_by"], 100 * row["bound_ms"] / row["ms"],
               plain_ms, lib, flops / 1e9, nbytes / 1e6, err))
    log("flash K1+K2 %.4f ms vs SDPA fwd+bwd %.4f ms"
        % (ms["K1"] + ms["dq"] + ms["dkv"], lib_fwd + lib_bwd))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write the full report as JSON here")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks (phases 1-3)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    report = {"card": card()}
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        t0 = time.perf_counter()
        report["build_s"] = build()
        report["kernel_checks"] = kernel_checks()
        report["flash_checks"] = flash_checks()
        if not args.kernels_only:
            report["main_path"] = main_path(workdir)
            report["train_gate"] = train_gate()
            report["train_path"] = train_path()
            report["flash_timing"] = flash_timing(
                report["train_path"]["launches"])
        report["seconds"] = time.perf_counter() - t0
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(report, f, indent=1, default=str)
    if not args.kernels_only:
        print(json.dumps({"kernels": [report["main_path"]["k3"]] +
                          report["flash_timing"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": report["card"]["name"],
        "count": report["card"]["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
