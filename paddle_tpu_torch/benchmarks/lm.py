"""Transformer-LM training tokens/s on one card — the port of
``bench_lm.py``: the same program (``transformer_lm`` 12 layers, 512
wide, 8 heads, vocab 32000, bf16 mixed precision, ``Adam(1e-4)``), the
same environment knobs, the same rounds and the same JSON keys.

    python -m paddle_tpu_torch.benchmarks.lm

Each round is ``Executor.run_steps(n_steps=ITERS, return_numpy=False)``:
on the card one captured CUDA graph replayed ITERS times, whose replays
launch the flash kernels (K1/K2, or K5 with ``BENCH_PACKED=1``). The
rounds run under ``robustness.train_loop`` with
``CheckpointManager.from_flags()`` (a SIGTERM checkpoints and exits 42;
``FLAGS_step_deadline_s`` arms the hang watchdog); warm rounds sync only
on the last, each timed round syncs once, through its
``FetchHandle.numpy()`` (so ``device_wait_s`` counts the wait).

``BENCH_PACKED=1`` measures the segment-packed path instead: ragged
documents packed into ``[BATCH, SEQ]`` rows with segment ids, against the
same documents padded one per row under a ``valid`` mask; both rates in
REAL tokens/s.

Knobs (environment): BENCH_BATCH (16), BENCH_SEQ (1024), BENCH_WARMUP
(steps, rounded up to whole rounds; 3), BENCH_ITERS (60), BENCH_ROUNDS
(3), BENCH_PACKED (0). ``BENCH_FORCE_CPU=1`` runs on the CPU (plain
versions of the kernels); without it a machine with no card gets the
failure JSON line and exit 1.
"""

import json
import os
import time

import numpy as np

METRIC = "transformer_lm_train_tokens_per_sec_per_chip"
UNIT = "tokens/sec"
BATCH = int(os.environ.get("BENCH_BATCH", 16))
SEQ = int(os.environ.get("BENCH_SEQ", 1024))
VOCAB = 32000
LAYERS, D_MODEL, HEADS = 12, 512, 8
WARMUP = int(os.environ.get("BENCH_WARMUP", 3))
ITERS = int(os.environ.get("BENCH_ITERS", 60))
PACKED = os.environ.get("BENCH_PACKED", "0") == "1"
ROUNDS = int(os.environ.get("BENCH_ROUNDS", 3))


def _measure_rounds(exe, prog, loss, feed, iters, warm_rounds, rounds):
    """ITERS-step run_steps rounds under robustness.train_loop — the one
    copy of the bench methodology (warm rounds synced only on the last,
    timed rounds synced through the fetch handle). Returns (median
    timed-round seconds, last round's fetch handle)."""
    from .. import robustness
    dts = []
    state = {"lv": None}

    def bench_round(i):
        t0 = time.perf_counter()
        lv = exe.run_steps(prog, feed=feed, n_steps=iters,
                           fetch_list=[loss], return_numpy=False)
        state["lv"] = lv
        if i < warm_rounds:
            if i == warm_rounds - 1:
                lv.numpy()
        else:
            lv.numpy()
            dts.append(time.perf_counter() - t0)
        return lv

    # resume=False: a bench's round index is not a resumable trajectory
    # position — a relaunch re-measures from round 0 (the SIGTERM
    # checkpoint is for state inspection, not resume)
    robustness.train_loop(
        bench_round, warm_rounds + rounds, program=prog, executor=exe,
        checkpoint=robustness.CheckpointManager.from_flags(),
        resume=False)
    dts.sort()
    return dts[len(dts) // 2], state["lv"]


def _build_lm(batch, seq, packed_rows=False, valid=True, *, layers=None,
              d_model=None, heads=None, vocab=None, optimizer=None,
              amp=True):
    """The LM training program; ``packed_rows`` adds a seg-id feed for the
    packed path (segment-aware attention), otherwise ``valid`` a padding
    feed (the padded baseline); ``valid=False`` is ``main()``'s program,
    with neither. The sizes default to LAYERS, D_MODEL, HEADS and VOCAB,
    the optimizer to ``Adam(1e-4)``; ``amp``: bf16 mixed precision."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import models

    layers = LAYERS if layers is None else layers
    d_model = D_MODEL if d_model is None else d_model
    heads = HEADS if heads is None else heads
    vocab = VOCAB if vocab is None else vocab
    if optimizer is None:
        optimizer = fluid.optimizer.Adam(learning_rate=1e-4)
    prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(prog, startup):
        ids = fluid.layers.data(name="ids", shape=[batch, seq],
                                dtype="int64", append_batch_size=False)
        labels = fluid.layers.data(name="labels", shape=[batch, seq],
                                   dtype="int64", append_batch_size=False)
        kw = {}
        if packed_rows:
            kw["segment_ids"] = fluid.layers.data(
                name="seg", shape=[batch, seq], dtype="int32",
                append_batch_size=False)
        elif valid:
            kw["valid"] = fluid.layers.data(
                name="valid", shape=[batch, seq], dtype="int32",
                append_batch_size=False)
        logits = models.transformer_lm(
            ids, vocab_size=vocab, num_layers=layers, d_model=d_model,
            num_heads=heads, max_len=seq, **kw)
        flat = fluid.layers.reshape(logits, [batch * seq, vocab])
        flat_lbl = fluid.layers.reshape(labels, [batch * seq, 1])
        # fused log-softmax + gather loss: no fp32 probabilities over the
        # 32k vocab
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(flat, flat_lbl))
        optimizer.minimize(loss)
    fluid.enable_mixed_precision(prog, amp)
    return prog, startup, loss


def dense_data(batch, seq, vocab):
    """``main()``'s feed from ``RandomState(0)``: ids, and labels the ids
    rolled by one."""
    x = np.random.RandomState(0).randint(0, vocab, (batch, seq))
    return {"ids": x.astype(np.int32),
            "labels": np.roll(x, -1, 1).astype(np.int32)}


def packed_data(batch, seq, vocab):
    """``packed_main()``'s inputs from ``RandomState(0)``: ragged documents
    packed into ``batch`` rows, and the same documents padded one per
    row. Returns (packed feed, baseline feed, real tokens packed, real
    tokens baseline, documents) as numpy."""
    from ..data import decorator as D
    rng = np.random.RandomState(0)
    docs = []
    # ragged docs at ~1/4 SEQ mean length: enough to fill BATCH rows
    while sum(len(d) for d in docs) < int(batch * seq * 1.05):
        docs.append(rng.randint(1, vocab, size=int(
            rng.randint(seq // 8, seq // 2))).astype(np.int32))
    rows = D.pack_segments(docs, seq)[:batch]
    ids = np.stack([t for t, _ in rows]).astype(np.int32)
    seg = np.stack([s for _, s in rows]).astype(np.int32)
    lab = D.packed_next_token_labels(ids, seg, ignore_id=0)
    packed = {"ids": ids, "seg": seg, "labels": lab.astype(np.int32)}
    # real tokens = positions outside each row's final (padding) segment
    pad_mask = np.zeros_like(seg, bool)
    for r in range(seg.shape[0]):
        tail = seg[r] == seg[r, -1]
        if ids[r][tail].max(initial=0) == 0 and seg[r, -1] > 0:
            pad_mask[r] = tail
    real_packed = int((~pad_mask).sum())
    # the baseline batch: exactly the documents that landed in the
    # measured packed rows, one per row, padded to SEQ
    base_docs = []
    for t, s in rows:
        for si in range(int(s.max()) + 1):
            span = t[s == si]
            if len(span) and not (span == 0).all():
                base_docs.append(span)
    nb = len(base_docs)
    base_ids = np.zeros((nb, seq), np.int32)
    base_valid = np.zeros((nb, seq), np.int32)
    for i, d in enumerate(base_docs):
        base_ids[i, :len(d)] = d
        base_valid[i, :len(d)] = 1
    base_lab = np.zeros((nb, seq), np.int32)
    base_lab[:, :-1] = base_ids[:, 1:]
    base = {"ids": base_ids, "valid": base_valid, "labels": base_lab}
    return packed, base, real_packed, int(base_valid.sum()), base_docs


def _on_device(feed, exe):
    """The feed uploaded once: device-resident, as the rounds reuse it."""
    import torch
    return {k: torch.as_tensor(v).to(exe.device) for k, v in feed.items()}


def packed_main():
    """BENCH_PACKED=1: segment-packed rows (flash segment kernels) vs
    the same ragged documents padded one per row (factored mask) —
    REAL-token throughput both ways. Prints the JSON line and returns
    it as a dict."""
    import paddle_tpu_torch as fluid
    from .. import profiler
    from .common import place

    packed, base, real_packed, real_base, docs = packed_data(BATCH, SEQ,
                                                             VOCAB)
    nb = base["ids"].shape[0]
    warm_rounds = -(-WARMUP // ITERS) if WARMUP > 0 else 0
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(place())
        prog_b, startup_b, loss_b = _build_lm(nb, SEQ, packed_rows=False)
        exe.run(startup_b)
        dt_base, _ = _measure_rounds(exe, prog_b, loss_b,
                                     _on_device(base, exe), ITERS,
                                     warm_rounds, ROUNDS)
        # the baseline's captured step holds a private memory pool:
        # release it before the packed program captures its own
        exe.close()
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(place())
        prog_p, startup_p, loss_p = _build_lm(BATCH, SEQ, packed_rows=True)
        exe.run(startup_p)
        dt_packed, lv = _measure_rounds(exe, prog_p, loss_p,
                                        _on_device(packed, exe), ITERS,
                                        warm_rounds, ROUNDS)
        exe.close()

    # the dense-mask bytes a non-segment packed implementation would
    # have streamed: one int8 [SEQ, SEQ] mask per row per attention
    # layer per step (timed steps only)
    mask_bytes = BATCH * SEQ * SEQ * LAYERS * ITERS * ROUNDS
    profiler.incr_counter("attention_mask_bytes_avoided_total",
                          float(mask_bytes))
    profiler.incr_counter("packed_segments_total", float(len(docs)))

    packed_tok_s = real_packed * ITERS / dt_packed
    base_tok_s = real_base * ITERS / dt_base
    rec = {
        "metric": METRIC,
        "value": round(packed_tok_s, 0),
        "unit": UNIT,
        "config": "%dL-%dd-%dh seq=%d rows=%d bf16 PACKED segment-attn"
                  % (LAYERS, D_MODEL, HEADS, SEQ, BATCH),
        "packed": True,
        "padded_baseline_tok_s": round(base_tok_s, 0),
        "speedup_vs_padded_ragged": round(packed_tok_s / base_tok_s, 3)
        if base_tok_s else None,
        "real_tokens_packed": real_packed,
        "real_tokens_baseline": real_base,
        "pack_occupancy": round(real_packed / float(BATCH * SEQ), 4),
        "pad_waste_baseline":
            round(1.0 - real_base / float(nb * SEQ), 4),
        "baseline_rows": nb,
        "mask_bytes_avoided": mask_bytes,
        "docs": len(docs),
    }
    print(json.dumps(rec))
    rec["_round_s"] = {"baseline": dt_base, "packed": dt_packed}
    rec["_loss"] = float(lv.numpy()[0].ravel()[0])
    return rec


def main():
    """The dense LM step's rounds; prints the JSON line and returns it as
    a dict."""
    if PACKED:
        return packed_main()
    import paddle_tpu_torch as fluid
    from ..flops import device_peak_flops, estimate_program_flops
    from .common import place, telemetry_report

    prog, startup, loss = _build_lm(BATCH, SEQ, valid=False)
    step_flops = estimate_program_flops(prog, BATCH, training=True)
    feed = dense_data(BATCH, SEQ, VOCAB)

    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(place())
        exe.run(startup)
        # WARMUP counts steps, rounded up to whole ITERS-step dispatches
        # (the same captured step as the timed rounds)
        warm_rounds = -(-WARMUP // ITERS) if WARMUP > 0 else 0
        dt, lv = _measure_rounds(exe, prog, loss, _on_device(feed, exe),
                                 ITERS, warm_rounds, ROUNDS)
        exe.close()

    tok_per_sec = BATCH * SEQ * ITERS / dt
    peak = device_peak_flops() if exe.device.type == "cuda" else None
    tel = telemetry_report()
    rec = {
        "metric": METRIC,
        "value": round(tok_per_sec, 0),
        "unit": UNIT,
        "config": "%dL-%dd-%dh seq=%d bs=%d bf16 flash-attn"
                  % (LAYERS, D_MODEL, HEADS, SEQ, BATCH),
        "mfu": round(step_flops * ITERS / dt / peak, 4) if peak else None,
        "loss": round(float(lv.numpy()[0].ravel()[0]), 3),
        # a healthy run shows misses == distinct shapes, not per-round
        "steps": tel.get("steps"),
        "compile_cache_misses": tel.get("compile_cache_misses"),
        "device_wait_s": round(tel.get("device_wait_s", 0.0), 4),
    }
    print(json.dumps(rec))
    rec["_round_s"] = dt
    rec["_step_flops"] = step_flops
    return rec


if __name__ == "__main__":
    from .common import run_guarded
    run_guarded(main, METRIC, UNIT)
