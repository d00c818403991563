"""Seq2seq NMT training target tokens/s on one card — the port of
``bench_nmt.py``: the same program (``seq2seq_net`` with embedding,
encoder and decoder 512 wide, source and target vocabulary 30000, bf16
mixed precision, ``Adam(1e-3)``, the fused ``softmax_with_cross_entropy``
summed per sequence), the same synthetic ragged pairs and seeds, the
same two schedules, the same environment knobs and the same JSON keys.

    python -m paddle_tpu_torch.benchmarks.nmt

- ``baseline``: unsorted batches padded to the global max length, one
  shape, ``ITERS`` steps a sweep (``baseline_tok_s``);
- ``pooled``: ``data.decorator.pool_batch_by_length`` batches (a sorted
  pool of ``POOL_FACTOR`` batches, each batch's max length snapped to a
  ``POOL_BUCKET`` grid), one ``run_steps`` dispatch per distinct padded
  shape (``value``).

Each dispatch is ``Executor.run_steps(return_numpy=False)``: on the card
one captured CUDA graph per padded shape, replayed. The sweeps run under
``robustness.train_loop`` (a SIGTERM checkpoints when
``FLAGS_checkpoint_dir`` is set and exits 42); warm sweeps sync only on
the last, each timed sweep once, through its last ``FetchHandle``.

Knobs (environment): BENCH_BATCH (64), BENCH_SEQ (40), BENCH_WARMUP
(steps, rounded up to whole sweeps; 2), BENCH_ITERS (200), BENCH_ROUNDS
(3), BENCH_VOCAB (30000), BENCH_POOL_FACTOR (16), BENCH_POOL_BUCKET (8).
``BENCH_FORCE_CPU=1`` runs on the CPU; without it a machine with no card
gets the failure JSON line and exit 1.
"""

import json
import os
import statistics
import time

import numpy as np

METRIC = "seq2seq_nmt_train_target_tokens_per_sec_per_chip"
UNIT = "tokens/sec"
BATCH = int(os.environ.get("BENCH_BATCH", 64))
SEQ = int(os.environ.get("BENCH_SEQ", 40))
WARMUP = int(os.environ.get("BENCH_WARMUP", 2))
ITERS = int(os.environ.get("BENCH_ITERS", 200))
ROUNDS = int(os.environ.get("BENCH_ROUNDS", 3))
SRC_VOCAB = TRG_VOCAB = int(os.environ.get("BENCH_VOCAB", 30000))
POOL_FACTOR = int(os.environ.get("BENCH_POOL_FACTOR", 16))
POOL_BUCKET = int(os.environ.get("BENCH_POOL_BUCKET", 8))
# the model's widths (bench_nmt.py's, fixed there too)
EMB = HID = 512


def nmt_step_flops(src_tokens, trg_tokens, n_seqs,
                   emb=512, hid=512, vocab=None):
    """Analytic model FLOPs of one training step of ``seq2seq_net``:
    matmul-class terms only, 2 FLOPs a MAC, counted on real tokens, the
    forward x3 for training. Encoder, per source token: both directions'
    emb→4H fcs and recurrent H→4H GEMMs, the 2H→H projection. Decoder,
    per target token: the emb→4H fc, the recurrent GEMM, the H→V
    projection. Per sequence: the H→H decoder-boot fc."""
    v = vocab or TRG_VOCAB
    enc_tok = 2 * (2 * emb * 4 * hid)    # fc_fwd + fc_bwd
    enc_tok += 2 * (2 * hid * 4 * hid)   # fwd + bwd LSTM recurrent GEMMs
    enc_tok += 2 * (2 * hid) * hid       # bidirect concat → H fc
    dec_tok = 2 * emb * 4 * hid          # dec_in fc
    dec_tok += 2 * hid * 4 * hid         # decoder LSTM recurrent GEMM
    dec_tok += 2 * hid * v               # vocab projection
    per_seq = 2 * hid * hid              # dec_h0 boot fc
    fwd = (src_tokens * enc_tok + trg_tokens * dec_tok
           + n_seqs * per_seq)
    return 3 * fwd


def synthetic_samples(n, seq, vocab, seed=0):
    """n (src, trg) ragged pairs with correlated lengths: src uniform in
    [seq/2, seq), trg = src ± 20% jitter."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ls = int(rng.randint(seq // 2, seq))
        lt = int(np.clip(ls + rng.randint(-seq // 10, seq // 10 + 1),
                         2, seq - 1))
        out.append((rng.randint(1, vocab, size=ls).astype(np.int32),
                    rng.randint(1, vocab, size=lt).astype(np.int32)))
    return out


def make_feed(pairs, max_len=None, pad_to_multiple=None):
    """(src, trg) pairs → the program's feed of host ``LoDArray``s; the
    next-word targets are the decoder input shifted by one token (0 at
    the end)."""
    from ..core import LoDArray
    srcs = [p[0] for p in pairs]
    trgs = [p[1] for p in pairs]
    nexts = [np.concatenate([s[1:], [0]]).astype(np.int32) for s in trgs]
    kw = dict(dtype=np.int32, max_len=max_len,
              pad_to_multiple=pad_to_multiple)
    return {
        "src_word_id": LoDArray.from_sequences(srcs, **kw),
        "target_language_word": LoDArray.from_sequences(trgs, **kw),
        "target_language_next_word": LoDArray.from_sequences(nexts, **kw),
    }


def build_program(batch=None, seq=None, vocab=None, emb=None, hid=None,
                  amp=True):
    """The measured program and its feed: (prog, startup, loss, feed,
    src_tokens, trg_tokens). ``emb``/``hid`` default to the bench's 512
    (narrower only for tests); ``amp``: bf16 mixed precision."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import models

    batch = batch or BATCH
    seq = seq or SEQ
    vocab = vocab or TRG_VOCAB
    emb = emb or EMB
    hid = hid or HID
    prog = fluid.Program()
    startup = fluid.Program()
    with fluid.program_guard(prog, startup):
        src = fluid.layers.data(name="src_word_id", shape=[1],
                                dtype="int64", lod_level=1)
        trg = fluid.layers.data(name="target_language_word", shape=[1],
                                dtype="int64", lod_level=1)
        lbl = fluid.layers.data(name="target_language_next_word", shape=[1],
                                dtype="int64", lod_level=1)
        logits = models.seq2seq_net(src, trg, vocab, vocab,
                                    embedding_dim=emb, encoder_size=hid,
                                    decoder_size=hid, with_softmax=False)
        # the fused logits-level loss: no [tokens, vocab] probabilities
        cost = fluid.layers.softmax_with_cross_entropy(logits, lbl)
        loss = fluid.layers.mean(fluid.layers.sequence_pool(cost, "sum"))
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    fluid.enable_mixed_precision(prog, amp)

    pairs = synthetic_samples(batch, seq, vocab, seed=0)
    feed = make_feed(pairs, max_len=seq)
    trg_tokens = int(sum(len(p[1]) for p in pairs))
    src_tokens = int(sum(len(p[0]) for p in pairs))
    return prog, startup, loss, feed, src_tokens, trg_tokens


def _feed_tokens(feed):
    src = int(np.sum(np.asarray(feed["src_word_id"].length)))
    trg = int(np.sum(np.asarray(feed["target_language_word"].length)))
    return src, trg


def pooled_schedule(samples, batch=None, pool_factor=None, bucket=None):
    """The pooled path's schedule: length-pooled batches of ``samples``
    grouped by padded (src, trg) shape, each group one dispatch of its
    first batch's feed for the group's step count. [(feed, n_steps,
    src_tokens, trg_tokens)] in shape order, and the batches."""
    from ..data import decorator as D
    batch = batch or BATCH
    pool_factor = pool_factor or POOL_FACTOR
    bucket = bucket or POOL_BUCKET
    key = lambda s: len(s[0]) + len(s[1])       # noqa: E731
    batches = list(D.pool_batch_by_length(
        lambda: iter(samples), batch, pool_factor=pool_factor, key=key,
        shuffle_batches=False, drop_last=True)())
    groups = {}  # (src_pad, trg_pad) → [batch, ...]
    for b in batches:
        sp = D.snap_length(max(len(s[0]) for s in b), bucket)
        tp = D.snap_length(max(len(s[1]) for s in b), bucket)
        groups.setdefault((sp, tp), []).append(b)
    schedule = []
    for (sp, tp), bs in sorted(groups.items()):
        feed = make_feed(bs[0], max_len=None, pad_to_multiple=bucket)
        s_tok, t_tok = _feed_tokens(feed)
        schedule.append((feed, len(bs), s_tok, t_tok))
    return schedule, batches


def _measure_schedule(exe, prog, loss, schedule):
    """Run a [(feed, n_steps)] schedule: warm sweeps (WARMUP steps
    rounded up to whole sweeps) capture and warm each padded shape, then
    ROUNDS timed sweeps, each synced once through its last fetch handle.
    The pipeline counters are reset after the warm-up, so the telemetry
    covers the timed sweeps only. Returns (median sweep seconds, [sweep
    seconds], telemetry, [last handle of each sweep])."""
    from .. import profiler, robustness
    from .common import telemetry_report
    sweep_steps = sum(n for _, n in schedule)
    warm_sweeps = -(-WARMUP // sweep_steps) if WARMUP > 0 else 0
    dts, handles = [], []

    def sweep(i):
        if i == warm_sweeps:
            profiler.reset_counters()
            profiler.reset_histograms()
        t0 = time.perf_counter()
        h = None
        for feed, n in schedule:
            h = exe.run_steps(prog, feed=feed, n_steps=n,
                              fetch_list=[loss], return_numpy=False)
        if i < warm_sweeps:
            if i == warm_sweeps - 1:
                h.numpy()
        else:
            h.numpy()   # the sweep's one sync → device_wait_s
            dts.append(time.perf_counter() - t0)
        handles.append(h)
        return h

    # resume=False: a sweep index is not a resumable trajectory position
    robustness.train_loop(
        sweep, warm_sweeps + ROUNDS, program=prog, executor=exe,
        checkpoint=robustness.CheckpointManager.from_flags(),
        resume=False)
    return statistics.median(dts), dts, telemetry_report(), handles


def main():
    """Both schedules on one executor; prints the JSON line and returns
    it as a dict (with the sweeps' seconds and last handles under
    ``_``-keys)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.data import decorator as D
    from ..flops import device_peak_flops
    from .common import place

    prog, startup, loss, base_feed, src_tokens, trg_tokens = build_program()

    samples = synthetic_samples(BATCH * ITERS, SEQ, TRG_VOCAB, seed=1)
    schedule, pooled_batches = pooled_schedule(samples)
    pad_waste_base = D.pad_waste_fraction(
        [b for b in D.batch(lambda: iter(samples), BATCH,
                            drop_last=True)()],
        key=lambda s: len(s[1]), bucket_multiple=SEQ)  # pad to global max
    pad_waste_pooled = D.pad_waste_fraction(
        pooled_batches, key=lambda s: len(s[1]),
        bucket_multiple=POOL_BUCKET)
    # the same target stream segment-packed into [4·SEQ] rows: the
    # residual waste a packed path would pay instead
    trg_seqs = [s[1] for s in samples]
    packed_rows = D.pack_segments(trg_seqs, 4 * SEQ)
    packed_real = sum(len(s) for s in trg_seqs)
    pad_waste_packed = 1.0 - packed_real / float(4 * SEQ *
                                                 len(packed_rows))

    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(place())
        exe.run(startup)
        base_dt, base_dts, base_counters, base_h = _measure_schedule(
            exe, prog, loss, [(base_feed, ITERS)])
        pooled_dt, pooled_dts, counters, pooled_h = _measure_schedule(
            exe, prog, loss, [(feed, n) for feed, n, _, _ in schedule])
        exe.close()

    base_tok_s = trg_tokens * ITERS / base_dt
    pooled_trg = sum(n * t for _, n, _, t in schedule)
    pooled_src = sum(n * s for _, n, s, _ in schedule)
    pooled_steps = sum(n for _, n, _, _ in schedule)
    pooled_tok_s = pooled_trg / pooled_dt
    rates = sorted(pooled_trg / dt for dt in pooled_dts)
    peak = device_peak_flops() if exe.device.type == "cuda" else None
    pooled_flops = nmt_step_flops(pooled_src, pooled_trg,
                                  BATCH * pooled_steps)
    rec = {
        "metric": METRIC,
        "value": round(pooled_tok_s, 1),
        "unit": UNIT,
        "vs_baseline": None,
        "baseline_tok_s": round(base_tok_s, 1),
        "speedup_vs_padded_unsorted": round(pooled_tok_s / base_tok_s, 3)
        if base_tok_s else None,
        "mfu": round(pooled_flops / pooled_dt / peak, 4) if peak else None,
        "pad_waste_pooled": round(pad_waste_pooled, 4),
        "pad_waste_baseline": round(pad_waste_base, 4),
        "pad_waste_packed": round(pad_waste_packed, 4),
        "packed_rows": len(packed_rows),
        "packed_mask_bytes_per_layer_step":
            len(packed_rows) * (4 * SEQ) ** 2,
        "distinct_padded_shapes": len(schedule),
        "pooled_steps": pooled_steps,
        "feed_wait_s": round(counters.get("feed_wait_s", 0.0), 4),
        "device_wait_s": round(counters.get("device_wait_s", 0.0), 4),
        "baseline_feed_wait_s":
            round(base_counters.get("feed_wait_s", 0.0), 4),
        "baseline_device_wait_s":
            round(base_counters.get("device_wait_s", 0.0), 4),
        "pooled_compile_cache_misses":
            counters.get("compile_cache_misses", 0.0),
        "batch": BATCH,
        "max_seq": SEQ,
        "iters": ITERS,
        "rounds": ROUNDS,
        "pool_factor": POOL_FACTOR,
        "pool_bucket": POOL_BUCKET,
        "spread_tok_s": [round(rates[0], 1), round(rates[-1], 1)],
    }
    print(json.dumps(rec))
    rec.update({"_sweep_s": {"baseline": base_dts, "pooled": pooled_dts},
                "_handles": {"baseline": base_h, "pooled": pooled_h},
                "_telemetry": {"baseline": base_counters,
                               "pooled": counters},
                "_shapes": [(f["src_word_id"].max_len,
                             f["target_language_word"].max_len, n)
                            for f, n, _, _ in schedule]})
    return rec


if __name__ == "__main__":
    from .common import run_guarded
    run_guarded(main, METRIC, UNIT, extra={"batch": BATCH, "max_seq": SEQ})
