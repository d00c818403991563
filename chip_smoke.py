#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``paddle_tpu_torch``).

    python3 chip_smoke.py [--out REPORT.json] [--kernels-only]
    python3 chip_smoke.py --resume-child CHECKPOINT_DIR OUT_NPZ [...]

Run from the root of a checkout on a machine with one NVIDIA GPU (built
for the H100: the kernels compile for sm_90a). Phases, each of which
raises on failure (the script then exits non-zero and prints no result):

1. Card: require CUDA; print ``nvidia-smi`` name and power limit.
2. Build: compile every kernel of every slice from
   ``paddle_tpu_torch/csrc`` (one nvcc per source, in parallel); no
   tensor-core body (the forward of K1, K1-dense, K5, K6 and
   K6-fwd-dense, the backward of K2, K5 and K6, at head_dim 32, 64 and
   128) may spill
   (ptxas -v). Every
   flash kernel's reported shared memory at head_dim 32-256 in fp32 and
   bf16 is logged, and must belong to the body it launches: a kernel
   that runs a CUDA-core body under bf16 reports its fp32 bytes, one
   that runs a tensor-core body other bytes (``smem_gate``).
3. Kernels against their plain versions on the card. K3 in fp32 and
   bf16, at the serving geometry, the reference's tuning grid and a wide
   table (4 slots of 256 pages: 8 splits a slot, 32 on one-byte pools),
   lengths 0, 1, a mid-page frontier and the full window, then the split
   edges (a split's tokens - 1, them, + 1, and one token short of the
   full table). K3-quant (the same kernel on int8/fp8 pools with per-(page,
   group, kv-head) scales): int8 and fp8, fp32 and bf16 q, one scale
   group per page and groups of 4, h = hkv and GQA, both length lists,
   at the serving geometry (32 slots over the quantized engine's
   4097-page pool), small pools and the wide table.
   ``paged_quant_append`` on the card must equal the CPU bit for bit on
   every page but scratch (int8/fp8, both group sizes). K1, K2-dQ and
   K2-dKV (flash attention) in fp32 and bf16, causal and not, h = hkv
   and h = 2 hkv, without a mask and with a factored padding mask (a
   padded tail and a fully padded row), s in {256, 1024, 300, 130}, d in
   {64, 128, 96, 36, 32}, a 71-head group on one kv head, and at the
   training step's shape (b16 s1024 h8 d64 bf16 causal): o, lse, dq, dk and dv
   elementwise. bf16 K1 and K2 run on the tensor cores (d 96 puts zero
   columns inside their 16-wide steps, d 36 rows take their element-copy
   staging); fp32 K1 and K2 on the CUDA cores.
   Then K5-fwd, K5-dQ and K5-dKV (packed-segment flash attention) over
   the same geometries, dtypes and causal settings under four segment
   maps (random documents, one segment — which must also equal K1/K2 —,
   many 1-8-token segments, boundaries on and one off the kernels' 64-wide
   tiles), and at the packed step's own shape and map (bf16 K5-fwd,
   K5-dQ and K5-dKV on the tensor cores). K6-fwd, K6-dQ
   and K6-dKV (the per-head [b, h, s, d] layout) without a mask and with
   a factored padding mask, K6-fwd under dense [1|b, 1|h, s, s] masks
   and K1-dense under dense [1|b, 1, s, s] masks (each with one fully
   masked query row), fp32 and bf16 (K6 rounds P and dS to bf16 there,
   as the TPU's K6 and the plain version do), causal and not, h8/hkv8
   and h8/hkv2, s in {256, 1000, 1024}, d in {64, 128}, and s 300 d 32
   h8/hkv2 (bf16 K6-fwd, K6-fwd-dense, K6-dQ and K6-dKV and bf16
   K1-dense on the tensor cores; K6 taking P and dS as bf16 from S and
   dP summed in fp64; s 1000 and 300 stage the dense masks' rows byte
   by byte). K4 (fused
   Adam)
   on tensors of 1, 1023 and 71,153,920 elements in one call, with and
   without global-norm clipping and a loss scale: within 2 ulp.
4. Serving path: the 4-layer, 512-wide decoder (vocab 32000, 8 heads) in
   fp32 and in bf16 with the same random weights, written with
   ``save_decoder`` and served by ``load_decoder`` → ``PagedDecodeEngine``
   → ``GenerationScheduler`` → ``make_server`` on 127.0.0.1. Eight
   clients send six concurrent greedy ``/v1/generate`` requests each
   (48 in flight > 32 slots). fp32 streams must be token-identical to
   ``full_recompute_generate`` on the card; bf16 responses must be well
   formed and the bf16 first-step logits must match the fp32 twin's.
   The K3 launch count must equal decode steps × layers. Prints TTFT
   p50/p99 and decode tokens/s. Then three quantized runs of the same
   requests: the bf16 decoder with int8 KV pages, with fp8 KV pages, and
   the bf16 decoder written through ``quantize_decoder_dir(mode="int8")``
   with int8 KV pages (the pool auto-sized to 4096 pages). Each must
   launch K3-quant decode steps × layers times and K3 never, answer
   well formed, and give prefill logits of 8 prompts within rel L2 0.1
   of the unquantized bf16 engine's; each prints the greedy token match
   against the bf16 run beside the reference's 0.95 guard (recorded, not
   held), TTFT, decode tokens/s and pages. Then what the quantized pages
   buy, admission at equal pool bytes: on 64 slots, 96 requests whose
   worst case is the whole max_len each, served once with bf16 pages over
   the bf16 run's 2048 pages and once with int8 pages over as many pages
   as those bytes hold (4080); the int8 pool may take no more bytes, and
   the most sequences decoding at once must be at least 1.9x bf16's.
   Then, outside the served
   window, a decode-step profile with all 32 slots busy, and K3 at that
   step's layer-0 inputs: held against the plain version (it fails past
   the stated tolerance) and timed beside its bound, the plain version
   and ``F.scaled_dot_product_attention`` over the same tokens (a
   yardstick only: the port never calls it); then the same for K3-quant
   on the int8 engine (SDPA over the tokens pre-dequantized to bf16),
   and K3-quant held against its plain version at the fp8 engine's own
   decode-step inputs. Then K3 at long contexts (4 slots x 4096 tokens,
   where the split across blocks matters most), checked and timed beside
   SDPA over the same tokens: logged, not a row of the kernels line.
5. Training gate, fp32 with TF32 off: a 2-layer transformer LM at full
   width (512d, 8 heads, vocab 32000), batch 2, seq 512, from one
   initial state, 3 Adam steps through ``Executor.run`` on the card
   (kernels) and on the CPU (plain versions); losses and the first
   attention projection's weights must agree. Then captures under the
   cyclic garbage collector (``capture_gc_gate``): CGC_DEAD executors
   whose captured 1-layer LM steps (K4's pinned table in each) were
   never closed become cycles as the capture of another step opens, the
   collector due at every allocation until it ends; the captures must
   end, no collection may start inside one (``launch_count.Capture``
   holds it off) and the dead executors must be collected after.
6. Training path: ``bench_lm.py``'s step at full size — ``transformer_lm``
   12 layers, 512d, 8 heads, vocab 32000, batch 16, seq 1024, bf16 mixed
   precision, ``Adam(1e-4)`` — built with the layers DSL, startup on the
   card, then 10 steps through ``Executor.run``: the loss must be finite
   and lower at the last step than the first, and K1, K2-dQ and K2-dKV
   must each launch steps x 12 times. Prints step ms p50, tokens/s and a
   ``torch.profiler`` breakdown (device-busy ms per step, idle share,
   the shares of K1, K2 and the GEMMs; the flash kernels it saw, which
   must be exactly the bshd tensor-core bodies ``flash_fwd_mma_kernel``
   and ``flash_bwd_*_mma_kernel``). Then K1, K2-dQ and K2-dKV at the step's
   attention shape, L2 flushed before each call: each kernel beside its
   bound, its plain version, the library yardstick
   (``F.scaled_dot_product_attention`` forward for K1, its autograd
   backward for K2) and its max |err| against the plain version.
7. Packed path: ``bench_lm.py BENCH_PACKED=1``'s step — the same model
   on 16 rows x 1024 packed with ``data.decorator.pack_segments`` from
   its seeded documents (labels from ``packed_next_token_labels``, ids
   from ``transformer_lm(segment_ids=...)``) — 10 steps: loss finite and
   falling, K5-fwd, K5-dQ and K5-dKV each steps x 12 launches and K1/K2
   none; a profile whose flash kernels must be exactly the tensor-core
   K5 forward and backward (``PACKED_BODIES``). Then the
   padded baseline (the same documents one per row under a ``valid``
   mask, through K1/K2) for a few steps. Prints real tokens/s
   both ways, ``speedup_vs_padded_ragged``, ``pack_occupancy``,
   ``pad_waste_baseline`` and a profile (device-busy ms, idle share, the
   K5 share). Then K5 x3 at the packed step's shape beside their bounds
   (visible pairs only), plain versions and SDPA under the dense mask.
8. ``FusedAdamOptimizer``: the packed program with one ``fused_adam`` op.
   One step from phase 7's state and feed must match one ``Adam`` step
   within 2 ulp in every parameter and moment; then 10 steps with K4
   launched once each. Prints step ms p50 beside phase 7's and the host
   ms of the ``adam`` ops against the ``fused_adam`` op. Then K4 at the
   LM's 71,153,920 parameters beside its bound, its plain version and
   ``torch._fused_adam_``.
9. Per-head (bhsd) path: ``build_lm_layout(fluid, "bhsd", "none")`` —
   the LM of phase 6 with each layer's attention through ``transpose``
   to [b, h, s, d] and ``fused_attention`` at its default layout. First
   the layout-parity gate (fp32, TF32 off, 2 layers, full width, one
   state and feed): its loss and phase 6's program's within 1e-5
   relative, the layer-0 query projection's 3-step update within 1e-3.
   Then 10 steps at full size: loss finite and falling, K6-fwd, K6-dQ
   and K6-dKV each steps x 12 launches and no other flash kernel; a
   profile, whose flash kernels must be exactly K6's tensor-core bodies
   (``flash_fwd_mma_kernel<..., 0, true>``,
   ``flash_bwd_*_mma_kernel<..., 0, true>``: ``BHSD_BODIES``); steps in
   turns with phase 6's program (``step_ratio_vs_bshd``).
10. Dense-mask path: the prefix-LM mask (``prefix_mask``: [16, 1, 1024,
   1024] bool, row b sees keys j <= i or j < p_b, p_b in [128, 896];
   not causal). First fp32 gates (2 layers, full width): program 2 (bhsd)
   and program 3 (bshd) each card against CPU, and their first-step
   losses within 1e-5 of each other. Then 3 steps of each at full size:
   loss finite and falling; program 2 launches K6-fwd-dense steps x 12,
   program 3 K1-dense steps x 12, and no other flash kernel (the
   backward recomputes through the plain composition); each program's
   profile must show exactly its forward body (``DENSE_BODIES``: the
   tensor-core ``flash_fwd_mma_kernel<..., 2, false>`` for K1-dense and
   ``flash_fwd_mma_kernel<..., 2, true>`` for K6-fwd-dense). Then
   K6-fwd,
   K6-dQ, K6-dKV at phase 9's attention shape and K6-fwd-dense, K1-dense
   at phase 10's, each beside its bound, its plain version and SDPA.
11. ResNet training: ``bench.py``'s program (``resnet_imagenet(depth=50)``
   in NHWC, ``cross_entropy``, ``mean``, ``Momentum(0.01, 0.9)``). No TPU
   kernel lies on this path: its convolutions are cuDNN's. First the
   path's ops (``conv2d`` and its analytic grad at the stem's, a 3x3's
   and a strided 1x1's geometry, ``pool2d``, ``batch_norm``, ``relu``,
   ``softmax``, ``cross_entropy``, ``momentum``) card against CPU in fp32
   with TF32 off (1e-5 relative L2) and the convolutions in bf16. Then
   the fp32 card-vs-CPU gate (TF32 off; class_dim 10, batch 8, 64x64
   images, one startup state): 3 steps, each from the CPU run's state
   before it, losses and every persistable's update within
   ``RGATE_LOSS_RTOL`` / ``RGATE_UPDATE_REL_L2``. Then ``run_steps``
   against ``run`` on the card (the same model, fp32,
   ``cudnn.deterministic``): 4 ``run()`` calls, ``run_steps(n_steps=4)``
   and ``run_steps(n_steps=4)`` again must leave every persistable and
   the last loss bitwise equal to 12 ``run()`` calls, with 1 capture and
   7 replays; then a ``run()`` and ``run_steps`` on another feed (the
   replays load both) bitwise equal to as many ``run()`` calls. Then ``bench.py``'s configuration at full size (batch 256,
   224x224, 1000 classes, bf16 mixed precision; the feed from
   ``RandomState(0)`` on the card): eager ``run()`` steps and a profiled
   window, then one warm-up dispatch and ``RESNET_ROUNDS`` timed rounds of
   ``run_steps(n_steps=RESNET_STEPS)`` (bench.py: 100 x 3) and a profiled
   replay. Gates: the loss finite and lower after the rounds than at the
   first step; no launch of any of the 14 kernel entry points or the
   megastep loop; one capture. Prints images/s (median round), the captured step's ms, MFU
   (``flops.estimate_program_flops`` over ``flops.device_peak_flops``),
   device-busy ms and idle share of an eager and of a captured step, the
   eager step's p50, peak memory and the top device operations.
12. Megastep serving, run right after phase 4 (its decoder files, K = 1
   streams and decode-step profiles): ``megastep_k`` 8, the reference's
   auto value at max_len 1024, on fp32, bf16, int8 and fp8 pages. For
   each pool dtype: first the engine gate (``megastep_engine_gate``: 32
   busy slots, a greedy and a mixed temperature cohort, megasteps of 8,
   8 chained and 3 trips against 19 eager ``decode_step`` calls on a
   twin engine: every stream token-identical, one capture and one
   warm-up trip per variant, one launch of the loop graph (the captured
   trip in a conditional WHILE node, ``csrc/megastep_loop.cu``) per
   megastep and its body iterations equal to the trips, K3 (K3-quant)
   launched layers x (steps + trips run + warm-up trips)); then phase 4's
   48 requests served through phase 4's entry points with ``megastep_k``
   8 (the engine ``serve --gen-megastep-k 8`` builds): fp32 streams
   token-identical to full recompute and to phase 4's K = 1 run (48 of
   48; the other dtypes' matches printed), one greedy capture, one loop
   launch a megastep, iterations = the trips of the synced megasteps, the
   path's kernel launched layers x (trips run + warm-up trips + eager
   steps). Prints TTFT p50/p99, TPOT, decode
   tokens/s, megasteps, the trips histogram, host gap a token and the
   capture and replay counts beside phase 4's K = 1 run; then
   ``megastep_profile`` on the served engine at 32 busy slots: wall ms a
   trip (megasteps synced one by one, and chained), the loop's device ms
   a trip (CUDA events), the device-busy ms a trip and K3's ms a trip
   from the captured trip replayed alone under ``torch.profiler``, the
   idle share, and the pool's K3 instance launched layers x trips times
   (the kernel's own count on the card), beside phase 4's decode-step
   profile. (d) The early exit (``megastep_exit_gate``), bf16 and int8
   pages: a K = 8 megastep whose 32 slots all freeze after 2 trips, by
   caps 2 and, separately, by an EOS (every slot on one prompt whose
   stream's second token is the EOS): the loop's iteration count equals
   ``trips`` (2), the kernel's own count shows exactly layers x 2 K3
   (K3-quant) launches, the streams equal the K = 1 decode steps';
   prints the loop's device ms against a full 8-trip megastep's. Then the loop's row of the kernels line
   (``megastep_loop_row``): one launch of the loop graph against its plain
   version (the eager trip, the condition read on the host) on the same
   inputs, the whole state vector equal, beside the bytes a megastep must
   move once.
14. Speculative decoding, tenants and shedding, run right after phase 12
   (phase 4's decoder files, requests, K = 1 streams and full recompute;
   phase 12's K = 8 run beside it). (a) ``spec_engine_gate``:
   ``speculative_greedy_generate`` over 32 prompts x 48 tokens on the fp32
   and bf16 targets (and bf16 with int8 pages at k 4), with the target as
   its own draft and a 2-layer full-width draft from seed 1, at k 1 and
   4, against ``greedy_generate`` on the paged engine alone: K3 (K3-quant)
   launched exactly layers x the synced fallback steps (the verify and the
   dense draft launch none); fp32 streams token-identical, and the self
   draft's accepted = drafted less the drafts its streams' last, budget-
   truncated rounds drop (read from the catalog's counters); the bf16 and
   int8 matches printed. (b) Phase 4's 48 requests served through the
   engines ``serve --gen-draft-model DRAFT --gen-speculative-k 4`` builds,
   fp32, with the 2-layer draft and with the target as its own draft (some
   drafts accepted), then through the dense ``DecodeEngine`` ``serve``
   builds by default (K3 launched never): 48 of 48 equal full recompute in
   each; drafted, accepted, fallback reasons, TTFT, TPOT and tokens/s
   printed beside phase 4's K = 1 and phase 12's K = 8. (c) The requests at ``megastep_k`` 8 with every other one
   from tenant ``capped`` (16 tokens a 0.25 s window): a budget preemption
   to the held lane at least once, every stream equal to full recompute, a
   resumed prefill mapping a parked page. (d) Every other request
   ``"priority": "low"``, sent behind the high half under watermarks 0.05 /
   0.02: no high request fails and each equals full recompute (its first
   ``FLAGS_shed_token_cap`` tokens where level 2 clamped it), each low one
   does so or is answered 503 with Retry-After, at least one is shed, and
   ``requests_shed_total{class="low"}`` equals the 503s. Phases 4 and 12
   (``serve_run``) keep the shed ladder at level 0.

13. LM training as ``bench_lm.py`` runs it, through the captured step
   (run after phase 10; phases 8-10 end in its captured rounds).
   First the equivalence gates (fp32, TF32 off, deterministic
   algorithms, the 2-layer LM at full width, batch 2, seq 512, one
   state): 4 ``run()`` calls, then ``run_steps(4)`` twice, bitwise 12
   ``run()`` calls in every persistable and both losses, 1 capture and 7
   replays, K1/K2-dQ/K2-dKV launched 12 x 2 each counted through the
   replays; the same on packed rows with K5 x3 and no K1/K2. Then random
   ops under capture (``build_dropout``: dropout 0.5 and Adam):
   ``run_steps(8)`` bitwise 8 ``run()`` calls, two further rounds draw
   different masks, each keeping a share within 4 sigma of 0.5. Then
   ``bench_lm.py``'s rounds at full size through
   ``paddle_tpu_torch.benchmarks.lm`` (``main()``, then ``packed_main()``
   with its padded baseline; 5-step rounds (bench_lm.py: 60), one warm,
   2 timed (bench_lm.py: 3); the JSON line printed): the loss finite and falling from the
   first round to the last, ``compile_cache_misses`` = the (program, feed) pairs, the
   path's flash kernels launched steps x 12, one capture a program;
   printed beside phase 6's and 7's eager p50: the captured step's ms,
   the busy ms and idle share of a profiled replay, ``device_wait_s``,
   MFU and peak memory. Then preemption and resume (``resume_gate``):
   child processes (``--resume-child``) train the 2-layer LM under
   ``robustness.train_loop`` with a checkpoint every 10-step round; one
   SIGTERMs itself after round 2 of 3 and must exit 42 leaving a valid
   serial of step 2 and step counter 21; its relaunch must resume there
   and end bitwise an uninterrupted child. Phases 8, 9 and 10 each end in their
   program's 5-step captured rounds (``captured_rounds``: a warm round
   and 2 timed; K4 steps x 1 and K5 x3 steps x 12, K6 x3, K6-fwd-dense,
   K1-dense steps x 12, counted through the replays; one capture), timed
   beside their eager p50 with a profiled replay's busy ms and idle
   share. The kernels line counts these launches too.

15. Seq2seq NMT training as ``bench_nmt.py`` runs it (run after phase
   11; no hand-written kernel is on its path, and none may launch in the
   phase). (a) Gates: the ``lstm`` op forward and its generic grad at the
   bench's width (b64 t40 h512; peepholes, reverse, H0/C0), card against
   CPU in fp32 within 1e-5 rel L2 (``lstm_op_checks``); the bench's
   program at batch 8, max length 16, two steps each on both devices from
   the CPU's state (``nmt_gate``); ``run_steps`` bitwise ``run()`` over a
   switch of padded shapes and back, fp32 and amp, deterministic (2
   captures, 5 replays; ``nmt_replay_gate``). (b) ``bench_nmt.py``'s
   configuration through ``paddle_tpu_torch.benchmarks.nmt.main()``
   (batch 64, max length 40, vocab 30000, 512 wide, bf16, ``Adam(1e-3)``,
   the padded baseline and the length-pooled schedule, sweeps of
   ``NMT_ITERS`` steps (bench_nmt.py: 200), one warm and 3 timed; its JSON line printed), with one capture per
   distinct padded shape, no compile-cache miss in the timed sweeps and
   the loss finite and falling; beside it the captured step ms, the eager
   ``run()`` p50, each schedule's captures and peak memory. (c) One
   profiled replay of the baseline's step: busy ms, idle share, device
   ms by class (``nmt_class``: gemm, elementwise, copy, reduction).

16. ``bench.py``'s ResNet line as it runs by default: fp8-stored relu
   outputs (``PADDLE_TPU_FP8_ACTS=1``, e4m3) and conv outputs
   (``PADDLE_TPU_FP8_CONV_OUT``), through
   ``paddle_tpu_torch.benchmarks.resnet`` (run after phase 15; no
   hand-written kernel is on its path, and none may launch in (a)-(c);
   (d)'s LM bench, a child process, launches K1/K2 in its own process,
   out of this count's sight). (a) Gates, card against CPU (``fp8_gates``): the store cast
   ``registry.cast_fp8`` bit for bit on both formats over a sweep with
   448, 464, 465, 480, 57344, 61440, 1e6 and subnormals (and what the
   card's plain ``Tensor.to`` gives there, recorded); conv2d under modes
   ``1``, ``e5m2``, ``scaled`` and ``delayed`` (seeding and seeded) at
   phase 11's three NHWC geometries — each stored value, dequantized,
   within one fp8 ulp plus one bf16 ulp of the CPU's, and the next
   scale within 1e-2; batch norm from e4m3, e5m2 and ``ScaledFp8``
   input (Y within 1e-2 rel L2); one step of the reference's small conv
   net under each mode with no ``*_grad`` output of an fp8 dtype. (b)
   ``run_steps`` bitwise ``run()`` under the recipe (phase 11's gate
   model, amp, deterministic cuDNN; e5m2 and delayed, the ``Fp8Scale``
   vars included; one capture each). (c) ``benchmarks.resnet.main()`` at
   the default recipe and full size (batch 256, 224x224, NHWC, 1000
   classes, ``BENCH_RESNET_ONLY=1``; phase 11's 5-step rounds x 2
   after one warm dispatch, ``FP8_STEPS``), its JSON line printed: the loss finite and
   lower after the rounds than at the first step, one capture, no
   hand-written kernel, ``precision`` "bf16+fp8-acts+fp8-convout-e5m2";
   printed beside phase 11's bf16 step: images/s, the captured step's
   ms, a profiled replay's busy ms and device ms by class, MFU and peak
   memory. (d) The three-line bench end to end (``python -m
   paddle_tpu_torch.benchmarks.resnet`` at ``bench.py``'s smoke knobs
   ``BENCH_ITERS=2 BENCH_ROUNDS=1 BENCH_WARMUP=1`` (forwarded to the LM
   and NMT benches, its children) and ``BENCH_BATCH=8`` (the ResNet
   line's alone)): exactly three JSON lines, the ResNet line last, its
   ``submetrics.lm`` and ``.nmt`` numeric and without ``error``.

17. Inference deployment (run after phase 16). (a) fp32, TF32 off, for
   bench.py's ResNet-50 (NHWC inside, 224x224, 1000 classes) and the
   stacked-LSTM classifier at ``benchmark/fluid/stacked_dynamic_lstm.py``'s
   widths (dict 5147, emb 128, hid 512, 3 LSTMs, 2 classes, up to 80 ids;
   a ragged int feed), random weights from ``SEED`` (``export_gate``):
   the program pruned, exported with ``io.export_artifact`` at batch 4
   (``torch.export``, the batch dim symbolic) and loaded back; the
   artifact against ``Executor.run`` of the pruned program at batches 1,
   3 and 16 (LSTM lengths 1, 80 and 40-80) within 1e-5 relative L2, and
   against the CPU's run at batch 2 within 1e-4; ``save_inference_model``
   → ``load_inference_model`` → ``run`` bit for bit the program's. (b)
   Each artifact served in-process through ``InferenceSession`` →
   ``MicroBatcher`` from 16 threads (``serve_gate``): ResNet-50 256
   requests at ``max_batch_size`` 32, the classifier 1024 requests of
   40-80 ids (256 distinct sequences) at 64 and ``bucket_multiple`` 16,
   ``max_wait_ms`` 5: no error, mean occupancy > 1, every output within
   1e-5 of the artifact's run on its request alone; requests/s, latency
   p50/p99, occupancy, the shapes run and one full window's wall against
   device-busy ms printed. (c) ``python -m
   paddle_tpu_torch.serving.serve --artifact`` (the classifier) as a
   child process (``http_gate``): 32 requests from 4 ``ServingClient``s,
   each 200 with its outputs as in (b) and its X-Request-Id echoed;
   /metrics' occupancy; a bad feed a 400 naming the feed; then 32
   requests in flight and SIGTERM: /healthz answers 503, every one of
   them 200, exit code 0. No hand-written kernel launches in (a)-(c).
   (d) ``transformer_lm`` at bench_lm.py's widths and 2 layers, bf16
   under amp, exported (``lm_export_gate``): its graph holds K1 as
   ``paddle_tpu::flash_fwd`` once a layer; each call of the artifact
   launches K1 once a layer (the kernels line counts them), no other
   kernel and never the plain version; its logits within ``BF16_TOL`` of
   ``Executor.run``'s.

18. Disaggregated serving (run after phase 17): the serving decoder at
   ``bench_lm.py``'s depth (``DIS_LAYERS`` 12), written in fp32 and bf16;
   requests share one 512-token system prompt (32 full pages), each with a
   seeded 16-64-token suffix and 16-32 new tokens. The children of (b) and
   (c) boot while (a) runs. (a) In process (``disagg_engine_gates``): an
   exporting engine self-prefills and decodes the prompts, then publishes
   every prompt's full pages through ``PrefixTierClient.publish_now``; a
   second engine with the tier client first captures a megastep trip
   (K 8) on a warm-up prompt, then maps the pages and decodes in megasteps:
   both engines' fp32 streams equal full recompute, no recapture, the pool
   tensors keep their addresses, every prompt maps the shared prefix, the
   mapped pages equal the exported ones bitwise and
   ``kv_transfer_pages_imported_total`` > 0; the same with int8 pages
   (pages and scales bitwise, the stream match printed) and one prompt's
   bf16 and fp8 pages through the store, bitwise. K3 and K3-quant launched
   as the engines' steps and trips count; the plain K3 never. (b) The
   single-engine self-prefill run (``serve_run``), then ``python -m
   paddle_tpu_torch.serving.prefix_tier``, one ``serve --role prefill`` and
   two ``serve --role decode`` on one ``--kv-transfer-dir``: each request
   goes to ``POST /v1/prefill``, then to ``POST /v1/generate`` on the two
   decode children in turn; every response 200, the streams equal the
   self-prefill run's, both decode children import pages, and no decode
   prefill computes the shared prefix. (c) A prefill child started with
   ``--chaos-spec handoff:0=hang...`` hangs inside its first export and is
   SIGKILLed: the request completes through a decode child's self-prefill
   (no imported page) and the torn entry never becomes visible; then the
   tier child is SIGKILLed with requests in flight and more sent after:
   every one is 200 with its stream, and the decode children's direct-disk
   lookups serve the pages. Prints TTFT p50/p99 with the handoff against
   self-prefill, export and import ms a page, the entry's MB, decode
   tokens/s and the phase's seconds, with the card's name and power limit.

19. The serving fleet (run after phase 18), on phase 18's decoder; 16
   prompts, half of them a shared 256-token system prompt with a seeded
   16-64-token suffix, half 16-64 tokens alone, 16-32 new tokens each. (a)
   ``python -m paddle_tpu_torch.serving.fleet --gen-paged --replicas 2
   --prefill-replicas 1`` with ``--device cuda``, fp32 pages, an explicit
   page pool a replica, the prefix tier as another child, a shared
   ``--kv-transfer-dir``, ``--trace-spool-dir`` and ``--prefill-min-prompt
   128`` (``fleet_cli_gate``); the in-process reference engine runs while
   it boots. The router's added latency against a request sent straight to
   a decode replica (16 pairs, idle fleet); then 8 closed-loop
   ``ServingClient([router])`` threads send every prompt twice and one
   decode replica is SIGKILLed a third of the way in; once it is
   readmitted, every prompt once more. Zero failed requests, every stream
   equal to the in-process ``PagedDecodeEngine``'s, ``fleet_restarts_total``
   1, prefill hops ok and skipped, affinity picks, and
   ``/fleet/trace?request_id=`` of a handed-off request laned over the
   router, the prefill replica and a decode replica. The fleet CLI, the
   tier (its ``role=cache`` record) and a second fleet CLI started with
   ``--standby`` share ``--registry-dir`` (a 5 s ``--lease-secs``), and the
   clients know both routers. (c) ``fleet_failover_gate``: every prompt
   once more under closed-loop load, the active CLI's pid SIGKILLed a
   third of the way in (this script is the replicas' subreaper and reaps
   them at the end): zero failed requests, every stream equal to the
   engine's, the standby takes the lease (``lease_takeovers_total`` 1) and
   adopts the two decode replicas and the prefill replica by the same
   pids (``replicas_adopted_total`` 3, no restart), its ``/fleet/status``
   names it the holder and the tier from the tier's record; prints the
   seconds from the SIGKILL to the lease taken and to adoption done. The
   standby's SIGTERM drains the fleet (exit 0): every replica's log names
   the card, and the two decode replicas that drained report K3 launches
   (no K3-quant). (b)
   ``FleetRouter`` + ``ReplicaSupervisor`` over two replicas with int8 pages
   serving a ``publish_artifact`` serial of the decoder (``roll_fleet``,
   booting while (a) runs; ``fleet_roll_gate``): under closed-loop load
   ``hot_swap`` rolls them
   onto a second serial published with ``weight_quant_dtype="int8"``. Zero
   failed requests, both old replicas exit 0, every answer equal to an
   in-process int8-page engine on one of the two serials, every answer
   after the roll equal to the quantized serial's, both replicas' /healthz
   naming int8 weights, and the four decode replicas' drain lines report
   K3-quant launches (no K3). Prints each
   replica's cold start, the router's added p50, TTFT p50 through the
   prefill hop, SIGKILL to readmission, the failover's seconds, the roll's
   seconds and the phase's seconds, with the card's name and power
   limit. The kernels line counts
   the replicas' launches and the reference engines'.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.

``--resume-child CHECKPOINT_DIR OUT_NPZ [--device cpu] [--preempt-after
K] [--layers ...]`` runs one child of the preemption gate by hand.

``--ab PARENT`` compares the flash kernels' and K3's times with another
checkout (unpack ``git archive <parent>`` there): in turns parent, this
tree, this tree, parent, each in its own process from its tree's root,
it runs that tree's ``flash_timing`` (the LM step's shape, then the
packed step's), ``layout_timing`` and, with this tree's helpers over
that tree's kernels, ``k3_ab_rows`` (K3 and K3-quant at a decode step's
lengths, K3 at long contexts), and prints one line per run.

``--ab-serving PARENT`` runs, in the same turns, each tree's phase 4 fp32
cell at K = 1 and phase 12's four served cells at K = 8, each served three
times (``_AB_SERVE``): decode tokens/s, TPOT, TTFT, host gap; after each K
= 8 cell that tree's ``megastep_profile`` and a fresh engine's first three
megasteps' host ms (the first captures the trip); one line per run.
"""

import argparse
import concurrent.futures
import contextlib
import json
import math
import os
import re
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

# the serving slice's model: the flagship LM widths at a third of its depth
# (4 of bench_lm.py's 12 layers; 12 until phase 16 came, 6 until phase 17
# came), so that every phase fits the script's time limit
VOCAB, DIM, HEADS, LAYERS, FFN_MULT = 32000, 512, 8, 4, 4
SLOTS, MAX_LEN, BUCKETS, PAGE = 32, 1024, "64,128,256,512", 16
N_CLIENTS, PER_CLIENT = 8, 6
# seeded, inclusive; the new tokens 32-128 until phase 17 came, 16-64 until
# phase 18 came (cut for the script's time limit)
PROMPT_LEN, NEW_TOKENS = (16, 480), (16, 48)
SEED = 0
DEVICE = "cuda"

# the training slice: bench_lm.py's transformer LM step
LM_VOCAB, LM_DIM, LM_HEADS, LM_LAYERS = 32000, 512, 8, 12
LM_BATCH, LM_SEQ, LM_LR, LM_STEPS, LM_PROFILE_STEPS = 16, 1024, 1e-4, 10, 2
GATE_LAYERS, GATE_BATCH, GATE_SEQ, GATE_STEPS = 2, 2, 512, 3
# (b, s, h, hkv, d) of the flash checks; b = 3 rows: full, padded tail,
# fully padded under the mask. WIDE_GROUP is Falcon-7B's attention (71
# query heads on one kv head, head_dim 64): a group larger than a block's
# 64 rows, which the kernels split over several blocks.
# head_dim 96 leaves zero columns inside the bf16 K1/K2 bodies' 16-wide
# tensor-core steps; head_dim 36 rows are not 16-byte aligned, so those
# bodies stage them element by element instead of by cp.async; head_dim
# 32 takes the bodies' narrowest bin.
WIDE_GROUP = (3, 256, 71, 1, 64)
FLASH_GEOMS = [(3, 256, 4, 4, 64), (3, 256, 4, 2, 128),
               (3, 1024, 8, 8, 128), (3, 1024, 8, 4, 64),
               (3, 300, 4, 2, 64), (3, 300, 2, 2, 128), (3, 300, 4, 2, 96),
               (3, 130, 2, 1, 36), (3, 300, 4, 2, 32), WIDE_GROUP]
# fp32 training gate, card (kernels, cuBLAS) vs CPU (plain versions):
# the same arithmetic in fp32 in another summation order
GATE_LOSS_RTOL = 1e-5
# capture_gc_gate: dead executors left as cycles, and the LM they ran
CGC_DEAD, CGC_LAYERS, CGC_BATCH, CGC_SEQ = 3, 1, 2, 128
GATE_UPDATE_REL_L2 = 1e-3      # of the weight's 3-step update

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor cores
FP64_TC_FLOPS = 67e12          # H100 SXM fp64 tensor cores (data sheet)
# Kernel and plain version both accumulate in fp32 and round once to the
# output's dtype (K3 and K1/K2 alike), so they differ by summation order
# only: ~1e-7 relative in fp32 (the flash grid read <= 1.5e-5 on dv,
# whose sums over 2048 query rows reach tens),
# and in bf16 at most one unit in the last place of the output (<= 2^-7
# relative) where the fp32 values straddle a rounding boundary. Under
# bf16 the K1/K2 tensor-core bodies carry P and dS as hi + lo bf16 halves
# (~2^-17 relative of fp32 operands); K6 and its plain version round P
# and dS to bf16 at the same points (the forward's P at each key tile's
# running max), so a rounding differs only where the summation order
# moves an fp32 value across a bf16 boundary. The Lse stays fp32: the
# tensor cores change only the order of its sums.
FP32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=1e-3, rtol=1e-2)
BF16_LOGIT_REL_L2 = 5e-2       # bf16 vs fp32 twin, first-step logits

K3 = {"name": "paged_decode_attention", "route": "cuda",
      "source": "paddle_tpu_torch/csrc/paged_decode.cu",
      "replaces": "paddle_tpu/ops/pallas_paged_attention.py:239"}
# the quantized variant: the same pallas_call built with quant_group
K3Q = {"name": "paged_decode_attention_quant", "route": "cuda",
       "source": "paddle_tpu_torch/csrc/paged_decode.cu",
       "replaces": "paddle_tpu/ops/pallas_paged_attention.py:239"}
# the quantized serving runs: KV page modes, the sub-page scale group of the
# kernel checks, and the reference's greedy token-match guard (a recorded
# number here: random weights at full width are not the reference's probe)
KV_MODES = ("int8", "fp8")
SUB_GROUP = 4
QUANT_LOGIT_REL_L2 = 1e-1      # quantized vs unquantized prefill logits
TOKEN_MATCH_GUARD = 0.95
# admission at equal pool bytes: the bf16 decoder on CAP_SLOTS slots over
# the bf16 run's pool (SLOTS x MAX_LEN tokens), then with int8 pages over
# as many pages as those bytes hold; every request's worst case (prompt +
# budget) is CAP_TOKENS, so both pools, not the slots, bound admission
CAP_SLOTS, CAP_TOKENS, CAP_BUCKETS = 64, 1024, "64,128,256,512,992"
CAP_CLIENTS, CAP_PER_CLIENT, CAP_NEW_TOKENS = 16, 6, (32, 64)
ADMISSION_RATIO = 1.9          # the reference's equal-memory bar
# (S, H, KVH, D, page, MP) of the K3 checks' wide table: 8 splits of the
# kernel's plan per slot (32 for int8/fp8 pools); and the long-context K3
# timing's slots, all at LONG_TOKENS
K3_WIDE = (4, 8, 2, 64, 16, 256)
LONG_SLOTS, LONG_TOKENS = 4, 4096


_FLASH_SRC = "paddle_tpu_torch/csrc/flash_attention.cu"
K1 = {"name": "flash_fwd", "route": "cuda", "source": _FLASH_SRC,
      "replaces": "paddle_tpu/ops/pallas_attention.py:616"}
K2_DQ = {"name": "flash_bwd_dq", "route": "cuda", "source": _FLASH_SRC,
         "replaces": "paddle_tpu/ops/pallas_attention.py:959"}
K2_DKV = {"name": "flash_bwd_dkv", "route": "cuda", "source": _FLASH_SRC,
          "replaces": "paddle_tpu/ops/pallas_attention.py:977"}
_SEG_SRC = "paddle_tpu_torch/csrc/flash_segment.cu"
K5_FWD = {"name": "flash_segment_fwd", "route": "cuda", "source": _SEG_SRC,
          "replaces": "paddle_tpu/ops/pallas_attention.py:1115"}
K5_DQ = {"name": "flash_segment_bwd_dq", "route": "cuda",
         "source": _SEG_SRC,
         "replaces": "paddle_tpu/ops/pallas_attention.py:1258"}
K5_DKV = {"name": "flash_segment_bwd_dkv", "route": "cuda",
          "source": _SEG_SRC,
          "replaces": "paddle_tpu/ops/pallas_attention.py:1289"}
K4 = {"name": "fused_adam", "route": "cuda",
      "source": "paddle_tpu_torch/csrc/fused_adam.cu",
      "replaces": "paddle_tpu/ops/pallas_optimizer.py:85"}
_BHSD_SRC = "paddle_tpu_torch/csrc/flash_bhsd.cu"
K6_FWD = {"name": "flash_bhsd_fwd", "route": "cuda", "source": _BHSD_SRC,
          "replaces": "paddle_tpu/ops/pallas_attention.py:430"}
K6_DQ = {"name": "flash_bhsd_bwd_dq", "route": "cuda", "source": _BHSD_SRC,
         "replaces": "paddle_tpu/ops/pallas_attention.py:781"}
K6_DKV = {"name": "flash_bhsd_bwd_dkv", "route": "cuda", "source": _BHSD_SRC,
          "replaces": "paddle_tpu/ops/pallas_attention.py:798"}
# the dense-mask instantiations: the same pallas_calls built with a mask
K6_FWD_DENSE = {"name": "flash_bhsd_fwd_dense", "route": "cuda",
                "source": _BHSD_SRC,
                "replaces": "paddle_tpu/ops/pallas_attention.py:430"}
K1_DENSE = {"name": "flash_fwd_dense", "route": "cuda", "source": _FLASH_SRC,
            "replaces": "paddle_tpu/ops/pallas_attention.py:616"}
K1K2 = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
K5 = ("flash_segment_fwd", "flash_segment_bwd_dq", "flash_segment_bwd_dkv")
K6 = ("flash_bhsd_fwd", "flash_bhsd_bwd_dq", "flash_bhsd_bwd_dkv")
DENSE = ("flash_bhsd_fwd_dense", "flash_fwd_dense")
FLASH_KERNELS = K1K2 + K5 + K6 + DENSE

# the packed slice: segment maps of the K5 checks, the padded baseline's
# steps (each ~2.6x the packed step's work), the fused-Adam contract
SEG_MAPS = ("random", "one", "short", "edges")
BASE_STEPS = 4
ADAM_MAX_ULPS = 2              # kernel vs plain: the reference's contract
K4_SIZES = (1, 1023, 71153920)
K4_ODD_SIZES = (5, 10001, 333333)   # offsets off the 16-byte grain
ALTERNATE_ROUNDS = 3           # Adam / FusedAdam steps taken in turns

# the per-head and dense-mask slice: the K6 / K1-dense check grid (b = 3
# rows, as FLASH_GEOMS: full, padded tail, fully padded under a factored
# mask), its masks ("none", "factored", or a dense [mb, mh, s, s] mask
# with "b"/"h" for the full extent), the dense programs' steps (each step
# recomputes every layer's backward through [b, h, s, s] fp32 logits)
BHSD_GEOMS = [(3, s, 8, hkv, d) for s in (256, 1000, 1024) for d in (64, 128)
              for hkv in (8, 2)] + [(3, 300, 8, 2, 32), WIDE_GROUP]
BHSD_MASKS = ("none", "factored", (1, 1), ("b", 1), (1, "h"), ("b", "h"))
K1_DENSE_MASKS = ((1, 1), ("b", 1))
DENSE_STEPS = 3
# the flash bodies (``flash_bodies``) that the profiles of phase 6 (K1,
# K2), phase 7 (K5), phase 9 (K6) and phase 10's two programs (by layout)
# must show at the step's bf16 head_dim 64: the tensor-core bodies
TRAIN_BODIES = {("fwd", "mma", "bshd", 0), ("bwd_dq", "mma", "bshd", 0),
                ("bwd_dkv", "mma", "bshd", 0)}
PACKED_BODIES = {("fwd", "mma", "bshd", 1),
                 ("bwd_dq", "mma", "bshd", 1), ("bwd_dkv", "mma", "bshd", 1)}
BHSD_BODIES = {("fwd", "mma", "bhsd", 0), ("bwd_dq", "mma", "bhsd", 0),
               ("bwd_dkv", "mma", "bhsd", 0)}
DENSE_BODIES = {"bhsd": {("fwd", "mma", "bhsd", 2)},
                "bshd": {("fwd", "mma", "bshd", 2)}}
# the flash kernels whose bf16 calls at head_dim <= 128 run a tensor-core
# body (``mma_forward`` / ``mma_backward`` in csrc/flash_kernels.cuh): all
# of them; fp32 and head_dim > 128 run a CUDA-core body, whose shared
# memory holds fp32 tiles whatever the input dtype
MMA_FLASH = FLASH_KERNELS
SMEM_HEAD_DIMS = (32, 64, 128, 256)


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
    """Compile every source; print ptxas's registers and spills, and
    fail if any tensor-core body (``*_mma_kernel``: the forward of K1,
    K1-dense, K5, K6 and K6-fwd-dense, the backward of K2, K5 and K6, at
    every head_dim bin) spills, or if a flash kernel reports the shared
    memory of a body it does not launch (``flash_smem``)."""
    from paddle_tpu_torch import _build
    secs = _build.build()
    spills = {}
    for name, text in sorted(_build.build_logs.items()):
        for ln in text.splitlines():
            if "registers" in ln or "spill" in ln or "error" in ln:
                log("  nvcc %s: %s" % (name, ln.strip()))
        spills.update(mma_spills(text))
    log("tensor-core bodies (kernel: spill bytes stored, loaded): %s"
        % json.dumps(spills))
    bad = {k: v for k, v in spills.items() if any(v)}
    if bad:
        raise AssertionError("tensor-core bodies spill: %s" % bad)
    log("build: %s in %.2f s" % (", ".join(sorted(_build.SOURCES)), secs))
    flash_smem()
    return secs


def flash_smem():
    """Each flash kernel's reported shared memory per block (what its
    wrapper checks against the card's limit) at SMEM_HEAD_DIMS in fp32
    and bf16, logged and held by ``smem_gate``."""
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    nbytes = {(name, d, dt): fa.smem_bytes(name, d, dtype)
              for name in FLASH_KERNELS for d in SMEM_HEAD_DIMS
              for dt, dtype in (("float32", torch.float32),
                                ("bfloat16", torch.bfloat16))}
    log("flash kernels' shared memory (bytes, fp32 / bf16): %s" % json.dumps(
        {"%s d%d" % (name, d): [nbytes[(name, d, "float32")],
                                nbytes[(name, d, "bfloat16")]]
         for name in FLASH_KERNELS for d in SMEM_HEAD_DIMS}))
    smem_gate(nbytes)
    return nbytes


def smem_gate(nbytes):
    """``nbytes`` {(kernel, head_dim, "float32" | "bfloat16"): bytes}:
    the bytes belong to the body that each call launches, so a kernel
    that runs a CUDA-core body under bf16 (fp32 tiles) reports its fp32
    bytes and one that runs a tensor-core body (bf16 tiles, MMA_FLASH at
    head_dim <= 128) other bytes; a dense-mask forward's tensor-core
    body stages the mask's tile beside K and V, so it reports more than
    the unmasked forward of its layout (the CUDA-core bodies read the
    mask where it lies: the same bytes); raises otherwise."""
    bad = []
    for name in FLASH_KERNELS:
        for d in SMEM_HEAD_DIMS:
            mma = name in MMA_FLASH and d <= 128
            same = nbytes[(name, d, "bfloat16")] == \
                nbytes[(name, d, "float32")]
            if same == mma:
                bad.append("%s d%d (%s body)" % (
                    name, d, "tensor-core" if mma else "CUDA-core"))
    for dense, plain in zip(DENSE, ("flash_bhsd_fwd", "flash_fwd")):
        for d in SMEM_HEAD_DIMS:
            for dt in ("float32", "bfloat16"):
                staged = dt == "bfloat16" and d <= 128
                more = nbytes[(dense, d, dt)] - nbytes[(plain, d, dt)]
                if (more <= 0) if staged else more != 0:
                    bad.append("%s d%d %s (%s than %s)" % (
                        dense, d, dt, "no more" if staged else "other",
                        plain))
    if bad:
        raise AssertionError("flash kernels report the shared memory of "
                             "another body than they launch under bf16: "
                             "%s" % bad)


def mma_spills(text):
    """{mangled name: (spill stores, spill loads)} of the tensor-core
    kernels in ptxas's ``-v`` output (empty when nothing was built)."""
    out, name = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and name and "_mma_kernel" in name:
            out[name] = (int(m.group(1)), int(m.group(2)))
            name = None
    return out


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


def k3_lengths(rng, S, MP, page, edges=False, quant=False):
    """The S lengths of a K3 check over a table of MP pages: 0 (one live
    position), 1, a mid-page frontier and the full window — or, with
    ``edges``, the edges of the kernel's split plan for such pools
    (``quant``: int8/fp8; a split's tokens - 1, them, + 1, and one token
    short of the full table; capped at the table) —, then seeded lengths
    for the remaining slots."""
    from paddle_tpu_torch.ops import paged_attention as pa
    T = MP * page
    if edges:
        C = pa.split_plan(MP, page, quant)[0] * page
        fixed = [min(n, T) for n in (C - 1, C, C + 1, T - 1)]
    else:
        fixed = [0, 1, 2 * page + 3, T]
    return fixed + [int(n) for n in rng.randint(1, T + 1, size=S - 4)]


def kernel_checks():
    import torch
    from paddle_tpu_torch.ops import paged_attention as pa
    rng = np.random.RandomState(SEED)
    # (S, H, KVH, D, page, MP): the serving geometry at the engine's slot
    # count and pool size, the tuning grid of
    # tests/serving/test_paged_generation.py, then the wide table
    geoms = [(SLOTS, HEADS, HEADS, DIM // HEADS, PAGE, MAX_LEN // PAGE),
             (4, 4, 4, 32, 8, 6), (4, 4, 2, 64, 16, 6), (4, 8, 2, 128, 16, 6),
             (4, 4, 2, 192, 8, 6), (4, 4, 1, 256, 8, 6), K3_WIDE]
    rows = []
    for (S, H, KVH, D, page, MP), edges in [(g, e) for g in geoms
                                            for e in (False, True)]:
        lengths = k3_lengths(rng, S, MP, page, edges)
        for dtype in (torch.float32, torch.bfloat16):
            args = _pool_case(rng, S, MP, page, H, KVH, D, dtype, lengths)
            got = pa.paged_decode_attention(*args)
            _sync()
            err, ok = _against_plain(got,
                                     pa.paged_decode_attention_plain(*args))
            rows.append({"geometry": [S, H, KVH, D, page, MP],
                         "dtype": str(dtype).split(".")[-1],
                         "lengths": lengths, "max_abs_err": err, "ok": ok})
            log("  K3 S=%d H=%d KVH=%d D=%d page=%d pool=%d %s lengths "
                "%s...: max|err| %.3g %s"
                % (S, H, KVH, D, page, S * MP + 1, rows[-1]["dtype"],
                   lengths[:4], err, "ok" if ok else "FAIL"))
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


def _quant_pool_case(rng, S, MP, P, page, H, KVH, D, dtype, lengths, mode,
                     group):
    """Quantized pools of P pages plus the scratch row (int8 values over
    the whole range, fp8 from normal draws x 64) and per-(page, group,
    kv-head) scales that bring the dequantized values to O(1), as a real
    pool's scale (amax / qmax) does, with one virgin page (scale 0); also
    q, page table and lengths. Returns the wrapper's (args, kwargs)."""
    import torch
    from paddle_tpu_torch.ops import kv_quant as kvq
    cfg = kvq.KVQuantConfig(mode, page, group)
    shape = (P + 1, page, KVH, D)
    if mode == "int8":
        pools = [torch.from_numpy(rng.randint(-127, 128, size=shape).astype(
            np.int8)) for _ in range(2)]
    else:
        pools = [torch.from_numpy(rng.randn(*shape).astype(np.float32) * 64)
                 .clamp(-448, 448).to(torch.float8_e4m3fn) for _ in range(2)]
    spread = 73.0 if mode == "int8" else 64.0   # std of the stored values
    scales = []
    for _ in range(2):
        sc = (0.5 + rng.rand(P + 1, cfg.groups_per_page, KVH)) / spread
        sc[rng.randint(0, P)] = 0.0
        scales.append(torch.from_numpy(sc.astype(np.float32)))
    pt = torch.from_numpy(rng.randint(0, P, size=(S, MP)).astype(np.int32))
    q = torch.from_numpy(rng.randn(S, H, D).astype(np.float32)).to(dtype)
    ln = torch.from_numpy(np.asarray(lengths, np.int32))
    args = [t.to(DEVICE) for t in (q, pools[0], pools[1], pt, ln)]
    return args, {"k_scale": scales[0].to(DEVICE),
                  "v_scale": scales[1].to(DEVICE), "quant": cfg}


def quant_kernel_checks():
    """K3-quant against its plain version on the card: int8 and fp8 pools,
    bf16 and fp32 q, one scale group per page and sub-page groups, H = KVH
    and GQA, lengths 0, 1, mid-page and the full window, then the split
    edges (``k3_lengths``); first at the serving geometry (32 slots over
    the quantized engine's 4097-page pool), last on the wide table.
    Comparison launches do not count as the main path's."""
    import torch
    from paddle_tpu_torch.ops import paged_attention as pa
    rng = np.random.RandomState(SEED + 9)
    saved = pa.launches_quant
    # (S, H, KVH, D, page, MP, P)
    MP = MAX_LEN // PAGE
    geoms = [(SLOTS, HEADS, HEADS, DIM // HEADS, PAGE, MP, 2 * SLOTS * MP),
             (4, 8, 2, 64, 16, 6, 24), (4, 8, 8, 128, 16, 6, 24),
             (4, 8, 2, 128, 8, 6, 24), K3_WIDE + (K3_WIDE[0] * K3_WIDE[5],)]
    rows = []
    for (S, H, KVH, D, page, mp, P), edges in [(g, e) for g in geoms
                                               for e in (False, True)]:
        lengths = k3_lengths(rng, S, mp, page, edges, quant=True)
        for mode in KV_MODES:
            for group in (page, SUB_GROUP):
                for dtype in (torch.float32, torch.bfloat16):
                    args, kw = _quant_pool_case(rng, S, mp, P, page, H, KVH,
                                                D, dtype, lengths, mode,
                                                group)
                    got = pa.paged_decode_attention(*args, **kw)
                    _sync()
                    err, ok = _against_plain(
                        got, pa.paged_decode_attention_plain(*args, **kw))
                    rows.append({"geometry": [S, H, KVH, D, page, mp],
                                 "lengths": lengths,
                                 "pool": P + 1, "mode": mode, "group": group,
                                 "dtype": str(dtype).split(".")[-1],
                                 "max_abs_err": err, "ok": ok})
                    if not ok or S == SLOTS:
                        log("  K3-quant S=%d H=%d KVH=%d D=%d page=%d "
                            "pool=%d %s group=%d %s: max|err| %.3g %s"
                            % (S, H, KVH, D, page, P + 1, mode, group,
                               rows[-1]["dtype"], err,
                               "ok" if ok else "FAIL"))
    # quantized pools without their scales must raise, never fall back
    args, kw = _quant_pool_case(rng, 2, 2, 4, 8, 2, 2, 8, torch.float32,
                                [3, 5], "int8", 8)
    for bad in ({}, dict(kw, k_scale=kw["k_scale"][:-1])):
        try:
            pa.paged_decode_attention(*args, **bad)
        except (TypeError, ValueError):
            continue
        raise AssertionError("K3-quant accepted inputs it does not take")
    pa.launches_quant = saved
    log(json.dumps({"kernel_checks": [{
        "name": K3Q["name"], "cases": len(rows),
        "ok": all(r["ok"] for r in rows),
        "max_abs_err": max(r["max_abs_err"] for r in rows)}]}))
    if not all(r["ok"] for r in rows):
        raise AssertionError("K3-quant disagrees with its plain version: %s"
                             % [r for r in rows if not r["ok"]])
    return rows


def quant_append_checks():
    """``paged_quant_append`` on the card against the CPU from the same
    inputs: decode-like (one page per slot) and prefill-like (a window of
    pages plus scratch, padded positions) appends of growing and shrinking
    magnitude, 8 steps, int8 and fp8, one group per page and SUB_GROUP.
    Every page but scratch and every scale must be equal bit for bit."""
    import torch
    from paddle_tpu_torch.ops import kv_quant as kvq
    rng = np.random.RandomState(SEED + 10)
    P, H, D, S = 96, HEADS, DIM // HEADS, 8
    rows = []
    for mode in KV_MODES:
        for group in (PAGE, SUB_GROUP):
            cfg = kvq.KVQuantConfig(mode, PAGE, group)
            pools = {dev: (torch.zeros((P + 1, PAGE, H, D),
                                       dtype=cfg.storage_dtype, device=dev),
                           torch.zeros(cfg.scale_shape(P + 1, H),
                                       device=dev))
                     for dev in ("cpu", DEVICE)}
            for step in range(8):
                W, T = (2, 1) if step % 2 else (4, 3 * PAGE)
                perm = rng.permutation(P)[:S * (W - 1)].reshape(S, W - 1)
                win = np.concatenate([perm, np.full((S, 1), P)], 1)
                cells = np.stack([rng.permutation((W - 1) * PAGE)[:T]
                                  for _ in range(S)])
                pad = rng.rand(S, T) < 0.2
                w_idx = np.where(pad, W - 1, cells // PAGE)
                offs = np.where(pad, 0, cells % PAGE)
                vals = (rng.randn(S, T, H, D) * [0.2, 5.0, 1.0, 30.0][
                    step % 4]).astype(np.float32)
                for dev, (pool, sc) in pools.items():
                    t = [torch.from_numpy(a.astype(np.int64)).to(dev)
                         for a in (win, w_idx, offs)]
                    out = kvq.paged_quant_append(
                        pool, sc, t[0], t[1], t[2],
                        torch.from_numpy(vals).to(dev), cfg)
                    kvq.write_window(pool, sc, t[0], *out)
            _sync()
            (cp, cs), (gp, gs) = pools["cpu"], pools[DEVICE]
            diff_pages = int((cp[:P].view(torch.uint8) !=
                              gp[:P].cpu().view(torch.uint8)).sum())
            diff_scales = int((cs[:P] != gs[:P].cpu()).sum())
            rows.append({"mode": mode, "group": group,
                         "bytes_differ": diff_pages,
                         "scales_differ": diff_scales,
                         "ok": diff_pages == 0 and diff_scales == 0})
    log(json.dumps({"quant_append_checks": rows}))
    if not all(r["ok"] for r in rows):
        raise AssertionError("paged_quant_append on the card differs from "
                             "the CPU: %s" % rows)
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


def _flash_api(causal, valid=None, seg=None, mask=None, layout="bshd"):
    """The wrappers (fwd, dq, dkv) and plain versions (fwd, bwd) of K1/K2
    (K6 in ``layout="bhsd"``), of K5 under segment ids ``seg``, or the
    forward of K1-dense / K6-fwd-dense under the dense ``mask`` (dq, dkv
    and the plain bwd None: no kernel takes its backward), and the
    arguments each takes after its tensors."""
    import functools
    from paddle_tpu_torch.ops import flash_attention as fa
    if seg is not None:
        return (fa.flash_fwd_segment, fa.flash_bwd_segment_dq,
                fa.flash_bwd_segment_dkv, fa.flash_fwd_segment_plain,
                fa.flash_bwd_segment_plain), (seg, None, causal)
    fwd = functools.partial(fa.flash_fwd, mask=mask, layout=layout)
    fwd_plain = functools.partial(fa.flash_fwd_plain, mask=mask,
                                  layout=layout)
    if mask is not None:
        return (fwd, None, None, fwd_plain, None), (None, causal)
    return (fwd, functools.partial(fa.flash_bwd_dq, layout=layout),
            functools.partial(fa.flash_bwd_dkv, layout=layout), fwd_plain,
            functools.partial(fa.flash_bwd_plain, layout=layout)), \
        (None, causal, valid)


def _flash_check(q, k, v, do, valid, causal, seg=None, mask=None,
                 layout="bshd"):
    """K1 (K6-fwd in bhsd, K5-fwd under segment ids ``seg``, K1-dense or
    K6-fwd-dense under a dense ``mask``), then K2-dQ and K2-dKV (K6-dQ,
    K6-dKV; K5-dQ, K5-dKV; none under a dense mask) on the plain
    forward's (o, lse), each held against its plain version elementwise;
    (max |err| per output, ok, the kernels' (o, lse[, dq, dk, dv]))."""
    (fwd, dq_fn, dkv_fn, fwd_plain, bwd_plain), tail = \
        _flash_api(causal, valid, seg, mask, layout)
    o, lse = fwd(q, k, v, *tail)
    po, plse = fwd_plain(q, k, v, *tail)
    checks = [("o", o, po), ("lse", lse, plse)]
    if dq_fn is not None:
        delta = (do.float() * po.float()).sum(-1)
        dq = dq_fn(q, k, v, do, plse, delta, *tail)
        dk, dv = dkv_fn(q, k, v, do, plse, delta, *tail)
        _sync()
        ref = bwd_plain(q, k, v, po, plse, do, *tail)
        checks += list(zip(("dq", "dk", "dv"), (dq, dk, dv), ref))
    _sync()
    errs, ok = {}, True
    for name, got, want in checks:
        err, good = _against_plain(got, want)
        errs[name] = err
        ok = ok and good
    return errs, ok, tuple(got for _, got, _ in checks)


def _bhsd(*xs):
    """bshd tensors as contiguous bhsd ones."""
    return [x.transpose(1, 2).contiguous() for x in xs]


def _check_mask(rng, kind, b, s, h):
    """A dense check mask [mb, mh, s, s] bool for ``kind`` (mb, mh), "b"
    and "h" standing for the full extents: each key visible with
    probability 0.7, and query row 5 of its first [s, s] slice fully
    masked (that row is the uniform average of V)."""
    import torch
    mb, mh = (b if kind[0] == "b" else 1), (h if kind[1] == "h" else 1)
    m = rng.rand(mb, mh, s, s) < 0.7
    m[0, 0, 5] = False
    return torch.from_numpy(m).to(DEVICE)


def layout_checks():
    """K6-fwd, K6-dQ and K6-dKV (bhsd) without a mask, with a factored
    padding mask, and K6-fwd under dense [1|b, 1|h, s, s] masks; K1-dense
    (bshd) under dense [1|b, 1, s, s] masks — each against its plain
    version on the card over BHSD_GEOMS x dtype x causal. Comparison
    launches do not count as the main path's."""
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    rng = np.random.RandomState(SEED + 11)
    saved = dict(fa.launches)
    cases = [(g, dt, c, layout, m) for g in BHSD_GEOMS
             for dt in (torch.float32, torch.bfloat16) for c in (False, True)
             for layout, masks in (("bhsd", BHSD_MASKS),
                                   ("bshd", K1_DENSE_MASKS))
             for m in masks]
    rows = []
    for (b, s, h, hkv, d), dtype, causal, layout, kind in cases:
        q, k, v, do, valid = _flash_case(rng, b, s, h, hkv, d, dtype,
                                         kind == "factored")
        if layout == "bhsd":
            q, k, v, do = _bhsd(q, k, v, do)
        mask = None if kind in ("none", "factored") else \
            _check_mask(rng, kind, b, s, h)
        errs, ok, _ = _flash_check(q, k, v, do, valid, causal, mask=mask,
                                   layout=layout)
        name = fa.kernel_name("fwd", layout, mask is not None)
        rows.append({"kernel": name, "shape": [b, s, h, hkv, d],
                     "dtype": str(dtype).split(".")[-1], "causal": causal,
                     "mask": kind if mask is None else list(mask.shape[:2]),
                     "max_abs_err": errs, "ok": ok})
        if not ok or len(rows) == len(cases):
            log("  %s b=%d s=%d h=%d hkv=%d d=%d %s causal=%s mask=%s: "
                "max|err| %s %s" % (name, b, s, h, hkv, d, rows[-1]["dtype"],
                                   causal, rows[-1]["mask"], json.dumps(
                                       {n: float("%.3g" % e)
                                        for n, e in errs.items()}),
                                   "ok" if ok else "FAIL"))
    fa.launches.update(saved)
    summary = {}
    for name in ("flash_bhsd_fwd", "flash_bhsd_fwd_dense", "flash_fwd_dense"):
        mine = [r for r in rows if r["kernel"] == name]
        summary[name] = {"cases": len(mine), "ok": all(r["ok"] for r in mine),
                         "max_abs_err": {n: max(r["max_abs_err"][n]
                                                for r in mine)
                                         for n in mine[0]["max_abs_err"]}}
    log(json.dumps({"layout_checks": summary}))
    if not all(r["ok"] for r in rows):
        raise AssertionError("K6 / K1-dense disagree with their plain "
                             "versions: %s" % [r for r in rows
                                               if not r["ok"]])
    return rows


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
        errs, ok, _ = _flash_check(q, k, v, do, valid, causal)
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


def _seg_map(rng, kind, b, s):
    """[b, s] int32 segment ids, non-decreasing along each row: "random"
    2-5 documents at random cuts, "one" a single segment, "short"
    segments of 1-8 tokens, "edges" boundaries every 64 positions, on the
    kernels' tile edges in row 1 and one off either side in rows 0, 2."""
    out = np.zeros((b, s), np.int32)
    for i in range(b):
        if kind == "random":
            n = rng.randint(2, 6)
            cuts = np.sort(rng.choice(np.arange(1, s), n - 1, replace=False))
        elif kind == "short":
            cuts = np.cumsum(rng.randint(1, 9, size=s))
            cuts = cuts[cuts < s]
        elif kind == "edges":
            cuts = np.arange(64, s, 64) + (i % 3) - 1
        else:
            cuts = np.zeros(0, np.int64)
        bounds = np.concatenate([[0], cuts, [s]]).astype(np.int64)
        for si in range(len(bounds) - 1):
            out[i, bounds[si]:bounds[si + 1]] = si
    return out


def _segments(ids):
    import torch
    from paddle_tpu_torch.ops.segment_mask import SegmentIds
    t = torch.from_numpy(np.ascontiguousarray(ids, np.int32)).to(DEVICE)
    return SegmentIds(t, t)


def segment_checks(packed_ids):
    """K5-fwd, K5-dQ and K5-dKV against their plain versions on the card
    over FLASH_GEOMS x dtype x causal x SEG_MAPS, then at the packed
    step's shape and map (``packed_ids`` [16, 1024]). Under one segment
    the K5 results must also match K1/K2's. Comparison launches do not
    count as the main path's."""
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    rng = np.random.RandomState(SEED + 4)
    saved = dict(fa.launches)
    cases = [(g, dt, c, m) for g in FLASH_GEOMS
             for dt in (torch.float32, torch.bfloat16)
             for c in (False, True) for m in SEG_MAPS]
    cases.append(((LM_BATCH, LM_SEQ, LM_HEADS, LM_HEADS, LM_DIM // LM_HEADS),
                  torch.bfloat16, True, "packed"))
    rows = []
    for (b, s, h, hkv, d), dtype, causal, kind in cases:
        q, k, v, do, _ = _flash_case(rng, b, s, h, hkv, d, dtype, False)
        ids = packed_ids if kind == "packed" else _seg_map(rng, kind, b, s)
        errs, ok, outs = _flash_check(q, k, v, do, None, causal,
                                      _segments(ids))
        row = {"shape": [b, s, h, hkv, d], "dtype": str(dtype).split(".")[-1],
               "causal": causal, "map": kind, "max_abs_err": errs, "ok": ok}
        if kind == "one":      # one segment: K5 must match K1/K2
            _, _, k12 = _flash_check(q, k, v, do, None, causal)
            same = [_against_plain(a, b_) for a, b_ in zip(outs, k12)]
            row["k1k2_max_abs_err"] = max(e for e, _ in same)
            row["ok"] = ok = ok and all(good for _, good in same)
        rows.append(row)
        if not ok or len(rows) == len(cases):
            log("  K5 b=%d s=%d h=%d hkv=%d d=%d %s causal=%s map=%s: "
                "max|err| %s %s" % (b, s, h, hkv, d, row["dtype"], causal,
                                   kind, json.dumps(
                                       {n: float("%.3g" % e)
                                        for n, e in errs.items()}),
                                   "ok" if ok else "FAIL"))
    fa.launches.update(saved)
    worst = {n: max(r["max_abs_err"][n] for r in rows)
             for n in ("o", "lse", "dq", "dk", "dv")}
    one = max(r["k1k2_max_abs_err"] for r in rows if "k1k2_max_abs_err" in r)
    log(json.dumps({"segment_checks": {
        "cases": len(rows), "ok": all(r["ok"] for r in rows),
        "max_abs_err": worst, "one_segment_vs_k1k2_max_abs_err": one}}))
    if not all(r["ok"] for r in rows):
        raise AssertionError("segment kernels disagree with their plain "
                             "versions: %s" % [r for r in rows
                                               if not r["ok"]])
    return rows


def _max_ulps(got, want):
    """The largest distance, in units in the last place of ``want``,
    between two fp32 tensors."""
    import torch
    w = want.abs()
    ulp = torch.nextafter(w, torch.full_like(w, float("inf"))) - w
    return float(((got - want).abs() / ulp).max())


def _adam_state(sizes, seed, device):
    """Seeded fp32 Adam inputs, one tensor of each size per role; the
    scalars as the op reads them (step 3, lr 1e-4)."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def randn(n, scale=1.0):
        return torch.randn(n, generator=g, device=device) * scale
    ins = {"Param": [randn(n) for n in sizes],
           "Grad": [randn(n, 3.0) for n in sizes],
           "Moment1": [randn(n, 0.1) for n in sizes],
           "Moment2": [randn(n, 0.01).abs() for n in sizes]}
    for name, value in (("LearningRate", 1e-4), ("Beta1Pow", 0.9 ** 3),
                        ("Beta2Pow", 0.999 ** 3)):
        ins[name] = [torch.full((1,), value, device=device)]
    return ins


def _k4_args(ins, clip):
    """fused_adam_update's arguments for the op inputs ``ins``, the
    scalars computed as the op computes them."""
    from paddle_tpu_torch.ops.optimizer_ops import fused_adam_scalars
    lr_t, gscale = fused_adam_scalars(ins, clip)
    return (ins["Param"], ins["Grad"], ins["Moment1"], ins["Moment2"], lr_t,
            gscale, 0.9, 0.999, 1e-8)


def _k4_against_plain(ins, clip):
    """(max ulps, max |err|) of K4 against its plain version over every
    output element."""
    from paddle_tpu_torch.ops import fused_adam as pfa
    args = _k4_args(ins, clip)
    got = pfa.fused_adam_update(*args)
    _sync()
    want = pfa.fused_adam_update_plain(*args)
    pairs = [(a, b) for gs, ws in zip(got, want) for a, b in zip(gs, ws)]
    return (max(_max_ulps(a, b) for a, b in pairs),
            max(float((a - b).abs().max()) for a, b in pairs))


def fused_adam_checks():
    """K4 against its plain version on the card: one call over tensors of
    K4_SIZES elements, with and without global-norm clipping and a loss
    scale, the scalars computed as the op computes them, and one over
    K4_ODD_SIZES (a tensor starting off the 16-byte grain); within
    ADAM_MAX_ULPS in every output element."""
    import torch
    from paddle_tpu_torch.ops import fused_adam as pfa
    saved = dict(pfa.launches)
    rows = []
    for sizes, clip, loss_scale in ((K4_SIZES, 0.0, None),
                                    (K4_SIZES, 1.0, None),
                                    (K4_SIZES, 0.0, 1024.0),
                                    (K4_SIZES, 1.0, 1024.0),
                                    (K4_ODD_SIZES, 0.0, None)):
        ins = _adam_state(sizes, SEED + 5, DEVICE)
        if loss_scale:
            ins["Grad"] = [g * loss_scale for g in ins["Grad"]]
            ins["LossScale"] = [torch.full((1,), loss_scale, device=DEVICE)]
        ulps, err = _k4_against_plain(ins, clip)
        rows.append({"sizes": list(sizes), "clip_norm": clip,
                     "loss_scale": loss_scale, "max_ulps": ulps,
                     "max_abs_err": err, "ok": ulps <= ADAM_MAX_ULPS})
        del ins
    pfa.launches.update(saved)
    log(json.dumps({"fused_adam_checks": rows}))
    if not all(r["ok"] for r in rows):
        raise AssertionError("K4 disagrees with its plain version by more "
                             "than %d ulp: %s" % (ADAM_MAX_ULPS, rows))
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


def _post(url, body, headers=None, delay_s=0.0, shed_ok=False):
    """POST ``body`` as JSON (after ``delay_s``); the decoded reply. With
    ``shed_ok`` a 503 comes back as ``{"status": 503, "retry_after": ...,
    "error": ...}`` instead of raising."""
    time.sleep(delay_s)
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers=dict({"Content-Type":
                                               "application/json"},
                                              **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as e:
        if not (shed_ok and e.code == 503):
            raise
        return {"status": 503, "retry_after": e.headers.get("Retry-After"),
                "error": json.loads(e.read()).get("error")}


def serve_run(model_dir, prompts, budgets, kv_quant_dtype="off",
              slots=None, num_pages=0, buckets=None, megastep_k=1,
              draft_dir=None, speculative_k=0, sched_kw=None, extra=None,
              delays=None, token_cap=None, paged=True):
    """Serve ``model_dir`` through the port's entry points (KV pages in
    ``kv_quant_dtype``; SLOTS slots, BUCKETS and an auto-sized pool
    unless given; ``megastep_k`` decode trips a dispatch; without
    ``paged`` the dense ``DecodeEngine`` that ``serve`` builds by
    default, whose steps launch neither K3 nor K3-quant; with
    ``draft_dir`` the engines ``serve --gen-draft-model DRAFT
    --gen-speculative-k K`` builds: speculative rounds over a dense
    ``DecodeEngine`` on the draft) and send every request concurrently
    (``extra``: per request, ``(body fields, headers)``, e.g. a priority
    and an ``X-Tenant-Id``; ``delays``: per request, seconds before it is
    sent; ``sched_kw``: more ``GenerationScheduler`` arguments; without a
    ``brownout`` there, the shed ladder stays at level 0; ``token_cap``:
    the ladder's level-2 budget clamp, which a response may end at).
    Returns
    the responses (a shed request's as ``_post`` gives it), wall seconds,
    decode steps, the launches of K3 and K3-quant, the most sequences
    decoding at once, the pool's bytes, the decode host gap, the
    megasteps and the scheduler's counters in this run. The path's kernel
    must launch layers x (eager decode steps + megastep trips + warm-up
    trips) times — decode steps x layers at K = 1, the synced fallback
    steps of a speculative run (its verify and its draft launch none) —
    and the other kernel never."""
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.observability import catalog
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.serving import (BrownoutController, DecodeEngine,
                                          GenerationScheduler,
                                          PagedDecodeEngine, load_decoder,
                                          make_server)

    model, params = load_decoder(model_dir, device=DEVICE)
    if paged:
        engine = PagedDecodeEngine(model, params, max_slots=slots or SLOTS,
                                   max_len=MAX_LEN,
                                   prefill_buckets=buckets or BUCKETS,
                                   page_size=PAGE, num_pages=num_pages,
                                   speculative_k=speculative_k,
                                   kv_quant_dtype=kv_quant_dtype,
                                   megastep_k=megastep_k, device=DEVICE)
    else:
        engine = DecodeEngine(model, params, max_slots=slots or SLOTS,
                              max_len=MAX_LEN,
                              prefill_buckets=buckets or BUCKETS,
                              device=DEVICE)
    draft = None
    if draft_dir is not None:
        dm, dp = load_decoder(draft_dir, device=DEVICE)
        draft = DecodeEngine(dm, dp, max_slots=engine.max_slots,
                             max_len=engine.max_len,
                             prefill_buckets=engine.prefill_buckets,
                             device=DEVICE)
    sched_kw = dict(sched_kw or {})
    # the runs that measure the engines keep the shed ladder at level 0
    # (a controller whose dwell never passes): the capacity runs fill the
    # pool on purpose, and level 2 would clamp their budgets
    sched_kw.setdefault("brownout", BrownoutController(dwell_s=math.inf))
    sched = GenerationScheduler(engine, queue_depth=128, seed=SEED,
                                draft_engine=draft, **sched_kw)
    server = make_server(None, generator=sched, host="127.0.0.1", port=0,
                         request_timeout=300.0).start_background()
    url = server.url + "/v1/generate"
    extra = extra or [({}, {})] * len(prompts)
    delays = delays or [0.0] * len(prompts)
    try:
        profiler.reset_counters()
        profiler.reset_histograms()
        pa.launches = 0           # counts from here are the main path's
        pa.launches_quant = 0
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(prompts)) as ex:
            futs = [ex.submit(_post, url,
                              dict({"prompt": p.tolist(),
                                    "max_new_tokens": b,
                                    "temperature": 0.0}, **body),
                              headers, delay, "priority" in body)
                    for p, b, (body, headers), delay
                    in zip(prompts, budgets, extra, delays)]
            responses = [f.result() for f in futs]
        _sync()
        wall = time.perf_counter() - t0
        counts = {"k3": pa.launches, "k3_quant": pa.launches_quant}
        steps = int(catalog.GENERATION_DECODE_STEPS.value())
        hist = {name: profiler.histogram_percentiles(name, (50.0, 99.0))
                for name in ("generation_decode_step_ms",
                             "generation_prefill_ms")}
        peak = int(max(profiler.get_histogram("generation_slot_occupancy"),
                       default=0))
        metrics = urllib.request.urlopen(server.url + "/metrics",
                                         timeout=60).read().decode()
        health = _get_status(server.url + "/healthz")
        quant_pages = catalog.KV_QUANT_PAGES.value()
        gap_s = catalog.DECODE_HOST_GAP_SECONDS.value()
        megasteps = int(catalog.GENERATION_MEGASTEPS.value())
        trips = [int(t) for t in
                 profiler.get_histogram("generation_megastep_trips")]
        counters = {
            "drafted": catalog.SPECULATIVE_DRAFTED.value(),
            "accepted": catalog.SPECULATIVE_ACCEPTED.value(),
            "fallback": {r: catalog.SPECULATIVE_FALLBACK.value(reason=r)
                         for r in ("brownout", "capacity", "sampled")},
            "preempted": {r: catalog.PREEMPTIONS_TO_HELD.value(reason=r)
                          for r in ("budget", "pages", "slo")},
            "shed_low": catalog.REQUESTS_SHED.value(**{"class": "low"}),
            "shed_high": catalog.REQUESTS_SHED.value(**{"class": "high"}),
            "brownout_level_end": sched.brownout_level()}
    finally:
        status = server.shutdown_gracefully(60.0)
    if not status["drained"]:
        raise RuntimeError("server did not drain: %s" % status)
    if health != 200 or "generation_decode_steps_total" not in metrics:
        raise AssertionError("healthz %s / metrics incomplete" % health)
    path, other = ("k3", "k3_quant") if kv_quant_dtype == "off" else \
        ("k3_quant", "k3")
    launches = counts[path]
    trip = dict(engine.trip_stats) if paged else \
        {"decode_steps": 0, "iterations": 0, "warmups": 0}
    want = launch_want(trip, model.n_layers)
    if launches != want or counts[other] or (paged and draft is None and (
            launches <= 0 or
            (megastep_k == 1 and launches != steps * model.n_layers))):
        raise AssertionError(
            "%s launches %d != %d layers x (decode steps %d + megastep "
            "trips run %d + warm-up trips %d) = %d (served decode steps "
            "%d), or %s launched (%d)"
            % (path, launches, model.n_layers, trip["decode_steps"],
               trip["iterations"], trip["warmups"], want, steps,
               other, counts[other]))
    if (kv_quant_dtype != "off") != (quant_pages > 0):
        raise AssertionError("kv_quant_pages_total %g on a %s pool"
                             % (quant_pages, kv_quant_dtype))
    for r, b in zip(responses, budgets):
        if r.get("status") == 503:
            continue          # shed: held by the shedding phase's gates
        n = len(r["tokens"])
        if r["finish_reason"] != "length" or \
                (n != b and not (token_cap and n == token_cap < b)) or \
                not all(0 <= t < VOCAB for t in r["tokens"]):
            raise AssertionError("malformed response: %s" % {
                k: r[k] for k in ("finish_reason", "n_prompt")})
    if paged:
        pools = engine._kp + engine._vp + (engine._ks or []) + \
            (engine._vs or [])
        pages = engine.page_stats()
    else:
        pools = engine._ck + engine._cv
        pages = {"kv_quant_dtype": "off", "kv_pages_total": None,
                 "kv_pool_effective_capacity": None}
    return {"model": model, "engine": engine, "responses": responses,
            "wall_s": wall, "steps": steps, "launches": launches,
            "counts": counts, "hist": hist, "pages": pages,
            "peak_slots": peak,
            "pool_bytes": sum(t.numel() * t.element_size() for t in pools),
            "gap_s": gap_s, "megasteps": megasteps, "trips": trips,
            "trip_stats": trip, "counters": counters}


def launch_want(trip, layers):
    """K3 (or K3-quant) launches a run owes, from the engine's
    ``trip_stats``: every eager decode step, megastep trip run (an
    iteration of the loop graph's body on the card, counted when the
    megastep is synced; an eager trip on the CPU) and warm-up trip runs
    the kernel once a layer; a capture launches nothing."""
    return layers * (trip["decode_steps"] + trip["iterations"] +
                     trip["warmups"])


def _get_status(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def _serving_stats(run):
    served = [r for r in run["responses"] if "slo" in r]   # not shed
    ttft = np.array([r["slo"]["ttft_ms"] for r in served])
    tpot = np.array([r["slo"]["tpot_ms"] for r in served
                     if "tpot_ms" in r["slo"]])
    decode_tokens = sum(len(r["tokens"]) - 1 for r in served)
    return {"ttft_ms_p50": float(np.percentile(ttft, 50)),
            "ttft_ms_p99": float(np.percentile(ttft, 99)),
            "tpot_ms_p50": float(np.percentile(tpot, 50)),
            "tpot_ms_p99": float(np.percentile(tpot, 99)),
            "decode_tokens_per_s": decode_tokens / run["wall_s"],
            "host_gap_ms_per_token": run["gap_s"] * 1e3 / (
                decode_tokens + len(served)),
            "megasteps": run["megasteps"],
            "trips_histogram": {str(t): run["trips"].count(t)
                                for t in sorted(set(run["trips"]))},
            "trip_stats": run["trip_stats"],
            "tokens": int(decode_tokens + len(served)),
            "wall_s": run["wall_s"], "decode_steps": run["steps"],
            "decode_step_ms_p50": run["hist"]["generation_decode_step_ms"][50.0],
            "decode_step_ms_p99": run["hist"]["generation_decode_step_ms"][99.0],
            "prefill_ms_p50": run["hist"]["generation_prefill_ms"][50.0],
            "k3_launches": run["counts"]["k3"],
            "k3_quant_launches": run["counts"]["k3_quant"],
            "kv_quant_dtype": run["pages"]["kv_quant_dtype"],
            "kv_pages_total": run["pages"]["kv_pages_total"],
            "kv_pool_effective_capacity":
                run["pages"]["kv_pool_effective_capacity"],
            "peak_slots": run["peak_slots"], "pool_bytes": run["pool_bytes"]}


# cycles of the device sleep ahead of each timed call (~10 ms at the
# H100's 1.98 GHz boost clock): longer than any wrapper's host work, so
# the events time the device alone
SLEEP_CYCLES = 20_000_000


def _timed(fn, args, reps, flush):
    """Mean ms of ``fn(*args)`` over ``reps`` launches, each timed alone
    with CUDA events after the L2 cache was flushed (the serving loop
    touches every layer's pools between two calls of one layer). Each call
    is queued behind a device sleep, so the wrapper's host work (argument
    checks, allocations, K4's pointer table) overlaps the sleep and the
    events measure the device's time; a call whose host work outlasts
    the sleep (the eager plain versions) shows it in the time."""
    import torch
    for _ in range(3):
        fn(*args)
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        e0.record()
        fn(*args)
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / reps


def k3_check(step_args, step_kwargs=None):
    """K3 (K3-quant when ``step_kwargs`` carry a quant config and scales)
    against its plain version at a decode step's captured inputs; raises
    past the tolerance, returns max|err|. The comparison launch is not
    counted as the main path's."""
    from paddle_tpu_torch.ops import paged_attention as pa
    kw = dict(step_kwargs or {})
    saved = (pa.launches, pa.launches_quant)
    got = pa.paged_decode_attention(*step_args, **kw)
    _sync()
    err, ok = _against_plain(
        got, pa.paged_decode_attention_plain(*step_args, **kw))
    pa.launches, pa.launches_quant = saved
    if not ok:
        raise AssertionError(
            "%s disagrees with its plain version at the decode step's "
            "inputs (%s pools): max|err| %.3g"
            % ("K3" if kw.get("quant") is None else "K3-quant",
               str(step_args[1].dtype).split(".")[-1], err))
    return err


def k3_timing(step_args, launches, step_kwargs=None):
    """K3 (K3-quant when ``step_kwargs`` carry a quant config and scales)
    at the layer-0 inputs of a decode step with every slot busy
    (``step_profile``): checked against the plain version (``k3_check``),
    then timed beside its bound, the plain version and the SDPA yardstick
    on the same tokens (for K3-quant pre-dequantized to a dense cache in
    q's dtype)."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import kv_quant as kvq
    from paddle_tpu_torch.ops import paged_attention as pa
    kw = dict(step_kwargs or {})
    quant = kw.get("quant")
    q, kp, vp, pt, lengths = step_args
    S, H, D = q.shape
    _, page, KVH, _ = kp.shape
    n = lengths.clamp(min=1).long()
    elem = q.element_size()
    tokens = int(n.sum())
    pages = int(((n + page - 1) // page).sum())
    nbytes = (tokens * KVH * D * 2 * kp.element_size() + 2 * q.numel() * elem
              + pages * 4 + S * 4)
    if quant is not None:   # each live page's K and V scales, read once
        nbytes += pages * quant.groups_per_page * KVH * 4 * 2
    flops = tokens * H * D * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    err = k3_check(step_args, kw)
    name = "K3" if quant is None else "K3-quant"
    saved = (pa.launches, pa.launches_quant)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device=DEVICE)
    ms = _timed(lambda *a: pa.paged_decode_attention(*a, **kw),
                (q, kp, vp, pt, lengths), 200, flush)
    plain_ms = _timed(lambda *a: pa.paged_decode_attention_plain(*a, **kw),
                      (q, kp, vp, pt, lengths), 50, flush)
    # yardstick: the same live tokens pre-gathered into a dense cache
    L = int(n.max())
    idx = pt.long()
    if quant is None:
        kg, vg = kp[idx], vp[idx]
    else:
        kg, vg = (kvq.dequant_pages(kvq.gather_rows(pool, idx), sc[idx],
                                    quant, out_dtype=q.dtype)
                  for pool, sc in ((kp, kw["k_scale"]), (vp, kw["v_scale"])))
    kd = kg.reshape(S, -1, KVH, D)[:, :L].permute(0, 2, 1, 3).contiguous()
    vd = vg.reshape(S, -1, KVH, D)[:, :L].permute(0, 2, 1, 3).contiguous()
    mask = (torch.arange(L, device=DEVICE)[None, :] < n[:, None])[:, None,
                                                                 None, :]
    q4 = q[:, :, None, :]

    def sdpa(q4, kd, vd, mask):
        return F.scaled_dot_product_attention(q4, kd, vd, attn_mask=mask)

    library_ms = _timed(sdpa, (q4, kd, vd, mask), 200, flush)
    # comparison launches are not the main path's
    pa.launches, pa.launches_quant = saved
    row = dict(K3 if quant is None else K3Q)
    row.update({"launches": launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms,
                "bound_ms": max(t_bytes, t_ops) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": library_ms})
    log("%s at a decode step with every slot busy: S=%d H=%d KVH=%d D=%d "
        "page=%d %s pools %s, %d live tokens, %.1f MB: %.4f ms (bound %.4f "
        "ms, %.1f%% of it; plain %.4f ms; sdpa %.4f ms); max|err| vs plain "
        "%.3g" % (name, S, H, KVH, D, page, str(q.dtype).split(".")[-1],
                  str(kp.dtype).split(".")[-1], tokens, nbytes / 1e6, ms,
                  row["bound_ms"], 100 * row["bound_ms"] / ms, plain_ms,
                  library_ms, err))
    return row, {"live_tokens": tokens, "bytes": nbytes, "flops": flops}


def k3_step_inputs(rng, S, lengths, quant_mode=None):
    """K3's inputs at the serving widths (H = KVH = HEADS, D = DIM / HEADS,
    bf16 q, PAGE) for S slots of the given lengths, with a page table
    wide enough for the longest and distinct pages (a permutation of the
    pool, as an engine allocates them), bf16 pools, or int8 pools with
    one scale group a page (``quant_mode="int8"``): (args, kwargs) of the
    wrapper."""
    import torch
    mp = -(-max(lengths) // PAGE)
    d = DIM // HEADS
    if quant_mode is None:
        args, kw = _pool_case(rng, S, mp, PAGE, HEADS, HEADS, d,
                              torch.bfloat16, lengths), {}
    else:
        args, kw = _quant_pool_case(rng, S, mp, 2 * S * mp, PAGE, HEADS,
                                    HEADS, d, torch.bfloat16, lengths,
                                    quant_mode, PAGE)
    pool = args[1].shape[0] - 1
    args[3] = torch.from_numpy(rng.permutation(pool)[:S * mp].reshape(
        S, mp).astype(np.int32)).to(DEVICE)
    return args, kw


def k3_long_timing():
    """K3 at long contexts, where the split matters most: LONG_SLOTS
    slots at LONG_TOKENS each (``k3_step_inputs``), checked and timed as
    ``k3_timing`` times the decode step (beside its bound, the plain
    version and SDPA over the same tokens); logged and reported, not a
    row of the kernels line."""
    rng = np.random.RandomState(SEED + 11)
    args, _ = k3_step_inputs(rng, LONG_SLOTS, [LONG_TOKENS] * LONG_SLOTS)
    row, shape = k3_timing(args, 0)
    log("K3 at long contexts (%d slots x %d tokens): %.4f ms, sdpa %.4f "
        "ms, bound %.4f ms" % (LONG_SLOTS, LONG_TOKENS, row["ms"],
                               row["library_ms"], row["bound_ms"]))
    return dict(row, launches=None, **shape)


def k3_ab_rows():
    """The K3 rows of ``--ab``: K3 and K3-quant (int8 pages) at a decode
    step with every slot busy — the served requests' prompts plus 44
    decoded tokens, ``k3_step_inputs`` — and K3 at long contexts
    (``k3_long_timing``, named ``..._long``). ``ab_timing`` runs this
    tree's source of these helpers in either tree, over that tree's
    kernels and ``k3_timing``."""
    rng = np.random.RandomState(SEED + 12)
    prompts, _ = _requests()
    lengths = [min(len(p) + 44, MAX_LEN) for p in prompts[:SLOTS]]
    rows = []
    for mode in (None, "int8"):
        args, kw = k3_step_inputs(rng, SLOTS, lengths, mode)
        rows.append(k3_timing(args, 0, kw)[0])
    row = k3_long_timing()
    return rows + [dict(row, name=row["name"] + "_long")]


def step_profile(engine, prompts, steps=20):
    """Where a decode step's time goes at 32 busy slots: host wall per
    step (unprofiled), device-busy time per step and K3's share of it
    (``torch.profiler``), and the device kernels taking the most time.
    Also returns copies of the K3 (K3-quant) inputs of layer 0 of one more
    step, as (args, kwargs), for ``k3_timing``."""
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
            captured.append(tuple(t.clone() for t in args))
            captured.append({k: v.clone() if hasattr(v, "clone") else v
                             for k, v in kw.items()})
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
    return out, captured


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
    quant = quant_runs(workdir, d16, prompts, budgets, run16)
    cap = capacity_runs(d16)
    launches += cap["runs"]["bf16"]["k3_launches"]
    prof, (step_args, _) = step_profile(run16["engine"], prompts)
    row, shape = k3_timing(step_args, launches)
    qprof, (qargs, qkw) = step_profile(quant["runs"]["int8"]["engine"],
                                       prompts)
    qrow, qshape = k3_timing(
        qargs, quant["launches"] + cap["runs"]["int8"]["k3_quant_launches"],
        qkw)
    # the fp8 engine's own decode-step inputs: checked, not timed
    fprof, (fargs, fkw) = step_profile(quant["runs"]["fp8"]["engine"],
                                       prompts)
    ferr = k3_check(fargs, fkw)
    log("K3-quant at the fp8 engine's decode step with every slot busy: "
        "max|err| vs plain %.3g" % ferr)
    streams = {label: [r["tokens"] for r in run["responses"]]
               for label, run in (("fp32", run32), ("bf16", run16),
                                  ("int8", quant["runs"]["int8"]),
                                  ("fp8", quant["runs"]["fp8"]))}
    return {"fp32": s32, "bf16": s16, "k3": row, "k3_step": shape,
            "bf16_step_profile": prof,
            "bf16_logit_rel_l2": rel, "bf16_argmax_agree": agree,
            "quant": quant["stats"], "capacity": cap, "k3_quant": qrow,
            "k3_quant_step": qshape, "int8_step_profile": qprof,
            "fp8_step_profile": fprof, "fp8_step_max_abs_err": ferr,
            # for phase 12 (main() drops them from the report)
            "_streams": streams, "_recompute": ref,
            "_dirs": {"fp32": d32, "bf16": d16}}


def match_fraction(ref, got):
    """Share of greedy tokens equal position by position (the reference's
    token-match measure)."""
    m = t = 0
    for a, b in zip(ref, got):
        n = min(len(a), len(b))
        t += n
        m += sum(int(x == y) for x, y in zip(a[:n], b[:n]))
    return m / max(t, 1)


def _prefill_logits(engine, prompts):
    """[len(prompts), vocab] fp32 prefill logits from an emptied engine,
    one prompt at a time in slot 0 (distinct prompts: nothing is mapped
    from the prefix cache)."""
    engine.reset()
    out = []
    for p in prompts:
        out.append(engine.prefill(0, p, max_new_tokens=1))
        engine.release(0)
    engine.reset()
    return np.stack(out)


def quant_runs(workdir, d16, prompts, budgets, run16):
    """The quantized serving runs: the bf16 decoder with int8 and with fp8
    KV pages, and the bf16 decoder written through
    ``quantize_decoder_dir(mode="int8")`` with int8 KV pages, each serving
    the same requests as the bf16 run. Gates (each raises): responses
    well formed and K3-quant = decode steps x layers with no K3 launch
    (``serve_run``); the prefill logits of 8 prompts within
    QUANT_LOGIT_REL_L2 of the unquantized bf16 engine's, finite. Recorded:
    argmax agreement, the greedy token match against the bf16 run beside
    the reference's 0.95 guard, TTFT, decode tokens/s, pages."""
    from paddle_tpu_torch.serving import quantize_decoder_dir
    dq = os.path.join(workdir, "bf16_weights_int8")
    quantize_decoder_dir(d16, dq, "int8")
    k = 8
    ref = _prefill_logits(run16["engine"], prompts[:k])
    ref_tokens = [r["tokens"] for r in run16["responses"]]
    runs, stats, launches = {}, {}, 0
    for label, mdir, mode in (("int8", d16, "int8"), ("fp8", d16, "fp8"),
                              ("weights_int8_kv_int8", dq, "int8")):
        run = serve_run(mdir, prompts, budgets, kv_quant_dtype=mode)
        launches += run["launches"]
        st = _serving_stats(run)
        got = _prefill_logits(run["engine"], prompts[:k])
        st["weight_quant"] = run["model"].weight_quant or "off"
        st["prefill_logit_rel_l2"] = float(np.linalg.norm(got - ref) /
                                           np.linalg.norm(ref))
        st["prefill_argmax_agree"] = int((got.argmax(-1) ==
                                          ref.argmax(-1)).sum())
        st["token_match_vs_bf16"] = match_fraction(
            ref_tokens, [r["tokens"] for r in run["responses"]])
        st["token_match_guard"] = TOKEN_MATCH_GUARD
        log("%s serving: %s" % (label, json.dumps(st)))
        log("  %s vs bf16: prefill logits rel L2 %.4g (limit %g), argmax "
            "agrees on %d/%d; greedy token match %.4f (the reference's "
            "guard %.2f, recorded only)"
            % (label, st["prefill_logit_rel_l2"], QUANT_LOGIT_REL_L2,
               st["prefill_argmax_agree"], k, st["token_match_vs_bf16"],
               TOKEN_MATCH_GUARD))
        if not (st["prefill_logit_rel_l2"] <= QUANT_LOGIT_REL_L2
                and np.isfinite(got).all()):
            raise AssertionError("%s prefill logits off the bf16 engine's: "
                                 "rel L2 %.4g" % (label,
                                                  st["prefill_logit_rel_l2"]))
        runs[label], stats[label] = run, st
    return {"runs": runs, "stats": stats, "launches": launches}


def _capacity_requests():
    """CAP_CLIENTS x CAP_PER_CLIENT seeded requests whose prompt + budget
    is CAP_TOKENS each (budgets CAP_NEW_TOKENS)."""
    rng = np.random.RandomState(SEED + 2)
    n = CAP_CLIENTS * CAP_PER_CLIENT
    budgets = rng.randint(CAP_NEW_TOKENS[0], CAP_NEW_TOKENS[1] + 1, size=n)
    prompts = [rng.randint(0, VOCAB, size=CAP_TOKENS - int(b)).astype(
        np.int32) for b in budgets]
    return prompts, [int(b) for b in budgets]


def capacity_runs(d16):
    """What quantized pages buy: admission at equal pool bytes. The bf16
    decoder on CAP_SLOTS slots serves the same requests twice: with bf16
    pages over the bf16 run's auto-sized pool, and with int8 pages over as
    many pages as those bytes hold (``equal_memory_pages``, scales
    counted). Gates (each raises): the int8 pool takes no more bytes than
    the bf16 pool; the most sequences decoding at once in the int8 run is
    at least ADMISSION_RATIO x the bf16 run's; responses well formed and
    the path's kernel = decode steps x layers (``serve_run``)."""
    from paddle_tpu_torch.ops import kv_quant as kvq
    prompts, budgets = _capacity_requests()
    dense_pages = -(-SLOTS * MAX_LEN // PAGE)
    q_pages = kvq.equal_memory_pages(dense_pages, PAGE, HEADS, DIM // HEADS,
                                     kvq.KVQuantConfig("int8", PAGE))
    stats = {}
    for label, mode, pages in (("bf16", "off", dense_pages),
                               ("int8", "int8", q_pages)):
        run = serve_run(d16, prompts, budgets, kv_quant_dtype=mode,
                        slots=CAP_SLOTS, num_pages=pages,
                        buckets=CAP_BUCKETS)
        stats[label] = _serving_stats(run)
        log("%s capacity serving (%d slots, %d pages): %s"
            % (label, CAP_SLOTS, pages, json.dumps(stats[label])))
        del run
    b, q = stats["bf16"], stats["int8"]
    ratio = q["peak_slots"] / b["peak_slots"]
    log("admission at equal pool bytes (%d requests of %d tokens' worst "
        "case): int8 pages %d sequences at once over %d pages (%.1f MB) "
        "against bf16's %d over %d pages (%.1f MB): %.3fx (limit %.2fx)"
        % (len(prompts), CAP_TOKENS, q["peak_slots"], q["kv_pages_total"],
           q["pool_bytes"] / 1e6, b["peak_slots"], b["kv_pages_total"],
           b["pool_bytes"] / 1e6, ratio, ADMISSION_RATIO))
    if q["pool_bytes"] > b["pool_bytes"]:
        raise AssertionError("int8 pool %d B > bf16 pool %d B"
                             % (q["pool_bytes"], b["pool_bytes"]))
    if ratio < ADMISSION_RATIO:
        raise AssertionError("int8 pages admitted %d sequences at once, "
                             "bf16 %d: %.3fx < %.2fx"
                             % (q["peak_slots"], b["peak_slots"], ratio,
                                ADMISSION_RATIO))
    return {"runs": stats, "admission_ratio": ratio}


# -- phase 12: megastep decoding -------------------------------------------

MEGASTEP_K = 8                 # the reference's auto value at MAX_LEN 1024
# (label, decoder, KV pages) of phase 12's runs: phase 4's pool dtypes
MS_RUNS = (("fp32", "fp32", "off"), ("bf16", "bf16", "off"),
           ("int8", "bf16", "int8"), ("fp8", "bf16", "fp8"))
MS_GATE_KS = (8, 8, 3)         # the engine gate: fresh, chained, fresh
MS_PROFILE_MEGASTEPS = 2       # megasteps of MEGASTEP_K trips timed (4
                               # until (d) came)


def ms_temperatures(n):
    """The engine gate's mixed cohort: greedy, 0.9, greedy, 0.7, ..."""
    return np.array([(0.0, 0.9, 0.0, 0.7)[i % 4] for i in range(n)],
                    np.float32)


def trip_gate(label, trip, variants, trips=None):
    """The megastep loop's accounting: on the card one capture and one
    warm-up trip per variant used (``variants`` of greedy, sampling), one
    launch of the loop graph per megastep and no eager trip; on the CPU
    every trip run eager and nothing captured or launched. Either way the
    trips run (the loop's body iterations) are at least one and at most
    the trips dispatched, and equal ``trips`` (the sum of the synced
    megasteps' trips) where the caller knows it. Raises otherwise."""
    cuda = DEVICE == "cuda"
    got = {"greedy": trip["captures_greedy"],
           "sampling": trip["captures_sampling"]}
    want = {v: int(cuda and v in variants) for v in got}
    runs = (trip["loop_launches"], trip["eager_trips"])
    want_runs = (trip["megasteps"], 0) if cuda else \
        (0, trip["iterations"])
    if got != want or trip["warmups"] != sum(want.values()) or \
            runs != want_runs or trip["megasteps"] <= 0 or \
            not 0 < trip["iterations"] <= trip["trips_dispatched"] or \
            (trips is not None and trip["iterations"] != trips):
        raise AssertionError(
            "%s: captures %s (want %s), warm-up trips %d, (loop launches, "
            "eager trips) %s for %d megasteps (want %s), %d trips run of "
            "%d dispatched (want %s)"
            % (label, got, want, trip["warmups"], runs, trip["megasteps"],
               want_runs, trip["iterations"], trip["trips_dispatched"],
               "1.." + str(trip["trips_dispatched"]) if trips is None
               else trips))


def k3_instance(key):
    """"k3_quant" for a profiled ``paged_decode_kernel`` instance over
    one-byte pages (int8 is ``signed char``), else "k3"."""
    return "k3_quant" if ("char" in key or "fp8" in key) else "k3"


def megastep_engine_gate(label, model_dir, kv_quant_dtype, prompts):
    """A megastep engine against the eager decode step, at full width on
    SLOTS busy slots: a greedy cohort and a mixed temperature cohort
    (``ms_temperatures``), each decoded ``sum(MS_GATE_KS)`` steps by
    ``decode_step`` on one engine and by megasteps of MS_GATE_KS trips
    (a fresh dispatch, one chained on its device outputs, a fresh one)
    on another. Gates (each raises): every stream, length and pending
    token identical; ``trip_gate``; the path's kernel launched
    ``launch_want`` of both engines and the other kernel never."""
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.serving import PagedDecodeEngine, load_decoder
    model, params = load_decoder(model_dir, device=DEVICE)
    prompts = prompts[:SLOTS]
    trips = sum(MS_GATE_KS)

    def engine():
        return PagedDecodeEngine(model, params, max_slots=SLOTS,
                                 max_len=MAX_LEN, prefill_buckets=BUCKETS,
                                 page_size=PAGE,
                                 kv_quant_dtype=kv_quant_dtype,
                                 megastep_k=MEGASTEP_K, device=DEVICE)
    ref_eng, ms_eng = engine(), engine()
    pa.launches = pa.launches_quant = 0
    t0 = time.perf_counter()
    out = {}
    for variant, temps in (("greedy", np.zeros(SLOTS, np.float32)),
                           ("sampling", ms_temperatures(SLOTS))):
        for i, p in enumerate(prompts):
            logits = ref_eng.prefill(i, p, max_new_tokens=trips + 2)
            first = int(np.argmax(logits))
            ms_eng.prefill(i, p, max_new_tokens=trips + 2)
            ref_eng.set_input_token(i, first)
            ms_eng.set_input_token(i, first)
        ref = [[] for _ in prompts]
        for t in range(trips):
            toks = ref_eng.decode_step(temps, seed=SEED, step=t)
            for i in range(len(prompts)):
                ref[i].append(int(toks[i]))
        k1, k2, k3 = MS_GATE_KS
        h1 = ms_eng.megastep_dispatch(SEED, 0, k1, temperatures=temps)
        h2 = ms_eng.megastep_dispatch(
            SEED, h1["step0"] + h1["trips"], k2, temperatures=temps,
            caps=h1["caps"] - h1["n_emitted"], live=h1["live"],
            tokens=h1["tokens"], lengths=h1["lengths"])
        rs = [ms_eng.megastep_sync(h1), ms_eng.megastep_sync(h2)]
        rs.append(ms_eng.megastep_decode(SEED, k1 + k2, k_eff=k3,
                                         temperatures=temps))
        got = [[int(t) for r in rs for t in r["out"][:, i] if t >= 0]
               for i in range(len(prompts))]
        same = sum(a == b for a, b in zip(got, ref))
        state_ok = bool((ms_eng.lengths == ref_eng.lengths).all() and
                        (ms_eng._in_tokens == ref_eng._in_tokens).all())
        out[variant] = {"identical": same, "of": len(prompts),
                        "trips": [r["trips"] for r in rs],
                        "host_state_equal": state_ok}
        if same != len(prompts) or not state_ok or \
                [r["trips"] for r in rs] != list(MS_GATE_KS):
            i = next((k for k in range(len(prompts)) if got[k] != ref[k]),
                     0)
            raise AssertionError(
                "%s megastep %s cohort: %d/%d streams equal decode_step's, "
                "host state equal %s, trips %s (stream %d: %s vs %s)"
                % (label, variant, same, len(prompts), state_ok,
                   [r["trips"] for r in rs], i, got[i][:8], ref[i][:8]))
        for i in range(len(prompts)):
            ref_eng.release(i)
            ms_eng.release(i)
    _sync()
    path, other = ("k3", "k3_quant") if kv_quant_dtype == "off" else \
        ("k3_quant", "k3")
    counts = {"k3": pa.launches, "k3_quant": pa.launches_quant}
    want = launch_want(ref_eng.trip_stats, model.n_layers) + \
        launch_want(ms_eng.trip_stats, model.n_layers)
    trip_gate(label + " engine gate", ms_eng.trip_stats,
              {"greedy", "sampling"},
              trips=sum(sum(c["trips"]) for c in out.values()))
    if counts[path] != want or counts[other]:
        raise AssertionError("%s engine gate: %s launches %d != %d, %s %d"
                             % (label, path, counts[path], want, other,
                                counts[other]))
    res = {"cohorts": out, "launches": counts[path],
           "trip_stats": dict(ms_eng.trip_stats),
           "seconds": time.perf_counter() - t0}
    log("%s megastep engine gate (%d slots, megasteps of %s trips against "
        "%d decode steps): greedy %d/%d and temperature %d/%d streams "
        "identical; %s launches %d = %d layers x trips and steps; %s"
        % (label, len(prompts), list(MS_GATE_KS), trips,
           out["greedy"]["identical"], len(prompts),
           out["sampling"]["identical"], len(prompts), path, counts[path],
           model.n_layers, json.dumps(res["trip_stats"])))
    return res


def k3_counts():
    """``(K3, K3-quant)`` launches so far: on the card as the kernel
    counts itself (``paged_attention.device_launches``, which sees every
    iteration of a megastep loop's body; it waits for the card), on the
    CPU the wrapper's counts."""
    from paddle_tpu_torch.ops import paged_attention as pa
    if DEVICE == "cuda":
        return pa.device_launches()
    return pa.launches, pa.launches_quant


def _k3_delta(before):
    after = k3_counts()
    return {"k3": after[0] - before[0], "k3_quant": after[1] - before[1]}


def _ms_timed(engine, dispatch):
    """``dispatch()`` (one ``megastep_dispatch``), synced: its result and
    its device ms on the megastep's stream by CUDA events, the state's
    copies in (None on the CPU). The start event waits behind a device
    sleep (SLEEP_CYCLES), so the host's dispatch work falls inside the
    sleep and the events time the device alone."""
    import torch
    if DEVICE != "cuda":
        return engine.megastep_sync(dispatch()), None
    stream = engine._ms.stream
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with torch.cuda.stream(stream):
        torch.cuda._sleep(SLEEP_CYCLES)
    ev[0].record(stream)
    h = dispatch()
    ev[1].record(stream)
    r = engine.megastep_sync(h)
    ev[1].synchronize()
    return r, ev[0].elapsed_time(ev[1])


def megastep_profile(engine, prompts, k1_profile=None):
    """Where a megastep's time goes at SLOTS busy slots: host wall ms a
    trip over MS_PROFILE_MEGASTEPS megasteps of MEGASTEP_K trips,
    dispatched and synced one by one and chained (each dispatched before
    the one before it is synced); the loop's device ms a trip over as
    many megasteps again (``_ms_timed``: CUDA events on the megastep's
    stream, its state copies in) against MEGASTEP_K replays of the
    captured trip graph on its own, as the loop's predecessor ran it
    (CUDA events); the device-busy ms a trip, K3's ms a trip and the top
    kernels from ``torch.profiler`` over MEGASTEP_K more such replays
    (eager trips on the CPU), and the idle share 1 - busy / wall. The loop itself is not
    profiled: CUPTI misses executions of a conditional body's nodes.
    Gate (raises): the pool's K3 instance, as the kernel counts itself
    (``k3_counts``), launched layers x trips times in the synced
    megasteps and in the replays, the other never. ``k1_profile`` is
    phase 4's decode step at the same pool dtype, for the log."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    n = min(len(prompts), engine.max_slots)
    K, M = MEGASTEP_K, MS_PROFILE_MEGASTEPS
    cuda = DEVICE == "cuda"
    layers = engine.model.n_layers
    path, other = ("k3", "k3_quant") if engine.kv_quant is None else \
        ("k3_quant", "k3")
    # a budget for 3M + 1 megasteps and 2K + 1 replayed trips
    for i, p in enumerate(prompts[:n]):
        engine.prefill(i, p, max_new_tokens=K * (3 * M + 3) + 4)
        engine.set_input_token(i, 1)
    step0 = [0]

    def dispatch():
        return engine.megastep_dispatch(SEED, step0[0], K)

    def chained(count):
        h = dispatch()
        for _ in range(count - 1):
            h2 = engine.megastep_dispatch(
                SEED, h["step0"] + h["trips"], K,
                caps=h["caps"] - h["n_emitted"], live=h["live"],
                tokens=h["tokens"], lengths=h["lengths"])
            step0[0] += engine.megastep_sync(h)["trips"]
            h = h2
        step0[0] += engine.megastep_sync(h)["trips"]

    step0[0] += engine.megastep_sync(dispatch())["trips"]
    m = engine._ms
    before = k3_counts()
    s0 = step0[0]
    t0 = time.perf_counter()
    for _ in range(M):
        step0[0] += engine.megastep_sync(dispatch())["trips"]
    _sync()
    trips = step0[0] - s0
    wall = (time.perf_counter() - t0) / trips * 1e3
    launched = _k3_delta(before)
    loop_ms, loop_trips = 0.0, 0
    for _ in range(M):
        r, ms = _ms_timed(engine, dispatch)
        step0[0] += r["trips"]
        loop_trips += r["trips"]
        loop_ms += ms or 0.0
    t0 = time.perf_counter()
    s0 = step0[0]
    chained(M)
    _sync()
    chained_wall = (time.perf_counter() - t0) / (step0[0] - s0) * 1e3

    # the trip alone: t back to 0, so the replays write rows 0..K-1 of
    # the token buffer; every slot stays live (its budget holds them)
    def restart():
        with torch.cuda.stream(m.stream) if cuda else \
                contextlib.nullcontext():
            m.v.t.zero_()

    def trip():
        if cuda:
            with torch.cuda.stream(m.stream):
                m.graphs[False][3].replay()
        else:
            with torch.no_grad():
                engine._ms_trip(False)
    trip_ms = None
    if cuda:
        restart()
        trip()                       # instantiates the trip's own graph
        restart()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        with torch.cuda.stream(m.stream):
            torch.cuda._sleep(SLEEP_CYCLES)
        ev[0].record(m.stream)
        for _ in range(K):
            trip()
        ev[1].record(m.stream)
        _sync()
        trip_ms = ev[0].elapsed_time(ev[1]) / K
    restart()
    _sync()
    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    before = k3_counts()
    with profile(activities=acts) as prof:
        for _ in range(K):
            trip()
        _sync()
    replayed = _k3_delta(before)
    for i in range(engine.max_slots):
        if engine.active[i]:
            engine.release(i)
    events = [e for e in prof.key_averages()
              if str(e.device_type) == "DeviceType.CUDA"
              and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / K / 1e3
    k3 = [e for e in events if "paged_decode_kernel" in e.key]
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:6]
    out = {"slots": n, "megastep_k": K, "trips": trips,
           "trip_wall_ms": wall, "chained_trip_wall_ms": chained_wall,
           "loop_ms": loop_ms / loop_trips if cuda else None,
           "trip_replay_ms": trip_ms, "device_busy_ms": busy,
           "device_idle_share": 1.0 - busy / wall,
           "chained_idle_share": 1.0 - busy / chained_wall,
           "k3_ms": sum(e.self_device_time_total for e in k3) / K / 1e3,
           "k3_launched": launched, "k3_replayed": replayed,
           "top_kernels_ms": {e.key[:60]: e.self_device_time_total
                              / K / 1e3 for e in top}}
    if k1_profile:
        out["k1_step_wall_ms"] = k1_profile["step_wall_ms"]
        out["k1_step_busy_ms"] = k1_profile["device_busy_ms"]
    for what, got, want in (("synced megasteps", launched, layers * trips),
                            ("replayed trips", replayed, layers * K)):
        if got != {path: want, other: 0}:
            raise AssertionError("megastep profile, %s: K3 / K3-quant "
                                 "launched %s, want %s %d and %s 0"
                                 % (what, got, path, want, other))
    log("megastep at %d busy slots, K=%d: %.3f ms wall a trip (chained "
        "%.3f), the loop %s ms a trip on the device against %s for the "
        "trip graph replayed alone (CUDA events); the trip %.3f ms "
        "device-busy (idle %.0f%%, chained %.0f%%), K3 %.3f ms a trip; %s "
        "launched %d in %d trips (the kernel's count); the K=1 step: %s; "
        "top: %s"
        % (n, K, wall, chained_wall,
           "%.3f" % out["loop_ms"] if cuda else "not measured",
           "%.3f" % trip_ms if cuda else "not measured", busy,
           100 * out["device_idle_share"], 100 * out["chained_idle_share"],
           out["k3_ms"], path, launched[path], trips,
           "%.3f ms wall, %.3f busy" % (k1_profile["step_wall_ms"],
                                         k1_profile["device_busy_ms"])
           if k1_profile else "not profiled",
           json.dumps(out["top_kernels_ms"])))
    return out


# phase 12 (d): the early exit, on bf16 and int8 pages
MS_EXIT_RUNS = (("bf16", "bf16", "off"), ("int8", "bf16", "int8"))
MS_EXIT_TRIPS = 2              # every slot freezes after this many trips
MS_LOOP = {"name": "megastep_loop", "route": "cuda",
           "source": "paddle_tpu_torch/csrc/megastep_loop.cu",
           "replaces": "paddle_tpu/serving/paged_kv.py:524"}


def _exit_engine(model, params, mode):
    from paddle_tpu_torch.serving import PagedDecodeEngine
    return PagedDecodeEngine(model, params, max_slots=SLOTS, max_len=MAX_LEN,
                             prefill_buckets=BUCKETS, page_size=PAGE,
                             kv_quant_dtype=mode, megastep_k=MEGASTEP_K,
                             device=DEVICE)


def _exit_fill(engine, prompts, first):
    for i, p in enumerate(prompts):
        engine.prefill(i, p, max_new_tokens=2 * MEGASTEP_K + 4)
        engine.set_input_token(i, first[i])


def _exit_megastep(engine, caps, eos_id, profiled=False):
    """One K = MEGASTEP_K megastep: its result, the loop's ms on the
    device (``_ms_timed``; host wall ms on the CPU) and the K3 / K3-quant
    launches the kernel itself counted on the card (``k3_counts``). With
    ``profiled``, under ``torch.profiler``, and also the device-busy ms
    and the paged-decode and condition kernels' records it names (the
    profiler may miss executions of the loop body's nodes)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if DEVICE == "cuda":
        acts.append(ProfilerActivity.CUDA)
    before = k3_counts()
    with profile(activities=acts) if profiled else \
            contextlib.nullcontext() as prof:
        t0 = time.perf_counter()
        r, ms = _ms_timed(engine, lambda: engine.megastep_dispatch(
            SEED, 0, MEGASTEP_K, caps=caps, eos_id=eos_id))
        _sync()
        wall = (time.perf_counter() - t0) * 1e3
    out = {"loop_ms": wall if ms is None else ms,
           "k3_launched": _k3_delta(before)}
    if profiled:
        # spin_kernel: _ms_timed's device sleep
        events = [e for e in prof.key_averages()
                  if str(e.device_type) == "DeviceType.CUDA"
                  and e.self_device_time_total > 0
                  and "spin_kernel" not in e.key]
        k3 = {}
        for e in events:
            if "paged_decode_kernel" in e.key:
                name = k3_instance(e.key)
                k3[name] = k3.get(name, 0) + e.count
        out.update(busy_ms=sum(e.self_device_time_total
                               for e in events) / 1e3, k3_profiled=k3,
                   cond_profiled=sum(e.count for e in events
                                     if "megastep_cond_kernel" in e.key))
    return r, out


def megastep_exit_gate(label, model_dir, mode, prompts, card_label=""):
    """Phase 12 (d): a K = MEGASTEP_K megastep whose SLOTS slots all
    freeze after MS_EXIT_TRIPS trips, by caps and, separately, by an EOS
    (every slot decoding one prompt whose stream's second token is the
    EOS), on ``mode`` pages. Gates (each raises): the loop's iteration
    count equals ``trips`` = MS_EXIT_TRIPS; the pool's K3 instance, as
    the kernel counts itself on the card, launched exactly layers x trips
    times in that megastep and the other never; the streams equal the K =
    1 decode steps'. Records the loop's ms (CUDA events) against a full
    MEGASTEP_K-trip megastep's, and, from one more caps megastep under
    ``torch.profiler``, what the profiler recorded, not gated: on the
    H100 (torch 2.11.0+cu128, NVIDIA 580.159.03) it records some but not
    all executions of the loop body's kernels, at times under another
    kernel's name, so its count and busy ms miss trips."""
    from paddle_tpu_torch.serving import load_decoder
    model, params = load_decoder(model_dir, device=DEVICE)
    prompts = prompts[:SLOTS]
    want_k3 = "k3" if mode == "off" else "k3_quant"
    ref_eng = _exit_engine(model, params, mode)
    first = [int(np.argmax(ref_eng.prefill(i, p, max_new_tokens=8)))
             for i, p in enumerate(prompts)]
    for i in range(len(prompts)):
        ref_eng.set_input_token(i, first[i])
    ref = np.stack([ref_eng.decode_step(seed=SEED, step=t)
                    for t in range(MS_EXIT_TRIPS)])
    # the EOS cohort: one prompt whose first two steps differ, in every slot
    k = next(i for i in range(len(prompts)) if ref[0, i] != ref[1, i])
    eos = int(ref[1, k])
    del ref_eng
    eng = _exit_engine(model, params, mode)
    _exit_fill(eng, prompts, first)
    eng.megastep_decode(SEED, 0, MEGASTEP_K)      # warm-up and capture
    res = {"pages": mode, "slots": len(prompts)}
    for case in ("caps", "eos", "full", "profiled"):
        for i in range(len(prompts)):
            eng.release(i)
        if case == "eos":
            _exit_fill(eng, [prompts[k]] * len(prompts),
                       [first[k]] * len(prompts))
        else:
            _exit_fill(eng, prompts, first)
        caps = None if case == "full" else np.full(SLOTS, MS_EXIT_TRIPS)
        r, prof = _exit_megastep(eng, caps, eos if case == "eos" else None,
                                 profiled=case == "profiled")
        want_trips = MEGASTEP_K if case == "full" else MS_EXIT_TRIPS
        want = ref[:, [k] * len(prompts)] if case == "eos" else ref
        streams_ok = bool((r["out"][:MS_EXIT_TRIPS] ==
                           want[:, :len(prompts)]).all())
        res[case] = dict(prof, trips=r["trips"],
                         iterations=r["iterations"],
                         streams_equal_k1=streams_ok)
        want_launched = {"k3": 0, "k3_quant": 0}
        want_launched[want_k3] = model.n_layers * want_trips
        if r["trips"] != want_trips or r["iterations"] != r["trips"] or \
                prof["k3_launched"] != want_launched or not streams_ok:
            raise AssertionError("phase 12 (d) %s %s: %s (want %d trips, "
                                 "%s launched, %s profiled)"
                                 % (label, case, json.dumps(res[case]),
                                    want_trips, want_launched, want_k3))
    res["exit_over_full"] = res["caps"]["loop_ms"] / res["full"]["loop_ms"]
    res["bound"] = _loop_row_inputs(eng, model)
    log("phase 12 (d) %s pages (%s): a K=%d megastep whose %d slots freeze "
        "after %d trips ran %d iterations (caps) and %d (EOS), %s launched "
        "%s on the card; the loop %.3f ms against %.3f ms for all %d trips "
        "(%.0f%%, CUDA events); under torch.profiler (not gated) the caps "
        "megastep's records name %s paged-decode launches and %d condition "
        "kernels, busy %.3f ms"
        % (label, card_label, MEGASTEP_K, len(prompts), MS_EXIT_TRIPS,
           res["caps"]["iterations"], res["eos"]["iterations"], want_k3,
           res["caps"]["k3_launched"][want_k3], res["caps"]["loop_ms"],
           res["full"]["loop_ms"], MEGASTEP_K, 100 * res["exit_over_full"],
           res["profiled"]["k3_profiled"], res["profiled"]["cond_profiled"],
           res["profiled"]["busy_ms"]))
    return res, eng, prompts, first


def _loop_row_inputs(engine, model):
    """The bytes one megastep must move once: the weights, the live
    slots' KV pages (and scales) at their lengths, the page table and the
    state vector."""
    import torch
    params = sum(t.numel() * t.element_size()
                 for t in _leaves(engine.params))
    page_bytes = engine._kp[0][0].numel() * engine._kp[0].element_size()
    if engine._ks is not None:
        page_bytes += engine._ks[0][0].numel() * 4
    pages = int(sum(-(-int(n) // PAGE) for n in engine.lengths
                    if n > 0))
    kv = 2 * model.n_layers * pages * page_bytes
    m = engine._ms
    small = (m.state.numel() * 8 + m.table.numel() * 4 +
             m.temps.numel() * 4)
    return {"param_bytes": params, "kv_bytes": kv, "state_bytes": small,
            "bytes": params + kv + small}


def _leaves(tree):
    import torch
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return []


def megastep_loop_row(engine, prompts, first, launches, card_label=""):
    """The megastep loop's kernel row: the loop graph (one launch) against
    its plain version (``megastep_loop.run_plain``: the eager trip and a
    host read of the condition a trip) on one engine's inputs, fresh
    prefills each; MS_EXIT_TRIPS trips by caps. ``max_abs_err`` over the
    whole state vector after the loop (tokens, lengths, flags, counts);
    bound: the bytes a megastep must move once (``_loop_row_inputs``)."""
    import torch
    from paddle_tpu_torch.ops import megastep_loop as ml
    from paddle_tpu_torch.ops import paged_attention as pa
    caps = np.full(SLOTS, MS_EXIT_TRIPS)
    counts = (pa.launches, pa.launches_quant, ml.launches["megastep_loop"])

    def fresh():
        for i in range(len(prompts)):
            engine.release(i)
        _exit_fill(engine, prompts, first)
        _sync()

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(engine._ms.stream):
            start.record()
            fn()
            end.record()
        _sync()
        return start.elapsed_time(end)

    fresh()
    args = {"tokens": engine._in_tokens, "lengths": engine.lengths,
            "live": engine.active.copy(), "caps": caps, "step0": 0,
            "seed": SEED, "eos": -1, "k_eff": MEGASTEP_K}
    temps = np.zeros(SLOTS, np.float32)
    m = engine._ms
    loop = m.graphs[False][0]
    engine._ms_load(m, args, temps)
    _sync()
    ms = timed(lambda: loop.launch(m.stream))
    got = m.state.clone()
    fresh()
    engine._ms_load(m, args, temps)
    _sync()
    plain_ms = timed(lambda: ml.run_plain(
        lambda: engine._ms_trip(False), m.state, m.off))
    err = float((got - m.state).abs().max())
    nbytes = _loop_row_inputs(engine, engine.model)["bytes"]
    fresh()
    pa.launches, pa.launches_quant, ml.launches["megastep_loop"] = counts
    for i in range(len(prompts)):
        engine.release(i)
    row = _timing_row(MS_LOOP, launches, err, ms, plain_ms, None, 0.0,
                      nbytes, BF16_FLOPS, "%d slots, %d of %d trips, %s"
                      % (len(prompts), MS_EXIT_TRIPS, MEGASTEP_K,
                         card_label))
    if err != 0 or launches <= 0:
        raise AssertionError("megastep loop row: %s" % json.dumps(row))
    return row


def megastep_path(phase4, card_label=""):
    """Phase 12: phase 4's serving path with ``megastep_k`` MEGASTEP_K,
    on fp32, bf16, int8 and fp8 pages. For each: the engine gate
    (``megastep_engine_gate``); the 48 requests served (``serve_run``,
    gates there and ``trip_gate``: one greedy capture, a replay per
    dispatched trip); fp32's streams must equal full recompute and phase
    4's K = 1 streams (48 of 48), the others' matches are recorded; then
    ``megastep_profile`` on the served engine. Logs each run beside phase
    4's K = 1 run of the same pages."""
    prompts, budgets = _requests()
    k1_stats = {"fp32": phase4["fp32"], "bf16": phase4["bf16"],
                "int8": phase4["quant"]["int8"],
                "fp8": phase4["quant"]["fp8"]}
    k1_profiles = {"bf16": phase4["bf16_step_profile"],
                   "int8": phase4["int8_step_profile"],
                   "fp8": phase4["fp8_step_profile"]}
    from paddle_tpu_torch.ops import megastep_loop as ml
    from paddle_tpu_torch.ops import paged_attention as pa
    loops0 = ml.launches["megastep_loop"]
    res = {"megastep_k": MEGASTEP_K, "gates": {}, "runs": {},
           "profiles": {}, "launches": {"k3": 0, "k3_quant": 0}}
    for label, dec, mode in MS_RUNS:
        mdir = phase4["_dirs"][dec]
        res["gates"][label] = megastep_engine_gate(label, mdir, mode,
                                                   prompts)
        run = serve_run(mdir, prompts, budgets, kv_quant_dtype=mode,
                        megastep_k=MEGASTEP_K)
        trip_gate(label + " served", run["trip_stats"], {"greedy"},
                  trips=sum(run["trips"]))
        st = _serving_stats(run)
        toks = [r["tokens"] for r in run["responses"]]
        st["streams_equal_k1"] = sum(
            a == b for a, b in zip(toks, phase4["_streams"][label]))
        if label == "fp32":
            st["streams_equal_recompute"] = sum(
                a == b for a, b in zip(toks, phase4["_recompute"]))
            if st["streams_equal_recompute"] != len(toks) or \
                    st["streams_equal_k1"] != len(toks):
                raise AssertionError(
                    "fp32 megastep streams: %d/%d equal full recompute, "
                    "%d/%d equal K=1" % (st["streams_equal_recompute"],
                                         len(toks), st["streams_equal_k1"],
                                         len(toks)))
        path = "k3" if mode == "off" else "k3_quant"
        res["launches"][path] += run["launches"]
        k1 = k1_stats[label]
        log("%s megastep serving (K=%d): %s" % (label, MEGASTEP_K,
                                                json.dumps(st)))
        log("  %s K=%d vs K=1 (phase 4): TTFT p50 %.1f / %.1f ms, p99 %.1f "
            "/ %.1f; TPOT p50 %.3f / %.3f ms; decode %.1f / %.1f tokens/s; "
            "host gap %.4f / %.4f ms a token; %d megasteps, trips %s; "
            "streams equal to K=1: %d/%d"
            % (label, MEGASTEP_K, st["ttft_ms_p50"], k1["ttft_ms_p50"],
               st["ttft_ms_p99"], k1["ttft_ms_p99"], st["tpot_ms_p50"],
               k1["tpot_ms_p50"], st["decode_tokens_per_s"],
               k1["decode_tokens_per_s"], st["host_gap_ms_per_token"],
               k1["host_gap_ms_per_token"], st["megasteps"],
               st["trips_histogram"], st["streams_equal_k1"], len(toks)))
        res["runs"][label] = st
        res["profiles"][label] = megastep_profile(
            run["engine"], prompts, k1_profiles.get(label))
        del run
    # (d) the early exit; its engines' K3 launches count as phase 12's
    res["exit"] = {}
    for label, dec, mode in MS_EXIT_RUNS:
        k0 = {"k3": pa.launches, "k3_quant": pa.launches_quant}
        res["exit"][label], eng, eprompts, first = megastep_exit_gate(
            label, phase4["_dirs"][dec], mode, prompts, card_label)
        res["exit"][label]["launches"] = {
            "k3": pa.launches - k0["k3"],
            "k3_quant": pa.launches_quant - k0["k3_quant"]}
        for name, n in res["exit"][label]["launches"].items():
            res["launches"][name] += n
        if label == "bf16":
            kept = (eng, eprompts, first)
        else:
            del eng
    res["loop_launches"] = ml.launches["megastep_loop"] - loops0
    if DEVICE == "cuda":
        res["loop_row"] = megastep_loop_row(
            *kept, res["loop_launches"], card_label)
    return res


# -- phase 14: speculative decoding, tenants, shedding ---------------------

SPEC_KS = (1, 4)               # the engine gates' draft lengths
# a gate stream's tokens (SLOTS prompts; 64 until phase 18 came, cut for
# the script's time limit)
SPEC_NEW_TOKENS = 48
DRAFT_LAYERS, DRAFT_SEED = 2, 1
SERVED_SPEC_K = 4              # serve --gen-speculative-k 4
# (label, target decoder, KV pages, gated) of the engine gates: fp32
# streams must equal plain greedy; the others' matches are recorded
SPEC_RUNS = (("fp32", "fp32", "off", True), ("bf16", "bf16", "off", False),
             ("int8", "bf16", "int8", False))
TENANT, TENANT_BUDGET, TENANT_WINDOW_S = "capped", 16, 0.25
# the shedding run's ladder: watermarks the 48 requests' pages cross, the
# controller's default dwell (a level a dwell, so level 3 from ~0.5 s),
# and the low requests' arrivals behind the high ones
SHED_HIGH, SHED_LOW, SHED_DWELL_S = 0.05, 0.02, 0.25
SHED_LEAD_S, SHED_SPACING_S = 0.25, 0.05


def draft_decoder(workdir):
    """The DRAFT_LAYERS-layer full-width draft from seed DRAFT_SEED,
    written with ``save_decoder`` (the gates read it with
    ``load_decoder``)."""
    from paddle_tpu_torch.serving import TransformerDecoderModel, \
        save_decoder
    m = TransformerDecoderModel(VOCAB, dim=DIM, n_heads=HEADS,
                                n_layers=DRAFT_LAYERS, ffn_mult=FFN_MULT)
    path = os.path.join(workdir, "draft")
    save_decoder(path, m, m.init_params(DRAFT_SEED, device="cpu"))
    return path


def truncation_loss(n, k, fallback):
    """Drafts a draft that agrees with the target every time still loses
    over ``n`` streams of SPEC_NEW_TOKENS tokens at draft length ``k``:
    such streams move in lock-step, so after the prefill's token each
    takes rounds of k until fewer than k tokens are left, and then either
    every stream takes one round truncated at its budget (the drafts past
    it are not accepted) or, where that round no longer fits the pages
    (``fallback`` synced steps), none does."""
    left = (SPEC_NEW_TOKENS - 1) % k
    return 0 if fallback or not left else n * (k - left)


def spec_engine_gate(label, target_dir, mode, drafts, prompts, gated):
    """``speculative_greedy_generate`` on the full-width target (KV pages
    in ``mode``) over SLOTS prompts, SPEC_NEW_TOKENS each, with every
    draft of ``drafts`` (label → decoder directory) at every k of
    SPEC_KS, against ``greedy_generate`` on the paged engine alone. Gates
    (each raises): K3 (K3-quant) launched exactly layers x the synced
    fallback steps and the other kernel never (the verify and the dense
    draft launch none); with ``gated``, every stream token-identical to
    plain greedy and the self-draft's accepted = drafted less the
    ``truncation_loss``. Drafted and accepted are the catalog's
    ``speculative_*_tokens_total``. Returns the per-run records and the
    launches."""
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.observability import catalog
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.serving import (DecodeEngine, PagedDecodeEngine,
                                          greedy_generate, load_decoder,
                                          speculative_greedy_generate)
    model, params = load_decoder(target_dir, device=DEVICE)

    def target(k):
        return PagedDecodeEngine(model, params, max_slots=SLOTS,
                                 max_len=MAX_LEN, prefill_buckets=BUCKETS,
                                 page_size=PAGE, speculative_k=k,
                                 kv_quant_dtype=mode, device=DEVICE)
    path, other = ("k3", "k3_quant") if mode == "off" else \
        ("k3_quant", "k3")
    pa.launches = pa.launches_quant = 0
    plain = greedy_generate(target(0), prompts, SPEC_NEW_TOKENS)
    _sync()
    launches = {"k3": pa.launches, "k3_quant": pa.launches_quant}
    out = {}
    for dlabel, ddir in drafts.items():
        dm, dp = load_decoder(ddir, device=DEVICE)
        for k in SPEC_KS:
            if mode != "off" and k != max(SPEC_KS):
                continue          # quantized pages: the widest k only
            eng = target(k)
            draft = DecodeEngine(dm, dp, max_slots=SLOTS, max_len=MAX_LEN,
                                 prefill_buckets=BUCKETS, device=DEVICE)
            pa.launches = pa.launches_quant = 0
            profiler.reset_counters()
            t0 = time.perf_counter()
            got = speculative_greedy_generate(eng, draft, prompts,
                                              SPEC_NEW_TOKENS)
            _sync()
            counts = {"k3": pa.launches, "k3_quant": pa.launches_quant}
            for name in launches:
                launches[name] += counts[name]
            fallback = eng.trip_stats["decode_steps"]
            rec = {"draft": dlabel, "k": k, "fallback_steps": fallback,
                   "drafted": int(catalog.SPECULATIVE_DRAFTED.value()),
                   "accepted": int(catalog.SPECULATIVE_ACCEPTED.value()),
                   "truncation_loss": truncation_loss(len(prompts), k,
                                                      fallback),
                   "streams_equal_plain": sum(
                       a == b for a, b in zip(got, plain)),
                   "match_vs_plain": match_fraction(plain, got),
                   "launches": counts[path],
                   "seconds": time.perf_counter() - t0}
            rec["acceptance_rate"] = rec["accepted"] / max(rec["drafted"], 1)
            out["%s_k%d" % (dlabel, k)] = rec
            log("%s speculative engine gate, %s draft, k=%d: %d/%d streams "
                "equal plain greedy (token match %.4f), drafted %d, "
                "accepted %d (%.3f; a perfect draft's truncation loss %d), "
                "%d synced fallback steps, %s launches %d, %.1f s"
                % (label, dlabel, k, rec["streams_equal_plain"],
                   len(prompts), rec["match_vs_plain"], rec["drafted"],
                   rec["accepted"], rec["acceptance_rate"],
                   rec["truncation_loss"], fallback, path, counts[path],
                   rec["seconds"]))
            if counts[path] != fallback * model.n_layers or counts[other]:
                raise AssertionError(
                    "%s %s k=%d: %s launches %d != %d layers x %d synced "
                    "fallback steps, or %s launched %d"
                    % (label, dlabel, k, path, counts[path], model.n_layers,
                       fallback, other, counts[other]))
            if gated and rec["streams_equal_plain"] != len(prompts):
                i = next(j for j in range(len(prompts))
                         if got[j] != plain[j])
                raise AssertionError(
                    "%s %s k=%d: stream %d differs from plain greedy (%s vs "
                    "%s)" % (label, dlabel, k, i, got[i][:8], plain[i][:8]))
            if gated and dlabel == "self" and (
                    not rec["drafted"] or rec["accepted"] !=
                    rec["drafted"] - rec["truncation_loss"]):
                raise AssertionError(
                    "%s self draft k=%d: accepted %d of %d drafted, not "
                    "all but the truncation loss %d"
                    % (label, k, rec["accepted"], rec["drafted"],
                       rec["truncation_loss"]))
            del eng, draft
    return out, launches


def _vs(label, st, k1, k8):
    log("  %s vs K=1 (phase 4) / K=8 (phase 12): TTFT p50 %.1f / %.1f / "
        "%.1f ms, p99 %.1f / %.1f / %.1f; TPOT p50 %.3f / %.3f / %.3f ms; "
        "decode %.1f / %.1f / %.1f tokens/s"
        % (label, st["ttft_ms_p50"], k1["ttft_ms_p50"], k8["ttft_ms_p50"],
           st["ttft_ms_p99"], k1["ttft_ms_p99"], k8["ttft_ms_p99"],
           st["tpot_ms_p50"], k1["tpot_ms_p50"], k8["tpot_ms_p50"],
           st["decode_tokens_per_s"], k1["decode_tokens_per_s"],
           k8["decode_tokens_per_s"]))


def spec_path(phase4, phase12, workdir):
    """Phase 14: speculative decoding, tenants, preemption and shedding,
    after phase 12 (phase 4's decoder files, requests, K = 1 streams and
    full recompute; phase 12's K = 8 run for comparison).

    (a) ``spec_engine_gate`` on the fp32 and bf16 targets and on bf16
    with int8 pages, drafts: the target itself and a DRAFT_LAYERS-layer
    full-width decoder from seed DRAFT_SEED. (b) Phase 4's 48 requests
    served over HTTP by the engines ``serve --gen-draft-model DRAFT
    --gen-speculative-k SERVED_SPEC_K`` builds, fp32, once with the
    2-layer draft and once with the target as its own draft (which must
    accept some drafts), then by the dense ``DecodeEngine`` that ``serve``
    builds by default (K3 launched never): 48 of 48 streams
    token-identical to full recompute in each. (c) The same requests, fp32,
    ``megastep_k`` MEGASTEP_K, every other one from tenant TENANT with a
    budget of TENANT_BUDGET tokens a TENANT_WINDOW_S window: at least one
    preemption to the held lane for the budget, every stream equal to
    full recompute, a resumed admission's prefill mapping >= 1 parked
    page. (d) Shedding: watermarks SHED_HIGH / SHED_LOW, every other
    request ``"priority": "low"``, the high ones sent first and the low
    ones spread behind them: no high request fails and each equals full
    recompute (its first FLAGS_shed_token_cap tokens where level 2
    clamped its budget); each low one does so or is answered 503 with
    Retry-After, at least one is shed, and ``requests_shed_total{class=
    "low"}`` equals the low 503s. Each gate raises. Returns the report
    and the K3 / K3-quant launches of the phase."""
    from paddle_tpu_torch.serving import BrownoutController
    t0 = time.perf_counter()
    prompts, budgets = _requests()
    ref = phase4["_recompute"]
    dirs = dict(phase4["_dirs"], draft=draft_decoder(workdir))
    res = {"engine_gates": {}, "launches": {"k3": 0, "k3_quant": 0}}
    for label, dec, mode, gated in SPEC_RUNS:
        gate, launches = spec_engine_gate(
            label, dirs[dec], mode, {"self": dirs[dec],
                                     "2-layer": dirs["draft"]},
            prompts[:SLOTS], gated)
        res["engine_gates"][label] = gate
        for name in launches:
            res["launches"][name] += launches[name]
    k1, k8 = phase4["fp32"], phase12["runs"]["fp32"]

    def served(label, run, want_all=True):
        st = _serving_stats(run)
        st["counters"] = run["counters"]
        toks = [r.get("tokens") for r in run["responses"]]
        st["streams_equal_recompute"] = sum(a == b for a, b in zip(toks, ref))
        res["launches"]["k3"] += run["counts"]["k3"]
        res["launches"]["k3_quant"] += run["counts"]["k3_quant"]
        log("%s: %s" % (label, json.dumps(st)))
        _vs(label, st, k1, k8)
        if want_all and st["streams_equal_recompute"] != len(toks):
            raise AssertionError("%s: %d/%d streams equal full recompute"
                                 % (label, st["streams_equal_recompute"],
                                    len(toks)))
        return st

    # (b) the served speculative runs: the 2-layer draft, then the target
    # as its own draft, whose rounds accept (several tokens a round, each
    # charged to its tenant, committed m > 1 at a time)
    for key, dlabel, ddir in (("served", "2-layer", dirs["draft"]),
                              ("served_self", "self", dirs["fp32"])):
        run = serve_run(dirs["fp32"], prompts, budgets, draft_dir=ddir,
                        speculative_k=SERVED_SPEC_K)
        st = served("fp32 speculative serving (%s draft, k=%d)"
                    % (dlabel, SERVED_SPEC_K), run)
        c = run["counters"]
        st["acceptance_rate"] = c["accepted"] / max(c["drafted"], 1)
        log("  drafted %d, accepted %d (rate %.4f), fallback steps by "
            "reason %s" % (c["drafted"], c["accepted"],
                           st["acceptance_rate"], json.dumps(c["fallback"])))
        if dlabel == "self" and not c["accepted"]:
            raise AssertionError("self-draft serving: accepted 0 of %d "
                                 "drafted" % c["drafted"])
        res[key] = st
        del run

    # serve's default engine (no --gen-paged, draft or KV quantization):
    # dense prefill and decode_cache_attention steps, no K3
    run = serve_run(dirs["fp32"], prompts, budgets, paged=False)
    res["served_dense"] = served("fp32 dense DecodeEngine serving (serve's "
                                 "default)", run)
    del run

    # (c) a token-budgeted tenant, preempted to the held lane
    extra = [({}, {"X-Tenant-Id": TENANT} if i % 2 == 0 else {})
             for i in range(len(prompts))]
    run = serve_run(dirs["fp32"], prompts, budgets, megastep_k=MEGASTEP_K,
                    extra=extra, sched_kw={
                        "tenant_token_budget_map": {TENANT: TENANT_BUDGET},
                        "tenant_budget_window_s": TENANT_WINDOW_S})
    st = served("fp32 tenant serving (%s: %d tokens a %.2f s window, K=%d)"
                % (TENANT, TENANT_BUDGET, TENANT_WINDOW_S, MEGASTEP_K), run)
    hits = [r["slo"].get("prefix_hit_pages", 0)
            for r, (_, h) in zip(run["responses"], extra) if h]
    st["capped_prefix_hit_pages_max"] = max(hits)
    st["capped_resumed"] = sum(1 for h in hits if h > 0)
    log("  preemptions to the held lane %s; %d capped requests resumed "
        "with parked pages (at most %d pages mapped)"
        % (json.dumps(run["counters"]["preempted"]), st["capped_resumed"],
           st["capped_prefix_hit_pages_max"]))
    if run["counters"]["preempted"]["budget"] < 1 or max(hits) < 1:
        raise AssertionError("tenant run: %s budget preemptions, a resumed "
                             "prefill mapped at most %d pages"
                             % (run["counters"]["preempted"]["budget"],
                                max(hits)))
    res["tenants"] = st
    del run

    # (d) shedding: the high half first, the low half spread behind it.
    # From level 2 the ladder clamps new admissions' budgets to
    # FLAGS_shed_token_cap: such a stream is full recompute's first
    # tokens, ending at the cap
    from paddle_tpu_torch.serving import resolve_fleet_knobs
    cap = resolve_fleet_knobs(which=("shed_token_cap",))["shed_token_cap"]
    low = [i % 2 == 1 for i in range(len(prompts))]
    extra = [({"priority": "low" if lo else "high"}, {}) for lo in low]
    delays = [SHED_LEAD_S + SHED_SPACING_S * (i // 2) if lo else 0.0
              for i, lo in enumerate(low)]
    run = serve_run(dirs["fp32"], prompts, budgets, extra=extra,
                    delays=delays, token_cap=cap,
                    sched_kw={"brownout": BrownoutController(
                        high=SHED_HIGH, low=SHED_LOW, dwell_s=SHED_DWELL_S)})
    st = served("fp32 shedding (watermarks %.2f / %.2f)"
                % (SHED_HIGH, SHED_LOW), run, want_all=False)
    rs = run["responses"]

    def identical(i):
        toks = rs[i].get("tokens")
        return toks is not None and toks == ref[i][:len(toks)] and \
            len(toks) in (len(ref[i]), cap)
    shed = [r for r, lo in zip(rs, low) if lo and r.get("status") == 503]
    bad_high = [i for i, lo in enumerate(low) if not lo and not identical(i)]
    bad_low = [i for i, lo in enumerate(low)
               if lo and rs[i].get("status") != 503 and not identical(i)]
    no_retry = [r for r in shed if not r.get("retry_after") or
                int(r["retry_after"]) < 1]
    st.update({"low_shed": len(shed), "low_served": sum(low) - len(shed),
               "high_served": len(rs) - sum(low) - len(bad_high),
               "clamped": sum(1 for i, r in enumerate(rs)
                              if len(r.get("tokens") or ()) == cap <
                              len(ref[i]))})
    log("  high %d/%d served identically; low: %d shed with Retry-After %s, "
        "%d served; %d streams clamped at %d tokens (level 2); "
        "requests_shed_total{class=\"low\"} %d; level at the end %d"
        % (st["high_served"], len(rs) - sum(low), len(shed),
           sorted({r.get("retry_after") for r in shed}), st["low_served"],
           st["clamped"], cap, run["counters"]["shed_low"],
           run["counters"]["brownout_level_end"]))
    if bad_high or bad_low or no_retry or not shed or \
            run["counters"]["shed_low"] != len(shed) or \
            run["counters"]["shed_high"]:
        raise AssertionError(
            "shedding: high failures %s, low streams off %s, shed without "
            "Retry-After %d, %d low shed (requests_shed_total low %d, high "
            "%d)" % (bad_high, bad_low, len(no_retry), len(shed),
                     run["counters"]["shed_low"],
                     run["counters"]["shed_high"]))
    res["shedding"] = st
    del run
    res["seconds"] = time.perf_counter() - t0
    return res


# -- phases 5-6: training -------------------------------------------------

def build_lm(fluid, layers, batch, seq, amp, mask=None, opt="Adam"):
    """bench_lm.py's program as the port's bench builds it
    (``benchmarks.lm._build_lm``) at LM_DIM, LM_HEADS, LM_VOCAB and
    ``layers``, with ``opt``(LM_LR); bf16 mixed precision when ``amp``.
    ``mask``: None, "packed" (a ``seg`` feed of segment ids, its
    ``packed_rows=True``) or "valid" (a ``valid`` padding feed, its
    padded baseline)."""
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.benchmarks import lm
    with unique_name.guard():
        prog, startup, loss = lm._build_lm(
            batch, seq, packed_rows=mask == "packed", valid=mask == "valid",
            layers=layers, d_model=LM_DIM, heads=LM_HEADS, vocab=LM_VOCAB,
            optimizer=getattr(fluid.optimizer, opt)(learning_rate=LM_LR),
            amp=amp)
    prog.random_seed = startup.random_seed = SEED
    return prog, startup, loss


def lm_feed(batch, seq):
    """bench_lm.py's feed as the port's bench makes it
    (``benchmarks.lm.dense_data``, at LM_VOCAB): ids from seed 0, labels
    the ids rolled by one."""
    from paddle_tpu_torch.benchmarks import lm
    return lm.dense_data(batch, seq, LM_VOCAB)


GATE_WEIGHT = "fc_0.w_0"       # layer 0's query projection


def _startup_state(startup):
    """name -> CPU tensor: ``startup`` run once on the CPU."""
    import paddle_tpu_torch as fluid
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    return {n: scope.find_var(n) for n in scope.local_var_names()}


def _steps_from(state, prog, loss, feed, place, steps):
    """``steps`` steps of ``prog`` on ``place`` from a copy of ``state``:
    the losses, the seconds they took and GATE_WEIGHT after them."""
    import paddle_tpu_torch as fluid
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    for n, t in state.items():
        scope.set_var(n, t.to(exe.device, copy=True))
    t0 = time.perf_counter()
    losses = [float(exe.run(prog, feed=feed, fetch_list=[loss],
                            scope=scope)[0]) for _ in range(steps)]
    return {"losses": losses, "s": time.perf_counter() - t0,
            "w": scope.find_var(GATE_WEIGHT).float().cpu()}


def _gate(label, runs, start):
    """Hold two runs from one state to each other: per-step losses within
    GATE_LOSS_RTOL relative, GATE_WEIGHT's update (from ``start``) within
    GATE_UPDATE_REL_L2 relative L2 of the second run's; raises past
    either or on a loss that is not finite."""
    (ta, a), (tb, b) = runs.items()
    rel = [abs(x - y) / abs(y) for x, y in zip(a["losses"], b["losses"])]
    upd_a, upd_b = a["w"] - start, b["w"] - start
    upd_rel = float((upd_a - upd_b).norm() / upd_b.norm())
    res = {"losses_" + ta: a["losses"], "losses_" + tb: b["losses"],
           "loss_rel_err": max(rel), "weight": GATE_WEIGHT,
           "update_rel_l2": upd_rel,
           "weight_max_abs_diff": float((a["w"] - b["w"]).abs().max()),
           ta + "_s": a["s"], tb + "_s": b["s"]}
    log("%s: %s" % (label, json.dumps(res)))
    if not (max(rel) <= GATE_LOSS_RTOL and upd_rel <= GATE_UPDATE_REL_L2
            and all(np.isfinite(a["losses"] + b["losses"]))):
        raise AssertionError("%s: %s and %s disagree: loss rel err %.3g "
                             "(limit %g), %s update rel L2 %.3g (limit %g)"
                             % (label, ta, tb, max(rel), GATE_LOSS_RTOL,
                                GATE_WEIGHT, upd_rel, GATE_UPDATE_REL_L2))
    return res


def _fp32():
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def train_gate():
    """fp32 card-vs-CPU gate: the 2-layer full-width LM from one initial
    state (the CPU startup's, copied to the card), 3 Adam steps on each;
    losses within GATE_LOSS_RTOL, the first attention projection's
    3-step update within GATE_UPDATE_REL_L2."""
    import paddle_tpu_torch as fluid
    _fp32()
    log("training gate: fp32, TF32 off for matmuls and cuDNN")
    prog, startup, loss = build_lm(fluid, GATE_LAYERS, GATE_BATCH,
                                   GATE_SEQ, amp=False)
    feed = lm_feed(GATE_BATCH, GATE_SEQ)
    state = _startup_state(startup)
    runs = {tag: _steps_from(state, prog, loss, feed, place, GATE_STEPS)
            for tag, place in (("card", fluid.CUDAPlace(0)),
                               ("cpu", fluid.CPUPlace()))}
    return _gate("training gate", runs, state[GATE_WEIGHT])


def capture_gc_gate():
    """Captures under the cyclic collector. CGC_DEAD executors each
    capture a CGC_LAYERS-layer LM step with ``FusedAdam`` (K4 keeps a
    pinned table with its graph); each ``_CapturedStep`` and its
    executor hold each other, so once dropped without ``close()`` only
    the collector frees them. They are dropped as the capture of an
    ``Adam`` step opens, and the collector is due at every allocation
    (threshold 1) until it ends. Gates: every capture ends, no
    collection starts inside a capture (``launch_count.Capture`` holds
    the collector off) and the dead executors are gone after one
    outside."""
    import gc
    import weakref
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import launch_count
    t0 = time.perf_counter()
    threshold = gc.get_threshold()
    real_enter, real_exit = (launch_count.Capture.__enter__,
                             launch_count.Capture.__exit__)
    held, dead = [], []
    seen = {"arm": False, "open": False, "inside": 0, "captures": 0}

    def enter(self):
        out = real_enter(self)
        seen["open"] = True
        seen["captures"] += 1
        if seen["arm"]:
            seen["arm"] = False
            held.clear()            # cycles from here on
            gc.set_threshold(1, 1, 1)
        return out

    def exit_(self, *exc):
        seen["open"] = False
        out = real_exit(self, *exc)
        gc.set_threshold(*threshold)
        return out

    def count(phase, info):
        if phase == "start" and seen["open"]:
            seen["inside"] += 1

    def step(opt):
        prog, startup, loss = build_lm(fluid, CGC_LAYERS, CGC_BATCH,
                                       CGC_SEQ, amp=False, opt=opt)
        exe = fluid.Executor(fluid.CUDAPlace(0))
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        (lv,) = exe.run_steps(prog, feed=lm_feed(CGC_BATCH, CGC_SEQ),
                              n_steps=2, fetch_list=[loss], scope=scope)
        return exe, float(np.asarray(lv).reshape(-1)[0])

    launch_count.Capture.__enter__ = enter
    launch_count.Capture.__exit__ = exit_
    gc.callbacks.append(count)
    try:
        for _ in range(CGC_DEAD):
            exe, _loss = step("FusedAdam")
            held.append(exe)
            dead.append(weakref.ref(exe))
            del exe
        seen["arm"] = True
        exe, loss = step("Adam")
        exe.close()
    finally:
        gc.callbacks.remove(count)
        launch_count.Capture.__enter__ = real_enter
        launch_count.Capture.__exit__ = real_exit
        gc.set_threshold(*threshold)
        held.clear()
    gc.collect()
    res = {"dead_executors": CGC_DEAD, "captures": seen["captures"],
           "collections_inside": seen["inside"],
           "collected_after": sum(r() is None for r in dead), "loss": loss,
           "seconds": time.perf_counter() - t0}
    log("captures under the collector: %s" % json.dumps(res))
    want = CGC_DEAD + 1 if DEVICE == "cuda" else 0
    if res["collections_inside"] or res["captures"] != want or \
            res["collected_after"] != CGC_DEAD or not math.isfinite(loss):
        raise AssertionError("captures under the collector: %s"
                             % json.dumps(res))
    return res


# the flash kernels share their bodies (csrc/flash_kernels.cuh, the
# tensor-core bodies in csrc/flash_mma.cuh): a profiler row's template
# arguments <T, D, BK, kMask, kBhsd> name its kernel
_FLASH_KERNEL = re.compile(
    r"flash_(fwd|bwd_dq|bwd_dkv)(_mma)?_kernel<[^<>]*, (\d), "
    r"(true|false)>")


def flash_class(key):
    """"k1" (K1, K1-dense), "k2", "k5" or "k6" (K6-fwd, its dense
    instantiation, K6-dQ, K6-dKV) for a profiler kernel name, else
    None."""
    m = _FLASH_KERNEL.search(key)
    if m is None:
        return None
    if m.group(4) == "true":
        return "k6"
    if m.group(3) == "1":
        return "k5"
    return "k1" if m.group(1) == "fwd" else "k2"


def flash_bodies(names):
    """The flash bodies among profiler kernel names: a set of (role —
    "fwd", "bwd_dq" or "bwd_dkv" —, "mma" for a tensor-core body or
    "cuda-core", layout — "bhsd" or "bshd" —, mask kind digit)."""
    out = set()
    for key in names:
        m = _FLASH_KERNEL.search(key)
        if m:
            out.add((m.group(1), "mma" if m.group(2) else "cuda-core",
                     "bhsd" if m.group(4) == "true" else "bshd",
                     int(m.group(3))))
    return out


def body_gate(label, names, want):
    """The flash bodies that the profiler saw (``flash_bodies`` of
    ``names``) are exactly ``want``; raises otherwise. On CPU tensors no
    kernel runs and nothing is checked."""
    log("%s, profiled flash kernels: %s" % (label, json.dumps(sorted(names))))
    if DEVICE != "cuda":
        return
    seen = flash_bodies(names)
    if seen != set(want):
        raise AssertionError("%s: the profile shows the flash bodies %s, "
                             "want %s" % (label, sorted(seen), sorted(want)))


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
    k1, k2, k5, k6 = (ms(lambda k, c=c: flash_class(k) == c)
                      for c in ("k1", "k2", "k5", "k6"))
    gemm = ms(lambda k: any(t in k.lower() for t in
                            ("gemm", "nvjet", "xmma", "cutlass")))
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    flash = {e.key: e.self_device_time_total / steps / 1e3 for e in events
             if flash_class(e.key) is not None}
    ops = _op_ranges(averages, steps)
    generic = [t[:-len("_grad")] for t, info in OP_REGISTRY.items()
               if info.generic_grad and t in ops]
    return {"device_busy_ms": busy, "k1_ms": k1, "k2_ms": k2, "k5_ms": k5,
            "k6_ms": k6, "gemm_ms": gemm,
            "other_ms": busy - k1 - k2 - k5 - k6 - gemm,
            "top_kernels_ms": {e.key[:70]: e.self_device_time_total
                               / steps / 1e3 for e in top},
            "flash_kernels_ms": flash,
            "ops_host_ms": sum(o["host_ms"] for o in ops.values()),
            "ops": dict(sorted(ops.items(),
                               key=lambda kv: -kv[1]["host_ms"])),
            "generic_vjp_recompute_ms": sum(ops[t]["device_ms"]
                                            for t in generic if t in ops)}


def _op_ranges(averages, steps):
    """Per op type, the host ms, device ms and calls per step of the
    executor's ranges (``trace_ops``) in a profile's averages."""
    from paddle_tpu_torch.registry import OP_REGISTRY
    return {e.key: {"host_ms": e.cpu_time_total / steps / 1e3,
                    "device_ms": e.device_time_total / steps / 1e3,
                    "calls": e.count // steps}
            for e in averages if e.key in OP_REGISTRY
            and str(e.device_type) == "DeviceType.CPU"}


def _train_steps(exe, prog, feed, loss, steps):
    """``steps`` steps through Executor.run (each ends in the loss fetch,
    a sync); the losses and the host ms of each step."""
    losses, step_ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(exe.run(prog, feed=feed, fetch_list=[loss])[0]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return losses, step_ms


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
        losses, step_ms = _train_steps(exe, prog, feed, loss, LM_STEPS)
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
                             for k in ("k1", "k2", "k5", "gemm", "other")}
    log("training %dL-%dd b%d s%d bf16, %d params: %s"
        % (LM_LAYERS, LM_DIM, LM_BATCH, LM_SEQ, n_params, json.dumps(res)))
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError("training loss not finite and falling: %s"
                             % losses)
    if any(launches[n] != want for n in K1K2) or \
            any(launches[n] for n in K5):
        raise AssertionError("flash launches %s: K1/K2 != steps %d x "
                             "layers %d or K5 launched"
                             % (launches, LM_STEPS, LM_LAYERS))
    body_gate("training path", res["flash_kernels_ms"], TRAIN_BODIES)
    return res


def flash_timing(launches, seg_ids=None):
    """K1, K2-dQ and K2-dKV at the training step's attention shape (b16
    s1024 h8 d64 bf16 causal) — or, given the packed step's segment map
    ``seg_ids``, K5-fwd, K5-dQ and K5-dKV at that shape and map — each
    call timed alone with L2 flushed, beside its bound (the work of the
    visible pairs only), its plain version and SDPA, the library
    yardstick (causal, or under the dense [b, 1, s, s] segment mask;
    forward, and its autograd backward)."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import flash_attention as fa
    b, s, h, d = LM_BATCH, LM_SEQ, LM_HEADS, LM_DIM // LM_HEADS
    packed = seg_ids is not None
    rng = np.random.RandomState(SEED + (6 if packed else 3))
    q, k, v, do, _ = _flash_case(rng, b, s, h, h, d, torch.bfloat16, False)
    seg = _segments(seg_ids) if packed else None
    saved = dict(fa.launches)
    errs, ok, _ = _flash_check(q, k, v, do, None, True, seg)
    if not ok:
        raise AssertionError("%s kernels disagree with their plain versions "
                             "at the step's shape: %s"
                             % ("segment" if packed else "flash", errs))
    (fwd, dq_fn, dkv_fn, fwd_plain, bwd_plain), tail = \
        _flash_api(True, seg=seg)
    o, lse = fwd(q, k, v, *tail)
    delta = (do.float() * o.float()).sum(-1)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device=DEVICE)
    ms = {"fwd": _timed(fwd, (q, k, v) + tail, 20, flush),
          "dq": _timed(dq_fn, (q, k, v, do, lse, delta) + tail, 20, flush),
          "dkv": _timed(dkv_fn, (q, k, v, do, lse, delta) + tail, 20,
                        flush)}
    plain = {"fwd": _timed(fwd_plain, (q, k, v) + tail, 5, flush),
             "bwd": _timed(bwd_plain, (q, k, v, o, lse, do) + tail, 5,
                           flush)}
    sdpa = {"is_causal": True}
    if packed:
        sdpa = {"attn_mask": ((seg.q[:, :, None] == seg.kv[:, None, :]) &
                              torch.ones(s, s, dtype=torch.bool,
                                         device=DEVICE).tril())[:, None]}
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    lib_fwd = _timed(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, **sdpa), (), 20, flush)
    out = F.scaled_dot_product_attention(qt, kt, vt, **sdpa)
    g = do.transpose(1, 2)
    lib_bwd = _timed(lambda: torch.autograd.grad(out, (qt, kt, vt), g,
                                                 retain_graph=True),
                     (), 20, flush)
    fa.launches.update(saved)   # comparison launches are not the path's
    # bound: the larger of the visible pairs' work at the bf16 tensor-core
    # rate and each input read once plus each output written once
    pairs = h * visible_pairs(seg_ids if packed else np.zeros((b, s)))
    act = b * s * h * d * 2                   # one bf16 [b, s, h, d]
    lse_b, delta_b = b * h * s * 8 * 4, b * s * h * 4
    seg_b = 2 * b * s * 4 if packed else 0
    work = {"fwd": (4 * d * pairs, 4 * act + lse_b + seg_b),
            "dq": (6 * d * pairs, 5 * act + lse_b + delta_b + seg_b),
            "dkv": (8 * d * pairs, 6 * act + lse_b + delta_b + seg_b)}
    shape = "b%d s%d h%d d%d bf16 causal" % (b, s, h, d)
    if packed:
        shape += ", %d visible pairs" % pairs
    rows = [_timing_row(base, launches[base["name"]], err, ms[key],
                        plain[key if key == "fwd" else "bwd"], lib,
                        *work[key], BF16_FLOPS, shape)
            for key, base, err, lib in (
                ("fwd", K5_FWD if packed else K1, errs["o"], lib_fwd),
                ("dq", K5_DQ if packed else K2_DQ, errs["dq"], lib_bwd),
                ("dkv", K5_DKV if packed else K2_DKV,
                 max(errs["dk"], errs["dv"]), lib_bwd))]
    log("%s %.4f ms vs SDPA%s fwd+bwd %.4f ms"
        % ("K5 fwd+bwd" if packed else "flash K1+K2",
           ms["fwd"] + ms["dq"] + ms["dkv"],
           " (dense mask)" if packed else "", lib_fwd + lib_bwd))
    return rows


def _timing_row(base, launches, err, ms, plain_ms, library_ms, flops,
                nbytes, peak_flops, shape):
    """One kernel's line of the report: its time beside its bound (the
    larger of ``flops`` at ``peak_flops`` and ``nbytes`` at the memory
    rate), its plain version's and the library call's."""
    t_ops, t_bytes = flops / peak_flops, nbytes / HBM_BYTES_PER_S
    row = dict(base)
    row.update({"launches": launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes) * 1e3,
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": library_ms, "gflop": flops / 1e9,
                "mb": nbytes / 1e6})
    log("%s at %s: %.4f ms (bound %.4f ms by %s, %.1f%% of it; plain %.4f "
        "ms; library %s ms); %.2f GFLOP %.1f MB; max|err| vs plain %.3g"
        % (base["name"], shape, ms, row["bound_ms"], row["bound_by"],
           100 * row["bound_ms"] / ms, plain_ms,
           "%.4f" % library_ms if library_ms is not None else "-",
           flops / 1e9, nbytes / 1e6, err))
    return row


# -- phases 7-8: packed documents, fused Adam -----------------------------

def packed_data(batch, seq):
    """bench_lm.py packed_main's data as the port's bench makes it
    (``benchmarks.lm.packed_data``, at LM_VOCAB): the packed rows with
    segment ids and next-token labels, and the padded baseline, the
    documents of those rows one per row under a ``valid`` mask; with the
    real-token counts and the documents' geometry."""
    from paddle_tpu_torch.benchmarks import lm
    packed, base, real_packed, real_base, docs = lm.packed_data(
        batch, seq, LM_VOCAB)
    return {"packed": packed, "baseline": base,
            "real_packed": real_packed, "real_baseline": real_base,
            "docs": len(docs), "doc_lengths": [len(d) for d in docs],
            "segments_per_row": [int(r.max()) + 1 for r in packed["seg"]]}


def visible_pairs(seg, causal=True):
    """(q, k) pairs one head can see under segment ids ``seg`` [b, s]."""
    total = 0
    for row in np.asarray(seg):
        n = np.unique(row, return_counts=True)[1].astype(np.int64)
        total += int((n * (n + 1) // 2).sum() if causal else (n * n).sum())
    return total


def _p50(step_ms):
    return float(np.percentile(step_ms[1:], 50))


def packed_path(data):
    """Phase 7: bench_lm.py's packed step at full size — LM_STEPS steps
    with the launch counts set to 0 just before and read just after (K5
    x steps x layers, no K1/K2), a profiled window (its flash bodies
    exactly PACKED_BODIES), then the padded
    baseline through K1/K2 for BASE_STEPS steps, then ALTERNATE_ROUNDS
    packed and baseline steps in turns, whose p50s give
    ``speedup_vs_padded_ragged``. Returns the report and the packed run's
    scope (phase 8 starts from it)."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import flash_attention as fa
    prog, startup, loss = build_lm(fluid, LM_LAYERS, LM_BATCH, LM_SEQ,
                                   amp=True, mask="packed")
    feed = data["packed"]
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        for name in fa.launches:
            fa.launches[name] = 0      # counts from here are the main path's
        losses, step_ms = _train_steps(exe, prog, feed, loss, LM_STEPS)
        launches = dict(fa.launches)
        prof = _profile_steps(exe, prog, feed, loss, LM_PROFILE_STEPS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 \
        if DEVICE == "cuda" else None
    want = LM_STEPS * LM_LAYERS
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError("packed training loss not finite and falling: "
                             "%s" % losses)
    if any(launches[n] != want for n in K5) or \
            any(launches[n] for n in K1K2):
        raise AssertionError("packed path launches %s: K5 != steps %d x "
                             "layers %d or K1/K2 launched"
                             % (launches, LM_STEPS, LM_LAYERS))
    body_gate("packed path", prof["flash_kernels_ms"], PACKED_BODIES)

    # the padded baseline: the same documents one per row, K1/K2
    nb = data["baseline"]["ids"].shape[0]
    bprog, bstartup, bloss = build_lm(fluid, LM_LAYERS, nb, LM_SEQ,
                                      amp=True, mask="valid")
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    base_scope = fluid.Scope()
    with fluid.scope_guard(base_scope):
        exe.run(bstartup)
        for name in fa.launches:
            fa.launches[name] = 0
        base_losses, base_ms = _train_steps(exe, bprog, data["baseline"],
                                            bloss, BASE_STEPS)
        base_launches = dict(fa.launches)
    base_peak_gb = torch.cuda.max_memory_allocated() / 1e9 \
        if DEVICE == "cuda" else None
    turns = {"packed": [], "baseline": []}
    for _ in range(ALTERNATE_ROUNDS):
        for tag, sc, args in (("packed", scope, (prog, feed, loss)),
                              ("baseline", base_scope,
                               (bprog, data["baseline"], bloss))):
            with fluid.scope_guard(sc):
                turns[tag] += _train_steps(exe, *args, 1)[1]
    del base_scope
    if not all(np.isfinite(base_losses)) or \
            any(base_launches[n] != BASE_STEPS * LM_LAYERS for n in K1K2) \
            or any(base_launches[n] for n in K5):
        raise AssertionError("padded baseline: losses %s, launches %s"
                             % (base_losses, base_launches))
    p50, base_p50 = _p50(step_ms), _p50(base_ms)
    tok_s = data["real_packed"] / (p50 / 1e3)
    base_tok_s = data["real_baseline"] / (base_p50 / 1e3)
    turns_p50 = {tag: float(np.percentile(ms, 50))
                 for tag, ms in turns.items()}
    turns_tok_s = {"packed": data["real_packed"] / turns_p50["packed"],
                   "baseline": data["real_baseline"] /
                   turns_p50["baseline"]}
    res = {"losses": losses, "step_ms": step_ms, "step_ms_p50": p50,
           "real_tokens_packed": data["real_packed"],
           "real_tokens_per_s": tok_s, "launches": launches,
           "peak_memory_gb": peak_gb,
           "pack_occupancy": data["real_packed"] / float(LM_BATCH * LM_SEQ),
           "docs": data["docs"],
           "segments_per_row": data["segments_per_row"],
           "visible_pairs_per_head": visible_pairs(data["packed"]["seg"]),
           "baseline": {"rows": nb, "losses": base_losses,
                        "step_ms": base_ms, "step_ms_p50": base_p50,
                        "real_tokens": data["real_baseline"],
                        "real_tokens_per_s": base_tok_s,
                        "launches": base_launches,
                        "peak_memory_gb": base_peak_gb},
           "pad_waste_baseline": 1.0 - data["real_baseline"] /
           float(nb * LM_SEQ),
           "alternating_step_ms": turns,
           "alternating_step_ms_p50": turns_p50,
           "speedup_vs_padded_ragged": turns_tok_s["packed"] /
           turns_tok_s["baseline"]}
    res.update(prof)
    res["device_idle_share"] = 1.0 - prof["device_busy_ms"] / p50
    busy = prof["device_busy_ms"] or float("nan")
    res["shares_of_busy"] = {k: prof[k + "_ms"] / busy
                             for k in ("k5", "gemm", "other")}
    log("packed training %dL-%dd %d rows x %d bf16: %s"
        % (LM_LAYERS, LM_DIM, LM_BATCH, LM_SEQ, json.dumps(res)))
    log("packed vs padded, steps in turns: %s" % json.dumps({
        "real_tokens_per_s": {k: v * 1e3 for k, v in turns_tok_s.items()},
        "speedup_vs_padded_ragged": res["speedup_vs_padded_ragged"],
        "pack_occupancy": res["pack_occupancy"],
        "pad_waste_baseline": res["pad_waste_baseline"],
        "device_busy_ms": res["device_busy_ms"],
        "device_idle_share": res["device_idle_share"],
        "k5_share_of_busy": res["shares_of_busy"]["k5"]}))
    return res, scope


def _persistable_ulps(names, a, b):
    """name -> max ulp distance of scope ``a``'s value from ``b``'s."""
    return {n: _max_ulps(a.find_var(n).float(), b.find_var(n).float())
            for n in names}


def fused_adam_path(data, packed_scope, packed_res):
    """Phase 8: the packed program under FusedAdamOptimizer. One step
    from phase 7's state against one Adam step (deterministic kernels, so
    both compute the same gradients): every parameter and moment within
    ADAM_MAX_ULPS. Then LM_STEPS steps with the K4 count set to 0 just
    before (one launch per step), and a profiled window."""
    import warnings
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops import fused_adam as pfa
    feed = data["packed"]
    adam = build_lm(fluid, LM_LAYERS, LM_BATCH, LM_SEQ, amp=True,
                    mask="packed")
    fused = build_lm(fluid, LM_LAYERS, LM_BATCH, LM_SEQ, amp=True,
                     mask="packed", opt="FusedAdam")
    types = [op.type for op in fused[0].global_block().ops]
    if types.count("fused_adam") != 1 or "adam" in types:
        raise AssertionError("FusedAdam built %d fused_adam and %d adam ops"
                             % (types.count("fused_adam"),
                                types.count("adam")))
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scopes = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for tag, (prog, _, loss) in (("adam", adam), ("fused", fused)):
                sc = fluid.Scope()
                for n in packed_scope.local_var_names():
                    sc.set_var(n, packed_scope.find_var(n).clone())
                exe.run(prog, feed=feed, fetch_list=[loss], scope=sc)
                scopes[tag] = sc
        finally:
            torch.use_deterministic_algorithms(False)
    names = sorted(v.name for v in fused[0].list_vars()
                   if v.persistable and "_moment" in v.name) + \
        sorted(p.name for p in fused[0].global_block().all_parameters())
    ulps = _persistable_ulps(names, scopes["fused"], scopes["adam"])
    worst = max(ulps, key=ulps.get)
    one_step = {"tensors": len(names), "max_ulps": ulps[worst],
                "worst": worst,
                "bitwise": sum(1 for u in ulps.values() if u == 0)}
    log("FusedAdam vs Adam, one step from the packed state: %s"
        % json.dumps(one_step))
    if ulps[worst] > ADAM_MAX_ULPS:
        raise AssertionError("FusedAdam step off the Adam step by %g ulp "
                             "in %s" % (ulps[worst], worst))
    prog, _, loss = fused
    with fluid.scope_guard(scopes["fused"]):
        pfa.launches["fused_adam"] = 0  # counts from here are the path's
        losses, step_ms = _train_steps(exe, prog, feed, loss, LM_STEPS)
        launches = pfa.launches["fused_adam"]
        prof = _profile_steps(exe, prog, feed, loss, LM_PROFILE_STEPS)
    # the two optimizers' steps in turns, each on its own state
    turns = {"adam": [], "fused": []}
    for _ in range(ALTERNATE_ROUNDS):
        for tag, (tprog, _, tloss) in (("adam", adam), ("fused", fused)):
            with fluid.scope_guard(scopes[tag]):
                turns[tag] += _train_steps(exe, tprog, feed, tloss, 1)[1]
    with fluid.scope_guard(scopes["fused"]):
        captured = captured_rounds(
            "FusedAdam packed program", exe, prog, feed, loss,
            dict({n: LM_LAYERS for n in K5}, fused_adam=1), _p50(step_ms))
    del scopes
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError("FusedAdam loss not finite and falling: %s"
                             % losses)
    if launches != LM_STEPS:
        raise AssertionError("K4 launches %d != steps %d"
                             % (launches, LM_STEPS))
    adam_ops = packed_res["ops"].get("adam", {})
    res = {"one_step_vs_adam": one_step, "losses": losses,
           "step_ms": step_ms, "step_ms_p50": _p50(step_ms),
           "adam_step_ms_p50": packed_res["step_ms_p50"],
           "alternating_step_ms": turns,
           "alternating_step_ms_p50": {
               tag: float(np.percentile(ms, 50)) for tag, ms in turns.items()},
           "launches": launches,
           "adam_ops_host_ms": adam_ops.get("host_ms"),
           "adam_ops_calls": adam_ops.get("calls"),
           "fused_adam_op_host_ms": prof["ops"]["fused_adam"]["host_ms"],
           "fused_adam_op_device_ms": prof["ops"]["fused_adam"]["device_ms"],
           "device_busy_ms": prof["device_busy_ms"],
           "ops_host_ms": prof["ops_host_ms"], "captured": captured,
           "param_shapes": [list(p.shape) for p in
                            fused[0].global_block().all_parameters()]}
    log("FusedAdam packed training: %s" % json.dumps(
        {k: v for k, v in res.items()
         if k not in ("param_shapes", "captured")}))
    return res


def fused_adam_timing(shapes, launches):
    """K4 over tensors of the LM's parameter shapes (fp32), timed with
    L2 flushed, beside its bound (28 bytes per element), its plain version
    and ``torch._fused_adam_`` over the same tensors (a yardstick for
    time only: it places epsilon differently)."""
    import torch
    from paddle_tpu_torch.ops import fused_adam as pfa
    sizes = [int(np.prod(sh)) for sh in shapes]
    ins = _adam_state(sizes, SEED + 7, DEVICE)
    saved = dict(pfa.launches)
    ulps, err = _k4_against_plain(ins, 0.0)
    if ulps > ADAM_MAX_ULPS:
        raise AssertionError("K4 off its plain version by %g ulp" % ulps)
    args = _k4_args(ins, 0.0)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device=DEVICE)
    ms = _timed(pfa.fused_adam_update, args, 20, flush)
    plain_ms = _timed(pfa.fused_adam_update_plain, args, 5, flush)
    lib = [[t.clone() for t in ins[k]]
           for k in ("Param", "Grad", "Moment1", "Moment2")]
    steps = [torch.tensor(3.0, device=DEVICE) for _ in sizes]
    lib_ms = _timed(lambda: torch._fused_adam_(
        *lib, [], steps, lr=1e-4, beta1=0.9, beta2=0.999, weight_decay=0.0,
        eps=1e-8, amsgrad=False, maximize=False), (), 20, flush)
    pfa.launches.update(saved)
    n = sum(sizes)
    row = _timing_row(K4, launches, err, ms, plain_ms, lib_ms, 13 * n,
                      28 * n, FP32_FLOPS,
                      "%d fp32 parameters in %d tensors" % (n, len(sizes)))
    row["max_ulps"] = ulps
    return row


# -- phases 9-10: the per-head (bhsd) layout and dense masks --------------

def _attention_block(fluid, x, heads, layout, mask, causal):
    """``models/transformer.py``'s attention block with the op's layout
    followed: the q/k/v ``fc``s, ``reshape`` to [n, t, h, hd], for bhsd a
    ``transpose`` to [n, h, t, hd], one ``fused_attention`` op (layout
    left at its "bhsd" default, or "bshd"; ``mask`` wired as its Mask
    input), back to [n, t, d] and the output ``fc``."""
    L = fluid.layers
    n, t, d = x.shape
    hd = d // heads
    q, k, v = [L.fc(input=x, size=d, num_flatten_dims=2, bias_attr=True)
               for _ in range(3)]
    q, k, v = [L.reshape(y, [n, t, heads, hd]) for y in (q, k, v)]
    attrs = {"causal": causal, "scale": 1.0 / float(np.sqrt(hd))}
    if layout == "bhsd":
        q, k, v = [L.transpose(y, perm=[0, 2, 1, 3]) for y in (q, k, v)]
    else:
        attrs["layout"] = layout
    helper = fluid.layer_helper.LayerHelper("fused_attention")
    out = helper.create_tmp_variable(dtype=x.dtype)
    lse = helper.create_tmp_variable(dtype="float32")
    lse.stop_gradient = True
    inputs = {"Q": [q], "K": [k], "V": [v]}
    if mask is not None:
        inputs["Mask"] = [mask]
    helper.append_op(type="fused_attention", inputs=inputs,
                     outputs={"Out": [out], "Lse": [lse]}, attrs=attrs)
    if layout == "bhsd":
        out = L.transpose(out, perm=[0, 2, 1, 3])
    return L.fc(input=L.reshape(out, [n, t, d]), size=d, num_flatten_dims=2,
                bias_attr=True)


def build_lm_layout(fluid, layout, mask_kind, layers=None, batch=None,
                    seq=None, amp=True, vocab=None, dim=None, heads=None,
                    lr=None):
    """The flagship LM as ``models/transformer.py transformer_lm`` builds
    it (pre-LN blocks, tanh-gelu FFN 4x, learned positions), with each
    layer's attention in ``layout`` (``_attention_block``), under
    ``mask_kind``: "none" (causal) or "prefix" (a ``mask`` feed [batch,
    1, seq, seq] bool, not causal: ``prefix_mask``). Softmax
    cross-entropy on the next token, mean, ``Adam(lr)``; bf16 mixed
    precision when ``amp``. ``fluid`` is either package (``paddle_tpu``
    or ``paddle_tpu_torch``): one source defines the program in both, and
    its parameters are named as ``transformer_lm``'s. Widths default to
    the LM_* constants."""
    layers = LM_LAYERS if layers is None else layers
    batch = LM_BATCH if batch is None else batch
    seq = LM_SEQ if seq is None else seq
    vocab = LM_VOCAB if vocab is None else vocab
    dim = LM_DIM if dim is None else dim
    heads = LM_HEADS if heads is None else heads
    lr = LM_LR if lr is None else lr
    L = fluid.layers
    with fluid.unique_name.guard():
        prog, startup = fluid.Program(), fluid.Program()
        prog.random_seed = startup.random_seed = SEED
        with fluid.program_guard(prog, startup):
            ids = L.data(name="ids", shape=[batch, seq], dtype="int64",
                         append_batch_size=False)
            labels = L.data(name="labels", shape=[batch, seq],
                            dtype="int64", append_batch_size=False)
            mask = L.data(name="mask", shape=[batch, 1, seq, seq],
                          dtype="bool", append_batch_size=False) \
                if mask_kind == "prefix" else None
            tok = L.embedding(input=ids, size=[vocab, dim])
            helper = fluid.layer_helper.LayerHelper("transformer_pos")
            pos_table = helper.create_parameter(None, [seq, dim], "float32")
            pos = L.slice(pos_table, axes=[0], starts=[0], ends=[seq])
            x = L.elementwise_add(x=tok, y=pos, axis=1)
            for _ in range(layers):
                ln1 = L.layer_norm(x, begin_norm_axis=2)
                x = L.elementwise_add(x=x, y=_attention_block(
                    fluid, ln1, heads, layout, mask, mask is None))
                ln2 = L.layer_norm(x, begin_norm_axis=2)
                ffn = L.fc(input=ln2, size=dim * 4, num_flatten_dims=2,
                           act={"type": "gelu", "approximate": True})
                x = L.elementwise_add(x=x, y=L.fc(input=ffn, size=dim,
                                                  num_flatten_dims=2))
            x = L.layer_norm(x, begin_norm_axis=2)
            logits = L.fc(input=x, size=vocab, num_flatten_dims=2)
            loss = L.mean(L.softmax_with_cross_entropy(
                L.reshape(logits, [batch * seq, vocab]),
                L.reshape(labels, [batch * seq, 1])))
            fluid.optimizer.Adam(learning_rate=lr).minimize(loss)
        fluid.enable_mixed_precision(prog, amp)
    return prog, startup, loss


def prefix_mask(batch, seq):
    """The prefix-LM mask feed [batch, 1, seq, seq] bool (UniLM, T5's
    prefix-LM objective: the prompt attends bidirectionally):
    ``mask[b, 0, i, j] = j <= i or j < p_b``, each row's prefix p_b drawn
    from [seq/8, 7 seq/8] ([128, 896] at 1024) by RandomState(SEED)."""
    rng = np.random.RandomState(SEED)
    p = rng.randint(seq // 8, seq * 7 // 8 + 1, size=batch)
    i = np.arange(seq)
    m = (i[None, None, :] <= i[None, :, None]) | \
        (i[None, None, :] < p[:, None, None])
    return m[:, None]


def _launch_gate(label, launches, want):
    """Each kernel of ``want`` (name -> count) launched exactly that often
    and every other flash kernel never; raises otherwise."""
    bad = {n: launches[n] for n in FLASH_KERNELS
           if launches[n] != want.get(n, 0)}
    if bad:
        raise AssertionError("%s: flash launches %s, want %s and no other"
                             % (label, bad, want))


def _train_run(fluid, exe, prog, startup, feed, loss, steps):
    """A fresh scope, startup, then ``steps`` steps with the flash launch
    counts set to 0 just before and read just after, then a profiled
    window; (report, scope)."""
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        for name in fa.launches:
            fa.launches[name] = 0      # counts from here are the main path's
        losses, step_ms = _train_steps(exe, prog, feed, loss, steps)
        launches = dict(fa.launches)
        prof = _profile_steps(exe, prog, feed, loss, LM_PROFILE_STEPS)
    p50 = _p50(step_ms)
    res = {"losses": losses, "step_ms": step_ms, "step_ms_p50": p50,
           "tokens_per_s": LM_BATCH * LM_SEQ / (p50 / 1e3),
           "launches": launches,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9
           if DEVICE == "cuda" else None}
    res.update(prof)
    res["device_idle_share"] = 1.0 - prof["device_busy_ms"] / p50
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError("training loss not finite and falling: %s"
                             % losses)
    return res, scope


def layout_gate():
    """The layout-parity gate, fp32 with TF32 off, on the card: the
    2-layer full-width bhsd program (``build_lm_layout``) and phase 6's
    bshd program (``build_lm``) from one state on one feed, 3 Adam steps
    each; losses within GATE_LOSS_RTOL, GATE_WEIGHT's update within
    GATE_UPDATE_REL_L2."""
    import paddle_tpu_torch as fluid
    _fp32()
    feed = lm_feed(GATE_BATCH, GATE_SEQ)
    bhsd = build_lm_layout(fluid, "bhsd", "none", GATE_LAYERS, GATE_BATCH,
                           GATE_SEQ, amp=False)
    bshd = build_lm(fluid, GATE_LAYERS, GATE_BATCH, GATE_SEQ, amp=False)
    state = _startup_state(bshd[1])
    runs = {tag: _steps_from(state, prog, loss, feed, fluid.CUDAPlace(0),
                             GATE_STEPS)
            for tag, (prog, _, loss) in (("bhsd", bhsd), ("bshd", bshd))}
    return _gate("layout-parity gate (bhsd vs bshd, card)", runs,
                 state[GATE_WEIGHT])


def bhsd_path():
    """Phase 9: the LM with per-head (bhsd) attention at full size (the
    transposes and the op's default layout; causal, no mask): the
    layout-parity gate, then LM_STEPS steps (K6-fwd, K6-dQ, K6-dKV each
    steps x 12 launches, no other flash kernel; loss finite and falling),
    a profiled window, then ALTERNATE_ROUNDS steps in turns with phase
    6's bshd program, whose p50s give ``step_ratio_vs_bshd``."""
    import paddle_tpu_torch as fluid
    gate = layout_gate()
    feed = lm_feed(LM_BATCH, LM_SEQ)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    prog, startup, loss = build_lm_layout(fluid, "bhsd", "none", amp=True)
    res, scope = _train_run(fluid, exe, prog, startup, feed, loss, LM_STEPS)
    _launch_gate("bhsd path", res["launches"],
                 {n: LM_STEPS * LM_LAYERS for n in K6})
    body_gate("bhsd path", res["flash_kernels_ms"], BHSD_BODIES)
    bprog, bstartup, bloss = build_lm(fluid, LM_LAYERS, LM_BATCH, LM_SEQ,
                                      amp=True)
    bscope = fluid.Scope()
    with fluid.scope_guard(bscope):
        exe.run(bstartup)
        _train_steps(exe, bprog, feed, bloss, 1)
    turns = {"bhsd": [], "bshd": []}
    for _ in range(ALTERNATE_ROUNDS):
        for tag, sc, args in (("bhsd", scope, (prog, feed, loss)),
                              ("bshd", bscope, (bprog, feed, bloss))):
            with fluid.scope_guard(sc):
                turns[tag] += _train_steps(exe, *args, 1)[1]
    del bscope
    with fluid.scope_guard(scope):
        res["captured"] = captured_rounds(
            "bhsd program", exe, prog, feed, loss,
            {n: LM_LAYERS for n in K6}, res["step_ms_p50"])
    del scope
    p50 = {tag: float(np.percentile(ms, 50)) for tag, ms in turns.items()}
    res.update({"layout_gate": gate, "alternating_step_ms": turns,
                "alternating_step_ms_p50": p50,
                "step_ratio_vs_bshd": p50["bhsd"] / p50["bshd"]})
    busy = res["device_busy_ms"] or float("nan")
    res["shares_of_busy"] = {k: res[k + "_ms"] / busy
                             for k in ("k6", "gemm", "other")}
    log("bhsd training %dL-%dd b%d s%d bf16: %s"
        % (LM_LAYERS, LM_DIM, LM_BATCH, LM_SEQ, json.dumps(
            {k: v for k, v in res.items() if k not in ("ops", "captured")})))
    return res


def dense_gate():
    """Phase 10's fp32 gates (TF32 off, 2 layers, full width, the prefix
    mask): programs 2 (bhsd) and 3 (bshd) each card against CPU from one
    state, 3 Adam steps; then their first-step losses on the card within
    GATE_LOSS_RTOL of each other (they compute one function)."""
    import paddle_tpu_torch as fluid
    _fp32()
    feed = dict(lm_feed(GATE_BATCH, GATE_SEQ),
                mask=prefix_mask(GATE_BATCH, GATE_SEQ))
    out, first = {}, {}
    state = None
    for layout in ("bhsd", "bshd"):
        prog, startup, loss = build_lm_layout(
            fluid, layout, "prefix", GATE_LAYERS, GATE_BATCH, GATE_SEQ,
            amp=False)
        state = state or _startup_state(startup)
        runs = {tag: _steps_from(state, prog, loss, feed, place, GATE_STEPS)
                for tag, place in (("card", fluid.CUDAPlace(0)),
                                   ("cpu", fluid.CPUPlace()))}
        first[layout] = runs["card"]["losses"][0]
        out[layout] = _gate("dense-mask %s gate (card vs CPU)" % layout,
                            runs, state[GATE_WEIGHT])
    rel = abs(first["bhsd"] - first["bshd"]) / abs(first["bshd"])
    out["first_loss_bhsd_vs_bshd_rel_err"] = rel
    log("dense-mask programs 2 and 3, first-step loss on the card: %.9g vs "
        "%.9g, rel err %.3g (limit %g)" % (first["bhsd"], first["bshd"], rel,
                                          GATE_LOSS_RTOL))
    if not rel <= GATE_LOSS_RTOL:
        raise AssertionError("dense-mask bhsd and bshd programs disagree: "
                             "first-step loss rel err %.3g" % rel)
    return out


def dense_path():
    """Phase 10: the prefix-LM mask at full size (``prefix_mask`` [16, 1,
    1024, 1024], not causal): the fp32 gates (``dense_gate``), then
    program 2 (bhsd: K6-fwd-dense steps x 12, the backward recomputed
    through the plain composition) and program 3 (bshd: K1-dense steps x
    12) for DENSE_STEPS steps each — no other flash kernel, K6-dQ/dKV and
    K2-dQ/dKV above all; loss finite and falling — with a profiled
    window (its flash bodies exactly DENSE_BODIES of the layout) and the
    peak memory."""
    import paddle_tpu_torch as fluid
    gate = dense_gate()
    mask = prefix_mask(LM_BATCH, LM_SEQ)
    feed = dict(lm_feed(LM_BATCH, LM_SEQ), mask=mask)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    res = {"gate": gate, "visible_pairs_per_head": int(mask.sum()),
           "visible_share": float(mask.mean())}
    for layout, kernel in (("bhsd", "flash_bhsd_fwd_dense"),
                           ("bshd", "flash_fwd_dense")):
        prog, startup, loss = build_lm_layout(fluid, layout, "prefix",
                                              amp=True)
        run, scope = _train_run(fluid, exe, prog, startup, feed, loss,
                                DENSE_STEPS)
        with fluid.scope_guard(scope):
            run["captured"] = captured_rounds(
                "dense-mask %s program" % layout, exe, prog, feed, loss,
                {kernel: LM_LAYERS}, run["step_ms_p50"])
        del scope
        _launch_gate("dense-mask %s path" % layout, run["launches"],
                     {kernel: DENSE_STEPS * LM_LAYERS})
        body_gate("dense-mask %s path" % layout, run["flash_kernels_ms"],
                  DENSE_BODIES[layout])
        log("dense-mask %s training %dL-%dd b%d s%d bf16: %s"
            % (layout, LM_LAYERS, LM_DIM, LM_BATCH, LM_SEQ, json.dumps(
                {k: v for k, v in run.items()
                 if k not in ("ops", "captured")})))
        res[layout] = run
    return res


def _fp64_floor_ms(b, h, s, d, causal, products):
    """The least time of the fp64 products (S; S and dP in the backward:
    ``products``) that K6's tensor-core bodies run over the 64 x 64
    tiles they visit — the causal triangle's, or every tile (no tile is
    skipped under a dense mask) — at the FP64 tensor cores' rate."""
    n = -(-s // 64)
    tiles = n * (n + 1) // 2 if causal else n * n
    return products * 2 * d * b * h * tiles * 64 * 64 / FP64_TC_FLOPS * 1e3


def layout_timing(bhsd_launches, dense_res):
    """K6-fwd, K6-dQ and K6-dKV at phase 9's attention (b16 s1024 h8 d64
    bf16 causal, bhsd), K6-fwd-dense and K1-dense at phase 10's (the
    prefix mask, not causal), each checked against its plain version at
    that shape, then timed alone with L2 flushed beside its bound (the
    visible pairs' work; the mask's bytes counted once), its plain
    version and SDPA in its native [b, h, s, d] layout (``is_causal``, or
    the same bool ``attn_mask``; for K6-dQ/dKV its autograd backward; the
    bshd inputs' transposes made outside the timed window). The floor of
    K6's fp64 sums is logged by kernel name; it is worked out, not
    measured, so it stays out of the rows."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import flash_attention as fa
    b, s, h, d = LM_BATCH, LM_SEQ, LM_HEADS, LM_DIM // LM_HEADS
    rng = np.random.RandomState(SEED + 12)
    q, k, v, do, _ = _flash_case(rng, b, s, h, h, d, torch.bfloat16, False)
    qh, kh, vh, doh = _bhsd(q, k, v, do)
    mask = torch.from_numpy(prefix_mask(b, s)).to(DEVICE)
    saved = dict(fa.launches)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device=DEVICE)
    act = b * s * h * d * 2                   # one bf16 [b, h, s, d]
    lse_b, delta_b = b * h * s * 8 * 4, b * s * h * 4
    rows = []

    # K6: causal, no mask
    errs, ok, _ = _flash_check(qh, kh, vh, doh, None, True, layout="bhsd")
    if not ok:
        raise AssertionError("K6 disagrees with its plain versions at the "
                             "bhsd step's shape: %s" % errs)
    (fwd, dq_fn, dkv_fn, fwd_plain, bwd_plain), tail = \
        _flash_api(True, layout="bhsd")
    o, lse = fwd(qh, kh, vh, *tail)
    delta = (doh.float() * o.float()).sum(-1)
    ms = {"fwd": _timed(fwd, (qh, kh, vh) + tail, 20, flush),
          "dq": _timed(dq_fn, (qh, kh, vh, doh, lse, delta) + tail, 20,
                       flush),
          "dkv": _timed(dkv_fn, (qh, kh, vh, doh, lse, delta) + tail, 20,
                        flush)}
    plain = {"fwd": _timed(fwd_plain, (qh, kh, vh) + tail, 5, flush),
             "bwd": _timed(bwd_plain, (qh, kh, vh, o, lse, doh) + tail, 5,
                           flush)}
    qt, kt, vt = (x.detach().requires_grad_() for x in (qh, kh, vh))
    lib_fwd = _timed(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), (), 20, flush)
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    lib_bwd = _timed(lambda: torch.autograd.grad(out, (qt, kt, vt), doh,
                                                 retain_graph=True),
                     (), 20, flush)
    pairs = h * visible_pairs(np.zeros((b, s)))
    work = {"fwd": (4 * d * pairs, 4 * act + lse_b),
            "dq": (6 * d * pairs, 5 * act + lse_b + delta_b),
            "dkv": (8 * d * pairs, 6 * act + lse_b + delta_b)}
    shape = "b%d h%d s%d d%d bf16 causal (bhsd)" % (b, h, s, d)
    rows += [_timing_row(base, bhsd_launches[base["name"]], err, ms[key],
                         plain[key if key == "fwd" else "bwd"], lib,
                         *work[key], BF16_FLOPS, shape)
             for key, base, err, lib in (
                 ("fwd", K6_FWD, errs["o"], lib_fwd),
                 ("dq", K6_DQ, errs["dq"], lib_bwd),
                 ("dkv", K6_DKV, max(errs["dk"], errs["dv"]), lib_bwd))]

    # the dense prefix mask: K6-fwd-dense (bhsd) and K1-dense (bshd)
    pairs = h * int(mask.sum())
    lib = _timed(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask), (), 20, flush)
    for base, layout, args in ((K6_FWD_DENSE, "bhsd", (qh, kh, vh)),
                               (K1_DENSE, "bshd", (q, k, v))):
        errs, ok, _ = _flash_check(*args, None, None, False, mask=mask,
                                   layout=layout)
        if not ok:
            raise AssertionError("%s disagrees with its plain version at the "
                                 "prefix-LM step's shape: %s"
                                 % (base["name"], errs))
        (fwd, _, _, fwd_plain, _), tail = _flash_api(False, mask=mask,
                                                     layout=layout)
        rows.append(_timing_row(
            base, dense_res[layout]["launches"][base["name"]], errs["o"],
            _timed(fwd, args + tail, 20, flush),
            _timed(fwd_plain, args + tail, 5, flush), lib, 4 * d * pairs,
            4 * act + lse_b + mask.numel(), BF16_FLOPS,
            "b%d s%d h%d d%d bf16 %s, prefix mask [%d, 1, %d, %d], %d "
            "visible pairs" % (b, s, h, d, layout, b, s, s, pairs)))
    fa.launches.update(saved)   # comparison launches are not the path's
    log("K6 fp64 floors (ms): %s" % json.dumps(
        {base["name"]: _fp64_floor_ms(b, h, s, d, causal, products)
         for base, causal, products in ((K6_FWD, True, 1), (K6_DQ, True, 2),
                                        (K6_DKV, True, 2),
                                        (K6_FWD_DENSE, False, 1))}))
    log("K6 fwd+bwd %.4f ms vs SDPA fwd+bwd %.4f ms; dense fwd: K6 %.4f, "
        "K1-dense %.4f vs SDPA %.4f ms"
        % (ms["fwd"] + ms["dq"] + ms["dkv"], lib_fwd + lib_bwd,
           rows[3]["ms"], rows[4]["ms"], lib))
    return rows


# one A/B run: the timing functions of the chip_smoke.py in the current
# directory, with every launch count at 0, and the K3 rows of this tree's
# K3_AB source (its constants and helpers, run over that tree's kernels)
# -- phase 11: ResNet training ---------------------------------------------

# bench.py's ResNet step (bench.py:36-121): resnet_imagenet(depth=50) in
# NHWC, batch 256 of 224x224 images, 1000 classes, bf16 mixed precision,
# Momentum(0.01, 0.9), timed through run_steps. The one cut: 5 steps a
# dispatch (25 until phase 16 came, 10 until phases 12 (d) and 19 (c)
# came) and one warm-up dispatch, against bench.py's 100 x 3, so that
# every phase fits the script's time limit;
# phase 16's fp8 rounds take FP8_STEPS.
RESNET_DEPTH, RESNET_BATCH, RESNET_SIZE, RESNET_CLASSES = 50, 256, 224, 1000
RESNET_LR, RESNET_MOMENTUM = 0.01, 0.9
# 2 timed rounds (3 until phase 18 came) of 5 steps (10 until phases 12
# (d) and 19 (c) came)
RESNET_STEPS, RESNET_ROUNDS = 5, 2
RESNET_EAGER_STEPS, RESNET_PROFILE_STEPS = 3, 3
# the gates' model: the same program at class_dim 10, batch 8 of 64x64
# images (its last stage normalizes each channel over 8 x 2 x 2 = 32
# values). Card against CPU, each step from the CPU run's state: at this
# size a step's update moves by 2.5-3.3% rel L2 when the images move by
# 1e-7 (measured on the CPU, tests/test_torch_resnet.py), so the update
# is held to 0.15, the loss to 1e-3; the ops, one at a time, to 1e-5.
RGATE_BATCH, RGATE_SIZE, RGATE_CLASSES, RGATE_STEPS = 8, 64, 10, 3
RGATE_LOSS_RTOL, RGATE_UPDATE_REL_L2 = 1e-3, 0.15
ROP_REL_L2, ROP_BF16_REL_L2 = 1e-5, 1e-2
# run_steps against run: run() calls, then two run_steps calls of
# RGATE_N_STEPS each; 1 capture and 2 x RGATE_N_STEPS - 1 replays
RGATE_RUN_CALLS, RGATE_N_STEPS = 4, 4


def build_resnet(fluid, depth, batch, size, class_dim, amp):
    """bench.py's program: ``resnet_imagenet`` in NHWC, cross_entropy on
    the softmax, mean, Momentum; bf16 mixed precision when ``amp``."""
    from paddle_tpu_torch import models, unique_name
    with unique_name.guard():
        prog, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(prog, startup):
            images = fluid.layers.data(name="images", shape=[3, size, size],
                                       dtype="float32")
            label = fluid.layers.data(name="label", shape=[1],
                                      dtype="int64")
            pred = models.resnet_imagenet(images, class_dim=class_dim,
                                          depth=depth, data_format="NHWC")
            loss = fluid.layers.mean(
                fluid.layers.cross_entropy(input=pred, label=label))
            fluid.optimizer.Momentum(learning_rate=RESNET_LR,
                                     momentum=RESNET_MOMENTUM).minimize(loss)
        fluid.enable_mixed_precision(prog, amp)
    return prog, startup, loss


def resnet_feed(batch, size, class_dim, device="cpu", seed=SEED):
    """bench.py's synthetic feed: images, then labels, from
    ``RandomState(seed)``, as tensors on ``device``."""
    import torch
    rng = np.random.RandomState(seed)
    images = rng.rand(batch, 3, size, size).astype(np.float32)
    label = rng.randint(0, class_dim, (batch, 1)).astype(np.int64)
    return {"images": torch.from_numpy(images).to(device),
            "label": torch.from_numpy(label).to(device)}


def _rel_l2(got, want):
    want = want.double()
    return float((got.double() - want).norm() / max(float(want.norm()),
                                                    1e-30))


def _run_op(op_type, ins, attrs, amp, device, outputs=None):
    """``op_type``'s lowering (a grad op's: registered, or the generic
    vjp of its forward) on ``ins`` moved to ``device``; CPU outputs."""
    import types
    import torch.utils._pytree as pytree
    from paddle_tpu_torch import registry
    if registry.is_registered(op_type):
        fn = registry.get_op_info(op_type).lowering
    else:
        fn = registry.make_generic_grad_lowering(op_type[:-len("_grad")])
    op = types.SimpleNamespace(type=op_type, attrs=dict(attrs), op_uid=1,
                               inputs={}, outputs=outputs or {},
                               forward_op=None)
    ctx = registry.LoweringContext(op, step_key=(0, 0), device=device,
                                   amp=amp)
    # a ragged value (LoDArray) moves and comes back field by field
    outs = fn(ctx, {s: [pytree.tree_map(lambda t: t.to(device), v)
                        for v in vs] for s, vs in ins.items()})
    return {s: [pytree.tree_map(lambda t: t.cpu(), v) for v in vs
                if v is not None] for s, vs in outs.items()}


def _op_case(rng, label, op_type, ins, attrs, grads=(), amp=False):
    """One op on the card against the CPU: its outputs, then the grads
    of ``grads`` from random output cotangents; the worst rel L2."""
    import torch
    card = torch.device(DEVICE)
    cpu = torch.device("cpu")
    got = _run_op(op_type, ins, attrs, amp, card)
    want = _run_op(op_type, ins, attrs, amp, cpu)
    errs = [_rel_l2(a.float(), b.float()) for s in want
            for a, b in zip(got[s], want[s])]
    if grads:
        gins = dict(ins, **{s: want[s] for s in want})
        for s in want:
            gins[s + "@GRAD"] = [torch.from_numpy(
                rng.randn(*v.shape).astype(np.float32)).to(v.dtype)
                for v in want[s]]
        gattrs = dict(attrs, __fwd_input_slots__=list(ins),
                      __fwd_output_slots__=list(want), __fwd_op_uid__=1)
        outs = {s + "@GRAD": [s + "@GRAD"] for s in grads}
        got = _run_op(op_type + "_grad", gins, gattrs, amp, card, outs)
        want = _run_op(op_type + "_grad", gins, gattrs, amp, cpu, outs)
        errs += [_rel_l2(a.float(), b.float()) for s in want
                 for a, b in zip(got[s], want[s])]
    return {"case": label, "rel_l2": max(errs), "amp": amp}


def resnet_op_checks():
    """The ResNet path's ops on the card against the CPU, fp32 with TF32
    off (ROP_REL_L2): conv2d and its analytic grad at the stem's, a
    3x3's and a strided 1x1's geometry in NHWC (and a 3x3 in NCHW);
    pool2d max (3x3, stride 2, pad 1) and global avg; batch_norm in
    training (running mean away from the batch mean) and in test, with
    its grad; relu, softmax, cross_entropy, momentum. Then the three
    NHWC convolutions in bf16 (ROP_BF16_REL_L2: cuDNN and the CPU round
    the same fp32 sums once, in other orders)."""
    import torch
    _fp32()
    rng = np.random.RandomState(SEED)

    def t(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy((rng.randn(*shape) * scale + shift)
                                .astype(np.float32))

    b = RGATE_BATCH
    conv = {"stem-7x7-s2-p3": ((b, 64, 64, 3), (64, 3, 7, 7), 2, 3),
            "3x3-s1-p1": ((b, 16, 16, 64), (64, 64, 3, 3), 1, 1),
            "1x1-s2": ((b, 16, 16, 256), (512, 256, 1, 1), 2, 0)}
    rows = []
    for amp in (False, True):
        for name, (xs, ws, stride, pad) in conv.items():
            attrs = {"strides": [stride] * 2, "paddings": [pad] * 2,
                     "dilations": [1, 1], "groups": 1,
                     "data_format": "NHWC"}
            rows.append(_op_case(rng, "conv2d " + name, "conv2d",
                                 {"Input": [t(*xs)], "Filter": [t(*ws)]},
                                 attrs, ("Input", "Filter"), amp))
    rows.append(_op_case(rng, "conv2d 3x3-s2-p1 NCHW", "conv2d",
                         {"Input": [t(b, 64, 16, 16)],
                          "Filter": [t(64, 64, 3, 3)]},
                         {"strides": [2, 2], "paddings": [1, 1],
                          "dilations": [1, 1], "groups": 1,
                          "data_format": "NCHW"}, ("Input", "Filter")))
    x = t(b, 32, 32, 64)
    rows.append(_op_case(rng, "pool2d max-3x3-s2-p1", "pool2d", {"X": [x]},
                         {"pooling_type": "max", "ksize": [3, 3],
                          "strides": [2, 2], "paddings": [1, 1],
                          "data_format": "NHWC"}, ("X",)))
    rows.append(_op_case(rng, "pool2d avg-global", "pool2d",
                         {"X": [t(b, 2, 2, 2048)]},
                         {"pooling_type": "avg", "ksize": [1, 1],
                          "global_pooling": True, "data_format": "NHWC"},
                         ("X",)))
    for is_test in (False, True):
        c = 64
        rows.append(_op_case(
            rng, "batch_norm " + ("test" if is_test else "train"),
            "batch_norm", {"X": [t(b, 16, 16, c, scale=3.0, shift=2.0)],
                           "Scale": [1.0 + 0.1 * t(c)],
                           "Bias": [0.1 * t(c)], "Mean": [0.5 * t(c)],
                           "Variance": [1.0 + 0.2 * t(c).abs()]},
            {"epsilon": 1e-5, "momentum": 0.9, "is_test": is_test,
             "data_layout": "NHWC"}, ("X", "Scale", "Bias")))
    rows.append(_op_case(rng, "relu", "relu", {"X": [x]}, {}, ("X",)))
    rows.append(_op_case(rng, "softmax", "softmax", {"X": [t(b, 1000)]},
                         {}, ("X",)))
    p = torch.softmax(t(b, 1000), -1)
    rows.append(_op_case(rng, "cross_entropy", "cross_entropy",
                         {"X": [p], "Label": [torch.from_numpy(
                             rng.randint(0, 1000, (b, 1)))]},
                         {}, ("X",)))
    rows.append(_op_case(rng, "momentum", "momentum",
                         {"Param": [t(512, 256)], "Grad": [t(512, 256)],
                          "Velocity": [t(512, 256)],
                          "LearningRate": [torch.tensor([RESNET_LR])]},
                         {"mu": RESNET_MOMENTUM}))
    for r in rows:
        r["ok"] = r["rel_l2"] <= (ROP_BF16_REL_L2 if r["amp"]
                                  else ROP_REL_L2)
    log("resnet op checks (card vs CPU): %s" % json.dumps(rows))
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError("resnet ops disagree, card vs CPU: %s" % bad)
    return rows


def _copy_scope(fluid, state, device):
    scope = fluid.Scope()
    for n, v in state.items():
        scope.set_var(n, v.to(device, copy=True))
    return scope


def card_vs_cpu_steps(label, prog, startup, loss, feed, steps, loss_rtol,
                      update_rel_l2):
    """``prog`` from one startup state (the CPU's), ``steps`` steps; step
    k runs on the card and the CPU from the CPU run's state before it.
    Per step the losses within ``loss_rtol`` relative and every
    persistable's update within ``update_rel_l2`` relative L2; raises
    past either or on a loss that is not finite."""
    import paddle_tpu_torch as fluid
    state = _startup_state(startup)
    exes = {"card": fluid.Executor(fluid.CUDAPlace(0)),
            "cpu": fluid.Executor(fluid.CPUPlace())}
    rows, worst = [], {"loss": 0.0, "update": 0.0}
    for k in range(steps):
        after = {}
        for tag, exe in exes.items():
            scope = _copy_scope(fluid, state, exe.device)
            lv = float(exe.run(prog, feed=feed, fetch_list=[loss],
                               scope=scope)[0])
            after[tag] = (lv, {n: scope.find_var(n).float().cpu()
                               for n in state})
        (lc, card), (lp, cpu) = after["card"], after["cpu"]
        upd = {}
        for n, v in state.items():
            want = cpu[n] - v.float()
            if bool(want.any()):
                upd[n] = _rel_l2(card[n] - v.float(), want)
            elif bool((card[n] - v.float()).any()):
                upd[n] = float("inf")   # moved on the card only
        name = max(upd, key=upd.get)
        row = {"step": k, "loss_card": lc, "loss_cpu": lp,
               "loss_rel_err": abs(lc - lp) / abs(lp),
               "updates": len(upd), "worst_update": name,
               "worst_update_rel_l2": upd[name],
               "median_update_rel_l2": float(np.median(list(upd.values())))}
        rows.append(row)
        worst["loss"] = max(worst["loss"], row["loss_rel_err"])
        worst["update"] = max(worst["update"], upd[name])
        state = {n: v.clone() for n, v in cpu.items()}
    res = {"steps": rows, "loss_rel_err": worst["loss"],
           "update_rel_l2": worst["update"]}
    log("%s: %s" % (label, json.dumps(res)))
    if not (worst["loss"] <= loss_rtol and
            worst["update"] <= update_rel_l2 and
            all(np.isfinite([r["loss_card"] for r in rows]))):
        raise AssertionError(
            "%s: card and CPU disagree: loss rel err %.3g (limit %g), "
            "update rel L2 %.3g (limit %g)" % (
                label, worst["loss"], loss_rtol, worst["update"],
                update_rel_l2))
    return res


def resnet_gate():
    """fp32 card-vs-CPU gate, TF32 off: the gate model, RGATE_STEPS
    steps (``card_vs_cpu_steps``): per step the losses within
    RGATE_LOSS_RTOL and every persistable's update within
    RGATE_UPDATE_REL_L2 relative L2."""
    import paddle_tpu_torch as fluid
    _fp32()
    prog, startup, loss = build_resnet(fluid, RESNET_DEPTH, RGATE_BATCH,
                                       RGATE_SIZE, RGATE_CLASSES, amp=False)
    feed = resnet_feed(RGATE_BATCH, RGATE_SIZE, RGATE_CLASSES)
    return card_vs_cpu_steps("resnet gate (card vs CPU, fp32)", prog,
                             startup, loss, feed, RGATE_STEPS,
                             RGATE_LOSS_RTOL, RGATE_UPDATE_REL_L2)


@contextlib.contextmanager
def _cudnn(**flags):
    """torch.backends.cudnn flags set for the block, restored after."""
    import torch
    old = {k: getattr(torch.backends.cudnn, k) for k in flags}
    for k, v in flags.items():
        setattr(torch.backends.cudnn, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(torch.backends.cudnn, k, v)


def _bitwise(ref, got, names):
    """The names whose tensors differ in any bit between two scopes."""
    import torch
    return sorted(n for n in names if not torch.equal(
        ref.find_var(n).cpu(), got.find_var(n).cpu()))


def resnet_replay_gate():
    """``run_steps`` against ``run`` on the card, fp32, TF32 off,
    deterministic cuDNN, from one state: RGATE_RUN_CALLS ``run()`` calls
    then two ``run_steps(n_steps=RGATE_N_STEPS)`` calls (the first: a
    warm-up step, the capture, RGATE_N_STEPS - 1 replays; the second:
    RGATE_N_STEPS replays) against as many ``run()`` calls: every
    persistable and both returned losses bitwise equal, and on the card
    1 capture and 2 x RGATE_N_STEPS - 1 replays. Then one ``run()`` (it
    replaces the scope's tensors) and ``run_steps`` on another feed of
    the same shapes, which the replays must load, against as many
    ``run()`` calls: bitwise again, with RGATE_N_STEPS more replays and
    no new capture."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import executor as pexe
    _fp32()
    prog, startup, loss = build_resnet(fluid, RESNET_DEPTH, RGATE_BATCH,
                                       RGATE_SIZE, RGATE_CLASSES, amp=False)
    feed = resnet_feed(RGATE_BATCH, RGATE_SIZE, RGATE_CLASSES)
    feed2 = resnet_feed(RGATE_BATCH, RGATE_SIZE, RGATE_CLASSES, seed=SEED + 1)
    state = _startup_state(startup)
    total = RGATE_RUN_CALLS + 2 * RGATE_N_STEPS
    on_card = DEVICE == "cuda"
    with _cudnn(deterministic=True, benchmark=False):
        exe = fluid.Executor(fluid.CUDAPlace(0))
        ref = _copy_scope(fluid, state, exe.device)
        ref_losses = [exe.run(prog, feed=feed, fetch_list=[loss],
                              scope=ref)[0] for _ in range(total)]
        got = _copy_scope(fluid, state, exe.device)
        exe = fluid.Executor(fluid.CUDAPlace(0))
        for _ in range(RGATE_RUN_CALLS):
            exe.run(prog, feed=feed, fetch_list=[loss], scope=got)
        for name in pexe.graph_launches:
            pexe.graph_launches[name] = 0
        losses = [exe.run_steps(prog, feed=feed, n_steps=RGATE_N_STEPS,
                                fetch_list=[loss], scope=got)[0]
                  for _ in range(2)]
        counts = dict(pexe.graph_launches)
        differ = _bitwise(ref, got, state)
        # the replay path's loads: state that run() replaced, a new feed
        for f in [feed] + [feed2] * RGATE_N_STEPS:
            ref_last = exe.run(prog, feed=f, fetch_list=[loss], scope=ref)[0]
        exe.run(prog, feed=feed, fetch_list=[loss], scope=got)
        last = exe.run_steps(prog, feed=feed2, n_steps=RGATE_N_STEPS,
                             fetch_list=[loss], scope=got)[0]
        counts_after = dict(pexe.graph_launches)
        differ_after = _bitwise(ref, got, state)
        _sync()
    same_loss = [bool(np.array_equal(a, ref_losses[i])) for a, i in
                 zip(losses, (total - RGATE_N_STEPS - 1, total - 1))] + \
        [bool(np.array_equal(last, ref_last))]
    want = {"captures": 1, "replays": 2 * RGATE_N_STEPS - 1} if on_card \
        else {"captures": 0, "replays": 0}
    want_after = {"captures": 1, "replays": 3 * RGATE_N_STEPS - 1} \
        if on_card else want
    res = {"run_calls": RGATE_RUN_CALLS, "n_steps": RGATE_N_STEPS,
           "losses": [float(v) for v in losses] + [float(last)],
           "ref_losses": [float(v) for v in ref_losses] + [float(ref_last)],
           "losses_bitwise": same_loss, "persistables": len(state),
           "persistables_differing": differ,
           "persistables_differing_after_reload": differ_after,
           "graph_launches": counts, "graph_launches_after": counts_after}
    log("resnet run_steps vs run (card, fp32, deterministic cuDNN): %s"
        % json.dumps(res))
    if differ or differ_after or not all(same_loss) or counts != want \
            or counts_after != want_after:
        raise AssertionError(
            "run_steps differs from run: %d / %d persistables differ (%s), "
            "losses bitwise %s, graph launches %s then %s (want %s then %s)"
            % (len(differ), len(differ_after), (differ + differ_after)[:5],
               same_loss, counts, counts_after, want, want_after))
    return res


def _kernel_counts():
    """name -> launches of the 14 kernel entry points and the megastep
    loop."""
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_adam as pfa
    from paddle_tpu_torch.ops import megastep_loop as ml
    from paddle_tpu_torch.ops import paged_attention as pa
    counts = dict(fa.launches)
    counts["paged_decode_attention"] = pa.launches
    counts["paged_decode_attention_quant"] = pa.launches_quant
    counts["fused_adam"] = pfa.launches["fused_adam"]
    counts["megastep_loop"] = ml.launches["megastep_loop"]
    return counts


def _reset_kernel_counts():
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_adam as pfa
    from paddle_tpu_torch.ops import megastep_loop as ml
    from paddle_tpu_torch.ops import paged_attention as pa
    for name in fa.launches:
        fa.launches[name] = 0
    pa.launches = pa.launches_quant = 0
    pfa.launches["fused_adam"] = 0
    ml.launches["megastep_loop"] = 0


# device kernels by what they compute, for the ResNet profile (first
# match wins)
_RESNET_CLASSES = (
    ("pool", ("pool",)),
    ("conv", ("conv", "cudnn", "xmma", "implicit", "dgrad", "wgrad",
              "fprop", "sm90_")),
    ("gemm", ("gemm", "nvjet", "cutlass")),
    ("reduce", ("reduce",)),
    ("copy", ("copy", "memcpy", "memset", "fill")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "index",
                     "where", "cat")),
)


def _kernel_class(key, table):
    """The first class of ``table`` one of whose tags ``key`` contains."""
    low = key.lower()
    for name, tags in table:
        if any(t in low for t in tags):
            return name
    return "other"


def resnet_class(key):
    return _kernel_class(key, _RESNET_CLASSES)


def _device_events(prof):
    from paddle_tpu_torch.registry import OP_REGISTRY
    return [e for e in prof.key_averages()
            if str(e.device_type) == "DeviceType.CUDA"
            and not getattr(e, "is_user_annotation", False)
            and e.key not in OP_REGISTRY and e.self_device_time_total > 0]


def _kernel_profile(prof, steps, classify=None):
    """Device-busy ms per step, by class (``classify``, default
    ``resnet_class``) and the top 12 kernels, from a profile over
    ``steps`` steps."""
    events = _device_events(prof)
    by_class = {}
    for e in events:
        c = (classify or resnet_class)(e.key)
        by_class[c] = by_class.get(c, 0.0) + \
            e.self_device_time_total / steps / 1e3
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:12]
    return {"device_busy_ms": sum(by_class.values()),
            "class_ms": dict(sorted(by_class.items(),
                                    key=lambda kv: -kv[1])),
            "top_kernels_ms": {e.key[:90]: e.self_device_time_total
                               / steps / 1e3 for e in top}}


def _profile_eager(exe, prog, feed, loss, steps):
    """``steps`` ``run()`` steps under ``torch.profiler``: the kernel
    profile (``_kernel_profile``) and per op type the host and device ms
    of its lowering's range."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if DEVICE == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        for _ in range(steps):
            exe.run(prog, feed=feed, fetch_list=[loss])
        _sync()
    res = _kernel_profile(prof, steps)
    res["ops"] = _op_ranges(prof.key_averages(), steps)
    return res


def _profile_replay(exe, prog, feed, loss, steps, classify=None):
    """One ``run_steps(n_steps=steps)`` replay under ``torch.profiler``:
    device-busy ms per step, wall ms per step, the kernel classes
    (``classify``: see ``_kernel_profile``)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if DEVICE == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        exe.run_steps(prog, feed=feed, n_steps=steps, fetch_list=[loss])
        wall = (time.perf_counter() - t0) * 1e3 / steps
    res = _kernel_profile(prof, steps, classify)
    res["wall_ms"] = wall
    return res


def resnet_path(card_label=""):
    """bench.py's ResNet step at full size on the card: startup, eager
    ``run()`` steps (the first also lets cuDNN pick its algorithms), a
    profiled eager window, then one warm-up ``run_steps`` dispatch (the
    capture) and RESNET_ROUNDS timed ones, then a profiled replay; the
    kernel counts and the graph counts set to 0 just before and read
    just after."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import executor as pexe
    from paddle_tpu_torch.flops import device_peak_flops, \
        estimate_program_flops
    prog, startup, loss = build_resnet(fluid, RESNET_DEPTH, RESNET_BATCH,
                                       RESNET_SIZE, RESNET_CLASSES, amp=True)
    flops = estimate_program_flops(prog, RESNET_BATCH, training=True)
    peak = device_peak_flops() if DEVICE == "cuda" else None
    feed = resnet_feed(RESNET_BATCH, RESNET_SIZE, RESNET_CLASSES, DEVICE)
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _reset_kernel_counts()
    for name in pexe.graph_launches:
        pexe.graph_launches[name] = 0
    with _cudnn(benchmark=True, deterministic=False), \
            fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup)
        losses, eager_ms = _train_steps(exe, prog, feed, loss,
                                        1 + RESNET_EAGER_STEPS)
        eager_prof = _profile_eager(exe, prog, feed, loss,
                                    RESNET_PROFILE_STEPS)
        t0 = time.perf_counter()
        (lv,) = exe.run_steps(prog, feed=feed, n_steps=RESNET_STEPS,
                              fetch_list=[loss])
        warmup_s = time.perf_counter() - t0
        rounds = []
        for _ in range(RESNET_ROUNDS):
            t0 = time.perf_counter()
            (lv,) = exe.run_steps(prog, feed=feed, n_steps=RESNET_STEPS,
                                  fetch_list=[loss])
            rounds.append(time.perf_counter() - t0)
        replay_prof = _profile_replay(exe, prog, feed, loss,
                                      RESNET_PROFILE_STEPS)
    launches = _kernel_counts()
    graphs = dict(pexe.graph_launches)
    med = float(np.median(rounds))
    step_ms = med * 1e3 / RESNET_STEPS
    eager_p50 = float(np.percentile(eager_ms[1:], 50))
    res = {"config": {"depth": RESNET_DEPTH, "batch": RESNET_BATCH,
                      "image": RESNET_SIZE, "classes": RESNET_CLASSES,
                      "layout": "NHWC", "amp": True,
                      "optimizer": "Momentum(%g, %g)" % (RESNET_LR,
                                                         RESNET_MOMENTUM),
                      "cudnn_benchmark": True},
           "cut": "run_steps n_steps %d x %d rounds after one warm-up "
                  "dispatch (bench.py: 100 x 3)" % (RESNET_STEPS,
                                                     RESNET_ROUNDS),
           "card": card_label,
           "first_loss": losses[0], "eager_losses": losses,
           "final_loss": float(lv), "warmup_dispatch_s": warmup_s,
           "round_s": rounds, "images_per_s": RESNET_BATCH / (step_ms / 1e3),
           "step_ms_captured": step_ms, "step_ms_eager": eager_ms,
           "step_ms_eager_p50": eager_p50,
           "flops_per_step": flops, "peak_flops": peak,
           "mfu": flops / (step_ms / 1e3) / peak if peak else None,
           "eager_profile": eager_prof,
           "eager_device_busy_ms": eager_prof["device_busy_ms"],
           "eager_idle_share": 1.0 - eager_prof["device_busy_ms"]
           / eager_p50,
           "replay_profile": replay_prof,
           "replay_device_busy_ms": replay_prof["device_busy_ms"],
           "replay_idle_share": 1.0 - replay_prof["device_busy_ms"]
           / replay_prof["wall_ms"],
           "batch_norm_grad_device_ms":
               eager_prof["ops"].get("batch_norm_grad", {})
               .get("device_ms"),
           "launches": launches, "graph_launches": graphs,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9
           if DEVICE == "cuda" else None}
    summary = {k: res[k] for k in (
        "card", "cut", "images_per_s", "step_ms_captured",
        "step_ms_eager_p50", "mfu", "eager_device_busy_ms",
        "eager_idle_share", "replay_device_busy_ms", "replay_idle_share",
        "batch_norm_grad_device_ms", "peak_memory_gb", "first_loss",
        "final_loss", "round_s", "graph_launches")}
    summary["eager_class_ms"] = eager_prof["class_ms"]
    summary["replay_class_ms"] = replay_prof["class_ms"]
    summary["replay_top_kernels_ms"] = replay_prof["top_kernels_ms"]
    log("resnet-%d NHWC b%d %dx%d bf16 Momentum: %s"
        % (RESNET_DEPTH, RESNET_BATCH, RESNET_SIZE, RESNET_SIZE,
           json.dumps(summary)))
    if not (np.isfinite(res["final_loss"]) and
            all(np.isfinite(losses)) and res["final_loss"] < losses[0]):
        raise AssertionError("resnet loss not finite and falling: first "
                             "%s, after the rounds %s"
                             % (losses[0], res["final_loss"]))
    if any(launches.values()):
        raise AssertionError("the ResNet steps launched kernels of other "
                             "paths: %s" % {n: c for n, c in
                                            launches.items() if c})
    want = 1 if DEVICE == "cuda" else 0
    if graphs["captures"] != want:
        raise AssertionError("resnet: %d graph captures, want %d"
                             % (graphs["captures"], want))
    return res


# -- phase 13: bench_lm.py's rounds through the captured step ------------

# the run_steps ≡ run() gates (fp32, deterministic): REPLAY_RUN_CALLS
# run() calls then two run_steps(REPLAY_N_STEPS) against as many run()
# calls on a twin executor
REPLAY_RUN_CALLS, REPLAY_N_STEPS = 4, 4
# the random-op gate: a classifier with one dropout layer, Adam
DROPOUT_P, DROPOUT_ROWS, DROPOUT_WIDTH, DROPOUT_STEPS = 0.5, 64, 512, 8
# bench_lm.py's methodology: ITERS-step rounds, one warm round, 3 timed.
# The cuts: 5-step rounds against bench_lm.py's 60 (10 until phases 12 (d)
# and 19 (c) came), so that every phase fits the script's time
# limit, and 2 timed rounds (3 until phase 18 came)
BENCH_ITERS, BENCH_ROUNDS, BENCH_PROFILE_STEPS = 5, 2, 5
# phases 8-10 in captured rounds: a warm round, then CAPTURED_ROUNDS (5
# steps a round; 20 until phase 16 came, 10 until phase 17 came)
CAPTURED_STEPS, CAPTURED_ROUNDS = 5, 2
# the preemption gate: the 2-layer LM at full width, one run_steps round
# of RESUME_ROUND_STEPS per train_loop step, SIGTERM after round
# RESUME_PREEMPT_AFTER, a checkpoint every round; 3 rounds (4 until phases
# 12 (d) and 19 (c) came): the relaunch resumes one
RESUME_ROUNDS, RESUME_ROUND_STEPS, RESUME_PREEMPT_AFTER = 3, 10, 2
RESUME_TIMEOUT_S = 300


@contextlib.contextmanager
def _deterministic():
    """fp32 matmuls without TF32, deterministic algorithms (cuBLAS reads
    CUBLAS_WORKSPACE_CONFIG, set by ``main`` before CUDA starts). Yields
    a list that collects, once each, the warnings of operations that have
    no deterministic implementation (they run, and the gate names them)."""
    import warnings
    import torch
    _fp32()
    torch.use_deterministic_algorithms(True, warn_only=True)
    seen = []
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield seen
    finally:
        torch.use_deterministic_algorithms(False)
        for w in caught:
            msg = str(w.message)[:200]
            if "deterministic" in msg and msg not in seen:
                seen.append(msg)


def _zero_counts():
    from paddle_tpu_torch import executor as pexe
    _reset_kernel_counts()
    for name in pexe.graph_launches:
        pexe.graph_launches[name] = 0


def _counts_gate(label, launches, want):
    """Every kernel entry point launched exactly ``want[name]`` times (0
    where not named); raises otherwise."""
    bad = {n: c for n, c in launches.items() if c != want.get(n, 0)}
    if bad:
        raise AssertionError("%s: kernel launches %s, want %s and no other"
                             % (label, bad, want))


def lm_replay_gate(mask=None):
    """``run_steps`` against ``run`` on the LM, fp32, deterministic: the
    2-layer full-width program (``mask`` None: K1/K2; "packed": K5 on
    the packed rows at the gate's size) from one state, REPLAY_RUN_CALLS
    ``run()`` calls then two ``run_steps(REPLAY_N_STEPS)``, against as
    many ``run()`` calls on a twin: every persistable and both losses
    bitwise, 1 capture and 2 x REPLAY_N_STEPS - 1 replays, and the
    path's flash kernels launched steps x layers each (counted through
    the replays), the others never."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import executor as pexe
    prog, startup, loss = build_lm(fluid, GATE_LAYERS, GATE_BATCH, GATE_SEQ,
                                   amp=False, mask=mask)
    feed = packed_data(GATE_BATCH, GATE_SEQ)["packed"] if mask \
        else lm_feed(GATE_BATCH, GATE_SEQ)
    state = _startup_state(startup)
    total = REPLAY_RUN_CALLS + 2 * REPLAY_N_STEPS
    with _deterministic() as nondeterministic:
        exe = fluid.Executor(fluid.CUDAPlace(0))
        ref = _copy_scope(fluid, state, exe.device)
        ref_losses = [exe.run(prog, feed=feed, fetch_list=[loss],
                              scope=ref)[0] for _ in range(total)]
        got = _copy_scope(fluid, state, exe.device)
        exe = fluid.Executor(fluid.CUDAPlace(0))
        _zero_counts()
        for _ in range(REPLAY_RUN_CALLS):
            exe.run(prog, feed=feed, fetch_list=[loss], scope=got)
        losses = [exe.run_steps(prog, feed=feed, n_steps=REPLAY_N_STEPS,
                                fetch_list=[loss], scope=got)[0]
                  for _ in range(2)]
        launches, graphs = _kernel_counts(), dict(pexe.graph_launches)
        differ = _bitwise(ref, got, state)
        exe.close()
    same = [bool(np.array_equal(a, ref_losses[i])) for a, i in
            zip(losses, (total - REPLAY_N_STEPS - 1, total - 1))]
    want_graphs = {"captures": 1, "replays": 2 * REPLAY_N_STEPS - 1} \
        if DEVICE == "cuda" else {"captures": 0, "replays": 0}
    kernels = K5 if mask else K1K2
    res = {"mask": mask or "none", "losses": [float(v) for v in losses],
           "ref_losses": [float(v) for v in ref_losses],
           "losses_bitwise": same, "persistables": len(state),
           "persistables_differing": differ, "graph_launches": graphs,
           "launches": {n: launches[n] for n in kernels},
           "nondeterministic_ops": nondeterministic}
    log("LM run_steps vs run (%s, fp32, deterministic): %s"
        % (res["mask"], json.dumps(res)))
    if differ or not all(same) or graphs != want_graphs:
        raise AssertionError(
            "LM run_steps differs from run (%s): %d persistables differ "
            "(%s), losses bitwise %s, graph launches %s (want %s)"
            % (res["mask"], len(differ), differ[:5], same, graphs,
               want_graphs))
    _counts_gate("LM run_steps gate (%s)" % res["mask"], launches,
                 {n: total * GATE_LAYERS for n in kernels})
    return res


def build_dropout(fluid):
    """The random-op program: x [DROPOUT_ROWS, DROPOUT_WIDTH] → fc relu →
    dropout(DROPOUT_P) → fc(10) → softmax cross-entropy → mean, Adam;
    returns (prog, startup, loss, the dropout's Mask variable name)."""
    from paddle_tpu_torch import unique_name
    with unique_name.guard():
        prog, startup = fluid.Program(), fluid.Program()
        prog.random_seed = startup.random_seed = SEED
        with fluid.program_guard(prog, startup):
            x = fluid.layers.data(name="x", shape=[DROPOUT_WIDTH],
                                  dtype="float32")
            y = fluid.layers.data(name="y", shape=[1], dtype="int64")
            h = fluid.layers.fc(x, DROPOUT_WIDTH, act="relu")
            h = fluid.layers.dropout(h, dropout_prob=DROPOUT_P)
            logits = fluid.layers.fc(h, 10)
            loss = fluid.layers.mean(
                fluid.layers.softmax_with_cross_entropy(logits, y))
            fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    mask = [op for op in prog.global_block().ops
            if op.type == "dropout"][0].output("Mask")[0]
    return prog, startup, loss, mask


def dropout_gate():
    """Random ops under capture: ``run_steps(DROPOUT_STEPS)`` of the
    dropout program bitwise DROPOUT_STEPS ``run()`` calls (fp32,
    deterministic, one state); then two more rounds fetching the mask:
    they draw different masks, and each keeps a share within 4 sigma of
    1 - DROPOUT_P."""
    import paddle_tpu_torch as fluid
    prog, startup, loss, mask = build_dropout(fluid)
    rng = np.random.RandomState(SEED)
    feed = {"x": rng.randn(DROPOUT_ROWS, DROPOUT_WIDTH).astype(np.float32),
            "y": rng.randint(0, 10, (DROPOUT_ROWS, 1)).astype(np.int64)}
    state = _startup_state(startup)
    with _deterministic() as nondeterministic:
        exe = fluid.Executor(fluid.CUDAPlace(0))
        ref = _copy_scope(fluid, state, exe.device)
        ref_losses = [exe.run(prog, feed=feed, fetch_list=[loss],
                              scope=ref)[0] for _ in range(DROPOUT_STEPS)]
        got = _copy_scope(fluid, state, exe.device)
        exe = fluid.Executor(fluid.CUDAPlace(0))
        last = exe.run_steps(prog, feed=feed, n_steps=DROPOUT_STEPS,
                             fetch_list=[loss], scope=got)[0]
        differ = _bitwise(ref, got, state)
        masks = [exe.run_steps(prog, feed=feed, n_steps=DROPOUT_STEPS,
                               fetch_list=[mask], scope=got)[0]
                 for _ in range(2)]
        exe.close()
    n = masks[0].size
    sigma = float(np.sqrt(DROPOUT_P * (1 - DROPOUT_P) / n))
    kept = [float(m.mean()) for m in masks]
    res = {"steps": DROPOUT_STEPS, "loss": float(last),
           "ref_loss": float(ref_losses[-1]),
           "loss_bitwise": bool(np.array_equal(last, ref_losses[-1])),
           "persistables_differing": differ, "kept_share": kept,
           "sigma": sigma, "nondeterministic_ops": nondeterministic,
           "masks_differ": not np.array_equal(masks[0], masks[1])}
    log("dropout under capture: %s" % json.dumps(res))
    if differ or not res["loss_bitwise"] or not res["masks_differ"] or \
            any(abs(k - (1 - DROPOUT_P)) > 4 * sigma for k in kept):
        raise AssertionError("dropout under capture: %s" % json.dumps(res))
    return res


def _replay_profile(exe, prog, feed, loss):
    """A warm-up round (the capture, where the executor has none), then
    one profiled ``run_steps(BENCH_PROFILE_STEPS)`` replay: device-busy
    ms a step, wall ms a step, idle share and the top kernels."""
    exe.run_steps(prog, feed=feed, n_steps=2, fetch_list=[loss])
    prof = _profile_replay(exe, prog, feed, loss, BENCH_PROFILE_STEPS)
    prof["idle_share"] = 1.0 - prof["device_busy_ms"] / prof["wall_ms"]
    return prof


def bench_lm_rounds(eager_p50):
    """bench_lm.py's measured path through the port
    (``paddle_tpu_torch.benchmarks.lm``): ``main()`` at LM_* sizes, then
    ``packed_main()``, with BENCH_ITERS-step rounds (one warm, then
    BENCH_ROUNDS timed); each with the kernel, graph and telemetry
    counts set to 0 just before and read just after. Gates: the loss
    finite and lower after the last round than after the first; cache
    misses = distinct (program, feed) pairs; the path's flash kernels
    launched steps x layers; one capture a program. Then a profiled
    replay of each program (busy ms, idle share) beside ``eager_p50``
    (phase 6's and 7's step p50)."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import executor as pexe
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.benchmarks import lm
    from paddle_tpu_torch.observability import steps as step_telemetry
    sizes = {"BATCH": LM_BATCH, "SEQ": LM_SEQ, "VOCAB": LM_VOCAB,
             "LAYERS": LM_LAYERS, "D_MODEL": LM_DIM, "HEADS": LM_HEADS,
             "ITERS": BENCH_ITERS, "WARMUP": BENCH_ITERS,
             "ROUNDS": BENCH_ROUNDS}
    saved = {k: getattr(lm, k) for k in sizes}
    handles = []
    real_run_steps = pexe.Executor.run_steps

    def spy(self, *args, **kwargs):
        out = real_run_steps(self, *args, **kwargs)
        handles.append(out)
        return out

    steps = (1 + BENCH_ROUNDS) * BENCH_ITERS
    out = {}
    vars(lm).update(sizes)
    pexe.Executor.run_steps = spy
    try:
        for mode, fn in (("dense", lm.main), ("packed", lm.packed_main)):
            profiler.reset_counters()
            profiler.reset_histograms()
            _zero_counts()
            handles.clear()
            if DEVICE == "cuda":
                torch.cuda.reset_peak_memory_stats()
            rec = fn()
            tel = step_telemetry.step_summary()
            launches, graphs = _kernel_counts(), dict(pexe.graph_launches)
            mine = handles[-(1 + BENCH_ROUNDS):]
            round_losses = [float(h.numpy()[0].ravel()[0]) for h in mine]
            programs = 2 if mode == "packed" else 1
            rec.update({
                "round_losses": round_losses, "launches": launches,
                "graph_launches": graphs,
                "compile_cache_misses_by_cause":
                    tel.get("compile_cache_misses_by_cause"),
                "device_wait_s": tel.get("device_wait_s", 0.0),
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9
                if DEVICE == "cuda" else None,
                "eager_step_ms_p50": eager_p50[mode]})
            if mode == "dense":
                rec["step_ms_captured"] = rec["_round_s"] * 1e3 / BENCH_ITERS
                want = {n: steps * LM_LAYERS for n in K1K2}
            else:
                rec["step_ms_captured"] = {
                    k: v * 1e3 / BENCH_ITERS
                    for k, v in rec["_round_s"].items()}
                want = {n: steps * LM_LAYERS for n in K1K2 + K5}
            if not (all(np.isfinite(round_losses)) and
                    round_losses[-1] < round_losses[0]):
                raise AssertionError("bench %s: round losses not finite "
                                     "and falling: %s"
                                     % (mode, round_losses))
            if tel.get("compile_cache_misses") != 2 * programs:
                raise AssertionError(
                    "bench %s: %s cache misses, want %d (startup and step "
                    "of %d program(s)): %s"
                    % (mode, tel.get("compile_cache_misses"), 2 * programs,
                       programs, tel.get("compile_cache_misses_by_cause")))
            if graphs["captures"] != (programs if DEVICE == "cuda" else 0):
                raise AssertionError("bench %s: %d captures for %d "
                                     "program(s)" % (mode,
                                                     graphs["captures"],
                                                     programs))
            _counts_gate("bench %s" % mode, launches, want)
            out[mode] = rec
        pexe.Executor.run_steps = real_run_steps
        # a profiled replay of each program, outside the counted rounds
        for mode, (prog, startup, loss), feed in (
                ("dense", build_lm(fluid, LM_LAYERS, LM_BATCH, LM_SEQ,
                                   amp=True), lm_feed(LM_BATCH, LM_SEQ)),
                ("packed", build_lm(fluid, LM_LAYERS, LM_BATCH, LM_SEQ,
                                    amp=True, mask="packed"),
                 packed_data(LM_BATCH, LM_SEQ)["packed"])):
            with fluid.scope_guard(fluid.Scope()):
                exe = fluid.Executor(fluid.CUDAPlace(0))
                exe.run(startup)
                prof = _replay_profile(exe, prog, feed, loss)
                exe.close()
            out[mode]["replay_profile"] = prof
            out[mode]["replay_device_busy_ms"] = prof["device_busy_ms"]
            out[mode]["replay_wall_ms"] = prof["wall_ms"]
            out[mode]["replay_idle_share"] = prof["idle_share"]
    finally:
        pexe.Executor.run_steps = real_run_steps
        vars(lm).update(saved)
    for mode, rec in out.items():
        log("bench_lm %s through the captured step: %s" % (mode, json.dumps(
            {k: v for k, v in rec.items()
             if k not in ("replay_profile", "launches")})))
    return out


def _child_args(argv):
    """The preemption child's arguments (``--resume-child``)."""
    ap = argparse.ArgumentParser(prog="chip_smoke.py --resume-child")
    ap.add_argument("--resume-child", nargs=2, required=True,
                    metavar=("CHECKPOINT_DIR", "OUT_NPZ"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--layers", type=int, default=GATE_LAYERS)
    ap.add_argument("--dim", type=int, default=LM_DIM)
    ap.add_argument("--heads", type=int, default=LM_HEADS)
    ap.add_argument("--vocab", type=int, default=LM_VOCAB)
    ap.add_argument("--batch", type=int, default=GATE_BATCH)
    ap.add_argument("--seq", type=int, default=GATE_SEQ)
    ap.add_argument("--rounds", type=int, default=RESUME_ROUNDS)
    ap.add_argument("--round-steps", type=int, default=RESUME_ROUND_STEPS)
    ap.add_argument("--preempt-after", type=int, default=0,
                    help="SIGTERM itself after this many rounds (0: never)")
    args = ap.parse_args(argv)
    for name in ("layers", "dim", "heads", "vocab", "batch", "seq",
                 "rounds", "round_steps"):
        if getattr(args, name) < 1:
            ap.error("--%s must be >= 1" % name.replace("_", "-"))
    if not 0 <= args.preempt_after < args.rounds:
        ap.error("--preempt-after must lie in [0, --rounds)")
    return args


def resume_child(argv):
    """The preemption gate's child: the LM (fp32, deterministic) under
    ``robustness.train_loop`` with checkpoints in CHECKPOINT_DIR every
    round, one ``run_steps(--round-steps)`` round a loop step, resumed
    from the latest valid serial when there is one; ``--preempt-after
    K`` makes round K's ``step_fn`` send itself SIGTERM (the loop then
    checkpoints and exits 42). A finished run writes OUT_NPZ: the last
    loss, every persistable, the serial it resumed from and the step
    counter it resumed at. Returns the exit code."""
    import signal
    import torch
    args = _child_args(argv)
    global DEVICE, LM_DIM, LM_HEADS, LM_VOCAB
    DEVICE, LM_DIM, LM_HEADS, LM_VOCAB = (args.device, args.dim, args.heads,
                                          args.vocab)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("resume child: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import flags, robustness
    flags.checkpoint_dir = args.resume_child[0]
    flags.checkpoint_every_steps = 1
    prog, startup, loss = build_lm(fluid, args.layers, args.batch, args.seq,
                                   amp=False)
    feed = lm_feed(args.batch, args.seq)
    place = fluid.CUDAPlace(0) if args.device == "cuda" \
        else fluid.CPUPlace()
    info = {}
    with _deterministic(), fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(place)
        exe.run(startup)

        def step_fn(i):
            info.setdefault("resumed_at_step_counter", exe.step_counter)
            (lv,) = exe.run_steps(prog, feed=feed, n_steps=args.round_steps,
                                  fetch_list=[loss])
            info["loss"] = lv
            if args.preempt_after and i + 1 == args.preempt_after:
                os.kill(os.getpid(), signal.SIGTERM)
            return lv

        res = robustness.train_loop(
            step_fn, args.rounds, program=prog, executor=exe,
            checkpoint=robustness.CheckpointManager.from_flags())
        scope = fluid.global_scope()
        arrays = {"p:" + n: scope.find_var(n).cpu().numpy()
                  for n in scope.local_var_names()}
    np.savez(args.resume_child[1], loss=info["loss"],
             resumed_from=-1 if res.resumed_from is None
             else res.resumed_from,
             resumed_at_step_counter=info["resumed_at_step_counter"],
             **arrays)
    return 0


def _run_child(ckpt, out, device, sizes, preempt_after=0):
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    argv = [sys.executable, os.path.join(REPO, "chip_smoke.py"),
            "--resume-child", ckpt, out, "--device", device,
            "--preempt-after", str(preempt_after)]
    for k, v in sizes.items():
        argv += ["--" + k.replace("_", "-"), str(v)]
    proc = subprocess.run(argv, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=RESUME_TIMEOUT_S)
    return proc


def resume_gate(workdir, device=None, sizes=None):
    """Preemption and resume: an uninterrupted child, then a child that
    SIGTERMs itself after RESUME_PREEMPT_AFTER rounds (it must exit 42
    leaving a valid serial of that step and its step counter), then its
    relaunch, which must resume from that serial at that counter and end
    with every persistable and the loss bitwise the uninterrupted
    child's. ``sizes``: the children's ``--layers`` ... options (default:
    the 2-layer LM at full width, batch GATE_BATCH, seq GATE_SEQ)."""
    import paddle_tpu_torch as fluid  # noqa: F401  (the package is there)
    from paddle_tpu_torch import robustness
    device = device or DEVICE
    sizes = dict(sizes or {})
    rounds = sizes.get("rounds", RESUME_ROUNDS)
    round_steps = sizes.get("round_steps", RESUME_ROUND_STEPS)
    t0 = time.perf_counter()
    whole, cut = (os.path.join(workdir, t) for t in ("whole", "cut"))
    # the uninterrupted child runs beside the other two, which run in turn
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        uninterrupted = pool.submit(_run_child, os.path.join(whole, "ckpt"),
                                    whole + ".npz", device, sizes)
        procs = {"preempted": _run_child(os.path.join(cut, "ckpt"),
                                         cut + "_first.npz", device, sizes,
                                         RESUME_PREEMPT_AFTER)}
        found = robustness.CheckpointManager(
            dirname=os.path.join(cut, "ckpt")).latest_valid()
        procs["resumed"] = _run_child(os.path.join(cut, "ckpt"),
                                      cut + ".npz", device, sizes)
        procs["whole"] = uninterrupted.result()
    rcs = {k: p.returncode for k, p in procs.items()}
    want_rcs = {"whole": 0, "preempted": robustness.EXIT_PREEMPTED,
                "resumed": 0}
    if rcs != want_rcs:
        raise AssertionError("resume gate exit codes %s, want %s: %s" % (
            rcs, want_rcs, {k: p.stderr[-2000:] for k, p in procs.items()
                            if rcs[k] != want_rcs[k]}))
    want_counter = 1 + RESUME_PREEMPT_AFTER * round_steps
    serial, state = found if found else (None, {})
    with np.load(whole + ".npz") as a, np.load(cut + ".npz") as b:
        names = sorted(k for k in a.files if k.startswith("p:"))
        differ = [k[2:] for k in names
                  if k not in b.files or not np.array_equal(a[k], b[k])]
        res = {"device": device, "rounds": rounds,
               "round_steps": round_steps,
               "preempted_after": RESUME_PREEMPT_AFTER,
               "exit_codes": rcs, "serial": serial,
               "serial_step": (state or {}).get("step"),
               "serial_executor_step": (state or {}).get("executor_step"),
               "resumed_from": int(b["resumed_from"]),
               "resumed_at_step_counter":
                   int(b["resumed_at_step_counter"]),
               "loss": float(b["loss"].ravel()[0]),
               "loss_uninterrupted": float(a["loss"].ravel()[0]),
               "loss_bitwise": bool(np.array_equal(a["loss"], b["loss"])),
               "persistables": len(names), "persistables_differing": differ,
               "seconds": time.perf_counter() - t0}
    log("preemption and resume: %s" % json.dumps(res))
    if serial is None or res["serial_step"] != RESUME_PREEMPT_AFTER or \
            res["serial_executor_step"] != want_counter or \
            res["resumed_from"] != serial or \
            res["resumed_at_step_counter"] != want_counter or differ or \
            not res["loss_bitwise"]:
        raise AssertionError("resume gate: %s" % json.dumps(res))
    return res


def captured_rounds(label, exe, prog, feed, loss, per_step, eager_p50):
    """A phase's program in captured rounds (run from the phase's scope):
    a warm round of CAPTURED_STEPS (the capture), CAPTURED_ROUNDS timed
    ones, with the kernel and graph counts set to 0 just before and read
    just after; then a profiled replay. Gates: finite losses, each kernel
    of ``per_step`` (name → launches a step) launched steps x that, the
    others never, one capture. The graphs are dropped after."""
    from paddle_tpu_torch import executor as pexe
    _zero_counts()
    losses, round_s = [], []
    for _ in range(1 + CAPTURED_ROUNDS):
        t0 = time.perf_counter()
        h = exe.run_steps(prog, feed=feed, n_steps=CAPTURED_STEPS,
                          fetch_list=[loss], return_numpy=False)
        losses.append(float(h.numpy()[0].ravel()[0]))
        round_s.append(time.perf_counter() - t0)
    launches, graphs = _kernel_counts(), dict(pexe.graph_launches)
    prof = _profile_replay(exe, prog, feed, loss, BENCH_PROFILE_STEPS)
    exe.close()
    steps = (1 + CAPTURED_ROUNDS) * CAPTURED_STEPS
    step_ms = float(np.median(round_s[1:])) * 1e3 / CAPTURED_STEPS
    res = {"steps": steps, "round_s": round_s, "losses": losses,
           "step_ms_captured": step_ms, "step_ms_eager_p50": eager_p50,
           "replay_device_busy_ms": prof["device_busy_ms"],
           "replay_wall_ms": prof["wall_ms"],
           "replay_idle_share": 1.0 - prof["device_busy_ms"]
           / prof["wall_ms"],
           "launches": {n: c for n, c in launches.items() if c},
           "graph_launches": graphs}
    log("%s in captured rounds: %s" % (label, json.dumps(res)))
    if not all(np.isfinite(losses)):
        raise AssertionError("%s captured: losses %s" % (label, losses))
    if graphs["captures"] != (1 if DEVICE == "cuda" else 0):
        raise AssertionError("%s captured: %s" % (label, graphs))
    _counts_gate("%s captured" % label, launches,
                 {n: steps * c for n, c in per_step.items()})
    return res


def phase13_launches(report):
    """name → launches of phase 13's main-path runs: the bench's rounds
    and phases 8-10's captured rounds (the gates' are not counted)."""
    total = {}
    runs = [report["bench_lm"]["dense"], report["bench_lm"]["packed"],
            report["fused_adam_path"]["captured"],
            report["bhsd_path"]["captured"],
            report["dense_path"]["bhsd"]["captured"],
            report["dense_path"]["bshd"]["captured"]]
    for run in runs:
        for name, n in run["launches"].items():
            total[name] = total.get(name, 0) + n
    return total


# -- phase 15: seq2seq NMT training as bench_nmt.py runs it ----------------

# the lstm op at the bench's width (batch 64, 40 steps, 512 wide; lengths
# of 1, of the full window and bench_nmt's 20-39), fp32 with TF32 off,
# card against CPU: the outputs and each grad within LSTM_REL_L2
LSTM_BATCH, LSTM_STEPS, LSTM_WIDTH = 64, 40, 512
LSTM_CASES = (("peepholes", {"use_peepholes": True}, ()),
              ("reverse", {"use_peepholes": True, "is_reverse": True}, ()),
              ("reverse-h0-c0-no-peepholes",
               {"use_peepholes": False, "is_reverse": True}, ("H0", "C0")),
              ("h0", {"use_peepholes": True}, ("H0",)))
LSTM_REL_L2 = 1e-5
# the seq2seq gate: the bench's program (512 wide, vocab 30000) at batch
# 8, max length 16, fp32 with TF32 off; NGATE_STEPS steps, each on both
# devices from the CPU run's state: the losses within NGATE_LOSS_RTOL,
# every persistable's update within NGATE_UPDATE_REL_L2
NGATE_BATCH, NGATE_SEQ, NGATE_STEPS = 8, 16, 2
NGATE_LOSS_RTOL, NGATE_UPDATE_REL_L2 = 1e-5, 1e-2
# run_steps against run() across a padded-shape switch: (feed, n_steps)
# with feed 0 padded to 16 and feed 1 to 24 — 2 captures, 5 replays
NREPLAY_SCHEDULE = ((0, 2), (1, 3), (0, 2))
NMT_EAGER_STEPS, NMT_PROFILE_STEPS = 4, 3
# the bench's sweeps, cut for the script's time limit (bench_nmt.py: 200
# steps; 200 here until phase 17 came, 100 until phase 18 came, 50 until
# phases 12 (d) and 19 (c) came)
NMT_ITERS = 25
# device kernels by what they compute, for the NMT profile (first match
# wins): cuBLAS/CUTLASS GEMMs, reductions, copies, the rest elementwise
_NMT_CLASSES = (
    ("gemm", ("gemm", "nvjet", "cutlass", "xmma", "sm90_")),
    ("reduction", ("reduce",)),
    ("copy", ("copy", "memcpy", "memset", "fill", "catarray")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "index",
                     "where", "gather", "scatter")),
)


def nmt_class(key):
    return _kernel_class(key, _NMT_CLASSES)


def _lstm_inputs(rng, attrs, opts):
    """The lstm op's inputs at the bench's width: a ragged [b, t, 4h]
    projection, the recurrent weight, the bias ([1, 7h] with peepholes,
    else [1, 4h]) and ``opts`` of H0 / C0."""
    import torch
    from paddle_tpu_torch.core import LoDArray
    b, t, h = LSTM_BATCH, LSTM_STEPS, LSTM_WIDTH
    lengths = rng.randint(t // 2, t, size=b)
    lengths[:2] = (1, t)

    def f(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale)
                                .astype(np.float32))

    ins = {"Input": [LoDArray(f(b, t, 4 * h, scale=0.5),
                              torch.from_numpy(lengths.astype(np.int32)))],
           "Weight": [f(h, 4 * h, scale=1.0 / np.sqrt(h))],
           "Bias": [f(1, (7 if attrs["use_peepholes"] else 4) * h,
                      scale=0.1)]}
    for slot in opts:
        ins[slot] = [f(b, h, scale=0.5)]
    return ins


def lstm_op_checks():
    """The lstm op forward (Hidden, Cell) and its generic grad (Input,
    Weight, Bias, H0, C0 from random Hidden and Cell cotangents) on the
    card against the CPU, fp32 with TF32 off, for each of LSTM_CASES:
    the worst relative L2 within LSTM_REL_L2."""
    import torch
    _fp32()
    rng = np.random.RandomState(SEED)
    card, cpu = torch.device(DEVICE), torch.device("cpu")
    rows = []
    for label, attrs, opts in LSTM_CASES:
        ins = _lstm_inputs(rng, attrs, opts)
        outs = {"Hidden": ["hidden"], "Cell": ["cell"]}
        got = _run_op("lstm", ins, attrs, False, card, outs)
        want = _run_op("lstm", ins, attrs, False, cpu, outs)
        errs = {s: _rel_l2(got[s][0].data, want[s][0].data)
                for s in ("Hidden", "Cell")}
        gins = dict(ins, Hidden=want["Hidden"], Cell=want["Cell"])
        for s in ("Hidden", "Cell"):
            gins[s + "@GRAD"] = [torch.from_numpy(rng.randn(
                *want[s][0].shape).astype(np.float32))]
        gattrs = dict(attrs, __fwd_input_slots__=list(ins),
                      __fwd_output_slots__=["Hidden", "Cell"],
                      __fwd_op_uid__=1)
        gouts = {s + "@GRAD": [s] for s in ins}
        ggot = _run_op("lstm_grad", gins, gattrs, False, card, gouts)
        gwant = _run_op("lstm_grad", gins, gattrs, False, cpu, gouts)
        for s in gouts:
            a, b = ggot[s][0], gwant[s][0]
            errs[s] = _rel_l2(getattr(a, "data", a), getattr(b, "data", b))
        rows.append({"case": label, "rel_l2": errs,
                     "worst": max(errs.values())})
    for r in rows:
        r["ok"] = r["worst"] <= LSTM_REL_L2
    log("lstm op checks (card vs CPU, fp32, b%d t%d h%d): %s"
        % (LSTM_BATCH, LSTM_STEPS, LSTM_WIDTH, json.dumps(rows)))
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError("lstm disagrees, card vs CPU: %s" % bad)
    return rows


def build_nmt(batch, seq, amp):
    """bench_nmt.py's program through ``benchmarks.nmt.build_program``
    at ``batch`` x ``seq`` (the bench's widths and vocabulary), under one
    unique-name guard: (prog, startup, loss, feed)."""
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.benchmarks import nmt
    with unique_name.guard():
        prog, startup, loss, feed, _, _ = nmt.build_program(
            batch=batch, seq=seq, amp=amp)
    return prog, startup, loss, feed


def nmt_gate():
    """fp32 card-vs-CPU gate, TF32 off: the NMT program at NGATE_BATCH x
    NGATE_SEQ, NGATE_STEPS steps (``card_vs_cpu_steps``): per step the
    losses within NGATE_LOSS_RTOL and every persistable's update within
    NGATE_UPDATE_REL_L2 relative L2."""
    _fp32()
    prog, startup, loss, feed = build_nmt(NGATE_BATCH, NGATE_SEQ, False)
    return card_vs_cpu_steps(
        "nmt gate (card vs CPU, fp32, b%d s%d)" % (NGATE_BATCH, NGATE_SEQ),
        prog, startup, loss, feed, NGATE_STEPS, NGATE_LOSS_RTOL,
        NGATE_UPDATE_REL_L2)


def nmt_replay_feeds():
    """Two feeds of the gate's program at two padded shapes: batch
    NGATE_BATCH padded to a multiple of 8 (16), and to NGATE_SEQ + 8."""
    from paddle_tpu_torch.benchmarks import nmt
    pairs = nmt.synthetic_samples(2 * NGATE_BATCH, NGATE_SEQ,
                                  nmt.TRG_VOCAB, seed=2)
    return [nmt.make_feed(pairs[:NGATE_BATCH], pad_to_multiple=8),
            nmt.make_feed(pairs[NGATE_BATCH:], max_len=NGATE_SEQ + 8)]


def nmt_replay_gate(amp):
    """``run_steps`` against ``run`` on the NMT gate program (fp32 or
    amp), TF32 off, deterministic algorithms, from one state, over
    NREPLAY_SCHEDULE (a switch of padded shapes and back): every
    persistable and each dispatch's loss bitwise the ``run()`` calls';
    on the card 2 captures and 5 replays, no hand-written kernel."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import executor as pexe
    feeds = nmt_replay_feeds()
    with _deterministic() as warned:
        prog, startup, loss, _ = build_nmt(NGATE_BATCH, NGATE_SEQ, amp)
        state = _startup_state(startup)
        exe = fluid.Executor(fluid.CUDAPlace(0))
        ref = _copy_scope(fluid, state, exe.device)
        ref_losses = []
        for i, n in NREPLAY_SCHEDULE:
            for _ in range(n):
                ref_losses.append(exe.run(prog, feed=feeds[i],
                                          fetch_list=[loss], scope=ref)[0])
        got = _copy_scope(fluid, state, exe.device)
        exe = fluid.Executor(fluid.CUDAPlace(0))
        _zero_counts()
        losses = [exe.run_steps(prog, feed=feeds[i], n_steps=n,
                                fetch_list=[loss], scope=got)[0]
                  for i, n in NREPLAY_SCHEDULE]
        counts = dict(pexe.graph_launches)
        launches = _kernel_counts()
        differ = _bitwise(ref, got, state)
        exe.close()
        _sync()
    last = np.cumsum([n for _, n in NREPLAY_SCHEDULE]) - 1
    same = [bool(np.array_equal(a, ref_losses[i]))
            for a, i in zip(losses, last)]
    on_card = DEVICE == "cuda"
    misses = len({i for i, _ in NREPLAY_SCHEDULE})
    want = {"captures": misses,
            "replays": sum(n for _, n in NREPLAY_SCHEDULE) - misses} \
        if on_card else {"captures": 0, "replays": 0}
    res = {"amp": amp, "schedule": NREPLAY_SCHEDULE,
           "padded_shapes": [f["src_word_id"].shape for f in feeds],
           "losses": [float(v) for v in losses],
           "losses_bitwise": same, "persistables": len(state),
           "persistables_differing": differ, "graph_launches": counts,
           "nondeterministic_ops": warned}
    log("nmt run_steps vs run across padded shapes (%s, deterministic): "
        "%s" % ("amp" if amp else "fp32", json.dumps(res)))
    if differ or not all(same) or counts != want:
        raise AssertionError(
            "nmt run_steps differs from run (%s): %d persistables differ "
            "(%s), losses bitwise %s, graph launches %s (want %s)"
            % ("amp" if amp else "fp32", len(differ), differ[:5], same,
               counts, want))
    _counts_gate("nmt replay gate", launches, {})
    return res


def nmt_path(card_label=""):
    """bench_nmt.py's measured path at its full configuration through
    ``benchmarks.nmt.main()`` (the JSON line printed), its sweeps cut to
    NMT_ITERS steps: the padded baseline and the pooled schedule, each a
    warm sweep and 3 timed sweeps; the kernel and graph counts set to 0 just before
    and read just after, and per schedule its captures and peak memory.
    Gates: one capture per distinct padded shape, no compile-cache miss
    in the timed sweeps, the loss finite and falling over the sweeps,
    no hand-written kernel launched. Then the eager ``run()`` p50 and a
    profiled replay (device ms by class) of the baseline's step."""
    import torch
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import executor as pexe
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.benchmarks import nmt
    schedules = []
    real_measure = nmt._measure_schedule

    def measure(exe, prog, loss, schedule):
        before = dict(pexe.graph_launches)
        if DEVICE == "cuda":
            torch.cuda.reset_peak_memory_stats()
        out = real_measure(exe, prog, loss, schedule)
        schedules.append({
            "dispatches_a_sweep": len(schedule),
            "graph_launches": {k: pexe.graph_launches[k] - before[k]
                               for k in before},
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9
            if DEVICE == "cuda" else None})
        return out

    _zero_counts()
    nmt._measure_schedule = measure
    real_iters = nmt.ITERS
    nmt.ITERS = min(nmt.ITERS, NMT_ITERS)
    try:
        with unique_name.guard():
            rec = nmt.main()
    finally:
        nmt._measure_schedule = real_measure
        nmt.ITERS = real_iters
    launches, graphs = _kernel_counts(), dict(pexe.graph_launches)
    sweep_losses = {k: [float(h.numpy()[0]) for h in hs]
                    for k, hs in rec.pop("_handles").items()}
    shapes = {(s, t) for s, t, _ in rec["_shapes"]} | {(nmt.SEQ, nmt.SEQ)}
    base_ms = float(np.median(rec["_sweep_s"]["baseline"])) * 1e3 / \
        rec["iters"]
    pooled_ms = float(np.median(rec["_sweep_s"]["pooled"])) * 1e3 / \
        rec["pooled_steps"]
    # the eager step and a profiled replay of the baseline's step
    prog, startup, loss, feed = build_nmt(nmt.BATCH, nmt.SEQ, True)
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup)
        _, eager_ms = _train_steps(exe, prog, feed, loss,
                                   1 + NMT_EAGER_STEPS)
        exe.run_steps(prog, feed=feed, n_steps=2, fetch_list=[loss])
        prof = _profile_replay(exe, prog, feed, loss, NMT_PROFILE_STEPS,
                               nmt_class)
        exe.close()
    res = {"bench": {k: v for k, v in rec.items() if not k.startswith("_")},
           "card": card_label,
           "cut": "the sweeps to %d steps (bench_nmt.py: 200); else "
                  "bench_nmt.py's configuration (batch 64, max length 40, "
                  "vocab 30000, 512 wide, %d timed)"
                  % (rec["iters"], nmt.ROUNDS),
           "sweep_s": rec["_sweep_s"], "sweep_losses": sweep_losses,
           "padded_shapes": sorted(shapes),
           "pooled_shapes_steps": rec["_shapes"],
           "schedules": schedules,
           "step_ms_captured": {"baseline": base_ms, "pooled": pooled_ms},
           "step_ms_eager": eager_ms,
           "step_ms_eager_p50": float(np.percentile(eager_ms[1:], 50)),
           "replay_profile": prof,
           "replay_device_busy_ms": prof["device_busy_ms"],
           "replay_wall_ms": prof["wall_ms"],
           "replay_idle_share": 1.0 - prof["device_busy_ms"]
           / prof["wall_ms"],
           "telemetry": rec["_telemetry"],
           "launches": launches, "graph_launches": graphs,
           "peak_memory_gb": max((s["peak_memory_gb"] or 0.0)
                                 for s in schedules)
           if DEVICE == "cuda" else None}
    summary = {k: res[k] for k in (
        "card", "cut", "step_ms_captured", "step_ms_eager_p50",
        "replay_device_busy_ms", "replay_wall_ms", "replay_idle_share",
        "peak_memory_gb", "padded_shapes", "graph_launches", "schedules",
        "sweep_losses")}
    summary["replay_class_ms"] = prof["class_ms"]
    summary["replay_top_kernels_ms"] = prof["top_kernels_ms"]
    log("bench_nmt through the captured steps: %s" % json.dumps(summary))
    for k, ls in sweep_losses.items():
        if not (all(np.isfinite(ls)) and ls[-1] < ls[0]):
            raise AssertionError("nmt %s: sweep losses not finite and "
                                 "falling: %s" % (k, ls))
    want = len(shapes) if DEVICE == "cuda" else 0
    if graphs["captures"] != want:
        raise AssertionError("nmt: %d captures for %d padded shapes %s"
                             % (graphs["captures"], len(shapes),
                                sorted(shapes)))
    misses = [rec["pooled_compile_cache_misses"],
              rec["_telemetry"]["baseline"].get("compile_cache_misses", 0)]
    if any(misses):
        raise AssertionError("nmt: compile-cache misses in the timed "
                             "sweeps (pooled, baseline): %s" % misses)
    _counts_gate("nmt path", launches, {})
    return res


# -- phase 16: bench.py's ResNet line, fp8 stores, the three-line bench --

FP8_MODES = ("1", "e5m2", "scaled", "delayed")
FP8_SWEEP = (0.0, 1.0, 448.0, 463.0, 464.0, 465.0, 466.0, 472.0, 478.0,
             480.0, 872.0, 1e4, 57344.0, 61439.0, 61440.0, 61441.0, 1e6,
             2.0 ** -6, 2.0 ** -9, 2.0 ** -10, 3 * 2.0 ** -11, 2.0 ** -14,
             2.0 ** -16, 2.0 ** -17)
FP8_BN_REL_L2 = 1e-2
FP8_SCALE_RTOL = 1e-2
# phase 16 (c): the fp8 ResNet line's rounds, FP8_STEPS steps each — phase
# 11's, so that the two steps are timed alike
FP8_STEPS = RESNET_STEPS
# the three-line bench: bench.py's own smoke knobs (BENCH_BATCH stays
# with the ResNet line; the others reach the children); its wall-clock
# limit
THREE_LINE_KNOBS = {"BENCH_ITERS": "2", "BENCH_ROUNDS": "1", "BENCH_WARMUP": "1",
                "BENCH_BATCH": "8"}
THREE_LINE_TIMEOUT_S = 600


@contextlib.contextmanager
def _fp8_env(acts="1", conv_out="0"):
    """``PADDLE_TPU_FP8_ACTS`` / ``PADDLE_TPU_FP8_CONV_OUT`` set for the
    block (build and run), restored after."""
    names = ("PADDLE_TPU_FP8_ACTS", "PADDLE_TPU_FP8_CONV_OUT")
    old = {k: os.environ.get(k) for k in names}
    os.environ.update(dict(zip(names, (acts, conv_out))))
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _fp8_ulp(v, dtype):
    """One ulp of the fp8 ``dtype`` at each |value| (numpy float64)."""
    import torch
    mant, emin = (3, -6) if dtype == torch.float8_e4m3fn else (2, -14)
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** emin)))
    return 2.0 ** (e - mant)


def _stored_np(v):
    """(dequantized values, payload values, scale, fp8 dtype) of a stored
    conv output on the CPU, as float64 numpy."""
    from paddle_tpu_torch.core import ScaledFp8
    if isinstance(v, ScaledFp8):
        q = v.data.double().numpy()
        s = float(v.scale)
        return q * s, q, s, v.data.dtype
    q = v.double().numpy()
    return q, q, 1.0, v.dtype


def _cast_checks():
    """``cast_fp8`` on the card bit for bit against the CPU over the
    sweep, its negatives and random values, from bf16 and fp32; and what
    the card's plain ``Tensor.to`` gives at the sweep's overflow
    points."""
    import torch
    from paddle_tpu_torch.registry import cast_fp8
    rng = np.random.RandomState(SEED)
    sweep = np.array(FP8_SWEEP, np.float32)
    xs = np.concatenate([sweep, -sweep, rng.randn(4096) * 100,
                         rng.randn(4096) * 3e4, rng.randn(4096) * 1e-3])
    xs = torch.from_numpy(xs.astype(np.float32))
    rows = []
    for dt in (torch.float8_e4m3fn, torch.float8_e5m2):
        for src in (torch.bfloat16, torch.float32):
            x = xs.to(src)
            got = cast_fp8(x.to(DEVICE), dt).cpu().view(torch.uint8)
            want = cast_fp8(x, dt).view(torch.uint8)
            plain = x[:len(sweep)].to(DEVICE).to(dt).float().cpu()
            rows.append({"format": str(dt).split(".")[-1],
                         "source": str(src).split(".")[-1],
                         "values": len(xs),
                         "differ": int((got != want).sum()),
                         "plain_to_on_card": {
                             str(float(a)): float(b) for a, b in
                             zip(sweep, plain) if a >= 448}})
    return rows


def _conv_fp8_checks():
    """conv2d under each FP8_MODES mode (delayed seeding from 0.0 and
    from a seeded state) at phase 11's three NHWC geometries, amp, card
    against CPU: each element's dequantized stored value within one fp8
    ulp (at the larger payload, times the scale) plus one bf16 ulp of
    the CPU's, and ``Fp8ScaleOut`` within FP8_SCALE_RTOL."""
    import torch
    rng = np.random.RandomState(SEED + 1)
    b = RGATE_BATCH
    geoms = {"stem-7x7-s2-p3": ((b, 64, 64, 3), (64, 3, 7, 7), 2, 3),
             "3x3-s1-p1": ((b, 16, 16, 64), (64, 64, 3, 3), 1, 1),
             "1x1-s2": ((b, 16, 16, 256), (512, 256, 1, 1), 2, 0)}
    rows = []
    for name, (xs, ws, stride, pad) in geoms.items():
        x = torch.from_numpy(rng.randn(*xs).astype(np.float32))
        w = torch.from_numpy((rng.randn(*ws) / np.sqrt(np.prod(ws[1:])))
                             .astype(np.float32))
        attrs = {"strides": [stride] * 2, "paddings": [pad] * 2,
                 "dilations": [1, 1], "groups": 1, "data_format": "NHWC"}
        for mode, state in [(m, None) for m in FP8_MODES[:3]] + \
                [("delayed", 0.0), ("delayed", 0.02)]:
            ins = {"Input": [x], "Filter": [w]}
            if state is not None:
                ins["Fp8Scale"] = [torch.tensor([state])]
            with _fp8_env("1", mode):
                got = _run_op("conv2d", ins, attrs, True,
                              torch.device(DEVICE))
                want = _run_op("conv2d", ins, attrs, True,
                               torch.device("cpu"))
            gd, gq, gs, dt = _stored_np(got["Output"][0])
            wd, wq, ws_, _ = _stored_np(want["Output"][0])
            bound = _fp8_ulp(np.maximum(np.abs(gq), np.abs(wq)), dt) * \
                max(gs, ws_) + 2.0 ** -8 * np.abs(wd)
            err = np.abs(gd - wd)
            ok = bool(np.all((err <= bound) | (np.isnan(gd) & np.isnan(wd))))
            row = {"case": "%s %s%s" % (name, mode, "" if state is None else
                                        " state %g" % state),
                   "dtype": str(dt).split(".")[-1],
                   "max_err_over_bound": float(np.nanmax(err / bound)),
                   "same_payload": float(np.mean(gq == wq)),
                   "rel_l2": _rel_l2(torch.from_numpy(gd),
                                     torch.from_numpy(wd)), "ok": ok}
            if "Fp8ScaleOut" in want:
                a = float(got["Fp8ScaleOut"][0])
                c = float(want["Fp8ScaleOut"][0])
                row["next_scale"] = [a, c]
                row["ok"] = ok and abs(a - c) <= FP8_SCALE_RTOL * abs(c)
            rows.append(row)
    return rows


def _bn_fp8_checks():
    """batch_norm in training from e4m3, e5m2 and ``ScaledFp8`` input,
    amp, card against CPU: Y (bf16) within FP8_BN_REL_L2, the statistics
    within ROP_REL_L2."""
    import torch
    from paddle_tpu_torch.core import ScaledFp8
    from paddle_tpu_torch.registry import cast_fp8
    rng = np.random.RandomState(SEED + 2)
    c = 64
    x = torch.from_numpy((rng.randn(RGATE_BATCH, 16, 16, c) * 3 + 1)
                         .astype(np.float32)).to(torch.bfloat16)
    stored = {"e4m3": cast_fp8(x, torch.float8_e4m3fn),
              "e5m2": cast_fp8(x, torch.float8_e5m2),
              "scaled": ScaledFp8.quantize(x)}
    rows = []
    for name, v in stored.items():
        ins = {"X": [v], "Scale": [torch.ones(c)], "Bias": [torch.zeros(c)],
               "Mean": [torch.full((c,), 0.5)], "Variance": [torch.ones(c)]}
        attrs = {"epsilon": 1e-5, "momentum": 0.9, "data_layout": "NHWC"}
        got = _run_op("batch_norm", ins, attrs, True, torch.device(DEVICE))
        want = _run_op("batch_norm", ins, attrs, True, torch.device("cpu"))
        y = _rel_l2(got["Y"][0].float(), want["Y"][0].float())
        stats = max(_rel_l2(got[s][0], want[s][0]) for s in
                    ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance"))
        rows.append({"case": "batch_norm from " + name,
                     "y_dtype": str(got["Y"][0].dtype).split(".")[-1],
                     "y_rel_l2": y, "stats_rel_l2": stats,
                     "ok": y <= FP8_BN_REL_L2 and stats <= ROP_REL_L2
                     and got["Y"][0].dtype == torch.bfloat16})
    return rows


def build_fp8_net(fluid):
    """The reference's small conv net (``tests/ops/
    test_fp8_activations.py:17-40``): conv -> relu -> conv -> (+residual)
    -> relu -> avg pool -> fc, SGD(0.1), amp; and its feed."""
    import torch
    from paddle_tpu_torch import unique_name
    with unique_name.guard():
        prog, startup = fluid.Program(), fluid.Program()
        prog.random_seed = startup.random_seed = 5
        with fluid.program_guard(prog, startup):
            img = fluid.layers.data(name="img", shape=[8, 8, 8, 4],
                                    dtype="float32", append_batch_size=False)
            lbl = fluid.layers.data(name="lbl", shape=[8, 1], dtype="int64",
                                    append_batch_size=False)
            c1 = fluid.layers.conv2d(input=img, num_filters=8,
                                     filter_size=3, padding=1,
                                     data_format="NHWC")
            r1 = fluid.layers.relu(c1)
            c2 = fluid.layers.conv2d(input=r1, num_filters=8, filter_size=3,
                                     padding=1, data_format="NHWC")
            r2 = fluid.layers.relu(fluid.layers.elementwise_add(x=c2, y=r1))
            pooled = fluid.layers.pool2d(r2, pool_type="avg",
                                         global_pooling=True,
                                         data_format="NHWC")
            logits = fluid.layers.fc(
                input=fluid.layers.reshape(pooled, [8, 8]), size=3)
            loss = fluid.layers.mean(
                fluid.layers.softmax_with_cross_entropy(logits, lbl))
            fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        fluid.enable_mixed_precision(prog)
    rng = np.random.RandomState(0)
    feed = {"img": torch.from_numpy(rng.rand(8, 8, 8, 4).astype(np.float32)),
            "lbl": torch.from_numpy(rng.randint(0, 3, (8, 1)))}
    return prog, startup, loss, feed


def _no_fp8_grads():
    """One step of ``build_fp8_net`` on the card under each conv-out mode
    (and none), every value kept: the ``*_grad`` outputs of an fp8 dtype
    (there must be none) and the dtypes the relu and conv outputs took."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import executor as pexe
    from paddle_tpu_torch.registry import FP8_DTYPES
    real = pexe.trace_ops
    envs = []

    def keep_all(block, env, **kw):
        kw["drop"] = None
        out = real(block, env, **kw)
        envs.append((block, out))
        return out

    rows = []
    pexe.trace_ops = keep_all
    try:
        for mode in ("0",) + FP8_MODES:
            with _fp8_env("1", mode):
                prog, startup, loss, feed = build_fp8_net(fluid)
                with fluid.scope_guard(fluid.Scope()):
                    exe = fluid.Executor(fluid.CUDAPlace(0))
                    exe.run(startup)
                    envs.clear()
                    lv = float(exe.run(prog, feed=feed,
                                       fetch_list=[loss])[0])
            leaked, stored = [], {}
            for block, env in envs:
                for op in block.ops:
                    for names in op.outputs.values():
                        for n in names:
                            v = env.get(n)
                            dt = getattr(v, "dtype", None)
                            if op.type.endswith("_grad") and \
                                    dt in FP8_DTYPES:
                                leaked.append((op.type, n))
                            if op.type in ("relu", "conv2d") and \
                                    n in op.outputs.get("Out", []) + \
                                    op.outputs.get("Output", []):
                                stored[op.type] = "%s %s" % (
                                    type(v).__name__, dt)
            rows.append({"conv_out": mode, "loss": lv, "fp8_grads": leaked,
                         "stored": stored,
                         "ok": not leaked and bool(np.isfinite(lv))})
    finally:
        pexe.trace_ops = real
    return rows


def fp8_gates():
    """Phase 16 (a): the cast, conv2d's stores, batch norm from stored
    values, card against CPU; no fp8 gradient in a step of the small
    conv net under any mode. Raises on any failure."""
    res = {"cast": _cast_checks(), "conv2d": _conv_fp8_checks(),
           "batch_norm": _bn_fp8_checks(), "no_fp8_grads": _no_fp8_grads()}
    log("fp8 gates (card vs CPU): %s" % json.dumps(res))
    bad = [r for r in res["cast"] if r["differ"]] + \
        [r for k in ("conv2d", "batch_norm", "no_fp8_grads")
         for r in res[k] if not r["ok"]]
    if bad:
        raise AssertionError("fp8 gates failed: %s" % bad)
    return res


def fp8_replay_gate(mode):
    """``run_steps`` against ``run`` on phase 11's gate model under the
    fp8 recipe (``PADDLE_TPU_FP8_ACTS=1``, conv outputs ``mode``), amp,
    deterministic algorithms, from one state: RGATE_RUN_CALLS ``run()``
    calls then two ``run_steps(n_steps=RGATE_N_STEPS)`` against as many
    ``run()`` calls — every persistable (the ``Fp8Scale`` vars too) and
    both losses bitwise, 1 capture and 2 x RGATE_N_STEPS - 1 replays on
    the card, no hand-written kernel."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import executor as pexe
    feed = resnet_feed(RGATE_BATCH, RGATE_SIZE, RGATE_CLASSES)
    total = RGATE_RUN_CALLS + 2 * RGATE_N_STEPS
    with _fp8_env("1", mode), _deterministic() as warned, \
            _cudnn(deterministic=True, benchmark=False):
        prog, startup, loss = build_resnet(fluid, RESNET_DEPTH, RGATE_BATCH,
                                           RGATE_SIZE, RGATE_CLASSES,
                                           amp=True)
        state = _startup_state(startup)
        scales = sorted({n for op in prog.global_block().ops
                         if op.type == "conv2d"
                         for n in op.inputs.get("Fp8Scale", [])})
        exe = fluid.Executor(fluid.CUDAPlace(0))
        ref = _copy_scope(fluid, state, exe.device)
        ref_losses = [exe.run(prog, feed=feed, fetch_list=[loss],
                              scope=ref)[0] for _ in range(total)]
        got = _copy_scope(fluid, state, exe.device)
        exe = fluid.Executor(fluid.CUDAPlace(0))
        for _ in range(RGATE_RUN_CALLS):
            exe.run(prog, feed=feed, fetch_list=[loss], scope=got)
        _zero_counts()
        losses = [exe.run_steps(prog, feed=feed, n_steps=RGATE_N_STEPS,
                                fetch_list=[loss], scope=got)[0]
                  for _ in range(2)]
        counts, launches = dict(pexe.graph_launches), _kernel_counts()
        differ = _bitwise(ref, got, state)
        moved = [n for n in scales if not bool(
            (got.find_var(n).cpu() == state[n]).all())]
        exe.close()
        _sync()
    same = [bool(np.array_equal(a, ref_losses[i])) for a, i in
            zip(losses, (total - RGATE_N_STEPS - 1, total - 1))]
    want = {"captures": 1, "replays": 2 * RGATE_N_STEPS - 1} \
        if DEVICE == "cuda" else {"captures": 0, "replays": 0}
    res = {"conv_out": mode, "losses": [float(v) for v in losses],
           "losses_bitwise": same, "persistables": len(state),
           "fp8_scale_vars": len(scales), "fp8_scale_vars_moved": len(moved),
           "persistables_differing": differ, "graph_launches": counts,
           "nondeterministic_ops": warned}
    log("resnet run_steps vs run under fp8 (%s, amp, deterministic): %s"
        % (mode, json.dumps(res)))
    if differ or not all(same) or counts != want or \
            (mode == "delayed" and (not scales or len(moved) != len(scales))):
        raise AssertionError(
            "fp8 (%s) run_steps differs from run: %d persistables differ "
            "(%s), losses bitwise %s, graph launches %s (want %s), %d of %d "
            "scale vars moved" % (mode, len(differ), differ[:5], same,
                                  counts, want, len(moved), len(scales)))
    _counts_gate("fp8 replay gate", launches, {})
    return res


def fp8_resnet_path(card_label="", phase11=None):
    """Phase 16 (c): ``benchmarks.resnet.main()`` at bench.py's default
    recipe and full size, ``BENCH_RESNET_ONLY=1``, FP8_STEPS-step
    rounds x RESNET_ROUNDS after one warm dispatch (the JSON line
    printed). Around its rounds: one eager ``run()`` first (the first
    step's loss), and after them a profiled replay (device ms by class);
    the kernel and graph counts set to 0 just before and read just
    after. Gates: the loss finite and lower after the rounds than at the
    first step, one capture, no hand-written kernel, the precision
    string. Logged beside phase 11's bf16 step (``phase11``)."""
    import torch
    from paddle_tpu_torch import executor as pexe
    from paddle_tpu_torch import unique_name
    from paddle_tpu_torch.benchmarks import resnet
    extra = {}
    real_measure = resnet._measure_rounds

    def measure(exe, prog, loss, feed):
        extra["first_loss"] = float(exe.run(prog, feed=feed,
                                            fetch_list=[loss])[0])
        out = real_measure(exe, prog, loss, feed)
        extra["replay_profile"] = _profile_replay(
            exe, prog, feed, loss, RESNET_PROFILE_STEPS)
        extra["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9 \
            if DEVICE == "cuda" else None
        return out

    knobs = {"ITERS": FP8_STEPS, "ROUNDS": RESNET_ROUNDS,
             "WARMUP": FP8_STEPS, "BATCH": RESNET_BATCH,
             "DEPTH": RESNET_DEPTH, "IMAGE": RESNET_SIZE,
             "CLASSES": RESNET_CLASSES}
    old = {k: getattr(resnet, k) for k in knobs}
    old_only = os.environ.get("BENCH_RESNET_ONLY")
    for k, v in knobs.items():
        setattr(resnet, k, v)
    os.environ["BENCH_RESNET_ONLY"] = "1"
    resnet._measure_rounds = measure
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    try:
        with _fp8_env("", ""), unique_name.guard():
            for k in ("BENCH_FP8_ACTS", "BENCH_FP8_CONV_OUT"):
                os.environ.pop(k, None)
            rec = resnet.main()
    finally:
        resnet._measure_rounds = real_measure
        for k, v in old.items():
            setattr(resnet, k, v)
        if old_only is None:
            os.environ.pop("BENCH_RESNET_ONLY", None)
        else:
            os.environ["BENCH_RESNET_ONLY"] = old_only
    launches, graphs = _kernel_counts(), dict(pexe.graph_launches)
    prof = extra["replay_profile"]
    step_ms = float(np.median(rec["_round_s"])) * 1e3 / FP8_STEPS
    res = {"bench": {k: v for k, v in rec.items() if not k.startswith("_")},
           "card": card_label,
           "cut": "run_steps n_steps %d x %d rounds after one warm-up "
                  "dispatch (bench.py: 100 x 3)" % (FP8_STEPS,
                                                     RESNET_ROUNDS),
           "first_loss": extra["first_loss"], "final_loss": rec["loss"],
           "round_s": rec["_round_s"], "step_ms_captured": step_ms,
           "images_per_s": rec["value"], "mfu": rec["mfu"],
           "replay_profile": prof,
           "replay_device_busy_ms": prof["device_busy_ms"],
           "replay_wall_ms": prof["wall_ms"],
           "replay_idle_share": 1.0 - prof["device_busy_ms"]
           / prof["wall_ms"],
           "peak_memory_gb": extra["peak_memory_gb"],
           "launches": launches, "graph_launches": graphs}
    if phase11:
        res["phase11_bf16"] = {k: phase11.get(k) for k in (
            "images_per_s", "step_ms_captured", "replay_device_busy_ms",
            "mfu", "peak_memory_gb")}
        res["phase11_bf16"]["replay_class_ms"] = \
            phase11["replay_profile"]["class_ms"]
    summary = {k: res[k] for k in (
        "card", "cut", "images_per_s", "step_ms_captured", "mfu",
        "replay_device_busy_ms", "replay_idle_share", "peak_memory_gb",
        "first_loss", "final_loss", "graph_launches")}
    summary["replay_class_ms"] = prof["class_ms"]
    summary["replay_top_kernels_ms"] = prof["top_kernels_ms"]
    summary["phase11_bf16"] = res.get("phase11_bf16")
    log("bench.py's ResNet line (fp8 recipe) through benchmarks.resnet: %s"
        % json.dumps(summary))
    want_prec = "bf16+fp8-acts+fp8-convout-e5m2"
    if rec["precision"] != want_prec:
        raise AssertionError("resnet precision %r, want %r"
                             % (rec["precision"], want_prec))
    if not (np.isfinite(rec["loss"]) and np.isfinite(res["first_loss"])
            and rec["loss"] < res["first_loss"]):
        raise AssertionError("fp8 resnet loss not finite and falling: first "
                             "%s, after the rounds %s"
                             % (res["first_loss"], rec["loss"]))
    want = 1 if DEVICE == "cuda" else 0
    if graphs["captures"] != want:
        raise AssertionError("fp8 resnet: %d graph captures, want %d"
                             % (graphs["captures"], want))
    _counts_gate("fp8 resnet path", launches, {})
    return res


def three_line_bench():
    """Phase 16 (d): ``python -m paddle_tpu_torch.benchmarks.resnet`` at
    THREE_LINE_KNOBS (all but BENCH_BATCH reach its LM and NMT children) from
    the repo root: exactly three JSON lines, the ResNet line last, its
    ``submetrics.lm`` and ``.nmt`` numeric and without ``error``."""
    from paddle_tpu_torch.benchmarks import resnet
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BENCH_", "PADDLE_TPU_FP8"))}
    env.update(THREE_LINE_KNOBS)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    if DEVICE != "cuda":
        env["BENCH_FORCE_CPU"] = "1"
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m",
                        "paddle_tpu_torch.benchmarks.resnet"], cwd=REPO,
                       env=env, capture_output=True, text=True,
                       timeout=THREE_LINE_TIMEOUT_S)
    wall = time.perf_counter() - t0
    lines = [json.loads(ln) for ln in r.stdout.splitlines()
             if ln.startswith("{")]
    for ln in lines:
        print(json.dumps(ln))
    res = {"rc": r.returncode, "wall_s": wall, "lines": len(lines),
           "metrics": [ln.get("metric") for ln in lines]}
    log("three-line bench (%s): %s" % (" ".join(
        "%s=%s" % kv for kv in THREE_LINE_KNOBS.items()), json.dumps(res)))
    subs = lines[-1].get("submetrics", {}) if lines else {}
    bad = [n for n in ("lm", "nmt") if not isinstance(
        subs.get(n, {}).get("value"), (int, float)) or "error" in subs[n]]
    if r.returncode != 0 or len(lines) != 3 or \
            lines[-1].get("metric") != resnet.METRIC or bad:
        raise AssertionError(
            "three-line bench: rc %d, %d JSON lines %s, bad submetrics %s; "
            "stderr tail: %s" % (r.returncode, len(lines), res["metrics"],
                                 bad, r.stderr[-2000:]))
    res["submetrics"] = subs
    return res


# -- phase 17: inference deployment -----------------------------------------

# the served models at the repo's widths: bench.py's ResNet-50 (NHWC
# inside, 224x224, 1000 classes) and the stacked-LSTM classifier at
# benchmark/fluid/stacked_dynamic_lstm.py's widths (dict 5147, emb 128, hid
# 512, 3 LSTMs of alternating direction, 2 classes, 80 ids at most)
INFER_RESNET = {"depth": 50, "size": 224, "classes": 1000}
INFER_LSTM = {"dict_dim": 5147, "emb": 128, "hid": 512, "stacked": 3,
              "classes": 2, "max_len": 80}
INFER_BATCHES = (1, 3, 16)       # export_artifact traces at 4
INFER_CPU_BATCH = 2
INFER_REL_L2 = 1e-5              # the artifact against Executor.run
INFER_CPU_REL_L2 = 1e-4          # the card's artifact against the CPU
SERVE_REL_L2 = 1e-5              # a served output against its request alone
SERVE_THREADS = 16
SERVE_MAX_WAIT_MS = 5.0
# per model: requests, distinct samples among them (each request is held
# to its sample's run alone), the batcher's ceiling and bucket grid
SERVE_RUNS = {"resnet": {"requests": 256, "distinct": 256, "max_batch": 32,
                         "bucket": None},
              "lstm": {"requests": 1024, "distinct": 256, "max_batch": 64,
                       "bucket": 16}}
HTTP_CLIENTS, HTTP_PER_CLIENT, HTTP_DRAIN_REQUESTS = 4, 8, 32
HTTP_TIMEOUT_S = 120
INFER_LM_LAYERS, INFER_LM_BATCH, INFER_LM_CALLS = 2, 2, 2


def build_infer(fluid, kind):
    """Phase 17's ``kind`` ("resnet" or "lstm") for inference: (program,
    startup, prediction, feed names, max_seq_len); the weights the port's
    initializers draw from ``SEED``."""
    from paddle_tpu_torch import models, unique_name
    with unique_name.guard():
        prog, startup = fluid.Program(), fluid.Program()
        startup.random_seed = SEED
        with fluid.program_guard(prog, startup):
            if kind == "resnet":
                c = INFER_RESNET
                x = fluid.layers.data(name="images",
                                      shape=[3, c["size"], c["size"]],
                                      dtype="float32")
                pred = models.resnet_imagenet(
                    x, class_dim=c["classes"], depth=c["depth"],
                    data_format="NHWC")
                max_len = None
            else:
                c = INFER_LSTM
                x = fluid.layers.data(name="words", shape=[1], dtype="int64",
                                      lod_level=1)
                pred = models.stacked_lstm_net(
                    x, c["dict_dim"], class_dim=c["classes"],
                    emb_dim=c["emb"], hid_dim=c["hid"],
                    stacked_num=c["stacked"])
                max_len = c["max_len"]
    return prog, startup, pred, [x.name], max_len


def infer_samples(kind, n, seed, lengths=None):
    """``n`` single-request samples: images [3, s, s], or id sequences of
    ``lengths`` (default: half to all of the LSTM's max_len)."""
    rng = np.random.RandomState(seed)
    if kind == "resnet":
        s = INFER_RESNET["size"]
        return [rng.rand(3, s, s).astype(np.float32) for _ in range(n)]
    c = INFER_LSTM
    if lengths is None:
        lengths = rng.randint(c["max_len"] // 2, c["max_len"] + 1, size=n)
    return [rng.randint(0, c["dict_dim"], size=int(n_ids)).astype(np.int64)
            for n_ids in lengths]


def gate_lengths(batch):
    """The LSTM lengths of a parity batch: 1, max_len, then half to all
    of max_len."""
    m = INFER_LSTM["max_len"]
    rest = np.random.RandomState(batch).randint(m // 2, m + 1, size=batch)
    return ([1, m] + [int(n) for n in rest])[:batch]


def infer_feed(kind, samples):
    if kind == "resnet":
        return {"images": np.stack(samples)}
    return {"words": list(samples)}


def _rel(got, want):
    import torch
    return _rel_l2(torch.from_numpy(np.asarray(got, np.float64)),
                   torch.from_numpy(np.asarray(want, np.float64)))


def export_gate(kind, workdir):
    """Phase 17 (a), fp32 with TF32 off: the model pruned, exported (the
    trace at batch 4) and loaded back; the artifact against
    ``Executor.run`` of the pruned program on the card at INFER_BATCHES
    (LSTM lengths 1, max_len and 40-80) within INFER_REL_L2, against the
    CPU's run at INFER_CPU_BATCH within INFER_CPU_REL_L2;
    ``save_inference_model`` → ``load_inference_model`` → ``run``
    bitwise the original program. Returns (report, artifact, its
    directory)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io
    _fp32()
    prog, startup, pred, feeds, max_len = build_infer(fluid, kind)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    with fluid.scope_guard(scope):
        exe.run(startup)
    d = os.path.join(workdir, "artifact_" + kind)
    t0 = time.perf_counter()
    io.export_artifact(d, feeds, [pred], exe, main_program=prog, scope=scope,
                       max_seq_len=max_len)
    t1 = time.perf_counter()
    art = io.load_artifact(d)
    res = {"export_s": t1 - t0, "load_s": time.perf_counter() - t1,
           "artifact_mb": os.path.getsize(os.path.join(
               d, "__model__.pt2")) / 1e6,
           "graph_nodes": len(art.graph.nodes), "rel_l2": {}}
    infer = prog.prune([pred]).inference_optimize()

    def feed_at(batch, seed):
        return infer_feed(kind, infer_samples(
            kind, batch, seed, gate_lengths(batch) if kind == "lstm"
            else None))

    for batch in INFER_BATCHES:
        feed = feed_at(batch, batch)
        got = art.run(feed)[0]
        want = exe.run(infer, feed=feed, fetch_list=[pred.name],
                       scope=scope)[0]
        res["rel_l2"][batch] = _rel(got, want)
        if got.shape != want.shape or not \
                res["rel_l2"][batch] <= INFER_REL_L2:
            raise AssertionError(
                "%s artifact at batch %d: shape %s vs %s, rel L2 %.3g "
                "against Executor.run (limit %g)"
                % (kind, batch, got.shape, want.shape,
                   res["rel_l2"][batch], INFER_REL_L2))
    cpu_scope = _copy_scope(fluid, {n: scope.find_var(n)
                                    for n in scope.local_var_names()}, "cpu")
    feed = feed_at(INFER_CPU_BATCH, 99)
    cpu = fluid.Executor(fluid.CPUPlace()).run(
        infer, feed=feed, fetch_list=[pred.name], scope=cpu_scope)[0]
    res["rel_l2_vs_cpu"] = _rel(art.run(feed)[0], cpu)
    if not res["rel_l2_vs_cpu"] <= INFER_CPU_REL_L2:
        raise AssertionError("%s artifact against the CPU at batch %d: rel "
                             "L2 %.3g (limit %g)"
                             % (kind, INFER_CPU_BATCH,
                                res["rel_l2_vs_cpu"], INFER_CPU_REL_L2))
    md = os.path.join(workdir, "model_" + kind)
    with fluid.scope_guard(scope):
        io.save_inference_model(md, feeds, [pred], exe, main_program=prog)
    with fluid.scope_guard(fluid.Scope()):
        lprog, lfeeds, lfetch = io.load_inference_model(md, exe)
        loaded = exe.run(lprog, feed=feed, fetch_list=lfetch)[0]
    orig = exe.run(infer, feed=feed, fetch_list=[pred.name], scope=scope)[0]
    if lfeeds != feeds or not np.array_equal(loaded, orig):
        raise AssertionError("%s: load_inference_model's run is not the "
                             "program's bit for bit (feeds %s, max |diff| "
                             "%.3g)" % (kind, lfeeds, float(np.abs(
                                 loaded - orig).max())))
    res["inference_model_bitwise"] = True
    log("phase 17 (a) %s: %s" % (kind, json.dumps(res)))
    return res, art, d


def _percentile(xs, p):
    return float(np.percentile(np.asarray(xs), p))


def serve_gate(kind, art):
    """Phase 17 (b): SERVE_RUNS[kind]'s requests through
    ``InferenceSession.from_artifact`` → ``MicroBatcher``, from
    SERVE_THREADS threads, each sending its share one at a time. Gates:
    no error, mean occupancy > 1, every output within SERVE_REL_L2 of
    ``artifact.run`` on its sample alone. Records requests/s, latency
    p50/p99, occupancy, the shapes run, and one full window's wall
    against device-busy ms. Returns (report, (samples, their outputs
    alone))."""
    import threading
    import torch
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.serving import InferenceSession, MicroBatcher
    run = SERVE_RUNS[kind]
    name = art.feed_names[0]
    samples = infer_samples(kind, run["distinct"], seed=17)
    t0 = time.perf_counter()
    alone = [art.run(infer_feed(kind, [s]))[0][0] for s in samples]
    alone_s = time.perf_counter() - t0
    rng = np.random.RandomState(SEED)
    order = rng.permutation(np.resize(np.arange(len(samples)),
                                      run["requests"]))
    session = InferenceSession.from_artifact(art,
                                             bucket_multiple=run["bucket"])
    batcher = MicroBatcher(session, max_batch_size=run["max_batch"],
                           max_wait_ms=SERVE_MAX_WAIT_MS,
                           queue_depth=run["requests"])
    c0 = profiler.get_counters()
    outs, lat, errors = [None] * len(order), [None] * len(order), []

    def client(t):
        for i in range(t, len(order), SERVE_THREADS):
            try:
                p = batcher.submit({name: samples[order[i]]})
                outs[i] = p.wait(HTTP_TIMEOUT_S)[0]
                lat[i] = (p.t_done - p.t_enqueue) * 1e3
            except Exception as e:
                errors.append("request %d: %s: %s" % (i, type(e).__name__,
                                                      e))

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(SERVE_THREADS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    drained = batcher.close(60)
    c1 = profiler.get_counters()

    def delta(k):
        return c1.get(k, 0.0) - c0.get(k, 0.0)
    batches = delta("serving_batches_total")
    occupancy = delta("serving_batched_requests_total") / max(batches, 1)
    worst = max((_rel(outs[i], alone[order[i]]) for i in range(len(order))
                 if outs[i] is not None), default=float("inf"))
    # one full window, profiled: wall against device-busy
    window = [{name: s} for s in samples[:run["max_batch"]]]
    session.run_many(window)
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if DEVICE == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t1 = time.perf_counter()
        session.run_many(window)
        _sync()
        window_ms = (time.perf_counter() - t1) * 1e3
    kp = _kernel_profile(prof, 1)
    res = {"requests": len(order), "distinct_samples": len(samples),
           "threads": SERVE_THREADS, "max_batch_size": run["max_batch"],
           "max_wait_ms": SERVE_MAX_WAIT_MS,
           "bucket_multiple": run["bucket"],
           "requests_per_s": len(order) / wall, "wall_s": wall,
           "latency_ms_p50": _percentile([x for x in lat if x is not None],
                                         50) if any(lat) else None,
           "latency_ms_p99": _percentile([x for x in lat if x is not None],
                                         99) if any(lat) else None,
           "mean_occupancy": occupancy, "batches": batches,
           "compiled_shapes": sorted(session.compiled_shapes,
                                     key=lambda s: (s[0] or 0, s[1])),
           "worst_rel_l2_vs_alone": worst, "alone_runs_s": alone_s,
           "window": {"requests": len(window), "wall_ms": window_ms,
                      "device_busy_ms": kp["device_busy_ms"],
                      "idle_share": 1.0 - kp["device_busy_ms"] / window_ms,
                      "class_ms": kp["class_ms"]},
           "tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                    "cudnn": torch.backends.cudnn.allow_tf32},
           "drained": drained, "errors": errors[:5]}
    log("phase 17 (b) %s served: %s" % (kind, json.dumps(res)))
    if errors or not drained:
        raise AssertionError("%s served: %d errors %s, drained %s"
                             % (kind, len(errors), errors[:3], drained))
    if not worst <= SERVE_REL_L2:
        raise AssertionError("%s served: an output %.3g rel L2 from its "
                             "request alone (limit %g)"
                             % (kind, worst, SERVE_REL_L2))
    if not occupancy > 1.0:
        raise AssertionError("%s served: mean occupancy %.2f (no batching)"
                             % (kind, occupancy))
    return res, (samples, alone)


def start_serve_cli(art_dir):
    """``python -m paddle_tpu_torch.serving.serve --artifact art_dir`` as
    a child process on a free port; it boots while the caller goes on."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving.serve",
         "--artifact", art_dir, "--port", "0"], cwd=REPO, env=env,
        stderr=subprocess.PIPE, text=True)


def stop_child(proc):
    if proc.poll() is None:
        proc.kill()
        proc.wait(30)
    proc.stderr.close()


def _start_line(proc, timeout):
    """The child's ``serve: http://`` line (the lines before it, warnings,
    skipped), or the last line read when it exits or ``timeout`` passes
    first."""
    import threading
    box = [""]

    def read():
        for line in proc.stderr:
            box[0] = line
            if line.startswith("serve: http://"):
                return

    t = threading.Thread(target=read, daemon=True)
    t.start()
    t.join(timeout)
    return box[0]


def _infer_post(url, body, request_id=None):
    """(status, headers, JSON body) of one POST /v1/infer."""
    headers = {"Content-Type": "application/json"}
    if request_id:
        headers["X-Request-Id"] = request_id
    req = urllib.request.Request(url + "/v1/infer",
                                 data=json.dumps(body).encode(),
                                 headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT_S) as r:
            return r.status, r.headers, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, e.headers, json.loads(e.read())


def http_gate(proc, samples, alone):
    """Phase 17 (c): ``python -m paddle_tpu_torch.serving.serve
    --artifact`` as a child (``proc``, from ``start_serve_cli``; stopped
    here); HTTP_CLIENTS ``ServingClient``s send
    HTTP_PER_CLIENT requests each: every response 200 with its outputs
    within SERVE_REL_L2 of the sample's run alone and its X-Request-Id
    echoed; /metrics shows the occupancy; a bad feed is a 400 naming the
    feed. Then HTTP_DRAIN_REQUESTS requests in flight and SIGTERM:
    /healthz answers 503, every one of them completes 200, and the child
    exits 0."""
    import signal
    import threading
    from paddle_tpu_torch.serving import ServingClient
    t0 = time.perf_counter()
    try:
        line = _start_line(proc, HTTP_TIMEOUT_S)
        if not line.startswith("serve: http://"):
            raise AssertionError("serve --artifact did not start: %r"
                                 % line)
        start_s = time.perf_counter() - t0
        url = line.split()[1]
        echoed, errors = [], []

        class EchoClient(ServingClient):
            def _request(self, path, data=None, request_id=None, **kw):
                out = ServingClient._request(self, path, data=data,
                                             request_id=request_id, **kw)
                if data is not None:
                    echoed.append((request_id, out[2].get("X-Request-Id"),
                                   out[0]))
                return out

        def client(ci):
            c = EchoClient(url)
            for j in range(HTTP_PER_CLIENT):
                k = (ci * HTTP_PER_CLIENT + j) % len(samples)
                try:
                    (out,) = c.infer({"words": samples[k]})
                    rel = _rel(out, alone[k])
                    if not rel <= SERVE_REL_L2:
                        errors.append("sample %d: rel L2 %.3g" % (k, rel))
                except Exception as e:
                    errors.append("%s: %s" % (type(e).__name__, e))

        threads = [threading.Thread(target=client, args=(ci,))
                   for ci in range(HTTP_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        bad_echo = [e for e in echoed if e[0] != e[1] or e[2] != 200]
        metrics = ServingClient(url).metrics()
        occupancy = metrics["paddle_tpu_serving_batched_requests_total"] / \
            max(metrics["paddle_tpu_serving_batches_total"], 1.0)
        code, _, body = _infer_post(url, {"feeds": {"ids": [1, 2]}})
        bad_feed = (code, body.get("error", ""))
        # read after the bad feed: it was admitted (and counted) before
        # its batch refused it
        admitted = ServingClient(url).metrics()[
            "paddle_tpu_serving_requests_total"]
        # requests in flight, then SIGTERM
        statuses = [None] * HTTP_DRAIN_REQUESTS

        def drain_client(i):
            try:
                statuses[i] = _infer_post(
                    url, {"feeds": {"words": samples[i % len(samples)]
                                    .tolist()}})[0]
            except OSError as e:
                statuses[i] = "%s: %s" % (type(e).__name__, e)

        drainers = [threading.Thread(target=drain_client, args=(i,))
                    for i in range(HTTP_DRAIN_REQUESTS)]
        for t in drainers:
            t.start()
        deadline = time.perf_counter() + 30
        while time.perf_counter() < deadline and ServingClient(
                url).metrics()["paddle_tpu_serving_requests_total"] < \
                admitted + HTTP_DRAIN_REQUESTS:
            time.sleep(0.002)
        pending = sum(s is None for s in statuses)
        proc.send_signal(signal.SIGTERM)
        health = []
        while time.perf_counter() < deadline:
            try:
                with urllib.request.urlopen(url + "/healthz",
                                            timeout=5) as r:
                    health.append(r.status)
            except urllib.error.HTTPError as e:
                health.append(e.code)
            except OSError:
                break                       # the listener has stopped
            time.sleep(0.002)
        for t in drainers:
            t.join()
        rc = proc.wait(60)
    finally:
        stop_child(proc)
    res = {"start_wait_s": start_s, "requests": len(echoed),
           "echo_mismatches": len(bad_echo), "errors": errors[:5],
           "metrics_occupancy": occupancy,
           "metrics_batches": metrics["paddle_tpu_serving_batches_total"],
           "bad_feed": bad_feed, "drain_pending_at_sigterm": pending,
           "drain_statuses": sorted({str(s) for s in statuses}),
           "healthz_after_sigterm": sorted(set(health)), "exit_code": rc,
           "wall_s": time.perf_counter() - t0}
    log("phase 17 (c) serve --artifact over HTTP: %s" % json.dumps(res))
    if errors or bad_echo or len(echoed) != HTTP_CLIENTS * HTTP_PER_CLIENT:
        raise AssertionError("serve CLI: %d responses, %d id echoes wrong, "
                             "errors %s" % (len(echoed), len(bad_echo),
                                            errors[:3]))
    if not occupancy >= 1.0:
        raise AssertionError("serve CLI: /metrics occupancy %r" % occupancy)
    if bad_feed[0] != 400 or "'words'" not in bad_feed[1]:
        raise AssertionError("serve CLI: a bad feed answered %r"
                             % (bad_feed,))
    if 503 not in health or any(s != 200 for s in statuses) or rc != 0:
        raise AssertionError(
            "serve CLI drain: /healthz after SIGTERM %s (want a 503), the "
            "in-flight requests %s (want 200), exit code %s (want 0)"
            % (sorted(set(health)), sorted({str(s) for s in statuses}),
               rc))
    return res


def lm_export_gate(workdir):
    """Phase 17 (d): ``transformer_lm`` at bench_lm.py's widths and
    INFER_LM_LAYERS layers, bf16 under amp, exported on the card. Its
    graph holds K1 as ``paddle_tpu::flash_fwd`` once a layer; each of
    INFER_LM_CALLS calls of the artifact launches K1 once a layer and no
    other kernel, and never takes the plain version; the logits within
    BF16_TOL of ``Executor.run``. Returns the report with the calls'
    launches."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import io, models, unique_name
    from paddle_tpu_torch.ops import flash_attention as fa
    with unique_name.guard():
        prog, startup = fluid.Program(), fluid.Program()
        startup.random_seed = SEED
        with fluid.program_guard(prog, startup):
            ids = fluid.layers.data(name="ids", shape=[LM_SEQ],
                                    dtype="int64")
            logits = models.transformer_lm(
                ids, LM_VOCAB, num_layers=INFER_LM_LAYERS, d_model=LM_DIM,
                num_heads=LM_HEADS, max_len=LM_SEQ)
        fluid.enable_mixed_precision(prog)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    with fluid.scope_guard(scope):
        exe.run(startup)
    d = os.path.join(workdir, "artifact_lm")
    t0 = time.perf_counter()
    io.export_artifact(d, ["ids"], [logits], exe, main_program=prog,
                       scope=scope)
    t1 = time.perf_counter()
    art = io.load_artifact(d)
    load_s = time.perf_counter() - t1
    ops = [str(n.target) for n in art.graph.nodes if n.op == "call_function"]
    feed = {"ids": np.random.RandomState(SEED).randint(
        0, LM_VOCAB, (INFER_LM_BATCH, LM_SEQ)).astype(np.int64)}
    want = exe.run(prog.prune([logits]).inference_optimize(), feed=feed,
                   fetch_list=[logits.name], scope=scope)[0]
    plain = [0]
    real_plain = fa._fwd_plain

    def counted(*a, **k):
        plain[0] += 1
        return real_plain(*a, **k)

    _reset_kernel_counts()
    fa._fwd_plain = counted
    try:
        for _ in range(INFER_LM_CALLS):
            got = art.run(feed)[0]
    finally:
        fa._fwd_plain = real_plain
    launches = {n: c for n, c in _kernel_counts().items() if c}
    calls = INFER_LM_CALLS * INFER_LM_LAYERS
    want_launches = {"flash_fwd": calls} if DEVICE == "cuda" else {}
    err = float(np.abs(got.astype(np.float32) - want).max())
    res = {"export_s": t1 - t0, "load_s": load_s,
           "flash_fwd_ops_in_graph": ops.count("paddle_tpu.flash_fwd.default"),
           "calls": INFER_LM_CALLS, "launches": launches,
           "plain_calls": plain[0], "max_abs_err_vs_executor": err,
           "dtype": str(got.dtype)}
    log("phase 17 (d) transformer_lm artifact: %s" % json.dumps(res))
    if res["flash_fwd_ops_in_graph"] != INFER_LM_LAYERS:
        raise AssertionError("LM artifact: %d paddle_tpu::flash_fwd nodes "
                             "for %d layers" % (res["flash_fwd_ops_in_graph"],
                                                INFER_LM_LAYERS))
    _counts_gate("phase 17 (d)", _kernel_counts(), want_launches)
    if DEVICE == "cuda" and plain[0]:
        raise AssertionError("LM artifact took the plain version %d times "
                             "on the card" % plain[0])
    np.testing.assert_allclose(got.astype(np.float32), want, **BF16_TOL)
    return res


# -- phase 18: disaggregated serving -----------------------------------------

# bench_lm.py's widths at its own depth; requests share one system prompt
# of DIS_PREFIX tokens (32 full pages at PAGE 16), each with a seeded
# suffix and budget (inclusive ranges). The tier-kill run's suffixes are
# long enough to reach a page past the shared ones, so each of its decode
# prefills consults the tier
DIS_LAYERS, DIS_PREFIX, DIS_SUFFIX, DIS_NEW = 12, 512, (16, 64), (16, 32)
DIS_KILL_SUFFIX = (24, 64)
DIS_REQUESTS, DIS_KILL_REQUESTS = 16, 8
DIS_SLOTS, DIS_BUCKETS, DIS_MEGASTEP_K = 16, "64,128,640", 8
DIS_CHECK_PAGES = 64            # the bitwise-transit engines' pools
DIS_BOOT_S, DIS_HANG_S = 300, 600


def dis_requests(n, seed, prefix, suffix=None):
    """``n`` prompts of ``prefix`` plus a seeded suffix (DIS_SUFFIX tokens
    unless given), and their budgets."""
    suffix = suffix or DIS_SUFFIX
    rng = np.random.RandomState(seed)
    prompts = [np.concatenate([prefix, rng.randint(
        0, VOCAB, size=int(rng.randint(suffix[0], suffix[1] + 1)))]).astype(
            np.int32) for _ in range(n)]
    budgets = [int(b) for b in rng.randint(DIS_NEW[0], DIS_NEW[1] + 1,
                                           size=n)]
    return prompts, budgets


def dis_decoders(workdir):
    """The phase's decoder (DIS_LAYERS layers at the serving widths, seed
    SEED) written with ``save_decoder`` in fp32 and as its bf16 twin."""
    import torch
    from paddle_tpu_torch.serving import TransformerDecoderModel, \
        save_decoder
    dirs = {}
    m32 = TransformerDecoderModel(VOCAB, dim=DIM, n_heads=HEADS,
                                  n_layers=DIS_LAYERS, ffn_mult=FFN_MULT)
    p32 = m32.init_params(SEED, device="cpu")
    for label, dtype in (("fp32", torch.float32),
                         ("bf16", torch.bfloat16)):
        m = TransformerDecoderModel(VOCAB, dim=DIM, n_heads=HEADS,
                                    n_layers=DIS_LAYERS, ffn_mult=FFN_MULT,
                                    dtype=dtype)
        p = {k: ([{n: t.to(dtype) for n, t in b.items()} for b in v]
                 if k == "blocks" else v.to(dtype)) for k, v in p32.items()}
        dirs[label] = os.path.join(workdir, "dis_" + label)
        save_decoder(dirs[label], m, p)
    return dirs


def megastep_generate(engine, prompts, budgets):
    """Greedy streams through ``prefill`` and megasteps of the engine's
    ``megastep_k`` trips (each slot capped at its budget less the
    prefill's token): what the scheduler's megastep loop emits."""
    n = len(prompts)
    out, stats = [], []
    left = np.zeros(engine.max_slots, np.int64)
    for i, (p, b) in enumerate(zip(prompts, budgets)):
        logits = engine.prefill(i, p, max_new_tokens=b)
        stats.append(dict(engine.last_prefill_stats))
        out.append([int(np.argmax(logits))])
        left[i] = b - 1
        if left[i] > 0:
            engine.set_input_token(i, out[i][0])
        else:
            engine.release(i)
    step = 0
    while engine.active.any():
        r = engine.megastep_decode(SEED, step, k_eff=engine.megastep_k,
                                   caps=left.copy())
        step += r["trips"]
        for i in range(n):
            if engine.active[i]:
                toks = [int(t) for t in r["out"][:, i] if t >= 0]
                out[i].extend(toks)
                left[i] -= len(toks)
                if left[i] <= 0:
                    engine.release(i)
    return out, stats


def _spans(name, since):
    """(ms, pages) of each ``name`` span of the trace ring that began at
    or after wall time ``since`` (seconds)."""
    from paddle_tpu_torch.observability import tracing
    return [(e["dur"] / 1e3, int(e["args"].get("pages", 0)))
            for e in tracing.trace_events()
            if e["name"] == name and e["ts"] >= since * 1e6]


def _rows_equal(a, pa_ids, b, pb_ids):
    """Pool rows ``pa_ids`` of engine ``a`` bitwise rows ``pb_ids`` of
    engine ``b``: K and V of every layer, and the scales of a quantized
    pool."""
    import torch
    ia = torch.tensor(pa_ids, dtype=torch.long, device=a.device)
    ib = torch.tensor(pb_ids, dtype=torch.long, device=b.device)
    ta = a._kp + a._vp + (a._ks or []) + (a._vs or [])
    tb = b._kp + b._vp + (b._ks or []) + (b._vs or [])
    return 0 < len(pa_ids) == len(pb_ids) and len(ta) == len(tb) and all(
        torch.equal(x.view(torch.uint8).index_select(0, ia),
                    y.view(torch.uint8).index_select(0, ib))
        for x, y in zip(ta, tb))


def _publish_cached(engine, client, prompt):
    """Publish the prompt's full pages from ``engine``'s prefix cache
    (where its prefill left them); returns (entry path, pages)."""
    keys, pids = engine.prefix_cache.match(prompt, len(prompt) // PAGE)
    return client.publish_now(engine, keys, pids), len(pids)


def _mapped(engine, prompt):
    """The pool rows ``engine``'s prefix cache maps for the prompt's
    pages below its last token — what a prefill maps or imports (a page
    the prompt fills to its end is computed by the prefill itself)."""
    return engine.prefix_cache.match(prompt, (len(prompt) - 1) // PAGE)[1]


def disagg_engine_gates(dirs, prompts, budgets, extra, workdir):
    """Phase 18 (a), in-process. An exporting engine self-prefills and
    greedy-decodes ``prompts`` (plus ``extra``, the later runs'
    prompts), and publishes every prompt's full pages through
    ``PrefixTierClient.publish_now``; a second engine with the tier
    client captures a megastep trip on a warm-up prompt FIRST, then maps
    the pages and decodes the prompts in megasteps. Gates: both engines'
    fp32 streams equal full recompute; no recapture (the trip captured
    before the import reads the imported pages); the pool tensors keep
    their addresses; every prompt maps the shared prefix; the mapped
    pages equal the exported ones bitwise; kv_transfer_pages_imported_total
    > 0. The same with int8 pages (pages and scales bitwise, the stream
    match printed), and a bitwise transit of bf16 and fp8 pages. K3 and
    K3-quant launched as the engines' steps and trips count, the plain K3
    never on the card. Returns the report and the reference streams of
    ``prompts + extra``."""
    from paddle_tpu_torch.observability import catalog
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.serving import (PagedDecodeEngine,
                                          PrefixTierClient,
                                          full_recompute_generate,
                                          greedy_generate, kv_transfer,
                                          load_decoder)
    t0 = time.perf_counter()
    models = {k: load_decoder(d, device=DEVICE) for k, d in dirs.items()}
    shared = DIS_PREFIX // PAGE

    def engine(label="fp32", quant="off", tier=None, megastep_k=1,
               slots=DIS_SLOTS, num_pages=0):
        model, params = models[label]
        return PagedDecodeEngine(
            model, params, max_slots=slots, max_len=MAX_LEN,
            prefill_buckets=DIS_BUCKETS, page_size=PAGE,
            num_pages=num_pages, kv_quant_dtype=quant,
            megastep_k=megastep_k, prefix_tier=tier, device=DEVICE)

    plain = [0]
    real_plain = pa.paged_decode_attention_plain

    def counted(*a, **k):
        plain[0] += 1
        return real_plain(*a, **k)

    pa.paged_decode_attention_plain = counted
    pa.launches = pa.launches_quant = 0
    imported0 = catalog.KV_TRANSFER_PAGES_IMPORTED.value()
    try:
        model, params = models["fp32"]
        everything = prompts + extra[0]
        all_budgets = budgets + extra[1]
        ref = full_recompute_generate(model, params, everything,
                                      all_budgets, max_len=MAX_LEN)
        # the exporter: self-prefill (the shared prefix once, then mapped
        # from its own cache), then publish every prompt's full pages
        a = engine()
        self_streams = []
        for i in range(0, len(everything), DIS_SLOTS):
            self_streams += greedy_generate(
                a, everything[i:i + DIS_SLOTS],
                all_budgets[i:i + DIS_SLOTS])
        store = os.path.join(workdir, "dis_store_a")
        client = PrefixTierClient(store_root=store, tier_url="")
        _sync()
        t1 = time.perf_counter()
        exported = [_publish_cached(a, client, p) for p in prompts]
        export_s = time.perf_counter() - t1
        entry_mb = max(kv_transfer.entry_bytes(path)
                       for path, _ in exported) / 1e6
        # the importer: a trip captured before any import
        b = engine(tier=PrefixTierClient(store_root=store, tier_url=""),
                   megastep_k=DIS_MEGASTEP_K)
        warm = np.random.RandomState(SEED + 17).randint(
            0, VOCAB, 3 * PAGE + 5).astype(np.int32)
        b.prefill(0, warm, max_new_tokens=DIS_MEGASTEP_K + 1)
        b.set_input_token(0, 1)
        b.megastep_decode(SEED, 0, k_eff=DIS_MEGASTEP_K)
        b.release(0)
        graph = b._ms.graphs.get(False) if b._ms is not None else None
        captures = dict(b.trip_stats)
        pools = b._kp + b._vp
        ptrs = [t.data_ptr() for t in pools]
        mark = time.time()
        streams, stats = megastep_generate(b, prompts, budgets)
        _sync()
        imports = _spans("kv.transfer_import", mark)
        same_graph = graph is None or b._ms.graphs.get(False) is graph
        kept = [t.data_ptr() for t in b._kp + b._vp] == ptrs and all(
            x is y for x, y in zip(pools, b._kp + b._vp))
        bitwise = sum(_rows_equal(a, _mapped(a, p), b, _mapped(b, p))
                      for p in prompts)
        cold = sum(1 for st in stats if st["prefix_hit_pages"] < shared)
        n = len(prompts)
        res = {"prompts": n, "layers": model.n_layers,
               "streams_equal_recompute": sum(
                   x == y for x, y in zip(streams, ref[:n])),
               "self_streams_equal_recompute": sum(
                   x == y for x, y in zip(self_streams, ref)),
               "imported_pages": sum(st["imported_pages"] for st in stats),
               "prefix_hit_pages_min": min(st["prefix_hit_pages"]
                                           for st in stats),
               "cold_prefix_computes": cold,
               "pages_bitwise_prompts": bitwise,
               "captures_before_import": {k: captures[k] for k in (
                   "captures_greedy", "warmups")},
               "trip_stats_after": dict(b.trip_stats),
               "recaptured": not same_graph, "pool_addresses_kept": kept,
               "export_ms_per_page": export_s * 1e3 / sum(
                   k for _, k in exported),
               # the first import maps a whole chain; each later one
               # reads (and md5-verifies) a whole entry for the few pages
               # past the shared prefix
               "import_ms_per_page": sum(ms for ms, _ in imports) /
               max(sum(k for _, k in imports), 1),
               "first_import": {"ms": imports[0][0], "pages": imports[0][1]}
               if imports else None,
               "imports": len(imports), "entry_mb": entry_mb}
        if res["streams_equal_recompute"] != n or \
                res["self_streams_equal_recompute"] != len(ref) or \
                res["imported_pages"] <= 0 or cold or bitwise != n or \
                not same_graph or not kept or \
                b.trip_stats["captures_greedy"] != \
                captures["captures_greedy"] or \
                (DEVICE == "cuda" and (captures["captures_greedy"] != 1 or
                                       b.trip_stats["loop_launches"] <= 0)):
            raise AssertionError("phase 18 (a) fp32 import: %s"
                                 % json.dumps(res))
        want_k3 = launch_want(a.trip_stats, model.n_layers) + \
            launch_want(b.trip_stats, model.n_layers)
        del a, b
        # int8 pages: the same through K3-quant, pages and scales bitwise
        store_q = os.path.join(workdir, "dis_store_q")
        aq = engine(quant="int8")
        q_self = greedy_generate(aq, prompts, budgets)
        cq = PrefixTierClient(store_root=store_q, tier_url="")
        for p in prompts:
            _publish_cached(aq, cq, p)
        bq = engine(quant="int8", tier=PrefixTierClient(store_root=store_q,
                                                         tier_url=""))
        q_streams = greedy_generate(bq, prompts, budgets)
        q_imported = bq.last_prefill_stats["imported_pages"]
        q_bitwise = sum(_rows_equal(aq, _mapped(aq, p), bq, _mapped(bq, p))
                        for p in prompts)
        res["int8"] = {"pages_bitwise_prompts": q_bitwise,
                       "token_match_vs_self_prefill":
                           match_fraction(q_self, q_streams),
                       "imported_pages_last": q_imported}
        want_quant = launch_want(aq.trip_stats, model.n_layers) + \
            launch_want(bq.trip_stats, model.n_layers)
        if q_bitwise != n:
            raise AssertionError("phase 18 (a) int8 pages: %s"
                                 % json.dumps(res["int8"]))
        del aq, bq
        # bf16 and fp8 pages: one prompt's pages through the store
        transit = {}
        for label, quant in (("bf16", "off"), ("fp32", "fp8")):
            name = "bf16" if label == "bf16" else "fp8"
            root = os.path.join(workdir, "dis_store_" + name)
            src = engine(label, quant, slots=1, num_pages=DIS_CHECK_PAGES)
            src.prefill(0, prompts[0], max_new_tokens=1)
            _publish_cached(src, PrefixTierClient(store_root=root,
                                                  tier_url=""), prompts[0])
            dst = engine(label, quant, slots=1, num_pages=DIS_CHECK_PAGES,
                         tier=PrefixTierClient(store_root=root,
                                               tier_url=""))
            dst.prefill(0, prompts[0], max_new_tokens=1)
            transit[name] = {
                "imported_pages": dst.last_prefill_stats["imported_pages"],
                "bitwise": _rows_equal(src, _mapped(src, prompts[0]), dst,
                                       _mapped(dst, prompts[0])),
                "dtype": dst.geometry()["dtype"]}
            del src, dst
        res["transit"] = transit
        if not all(t["bitwise"] and t["imported_pages"] > 0
                   for t in transit.values()):
            raise AssertionError("phase 18 (a) bf16/fp8 transit: %s"
                                 % json.dumps(transit))
        _sync()
        counts = {"k3": pa.launches, "k3_quant": pa.launches_quant}
        res["launches"] = counts
        res["plain_k3_calls"] = plain[0]
        res["pages_imported_total"] = \
            catalog.KV_TRANSFER_PAGES_IMPORTED.value() - imported0
        if counts != {"k3": want_k3, "k3_quant": want_quant} or \
                min(counts.values()) <= 0 or \
                res["pages_imported_total"] <= 0 or \
                (DEVICE == "cuda" and plain[0]):
            raise AssertionError(
                "phase 18 (a) launches %s, want K3 %d and K3-quant %d; plain "
                "K3 calls %d; kv_transfer_pages_imported_total %g"
                % (counts, want_k3, want_quant, plain[0],
                   res["pages_imported_total"]))
    finally:
        pa.paged_decode_attention_plain = real_plain
    res["seconds"] = time.perf_counter() - t0
    return res, ref


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Child:
    """A phase-18/19 child process: ``argv`` run from the repo root with
    its stderr in ``log``; ``url`` once its start line names it."""

    def __init__(self, name, argv, log_path):
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        self.name, self.log_path, self.url = name, log_path, None
        self._log = open(log_path, "w")
        self.proc = subprocess.Popen([sys.executable, "-m"] + argv,
                                     cwd=REPO, env=env,
                                     stdout=subprocess.DEVNULL,
                                     stderr=self._log)

    def wait_url(self, deadline):
        pat = re.compile(r"^(?:serve|prefix tier|fleet): (?:router )?"
                         r"(http://[0-9.:]+)")
        while time.perf_counter() < deadline:
            with open(self.log_path) as f:
                for line in f:
                    m = pat.match(line)
                    if m:
                        self.url = m.group(1)
                        return self.url
            if self.proc.poll() is not None:
                break
            time.sleep(0.2)
        raise AssertionError("child %s did not start (rc %s): %s"
                             % (self.name, self.proc.poll(),
                                self.tail()))

    def tail(self, n=2000):
        with open(self.log_path) as f:
            return f.read()[-n:]

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(30)
        self._log.close()

    def stop(self, timeout):
        """SIGTERM (a graceful drain) and wait; the exit code, or None
        when it outlived ``timeout``."""
        import signal
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            return self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            return None


def start_disagg_children(d32, store, workdir):
    """The prefix tier, one ``serve --role prefill``, two ``serve --role
    decode`` and a prefill child whose first export hangs
    (``--chaos-spec handoff:0=hang...``), all on one store; they boot
    while phase 18 (a) runs."""
    tier_port = _free_port()
    tier_url = "http://127.0.0.1:%d" % tier_port
    serve = ["paddle_tpu_torch.serving.serve", "--generation-model", d32,
             "--device", DEVICE, "--port", "0", "--gen-max-slots",
             str(DIS_SLOTS), "--gen-max-len", str(MAX_LEN),
             "--gen-prefill-buckets", DIS_BUCKETS, "--gen-page-size",
             str(PAGE), "--kv-transfer-dir", store, "--prefix-tier-url",
             tier_url, "--request-timeout", "300"]
    specs = [("tier", ["paddle_tpu_torch.serving.prefix_tier",
                       "--store-dir", store, "--port", str(tier_port),
                       "--capacity-mb", "65536", "--sweep-interval-s",
                       "0.5"]),
             ("prefill", serve + ["--role", "prefill"]),
             ("decode0", serve + ["--role", "decode"]),
             ("decode1", serve + ["--role", "decode"]),
             ("torn_prefill", serve + ["--role", "prefill", "--chaos-spec",
                                       "handoff:0=hang%d" % DIS_HANG_S])]
    return {name: _Child(name, argv, os.path.join(workdir, name + ".log"))
            for name, argv in specs}


def _metric(url, name, **labels):
    """One sample of a child's /metrics (0 when absent)."""
    text = urllib.request.urlopen(url + "/metrics", timeout=60).read() \
        .decode()
    want = "paddle_tpu_" + name
    if labels:
        want += "{%s}" % ",".join('%s="%s"' % kv
                                  for kv in sorted(labels.items()))
    for line in text.splitlines():
        if line.startswith(want + " "):
            return float(line.split()[-1])
    return 0.0


def _handoff(children, prompt, budget, decode, delay_s=0.0):
    """The router's two hops from the client: POST /v1/prefill to the
    prefill child, then /v1/generate to ``decode``. Returns the prefill
    ack, the generate response and the prefill hop's wall ms."""
    time.sleep(delay_s)
    t0 = time.perf_counter()
    ack = _post(children["prefill"].url + "/v1/prefill",
                {"prompt": prompt.tolist()})
    hop_ms = (time.perf_counter() - t0) * 1e3
    resp = _post(children[decode].url + "/v1/generate",
                 {"prompt": prompt.tolist(), "max_new_tokens": budget,
                  "temperature": 0.0})
    return ack, resp, hop_ms


def disagg_path(workdir, card_label=""):
    """Phase 18: disaggregated serving on the card (``disagg_engine_gates``
    in-process while the children boot, then over HTTP and through its
    failures); see the module docstring. Returns the report and the
    in-process launches of K3 and K3-quant."""
    from paddle_tpu_torch.serving import kv_transfer
    t0 = time.perf_counter()
    dirs = dis_decoders(workdir)
    prefix = np.random.RandomState(SEED + 18).randint(0, VOCAB, DIS_PREFIX)
    prompts, budgets = dis_requests(DIS_REQUESTS, SEED + 19, prefix)
    kill_p, kill_b = dis_requests(DIS_KILL_REQUESTS, SEED + 20, prefix,
                                  DIS_KILL_SUFFIX)
    torn_p, torn_b = dis_requests(1, SEED + 21, np.random.RandomState(
        SEED + 22).randint(0, VOCAB, DIS_PREFIX))
    store = os.path.join(workdir, "dis_store")
    children = start_disagg_children(dirs["fp32"], store, workdir)
    report = {}
    try:
        report["engine_gates"], ref = disagg_engine_gates(
            dirs, prompts, budgets, (kill_p + torn_p, kill_b + torn_b),
            workdir)
        launches = dict(report["engine_gates"]["launches"])
        log("phase 18 (a) engine gates (%d layers, %d prompts on a %d-token "
            "shared prefix; %s): %s"
            % (DIS_LAYERS, len(prompts), DIS_PREFIX, card_label,
               json.dumps(report["engine_gates"])))
        # (b) the single-engine self-prefill run, then the handoff over HTTP
        base = serve_run(dirs["fp32"], prompts, budgets, slots=DIS_SLOTS,
                         buckets=DIS_BUCKETS)
        launches["k3"] += base["launches"]
        base_streams = [r["tokens"] for r in base["responses"]]
        if base_streams != ref[:len(prompts)]:
            raise AssertionError("phase 18 single-engine streams differ "
                                 "from full recompute")
        deadline = time.perf_counter() + DIS_BOOT_S
        for child in children.values():
            child.wait_url(deadline)
        t1 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(prompts)) as ex:
            got = list(ex.map(lambda i: _handoff(
                children, prompts[i], budgets[i], "decode%d" % (i % 2)),
                range(len(prompts))))
        wall = time.perf_counter() - t1
        streams = [r["tokens"] for _, r, _ in got]
        per_replica = {name: _metric(children[name].url,
                                     "kv_transfer_pages_imported_total")
                       for name in ("decode0", "decode1")}
        ttft = np.array([hop + r["slo"]["ttft_ms"] for _, r, hop in got])
        base_ttft = np.array([r["slo"]["ttft_ms"]
                              for r in base["responses"]])
        cold = sum(1 for _, r, _ in got
                   if r["slo"].get("prefix_hit_pages", 0) <
                   DIS_PREFIX // PAGE)
        tokens = sum(len(r["tokens"]) for _, r, _ in got)
        http = {"requests": len(got),
                "streams_equal_self_prefill": sum(
                    x == y for x, y in zip(streams, base_streams)),
                "pages_imported_by_replica": per_replica,
                "responses_importing": sum(
                    1 for _, r, _ in got if r["slo"].get("imported_pages")),
                "cold_prefix_computes": cold,
                "prefill_acks_pages": sorted({a["n_pages"]
                                              for a, _, _ in got}),
                "ttft_ms_p50": float(np.percentile(ttft, 50)),
                "ttft_ms_p99": float(np.percentile(ttft, 99)),
                "self_prefill_ttft_ms_p50": float(np.percentile(base_ttft,
                                                                50)),
                "self_prefill_ttft_ms_p99": float(np.percentile(base_ttft,
                                                                99)),
                "prefill_hop_ms_p50": float(np.median([h for _, _, h
                                                       in got])),
                "decode_tokens_per_s": tokens / wall,
                "self_prefill_decode_tokens_per_s":
                    _serving_stats(base)["decode_tokens_per_s"],
                "wall_s": wall}
        report["http"] = http
        log("phase 18 (b) handoff over HTTP (prefill child -> decode "
            "children; %s): %s" % (card_label, json.dumps(http)))
        if http["streams_equal_self_prefill"] != len(prompts) or cold or \
                min(per_replica.values()) <= 0:
            raise AssertionError("phase 18 (b): %s" % json.dumps(http))
        # (c) a torn handoff: the chaos child hangs inside its first export
        # (payload fsynced, no manifest); SIGKILL it, then the decode
        # replica self-prefills the request
        t2 = time.perf_counter()
        key = kv_transfer.chain_keys(torn_p[0], PAGE,
                                     len(torn_p[0]) // PAGE)[-1].hex()
        parent = os.path.join(store, key[:2])
        with concurrent.futures.ThreadPoolExecutor(1) as ex:
            fut = ex.submit(_post, children["torn_prefill"].url +
                            "/v1/prefill", {"prompt": torn_p[0].tolist()})
            torn = None
            while torn is None and time.perf_counter() - t2 < DIS_HANG_S:
                names = os.listdir(parent) if os.path.isdir(parent) else []
                for nm in names:
                    d = os.path.join(parent, nm)
                    if nm.startswith(key) and os.path.isfile(
                            os.path.join(d, "pages.npz")):
                        torn = d
                if fut.done():
                    raise AssertionError("phase 18 (c): the chaos prefill "
                                         "answered: %s" % (fut.result(),))
                time.sleep(0.1)
            children["torn_prefill"].kill()
            try:
                fut.result()
                raise AssertionError("phase 18 (c): the killed prefill "
                                     "answered")
            except (urllib.error.URLError, ConnectionError, OSError):
                pass
        if torn is None:
            raise AssertionError("phase 18 (c): no torn entry appeared")
        r = _post(children["decode0"].url + "/v1/generate",
                  {"prompt": torn_p[0].tolist(), "max_new_tokens": torn_b[0],
                   "temperature": 0.0})
        torn_res = {"status": 200, "imported_pages":
                    r["slo"].get("imported_pages", 0),
                    "prefix_hit_pages": r["slo"].get("prefix_hit_pages"),
                    "stream_equal": r["tokens"] == ref[-1],
                    "torn_manifest": os.path.exists(os.path.join(
                        torn, "_MANIFEST")),
                    "visible": kv_transfer.find_committed(store, key) ==
                    torn, "seconds": time.perf_counter() - t2}
        # (d) the tier SIGKILLed under load: half the requests in flight,
        # the other half sent after the kill
        t3 = time.perf_counter()
        half = len(kill_p) // 2
        with concurrent.futures.ThreadPoolExecutor(len(kill_p)) as ex:
            futs = [ex.submit(_handoff, children, kill_p[i], kill_b[i],
                              "decode%d" % (i % 2), 0.0 if i < half else 1.0)
                    for i in range(len(kill_p))]
            time.sleep(0.2)
            children["tier"].kill()
            killed = [f.result() for f in futs]
        disk = sum(_metric(children[name].url, "prefix_tier_requests_total",
                           op="lookup", outcome="disk")
                   for name in ("decode0", "decode1"))
        kill_res = {"requests": len(killed),
                    "streams_equal_recompute": sum(
                        r["tokens"] == w for (_, r, _), w in
                        zip(killed, ref[len(prompts):-1])),
                    "cold_prefix_computes": sum(
                        1 for _, r, _ in killed
                        if r["slo"].get("prefix_hit_pages", 0) <
                        DIS_PREFIX // PAGE),
                    "disk_fallback_lookups": disk,
                    "seconds": time.perf_counter() - t3}
        report["degradation"] = {"torn_handoff": torn_res,
                                 "tier_killed": kill_res}
        log("phase 18 (c) degradation (%s): %s"
            % (card_label, json.dumps(report["degradation"])))
        if torn_res["imported_pages"] or not torn_res["stream_equal"] or \
                torn_res["torn_manifest"] or torn_res["visible"] or \
                kill_res["streams_equal_recompute"] != len(kill_p) or \
                kill_res["cold_prefix_computes"] or disk <= 0:
            raise AssertionError("phase 18 (c): %s"
                                 % json.dumps(report["degradation"]))
    except Exception:
        for child in children.values():
            sys.stderr.write("-- phase 18 child %s --\n%s\n"
                             % (child.name, child.tail()))
        raise
    finally:
        for child in children.values():
            child.kill()
    report["launches"] = launches
    report["seconds"] = time.perf_counter() - t0
    log("phase 18 disaggregated serving in %.1f s (%s)"
        % (report["seconds"], card_label))
    return report


# -- phase 19: the serving fleet ---------------------------------------------

# The fleet serves phase 18's decoder (DIS_LAYERS layers at the serving
# widths) with fp32 pages in (a) and int8 pages in (b). Long prompts share
# one FLEET_PREFIX-token system prompt (a seeded suffix each) and take the
# prefill hop (>= FLEET_MIN_PROMPT tokens); short ones go straight to a
# decode replica. FLEET_CLIENTS closed-loop client threads send each wave.
FLEET_PREFIX, FLEET_SUFFIX, FLEET_SHORT, FLEET_NEW = 256, (16, 64), \
    (16, 64), (16, 32)
FLEET_PROMPTS, FLEET_CLIENTS, FLEET_WAVE = 16, 8, 32
FLEET_MIN_PROMPT = 128
FLEET_SLOTS, FLEET_BUCKETS, FLEET_PAGES = 16, "64,128,384", 1024
FLEET_OVERHEAD_PAIRS = 16
ROLL_REPLICAS, ROLL_WAVE = 2, 16
FLEET_BOOT_S, FLEET_DRAIN_S = 300, 120
FLEET_LEASE_S = 5              # the supervisor lease (FLAGS default)


def fleet_requests():
    """FLEET_PROMPTS prompts, the first half long (the shared prefix and a
    suffix), the rest short, with their budgets (seeded)."""
    rng = np.random.RandomState(SEED + 30)
    prefix = rng.randint(0, VOCAB, FLEET_PREFIX)
    half = FLEET_PROMPTS // 2
    prompts = []
    for i in range(FLEET_PROMPTS):
        lo, hi = FLEET_SUFFIX if i < half else FLEET_SHORT
        tail = rng.randint(0, VOCAB, int(rng.randint(lo, hi + 1)))
        prompts.append((np.concatenate([prefix, tail]) if i < half
                        else tail).astype(np.int32))
    budgets = [int(b) for b in rng.randint(FLEET_NEW[0], FLEET_NEW[1] + 1,
                                           size=FLEET_PROMPTS)]
    return prompts, budgets


def fleet_decoder(workdir):
    """Phase 18's fp32 decoder directory (written again when phase 18 did
    not run in this workdir)."""
    d32 = os.path.join(workdir, "dis_fp32")
    if not os.path.isfile(os.path.join(d32, "config.json")):
        d32 = dis_decoders(workdir)["fp32"]
    return d32


def fleet_reference(model_dir, prompts, budgets, kv_quant_dtype="off"):
    """Greedy streams of an in-process ``PagedDecodeEngine`` on the
    replicas' geometry, and its K3 / K3-quant launches."""
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.serving import PagedDecodeEngine, \
        greedy_generate, load_decoder
    model, params = load_decoder(model_dir, device=DEVICE)
    engine = PagedDecodeEngine(model, params, max_slots=len(prompts),
                               max_len=MAX_LEN,
                               prefill_buckets=FLEET_BUCKETS,
                               page_size=PAGE,
                               kv_quant_dtype=kv_quant_dtype, device=DEVICE)
    k0, q0 = pa.launches, pa.launches_quant
    streams = greedy_generate(engine, prompts, budgets)
    _sync()
    return streams, {"k3": pa.launches - k0,
                     "k3_quant": pa.launches_quant - q0}


def _replica_args(kv_quant_dtype="off"):
    """The serve flags every phase-19 replica takes: the engine geometry,
    an explicit pool (several replicas share the card) and the KV
    pages."""
    return ["--gen-max-slots", str(FLEET_SLOTS), "--gen-max-len",
            str(MAX_LEN), "--gen-prefill-buckets", FLEET_BUCKETS,
            "--gen-page-size", str(PAGE), "--gen-num-pages",
            str(FLEET_PAGES), "--kv-quant-dtype", kv_quant_dtype,
            "--request-timeout", "300"]


def replica_logs(log_dir):
    """Each replica log of a fleet: its role (generate or prefill), the
    device its start line names, and the K3 / K3-quant launches its drain
    line reports (None when it never drained: SIGKILLed)."""
    start = re.compile(r"^serve: http://\S+\s+(generate|prefill): .* "
                       r"device=(\S+) ")
    drain = re.compile(r"^serve: kernel launches k3=(\d+) k3_quant=(\d+)")
    out = {}
    for fn in sorted(os.listdir(log_dir)):
        if not fn.endswith(".log"):
            continue
        rec = {"role": None, "device": None, "k3": None, "k3_quant": None}
        with open(os.path.join(log_dir, fn)) as f:
            for line in f:
                m = start.match(line)
                if m:
                    rec["role"], rec["device"] = m.group(1), m.group(2)
                m = drain.match(line)
                if m:
                    rec["k3"], rec["k3_quant"] = int(m.group(1)), \
                        int(m.group(2))
        out[fn] = rec
    return out


def _drained_gate(label, logs, kernel, want):
    """Every replica served on DEVICE; ``want`` decode replicas drained,
    each having launched ``kernel`` (on the CPU its plain version runs and
    counts none) and never the other."""
    other = "k3" if kernel == "k3_quant" else "k3_quant"
    drained = {fn: r for fn, r in logs.items()
               if r["role"] == "generate" and r[kernel] is not None}
    bad = [fn for fn, r in logs.items()
           if (r["device"] or "").split(":")[0] != DEVICE]
    bad += [fn for fn, r in drained.items()
            if (r[kernel] > 0) != (DEVICE == "cuda") or r[other]]
    if bad or len(drained) != want:
        raise AssertionError("%s replica logs: %s" % (label,
                                                      json.dumps(logs)))
    return {kernel: sum(r[kernel] for r in drained.values()),
            "drained_decode_replicas": len(drained)}


def _closed_loop(url, next_job, on_done=None):
    """Closed-loop load through ``ServingClient(url)`` (one router URL or
    a list of them, failed over in turn) from FLEET_CLIENTS threads, each
    taking ``next_job()`` (``(index, prompt, budget)``, None to stop) when
    its last request answers. Returns [(index, result or exception,
    client seconds)] in completion order; ``on_done(n)`` after each
    answer."""
    import threading
    from paddle_tpu_torch.serving import ServingClient
    lock, done, out = threading.Lock(), [0], []

    def worker():
        client = ServingClient(url if isinstance(url, list) else [url],
                               timeout=300.0)
        while True:
            with lock:
                job = next_job()
            if job is None:
                return
            i, prompt, budget = job
            t0 = time.perf_counter()
            try:
                res = client.generate(prompt, max_new_tokens=budget)
            except Exception as e:   # counted as a failed request
                res = e
            with lock:
                out.append((i, res, time.perf_counter() - t0))
                done[0] += 1
                n = done[0]
            if on_done is not None:
                on_done(n)
    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(FLEET_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def _fleet_status(url):
    with urllib.request.urlopen(url + "/fleet/status", timeout=60) as r:
        return json.loads(r.read())


def _replica_pids(status):
    """{backend name: pid} of the reachable replicas in rotation."""
    return {e["name"]: (e.get("version") or {}).get("pid")
            for e in status["replicas"]
            if e["reachable"] and e["router_view"]["health"] in
            ("ok", "unknown")}


def router_overhead(router_url, status, prompt):
    """p50 of one short request through the router against the same
    request sent straight to a decode replica (both replicas in turn),
    FLEET_OVERHEAD_PAIRS pairs alternated, idle fleet."""
    direct = [e["url"] for e in status["replicas"]
              if e["router_view"]["role"] != "prefill"]
    body = {"prompt": prompt.tolist(), "max_new_tokens": 4}
    for url in [router_url] + direct:       # one warm request each
        _post(url + "/v1/generate", body)
    via, straight = [], []
    for i in range(FLEET_OVERHEAD_PAIRS):
        for url, times in ((router_url, via),
                           (direct[i % len(direct)], straight)):
            t0 = time.perf_counter()
            _post(url + "/v1/generate", body)
            times.append((time.perf_counter() - t0) * 1e3)
    return {"router_ms_p50": float(np.median(via)),
            "direct_ms_p50": float(np.median(straight)),
            "added_ms_p50": float(np.median(via) - np.median(straight))}


def _become_subreaper():
    """Make this process a child subreaper (``prctl(PR_SET_CHILD_SUBREAPER)``
    on itself): the replicas of a SIGKILLed fleet CLI become its children,
    so it can reap them when the standby that adopted them drains them."""
    import ctypes
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(36, 1, 0, 0, 0) != 0:      # PR_SET_CHILD_SUBREAPER
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_CHILD_SUBREAPER)")


def _registered_pids(reg_dir):
    """The pids of the replica records in a fleet registry."""
    from paddle_tpu_torch.serving.registry import ReplicaRegistry
    if not os.path.isdir(reg_dir):
        return []
    return sorted(r["pid"] for r in ReplicaRegistry(reg_dir).records()
                  if r.get("role") != "cache" and r.get("pid"))


def _inherited_replicas(store):
    """The pids of replica processes (``serving.serve``) of the fleet over
    the KV store ``store`` whose parent is this process: a SIGKILLed
    fleet CLI's replicas, a booting one included (a replica enters the
    registry only once it is ready); phase 19 (b)'s replicas, this
    process's own children, use no store and are left alone."""
    pids = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open("/proc/%s/stat" % name) as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open("/proc/%s/cmdline" % name, "rb") as f:
                argv = f.read().split(b"\0")
        except (OSError, ValueError, IndexError):
            continue
        if ppid == os.getpid() and \
                b"paddle_tpu_torch.serving.serve" in argv and \
                os.fsencode(store) in argv:
            pids.append(int(name))
    return pids


def _reap(pids, kill=False, timeout=30.0):
    """Wait for (SIGKILL first with ``kill``) processes this one inherited
    as their subreaper; returns the pids it reaped. A pid that is not this
    process's child is skipped."""
    import signal
    reaped = []
    for pid in pids:
        if kill:
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass
        deadline = time.perf_counter() + timeout
        while True:
            try:
                done, _ = os.waitpid(pid, os.WNOHANG)
            except ChildProcessError:
                break
            if done:
                reaped.append(pid)
                break
            if time.perf_counter() > deadline:
                break
            time.sleep(0.05)
    return reaped


def fleet_failover_gate(children, routers, reg_dir, prompts, budgets, ref,
                        tier_url, card_label):
    """Phase 19 (c), on (a)'s fleet: every prompt once more under
    closed-loop load through both routers, the ACTIVE fleet CLI's pid
    SIGKILLed (not its process group) a third in. Gates (each raises): no
    failed request; every stream equal to the engine's; the standby takes
    the lease (``lease_takeovers_total`` 1) and adopts the three replicas
    by the same pids (``replicas_adopted_total`` 3) with no restart; its
    ``/fleet/status`` names it the holder and the tier URL of the tier's
    ``role=cache`` record. Records the seconds from the SIGKILL to the
    lease taken and to adoption done."""
    import signal
    import threading
    from paddle_tpu_torch.serving import ServingClient
    from paddle_tpu_torch.serving.registry import Lease, ReplicaRegistry
    t0 = time.perf_counter()
    active, standby = children["fleet"], children["standby"]
    registry = ReplicaRegistry(reg_dir)
    lease = Lease.reader(registry.lease_path())
    holder_b = ":%d" % standby.proc.pid
    before = {r["slot"]: r["pid"] for r in registry.records()
              if r.get("role") != "cache"}
    killed, seen = {}, {}

    def watch():
        # the lease file and the records, read as the routers read them
        while "adopted" not in seen and \
                time.perf_counter() - killed["t"] < FLEET_BOOT_S:
            rec = lease.read() or {}
            now = time.perf_counter()
            if "lease" not in seen and \
                    rec.get("holder", "").endswith(holder_b):
                seen["lease"] = now - killed["t"]
            recs = [r for r in registry.records()
                    if r.get("role") != "cache"]
            if "lease" in seen and len(recs) == len(before) and all(
                    r["holder"].endswith(holder_b) for r in recs):
                seen["adopted"] = now - killed["t"]
            time.sleep(0.02)

    watcher = threading.Thread(target=watch, daemon=True)

    def kill_at(n):
        if n == len(prompts) // 3 and "t" not in killed:
            killed["t"] = time.perf_counter()
            os.kill(active.proc.pid, signal.SIGKILL)
            watcher.start()

    jobs = iter([(i, prompts[i], budgets[i]) for i in range(len(prompts))])
    got = _closed_loop(routers, lambda: next(jobs, None), kill_at)
    watcher.join(FLEET_BOOT_S)
    active_exit = active.proc.wait(30)
    status = _fleet_status(standby.url)
    metrics = ServingClient(standby.url).metrics()
    after = {r["slot"]: r["pid"] for r in status["registry"]["records"]
             if r.get("role") != "cache"}
    failed = [repr(r) for _, r, _ in got if isinstance(r, Exception)]
    res = {"requests": len(got), "failed": len(failed),
           "streams_equal_engine": sum(
               not isinstance(r, Exception) and r["tokens"] == ref[i]
               for i, r, _ in got),
           "active_exit": active_exit,
           "kill_to_lease_s": seen.get("lease"),
           "kill_to_adopted_s": seen.get("adopted"),
           "lease_takeovers": metrics.get(
               "paddle_tpu_lease_takeovers_total", 0.0),
           "replicas_adopted": metrics.get(
               "paddle_tpu_replicas_adopted_total", 0.0),
           "standby_restarts": metrics.get(
               "paddle_tpu_fleet_restarts_total", 0.0),
           "holder": status["lease"]["holder"],
           "tier_url": (status["roles"].get("cache_tier") or {}).get("url"),
           "pids_before": sorted(before.values()),
           "pids_after": sorted(after.values()),
           "same_pids_by_slot": after == before,
           "replicas_reachable": sum(e["reachable"]
                                     for e in status["replicas"]),
           "seconds": time.perf_counter() - t0}
    if failed:
        res["first_failure"] = failed[0]
    log("phase 19 (c) control-plane failover (%s): SIGKILL of the active "
        "fleet CLI to the standby's lease %s s, to adoption done %s s; %s"
        % (card_label, res["kill_to_lease_s"], res["kill_to_adopted_s"],
           json.dumps(res)))
    if res["failed"] or res["streams_equal_engine"] != len(prompts) or \
            res["requests"] != len(prompts) or \
            res["lease_takeovers"] != 1 or res["replicas_adopted"] != 3 or \
            res["standby_restarts"] != 0 or not res["same_pids_by_slot"] \
            or len(after) != 3 or not res["holder"].endswith(holder_b) or \
            res["tier_url"] != tier_url or res["kill_to_adopted_s"] is None \
            or res["replicas_reachable"] != 3 or \
            res["active_exit"] != -signal.SIGKILL:
        raise AssertionError("phase 19 (c): %s" % json.dumps(res))
    return res


def _wait_lease_held(reg_dir, child, deadline):
    """Wait until the supervisor lease under ``reg_dir`` has a live
    holder (``child``, the fleet CLI that contends for it at start)."""
    from paddle_tpu_torch.serving.registry import Lease, ReplicaRegistry
    lease = Lease.reader(ReplicaRegistry(reg_dir).lease_path())
    while time.perf_counter() < deadline:
        if not lease.expired():
            return
        if child.proc.poll() is not None:
            break
        time.sleep(0.05)
    raise AssertionError("no holder of the fleet lease under %s (child "
                         "%s rc %s): %s" % (reg_dir, child.name,
                                            child.proc.poll(), child.tail()))


def fleet_cli_gate(workdir, d32, prompts, budgets, card_label):
    """Phase 19 (a): ``python -m paddle_tpu_torch.serving.fleet`` with two
    decode replicas, one prefill replica and the prefix tier; closed-loop
    load, one decode replica SIGKILLed mid-load. The fleet, the tier and a
    second, standby fleet CLI share a registry, and clients know both
    routers; then (c), ``fleet_failover_gate``: the active CLI SIGKILLed
    under load, the standby taking over. The standby's SIGTERM drains the
    fleet. Returns the report and the in-process reference engine's
    launches."""
    import signal
    import threading
    from paddle_tpu_torch.serving import ServingClient
    t0 = time.perf_counter()
    _become_subreaper()
    store = os.path.join(workdir, "fleet_store")
    log_dir = os.path.join(workdir, "fleet_logs")
    spool = os.path.join(workdir, "fleet_spool")
    reg_dir = os.path.join(workdir, "fleet_registry")
    tier_port = _free_port()
    tier_url = "http://127.0.0.1:%d" % tier_port

    def fleet_cli(tag, extra):
        return _Child(tag, [
            "paddle_tpu_torch.serving.fleet", "--generation-model", d32,
            "--device", DEVICE, "--gen-paged", "--replicas", "2",
            "--prefill-replicas", "1", "--kv-transfer-dir", store,
            "--prefill-min-prompt", str(FLEET_MIN_PROMPT), "--port", "0",
            "--trace-spool-dir", spool, "--check-interval-s", "0.25",
            "--request-timeout", "300", "--drain-timeout",
            str(FLEET_DRAIN_S), "--registry-dir", reg_dir, "--lease-secs",
            str(FLEET_LEASE_S)] + extra +
            ["--serve-arg=" + a for a in _replica_args()],
            os.path.join(workdir, tag + ".log"))

    children = {
        "tier": _Child("fleet_tier", [
            "paddle_tpu_torch.serving.prefix_tier", "--store-dir", store,
            "--port", str(tier_port), "--capacity-mb", "65536",
            "--registry-dir", reg_dir],
            os.path.join(workdir, "fleet_tier.log")),
        "fleet": fleet_cli("fleet_cli", [
            "--prefix-tier-url", tier_url, "--log-dir", log_dir])}
    res = {}
    try:
        deadline = time.perf_counter() + FLEET_BOOT_S
        # a standby takes a lease nobody holds: it starts once the fleet
        # CLI holds it. Its router knows the tier only by its registry
        # record (its replicas would get the URL as a serve flag)
        _wait_lease_held(reg_dir, children["fleet"], deadline)
        children["standby"] = fleet_cli("fleet_standby", [
            "--standby", "--log-dir", log_dir + "_standby",
            "--serve-arg=--prefix-tier-url=" + tier_url])
        # the reference streams while the fleet boots
        ref, launches = fleet_reference(d32, prompts, budgets)
        for child in children.values():
            child.wait_url(deadline)
        router = children["fleet"].url
        with open(children["fleet"].log_path) as f:
            line = next(ln for ln in f if ln.startswith("fleet: router"))
        res["cold_start_s"] = json.loads(line.split("ready_s=", 1)[1].split(
            "  role=")[0].replace("'", '"'))
        res["fleet_up_s"] = time.perf_counter() - t0
        status = _fleet_status(router)
        res["overhead"] = router_overhead(router, status,
                                          prompts[FLEET_PROMPTS // 2])
        # wave 1: every prompt twice; replica0 is SIGKILLed a third in
        status = _fleet_status(router)
        pids = _replica_pids(status)
        killed = {"pid": pids["replica0"]}
        third = FLEET_WAVE // 3

        def kill_at(n):
            if n == third and "t" not in killed:
                killed["t"] = time.perf_counter()
                os.kill(killed["pid"], signal.SIGKILL)

        jobs = iter([(i % FLEET_PROMPTS, prompts[i % FLEET_PROMPTS],
                      budgets[i % FLEET_PROMPTS])
                     for i in range(FLEET_WAVE)])
        routers = [router, children["standby"].url]
        got = _closed_loop(routers, lambda: next(jobs, None), kill_at)
        # readmission: a replica0 with another pid in rotation
        while True:
            pids = _replica_pids(_fleet_status(router))
            if pids.get("replica0") not in (None, killed["pid"]):
                break
            if time.perf_counter() - killed["t"] > FLEET_BOOT_S:
                raise AssertionError("phase 19 (a): replica0 was not "
                                     "readmitted: %s" % pids)
            time.sleep(0.1)
        res["kill_to_readmission_s"] = time.perf_counter() - killed["t"]
        # wave 2, after the readmission: every prompt once more
        jobs = iter([(i, prompts[i], budgets[i])
                     for i in range(FLEET_PROMPTS)])
        got += _closed_loop(routers, lambda: next(jobs, None))
        failed = [repr(r) for _, r, _ in got if isinstance(r, Exception)]
        ok = [(i, r, s) for i, r, s in got if not isinstance(r, Exception)]
        long_ok = [(i, r, s) for i, r, s in ok if i < FLEET_PROMPTS // 2]
        # TTFT through the hop: client wall less the decode replica's
        # time after its first token
        ttft = [s * 1e3 - (r["latency_ms"] - r["slo"]["ttft_ms"])
                for _, r, s in long_ok]
        metrics = ServingClient(router).metrics()

        def metric(name, **labels):
            key = "paddle_tpu_" + name
            if labels:
                key += "{%s}" % ",".join('%s="%s"' % kv
                                         for kv in sorted(labels.items()))
            return metrics.get(key, 0.0)

        # one handed-off request's merged trace
        rid = long_ok[-1][1]["request_id"]
        trace = ServingClient(router).fetch_trace(rid)
        lanes = {ev["pid"]: ev["args"]["name"]
                 for ev in trace["traceEvents"] if ev.get("ph") == "M"}
        final = _replica_pids(_fleet_status(router))
        prefill_pid = final.get("prefill0")
        decode_pids = {p for n, p in final.items() if n != "prefill0"} | \
            {killed["pid"]}
        res.update({
            "requests": len(got), "failed": len(failed),
            "streams_equal_engine": sum(r["tokens"] == ref[i]
                                        for i, r, _ in ok),
            "restarts": metric("fleet_restarts_total"),
            "handoff": {o: metric("handoff_prefills_total", outcome=o)
                        for o in ("ok", "failed", "unavailable",
                                  "skipped")},
            "affinity": {o: metric("fleet_prefix_affinity_total",
                                   outcome=o)
                         for o in ("affinity", "load", "none")},
            "ttft_ms_p50_via_prefill_hop": float(np.percentile(ttft, 50)),
            "ttft_ms_p50_short": float(np.percentile(
                [r["slo"]["ttft_ms"] for i, r, _ in ok
                 if i >= FLEET_PROMPTS // 2], 50)),
            "trace": {"request_id": rid,
                      "spans": trace["metadata"]["span_count"],
                      "lanes": sorted(lanes.values()),
                      "router": children["fleet"].proc.pid in lanes,
                      "prefill": prefill_pid in lanes,
                      "decode": bool(decode_pids & set(lanes))}})
        if failed:
            res["first_failure"] = failed[0]
        # (c) the active CLI SIGKILLed under load, the standby takes over
        res["failover"] = fleet_failover_gate(
            children, routers, reg_dir, prompts, budgets, ref, tier_url,
            card_label)
        # drain: SIGTERM the surviving CLI; it drains the replicas it
        # adopted, and each replica logs its launches
        res["fleet_exit"] = children["standby"].stop(FLEET_DRAIN_S + 60)
        res["adopted_reaped"] = _reap(res["failover"]["pids_after"])
        res["replica_logs"] = replica_logs(log_dir)
        # the survivor and the replacement drained; the killed one did not
        res["drained"] = _drained_gate("phase 19 (a)",
                                       res["replica_logs"], "k3", 2)
    except Exception:
        for child in children.values():
            sys.stderr.write("-- phase 19 child %s --\n%s\n"
                             % (child.name, child.tail()))
        raise
    finally:
        for child in children.values():
            child.kill()
        # replicas a SIGKILLed CLI left, if a gate failed before the drain
        _reap(set(_registered_pids(reg_dir)) |
              set(_inherited_replicas(store)), kill=True)
    res["seconds"] = time.perf_counter() - t0
    log("phase 19 (a) fleet CLI (2 decode + 1 prefill replicas, prefix "
        "tier, %d-layer decoder, fp32 pages; %s): %s"
        % (DIS_LAYERS, card_label, json.dumps(
            {k: v for k, v in res.items() if k != "replica_logs"})))
    n = len(prompts)
    if res["failed"] or res["streams_equal_engine"] != len(got) or \
            len(got) != FLEET_WAVE + n or res["restarts"] != 1 or \
            res["handoff"]["ok"] <= 0 or res["handoff"]["skipped"] <= 0 or \
            res["affinity"]["affinity"] <= 0 or res["fleet_exit"] != 0 or \
            not all(res["trace"][k] for k in ("router", "prefill",
                                               "decode")):
        raise AssertionError("phase 19 (a): %s" % json.dumps(res))
    return res, launches


def roll_fleet(workdir, d32):
    """Phase 19 (b)'s fleet: a ``FleetRouter`` and a ``ReplicaSupervisor``
    over ROLL_REPLICAS int8-page replicas of serial 0 of ``d32`` (a
    ``publish_artifact`` serial), booting on a thread while the caller
    goes on."""
    import threading
    from paddle_tpu_torch.serving.fleet import FleetRouter, \
        ReplicaSupervisor, publish_artifact
    root = os.path.join(workdir, "fleet_serials")
    s0, dir0 = publish_artifact(root, d32)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")

    def make_argv(port, serial_dir):
        return [sys.executable, "-m", "paddle_tpu_torch.serving.serve",
                "--generation-model", serial_dir or dir0, "--device",
                DEVICE, "--port", str(port)] + _replica_args("int8")

    router = FleetRouter(("127.0.0.1", 0), check_interval_s=0.25,
                         request_timeout=300.0, route_timeout_s=300.0,
                         backoff_base_s=0.02, backoff_cap_s=0.2)
    router.start_background()
    state = {"root": root, "serials": [s0], "dirs": [dir0],
             "log_dir": os.path.join(workdir, "roll_logs"),
             "router": router}
    state["sup"] = ReplicaSupervisor(
        make_argv, replicas=ROLL_REPLICAS, router=router, artifact_root=root,
        check_interval_s=0.25, drain_timeout_s=FLEET_DRAIN_S,
        hot_swap_poll_s=3600.0, env=env,
        log_dir=state["log_dir"])
    state["boot"] = threading.Thread(target=state["sup"].start,
                                     daemon=True)
    state["boot"].start()
    return state


def fleet_roll_gate(state, d32, prompts, budgets, card_label):
    """Phase 19 (b): the fleet of ``roll_fleet`` rolled under load by
    ``hot_swap`` onto a second serial published with
    ``weight_quant_dtype="int8"``; the fleet stopped at the end. Returns
    the report and the in-process reference engines' launches."""
    import itertools
    import threading
    from paddle_tpu_torch.serving import ServingClient
    from paddle_tpu_torch.serving.fleet import publish_artifact, slot_label
    t0 = time.perf_counter()
    sup, router, root = state["sup"], state["router"], state["root"]
    s0, dir0 = state["serials"][0], state["dirs"][0]
    log_dir = state["log_dir"]
    res = {"serials": [s0]}
    launches = {"k3": 0, "k3_quant": 0}
    try:
        ref0, n0 = fleet_reference(dir0, prompts, budgets, "int8")
        state["boot"].join(FLEET_BOOT_S)
        if len(sup.replicas()) != ROLL_REPLICAS:
            raise AssertionError("phase 19 (b): the fleet did not start")
        res["cold_start_s"] = {slot_label(r.slot): r.ready_s
                               for r in sup.replicas()}
        # closed-loop load from before the roll until ROLL_WAVE answers
        # after it
        stop, seq, done = threading.Event(), itertools.count(), [0]
        got = []

        def next_job():
            if stop.is_set():
                return None
            i = next(seq) % len(prompts)
            return i, prompts[i], budgets[i]

        def count(n):
            done[0] = n
        loader = threading.Thread(target=lambda: got.extend(_closed_loop(
            router.url, next_job, count)), daemon=True)
        loader.start()
        while done[0] < ROLL_WAVE // 2 and loader.is_alive():
            time.sleep(0.05)
        t1 = time.perf_counter()
        s1, dir1 = publish_artifact(root, d32, weight_quant_dtype="int8")
        old = sup.replicas()
        swapped = sup.hot_swap(s1)
        roll_s = time.perf_counter() - t1
        old_exit = [r.proc.returncode for r in old]
        after_roll = done[0]
        while done[0] < after_roll + ROLL_WAVE and loader.is_alive():
            time.sleep(0.05)
        stop.set()
        loader.join(300)
        swap = {"serial": s1, "swapped": swapped, "s": roll_s,
                "old_exit": old_exit}
        ref1, n1 = fleet_reference(dir1, prompts, budgets, "int8")
        for n in (n0, n1):
            for k in launches:
                launches[k] += n[k]
        client = ServingClient(router.url, timeout=300.0)
        after = [client.generate(p, max_new_tokens=b)["tokens"]
                 for p, b in zip(prompts, budgets)]
        # what each replica says it serves, from its /healthz stanza
        served = [(json.loads(urllib.request.urlopen(
            r.url + "/healthz", timeout=60).read())["serving"])
            for r in sup.replicas()]
        failed = [repr(r) for _, r, _ in got if isinstance(r, Exception)]
        ok = [(i, r) for i, r, _ in got if not isinstance(r, Exception)]
        res.update({
            "serials": [s0, swap["serial"]], "requests": len(got),
            "failed": len(failed), "swapped": swap["swapped"],
            "roll_s": swap["s"], "old_exit_codes": swap["old_exit"],
            "streams_in_either_weight_set": sum(
                r["tokens"] in (ref0[i], ref1[i]) for i, r in ok),
            "streams_equal_quantized_after_roll": sum(
                a == w for a, w in zip(after, ref1)),
            "quantized_vs_plain_streams_equal": sum(
                a == b for a, b in zip(ref0, ref1)),
            "weight_quant_after_roll": sorted(
                st["weight_quant"] for st in served),
            "serial_now": sup.current_serial})
        if failed:
            res["first_failure"] = failed[0]
    finally:
        sup.stop()
        router.stop(10.0)
    res["replica_logs"] = replica_logs(log_dir)
    # the replicas rolled out and those rolled in
    res["drained"] = _drained_gate("phase 19 (b)", res["replica_logs"],
                                   "k3_quant", 2 * ROLL_REPLICAS)
    res["seconds"] = time.perf_counter() - t0
    log("phase 19 (b) API roll (FleetRouter + ReplicaSupervisor, %d "
        "replicas, int8 pages, serial %d -> %d with int8 weights; %s): %s"
        % (ROLL_REPLICAS, res["serials"][0], res["serials"][-1],
           card_label, json.dumps(
            {k: v for k, v in res.items() if k != "replica_logs"})))
    if res["failed"] or res["swapped"] != ROLL_REPLICAS or \
            res["old_exit_codes"] != [0] * ROLL_REPLICAS or \
            res["streams_in_either_weight_set"] != res["requests"] or \
            res["streams_equal_quantized_after_roll"] != len(prompts) or \
            res["weight_quant_after_roll"] != ["int8"] * ROLL_REPLICAS or \
            res["serial_now"] != res["serials"][1]:
        raise AssertionError("phase 19 (b): %s" % json.dumps(res))
    return res, launches


def fleet_path(workdir, card_label=""):
    """Phase 19: the serving fleet on the card, (a) through the fleet CLI
    and (b) through the API's rolling hot-swap; see the module docstring.
    Returns the report with the in-process engines' launches of K3 and
    K3-quant."""
    t0 = time.perf_counter()
    d32 = fleet_decoder(workdir)
    prompts, budgets = fleet_requests()
    report = {}
    # (b)'s replicas boot while (a) boots and runs; they idle until (b)
    roll = roll_fleet(workdir, d32)
    try:
        report["cli"], la = fleet_cli_gate(workdir, d32, prompts, budgets,
                                           card_label)
    except Exception:
        roll["sup"].stop(drain=False)
        roll["router"].stop(10.0)
        raise
    report["roll"], lb = fleet_roll_gate(roll, d32, prompts, budgets,
                                         card_label)
    report["launches"] = {k: la[k] + lb[k] for k in la}
    report["replica_launches"] = {
        "k3": report["cli"]["drained"]["k3"],
        "k3_quant": report["roll"]["drained"]["k3_quant"]}
    report["seconds"] = time.perf_counter() - t0
    cli, roll = report["cli"], report["roll"]
    log("phase 19 the serving fleet in %.1f s (%s): cold start s %s / %s, "
        "router adds %.2f ms p50 (%.2f vs %.2f direct), TTFT p50 %.1f ms "
        "through the prefill hop, SIGKILL to readmission %.2f s, the active "
        "CLI's SIGKILL to the standby's lease %.2f s and to adoption %.2f "
        "s, roll %.2f s, replica launches K3 %d K3-quant %d"
        % (report["seconds"], card_label, json.dumps(cli["cold_start_s"]),
           json.dumps(roll["cold_start_s"]),
           cli["overhead"]["added_ms_p50"],
           cli["overhead"]["router_ms_p50"],
           cli["overhead"]["direct_ms_p50"],
           cli["ttft_ms_p50_via_prefill_hop"],
           cli["kill_to_readmission_s"],
           cli["failover"]["kill_to_lease_s"],
           cli["failover"]["kill_to_adopted_s"], roll["roll_s"],
           report["replica_launches"]["k3"],
           report["replica_launches"]["k3_quant"]))
    return report


_AB_RUN = r"""
import json, sys
sys.path.insert(0, ".")
import chip_smoke as cs
from paddle_tpu_torch import _build
from paddle_tpu_torch.ops import flash_attention as fa
_build.build()
z = {n: 0 for n in fa.launches}
rows = cs.flash_timing(z)
rows += cs.flash_timing(z, cs.packed_data(cs.LM_BATCH, cs.LM_SEQ)
                        ["packed"]["seg"])
rows += cs.layout_timing(z, {"bhsd": {"launches": z},
                             "bshd": {"launches": z}})
vars(cs).update(K3_CONSTS)
exec(K3_AB, vars(cs))
rows += cs.k3_ab_rows()
print("AB_ROWS " + json.dumps([{k: r[k] for k in (
    "name", "ms", "bound_ms", "plain_ms", "library_ms", "max_abs_err")}
    for r in rows]))
"""


def _ab_script():
    """``_AB_RUN`` with this tree's K3 helpers and their constants in."""
    import inspect
    src = "".join(inspect.getsource(f) + "\n\n" for f in (
        k3_step_inputs, k3_long_timing, k3_ab_rows))
    return _AB_RUN.replace("K3_CONSTS", repr({
        "LONG_SLOTS": LONG_SLOTS, "LONG_TOKENS": LONG_TOKENS})).replace(
            "K3_AB", repr(src))


# the serving cells of ``--ab-serving``, run from each tree's root with
# that tree's helpers: phase 4's decoders and 48 requests, fp32 at K = 1
# and phase 12's MS_RUNS at K = MEGASTEP_K, each served REPEATS times; after
# a K > 1 cell that tree's ``megastep_profile`` on its engine, and on a
# fresh engine at SLOTS busy slots the first megastep's host ms (the
# capture in) against the next two
_AB_SERVE = r"""
import json, os, sys, tempfile, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from paddle_tpu_torch import _build
from paddle_tpu_torch.serving import (PagedDecodeEngine,
                                      TransformerDecoderModel, load_decoder,
                                      save_decoder)
REPEATS = 3
_build.build()
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
work = tempfile.mkdtemp(prefix="ab_serving_")
m32 = TransformerDecoderModel(cs.VOCAB, dim=cs.DIM, n_heads=cs.HEADS,
                              n_layers=cs.LAYERS, ffn_mult=cs.FFN_MULT)
m16 = TransformerDecoderModel(cs.VOCAB, dim=cs.DIM, n_heads=cs.HEADS,
                              n_layers=cs.LAYERS, ffn_mult=cs.FFN_MULT,
                              dtype=torch.bfloat16)
p32 = m32.init_params(cs.SEED, device="cpu")
p16 = {k: ([{n: t.to(torch.bfloat16) for n, t in b.items()} for b in v]
           if k == "blocks" else v.to(torch.bfloat16))
       for k, v in p32.items()}
dirs = {"fp32": os.path.join(work, "fp32"), "bf16": os.path.join(work, "bf16")}
save_decoder(dirs["fp32"], m32, p32)
save_decoder(dirs["bf16"], m16, p16)
prompts, budgets = cs._requests()
cells = [("fp32 K=1", "fp32", "off", 1)] + [
    ("%s K=%d" % (label, cs.MEGASTEP_K), dec, mode, cs.MEGASTEP_K)
    for label, dec, mode in cs.MS_RUNS]
keys = ("decode_tokens_per_s", "tpot_ms_p50", "ttft_ms_p50",
        "host_gap_ms_per_token", "wall_s")
rows = {}
for name, dec, mode, k in cells:
    row = {key: [] for key in keys}
    for rep in range(REPEATS):
        run = cs.serve_run(dirs[dec], prompts, budgets, kv_quant_dtype=mode,
                           megastep_k=k)
        st = cs._serving_stats(run)
        for key in keys:
            row[key].append(st[key])
        if rep < REPEATS - 1:
            del run
    if k > 1:
        prof = cs.megastep_profile(run["engine"], prompts)
        row.update({key: prof.get(key) for key in (
            "trip_wall_ms", "chained_trip_wall_ms", "loop_ms",
            "trip_replay_ms", "device_busy_ms", "k3_ms")})
        del run
        model, params = load_decoder(dirs[dec], device="cuda")
        eng = PagedDecodeEngine(model, params, max_slots=cs.SLOTS,
                                max_len=cs.MAX_LEN,
                                prefill_buckets=cs.BUCKETS,
                                page_size=cs.PAGE, kv_quant_dtype=mode,
                                megastep_k=k, device="cuda")
        for i, p in enumerate(prompts[:cs.SLOTS]):
            eng.prefill(i, p, max_new_tokens=4 * k + 4)
            eng.set_input_token(i, 1)
        ms, step0 = [], 0
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step0 += eng.megastep_decode(cs.SEED, step0, k)["trips"]
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        row["megastep_host_ms"] = ms
        del eng
    else:
        del run
    rows[name] = row
print("AB_SERVE " + json.dumps(rows))
"""


def ab_timing(parent, script=None, tag="AB_ROWS"):
    """``script`` (default: the flash kernels and K3, ``_ab_script``) run
    in turns — the checkout at ``parent``, this tree, this tree,
    ``parent`` — each in its own process from its tree's root, so it runs
    that tree's code; its line ``TAG <json>`` is kept. [{"tree",
    "rows"}]."""
    script = script or _ab_script()
    runs = []
    for label, root in (("parent", parent), ("this", REPO), ("this", REPO),
                        ("parent", parent)):
        proc = subprocess.run([sys.executable, "-c", script],
                              cwd=os.path.abspath(root), capture_output=True,
                              text=True, timeout=900)
        rows = [json.loads(ln[len(tag) + 1:])
                for ln in proc.stdout.splitlines()
                if ln.startswith(tag + " ")]
        if proc.returncode or not rows:
            raise RuntimeError("A/B run in %s failed (exit %d): %s"
                               % (root, proc.returncode, proc.stderr[-3000:]))
        runs.append({"tree": label, "rows": rows[0]})
        if tag == "AB_ROWS":
            log("%s: %s" % (label, " ".join(
                "%s=%.4f" % (r["name"], r["ms"]) for r in rows[0])))
        else:
            log("%s: %s" % (label, json.dumps(rows[0])))
    return runs


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if "--resume-child" in argv:
        return resume_child(argv)
    # cuBLAS reads it when it starts: the deterministic gates need it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write the full report as JSON here")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks (phases 1-3)")
    ap.add_argument("--ab", metavar="PARENT", default=None,
                    help="only time the flash kernels in turns against "
                         "the checkout at PARENT")
    ap.add_argument("--ab-serving", metavar="PARENT", default=None,
                    help="only run phase 4's fp32 and phase 12's served "
                         "cells in turns against the checkout at PARENT")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    report = {"card": card(), "phase_s": {}}
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        t0 = time.perf_counter()
        mark = [t0]

        def lap(name):
            """The seconds since the last lap, as ``phase_s[name]``."""
            now = time.perf_counter()
            report["phase_s"][name] = now - mark[0]
            mark[0] = now

        if args.ab:
            report["ab"] = ab_timing(args.ab)
            return 0
        if args.ab_serving:
            report["ab_serving"] = ab_timing(args.ab_serving, _AB_SERVE,
                                             "AB_SERVE")
            return 0
        report["build_s"] = build()
        lap("build_s")
        data = packed_data(LM_BATCH, LM_SEQ)
        report["kernel_checks"] = kernel_checks()
        lap("kernel_checks")
        report["quant_kernel_checks"] = quant_kernel_checks()
        lap("quant_kernel_checks")
        report["quant_append_checks"] = quant_append_checks()
        lap("quant_append_checks")
        report["flash_checks"] = flash_checks()
        lap("flash_checks")
        report["segment_checks"] = segment_checks(data["packed"]["seg"])
        lap("segment_checks")
        report["layout_checks"] = layout_checks()
        lap("layout_checks")
        report["fused_adam_checks"] = fused_adam_checks()
        lap("fused_adam_checks")
        if not args.kernels_only:
            report["main_path"] = main_path(workdir)
            lap("main_path")
            report["megastep_path"] = megastep_path(
                report["main_path"], report["card"]["nvidia_smi"])
            lap("megastep_path")
            report["spec_path"] = spec_path(report["main_path"],
                                            report["megastep_path"], workdir)
            lap("spec_path")
            for key in ("_streams", "_recompute", "_dirs"):
                report["main_path"].pop(key)
            # K3's rows count the launches of every serving path
            for row, name in ((report["main_path"]["k3"], "k3"),
                              (report["main_path"]["k3_quant"],
                               "k3_quant")):
                row["launches"] += report["megastep_path"]["launches"][name]
                row["launches"] += report["spec_path"]["launches"][name]
            report["k3_long"] = k3_long_timing()
            lap("k3_long")
            report["train_gate"] = train_gate()
            lap("train_gate")
            report["capture_gc_gate"] = capture_gc_gate()
            lap("capture_gc_gate")
            report["train_path"] = train_path()
            lap("train_path")
            report["flash_timing"] = flash_timing(
                report["train_path"]["launches"])
            lap("flash_timing")
            report["packed_path"], scope = packed_path(data)
            lap("packed_path")
            report["segment_timing"] = flash_timing(
                report["packed_path"]["launches"], data["packed"]["seg"])
            lap("segment_timing")
            report["fused_adam_path"] = fused_adam_path(
                data, scope, report["packed_path"])
            lap("fused_adam_path")
            del scope
            report["fused_adam_timing"] = fused_adam_timing(
                report["fused_adam_path"]["param_shapes"],
                report["fused_adam_path"]["launches"])
            lap("fused_adam_timing")
            report["bhsd_path"] = bhsd_path()
            lap("bhsd_path")
            report["dense_path"] = dense_path()
            lap("dense_path")
            report["layout_timing"] = layout_timing(
                report["bhsd_path"]["launches"], report["dense_path"])
            lap("layout_timing")
            report["lm_replay_gates"] = [lm_replay_gate(),
                                         lm_replay_gate("packed")]
            lap("lm_replay_gates")
            report["dropout_gate"] = dropout_gate()
            lap("dropout_gate")
            report["bench_lm"] = bench_lm_rounds({
                "dense": report["train_path"]["step_ms_p50"],
                "packed": report["packed_path"]["step_ms_p50"]})
            lap("bench_lm")
            report["resume_gate"] = resume_gate(workdir)
            lap("resume_gate")
            # the kernel rows count phase 13's launches too
            extra = phase13_launches(report)
            for row in report["flash_timing"] + report["segment_timing"] + \
                    [report["fused_adam_timing"]] + report["layout_timing"]:
                row["launches"] += extra.get(row["name"], 0)
            report["resnet_op_checks"] = resnet_op_checks()
            lap("resnet_op_checks")
            report["resnet_gate"] = resnet_gate()
            lap("resnet_gate")
            report["resnet_replay_gate"] = resnet_replay_gate()
            lap("resnet_replay_gate")
            report["resnet_path"] = resnet_path(
                report["card"]["nvidia_smi"])
            lap("resnet_path")
            # phase 15: no hand-written kernel may launch in it
            _zero_counts()
            report["lstm_op_checks"] = lstm_op_checks()
            lap("lstm_op_checks")
            report["nmt_gate"] = nmt_gate()
            lap("nmt_gate")
            report["nmt_replay_gates"] = [nmt_replay_gate(False),
                                          nmt_replay_gate(True)]
            lap("nmt_replay_gates")
            report["nmt_path"] = nmt_path(report["card"]["nvidia_smi"])
            lap("nmt_path")
            _counts_gate("phase 15", _kernel_counts(), {})
            # phase 16: no hand-written kernel may launch in this process
            # (the three-line bench's LM child launches K1/K2 in its own)
            _zero_counts()
            report["fp8_gates"] = fp8_gates()
            lap("fp8_gates")
            report["fp8_replay_gates"] = [fp8_replay_gate("e5m2"),
                                          fp8_replay_gate("delayed")]
            lap("fp8_replay_gates")
            report["fp8_resnet_path"] = fp8_resnet_path(
                report["card"]["nvidia_smi"], report["resnet_path"])
            lap("fp8_resnet_path")
            report["three_line_bench"] = three_line_bench()
            lap("three_line_bench")
            _counts_gate("phase 16", _kernel_counts(), {})
            # phase 17: inference deployment; (a)-(c) launch no
            # hand-written kernel, (d) K1 alone
            _zero_counts()
            arts, alone = {}, {}
            report["infer_export_lstm"], arts["lstm"], lstm_dir = \
                export_gate("lstm", workdir)
            lap("infer_export_lstm")
            # the CLI child boots while ResNet-50 exports and serves
            child = start_serve_cli(lstm_dir)
            try:
                report["infer_export_resnet"], arts["resnet"], _ = \
                    export_gate("resnet", workdir)
                lap("infer_export_resnet")
                for kind in ("resnet", "lstm"):
                    report["infer_serve_" + kind], alone[kind] = \
                        serve_gate(kind, arts.pop(kind))
                    lap("infer_serve_" + kind)
                report["infer_http"] = http_gate(child, *alone["lstm"])
                lap("infer_http")
            finally:
                stop_child(child)
            _counts_gate("phase 17 (a)-(c)", _kernel_counts(), {})
            report["infer_lm"] = lm_export_gate(workdir)
            lap("infer_lm")
            for row in report["flash_timing"]:
                row["launches"] += report["infer_lm"]["launches"].get(
                    row["name"], 0)
            # phase 18: disaggregated serving; K3 and K3-quant in process
            report["disagg_path"] = disagg_path(
                workdir, report["card"]["nvidia_smi"])
            lap("disagg_path")
            for row, name in ((report["main_path"]["k3"], "k3"),
                              (report["main_path"]["k3_quant"],
                               "k3_quant")):
                row["launches"] += report["disagg_path"]["launches"][name]
            # phase 19: the serving fleet; K3 and K3-quant in the replica
            # processes (read from their drain lines) and in process
            report["fleet_path"] = fleet_path(
                workdir, report["card"]["nvidia_smi"])
            lap("fleet_path")
            for row, name in ((report["main_path"]["k3"], "k3"),
                              (report["main_path"]["k3_quant"],
                               "k3_quant")):
                row["launches"] += report["fleet_path"]["launches"][name]
                row["launches"] += \
                    report["fleet_path"]["replica_launches"][name]
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
        print(json.dumps({"kernels": [report["main_path"]["k3"],
                                      report["main_path"]["k3_quant"],
                                      report["megastep_path"]["loop_row"]] +
                          report["flash_timing"] +
                          report["segment_timing"] +
                          [report["fused_adam_timing"]] +
                          report["layout_timing"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": report["card"]["name"],
        "count": report["card"]["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
