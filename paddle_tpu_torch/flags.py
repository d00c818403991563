"""Runtime flags the port reads — a trimmed copy of
``paddle_tpu/flags.py`` (the port keeps its own copy; it never imports the
JAX package). Set by assignment (``flags.generation_max_slots = 32``) or
passed explicitly to the resolvers, which validate each value and raise
``ValueError`` naming the ``FLAGS_*`` knob.

Not carried over: ``use_pallas_attention``. In the port a CUDA tensor
always goes through the hand-written kernel (or raises), so there is no
switch that routes the card around it.
"""

# Online serving (serving.batcher.resolve_serving_knobs; the
# MicroBatcher and the serve CLI read these when no explicit knob is
# passed):
# - ``serving_max_batch_size`` — ceiling on a dynamic micro-batch; the
#   batcher flushes early when the window fills.
# - ``serving_max_wait_ms`` — how long the first request of a window
#   waits for co-riders before the partial window flushes.
# - ``serving_queue_depth`` — admission bound; a full queue rejects with
#   an explicit overload error (HTTP 503) instead of letting latency
#   climb unbounded.
# - ``bucket_multiple`` — ragged feeds of an inference session pad to a
#   multiple of this (bounding the distinct shapes it runs).
# - ``online_log_events`` — ``/v1/infer`` appends a ``serving_event``
#   record to the open run log for each request that carries an
#   ``outcome`` label (the client-side feedback join).
serving_max_batch_size = 8
serving_max_wait_ms = 5.0
serving_queue_depth = 128
bucket_multiple = 32
online_log_events = True

# Generation (serving.generation.resolve_generation_knobs):
# ``generation_max_slots`` — decode-batch width (KV-cache slots);
# ``generation_max_len`` — per-slot capacity (prompt + generated);
# ``generation_prefill_buckets`` — prompt padding lengths.
generation_max_slots = 8
generation_max_len = 256
generation_prefill_buckets = "16,32,64,128"

# Paged KV cache + speculative decoding (resolve_generation_knobs(
# paged=True)):
# ``kv_page_size`` tokens per page; ``kv_num_pages`` pool capacity per
# layer (0 = auto, the dense-equivalent budget, doubled when the pages are
# quantized).
# ``speculative_k`` — tokens drafted per speculative-decode round (0
# disables). Requires a draft model (serve --gen-draft-model); greedy
# requests then emit up to k tokens per verify step, token-identical to
# plain greedy decoding.
# ``generation_megastep_k`` — decode trips per scheduler dispatch
# (``PagedDecodeEngine.megastep_dispatch``): one trip is captured as a
# CUDA graph and replayed, with token feedback, sampling and EOS/budget
# freezing on the device, so the host pays one dispatch and one sync per
# K tokens. 1 = the step-at-a-time loop; 0 = auto (min(8,
# generation_max_len - 1)). The scheduler clamps each megastep's K by the
# widest remaining budget and the tightest deadline's slack.
kv_page_size = 16
kv_num_pages = 0
speculative_k = 0
generation_megastep_k = 1

# Quantized KV pages (``resolve_generation_knobs(paged=True)`` validates
# them; errors name the FLAGS_* knob):
# ``kv_quant_dtype`` — KV-page storage of the paged engine: "off" (the
# model dtype), "fp8" (float8_e4m3fn) or "int8", with per-(page, group,
# kv-head) fp32 scales; decode attention goes through K3-quant.
# ``kv_quant_group`` — tokens per scale group within a page (0 = one group
# per page); must divide kv_page_size.
kv_quant_dtype = "off"
kv_quant_group = 0

# End-to-end deadlines and brownout load shedding (the scheduler's share
# of ``serving.registry.resolve_fleet_knobs``; errors name the flag):
# ``deadline_default_ms`` — implicit per-request deadline (0 = none);
# ``deadline_admit_min_ms`` — budget a request must have left to be
# admitted (HTTP 504 before any prefill otherwise).
#
# Brownout load shedding (watermark-driven ladder with hysteresis over
# queue/page-pool pressure — serving.generation.BrownoutController):
#
# - ``shed_high_watermark`` / ``shed_low_watermark`` — pressure (max of
#   queue fullness and KV-page-pool occupancy, in [0, 1]) above high
#   escalates the brownout level one step per evaluation; below low
#   de-escalates; between the two the level holds (hysteresis).
# - ``shed_token_cap`` — at brownout level >= 2, new admissions'
#   max_new_tokens are clamped to this many tokens.
# - ``shed_retry_floor_s`` / ``shed_retry_cap_s`` — clamp on the
#   Retry-After hint derived from the observed queue drain rate
#   (backlog / drain rate) that overload and shed 503s carry.
deadline_default_ms = 0.0
deadline_admit_min_ms = 0.0
shed_high_watermark = 0.85
shed_low_watermark = 0.60
shed_token_cap = 16
shed_retry_floor_s = 0.05
shed_retry_cap_s = 5.0

# Multi-tenant isolation + SLO-driven admission (validated by
# ``serving.generation.resolve_tenant_knobs``, whose errors name the
# offending FLAGS_* name):
#
# - ``tenant_token_budget`` — default per-tenant decode-token budget per
#   accounting window (0 = unlimited). A tenant over budget is not
#   503d: its next admissions wait in the held lane until the window
#   rolls, so a hot tenant throttles ITSELF, never the fleet.
# - ``tenant_token_budget_map`` — per-tenant overrides as
#   "tenantA=500,tenantB=100"; unlisted tenants get the default.
# - ``tenant_budget_window_s`` — budget accounting window length.
# - ``tenant_held_depth`` — bound on the held queue (page-pressure
#   holds, budget throttles, and SLO preemptions all park here).
#   Overflow sheds with 503 + Retry-After like any overload.
# - ``slo_ttft_ms`` / ``slo_tpot_ms`` — per-class targets as
#   "high=250,low=0" (0 / unlisted class = no target; "" disables the
#   control loop for that signal). Compared against live observations
#   every scheduler iteration.
# - ``slo_sustain_s`` — a violation must persist this long before the
#   scheduler reacts (preempt low-class work to the held lane, clamp
#   the megastep K, feed the brownout ladder) — transient blips don't
#   trigger preemption.
tenant_token_budget = 0
tenant_token_budget_map = ""
tenant_budget_window_s = 1.0
tenant_held_depth = 8
slo_ttft_ms = ""
slo_tpot_ms = ""
slo_sustain_s = 1.0

# Debugging: ``check_nan_inf`` — per-step NaN/Inf scan of the fetches and
# the updated state (``Executor._nan_check``); forces a host sync and
# raises ``FloatingPointError`` naming the variable.
check_nan_inf = False

# Input pipeline: ``length_pool_factor`` — the default pool size, in
# batches, of ``data.decorator.pool_batch_by_length``: it buffers
# ``length_pool_factor x batch_size`` samples, sorts them by length and
# slices near-uniform-length batches off the sorted pool. A bigger pool
# cuts pad waste further but delays streaming and costs host memory.
length_pool_factor = 16

# Observability (observability.flight_recorder):
# - ``flight_recorder_events`` — ring-buffer capacity of the always-on
#   trace flight recorder (executor-level spans; a handful per step).
#   Read at first use; resize a live recorder via
#   ``observability.flight_recorder.get_recorder().set_capacity(n)``.
# - ``trace_dump_dir`` — where crash/SIGUSR1 flight-recorder dumps land
#   (default: the system temp dir).
flight_recorder_events = 4096
trace_dump_dir = ""

# Fault-tolerant training runtime (robustness.CheckpointManager /
# robustness.train_loop read these):
#
# - ``checkpoint_dir`` — root of the versioned serial-dir checkpoints
#   ("" = checkpointing disabled; ``CheckpointManager.from_flags()``
#   returns None so call sites need no conditional wiring).
# - ``checkpoint_every_steps`` / ``checkpoint_every_secs`` — save policy;
#   either (or both) may be set, 0 disables that trigger. The save
#   snapshots device state to host synchronously (one consistent cut)
#   and writes/fsyncs in a background thread overlapping training.
# - ``checkpoint_keep`` — newest serials retained after each save.
# - ``step_retry_max`` / ``step_retry_backoff_s`` — retryable step
#   failures (transient host/IO) are retried with capped exponential
#   backoff; fatal ones (DeviceStateError, NaN) never are.
# - ``step_deadline_s`` — hang watchdog: a step exceeding this many
#   wall seconds dumps the flight recorder + faulthandler stacks and
#   aborts with EXIT_WATCHDOG. 0 disables.
checkpoint_dir = ""
checkpoint_every_steps = 0
checkpoint_every_secs = 0.0
checkpoint_keep = 3
step_retry_max = 3
step_retry_backoff_s = 0.5
step_deadline_s = 0.0

# Chaos fault injection (robustness.chaos parses these). ``chaos_spec``
# is a comma-separated list of ``point:selector=action`` rules, e.g.
# ``step:37=raise``, ``save:2=kill9``, ``step:*=raise@0.01``
# (probabilistic rules draw from a PRNG seeded by ``chaos_seed`` —
# deterministic, replayable). "" = no injection (the hooks are free
# no-ops).
chaos_spec = ""
chaos_seed = 0
