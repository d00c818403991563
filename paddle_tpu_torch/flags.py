"""Runtime flags the ported serving slice reads — a trimmed copy of
``paddle_tpu/flags.py`` (the port keeps its own copy; it never imports the
JAX package). Set by assignment (``flags.generation_max_slots = 32``) or
passed explicitly to the resolvers, which validate each value and raise
``ValueError`` naming the ``FLAGS_*`` knob.

Not carried over: ``use_pallas_attention``. In the port a CUDA tensor
always goes through the hand-written kernel (or raises), so there is no
switch that routes the card around it.
"""

# Serving admission (serving.batcher.resolve_serving_knobs):
# ``serving_queue_depth`` bounds the admission queue — a full queue
# rejects with an explicit overload error (HTTP 503) instead of letting
# latency climb unbounded. The micro-batcher's batch-size and wait knobs
# come with the micro-batcher, which is not ported yet.
serving_queue_depth = 128

# Generation (serving.generation.resolve_generation_knobs):
# ``generation_max_slots`` — decode-batch width (KV-cache slots);
# ``generation_max_len`` — per-slot capacity (prompt + generated);
# ``generation_prefill_buckets`` — prompt padding lengths.
generation_max_slots = 8
generation_max_len = 256
generation_prefill_buckets = "16,32,64,128"

# Paged KV cache (resolve_generation_knobs(paged=True)):
# ``kv_page_size`` tokens per page; ``kv_num_pages`` pool capacity per
# layer (0 = auto, the dense-equivalent budget, doubled when the pages are
# quantized). The knob of speculative decoding comes with that path.
# ``generation_megastep_k`` — decode trips per scheduler dispatch
# (``PagedDecodeEngine.megastep_dispatch``): one trip is captured as a
# CUDA graph and replayed, with token feedback, sampling and EOS/budget
# freezing on the device, so the host pays one dispatch and one sync per
# K tokens. 1 = the step-at-a-time loop; 0 = auto (min(8,
# generation_max_len - 1)). The scheduler clamps each megastep's K by the
# widest remaining budget and the tightest deadline's slack.
kv_page_size = 16
kv_num_pages = 0
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

# End-to-end deadlines and overload hints (the scheduler's share of
# serving.registry.resolve_fleet_knobs in the reference):
# ``deadline_default_ms`` — implicit per-request deadline (0 = none);
# ``deadline_admit_min_ms`` — budget a request must have left to be
# admitted; ``shed_retry_floor_s`` / ``shed_retry_cap_s`` clamp the
# drain-rate Retry-After hint of overload 503s.
deadline_default_ms = 0.0
deadline_admit_min_ms = 0.0
shed_retry_floor_s = 0.05
shed_retry_cap_s = 5.0
