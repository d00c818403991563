"""The metric catalogue of the port — the names, help text and label
sets of ``paddle_tpu/observability/catalog.py`` for every metric the
ported slices record, with the typed-metric layer of
``paddle_tpu/observability/registry.py`` folded in.

Storage is ``profiler``'s counters and histograms; a labelled sample is
stored under ``name|k=v,k2=v2`` (keys sorted), which the Prometheus
renderer (``serving.metrics``) splits back into ``name{k="v"}``. A metric
declared with ``legacy=`` stores under that older key
(``feed_wait_s``, ``device_wait_s``), so ``profiler.get_counters()``
readers see the reference's keys. Exposition names and help strings
match the reference, so one scrape config reads either package.
"""

from .. import profiler

__all__ = [
    "Counter", "Gauge", "Histogram", "resolve", "parse_storage_key",
    "encode_storage_key", "live_gauges",
    "STEPS_TOTAL", "COMPILE_CACHE_HITS", "COMPILE_CACHE_MISSES",
    "COMPILE_SECONDS", "FEED_WAIT_SECONDS", "DEVICE_WAIT_SECONDS",
    "STEP_SECONDS", "CHECKPOINTS_SAVED", "CHECKPOINT_WRITE_SECONDS",
    "CHECKPOINT_LAST_STEP", "CHECKPOINT_GC_SECONDS", "STEP_RETRIES",
    "PREEMPTIONS", "CHAOS_INJECTED", "FLIGHT_DROPPED", "FLIGHT_DUMPS",
    "ATTENTION_MASK_BYTES_AVOIDED", "PACKED_SEGMENTS",
    "GENERATION_REQUESTS", "GENERATION_REJECTED", "GENERATION_FAILED",
    "GENERATION_PREFILLS", "GENERATION_DECODE_STEPS", "GENERATION_TOKENS",
    "GENERATION_PREFILL_MS", "GENERATION_DECODE_STEP_MS",
    "GENERATION_SLOT_OCCUPANCY", "GENERATION_MEGASTEPS",
    "GENERATION_MEGASTEP_TRIPS", "DECODE_HOST_GAP_SECONDS",
    "DECODE_HOST_GAP", "PREFIX_CACHE_HITS",
    "PREFIX_CACHE_EVICTIONS", "PAGE_EVICTIONS", "DEADLINE_EXCEEDED",
    "REQUEST_TTFT_SECONDS", "REQUEST_TPOT_SECONDS", "REQUESTS_FINISHED",
    "KV_QUANT_PAGES", "WEIGHT_QUANT_ARTIFACTS", "SPECULATIVE_DRAFTED",
    "SPECULATIVE_ACCEPTED", "SPECULATIVE_FALLBACK", "REQUESTS_SHED",
    "TENANT_TOKENS", "PREEMPTIONS_TO_HELD", "SLO_VIOLATION_SECONDS",
]

_LABEL_SEP = "|"
_by_storage = {}   # storage key and name -> metric (filled at import)


def encode_storage_key(base, labels):
    """Flat profiler-storage key for one labelled sample."""
    if not labels:
        return base
    return base + _LABEL_SEP + ",".join(
        "%s=%s" % (k, labels[k]) for k in sorted(labels))


def parse_storage_key(key):
    """Inverse of :func:`encode_storage_key`: ``(base, {label: value})``."""
    if _LABEL_SEP not in key:
        return key, {}
    base, _, enc = key.partition(_LABEL_SEP)
    labels = {}
    for pair in enc.split(","):
        k, _, v = pair.partition("=")
        if k:
            labels[k] = v
    return base, labels


class _Metric:
    kind = None

    def __init__(self, name, help="", labels=(), unit="", legacy=None):
        self.name = name
        self.help = help
        self.unit = unit
        self.label_names = tuple(labels)
        # the profiler-storage key: the legacy name when one exists
        self.storage_key = legacy or name
        _by_storage[name] = _by_storage[self.storage_key] = self

    def _key(self, labels):
        if set(labels) != set(self.label_names):
            raise ValueError("metric %r takes labels %r, got %r"
                             % (self.name, self.label_names, tuple(labels)))
        return encode_storage_key(self.storage_key, labels)


class Counter(_Metric):
    """Monotonically increasing total (name ends in ``_total``)."""

    kind = "counter"

    def inc(self, value=1.0, **labels):
        if value < 0:
            raise ValueError("counter %r cannot decrease" % self.name)
        profiler.incr_counter(self._key(labels), value)

    def value(self, **labels):
        return profiler.get_counters().get(self._key(labels), 0.0)


class Gauge(_Metric):
    """A value that can go up and down (the last checkpoint's step)."""

    kind = "gauge"

    def set(self, value, **labels):
        profiler.set_counter(self._key(labels), value)

    def value(self, **labels):
        return profiler.get_counters().get(self._key(labels), 0.0)


class Histogram(_Metric):
    """Bounded observation window rendered as a Prometheus summary."""

    kind = "histogram"

    def observe(self, value, **labels):
        profiler.record_histogram(self._key(labels), value)


def resolve(storage_key):
    """The metric owning a storage key (None for ad-hoc keys)."""
    return _by_storage.get(parse_storage_key(storage_key)[0])


# -- executor / training step telemetry ------------------------------------

STEPS_TOTAL = Counter(
    "steps_total", help="Executor steps dispatched (run_steps counts its "
    "device-loop iterations individually)")
COMPILE_CACHE_HITS = Counter(
    "compile_cache_hits_total",
    help="Steps served by an already-compiled executable")
COMPILE_CACHE_MISSES = Counter(
    "compile_cache_misses_total", labels=("cause",),
    help="XLA (re)compiles, attributed to what changed vs the previous "
    "compile of the same program: first_compile, feed_signature, "
    "fetch_list, program_version, param_set, mode, n_steps")
COMPILE_SECONDS = Counter(
    "compile_seconds_total",
    help="Host seconds spent building/jit-wrapping step executables",
    unit="seconds")
FEED_WAIT_SECONDS = Counter(
    "feed_wait_seconds_total", legacy="feed_wait_s",
    help="Host seconds converting/uploading feeds (Executor._prepare)",
    unit="seconds")
DEVICE_WAIT_SECONDS = Counter(
    "device_wait_seconds_total", legacy="device_wait_s",
    help="Host seconds blocked on device results (fetch -> numpy sync)",
    unit="seconds")
STEP_SECONDS = Histogram(
    "step_seconds",
    help="Per-run() host wall seconds (feed prepare + compile + "
    "dispatch; device sync always excluded — see "
    "device_wait_seconds_total)", unit="seconds")

# -- fault-tolerant training runtime (robustness/) -------------------------

CHECKPOINTS_SAVED = Counter(
    "checkpoints_saved_total",
    help="Checkpoints committed (tensor files + TRAIN_STATE + manifest "
    "durable on disk)")
CHECKPOINT_WRITE_SECONDS = Counter(
    "checkpoint_write_seconds_total",
    help="Seconds spent writing checkpoint serials (background writer "
    "thread; overlaps training)", unit="seconds")
CHECKPOINT_LAST_STEP = Gauge(
    "checkpoint_last_step",
    help="Global step of the last committed checkpoint")
CHECKPOINT_GC_SECONDS = Counter(
    "checkpoint_gc_seconds_total",
    help="Seconds the background checkpoint GC worker spent trimming "
    "old serials (off the save path)", unit="seconds")
STEP_RETRIES = Counter(
    "step_retries_total",
    help="Training steps retried after a retryable (transient host/IO) "
    "failure — robustness.train_loop's backoff path")
PREEMPTIONS = Counter(
    "preemptions_total",
    help="Preemption signals honored: finish-step + checkpoint + exit "
    "cycles (SIGTERM/SIGINT in robustness.train_loop)")
CHAOS_INJECTED = Counter(
    "chaos_injected_total", labels=("point", "action"),
    help="Faults injected by robustness.chaos (FLAGS_chaos_spec)")

# -- flight recorder -------------------------------------------------------

FLIGHT_DROPPED = Counter(
    "flight_recorder_dropped_total",
    help="Spans evicted from the flight-recorder ring buffer")
FLIGHT_DUMPS = Counter(
    "flight_recorder_dumps_total", labels=("reason",),
    help="Flight-recorder chrome-trace exports (reason: crash, signal, "
    "http, manual)")

# -- packed-document attention (benchmarks.lm packed_main) -----------------

ATTENTION_MASK_BYTES_AVOIDED = Counter(
    "attention_mask_bytes_avoided_total",
    help="Dense-mask bytes the segment-packed attention path did NOT "
    "materialize or stream (rows × seq² int8 per attention layer per "
    "step — what the pre-packing dense-mask route would have paid; "
    "recorded by the packed benches from the step geometry)",
    unit="bytes")
PACKED_SEGMENTS = Counter(
    "packed_segments_total",
    help="Sequences packed into fixed-length segment rows by the "
    "packed input path (data.decorator.pack_segments callers)")

# -- generation (serving/generation.py) ------------------------------------

GENERATION_REQUESTS = Counter(
    "generation_requests_total",
    help="Generation requests admitted to the scheduler queue")
GENERATION_REJECTED = Counter(
    "generation_rejected_total",
    help="Generation requests rejected by admission control (HTTP 503)")
GENERATION_FAILED = Counter(
    "generation_failed_total",
    help="In-flight sequences failed by a scheduler/device error "
    "(cohort failures; admission rejections are generation_rejected_"
    "total)")
GENERATION_PREFILLS = Counter(
    "generation_prefills_total",
    help="Prompt prefills run (one per admitted request; writes the "
    "slot's KV cache)")
GENERATION_DECODE_STEPS = Counter(
    "generation_decode_steps_total",
    help="Decode steps run (one token per active slot per step)")
GENERATION_TOKENS = Counter(
    "generation_tokens_total",
    help="Tokens emitted (prefill first-tokens + decode-step tokens); "
    "rate() of this is decode tokens/sec")
GENERATION_PREFILL_MS = Histogram(
    "generation_prefill_ms",
    help="Per-request prompt prefill latency")
GENERATION_DECODE_STEP_MS = Histogram(
    "generation_decode_step_ms",
    help="Per decode-step wall latency (launch + device sync of the "
    "step's tokens)")
GENERATION_SLOT_OCCUPANCY = Histogram(
    "generation_slot_occupancy",
    help="Active KV-cache slots per decode step (ceiling = "
    "FLAGS_generation_max_slots)")

# -- megastep decoding (serving/paged_kv.py megastep_dispatch) -------------

GENERATION_MEGASTEPS = Counter(
    "generation_megasteps_total",
    help="Fused multi-token decode loops dispatched (each runs up to "
    "megastep_k device-resident decode trips; generation_decode_steps_"
    "total still counts the trips, so steps/megasteps is the fusion "
    "ratio actually achieved)")
GENERATION_MEGASTEP_TRIPS = Histogram(
    "generation_megastep_trips",
    help="Decode trips actually executed per megastep (after deadline/"
    "budget clamping and the all-finished device early exit; ceiling = "
    "FLAGS_generation_megastep_k)")
DECODE_HOST_GAP_SECONDS = Counter(
    "decode_host_gap_seconds_total",
    help="Host seconds between a decode/megastep result landing and "
    "the NEXT decode dispatch — the per-token host overhead megastep "
    "decoding amortizes; per-token gap = this / generation_tokens_"
    "total (chained double-buffered dispatches contribute 0)")
DECODE_HOST_GAP = Histogram(
    "decode_host_gap_seconds",
    help="Per-dispatch distribution of the decode host gap (see "
    "decode_host_gap_seconds_total)")

# -- paged KV cache (serving/paged_kv.py) ----------------------------------

PREFIX_CACHE_HITS = Counter(
    "prefix_cache_hits_total",
    help="Prompt-prefix pages mapped from the refcounted prefix cache "
    "instead of re-prefilled (reuse rate = hits / "
    "generation_prefills_total, in pages per admitted request)")
PREFIX_CACHE_EVICTIONS = Counter(
    "prefix_cache_evictions_total",
    help="Prefix-cache entries dropped (capacity LRU or pool pressure)")
PAGE_EVICTIONS = Counter(
    "page_evictions_total",
    help="KV pages reclaimed from the prefix cache back to the free "
    "pool to admit a new request (sole-owner entries only)")

SPECULATIVE_DRAFTED = Counter(
    "speculative_drafted_tokens_total",
    help="Tokens proposed by the draft model (speculative_k per live "
    "slot per round)")
SPECULATIVE_ACCEPTED = Counter(
    "speculative_accepted_tokens_total",
    help="Drafted tokens confirmed by the verify step and emitted — "
    "the speculative win; acceptance rate = accepted / drafted")
SPECULATIVE_FALLBACK = Counter(
    "speculative_fallback_total", labels=("reason",),
    help="Decode iterations that fell back from a speculative round to "
    "plain synced stepping, by reason: brownout (shed ladder turned "
    "speculation off), capacity (a slot's verify chunk no longer fits "
    "its reservation or the draft cache), sampled (a temperature>0 "
    "co-rider — speculation is greedy-only)")

# -- quantized serving (ops/kv_quant.py) -----------------------------------

KV_QUANT_PAGES = Counter(
    "kv_quant_pages_total",
    help="KV pages claimed in a quantized (fp8/int8) page pool — "
    "prefill reservations plus tier imports; zero on full-precision "
    "engines, so rate() > 0 confirms the quantized path is live")
WEIGHT_QUANT_ARTIFACTS = Counter(
    "weight_quant_artifacts_total",
    help="Decoder directories weight-only-quantized by "
    "quantize_decoder_dir (per-output-channel scales + weight_quant "
    "config stanza; load_decoder reconstructs a dequant-on-use model)")

# -- deadlines, brownout and token-level SLOs ------------------------------

REQUESTS_SHED = Counter(
    "requests_shed_total", labels=("class",),
    help="Requests shed by brownout admission control (level >= 3), by "
    "priority class; shed 503s carry a drain-rate-derived Retry-After")
DEADLINE_EXCEEDED = Counter(
    "deadline_exceeded_total", labels=("stage",),
    help="Requests failed by end-to-end deadline expiry (HTTP 504), by "
    "stage: queue (infer request expired while queued — rejected before "
    "batch assembly), admission (generation request dead on arrival — "
    "rejected "
    "BEFORE consuming a prefill), decode (slot evicted between decode "
    "steps), held (request expired while parked in the held lane — "
    "evicted before any prefill is spent on it)")
REQUEST_TTFT_SECONDS = Histogram(
    "request_ttft_seconds",
    help="Time To First Token per generation request: submit -> first "
    "token sampled (queue wait + admission hold + prefill)")
REQUEST_TPOT_SECONDS = Histogram(
    "request_tpot_seconds",
    help="Time Per Output Token per generation request: mean inter-"
    "token latency after the first token (requests emitting >= 2 "
    "tokens)")
REQUESTS_FINISHED = Counter(
    "requests_finished_total", labels=("path", "outcome"),
    help="Requests resolved, by path (infer, generate) and outcome (ok, "
    "eos, length, error, deadline); the newest trace per combination is "
    "exposed as an # EXEMPLAR comment on /metrics")

# -- multi-tenant isolation + SLO admission control (serving/generation.py).
# Tenant ids are never labels — only the bounded priority class /
# preemption reason ------------------------------------------------------

TENANT_TOKENS = Counter(
    "tenant_tokens_total", labels=("class",),
    help="Decode tokens charged against per-tenant budgets, by priority "
    "class (tenant ids live on trace spans, never on labels); a tenant "
    "over FLAGS_tenant_token_budget is throttled to the held lane, not "
    "503d")
PREEMPTIONS_TO_HELD = Counter(
    "preemptions_to_held_total", labels=("reason",),
    help="In-flight requests preempted between megasteps and parked on "
    "the held queue (reason: pages — pool pressure blocked a "
    "higher-class admission; slo — sustained high-class SLO violation; "
    "budget — tenant exceeded its token budget). Full KV pages stay in "
    "the prefix cache, so re-admission prefills only the suffix and the "
    "greedy continuation is token-identical")
SLO_VIOLATION_SECONDS = Counter(
    "slo_violation_seconds_total", labels=("class",),
    help="Seconds a priority class spent violating its TTFT/TPOT target "
    "(FLAGS_slo_ttft_ms / FLAGS_slo_tpot_ms); sustained high-class "
    "violation beyond FLAGS_slo_sustain_s drives low-class preemption, "
    "the megastep clamp, and the brownout pressure signal")

# Gauges passed LIVE to the renderer by their owner (no profiler storage):
_LIVE_GAUGES = {
    "generation_active_slots":
        "KV-cache slots currently decoding (live scheduler gauge)",
    "generation_held_requests":
        "Requests parked in the held lane (page-pressure holds, tenant "
        "budget throttles, SLO preemptions), bounded by "
        "FLAGS_tenant_held_depth",
    "brownout_level":
        "Current brownout shed-ladder level (0 = normal, 1 = "
        "speculative decoding off, 2 = new-token caps shrunk, 3 = "
        "low-priority requests shed)",
    "kv_pages_in_use":
        "KV pages currently allocated (slots + prefix cache) out of "
        "kv_pages_total — pool occupancy",
    "kv_pages_total": "KV page-pool capacity per layer",
    "kv_pool_effective_capacity":
        "Admission token capacity of the page pool (num_pages × "
        "page_size)",
}


def live_gauges():
    return dict(_LIVE_GAUGES)
