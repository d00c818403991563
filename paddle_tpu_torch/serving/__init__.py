"""Serving on the port: ``/v1/infer`` (an exported artifact or a pruned
program behind ``InferenceSession``, the dynamic ``MicroBatcher``) and
generation — dense and paged-KV decode engines (full-precision or
int8/fp8 pages), speculative decoding over a dense draft engine, the
continuous-batching scheduler with tenants, priorities, brownout, SLO
control and preemption, weight-only quantized decoders — behind one HTTP
server, and its ``ServingClient``."""

from .batcher import (DeadlineExceededError, DrainRateEstimator,
                      MicroBatcher, OverloadedError, PendingResult,
                      ServingClosedError, resolve_serving_knobs)
from .client import ServingClient
from .generation import (BrownoutController, DecodeEngine, DeviceStateError,
                         GenerationScheduler, TransformerDecoderModel,
                         full_recompute_generate, greedy_generate,
                         load_decoder, quantize_decoder_dir,
                         resolve_generation_knobs, resolve_tenant_knobs,
                         save_decoder)
from .metrics import render_prometheus
from .paged_kv import (PagedDecodeEngine, PagePool, PoolExhaustedError,
                       PrefixCache, can_speculate, speculative_greedy_generate,
                       speculative_round, validate_draft_geometry)
from .registry import (parse_deadline_header, parse_tenant_header,
                       resolve_fleet_knobs)
from .server import ServingServer, make_server
from .session import InferenceSession

__all__ = [
    "DeadlineExceededError", "DrainRateEstimator", "MicroBatcher",
    "OverloadedError", "PendingResult", "ServingClosedError",
    "resolve_serving_knobs", "ServingClient", "InferenceSession",
    "BrownoutController", "DecodeEngine", "DeviceStateError",
    "GenerationScheduler", "TransformerDecoderModel",
    "full_recompute_generate", "greedy_generate", "load_decoder",
    "quantize_decoder_dir", "resolve_generation_knobs",
    "resolve_tenant_knobs", "save_decoder",
    "render_prometheus",
    "PagedDecodeEngine", "PagePool", "PoolExhaustedError", "PrefixCache",
    "can_speculate", "speculative_greedy_generate", "speculative_round",
    "validate_draft_geometry",
    "parse_deadline_header", "parse_tenant_header", "resolve_fleet_knobs",
    "ServingServer", "make_server",
]
