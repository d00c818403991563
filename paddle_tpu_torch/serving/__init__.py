"""Generation serving on the port: paged-KV decode engine (full-precision
or int8/fp8 pages), continuous-batching scheduler, weight-only quantized
decoders and the ``/v1/generate`` HTTP server."""

from .batcher import (DeadlineExceededError, DrainRateEstimator,
                      OverloadedError, PendingResult, ServingClosedError,
                      resolve_serving_knobs)
from .generation import (DeviceStateError, GenerationScheduler,
                         TransformerDecoderModel, full_recompute_generate,
                         greedy_generate, load_decoder,
                         quantize_decoder_dir, resolve_generation_knobs,
                         save_decoder)
from .metrics import render_prometheus
from .paged_kv import (PagedDecodeEngine, PagePool, PoolExhaustedError,
                       PrefixCache)
from .server import ServingServer, make_server

__all__ = [
    "DeadlineExceededError", "DrainRateEstimator", "OverloadedError",
    "PendingResult", "ServingClosedError", "resolve_serving_knobs",
    "DeviceStateError", "GenerationScheduler", "TransformerDecoderModel",
    "full_recompute_generate", "greedy_generate", "load_decoder",
    "quantize_decoder_dir", "resolve_generation_knobs", "save_decoder",
    "render_prometheus",
    "PagedDecodeEngine", "PagePool", "PoolExhaustedError", "PrefixCache",
    "ServingServer", "make_server",
]
