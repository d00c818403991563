"""Serving on the port: ``/v1/infer`` (an exported artifact or a pruned
program behind ``InferenceSession``, the dynamic ``MicroBatcher``) and
generation — dense and paged-KV decode engines (full-precision or
int8/fp8 pages), speculative decoding over a dense draft engine, the
continuous-batching scheduler with tenants, priorities, brownout, SLO
control and preemption, weight-only quantized decoders — behind one HTTP
server, and its ``ServingClient``; and disaggregated serving: the KV-page
handoff (``kv_transfer``: the md5-manifest wire form, ``PrefillWorker``
behind ``POST /v1/prefill``) and the fleet prefix-cache tier
(``prefix_tier``: store, index server and the degrading client that paged
engines map pages through); and the serving fleet (``fleet``: the router
with the prefill hop, the replica supervisor, rolling hot-swap and the
artifact serials, and its HA over the shared ``registry``: replica
records, the supervisor lease, standby takeover and adoption), imported at
first use so that ``python -m
paddle_tpu_torch.serving.fleet`` runs the module once."""

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
from .kv_transfer import (PrefillWorker, TornTransferError, TransferError,
                          resolve_kv_transfer_knobs)
from .metrics import render_prometheus
from .paged_kv import (PagedDecodeEngine, PagePool, PoolExhaustedError,
                       PrefixCache, can_speculate, speculative_greedy_generate,
                       speculative_round, validate_draft_geometry)
from .prefix_tier import (PrefixTierClient, PrefixTierServer,
                          PrefixTierStore, make_tier_server)
from .registry import (Lease, ReplicaRegistry, StaleIncarnationError,
                       parse_deadline_header, parse_tenant_header,
                       resolve_fleet_knobs)
from .server import ServingServer, make_server
from .session import InferenceSession

_FLEET = ("CircuitBreaker", "RouterBackend", "FleetRouter",
          "ReplicaSupervisor", "publish_artifact", "latest_artifact",
          "merge_scrapes")

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
    "ReplicaRegistry", "Lease", "StaleIncarnationError",
    "PrefillWorker", "TransferError", "TornTransferError",
    "resolve_kv_transfer_knobs", "PrefixTierClient", "PrefixTierServer",
    "PrefixTierStore", "make_tier_server",
    "ServingServer", "make_server",
] + list(_FLEET)


def __getattr__(name):
    if name in _FLEET:
        import importlib
        return getattr(importlib.import_module(".fleet", __name__), name)
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
