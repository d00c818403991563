"""Serve an exported inference artifact and/or a saved decoder over HTTP
with the port — its counterpart of the reference's ``tools/serve.py``:

    python -m paddle_tpu_torch.serving.serve [--artifact DIR] \
        [--generation-model DIR] [--device cuda] [--host 127.0.0.1] \
        [--port 8500] [--max-batch-size 8] [--max-wait-ms 5] \
        [--queue-depth N] [--max-inflight 2] [--bucket-multiple 32] \
        [--no-pad-batch-pow2] \
        [--gen-max-slots 32] [--gen-max-len 1024] \
        [--gen-prefill-buckets 64,128,256,512] [--gen-eos-id ID] \
        [--gen-paged] [--gen-page-size 16] \
        [--gen-num-pages 0] [--kv-quant-dtype off|int8|fp8] \
        [--kv-quant-group N] [--gen-megastep-k K] \
        [--gen-draft-model DRAFT_DIR] [--gen-speculative-k K] \
        [--tenant-token-budget N] [--tenant-token-budget-map A=N,B=M] \
        [--tenant-budget-window-s S] [--tenant-held-depth N] \
        [--slo-ttft-ms high=MS,low=MS] [--slo-tpot-ms high=MS] \
        [--slo-sustain-s S] [--role both|decode|prefill] \
        [--kv-transfer-dir DIR] [--prefix-tier-url URL] [--chaos-spec SPEC]

``--artifact`` (an ``export_artifact`` directory) serves POST /v1/infer
through the dynamic ``MicroBatcher`` (``--max-batch-size``,
``--max-wait-ms``, ``--queue-depth``, ``--max-inflight``; ragged feeds
on the ``--bucket-multiple`` grid, the batch padded to a power of two
unless ``--no-pad-batch-pow2``). The artifact runs on the device it was
exported on. ``--generation-model`` (a ``save_decoder`` directory, or a
weight-quantized one from ``quantize_decoder_dir``; either package
writes the same forms) serves POST /v1/generate. At least one of the two
is required. The generation engine is the reference's choice: the paged
engine (``PagedDecodeEngine``) when ``--gen-paged``, a draft model or KV
quantization asks for it, the dense ``DecodeEngine`` otherwise. With
``--kv-quant-dtype int8|fp8`` the KV pages are quantized (decode
attention through K3-quant) and the auto-sized pool holds twice the
pages. With ``--gen-megastep-k K`` (K > 1, or 0 for auto; paged engine)
the scheduler decodes up to K tokens per dispatch, each trip a replay of
a captured CUDA graph. ``--gen-draft-model`` serves greedy requests
through speculative rounds over a dense engine on the draft decoder
(``--gen-speculative-k``, 4 when the flag is 0). Requests name their
tenant with the ``X-Tenant-Id`` header and their class with
``"priority"`` in the body; the tenant and SLO flags set the scheduler's
budgets, held lane and control loop.

Disaggregated serving: ``--role prefill`` serves only POST /v1/prefill (a
``PrefillWorker`` over the paged engine, no scheduler): it prefills each
prompt and commits its full KV pages to ``--kv-transfer-dir`` (required),
announcing them to ``--prefix-tier-url`` when given. ``--role decode``
serves /v1/generate and maps those pages instead of recomputing them;
``both`` (the default) is the classic replica, which also maps and
publishes when a store or tier is configured. Both disaggregated roles
imply the paged engine. ``--chaos-spec`` installs a fault-injection spec
(``robustness.chaos``; ``handoff:0=hang30`` freezes the first export
between its payload and its manifest). Knobs left unset come from
``paddle_tpu_torch.flags``. Endpoints: POST /v1/infer, POST
/v1/generate, GET /healthz (its ``serving`` stanza names the
``artifact``, the ``generation_model``, ``paged``, the ``role``,
``kv_quant``, ``weight_quant``, ``megastep_k`` and ``speculative_k``), GET
/metrics, and POST /v1/prefill on a prefill-role server.
SIGINT/SIGTERM drain gracefully: /healthz flips to 503, queued requests
and in-flight generations complete, then the listener stops and the
process exits 0. The decoder's device defaults to ``cuda`` and the
server refuses to start it without a GPU unless ``--device cpu``.
"""

import argparse
import os
import signal
import sys
import threading


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--artifact", default=None,
                    help="export_artifact directory (/v1/infer)")
    ap.add_argument("--generation-model", default=None,
                    help="save_decoder directory (/v1/generate)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8500)
    ap.add_argument("--queue-depth", type=int, default=None,
                    help="admission bound; full queue -> HTTP 503")
    ap.add_argument("--max-batch-size", type=int, default=None,
                    help="micro-batch ceiling (default FLAGS_serving_max_"
                         "batch_size)")
    ap.add_argument("--max-wait-ms", type=float, default=None,
                    help="batching window deadline (default FLAGS_serving_"
                         "max_wait_ms)")
    ap.add_argument("--max-inflight", type=int, default=2,
                    help="windows on the device at once")
    ap.add_argument("--bucket-multiple", type=int, default=None,
                    help="ragged-length padding grid (default FLAGS_"
                         "bucket_multiple)")
    ap.add_argument("--no-pad-batch-pow2", action="store_true",
                    help="run every occupancy instead of the pow2 grid")
    ap.add_argument("--gen-max-slots", type=int, default=None,
                    help="KV-cache slots (default FLAGS_generation_"
                         "max_slots)")
    ap.add_argument("--gen-max-len", type=int, default=None,
                    help="per-slot capacity (default FLAGS_generation_"
                         "max_len)")
    ap.add_argument("--gen-prefill-buckets", default=None,
                    help="comma list of prompt padding lengths")
    ap.add_argument("--gen-paged", action="store_true",
                    help="paged KV cache + prefix reuse instead of dense "
                         "per-slot caches")
    ap.add_argument("--gen-page-size", type=int, default=None,
                    help="tokens per KV page (default FLAGS_kv_page_size)")
    ap.add_argument("--gen-num-pages", type=int, default=None,
                    help="page-pool capacity; 0 = dense-equivalent auto")
    ap.add_argument("--kv-quant-dtype", default=None,
                    choices=("off", "fp8", "int8"),
                    help="quantized KV-page storage (default FLAGS_kv_"
                         "quant_dtype) — implies --gen-paged when not "
                         "'off'")
    ap.add_argument("--kv-quant-group", type=int, default=None,
                    help="tokens per quant scale group within a page (0 = "
                         "whole page; must divide the page size; default "
                         "FLAGS_kv_quant_group)")
    ap.add_argument("--gen-megastep-k", type=int, default=None,
                    help="decode trips per dispatch, replayed from one "
                         "captured trip; 1 = step at a time, 0 = auto "
                         "(default FLAGS_generation_megastep_k)")
    ap.add_argument("--gen-speculative-k", type=int, default=None,
                    help="draft tokens per speculative round; needs "
                         "--gen-draft-model (default FLAGS_speculative_k, "
                         "or 4 when a draft model is given and the flag "
                         "is 0)")
    ap.add_argument("--gen-draft-model", default=None,
                    help="save_decoder directory of the DRAFT model for "
                         "speculative decoding (implies --gen-paged)")
    ap.add_argument("--tenant-token-budget", type=int, default=None,
                    help="default per-tenant decoded-token budget per "
                         "window, 0 = unlimited (default FLAGS_tenant_"
                         "token_budget)")
    ap.add_argument("--tenant-token-budget-map", default=None,
                    help="per-tenant budget overrides as "
                         "'tenant=budget,...' (default FLAGS_tenant_token_"
                         "budget_map)")
    ap.add_argument("--tenant-budget-window-s", type=float, default=None,
                    help="budget accounting window seconds (default "
                         "FLAGS_tenant_budget_window_s)")
    ap.add_argument("--tenant-held-depth", type=int, default=None,
                    help="held-lane capacity: parked admissions + "
                         "preempted requests (default FLAGS_tenant_held_"
                         "depth)")
    ap.add_argument("--slo-ttft-ms", default=None,
                    help="per-class TTFT targets 'high=250,low=2000' for "
                         "the SLO control loop (default FLAGS_slo_ttft_ms; "
                         "empty = loop off)")
    ap.add_argument("--slo-tpot-ms", default=None,
                    help="per-class TPOT targets 'high=50' (default "
                         "FLAGS_slo_tpot_ms)")
    ap.add_argument("--slo-sustain-s", type=float, default=None,
                    help="seconds a high-class SLO violation must persist "
                         "before preemption kicks in (default FLAGS_slo_"
                         "sustain_s)")
    ap.add_argument("--gen-eos-id", type=int, default=None,
                    help="token id that finishes a generation")
    ap.add_argument("--gen-max-new-tokens", type=int, default=64,
                    help="default per-request generation budget")
    ap.add_argument("--role", choices=("both", "decode", "prefill"),
                    default="both",
                    help="disaggregated serving role: 'prefill' serves only "
                         "the /v1/prefill hop (requires --kv-transfer-dir), "
                         "'decode' serves /v1/generate mapping handed-off "
                         "pages, 'both' is the classic replica; both "
                         "disaggregated roles imply --gen-paged")
    ap.add_argument("--kv-transfer-dir", default=None,
                    help="shared KV-page store root for the handoff/tier "
                         "wire form (default FLAGS_kv_transfer_dir; empty "
                         "= handoff off)")
    ap.add_argument("--prefix-tier-url", default=None,
                    help="prefix-tier index service base URL (python -m "
                         "paddle_tpu_torch.serving.prefix_tier; default "
                         "FLAGS_fleet_prefix_tier_url; empty = store-only "
                         "/ local cache)")
    ap.add_argument("--chaos-spec", default="",
                    help="fault-injection spec (robustness.chaos grammar, "
                         "e.g. 'handoff:0=hang30')")
    ap.add_argument("--request-timeout", type=float, default=60.0)
    ap.add_argument("--verbose", action="store_true",
                    help="log each HTTP request")
    args = ap.parse_args(argv)
    if not args.artifact and not args.generation_model:
        ap.error("need --artifact and/or --generation-model")
    if args.role == "prefill" and not args.generation_model:
        ap.error("--role prefill requires --generation-model")

    from .. import flags
    if args.chaos_spec:
        from ..robustness import chaos
        chaos.set_injector(chaos.ChaosInjector(args.chaos_spec))
    from .batcher import MicroBatcher
    from .server import make_server
    from .session import InferenceSession

    batcher = None
    if args.artifact:
        session = InferenceSession.from_artifact(
            args.artifact, bucket_multiple=args.bucket_multiple,
            pad_batch_pow2=not args.no_pad_batch_pow2)
        batcher = MicroBatcher(
            session, max_batch_size=args.max_batch_size,
            max_wait_ms=args.max_wait_ms, queue_depth=args.queue_depth,
            max_inflight=args.max_inflight)

    generator = engine = model = prefill_worker = None
    paged = False
    if args.generation_model:
        from .generation import DecodeEngine, GenerationScheduler, \
            load_decoder
        from .kv_transfer import PrefillWorker, resolve_kv_transfer_knobs
        from .paged_kv import PagedDecodeEngine
        from .prefix_tier import PrefixTierClient
        from .registry import resolve_fleet_knobs
        model, params = load_decoder(args.generation_model,
                                     device=args.device)
        # any paged role can talk to the shared store / tier index; the
        # client degrades to pure-local when neither is configured
        store = resolve_kv_transfer_knobs(
            transfer_dir=args.kv_transfer_dir,
            which=("transfer_dir",))["transfer_dir"]
        tier_url = resolve_fleet_knobs(
            prefix_tier_url=args.prefix_tier_url,
            which=("prefix_tier_url",))["prefix_tier_url"]
        prefix_tier = None
        if store or tier_url:
            prefix_tier = PrefixTierClient(store_root=store,
                                           tier_url=tier_url)
        # the paged engine when paging, a draft, a disaggregated role (pages
        # are the handoff unit) or KV quantization asks for it
        # (quantization is a property of the page pool); the dense engine
        # otherwise
        paged = args.gen_paged or bool(args.gen_draft_model) or \
            args.role in ("prefill", "decode") or \
            (args.kv_quant_dtype or "off") != "off"
        draft_engine = None
        if paged:
            spec_k = args.gen_speculative_k
            if args.gen_draft_model and spec_k is None and \
                    flags.speculative_k == 0:
                spec_k = 4   # a draft model implies speculation
            engine = PagedDecodeEngine(
                model, params, max_slots=args.gen_max_slots,
                max_len=args.gen_max_len,
                prefill_buckets=args.gen_prefill_buckets,
                page_size=args.gen_page_size, num_pages=args.gen_num_pages,
                speculative_k=spec_k, kv_quant_dtype=args.kv_quant_dtype,
                kv_quant_group=args.kv_quant_group,
                megastep_k=args.gen_megastep_k, prefix_tier=prefix_tier,
                device=args.device)
            if args.gen_draft_model:
                draft_model, draft_params = load_decoder(
                    args.gen_draft_model, device=args.device)
                draft_engine = DecodeEngine(
                    draft_model, draft_params, max_slots=engine.max_slots,
                    max_len=engine.max_len,
                    prefill_buckets=engine.prefill_buckets,
                    device=args.device)
        else:
            engine = DecodeEngine(model, params,
                                  max_slots=args.gen_max_slots,
                                  max_len=args.gen_max_len,
                                  prefill_buckets=args.gen_prefill_buckets,
                                  device=args.device)
        if args.role == "prefill":
            # no scheduler: the engine serves only /v1/prefill, exporting
            # pages for decode replicas to map
            prefill_worker = PrefillWorker(engine, prefix_tier,
                                           eos_id=args.gen_eos_id)
        else:
            generator = GenerationScheduler(
                engine, eos_id=args.gen_eos_id,
                queue_depth=args.queue_depth,
                default_max_new_tokens=args.gen_max_new_tokens,
                draft_engine=draft_engine,
                tenant_token_budget=args.tenant_token_budget,
                tenant_token_budget_map=args.tenant_token_budget_map,
                tenant_budget_window_s=args.tenant_budget_window_s,
                tenant_held_depth=args.tenant_held_depth,
                slo_ttft_ms=args.slo_ttft_ms, slo_tpot_ms=args.slo_tpot_ms,
                slo_sustain_s=args.slo_sustain_s)
    server = make_server(batcher, generator=generator,
                         prefill_worker=prefill_worker, host=args.host,
                         port=args.port,
                         request_timeout=args.request_timeout,
                         verbose=args.verbose)
    server.version_info = {"pid": os.getpid(), "artifact": args.artifact,
                           "generation_model": args.generation_model,
                           "paged": paged, "role": args.role}
    if engine is not None:
        server.version_info.update({
            "kv_quant": getattr(engine, "kv_quant_dtype", "off"),
            "weight_quant": model.weight_quant or "off",
            "megastep_k": getattr(engine, "megastep_k", 1),
            "speculative_k": getattr(engine, "speculative_k", 0),
            "draft_model": args.gen_draft_model})

    def _drain(signum, frame):
        print("serve: draining...", file=sys.stderr)

        def _shutdown():
            # shutdown() must not run on the serve_forever thread
            status = server.shutdown_gracefully(30.0)
            if not status["drained"]:
                print("serve: drain timed out, residue: %s"
                      % status["residue"], file=sys.stderr)

        threading.Thread(target=_shutdown, daemon=True).start()

    signal.signal(signal.SIGINT, _drain)
    signal.signal(signal.SIGTERM, _drain)
    host, port = server.server_address[:2]
    parts = []
    if batcher is not None:
        parts.append("infer: %s feeds=%s fetches=%s max_batch=%d "
                     "wait=%.1fms depth=%d device=%s"
                     % (args.artifact,
                        [s["name"] for s in session.feed_specs],
                        session.fetch_names, batcher.max_batch_size,
                        batcher.max_wait_s * 1e3, batcher._q.maxsize,
                        session._artifact.device))
    if engine is not None:
        pages = "paged(page=%d pages=%d kv_quant=%s)" % (
            engine.page_size, engine.num_pages, engine.kv_quant_dtype) \
            if paged else "dense"
        parts.append(
            "%s: %s role=%s device=%s slots=%d max_len=%d buckets=%s %s "
            "weight_quant=%s megastep_k=%d speculative_k=%d draft=%s "
            "kv_transfer_dir=%s prefix_tier=%s"
            % ("generate" if generator is not None else "prefill",
               args.generation_model, args.role, engine.device,
               engine.max_slots, engine.max_len,
               list(engine.prefill_buckets), pages,
               model.weight_quant or "off",
               server.version_info["megastep_k"],
               server.version_info["speculative_k"], args.gen_draft_model,
               prefix_tier.store_root if prefix_tier else "",
               prefix_tier.tier_url if prefix_tier else ""))
    print("serve: http://%s:%d  %s" % (host, port, "; ".join(parts)),
          file=sys.stderr)
    try:
        server.serve_forever()
    finally:
        print("serve: stopped", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
