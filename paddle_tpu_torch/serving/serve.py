"""Serve a saved decoder over HTTP with the port's paged engine — the
``--gen-paged`` branch of the reference's ``tools/serve.py``:

    python -m paddle_tpu_torch.serving.serve --generation-model DIR \
        [--device cuda] [--host 127.0.0.1] [--port 8500] \
        [--gen-max-slots 32] [--gen-max-len 1024] \
        [--gen-prefill-buckets 64,128,256,512] [--gen-page-size 16] \
        [--gen-num-pages 0] [--gen-eos-id ID] [--queue-depth N] \
        [--kv-quant-dtype off|int8|fp8] [--kv-quant-group N] \
        [--gen-megastep-k K]

``DIR`` is a ``save_decoder`` directory, or a weight-quantized one from
``quantize_decoder_dir`` (either package writes the same forms). With
``--kv-quant-dtype int8|fp8`` the KV pages are quantized (decode
attention through K3-quant) and the auto-sized pool holds twice the
pages. With ``--gen-megastep-k K`` (K > 1, or 0 for auto) the scheduler
decodes up to K tokens per dispatch, each trip a replay of a captured
CUDA graph. Knobs left unset come from ``paddle_tpu_torch.flags``.
Endpoints: POST /v1/generate, GET /healthz (its ``serving`` stanza names
``kv_quant``, ``weight_quant`` and ``megastep_k``), GET /metrics.
SIGINT/SIGTERM drain gracefully: /healthz flips to 503, queued and
in-flight generations complete, then the listener stops. The device
defaults to ``cuda`` and the server refuses to start without a GPU
unless ``--device cpu``.
"""

import argparse
import signal
import sys
import threading


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--generation-model", required=True,
                    help="save_decoder directory (/v1/generate)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8500)
    ap.add_argument("--queue-depth", type=int, default=None,
                    help="admission bound; full queue -> HTTP 503")
    ap.add_argument("--gen-max-slots", type=int, default=None,
                    help="KV-cache slots (default FLAGS_generation_"
                         "max_slots)")
    ap.add_argument("--gen-max-len", type=int, default=None,
                    help="per-slot capacity (default FLAGS_generation_"
                         "max_len)")
    ap.add_argument("--gen-prefill-buckets", default=None,
                    help="comma list of prompt padding lengths")
    ap.add_argument("--gen-page-size", type=int, default=None,
                    help="tokens per KV page (default FLAGS_kv_page_size)")
    ap.add_argument("--gen-num-pages", type=int, default=None,
                    help="page-pool capacity; 0 = dense-equivalent auto")
    ap.add_argument("--kv-quant-dtype", default=None,
                    choices=("off", "fp8", "int8"),
                    help="quantized KV-page storage (default FLAGS_kv_"
                         "quant_dtype)")
    ap.add_argument("--kv-quant-group", type=int, default=None,
                    help="tokens per quant scale group within a page (0 = "
                         "whole page; must divide the page size; default "
                         "FLAGS_kv_quant_group)")
    ap.add_argument("--gen-megastep-k", type=int, default=None,
                    help="decode trips per dispatch, replayed from one "
                         "captured trip; 1 = step at a time, 0 = auto "
                         "(default FLAGS_generation_megastep_k)")
    ap.add_argument("--gen-eos-id", type=int, default=None,
                    help="token id that finishes a generation")
    ap.add_argument("--gen-max-new-tokens", type=int, default=64,
                    help="default per-request generation budget")
    ap.add_argument("--request-timeout", type=float, default=60.0)
    ap.add_argument("--verbose", action="store_true",
                    help="log each HTTP request")
    args = ap.parse_args(argv)

    from .generation import GenerationScheduler, load_decoder
    from .paged_kv import PagedDecodeEngine
    from .server import make_server

    model, params = load_decoder(args.generation_model, device=args.device)
    engine = PagedDecodeEngine(
        model, params, max_slots=args.gen_max_slots,
        max_len=args.gen_max_len, prefill_buckets=args.gen_prefill_buckets,
        page_size=args.gen_page_size, num_pages=args.gen_num_pages,
        kv_quant_dtype=args.kv_quant_dtype,
        kv_quant_group=args.kv_quant_group,
        megastep_k=args.gen_megastep_k, device=args.device)
    generator = GenerationScheduler(
        engine, eos_id=args.gen_eos_id, queue_depth=args.queue_depth,
        default_max_new_tokens=args.gen_max_new_tokens)
    server = make_server(generator, host=args.host, port=args.port,
                         request_timeout=args.request_timeout,
                         verbose=args.verbose)
    server.version_info = {
        "generation_model": args.generation_model, "paged": True,
        "kv_quant": engine.kv_quant_dtype,
        "weight_quant": model.weight_quant or "off",
        "megastep_k": engine.megastep_k}

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
    print("serve: http://%s:%d  generate: %s device=%s slots=%d max_len=%d "
          "buckets=%s paged(page=%d pages=%d kv_quant=%s) weight_quant=%s "
          "megastep_k=%d"
          % (host, port, args.generation_model, engine.device,
             engine.max_slots, engine.max_len, list(engine.prefill_buckets),
             engine.page_size, engine.num_pages, engine.kv_quant_dtype,
             model.weight_quant or "off", engine.megastep_k),
          file=sys.stderr)
    try:
        server.serve_forever()
    finally:
        print("serve: stopped", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
