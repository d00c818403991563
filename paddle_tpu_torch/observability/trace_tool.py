"""Fetch or merge distributed request traces — the port of the reference's
``tools/trace.py``.

    # one request's journey across the fleet, from the router's
    # aggregation endpoint (rings and span spool merged there)
    python -m paddle_tpu_torch.observability.trace_tool \\
        --router http://127.0.0.1:8600 --request-id 6f2c1a... -o trace.json

    # offline: merge a span-spool directory and/or ring dumps into one
    # chrome-trace — works after every process is gone
    python -m paddle_tpu_torch.observability.trace_tool \\
        --spool-dir /tmp/paddle_tpu_torch_fleet/trace --request-id 6f2c1a...
    python -m paddle_tpu_torch.observability.trace_tool \\
        --ring dump_a.json dump_b.json -o merged.json   # no filter: laned

Open the output at chrome://tracing or ui.perfetto.dev: one lane per
process. Without ``--request-id``/``--trace-id`` every span is kept; with
one, only that request's journey. The handoff family of spans
(``handoff.*``, ``kv.transfer*``, ``prefix_tier.*``) gets fixed colors.

Exit status: 0 with spans written; 1 when nothing matched or the router
answered with an error.
"""

import argparse
import json
import os
import sys
import urllib.error
import urllib.request

from . import tracing

__all__ = ["label_handoff_spans", "main"]

_HANDOFF_COLORS = (
    ("handoff.", "yellow"),
    ("kv.transfer", "olive"),
    ("prefix_tier.", "grey"),
)


def label_handoff_spans(doc):
    """Give handoff-family spans a ``cname`` color; returns {prefix: count}
    of the spans labelled."""
    counts = {}
    for ev in doc.get("traceEvents", []):
        name = ev.get("name", "")
        for prefix, cname in _HANDOFF_COLORS:
            if name.startswith(prefix):
                ev.setdefault("cname", cname)
                counts[prefix] = counts.get(prefix, 0) + 1
                break
    return counts


def _fetch_router(base, request_id, trace_id, timeout):
    qs = []
    if request_id:
        qs.append("request_id=%s" % request_id)
    if trace_id:
        qs.append("trace_id=%s" % trace_id)
    url = "%s/fleet/trace?%s" % (base.rstrip("/"), "&".join(qs))
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return json.loads(r.read()), None
    except urllib.error.HTTPError as e:
        try:
            msg = json.loads(e.read()).get("error", str(e))
        except ValueError:
            msg = str(e)
        return None, "router answered HTTP %d: %s" % (e.code, msg)
    except (urllib.error.URLError, OSError) as e:
        return None, "router unreachable at %s: %s" % (base, e)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.observability.trace_tool",
        description="Fetch / merge distributed request traces.")
    ap.add_argument("--router",
                    help="fleet router base URL: fetch the merged trace "
                         "from /fleet/trace")
    ap.add_argument("--spool-dir",
                    help="span-spool directory to merge offline "
                         "(spans_<pid>.jsonl files)")
    ap.add_argument("--ring", nargs="*", default=[], metavar="DUMP.json",
                    help="ring dumps (GET /trace answers) to merge offline")
    ap.add_argument("--request-id", help="filter to one request id")
    ap.add_argument("--trace-id", help="filter to one trace id")
    ap.add_argument("--timeout", type=float, default=10.0)
    ap.add_argument("-o", "--output", default=None,
                    help="write the chrome-trace here (default stdout)")
    args = ap.parse_args(argv)
    if not args.router and not args.spool_dir and not args.ring:
        ap.error("need --router, --spool-dir, and/or --ring")
    if args.router and not (args.request_id or args.trace_id):
        ap.error("--router needs --request-id (or --trace-id)")

    if args.router:
        doc, err = _fetch_router(args.router, args.request_id,
                                 args.trace_id, args.timeout)
        if doc is None:
            print("trace: %s" % err, file=sys.stderr)
            return 1
    else:
        sources = []
        if args.spool_dir:
            sources.append(("spool", tracing.read_spool(args.spool_dir)))
        for path in args.ring:
            with open(path) as f:
                dump = json.load(f)
            events = dump.get("traceEvents", dump) \
                if isinstance(dump, dict) else dump
            sources.append((os.path.basename(path), events))
        doc = tracing.merge_traces(sources, request_id=args.request_id,
                                   trace_id=args.trace_id)

    n = doc.get("metadata", {}).get("span_count",
                                    len(doc.get("traceEvents", [])))
    if not n:
        print("trace: no spans matched (request_id=%s trace_id=%s)"
              % (args.request_id, args.trace_id), file=sys.stderr)
        return 1
    handoff = label_handoff_spans(doc)
    if handoff:
        print("trace: handoff spans: %s"
              % ", ".join("%s*=%d" % kv for kv in sorted(handoff.items())),
              file=sys.stderr)
    out = json.dumps(doc)
    if args.output:
        with open(args.output, "w") as f:
            f.write(out)
        print("trace: %d spans, trace_ids=%s -> %s"
              % (n, doc.get("metadata", {}).get("trace_ids"), args.output),
              file=sys.stderr)
    else:
        print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
