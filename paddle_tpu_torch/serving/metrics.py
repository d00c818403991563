"""Prometheus text exposition of the port's metrics — the renderer of
``paddle_tpu/observability/prometheus.py`` behind the reference's
``serving.metrics.render_prometheus``: every profiler counter and
histogram (catalogued names with ``# HELP`` / ``# TYPE``, labels decoded
from the storage key) plus caller-supplied live gauges, under the
``paddle_tpu_`` prefix so one scrape config reads either package."""

from .. import profiler
from ..observability import catalog, tracing

__all__ = ["render_prometheus", "PREFIX"]

PREFIX = "paddle_tpu_"
_QUANTILES = (50.0, 95.0, 99.0)


def _sanitize(name):
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)


def _escape_label(value):
    return value.replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n")


def _label_str(labels):
    if not labels:
        return ""
    return "{%s}" % ",".join(
        '%s="%s"' % (_sanitize(k), _escape_label(str(v)))
        for k, v in sorted(labels.items()))


def render_prometheus(gauges=None):
    """Render all profiler counters + histograms (plus live ``gauges``:
    name → number) as Prometheus exposition text."""
    lines = []
    groups = {}
    for key, value in profiler.get_counters().items():
        base, labels = catalog.parse_storage_key(key)
        m = catalog.resolve(key)
        if m is not None:
            base = m.name       # a legacy storage key renders canonically
            help_, kind = m.help, m.kind
        else:
            help_ = ""
            kind = "counter" if base.endswith("_total") else "gauge"
        groups.setdefault(base, (help_, kind, []))[2].append((labels, value))
    for base, (help_, kind, samples) in sorted(groups.items()):
        metric = PREFIX + _sanitize(base)
        if help_:
            lines.append("# HELP %s %s" % (metric, help_))
        lines.append("# TYPE %s %s" % (metric, kind))
        for labels, value in sorted(samples,
                                    key=lambda s: sorted(s[0].items())):
            lines.append("%s%s %.9g" % (metric, _label_str(labels), value))
        if base == "requests_finished_total":
            # exemplars ride as comments: ids stay off the labels
            for (path, outcome), (tid, rid) in sorted(
                    tracing.exemplars().items()):
                lines.append(
                    '# EXEMPLAR %s{outcome="%s",path="%s"} trace_id=%s '
                    'request_id=%s' % (metric, _escape_label(outcome),
                                       _escape_label(path), tid, rid))
    live = catalog.live_gauges()
    for name, value in sorted((gauges or {}).items()):
        metric = PREFIX + _sanitize(name)
        if live.get(name):
            lines.append("# HELP %s %s" % (metric, live[name]))
        lines.append("# TYPE %s gauge" % metric)
        lines.append("%s %.9g" % (metric, float(value)))
    for name, vals in sorted(profiler.get_histograms().items()):
        base, labels = catalog.parse_storage_key(name)
        m = catalog.resolve(name)
        metric = PREFIX + _sanitize(m.name if m is not None else base)
        if m is not None and m.help:
            lines.append("# HELP %s %s" % (metric, m.help))
        lines.append("# TYPE %s summary" % metric)
        pcts = profiler.histogram_percentiles(name, _QUANTILES)
        for p in _QUANTILES:
            if p not in pcts:
                break
            q = dict(labels)
            q["quantile"] = "%.3g" % (p / 100.0)
            lines.append("%s%s %.9g" % (metric, _label_str(q), pcts[p]))
        lines.append("%s_sum%s %.9g" % (metric, _label_str(labels),
                                        float(sum(vals))))
        lines.append("%s_count%s %d" % (metric, _label_str(labels),
                                        len(vals)))
    return "\n".join(lines) + "\n"
