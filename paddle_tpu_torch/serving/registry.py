"""The request-ingest helpers and the fleet knobs of
``paddle_tpu/serving/registry.py``: the ``X-Deadline-Ms`` and
``X-Tenant-Id`` header parsers and :func:`resolve_fleet_knobs` over the
deadline, brownout-shedding, prefix-tier and prefill-hop flags. The
replica registry and its leases (fleet HA) are not ported."""

import math
import re

__all__ = ["parse_deadline_header", "parse_tenant_header",
           "resolve_fleet_knobs"]

# Same id alphabet the trace ids use: a tenant id rides logs, span args
# and status surfaces, so it must be shell- and JSON-inert.
_TENANT_ID_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")


def parse_deadline_header(raw):
    """``X-Deadline-Ms`` value → remaining-budget milliseconds (>= 0), or
    None when absent, malformed or non-finite (a broken client gets
    service, not a parse error)."""
    if raw is None:
        return None
    try:
        v = float(raw)
    except (TypeError, ValueError):
        return None
    if not math.isfinite(v):
        return None
    return max(0.0, v)


def parse_tenant_header(raw):
    """``X-Tenant-Id`` value → validated tenant id string, or None when
    absent or malformed (a broken client gets service as the anonymous
    tenant, not a parse error)."""
    if raw is None:
        return None
    if not isinstance(raw, str) or not _TENANT_ID_RE.match(raw):
        return None
    return raw


def resolve_fleet_knobs(deadline_default_ms=None, deadline_admit_min_ms=None,
                        shed_high_watermark=None, shed_low_watermark=None,
                        shed_token_cap=None, shed_retry_floor_s=None,
                        shed_retry_cap_s=None, prefix_tier_url=None,
                        prefix_tier_timeout_s=None,
                        prefix_tier_capacity_mb=None,
                        prefill_min_prompt=None, which=None):
    """Resolve the deadline, brownout and prefix-tier knobs from explicit
    values or their ``FLAGS_deadline_*`` / ``FLAGS_shed_*`` /
    ``FLAGS_fleet_prefix_tier_*`` defaults, validating each (errors name
    the flag when the value came from the flag, the argument otherwise).
    Returns a dict of the requested knobs:

    ``deadline_default_ms`` (0 = requests carry no implicit deadline),
    ``deadline_admit_min_ms`` (admission requires at least this much
    budget left), ``shed_high_watermark`` / ``shed_low_watermark`` (the
    brownout hysteresis band over queue/page pressure, low < high),
    ``shed_token_cap`` (level-2 clamp on new admissions'
    max_new_tokens), ``shed_retry_floor_s`` / ``shed_retry_cap_s``
    (clamp on the drain-rate-derived Retry-After),
    ``prefix_tier_url`` (str, "" = no fleet prefix tier),
    ``prefix_tier_timeout_s`` / ``prefix_tier_capacity_mb`` (tier call
    timeout and store eviction watermark), ``prefill_min_prompt`` (the
    router's prefill-hop prompt-length gate).

    ``which`` (a tuple of knob names, None = all) scopes both the result
    and the validation."""
    from .. import flags

    def _num(value, flag, lo, cast=float, hi=None):
        explicit = value is not None
        label = flag if explicit else "FLAGS_" + flag
        if not explicit:
            value = getattr(flags, flag)
        try:
            v = cast(value)
        except (TypeError, ValueError, OverflowError):
            raise ValueError(
                "%s must be a number (got %r)" % (label, value)) from None
        if not math.isfinite(v):
            raise ValueError("%s must be a finite number (got %r)"
                             % (label, value))
        if v < lo or (hi is not None and v > hi):
            raise ValueError(
                "%s must be %s (got %s)"
                % (label, (">= %s" % lo) if hi is None else
                   ("in [%s, %s]" % (lo, hi)), v))
        return v

    resolvers = {
        "deadline_default_ms": lambda: _num(
            deadline_default_ms, "deadline_default_ms", 0.0),
        "deadline_admit_min_ms": lambda: _num(
            deadline_admit_min_ms, "deadline_admit_min_ms", 0.0),
        "shed_high_watermark": lambda: _num(
            shed_high_watermark, "shed_high_watermark", 0.0, hi=1.0),
        "shed_low_watermark": lambda: _num(
            shed_low_watermark, "shed_low_watermark", 0.0, hi=1.0),
        "shed_token_cap": lambda: _num(
            shed_token_cap, "shed_token_cap", 1, int),
        "shed_retry_floor_s": lambda: _num(
            shed_retry_floor_s, "shed_retry_floor_s", 0.0),
        "shed_retry_cap_s": lambda: _num(
            shed_retry_cap_s, "shed_retry_cap_s", 0.0),
        "prefix_tier_timeout_s": lambda: _num(
            prefix_tier_timeout_s, "fleet_prefix_tier_timeout_s", 0.05),
        "prefix_tier_capacity_mb": lambda: _num(
            prefix_tier_capacity_mb, "fleet_prefix_tier_capacity_mb",
            0.001),
        "prefill_min_prompt": lambda: _num(
            prefill_min_prompt, "fleet_prefill_min_prompt", 0, int),
    }
    _strings = ("prefix_tier_url",)
    wanted = tuple(resolvers) + _strings if which is None \
        else tuple(which)
    unknown = [k for k in wanted
               if k not in resolvers and k not in _strings]
    if unknown:
        raise ValueError("unknown fleet knob(s) %r" % (unknown,))
    knobs = {}
    if "prefix_tier_url" in wanted:
        if prefix_tier_url is None:
            prefix_tier_url = flags.fleet_prefix_tier_url
        if prefix_tier_url is not None and \
                not isinstance(prefix_tier_url, str):
            raise ValueError(
                "FLAGS_fleet_prefix_tier_url must be a URL string "
                "(got %r)" % (prefix_tier_url,))
        knobs["prefix_tier_url"] = prefix_tier_url or ""
    for name in wanted:
        if name in resolvers:
            knobs[name] = resolvers[name]()
    if "shed_low_watermark" in knobs and \
            "shed_high_watermark" in knobs and \
            knobs["shed_low_watermark"] >= knobs["shed_high_watermark"]:
        raise ValueError(
            "FLAGS_shed_low_watermark=%g must be < FLAGS_shed_high_"
            "watermark=%g (the hysteresis band would be empty or "
            "inverted)" % (knobs["shed_low_watermark"],
                           knobs["shed_high_watermark"]))
    if "shed_retry_floor_s" in knobs and "shed_retry_cap_s" in knobs \
            and knobs["shed_retry_floor_s"] > knobs["shed_retry_cap_s"]:
        raise ValueError(
            "FLAGS_shed_retry_floor_s=%g must be <= FLAGS_shed_retry_"
            "cap_s=%g" % (knobs["shed_retry_floor_s"],
                          knobs["shed_retry_cap_s"]))
    return knobs
