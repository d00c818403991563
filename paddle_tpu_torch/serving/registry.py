"""Fleet control-plane state on shared disk — the replica registry and
the supervisor lease (fleet HA) — and the request-ingest helpers and
fleet knobs; the port of ``paddle_tpu/serving/registry.py``.

One router and one supervisor, each holding the replica membership in
process memory, make the supervisor a single point of failure for a fleet
whose replicas are healthy. The reference's answer, an etcd-lease-style
fault-tolerant master, is re-expressed here over a shared POSIX
directory: every record is committed by write-tmp → fsync → atomic rename
and carries an md5 of its payload, so a torn record is INVISIBLE to
readers rather than garbage; liveness is a heartbeat timestamp, so a dead
writer's records go stale instead of lying forever. The on-disk form is
the reference's byte for byte: a record or lease written by either package
is read by the other.

Two cooperating pieces:

* :class:`ReplicaRegistry` — one JSON record per replica slot
  (url/pid/serial/state/failures/backoff gate/role), written by the ACTIVE
  supervisor, read by any number of routers (membership) and by a standby
  supervisor (adoption). Records carry an ``incarnation`` nonce: a
  supervisor that lost the lease keeps the nonce of the records it wrote,
  and its late heartbeats are rejected with
  :class:`StaleIncarnationError` once the new owner re-published them.
* :class:`Lease` — a single holder file with a wall-clock expiry, renewed
  by the active supervisor every sweep. A standby acquires it only after
  expiry, by atomic replace + settle + re-read (last writer wins; the
  re-read decides). Losing a renewal race is an explicit ``False`` — the
  demoted supervisor must stop shaping the fleet.

The module is stdlib-only (json/os/hashlib): routers and standby
supervisors watch the control plane without importing torch.
"""

import hashlib
import json
import math
import os
import re
import socket
import threading
import time
import uuid

__all__ = ["ReplicaRegistry", "Lease", "StaleIncarnationError",
           "parse_deadline_header", "parse_tenant_header",
           "resolve_fleet_knobs", "default_holder"]

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


class StaleIncarnationError(RuntimeError):
    """A heartbeat/withdraw named an incarnation nonce that no longer
    owns the record — the writer lost the lease (or the record) to a
    newer supervisor and must stop treating the replica as its own."""


def resolve_fleet_knobs(registry_dir=None, lease_secs=None,
                        deadline_default_ms=None, deadline_admit_min_ms=None,
                        shed_high_watermark=None, shed_low_watermark=None,
                        shed_token_cap=None, shed_retry_floor_s=None,
                        shed_retry_cap_s=None, prefix_tier_url=None,
                        prefix_tier_timeout_s=None,
                        prefix_tier_capacity_mb=None,
                        prefill_min_prompt=None, which=None):
    """Resolve the fleet-HA, deadline, brownout and prefix-tier knobs from
    explicit values or their ``FLAGS_fleet_*`` / ``FLAGS_deadline_*`` /
    ``FLAGS_shed_*`` defaults, validating each (errors name the flag when
    the value came from the flag, the argument otherwise). Returns a dict
    of the requested knobs:

    ``registry_dir`` (str, "" = no shared registry), ``lease_secs``,
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
    and the validation: a bad supervisor-only flag (say an inverted
    lease) must not fail a router or a replica that does not read it."""
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
        "lease_secs": lambda: _num(lease_secs, "fleet_lease_secs", 0.1),
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
    _strings = ("registry_dir", "prefix_tier_url")
    wanted = tuple(resolvers) + _strings if which is None \
        else tuple(which)
    unknown = [k for k in wanted
               if k not in resolvers and k not in _strings]
    if unknown:
        raise ValueError("unknown fleet knob(s) %r" % (unknown,))
    knobs = {}
    if "registry_dir" in wanted:
        if registry_dir is None:
            registry_dir = flags.fleet_registry_dir
        if registry_dir is not None and \
                not isinstance(registry_dir, str):
            raise ValueError(
                "FLAGS_fleet_registry_dir must be a directory path "
                "string (got %r)" % (registry_dir,))
        knobs["registry_dir"] = registry_dir or ""
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


# ---------------------------------------------------------------------------
# crash-consistent single-record files
# ---------------------------------------------------------------------------

def _payload_md5(payload):
    return hashlib.md5(
        json.dumps(payload, sort_keys=True).encode("utf-8")).hexdigest()


def _write_record(path, payload):
    """Commit one JSON record durably and atomically: payload + md5 to
    a tmp file, fsync, rename into place (the checkpoint manifest's
    commit order, scaled down to one record). A crash at any
    point leaves either the previous record or a tmp file nobody
    reads — never a half-written visible record."""
    doc = {"payload": payload, "md5": _payload_md5(payload)}
    # pid alone is not unique enough: two Lease/registry objects in one
    # process (a settle race, a test's active+standby pair) would share
    # the tmp path and one writer's rename would steal the other's file
    tmp = "%s.tmp.%d.%s" % (path, os.getpid(), uuid.uuid4().hex[:8])
    with open(tmp, "w") as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _read_record(path):
    """Read one committed record; None when absent, TORN (json error —
    e.g. a truncated write that bypassed the tmp protocol) or
    md5-mismatched — torn records are invisible, exactly like a
    manifest-less checkpoint serial."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    payload = doc.get("payload") if isinstance(doc, dict) else None
    if payload is None or doc.get("md5") != _payload_md5(payload):
        return None
    return payload


def _new_nonce():
    return uuid.uuid4().hex[:16]


def default_holder():
    """Stable-ish identity for lease/record writers: host:pid."""
    return "%s:%d" % (socket.gethostname(), os.getpid())


# ---------------------------------------------------------------------------
# Replica registry
# ---------------------------------------------------------------------------

class ReplicaRegistry:
    """Shared on-disk replica membership: ``<root>/replicas/slot_N.json``
    records written by the active supervisor, readable by any process.

    Record payload fields: ``slot`` (int, the logical metric-label
    slot), ``url``, ``pid``, ``serial`` (artifact serial or None),
    ``state`` (``ready`` | ``backoff`` | ``retiring``), ``failures``
    (consecutive crash count — survives adoption), ``not_before_unix``
    (wall-clock respawn gate for ``backoff`` records), ``incarnation``
    (owner nonce), ``holder`` (owner identity), ``heartbeat_unix``.

    All mutators are read-modify-write under a process-local lock (the
    supervisor's watch thread and shape mutations both write); cross-
    process safety rests on atomic-rename last-writer-wins plus the
    incarnation guard: :meth:`heartbeat` and :meth:`withdraw` refuse to
    touch a record whose nonce is no longer the caller's."""

    def __init__(self, root, ttl_s=10.0, clock=time.time,
                 holder=None):
        self.root = root
        self.replica_dir = os.path.join(root, "replicas")
        self.ttl_s = float(ttl_s)
        self._clock = clock
        self.holder = holder or default_holder()
        self._lock = threading.Lock()
        os.makedirs(self.replica_dir, exist_ok=True)

    def lease_path(self):
        """The conventional supervisor-lease location under this
        registry root (routers read it for /fleet/status)."""
        return os.path.join(self.root, "supervisor.lease")

    def _path(self, slot):
        return os.path.join(self.replica_dir, "slot_%d.json" % int(slot))

    # -- writers (active supervisor) ----------------------------------
    def publish(self, slot, url, *, pid=None, serial=None, state="ready",
                failures=0, not_before_unix=0.0, incarnation=None,
                role="both"):
        """(Re)claim ``slot`` with a fresh record. A new ``incarnation``
        nonce is minted unless the caller passes one (adoption re-
        publishes preserved records under ITS nonce so the previous
        owner's late heartbeats are rejected). ``role`` names the
        process's serving role (``both`` | ``decode`` | ``prefill`` |
        ``cache``); routers use it to
        filter rotation membership and to discover the prefix tier.
        Returns the nonce."""
        if role not in ("both", "decode", "prefill", "cache"):
            raise ValueError("role must be both|decode|prefill|cache "
                             "(got %r)" % (role,))
        nonce = incarnation or _new_nonce()
        payload = {"slot": int(slot), "url": url, "pid": pid,
                   "serial": serial, "state": state,
                   "failures": int(failures),
                   "not_before_unix": float(not_before_unix),
                   "incarnation": nonce, "holder": self.holder,
                   "role": role,
                   "heartbeat_unix": float(self._clock())}
        with self._lock:
            _write_record(self._path(slot), payload)
        return nonce

    def heartbeat(self, slot, incarnation, state=None, failures=None,
                  not_before_unix=None, serial=None):
        """Refresh a record's heartbeat (and optionally its mutable
        fields). Raises :class:`StaleIncarnationError` when the record
        is gone, torn, or owned by a different incarnation — the signal
        that another supervisor took this replica over."""
        with self._lock:
            rec = _read_record(self._path(slot))
            if rec is None or rec.get("incarnation") != incarnation:
                raise StaleIncarnationError(
                    "slot %d is %s — this supervisor's incarnation %r "
                    "no longer owns it" %
                    (slot, "owned by incarnation %r (holder %r)"
                     % (rec.get("incarnation"), rec.get("holder"))
                     if rec else "gone or torn", incarnation))
            rec["heartbeat_unix"] = float(self._clock())
            if state is not None:
                rec["state"] = state
            if failures is not None:
                rec["failures"] = int(failures)
            if not_before_unix is not None:
                rec["not_before_unix"] = float(not_before_unix)
            if serial is not None:
                rec["serial"] = serial
            _write_record(self._path(slot), rec)
        return rec

    def withdraw(self, slot, incarnation=None):
        """Remove a slot's record (replica retired/removed). With an
        ``incarnation``, refuses to withdraw a record another owner has
        since re-published (raises :class:`StaleIncarnationError`)."""
        with self._lock:
            rec = _read_record(self._path(slot))
            if rec is None:
                return
            if incarnation is not None and \
                    rec.get("incarnation") != incarnation:
                raise StaleIncarnationError(
                    "slot %d 's record is owned by incarnation %r, not "
                    "%r — not withdrawing it" %
                    (slot, rec.get("incarnation"), incarnation))
            try:
                os.unlink(self._path(slot))
            except OSError:
                pass

    # -- readers (routers, standby supervisors) -----------------------
    def read(self, slot):
        return _read_record(self._path(slot))

    def records(self, live_only=False):
        """Every committed record, sorted by slot; torn records are
        skipped. ``live_only`` additionally filters out records whose
        heartbeat is older than ``ttl_s`` (a dead supervisor's records
        go stale, they do not lie)."""
        out = []
        now = self._clock()
        try:
            names = sorted(os.listdir(self.replica_dir))
        except OSError:
            return out
        for fn in names:
            if not fn.startswith("slot_") or not fn.endswith(".json"):
                continue
            rec = _read_record(os.path.join(self.replica_dir, fn))
            if rec is None:
                continue
            if live_only and \
                    now - rec.get("heartbeat_unix", 0.0) > self.ttl_s:
                continue
            out.append(rec)
        out.sort(key=lambda r: r.get("slot", 0))
        return out

    def age_s(self):
        """Seconds since the NEWEST record heartbeat (None when the
        registry holds no committed records) — the /fleet/status
        freshness indicator: a growing age means no supervisor is
        heartbeating the membership."""
        recs = self.records()
        if not recs:
            return None
        newest = max(r.get("heartbeat_unix", 0.0) for r in recs)
        return max(0.0, self._clock() - newest)

    def describe(self):
        """Registry summary for status endpoints: record payloads (with
        per-record heartbeat age and, for backoff records, time until
        the respawn gate opens) + overall age — computed from the ONE
        record scan (``age_s()`` would re-read and re-verify every
        record)."""
        now = self._clock()
        records, newest = [], None
        for rec in self.records():
            doc = dict(rec)
            hb = rec.get("heartbeat_unix", 0.0)
            newest = hb if newest is None else max(newest, hb)
            doc["age_s"] = round(max(0.0, now - hb), 3)
            if rec.get("state") == "backoff":
                doc["not_before_in_s"] = round(
                    max(0.0, rec.get("not_before_unix", 0.0) - now), 3)
            records.append(doc)
        return {"root": self.root,
                "age_s": None if newest is None else
                max(0.0, now - newest),
                "records": records}


# ---------------------------------------------------------------------------
# Supervisor lease
# ---------------------------------------------------------------------------

class Lease:
    """A single-holder lease file with wall-clock expiry — the
    fault-tolerant-master election primitive (the etcd lease of the
    reference's design, over a shared POSIX dir).

    The ACTIVE holder calls :meth:`renew` every supervision sweep; a
    STANDBY polls :meth:`try_acquire`, which succeeds only when the
    lease is absent, expired, or already ours. Acquisition is atomic
    replace + settle + re-read: concurrent acquirers both write, the
    last writer's nonce survives, and the re-read tells each contender
    truthfully whether it won. ``renew`` returning False means the
    lease was lost (expired AND taken) — the caller must demote
    itself before mutating any shared state again."""

    def __init__(self, path, lease_secs=None, holder=None,
                 clock=time.time, settle_s=0.05):
        knobs = resolve_fleet_knobs(lease_secs=lease_secs,
                                    which=("lease_secs",))
        self.path = path
        self.lease_secs = knobs["lease_secs"]
        self.holder = holder or default_holder()
        self._clock = clock
        self.settle_s = float(settle_s)
        self._lock = threading.Lock()
        self._nonce = None          # guarded-by: _lock

    @classmethod
    def reader(cls, path, clock=time.time):
        """A read-only view (``read``/``expired``/``describe``) that
        never contends for the lease: skips knob resolution entirely,
        so a bad supervisor-only ``FLAGS_fleet_lease_secs`` cannot
        fail a router-only process that merely DISPLAYS the lease."""
        self = cls.__new__(cls)
        self.path = path
        self.lease_secs = None
        self.holder = ""
        self._clock = clock
        self.settle_s = 0.0
        self._lock = threading.Lock()
        self._nonce = None
        return self

    # -- readers -------------------------------------------------------
    def read(self):
        """The current lease payload ({holder, nonce, acquired_unix,
        expires_unix, seq}) or None (absent/torn)."""
        return _read_record(self.path)

    def expired(self, rec=None):
        if rec is None:
            rec = self.read()
        if rec is None:
            return True
        return self._clock() >= rec.get("expires_unix", 0.0)

    def held(self):
        """Do WE hold an unexpired lease right now?"""
        with self._lock:
            nonce = self._nonce
        if nonce is None:
            return False
        rec = self.read()
        return rec is not None and rec.get("nonce") == nonce \
            and not self.expired(rec)

    def describe(self):
        """Status-page view: the payload plus expires_in_s."""
        rec = self.read()
        if rec is None:
            return None
        doc = dict(rec)
        doc["expires_in_s"] = round(
            rec.get("expires_unix", 0.0) - self._clock(), 3)
        return doc

    # -- holder protocol ----------------------------------------------
    def _write(self, prev):
        nonce = _new_nonce()
        now = self._clock()
        payload = {"holder": self.holder, "nonce": nonce,
                   "acquired_unix": now,
                   "expires_unix": now + self.lease_secs,
                   "seq": (prev.get("seq", 0) + 1) if prev else 1}
        _write_record(self.path, payload)
        return nonce

    def _acquire_locked(self, prev):
        """Write + settle + re-read under ``_lock``: under concurrent
        acquirers the LAST atomic replace wins; the re-read is what
        makes each contender's answer truthful rather than
        optimistic."""
        nonce = self._write(prev)
        if self.settle_s:
            time.sleep(self.settle_s)
        rec = self.read()
        if rec is not None and rec.get("nonce") == nonce:
            self._nonce = nonce
            return True
        self._nonce = None
        return False

    def try_acquire(self):
        """Acquire the lease if it is free (absent/expired) or already
        ours. Returns True on success; False when another holder's
        unexpired lease stands, or we lost the settle race."""
        with self._lock:
            rec = self.read()
            if rec is not None and not self.expired(rec):
                if rec.get("nonce") == self._nonce:
                    return True      # already ours, still fresh
                return False
            return self._acquire_locked(rec)

    def renew(self):
        """Extend our lease. Returns False (caller must demote) when we
        never held it, it was taken over, or the file is gone/torn.
        A renewal arriving AFTER our expiry re-contends with the full
        acquire protocol instead of silently extending: a standby may
        be mid-settle on the expired record right now, and a plain
        write landing after its re-read would leave BOTH sides
        believing they hold the lease."""
        with self._lock:
            rec = self.read()
            if self._nonce is None or rec is None or \
                    rec.get("nonce") != self._nonce:
                self._nonce = None
                return False
            now = self._clock()
            if now >= rec.get("expires_unix", 0.0):
                return self._acquire_locked(rec)
            rec["expires_unix"] = now + self.lease_secs
            rec["renewed_unix"] = now
            _write_record(self.path, rec)
            return True

    def release(self):
        """Drop the lease if we hold it (clean shutdown: the standby
        can take over immediately instead of waiting out the expiry).
        Writes an already-expired record rather than unlinking so the
        ``seq`` takeover chain survives clean handovers."""
        with self._lock:
            rec = self.read()
            if rec is not None and rec.get("nonce") == self._nonce:
                rec["expires_unix"] = self._clock()
                rec["released_unix"] = self._clock()
                _write_record(self.path, rec)
            self._nonce = None
