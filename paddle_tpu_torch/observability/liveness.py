"""Process liveness AND readiness — the port of
``paddle_tpu/observability/liveness.py``: what /healthz reports instead
of an unconditional "ok".

One tiny process-wide record updated from the hot paths:

* ``report_progress(step)`` — every executor step lands here (wired in
  ``steps.emit_step``), so "last step + when" is accurate for ANY run:
  training, bench, or serving (serving inference steps go through the
  same executor telemetry).
* ``report_checkpoint(step)`` — every committed checkpoint
  (``robustness.CheckpointManager``) stamps its age.
* ``set_deadline(seconds)`` — the train loop's hang watchdog arms this;
  once armed, ``status()["healthy"]`` flips False (and /healthz returns
  503) when no progress lands within the deadline — a load balancer or
  babysitter sees the stall BEFORE the watchdog aborts the process.
* ``set_draining(True)`` — READINESS, distinct from liveness: a
  draining process is perfectly alive (it is finishing in-flight work)
  but must receive no new traffic. ``status()`` then reports
  ``status="draining"``/``ready=False`` while ``healthy`` stays
  truthful, so a router stops routing WITHOUT a supervisor killing the
  replica as dead.

The two bits drive different reactions: ``ready=False`` means "route
around me", ``healthy=False`` means "I am wedged — restarting me is
reasonable". HTTP endpoints return 200 only when both hold.

``status()`` is what the monitor and serving /healthz endpoints
serialize; it never raises and costs a couple of dict reads.
"""

import threading
import time

__all__ = ["report_progress", "report_checkpoint", "set_deadline",
           "set_draining", "status", "reset"]

_lock = threading.Lock()
# Wall-clock stamps (*_ts) are REPORTED; ages and the stall decision use
# the monotonic twins (*_mono) — an NTP step must not 503 a healthy run
# (or mask a stalled one). The HangWatchdog is monotonic for the same
# reason.
_state = {
    "last_step": None,        # last executor/loop step index reported
    "last_step_ts": None,     # wall time of that report (reporting only)
    "last_step_mono": None,
    "checkpoint_step": None,  # global step of the last committed ckpt
    "checkpoint_ts": None,
    "checkpoint_mono": None,
    "deadline_s": None,       # hang-watchdog deadline (None = unarmed)
    "armed_mono": None,       # when the deadline was (re)armed
    "draining": None,         # readiness: True = finish work, no new traffic
}


def report_progress(step=None, ts=None):
    with _lock:
        if step is not None:
            _state["last_step"] = int(step)
        _state["last_step_ts"] = time.time() if ts is None else ts
        _state["last_step_mono"] = time.monotonic()


def report_checkpoint(step=None, ts=None):
    with _lock:
        if step is not None:
            _state["checkpoint_step"] = int(step)
        _state["checkpoint_ts"] = time.time() if ts is None else ts
        _state["checkpoint_mono"] = time.monotonic()


def set_deadline(seconds):
    """Arm (or, with None/0, disarm) the liveness deadline. While armed,
    ``healthy`` is False when the last progress report is older than the
    deadline (measured from the later of arming and last progress, so a
    freshly-armed idle process isn't instantly unhealthy... it gets one
    full deadline to make its first step)."""
    with _lock:
        if not seconds:
            _state["deadline_s"] = None
            _state["armed_mono"] = None
        else:
            _state["deadline_s"] = float(seconds)
            _state["armed_mono"] = time.monotonic()


def set_draining(on=True):
    """Flip process readiness: ``True`` marks this process draining —
    still alive, finishing in-flight work, but routable traffic must go
    elsewhere. Liveness (``healthy``) is unaffected."""
    with _lock:
        _state["draining"] = bool(on) or None


def status(now=None):
    """Liveness + readiness snapshot for /healthz: last-step index +
    age, checkpoint step + age, the armed deadline, the derived
    ``healthy`` (liveness: not stalled) and ``ready`` (healthy AND not
    draining) bools. ``now`` (tests only) is a monotonic-clock
    instant."""
    mono = time.monotonic() if now is None else now
    with _lock:
        st = dict(_state)
    out = {"status": "ok", "healthy": True,
           "draining": bool(st["draining"]),
           "last_step": st["last_step"],
           "last_step_ts": st["last_step_ts"],
           "last_step_age_s": None,
           "checkpoint_step": st["checkpoint_step"],
           "checkpoint_age_s": None,
           "watchdog_deadline_s": st["deadline_s"]}
    if st["last_step_mono"] is not None:
        out["last_step_age_s"] = round(
            max(0.0, mono - st["last_step_mono"]), 3)
    if st["checkpoint_mono"] is not None:
        out["checkpoint_age_s"] = round(
            max(0.0, mono - st["checkpoint_mono"]), 3)
    if st["deadline_s"] is not None:
        ref = max(filter(None, (st["armed_mono"], st["last_step_mono"])),
                  default=None)
        if ref is not None and mono - ref > st["deadline_s"]:
            out["healthy"] = False
            out["status"] = "stalled"
    if out["draining"] and out["status"] == "ok":
        out["status"] = "draining"
    out["ready"] = out["healthy"] and not out["draining"]
    return out


def reset():
    """Tests only: forget all progress/deadline state."""
    with _lock:
        for k in _state:
            _state[k] = None
