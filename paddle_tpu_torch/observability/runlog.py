"""JSONL run log — one line per event, opened by a run manifest (the
port of ``paddle_tpu/observability/runlog.py``; the same schema, with
the CUDA devices in ``devices``).

Schema:

* line 1 — ``{"kind": "manifest", "time": ..., "flags": {...},
  "devices": [{"id", "platform", "name", "capability"}],
  "mesh": null,
  "program_fingerprint": "...", ...extra}`` — enough to answer "what
  exactly was this run?" without the launching script.
* then — ``{"kind": "step", "step": i, "feed_wait_s": ...,
  "compile_s": ..., "dispatch_s": ..., "cache": "hit"|"miss",
  "cause": ..., "real_tokens": ..., "pad_tokens": ...,
  "pad_waste_frac": ...}`` per executor step (emitted by
  ``steps.emit_step``), and ``{"kind": "error", "step": i, "error": ...,
  "trace_dump": path}`` when a step raises.
* the fault-tolerance runtime (``robustness``) adds
  ``{"kind": "checkpoint", "step", "serial", "dir"}`` per committed
  serial, ``{"kind": "resume", "serial", "step"}`` on auto-resume,
  ``{"kind": "retry", "step", "attempt", "error", "backoff_s"}`` per
  retried step, and ``{"kind": "preempt", "signal", "step", "serial"}``
  when a preemption notice is honored.

One ACTIVE run log per process (``start_run_log`` / ``get_run_log`` /
``stop_run_log``): the executor writes to whichever is active, so a
training script opts in with one call and no plumbing.
"""

import hashlib
import json
import threading
import time

__all__ = ["RunLog", "start_run_log", "get_run_log", "stop_run_log",
           "build_manifest"]


def _flags_snapshot():
    from .. import flags
    return {k: v for k, v in vars(flags).items()
            if not k.startswith("_")
            and isinstance(v, (bool, int, float, str))}


def _device_topology():
    """The CUDA devices this process sees: index, name and compute
    capability ([] without a card)."""
    try:
        import torch
        if not torch.cuda.is_available():
            return []
        return [{"id": i, "platform": "gpu",
                 "name": torch.cuda.get_device_name(i),
                 "capability": "%d.%d" % torch.cuda.get_device_capability(i)}
                for i in range(torch.cuda.device_count())]
    except Exception:
        return []  # no CUDA runtime — the manifest still opens the log


def program_fingerprint(program):
    """Stable digest of a Program's IR — identifies WHAT was running
    across log files without embedding the whole program."""
    if program is None:
        return None
    try:
        blob = json.dumps(program.to_dict(), sort_keys=True, default=str)
    except Exception:
        blob = repr(program)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


def build_manifest(program=None, mesh=None, extra=None):
    man = {"kind": "manifest", "time": time.time(),
           "flags": _flags_snapshot(), "devices": _device_topology(),
           "mesh": None, "program_fingerprint":
           program_fingerprint(program)}
    if mesh is not None:
        try:
            man["mesh"] = {"axis_names": list(mesh.axis_names),
                           "shape": dict(mesh.shape)}
        except Exception:
            man["mesh"] = str(mesh)
    if extra:
        man.update(extra)
    return man


class RunLog:
    """Append-only JSONL writer (thread-safe; one flush per record so a
    crash loses at most the in-flight line)."""

    def __init__(self, path, manifest=None, append=False):
        """``append=True`` joins an existing log instead of truncating
        it. Each record is one ``write()`` on an O_APPEND stream, so
        concurrent writers interleave at line granularity."""
        self.path = path
        self._lock = threading.Lock()
        self._f = open(path, "a" if append else "w")
        self.write(manifest or build_manifest())

    def write(self, record):
        line = json.dumps(record, default=str)
        with self._lock:
            if self._f is None:
                return
            self._f.write(line + "\n")
            self._f.flush()

    def close(self):
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None


_active = None
_active_lock = threading.Lock()


def start_run_log(path, program=None, mesh=None, extra=None,
                  append=False):
    """Open ``path`` as THE process run log (closing any prior one) and
    write its manifest. The executor's step telemetry lands here until
    ``stop_run_log``. ``append=True`` joins the file instead of
    truncating."""
    global _active
    log = RunLog(path, build_manifest(program=program, mesh=mesh,
                                      extra=extra), append=append)
    with _active_lock:
        if _active is not None:
            _active.close()
        _active = log
    return log


def get_run_log():
    return _active


def stop_run_log():
    global _active
    with _active_lock:
        if _active is not None:
            _active.close()
            _active = None
