"""Shared bench hardening — the port of ``bench_common.py``'s
``telemetry_report``, ``emit_failure`` and ``run_guarded``.

A bench measures the card. ``run_guarded`` therefore refuses to start
without one: with no CUDA device, and without ``BENCH_FORCE_CPU=1`` (the
only way onto the CPU, for smoke runs), it prints the failure JSON line
and exits 1 — it never falls back to the CPU. Otherwise it runs the
measurement under a watchdog thread (``BENCH_WATCHDOG`` seconds, default
1500; 0 disables) that prints the failure line and hard-exits on a
stall, and turns any exception into the failure line and exit 1: the
caller always gets one JSON line.
"""

import json
import os
import sys
import threading

__all__ = ["telemetry_report", "emit_failure", "run_guarded", "force_cpu",
           "place"]


def force_cpu():
    """True when ``BENCH_FORCE_CPU`` asks for a CPU smoke run."""
    return os.environ.get("BENCH_FORCE_CPU", "") not in ("", "0")


def place():
    """The bench's place: the card, or the CPU under BENCH_FORCE_CPU."""
    import paddle_tpu_torch as fluid
    return fluid.CPUPlace() if force_cpu() else fluid.CUDAPlace(0)


def telemetry_report():
    """The run's telemetry (pipeline counters + step / cache stats) from
    the observability catalogue — what the benches report instead of
    keeping private accounting."""
    from ..observability import steps
    return steps.step_summary()


def emit_failure(metric, unit, error, extra=None):
    rec = {"metric": metric, "value": None, "unit": unit,
           "vs_baseline": None, "error": str(error)[:500]}
    if extra:
        rec.update(extra)
    print(json.dumps(rec))


def run_guarded(main_fn, metric, unit, extra=None):
    """Check for the card, then run ``main_fn`` under a watchdog. Exit 0
    on success; exit 1 — but always with the JSON line on stdout — on
    terminal failure."""
    import torch
    if not force_cpu() and not torch.cuda.is_available():
        emit_failure(metric, unit,
                     "no CUDA device (torch.cuda.is_available() is False); "
                     "set BENCH_FORCE_CPU=1 for a CPU smoke run", extra)
        sys.exit(1)
    watchdog = float(os.environ.get("BENCH_WATCHDOG", 1500))
    done = threading.Event()

    def _watch():
        if not done.wait(watchdog):
            emit_failure(metric, unit, "watchdog: bench exceeded %ds"
                         % int(watchdog), extra)
            sys.stdout.flush()
            os._exit(1)

    if watchdog > 0:
        threading.Thread(target=_watch, daemon=True).start()
    try:
        main_fn()
    except BaseException as e:  # noqa: BLE001 — diagnosis must always print
        if isinstance(e, (KeyboardInterrupt, SystemExit)):
            raise
        emit_failure(metric, unit, "%s: %s" % (type(e).__name__, e), extra)
        sys.exit(1)
    finally:
        done.set()
