"""The fault-tolerant training loop — the port of
``paddle_tpu/robustness/train_loop.py``.

``train_loop(step_fn, n_steps, ...)`` is the layer between "a loop that
calls the executor" and "a run that survives": it owns resume,
preemption, retries, and the hang watchdog so that training scripts
and the benches (``benchmarks.lm``) get the same guarantees from one
place.

* **Auto-resume** — ``resume_or_init()`` restores the latest valid
  checkpoint's tensors, the executor's RNG step counter, and the data
  position (via ``restore_data_fn``), then starts the loop at the saved
  step: a resumed run continues the SAME trajectory, not a similar one.
* **Preemption** — SIGTERM/SIGINT set a flag; the in-flight step
  finishes, a final checkpoint commits (blocking), and the process
  exits with :data:`EXIT_PREEMPTED` so wrappers can tell "preempted,
  relaunch me" from success and from crashes.
* **Retry classification** — transient host/IO failures
  (:func:`classify_failure` → ``"retryable"``) back off exponentially
  (capped) and retry up to ``max_retries``; fatal ones
  (``DeviceStateError`` — the device state is gone — NaN checks,
  programming errors) raise immediately.
* **Hang watchdog** — a step exceeding ``step_deadline_s`` dumps the
  flight recorder and every thread's stack (``faulthandler``), then
  aborts with :data:`EXIT_WATCHDOG`: a wedged device becomes a
  diagnosable crash instead of a silent stall. The armed deadline also
  flips ``/healthz`` to 503 (observability.liveness) before the abort.
"""

import faulthandler
import os
import signal
import sys
import threading
import time

from . import chaos as chaos_mod
from .checkpoint import CheckpointManager

__all__ = ["train_loop", "resume_or_init", "classify_failure",
           "TrainLoopResult", "HangWatchdog", "EXIT_PREEMPTED",
           "EXIT_WATCHDOG"]

# Distinct exit codes: wrappers and schedulers key off these — 0 success, EXIT_PREEMPTED "checkpointed
# and yielded, relaunch me", EXIT_WATCHDOG "hung past the deadline,
# stacks are on stderr", anything else a crash.
EXIT_PREEMPTED = 42
EXIT_WATCHDOG = 43


def classify_failure(exc):
    """``"retryable"`` (transient host/IO — worth re-running the step)
    or ``"fatal"`` (wrong answer or dead device — re-running can only
    corrupt the run)."""
    from ..serving.generation import DeviceStateError
    if isinstance(exc, DeviceStateError):
        return "fatal"  # device state updated in place; unrecoverable
    if isinstance(exc, chaos_mod.ChaosError):
        return "retryable"
    if isinstance(exc, FloatingPointError):
        return "fatal"  # NaN/Inf: retrying reproduces it
    if isinstance(exc, (MemoryError, KeyboardInterrupt, SystemExit)):
        return "fatal"
    if isinstance(exc, (OSError, IOError, ConnectionError, TimeoutError)):
        return "retryable"  # host/IO weather
    return "fatal"


class HangWatchdog:
    """Per-step deadline enforcement on a daemon thread.

    ``beat()`` after every completed step; if no beat lands within
    ``deadline_s`` the watchdog dumps the flight recorder +
    ``faulthandler`` stacks for EVERY thread to stderr and hard-exits
    with :data:`EXIT_WATCHDOG` (``os._exit``: the hung step is wedged in
    native code — a Python exception would never be seen)."""

    def __init__(self, deadline_s, exit_code=EXIT_WATCHDOG):
        self.deadline_s = float(deadline_s)
        self.exit_code = exit_code
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._paused = False
        self._thread = None

    def start(self):
        from ..observability import liveness
        liveness.set_deadline(self.deadline_s)
        self._thread = threading.Thread(target=self._run,
                                        name="train-watchdog", daemon=True)
        self._thread.start()
        return self

    def beat(self):
        """Progress/activity stamp. Also refreshes the liveness
        timestamp: a retry cycle deliberately beating through backoff is
        alive, and /healthz must not call it 'stalled' while the
        watchdog itself is satisfied."""
        self._last = time.monotonic()
        from ..observability import liveness
        liveness.report_progress()

    def pause(self):
        """Suspend deadline enforcement for deliberate long waits (a
        blocking checkpoint save is not a hang). Also disarms the
        liveness deadline: /healthz flipping to 503 "stalled" mid-save
        would invite a babysitter to kill the very write the pause
        protects."""
        from ..observability import liveness
        self._paused = True
        liveness.set_deadline(None)

    def resume(self):
        from ..observability import liveness
        self.beat()
        self._paused = False
        liveness.set_deadline(self.deadline_s)

    def stop(self):
        from ..observability import liveness
        self._stop.set()
        liveness.set_deadline(None)

    def _run(self):
        poll = max(0.05, min(1.0, self.deadline_s / 4.0))
        while not self._stop.wait(poll):
            if self._paused:
                continue
            stalled = time.monotonic() - self._last
            if stalled <= self.deadline_s:
                continue
            sys.stderr.write(
                "train_loop watchdog: no step progress for %.1fs "
                "(deadline %.1fs) — dumping stacks + flight recorder, "
                "aborting with exit code %d\n"
                % (stalled, self.deadline_s, self.exit_code))
            try:
                faulthandler.dump_traceback(file=sys.stderr,
                                            all_threads=True)
            except Exception:
                pass
            try:
                from ..observability import flight_recorder
                path = flight_recorder.dump_on_crash("watchdog")
                if path:
                    sys.stderr.write(
                        "train_loop watchdog: flight recorder -> %s\n"
                        % path)
            except Exception:
                pass
            sys.stderr.flush()
            os._exit(self.exit_code)


def _sleep_beating(delay, watchdog, preempt=None):
    """Backoff sleep that keeps the watchdog fed (deliberate waiting is
    not a hang) and wakes early when a preemption notice lands — the
    grace window must not be spent sleeping."""
    end = time.monotonic() + delay
    while True:
        if watchdog is not None:
            watchdog.beat()
        if preempt is not None and preempt.get("signum") is not None:
            return
        left = end - time.monotonic()
        if left <= 0:
            return
        time.sleep(min(left, 0.25))


class TrainLoopResult:
    def __init__(self, step, fetches=None, preempted=False, retries=0,
                 resumed_from=None):
        self.step = step                  # steps COMPLETED
        self.fetches = fetches            # last step_fn return value
        self.preempted = preempted
        self.retries = retries
        self.resumed_from = resumed_from  # serial resumed from, or None

    def __repr__(self):
        return ("TrainLoopResult(step=%d, preempted=%s, retries=%d, "
                "resumed_from=%s)" % (self.step, self.preempted,
                                      self.retries, self.resumed_from))


def resume_or_init(checkpoint, scope=None, executor=None,
                   restore_data_fn=None):
    """Restore the latest valid checkpoint (tensors into ``scope``,
    executor step counter, data position through ``restore_data_fn``)
    and return (start_step, serial); (0, None) on a fresh start."""
    if checkpoint is None:
        return 0, None
    from ..executor import global_scope
    from ..observability import runlog
    found = checkpoint.latest_valid()
    if found is None:
        return 0, None
    serial, peek = found
    if peek is None:
        # a bare io.save_checkpoint serial: tensors but no TRAIN_STATE.
        # Restoring trained params and re-running from step 0 would
        # silently fork the trajectory (N extra optimizer passes), so
        # refuse to auto-resume — the operator can load it explicitly
        import warnings
        warnings.warn(
            "checkpoint serial %d has no TRAIN_STATE (written by bare "
            "io.save_checkpoint?) — cannot resume a trajectory from it; "
            "starting fresh. Load it explicitly if params-only restore "
            "is intended." % serial)
        return 0, None
    state = checkpoint.restore(scope if scope is not None
                               else global_scope(), executor=executor,
                               serial=serial)
    if state is None:
        return 0, None
    if restore_data_fn is not None and state.get("data_state") is not None:
        restore_data_fn(state["data_state"])
    log = runlog.get_run_log()
    if log is not None:
        log.write({"kind": "resume", "serial": state.get("serial"),
                   "step": state.get("step", 0)})
    return int(state.get("step", 0)), state.get("serial")


def train_loop(step_fn, n_steps, *, program=None, scope=None, executor=None,
               checkpoint=None, resume=True, save_at_end=False,
               preempt_signals=(signal.SIGTERM, signal.SIGINT),
               exit_on_preempt=True, max_retries=None,
               retry_backoff_s=None, retry_backoff_cap_s=30.0,
               step_deadline_s=None, data_state_fn=None,
               restore_data_fn=None, on_step=None, chaos=None):
    """Run ``step_fn(step)`` for steps ``[start, n_steps)`` with resume,
    preemption, retry, and watchdog semantics (module docstring).

    ``step_fn(step)`` runs ONE training step (an ``Executor.run`` call,
    or a whole ``run_steps`` dispatch) and returns its fetches.
    Retry contract: a retried step re-runs ``step_fn(step)`` whole, so
    retryable (host/IO) errors should only escape ``step_fn`` from its
    PRE-dispatch phase — a transient failure after the optimizer update
    committed on device would re-apply the step. Failures the runtime
    itself injects at the post-commit boundary (the chaos ``fetch``
    hook) are never retried for exactly that reason.
    ``checkpoint`` is a :class:`CheckpointManager` (or None);
    ``data_state_fn()`` contributes the JSON data-pipeline position each
    save bundles (e.g. ``task_master.state_dict``), ``restore_data_fn``
    applies it on resume. ``chaos`` overrides the FLAGS_chaos_spec
    injector (tests). Knobs default to the FLAGS_step_* flags.
    """
    from .. import flags
    from ..executor import global_scope
    from ..framework import default_main_program
    from ..observability import catalog, liveness, runlog

    program = program or default_main_program()
    scope = scope if scope is not None else global_scope()
    max_retries = int(flags.step_retry_max if max_retries is None
                      else max_retries)
    retry_backoff_s = float(flags.step_retry_backoff_s
                            if retry_backoff_s is None else retry_backoff_s)
    step_deadline_s = float(flags.step_deadline_s if step_deadline_s is None
                            else step_deadline_s)
    injector = chaos if chaos is not None else chaos_mod.get_injector()

    start, resumed_from = (0, None)
    if resume and checkpoint is not None:
        start, resumed_from = resume_or_init(
            checkpoint, scope=scope, executor=executor,
            restore_data_fn=restore_data_fn)

    # -- preemption notice: finish the step, checkpoint, exit 42 -------
    preempt = {"signum": None}
    old_handlers = {}
    if preempt_signals:
        def _on_signal(signum, frame):
            preempt["signum"] = signum
        for sig in preempt_signals:
            try:
                old_handlers[sig] = signal.signal(sig, _on_signal)
            except (ValueError, OSError):  # non-main thread / platform
                pass

    watchdog = None
    if step_deadline_s > 0:
        watchdog = HangWatchdog(step_deadline_s).start()

    def _save(step, block):
        if checkpoint is None:
            return None
        data_state = data_state_fn() if data_state_fn is not None else None
        # a save legitimately takes as long as the snapshot + (when
        # blocking or joining a slow prior write) the disk need — that
        # is not a hang, and killing it mid-write would turn a clean
        # preemption into a torn serial + a misleading exit 43
        if watchdog is not None:
            watchdog.pause()
        try:
            return checkpoint.save(program, scope, step,
                                   executor=executor,
                                   data_state=data_state, block=block,
                                   chaos=injector)
        finally:
            if watchdog is not None:
                watchdog.resume()

    total_retries = 0
    fetches = None
    step = start

    def _preempt_exit(completed):
        """Honor the pending preemption notice: checkpoint ``completed``
        steps (blocking) and exit EXIT_PREEMPTED (or return the result).
        Reached after a completed step OR from inside a retry cycle —
        in the latter case the failing step simply re-runs on resume."""
        catalog.PREEMPTIONS.inc()
        serial = _save(completed, block=True)
        log = runlog.get_run_log()
        if log is not None:
            log.write({"kind": "preempt",
                       "signal": int(preempt["signum"]),
                       "step": completed, "serial": serial})
        sys.stderr.write(
            "train_loop: preemption signal %s after %d completed "
            "step(s) — checkpointed serial %s, exiting %d\n"
            % (preempt["signum"], completed, serial, EXIT_PREEMPTED))
        if exit_on_preempt:
            sys.exit(EXIT_PREEMPTED)
        return TrainLoopResult(completed, fetches, preempted=True,
                               retries=total_retries,
                               resumed_from=resumed_from)

    try:
        while step < n_steps:
            # -- one step, with retry-on-transient ----------------------
            attempt = 0
            while True:
                if watchdog is not None:
                    watchdog.beat()  # each ATTEMPT gets a full deadline
                try:
                    chaos_mod.maybe_fire("step", injector)
                    fetches = step_fn(step)
                    break
                except BaseException as e:
                    kind = classify_failure(e)
                    if kind != "retryable" or attempt >= max_retries:
                        raise
                    attempt += 1
                    total_retries += 1
                    catalog.STEP_RETRIES.inc()
                    # a preemption notice must not wait out a whole
                    # retry-backoff cycle (the grace window may be
                    # shorter): checkpoint the COMPLETED steps now; the
                    # failing step re-runs on resume
                    if preempt["signum"] is not None:
                        return _preempt_exit(step)
                    delay = min(retry_backoff_s * (2 ** (attempt - 1)),
                                retry_backoff_cap_s)
                    log = runlog.get_run_log()
                    if log is not None:
                        log.write({"kind": "retry", "step": step,
                                   "attempt": attempt,
                                   "error": "%s: %s" % (type(e).__name__,
                                                        e),
                                   "backoff_s": round(delay, 3)})
                    sys.stderr.write(
                        "train_loop: step %d failed (%s: %s) — retry "
                        "%d/%d in %.2fs\n" % (step, type(e).__name__, e,
                                              attempt, max_retries, delay))
                    _sleep_beating(delay, watchdog, preempt)
                    if preempt["signum"] is not None:
                        return _preempt_exit(step)
            # fetch boundary OUTSIDE the retry: once step_fn returned,
            # the optimizer update is committed — re-running the step
            # would double-apply it and silently fork the trajectory,
            # so failures injected here propagate. (The loop cannot see
            # inside step_fn: a retryable error step_fn raises AFTER
            # its own dispatch committed will still be retried — see
            # the docstring's idempotence note.)
            chaos_mod.maybe_fire("fetch", injector)
            step += 1
            # freshness stamp for /healthz. The step NUMBER is only
            # written when no executor is involved — executor steps
            # already stamp their global dispatch counter via emit_step,
            # and overwriting it with the loop's (smaller) index would
            # make last_step oscillate backwards between scrapes
            liveness.report_progress(step - 1 if executor is None
                                     else None)
            if watchdog is not None:
                watchdog.beat()
            if on_step is not None:
                on_step(step - 1, fetches)
            # -- preemption: checkpoint the completed step, yield -------
            if preempt["signum"] is not None:
                return _preempt_exit(step)
            # -- policy checkpoint (non-blocking background write) ------
            if checkpoint is not None and checkpoint.should_save(step):
                _save(step, block=False)
        if save_at_end and checkpoint is not None and step > start:
            _save(step, block=True)
        return TrainLoopResult(step, fetches, retries=total_retries,
                               resumed_from=resumed_from)
    finally:
        if watchdog is not None:
            watchdog.stop()
        for sig, h in old_handlers.items():
            try:
                signal.signal(sig, h)
            except (ValueError, OSError):
                pass
        if checkpoint is not None:
            checkpoint.wait(raise_on_error=False)
