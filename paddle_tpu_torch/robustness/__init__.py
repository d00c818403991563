"""Fault-tolerant training runtime — the port of ``paddle_tpu/robustness``:

- :class:`CheckpointManager` — policy-driven saves (FLAGS_checkpoint_*)
  that snapshot device state to host synchronously and commit in a
  background thread; each serial bundles a TRAIN_STATE record (global
  step, the executor's step counter, data position) under the md5
  manifest; ``latest_valid()`` walks serials newest-first past torn or
  corrupt ones. The serial layout is the reference's: either package
  restores the other's serials.
- :func:`train_loop` — the loop the port's bench runs under:
  auto-resume, SIGTERM/SIGINT preemption (finish step → checkpoint →
  exit :data:`EXIT_PREEMPTED`), capped-backoff retry of transient
  failures, and a hang watchdog that dumps stacks + the flight recorder
  before aborting with :data:`EXIT_WATCHDOG`.
- :mod:`chaos` — deterministic, seedable fault injection
  (``FLAGS_chaos_spec``: ``step:37=raise``, ``save:2=kill9``, ...) at the
  step/save/fetch boundaries, plus the subprocess kill/relaunch harness.

Sharded (multi-process) serials are not ported yet.
"""

from . import chaos
from .chaos import ChaosError, ChaosInjector, maybe_fire, \
    parse_chaos_spec, run_until_success
from .checkpoint import CheckpointManager, build_train_state
from .train_loop import EXIT_PREEMPTED, EXIT_WATCHDOG, HangWatchdog, \
    TrainLoopResult, classify_failure, resume_or_init, train_loop

__all__ = [
    "chaos", "ChaosError", "ChaosInjector", "maybe_fire",
    "parse_chaos_spec", "run_until_success",
    "CheckpointManager", "build_train_state",
    "EXIT_PREEMPTED", "EXIT_WATCHDOG", "HangWatchdog", "TrainLoopResult",
    "classify_failure", "resume_or_init", "train_loop",
]
