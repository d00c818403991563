"""Deterministic, seedable fault injection — the port of
``paddle_tpu/robustness/chaos.py``, the same grammar and the same
draws, so a (spec, seed) pair fires at the same hooks in either
package.

The claim "every run survives a kill at any instant" is only worth
anything when it is PROVEN by killing runs — this module is the
injection side of that proof. Hooks are placed at the runtime's three
hazard boundaries (``step`` — before one training step, retryable;
``save`` — between a checkpoint's tensor files and its manifest commit;
``fetch`` — after the step returned, i.e. the committed/sync side,
never step-retried); each hook calls
:func:`maybe_fire`, which is a free no-op unless ``FLAGS_chaos_spec``
names it.

Spec grammar (comma-separated rules)::

    spec     := rule (',' rule)*
    rule     := point ':' selector '=' action ['@' probability]
    point    := 'step' | 'save' | 'fetch'
    selector := INT   -- the Nth firing of that hook (0-based)
              | '*'   -- every firing (usually with '@p')
    action   := 'raise'     -- ChaosError (classified retryable)
              | 'fatal'     -- DeviceStateError (never retried)
              | 'kill9'     -- SIGKILL self: the preemption/crash case
              | 'sigterm'   -- SIGTERM self: graceful preemption notice
              | 'hang'[SECS]-- block SECS (default 3600): watchdog food

Examples: ``step:37=raise`` (step 37 raises once), ``save:2=kill9``
(the third checkpoint write dies mid-save, leaving a torn serial),
``step:*=raise@0.01`` (1% of steps fail; the draw sequence is a PRNG
seeded by ``FLAGS_chaos_seed``, so a given (spec, seed) pair replays
byte-identically), ``step:5=hang30`` (step 5 wedges for 30 s).

The subprocess harness (:func:`run_until_success`) is the other half:
it launches a training command, lets chaos (or an external
``kill_after_s``) kill it, and relaunches until the run exits clean —
the auto-resume cycle the tests assert on.
"""

import os
import re
import signal
import subprocess
import sys
import threading
import time

__all__ = ["ChaosError", "ChaosRule", "ChaosInjector", "parse_chaos_spec",
           "get_injector", "set_injector", "maybe_fire",
           "run_until_success", "KillResult"]

POINTS = ("step", "save", "fetch", "handoff")

_ACTION_RE = re.compile(r"^(raise|fatal|kill9|sigterm|hang(\d+(?:\.\d+)?)?)$")


class ChaosError(RuntimeError):
    """An injected TRANSIENT failure — robustness.train_loop classifies
    it retryable (it stands in for flaky host IO)."""


class ChaosRule:
    def __init__(self, point, selector, action, hang_s=None, prob=None):
        self.point = point
        self.selector = selector      # int or "*"
        self.action = action          # raise|fatal|kill9|sigterm|hang
        self.hang_s = hang_s
        self.prob = prob              # None = always

    def matches(self, index, rng):
        if self.selector != "*" and self.selector != index:
            return False
        if self.prob is not None:
            return rng.random() < self.prob
        return True

    def __repr__(self):
        sel = self.selector
        act = self.action + ("%g" % self.hang_s if self.action == "hang"
                             and self.hang_s else "")
        p = "@%g" % self.prob if self.prob is not None else ""
        return "%s:%s=%s%s" % (self.point, sel, act, p)


def parse_chaos_spec(spec):
    """Parse the grammar above into [ChaosRule]; raises ValueError naming
    the offending rule."""
    rules = []
    for raw in filter(None, (p.strip() for p in (spec or "").split(","))):
        m = re.match(r"^(\w+):([^=]+)=(.+)$", raw)
        if not m:
            raise ValueError(
                "chaos rule %r is not point:selector=action" % raw)
        point, sel, act = m.group(1), m.group(2).strip(), m.group(3).strip()
        if point not in POINTS:
            raise ValueError("chaos rule %r: unknown point %r (one of %s)"
                             % (raw, point, "/".join(POINTS)))
        prob = None
        if "@" in act:
            act, _, p = act.partition("@")
            try:
                prob = float(p)
            except ValueError:
                raise ValueError("chaos rule %r: bad probability %r"
                                 % (raw, p))
            if not 0.0 <= prob <= 1.0:
                raise ValueError("chaos rule %r: probability %g not in "
                                 "[0, 1]" % (raw, prob))
        am = _ACTION_RE.match(act)
        if not am:
            raise ValueError(
                "chaos rule %r: unknown action %r (raise/fatal/kill9/"
                "sigterm/hang[SECS])" % (raw, act))
        hang_s = None
        action = am.group(1)
        if action.startswith("hang"):
            hang_s = float(am.group(2)) if am.group(2) else 3600.0
            action = "hang"
        if sel != "*":
            try:
                sel = int(sel)
            except ValueError:
                raise ValueError("chaos rule %r: selector must be an int "
                                 "or '*'" % raw) from None
            if sel < 0:
                raise ValueError("chaos rule %r: negative selector" % raw)
        rules.append(ChaosRule(point, sel, action, hang_s, prob))
    return rules


class ChaosInjector:
    """Counts firings per hook point and executes matching rules.

    Deterministic: each point has its OWN PRNG stream (seeded from
    (chaos_seed, point)) and its own firing counter, so probabilistic
    draws depend only on that point's firing sequence — concurrent
    hooks (the async checkpoint writer fires ``save`` while the
    training thread fires ``step``/``fetch``) cannot perturb each
    other's replay. Counter/draw state is lock-guarded."""

    def __init__(self, spec, seed=None):
        import random
        import threading
        from .. import flags
        self.rules = parse_chaos_spec(spec)
        self.seed = int(flags.chaos_seed if seed is None else seed)
        self._rngs = {p: random.Random(self.seed * 1000003 + i)
                      for i, p in enumerate(POINTS)}
        self.counts = {p: 0 for p in POINTS}
        self._lock = threading.Lock()

    def fire(self, point):
        """One firing of ``point``: bump its counter, execute matching
        rules. raise/fatal raise; kill9 never returns."""
        if point not in self.counts:
            raise ValueError("unknown chaos point %r" % point)
        with self._lock:
            index = self.counts[point]
            self.counts[point] = index + 1
            fired = [r for r in self.rules if r.point == point
                     and r.matches(index, self._rngs[point])]
        for rule in fired:  # actions outside the lock: hang must not
            self._execute(rule, point, index)  # wedge other points

    def _execute(self, rule, point, index):
        from ..observability import catalog
        catalog.CHAOS_INJECTED.inc(point=point, action=rule.action)
        where = "%s[%d]" % (point, index)
        if rule.action == "raise":
            raise ChaosError("chaos: injected transient failure at %s"
                             % where)
        if rule.action == "fatal":
            from ..serving.generation import DeviceStateError
            raise DeviceStateError(
                "chaos: injected fatal device failure at %s" % where)
        if rule.action == "kill9":
            sys.stderr.write("chaos: SIGKILL self at %s\n" % where)
            sys.stderr.flush()
            os.kill(os.getpid(), signal.SIGKILL)
            time.sleep(60)  # unreachable; SIGKILL is not deliverable-late
        if rule.action == "sigterm":
            sys.stderr.write("chaos: SIGTERM self at %s\n" % where)
            sys.stderr.flush()
            os.kill(os.getpid(), signal.SIGTERM)
            return
        if rule.action == "hang":
            time.sleep(rule.hang_s)


# -- process-wide injector (from FLAGS_chaos_spec) --------------------------

_injector = None
_injector_from = None
_pinned = False
# guards the rebuild-on-flag-change below: maybe_fire runs on training
# AND checkpoint-writer threads, and an unlocked spec comparison could
# build two injectors with independent PRNG streams (analysis/race_lint)
_injector_lock = threading.Lock()


def get_injector():
    """The process injector: an explicitly pinned one (set_injector),
    else per FLAGS_chaos_spec (None when unset). Re-reads the flag, so
    tests/set_flags can change it at runtime."""
    global _injector, _injector_from
    from .. import flags
    with _injector_lock:
        if _pinned:
            return _injector
        spec = flags.chaos_spec or ""
        if spec != (_injector_from or ""):
            _injector = ChaosInjector(spec) if spec else None
            _injector_from = spec
        return _injector


def set_injector(injector):
    """Pin an explicit injector, overriding the flag (tests); None
    unpins and returns control to FLAGS_chaos_spec."""
    global _injector, _injector_from, _pinned
    with _injector_lock:
        _injector = injector
        _injector_from = None
        _pinned = injector is not None


def maybe_fire(point, injector=None):
    """The hook call sites use: fire ``point`` on the given (or process)
    injector; free no-op when chaos is off."""
    inj = injector if injector is not None else get_injector()
    if inj is not None:
        inj.fire(point)


# -- subprocess harness -----------------------------------------------------

class KillResult:
    """One launch of the harnessed command."""

    def __init__(self, returncode, stdout, stderr, killed_externally):
        self.returncode = returncode
        self.stdout = stdout
        self.stderr = stderr
        self.killed_externally = killed_externally


def run_until_success(argv, *, env=None, cwd=None, max_launches=8,
                      kill_after_s=None, kill_signal=signal.SIGKILL,
                      per_launch_timeout_s=600.0, ok_codes=(0,)):
    """Launch ``argv`` repeatedly until it exits with an ok code — the
    auto-resume kill/restart cycle as a harness.

    ``kill_after_s``: optionally kill each launch EXTERNALLY after that
    many seconds (a float, or a zero-arg callable returning one — pass a
    seeded RNG's draw for "SIGKILL at a random point"). The launch that
    survives its window (or whose chaos spec stops killing it) ends the
    loop. Returns the list of :class:`KillResult`, last one successful;
    raises RuntimeError after ``max_launches`` without a clean exit."""
    results = []
    for _ in range(max_launches):
        proc = subprocess.Popen(argv, env=env, cwd=cwd,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        killed = False
        delay = kill_after_s() if callable(kill_after_s) else kill_after_s
        try:
            if delay is not None:
                try:
                    out, err = proc.communicate(timeout=delay)
                except subprocess.TimeoutExpired:
                    proc.send_signal(kill_signal)
                    killed = True
                    out, err = proc.communicate(
                        timeout=per_launch_timeout_s)
            else:
                out, err = proc.communicate(timeout=per_launch_timeout_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
            raise RuntimeError(
                "chaos harness: launch exceeded %gs\n--- stdout\n%s\n"
                "--- stderr\n%s" % (per_launch_timeout_s, out, err))
        res = KillResult(proc.returncode, out, err, killed)
        results.append(res)
        if proc.returncode in ok_codes:
            return results
    raise RuntimeError(
        "chaos harness: no clean exit in %d launches (last rc=%s)\n"
        "--- last stderr\n%s"
        % (max_launches, results[-1].returncode, results[-1].stderr[-2000:]))
