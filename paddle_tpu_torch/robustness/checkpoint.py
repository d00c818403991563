"""Policy-driven, preemption-safe checkpointing — the port of
``paddle_tpu/robustness/checkpoint.py``.

``io.save_checkpoint`` gave the on-disk FORM (serial dirs + md5
``_MANIFEST``); this module adds the POLICY and the training-state
bundle that make the form a resumable run:

* **One consistent cut, written in the background.** ``save()``
  synchronously snapshots every persistable (params + optimizer state)
  from device to host between steps, then hands the host copies to a
  writer thread that serializes, md5s, fsyncs and commits while the next
  steps already run. Training only ever blocks on the snapshot, not the
  disk.
* **TRAIN_STATE rides in the serial.** Global step, the executor's step
  counter (random draws fold it in) and the data-pipeline position are
  JSON in the serial dir, covered by the same manifest md5s as the
  tensors: a serial is valid as a WHOLE or not at all.
* **``latest_valid()`` scans newest-first**, skipping torn serials (no
  manifest: the writer died mid-save) and corrupt ones (md5 mismatch).

Tensor files are the ``save``-op npz format (one file per var, a
``data`` key), so a serial written by either package restores in the
other. Sharded serials (the reference's multi-process layout) are not
ported: ``sharded=True`` raises.
"""

import json
import os
import queue
import threading
import time

import numpy as np
import torch

from ..io import _checkpoint_manifest, _claim_serial_dir, \
    _commit_manifest, _fsync_path, _trim_old_serials, _verify_serial
from ..ops.io_ops import from_np, savez_exact, to_np

__all__ = ["CheckpointManager", "build_train_state", "TRAIN_STATE_FILE"]

TRAIN_STATE_FILE = "TRAIN_STATE"


def build_train_state(step, executor=None, data_state=None, extra=None):
    """The TRAIN_STATE record: everything beyond tensors a resumed run
    needs to continue the SAME trajectory — global step, the executor's
    step counter (per-step random draws derive from it), data position."""
    rec = {"kind": "train_state", "step": int(step), "time": time.time()}
    if executor is not None:
        rec["executor_step"] = int(executor.step_counter)
    if data_state is not None:
        rec["data_state"] = data_state
    if extra:
        rec["extra"] = dict(extra)
    return rec


class CheckpointManager:
    """Versioned training checkpoints with a save policy and auto-resume.

    ``dirname``/``every_steps``/``every_secs``/``keep`` default to the
    ``FLAGS_checkpoint_*`` knobs; :meth:`from_flags` returns ``None``
    when no directory is configured, so call sites wire unconditionally.
    """

    def __init__(self, dirname=None, every_steps=None, every_secs=None,
                 keep=None, async_write=True, sharded=None):
        from .. import flags
        if sharded:
            raise NotImplementedError(
                "sharded checkpoint serials are not ported yet (they come "
                "with multi-process parallelism)")
        self.dirname = dirname if dirname is not None else flags.checkpoint_dir
        if not self.dirname:
            raise ValueError(
                "CheckpointManager needs a directory (argument or "
                "FLAGS_checkpoint_dir)")
        self.every_steps = int(flags.checkpoint_every_steps
                               if every_steps is None else every_steps)
        self.every_secs = float(flags.checkpoint_every_secs
                                if every_secs is None else every_secs)
        self.keep = max(1, int(flags.checkpoint_keep
                               if keep is None else keep))
        self.async_write = bool(async_write)
        self._writer = None
        self._write_error = None
        # background GC: trims run on their own worker so the save path
        # never blocks on directory deletion; a serial is enqueued only
        # after its own manifest commit, and io._trim_old_serials never
        # deletes a serial newer than the committed one
        self._gc_lock = threading.Lock()
        self._gc_queue = queue.Queue()
        self._gc_thread = None  # guarded-by: _gc_lock
        self._last_save_t = time.monotonic()
        self.last_serial = None
        os.makedirs(self.dirname, exist_ok=True)

    @classmethod
    def from_flags(cls):
        """A manager per the FLAGS_checkpoint_* knobs, or None when no
        directory is configured (checkpointing disabled). The env var
        ``PADDLE_TPU_CHECKPOINT_DIR`` overrides the flag, so a bench or
        script run becomes preemption-safe from the launcher."""
        from .. import flags
        env_dir = os.environ.get("PADDLE_TPU_CHECKPOINT_DIR", "")
        if env_dir:
            return cls(dirname=env_dir)
        return cls() if flags.checkpoint_dir else None

    # -- policy --------------------------------------------------------
    def should_save(self, step):
        """True when the save policy triggers at ``step`` (steps
        COMPLETED so far): every_steps divides it, or every_secs of wall
        time passed since the last save."""
        if step <= 0:
            return False
        if self.every_steps and step % self.every_steps == 0:
            return True
        return bool(self.every_secs) and \
            time.monotonic() - self._last_save_t >= self.every_secs

    # -- save ----------------------------------------------------------
    def collect(self, program, scope):
        """The consistent cut: host copies of every scope-resident tensor
        persistable of ``program`` (params, optimizer accumulators,
        program-created counters). Syncs with the in-flight step — call
        between steps."""
        from ..executor import program_exec_plan
        plan = program_exec_plan(program)
        names = list(plan["persistables"]) + [
            n for n in plan["created_persistables"]
            if n not in plan["persistables"]]
        out = {}
        for name in names:
            v = scope.find_var(name)
            if isinstance(v, (torch.Tensor, np.ndarray)) or np.isscalar(v):
                out[name] = to_np(v)
        return out

    def save(self, program, scope, step, executor=None, data_state=None,
             extra=None, block=False, chaos=None):
        """Snapshot now, write in the background; returns the claimed
        serial. ``block=True`` (preemption, end-of-run) waits for the
        commit and raises on write failure."""
        # serialize writers, keep order (GC stays async off this path)
        self.wait(raise_on_error=False, _drain_gc=False)
        # a PRIOR write's failure was already reported; it must not
        # resurface as THIS save's error at the next blocking wait
        self._write_error = None
        snap = self.collect(program, scope)
        state = build_train_state(step, executor=executor,
                                  data_state=data_state, extra=extra)
        serial, cur = _claim_serial_dir(self.dirname)
        self._last_save_t = time.monotonic()
        if self.async_write and not block:
            self._writer = threading.Thread(
                target=self._write_serial_guarded,
                args=(cur, serial, snap, state, chaos),
                name="checkpoint-writer", daemon=True)
            self._writer.start()
        else:
            self._write_serial(cur, serial, snap, state, chaos)
        if block:
            self.wait()
        return serial

    def _write_serial_guarded(self, cur, serial, snap, state, chaos):
        try:
            self._write_serial(cur, serial, snap, state, chaos)
        except BaseException as e:  # surfaced by wait(); training goes on
            self._write_error = e
            import sys
            sys.stderr.write("checkpoint: serial %d write failed: %s\n"
                             % (serial, e))

    def _write_serial(self, cur, serial, snap, state, chaos):
        from ..observability import catalog, liveness, runlog
        from . import chaos as chaos_mod
        t0 = time.perf_counter()
        for name, arrays in snap.items():
            path = os.path.join(cur, name)
            savez_exact(path, arrays)
            # tensor bytes stable BEFORE the manifest that vouches for
            # them; strict: an fsync failure must fail THIS save
            _fsync_path(path, strict=True)
        with open(os.path.join(cur, TRAIN_STATE_FILE), "w") as f:
            json.dump(state, f)
            f.flush()
            os.fsync(f.fileno())
        # chaos "save" boundary: tensors + TRAIN_STATE down, manifest not
        # yet — a kill9 HERE is the torn-serial case latest_valid skips
        chaos_mod.maybe_fire("save", chaos)
        manifest = {"trainer_id": 0, "timestamp": time.time(),
                    "step": state["step"], "md5": _checkpoint_manifest(cur)}
        _commit_manifest(self.dirname, cur, manifest)
        self.last_serial = serial
        catalog.CHECKPOINTS_SAVED.inc()
        catalog.CHECKPOINT_WRITE_SECONDS.inc(time.perf_counter() - t0)
        catalog.CHECKPOINT_LAST_STEP.set(state["step"])
        liveness.report_checkpoint(state["step"])
        log = runlog.get_run_log()
        if log is not None:
            log.write({"kind": "checkpoint", "step": state["step"],
                       "serial": serial, "dir": cur})
        self._trim(serial)

    def _trim(self, serial):
        """Hand the trim to the background GC worker (after ``serial``'s
        own manifest commit, so it can never reap the serial it
        follows)."""
        with self._gc_lock:
            if self._gc_thread is None or not self._gc_thread.is_alive():
                self._gc_thread = threading.Thread(
                    target=self._gc_worker, name="checkpoint-gc",
                    daemon=True)
                self._gc_thread.start()
            self._gc_queue.put(serial)

    def _gc_worker(self):
        """Drains trim requests; seconds land on checkpoint_gc_seconds
        (off the step path). Exits on the ``None`` sentinel close()
        sends after its drain."""
        from ..observability import catalog
        while True:
            serial = self._gc_queue.get()
            try:
                if serial is None:
                    return
                t0 = time.perf_counter()
                try:
                    _trim_old_serials(self.dirname, serial, self.keep)
                except Exception as e:  # GC must never kill training
                    import sys
                    sys.stderr.write("checkpoint: gc of serials older "
                                     "than %d failed: %s\n" % (serial, e))
                catalog.CHECKPOINT_GC_SECONDS.inc(time.perf_counter() - t0)
            finally:
                self._gc_queue.task_done()

    def _gc_drain(self):
        """Block until every enqueued trim has run (tests, close())."""
        with self._gc_lock:
            t = self._gc_thread
        if t is not None and t.is_alive():
            self._gc_queue.join()

    def wait(self, raise_on_error=True, _drain_gc=True):
        """Join the in-flight background write (no-op when idle) and, by
        default, the pending trims, so the directory reflects the keep
        policy."""
        w = self._writer
        if w is not None:
            w.join()
            self._writer = None
        if _drain_gc:
            self._gc_drain()
        if raise_on_error and self._write_error is not None:
            e, self._write_error = self._write_error, None
            raise e

    def close(self):
        self.wait(raise_on_error=False)
        with self._gc_lock:
            t, self._gc_thread = self._gc_thread, None
        if t is not None and t.is_alive():
            self._gc_queue.put(None)  # drained already; stop the worker
            t.join(timeout=5.0)

    # -- resume --------------------------------------------------------
    def latest_valid(self):
        """Newest (serial, train_state) whose manifest verifies; torn
        (manifest-less) and corrupt (md5-mismatched) serials are skipped
        with a warning. None when nothing is loadable. train_state is
        None for serials written without one (bare io.save_checkpoint)."""
        import warnings
        try:
            serials = sorted((int(s) for s in os.listdir(self.dirname)
                              if s.isdigit()), reverse=True)
        except OSError:
            return None
        for s in serials:
            cur = os.path.join(self.dirname, str(s))
            try:
                manifest = _verify_serial(cur)
                if manifest is None:  # torn: killed before the commit
                    raise IOError("no manifest (crash mid-save)")
                state = None
                if TRAIN_STATE_FILE in manifest["md5"]:
                    with open(os.path.join(cur, TRAIN_STATE_FILE)) as f:
                        state = json.load(f)
                return s, state
            except Exception as e:
                warnings.warn("checkpoint serial %d invalid (%s); trying "
                              "the previous one" % (s, e))
                continue
        return None

    def restore(self, scope, executor=None, serial=None):
        """Load the latest valid (or given) serial's tensors into
        ``scope`` (on the executor's device when one is given) and rewind
        the executor's step counter to the saved one (random draws fold
        it in — same counter, same trajectory). Returns the train_state
        dict (with ``"serial"`` added) or None when no valid checkpoint
        exists."""
        if serial is None:
            found = self.latest_valid()
            if found is None:
                return None
            serial, state = found
        else:
            cur = os.path.join(self.dirname, str(serial))
            state = None
            sp = os.path.join(cur, TRAIN_STATE_FILE)
            if os.path.exists(sp):
                with open(sp) as f:
                    state = json.load(f)
        cur = os.path.join(self.dirname, str(serial))
        device = executor.device if executor is not None else "cpu"
        for fn in sorted(os.listdir(cur)):
            if fn in ("_MANIFEST", TRAIN_STATE_FILE) or fn.endswith(".tmp"):
                continue
            path = os.path.join(cur, fn)
            if not os.path.isfile(path):
                continue
            with np.load(path, allow_pickle=False) as f:
                scope.set_var(fn, from_np(dict(f), device))
        state = dict(state) if state else {}
        state["serial"] = serial
        if executor is not None and "executor_step" in state:
            executor.set_step_counter(state["executor_step"])
        self.last_serial = serial
        return state
