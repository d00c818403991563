"""Executor + Scope: run a Program block op by op on one device — the port
of ``paddle_tpu/executor.py``'s ``Scope``, ``trace_ops``, ``FetchHandle``,
the execution plan, and ``Executor.run`` / ``run_steps`` with their step
telemetry.

The reference traces a block once into one jitted XLA computation; the
port's ``run`` runs the same lowerings eagerly (PyTorch dispatches each
op's kernels as it goes), so it compiles nothing: its cache holds step
plans (what to read, write and drop), keyed as the reference keys its
compile cache, and a miss or a hit is reported the same way
(``observability.steps``). Parameters and optimizer state live in a
:class:`Scope` as tensors on the executor's device; a step reads the
program's persistables from it and writes back every persistable the
step produced. A step drops each intermediate after its last reader, as
XLA reuses a dead buffer.

``run_steps`` on the card captures one step as a CUDA graph and replays
it: the port's counterpart of the reference's on-device step loop (see
:meth:`Executor.run_steps`).

A ragged feed (a ``core.LoDArray``, or a list of per-sequence arrays for
a ``lod_level=1`` var) becomes a ``LoDArray`` of device tensors; its
padded shape, not its lengths, keys the caches, so new lengths at one
padded shape reuse a step plan or a captured step. A ragged fetch comes
back as a ``LoDArray`` of numpy arrays.
"""

import contextlib
import threading
import time

import numpy as np
import torch
import torch.utils._pytree as pytree

from . import flags, profiler
from .core import LoDArray, Place, torch_dtype
from .framework import VarType, default_main_program
from .observability import flight_recorder, steps as step_telemetry
from .ops import launch_count
from .registry import LoweringContext, get_op_info

__all__ = ["Executor", "FetchHandle", "Scope", "global_scope",
           "scope_guard", "trace_ops", "program_exec_plan",
           "graph_launches"]

# run_steps' telemetry, counted as the kernel wrappers count launches:
# CUDA graphs captured and graph replays
graph_launches = {"captures": 0, "replays": 0}


class Scope:
    """Name → value store for persistable variables."""

    def __init__(self):
        self.vars = {}

    def find_var(self, name):
        return self.vars.get(name)

    def set_var(self, name, value):
        self.vars[name] = value

    def local_var_names(self):
        return list(self.vars)


_current_scope = [Scope()]


def global_scope():
    return _current_scope[-1]


@contextlib.contextmanager
def scope_guard(scope):
    _current_scope.append(scope)
    try:
        yield
    finally:
        _current_scope.pop()


def trace_ops(block, env, *, step_key=None, is_test=False, device=None,
              drop=None, fetch_names=None):
    """Run every op of ``block`` over ``env`` (name → tensor or
    ``LoDArray``), mutating and returning env. Each op runs inside a
    ``torch.profiler`` range named by its type, so a profile attributes
    host and device time per op type (a no-op unless a profiler is
    recording). ``drop[i]`` (see :func:`liveness`) lists the names to
    remove from env after op i. ``fetch_names``: the step's fetch
    targets, when known — a lowering may skip an output that nothing
    reads (``registry.output_consumed``)."""
    amp = bool(getattr(block.program, "_amp", False))
    for i, op in enumerate(block.ops):
        info = get_op_info(op.type)
        if info.lowering is not None:
            ctx = LoweringContext(op, step_key=step_key, is_test=is_test,
                                  device=device, amp=amp)
            ctx.block, ctx.fetch_names = block, fetch_names
            ins = {slot: [env.get(n) if n else None for n in names]
                   for slot, names in op.inputs.items()}
            with torch.profiler.record_function(op.type):
                outs = info.lowering(ctx, ins)
            for slot, names in op.outputs.items():
                for name, val in zip(names, (outs or {}).get(slot) or ()):
                    if name and val is not None:
                        env[name] = val
        for name in drop[i] if drop is not None else ():
            env.pop(name, None)
    return env


def _names(slots):
    """The variable names of an op's ``inputs`` or ``outputs``."""
    return [n for names in slots.values() for n in names if n]


def liveness(block, keep):
    """Per op of ``block``, the names that op reads or writes last, less
    ``keep`` (the persistables and fetch targets): the executor drops
    them from its env after that op, so the step frees each intermediate
    — an activation, a gradient — once nothing reads it."""
    last = {}
    for i, op in enumerate(block.ops):
        for n in _names(op.inputs) + _names(op.outputs):
            last[n] = i
    drop = [[] for _ in block.ops]
    for n, i in last.items():
        if n not in keep:
            drop[i].append(n)
    return drop


def _to_numpy(t):
    """Host copy of a fetch: a numpy array, or a ``LoDArray`` of them."""
    if isinstance(t, LoDArray):
        return LoDArray(_to_numpy(t.data), _to_numpy(t.length))
    t = t.detach()
    if t.dtype == torch.bfloat16:   # numpy has no bfloat16: widen exactly
        t = t.float()
    return t.cpu().numpy()


def _host_copy(v):
    """A fresh copy of one host fetch value."""
    if isinstance(v, LoDArray):
        return LoDArray(v.data.copy(), v.length.copy())
    return v.copy()


def normalize_ragged_sequences(col, var_shape, dtype):
    """One ragged feed column in the runtime layout (the reference's
    ``data_feeder.normalize_ragged_sequences``): integer ids declared
    ``[-1, 1]`` are token-scalar ``(L,)`` sequences; other vars keep
    their per-token feature dims, a scalar float sequence gaining the
    ``(1,)`` its var declares."""
    seqs = [np.asarray(s, dtype=dtype) for s in col]
    scalar_decl = var_shape and len(var_shape) >= 2 and var_shape[-1] == 1
    if seqs and seqs[0].ndim == 1 and scalar_decl and \
            not np.issubdtype(np.dtype(dtype), np.integer):
        seqs = [s[:, None] for s in seqs]
    if seqs and seqs[0].ndim >= 2 and seqs[0].shape[-1] == 1 and \
            np.issubdtype(np.dtype(dtype), np.integer) and scalar_decl:
        seqs = [s[..., 0] for s in seqs]
    return seqs


def _fetch_from_env(env, fetch_names):
    missing = [n for n in fetch_names if n not in env]
    if missing:
        raise KeyError("fetch target(s) %r were never computed by the "
                       "program" % missing)
    return [env[n] for n in fetch_names]


class FetchHandle:
    """Non-blocking fetch result (``run(..., return_numpy=False)``): the
    device tensors of a step's fetch list, with a CUDA event recorded on
    the stream after them, so the caller can prepare the next step while
    this one runs.

    Sequence-compatible — ``len``, indexing and iteration yield the
    device tensors. ``numpy()`` performs the host sync (counted once in
    the ``device_wait_s`` pipeline counter) and gives a fresh host copy on
    every call, bitwise what ``run(return_numpy=True)`` returns;
    ``block_until_ready()`` waits without downloading. The tensors are
    the handle's own: a later ``run_steps`` round does not overwrite
    them."""

    def __init__(self, names, values):
        self.names = list(names)
        self._values = list(values)
        self._numpy = None
        self._sync_lock = threading.Lock()
        self._event = None
        devs = {v.device for v in pytree.tree_leaves(self._values)
                if v.device.type == "cuda"}
        if devs:
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(devs.pop()))

    def __len__(self):
        return len(self._values)

    def __getitem__(self, i):
        return self._values[i]

    def __iter__(self):
        return iter(self._values)

    def _wait(self):
        try:
            if self._event is not None:
                self._event.synchronize()
        except Exception:
            # asynchronous device failures surface at the host sync —
            # dump the flight recorder here too
            flight_recorder.dump_on_crash("fetch_sync")
            raise

    def block_until_ready(self):
        """Wait for the device computation, leaving results on device."""
        t0 = time.perf_counter()
        self._wait()
        profiler.incr_counter("device_wait_s", time.perf_counter() - t0)
        return self

    def numpy(self):
        """Host copies of the fetches. The device sync happens once and is
        thread-safe; every call returns its own fresh arrays."""
        with self._sync_lock:
            if self._numpy is None:
                t0 = time.perf_counter()
                self._wait()
                self._numpy = [_to_numpy(v) for v in self._values]
                profiler.incr_counter("device_wait_s",
                                      time.perf_counter() - t0)
        return [_host_copy(v) for v in self._numpy]

    def __repr__(self):
        return "FetchHandle(%s)" % ", ".join(self.names)


def _python_exec_plan(program):
    """Host-op presence, the persistables (sorted) and the persistables
    the program's ops write, in first-write order."""
    persist = set()
    created = []
    created_seen = set()
    has_host = False
    for blk in program.blocks:
        for name, v in blk.vars.items():
            if v.persistable and v.type == VarType.LOD_TENSOR:
                persist.add(name)
    for blk in program.blocks:
        for op in blk.ops:
            if get_op_info(op.type).host:
                has_host = True
            for name in op.all_output_vars():
                if name in created_seen:
                    continue
                v = blk._find_var_recursive(name)
                if v is not None and v.persistable and \
                        v.type == VarType.LOD_TENSOR:
                    created_seen.add(name)
                    created.append(name)
    return {"has_host_ops": has_host, "persistables": sorted(persist),
            "created_persistables": created}


def program_exec_plan(program):
    """The execution plan of ``program``'s current version, cached on the
    program (the reference's Python spec; its native tier is not
    ported)."""
    cached = getattr(program, "_exec_plan", None)
    if cached is not None and cached[0] == program._version:
        return cached[1]
    plan = _python_exec_plan(program)
    program._exec_plan = (program._version, plan)
    return plan


def _feed_signature(feed_vals):
    """The feeds' names, shapes and dtypes; a ragged feed by its padded
    shape (its lengths are data, not part of the key)."""
    sig = []
    for name in sorted(feed_vals):
        v = feed_vals[name]
        sig.append((name, "lod", tuple(v.data.shape), str(v.data.dtype))
                   if isinstance(v, LoDArray) else
                   (name, tuple(v.shape), str(v.dtype)))
    return tuple(sig)


def _host_ops(program):
    return sorted({op.type for op in program.global_block().ops
                   if get_op_info(op.type).host})


class Executor:
    """``run(program, feed, fetch_list)``: convert feeds to tensors on the
    executor's device, run the block's ops, write updated persistables
    back to the scope, return the fetched values (numpy by default, a
    :class:`FetchHandle` with ``return_numpy=False``).

    ``Executor()`` and ``Executor(CUDAPlace(i))`` run on the card and raise
    when there is none; ``Executor(CPUPlace())`` runs on the CPU."""

    def __init__(self, place=None):
        self.place = place if isinstance(place, Place) else None
        if place is not None and self.place is None:
            raise TypeError("place must be a CPUPlace or CUDAPlace "
                            "(got %r)" % (place,))
        from . import resolve_device
        self.device = resolve_device(None) if self.place is None \
            else self.place.torch_device()
        self._step = 0
        # step plans by the reference's compile-cache key; run_steps'
        # captured steps by theirs (without n_steps: one capture serves
        # every round length)
        self._cache = {}
        self._graphs = {}
        # per program version: the static state its captured steps share
        # and their graph memory pool
        self._static = {}
        self._pools = {}
        # program _uid -> the config of its last miss, so a miss can name
        # what changed (observability.steps.attribute_cache_miss)
        self._seen = {}
        # concurrent run() safety: guards the step counter, the caches
        # and the scope write-back
        self._lock = threading.Lock()

    # -- the step's prologue -----------------------------------------
    def _tensor(self, val, var):
        t = val if isinstance(val, torch.Tensor) else \
            torch.as_tensor(np.asarray(val))
        dtype = torch_dtype(var.dtype) if var is not None and \
            var.dtype is not None else t.dtype
        # int ids arrive as int32 or int64 alike: cast to the var's
        return t.to(device=self.device, dtype=dtype)

    def _convert_feed(self, program, feed):
        """The feeds as tensors (or ``LoDArray``s of tensors) on the
        executor's device; real and padding tokens of host ragged feeds
        are counted (``real_tokens``, ``pad_tokens``)."""
        block = program.global_block()
        out = {}
        for name, val in (feed or {}).items():
            var = block.vars.get(name)
            if isinstance(val, (list, tuple)) and var is not None and \
                    var.lod_level > 0:
                dtype = np.dtype(var.dtype) if var.dtype else np.float32
                val = LoDArray.from_sequences(
                    normalize_ragged_sequences(val, var.shape, dtype),
                    dtype=dtype)
            if isinstance(val, LoDArray):
                if not isinstance(val.length, torch.Tensor):
                    # host lengths: counting them costs no device sync
                    real = float(np.sum(val.length))
                    profiler.incr_counter("real_tokens", real)
                    profiler.incr_counter(
                        "pad_tokens",
                        float(np.shape(val.length)[0] * val.max_len) - real)
                out[name] = LoDArray(
                    self._tensor(val.data, var),
                    torch.as_tensor(val.length).to(device=self.device,
                                                   dtype=torch.int32))
            else:
                out[name] = self._tensor(val, var)
        return out

    def _prepare(self, program, feed, scope):
        """Feed conversion (timed into ``feed_wait_s``) and the step's
        persistables: those the scope holds, then those the program
        creates. Returns (feed_vals, feed_wait_s, param_names,
        out_param_names)."""
        t0 = time.perf_counter()
        feed_vals = self._convert_feed(program, feed)
        dt = time.perf_counter() - t0
        profiler.incr_counter("feed_wait_s", dt)
        plan = program_exec_plan(program)
        param_names = [n for n in plan["persistables"]
                       if scope.find_var(n) is not None]
        have = set(param_names)
        created = [n for n in plan["created_persistables"] if n not in have]
        return feed_vals, dt, param_names, param_names + created

    def _lookup(self, cache, key, cfg, program, build):
        """The cached entry of ``key``, or ``build()`` it: a miss,
        attributed to what changed since the program's last miss.
        Returns (entry, "hit" | "miss", cause, build seconds)."""
        entry = cache.get(key)
        if entry is not None:
            return entry, "hit", None, 0.0
        with self._lock:
            entry = cache.get(key)
            if entry is not None:
                return entry, "hit", None, 0.0
            cause = step_telemetry.attribute_cache_miss(
                self._seen.get(program._uid), cfg)
            self._seen[program._uid] = cfg
            t0 = time.perf_counter()
            entry = build()
            cache[key] = entry
            return entry, "miss", cause, time.perf_counter() - t0

    @staticmethod
    def _key_cfg(program, feed_vals, fetch_names, out_param_names,
                 n_steps):
        key = (program._uid, program._version, _feed_signature(feed_vals),
               tuple(fetch_names), tuple(out_param_names), program._is_test,
               bool(getattr(program, "_amp", False)))
        cfg = {"program_version": key[1], "feed_signature": key[2],
               "fetch_list": key[3], "param_set": key[4],
               "mode": key[5:7], "n_steps": n_steps}
        return key, cfg

    @staticmethod
    def _nan_check(fetch_names, fetched, out_param_names, scope):
        """FLAGS_check_nan_inf: scan the fetches and the updated state;
        forces a host sync."""
        def _scan(name, v):
            if isinstance(v, LoDArray):
                v = v.data
            if not isinstance(v, torch.Tensor) or \
                    not torch.is_floating_point(v):
                return
            if not bool(torch.isfinite(v).all()):
                raise FloatingPointError(
                    "NaN/Inf detected in %r (FLAGS_check_nan_inf)" % name)
        for name, v in zip(fetch_names, fetched):
            _scan(name, v)
        for n in out_param_names:
            _scan(n, scope.find_var(n))

    def _package_fetches(self, fetched, fetch_names, return_numpy):
        """Blocking path: host numpy copies (sync time → ``device_wait_s``).
        Non-blocking: a :class:`FetchHandle` over the device values."""
        if not return_numpy:
            return FetchHandle(fetch_names, fetched)
        t0 = time.perf_counter()
        out = [_to_numpy(t) for t in fetched]
        profiler.incr_counter("device_wait_s", time.perf_counter() - t0)
        return out

    def _envelope(self, step, body):
        """Run ``body()`` inside the crash envelope: on a failure the
        flight recorder is dumped and the run log gets an error record
        before the exception reaches the caller."""
        try:
            return body()
        except Exception as e:
            dump = flight_recorder.dump_on_crash("step%d" % step)
            step_telemetry.emit_step_error(step, e, trace_dump=dump)
            raise

    # -- run -----------------------------------------------------------
    def _step_once(self, program, scope, feed_vals, fetch_names,
                   param_names, out_param_names, drop, step):
        """One eager step at executor step ``step``: trace the block over
        the scope's persistables and the feeds (dropping intermediates by
        ``drop``), write back the persistables it produced; the fetched
        tensors."""
        env = {}
        for n in param_names:
            val = scope.find_var(n)
            env[n] = (val if isinstance(val, torch.Tensor)
                      else torch.as_tensor(np.asarray(val))).to(self.device)
        env.update(feed_vals)
        with torch.no_grad():
            trace_ops(program.global_block(), env,
                      step_key=(program.random_seed or 0, step),
                      is_test=program._is_test, device=self.device,
                      drop=drop, fetch_names=fetch_names)
        with self._lock:
            for n in out_param_names:
                if n in env:
                    scope.set_var(n, env[n])
        return _fetch_from_env(env, fetch_names)

    def _plan(self, cache, program, feed_vals, fetch_names,
              out_param_names, n_steps):
        """The eager step's cached liveness plan (``run``, and
        ``run_steps`` on the CPU): (drop plan, "hit" | "miss", cause,
        build seconds)."""
        key, cfg = self._key_cfg(program, feed_vals, fetch_names,
                                 out_param_names, n_steps)
        keep = set(out_param_names) | set(fetch_names)
        return self._lookup(cache, key, cfg, program,
                            lambda: liveness(program.global_block(), keep))

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        program = program or default_main_program()
        scope = scope or global_scope()
        fetch_names = [f if isinstance(f, str) else f.name
                       for f in (fetch_list or [])]
        feed_vals, feed_s, param_names, out_param_names = \
            self._prepare(program, feed, scope)
        with self._lock:
            step = self._step
            self._step += 1
        t0 = time.perf_counter()

        def body():
            drop, cache, cause, build_s = self._plan(
                self._cache, program, feed_vals, fetch_names,
                out_param_names, 1)
            with profiler.record_event("run_block"):
                fetched = self._step_once(program, scope, feed_vals,
                                          fetch_names, param_names,
                                          out_param_names, drop, step)
            return self._finish(scope, fetched, fetch_names,
                                out_param_names, return_numpy, cache, cause,
                                build_s, t0)

        packaged, cache, cause, build_s, dispatch_s = \
            self._envelope(step, body)
        step_telemetry.emit_step(step, feed_wait_s=feed_s,
                                 compile_s=build_s, dispatch_s=dispatch_s,
                                 cache=cache, cause=cause)
        return packaged

    def _finish(self, scope, fetched, fetch_names, out_param_names,
                return_numpy, cache, cause, build_s, t0):
        """The step's epilogue inside the envelope: the NaN scan, then the
        packaged fetches beside the telemetry fields."""
        if flags.check_nan_inf:
            self._nan_check(fetch_names, fetched, out_param_names, scope)
        dispatch_s = time.perf_counter() - t0 - build_s
        return (self._package_fetches(fetched, fetch_names, return_numpy),
                cache, cause, build_s, dispatch_s)

    # -- run_steps -----------------------------------------------------
    def run_steps(self, program=None, feed=None, n_steps=1, fetch_list=None,
                  scope=None, return_numpy=True):
        """Run ``n_steps`` steps of ``program`` with ``feed`` held constant
        and return the last step's fetches; the scope afterwards holds
        what ``n_steps`` calls to :meth:`run` would leave, and random ops
        draw what those calls would draw. Programs with host-side ops are
        refused.

        On the card the step is captured as one CUDA graph and replayed:
        every persistable the block reads or writes, every feed and the
        step counter the random ops read are static tensors on the
        device; the captured step reads only those and ends by copying
        each persistable it produced into its static tensor and adding
        one to the step counter, so a replay carries the state to the
        next with no host work. The first call for a program, feed
        signature, fetch list, persistable set, ``is_test`` and amp runs
        step 1 eagerly on a side stream (cuDNN picks its algorithms,
        lowerings build what they cache), captures step 2 and replays it
        ``n_steps`` − 1 times (a cache miss); later calls replay
        ``n_steps`` times after copying their feed, the executor's step
        and any state a ``run`` call replaced in the scope into the
        static tensors (a hit: ``n_steps`` is not part of the key). A
        failure to capture raises — the step is never run eagerly
        instead. The captures of one program (a feed of another padded
        shape is another capture) share their static state and one
        graph memory pool, so switching between them copies nothing.

        On the CPU there is nothing to capture: the step plan runs
        ``n_steps`` times, as ``n_steps`` calls to :meth:`run` would."""
        program = program or default_main_program()
        scope = scope or global_scope()
        n_steps = int(n_steps)
        if n_steps < 1:
            raise ValueError("n_steps must be >= 1 (got %d)" % n_steps)
        fetch_names = [f if isinstance(f, str) else f.name
                       for f in (fetch_list or [])]
        host = _host_ops(program)
        if host:
            raise RuntimeError(
                "run_steps cannot capture programs with host-side ops (%s) "
                "— use run() per step" % ", ".join(host))
        feed_vals, feed_s, param_names, out_param_names = \
            self._prepare(program, feed, scope)
        with self._lock:
            start = self._step
            self._step += n_steps
        t0 = time.perf_counter()

        def body():
            if self.device.type != "cuda":
                drop, cache, cause, build_s = self._plan(
                    self._graphs, program, feed_vals, fetch_names,
                    out_param_names, n_steps)
                with profiler.record_event("run_block_steps"):
                    for i in range(n_steps):
                        fetched = self._step_once(
                            program, scope, feed_vals, fetch_names,
                            param_names, out_param_names, drop, start + i)
                return self._finish(scope, fetched, fetch_names,
                                    out_param_names, return_numpy, cache,
                                    cause, build_s, t0)
            key, cfg = self._key_cfg(program, feed_vals, fetch_names,
                                     out_param_names, n_steps)
            captured, cache, cause, build_s = self._lookup(
                self._graphs, key, cfg, program,
                lambda: _CapturedStep(self, program, scope, feed_vals,
                                      fetch_names, start))
            with profiler.record_event("run_block_steps"):
                if cache == "miss":
                    fetched = captured.warm if n_steps == 1 else \
                        captured.replays(n_steps - 1)
                else:
                    fetched = captured.replay(scope, feed_vals, start,
                                              n_steps)
                with self._lock:
                    for n, t in captured.state.items():
                        scope.set_var(n, t)
                # the handle's own tensors: the next round's replays
                # overwrite the graph's fetch tensors
                fetched = [pytree.tree_map(torch.clone, t)
                           for t in fetched]
            return self._finish(scope, fetched, fetch_names,
                                out_param_names, return_numpy, cache, cause,
                                build_s, t0)

        packaged, cache, cause, build_s, dispatch_s = \
            self._envelope(start, body)
        step_telemetry.emit_step(start, n_steps=n_steps, feed_wait_s=feed_s,
                                 compile_s=build_s, dispatch_s=dispatch_s,
                                 cache=cache, cause=cause)
        return packaged

    @property
    def step_counter(self):
        """The monotone step index random draws fold in. Checkpoints
        bundle it so a resumed run continues the same random trajectory
        (``robustness.CheckpointManager``)."""
        return self._step

    def set_step_counter(self, value):
        """Rewind/advance the step counter (checkpoint restore)."""
        with self._lock:
            self._step = int(value)

    def close(self):
        """Drop the cached step plans and the captured graphs (after a
        device sync: a graph may still be replaying), which frees their
        memory pools."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        with self._lock:
            self._cache.clear()
            self._graphs.clear()
            self._static.clear()
            self._pools.clear()


class _CapturedStep:
    """One program step captured as a CUDA graph over static tensors
    (``state``: persistables by name; ``feed``: feeds by name; ``step_t``:
    the executor step the random ops read, an int64 scalar), and the
    fetch tensors its replays write. ``recorded`` (a
    ``launch_count.Capture``) holds the kernel calls the capture
    recorded and the host buffers the graph reads."""

    def __init__(self, exe, program, scope, feed_vals, fetch_names, start):
        self.exe, self.program = exe, program
        self.fetch_names = fetch_names
        block = program.global_block()
        persist = {n for n, v in block.vars.items() if v.persistable}
        reads = persist & {n for op in block.ops for n in _names(op.inputs)}
        self.written = sorted(persist & {n for op in block.ops
                                         for n in _names(op.outputs)})
        # the program's static state, shared by its captures (one a padded
        # shape): a switch of shapes copies nothing
        self.shared = exe._static.setdefault(
            (program._uid, program._version), {})
        self.state = {}
        for n in sorted(reads | set(self.written)):
            val = scope.find_var(n)
            if val is not None and not isinstance(val, torch.Tensor):
                val = torch.as_tensor(np.asarray(val))
            t = self.shared.get(n)
            if t is not None:
                if val is not None and val is not t:
                    t.copy_(val)
                self.state[n] = t
            elif val is not None:
                self.state[n] = self.shared[n] = val.to(exe.device,
                                                        copy=True)
            elif n in reads:
                raise KeyError("run_steps: persistable %r is read by the "
                               "program but not in the scope" % n)
        self.feed = {n: pytree.tree_map(torch.clone, t)
                     for n, t in feed_vals.items()}
        self.step_t = torch.zeros((), dtype=torch.int64, device=exe.device)
        self.drop = liveness(block, set(self.state) | set(self.written) |
                             set(fetch_names))
        self.recorded = launch_count.Capture()
        self.warm = self._capture(start)

    def _step(self):
        """One step over the static tensors: trace the block at the step
        ``step_t`` holds, copy each persistable it wrote into its static
        tensor, advance ``step_t``; the fetches."""
        env = dict(self.state)
        env.update(self.feed)
        with torch.no_grad():
            trace_ops(self.program.global_block(), env,
                      step_key=(self.program.random_seed or 0, self.step_t),
                      is_test=self.program._is_test, device=self.exe.device,
                      drop=self.drop, fetch_names=self.fetch_names)
            for n in self.written:
                if n not in env:
                    continue
                if n in self.state:
                    self.state[n].copy_(env[n])
                else:           # first written here: its static tensor
                    self.state[n] = self.shared[n] = env[n].clone()
            self.step_t.add_(1)
        return _fetch_from_env(env, self.fetch_names)

    def _capture(self, start):
        """Step ``start`` eagerly on a side stream, then the capture of
        step ``start + 1`` (its replays run it); the eager step's
        fetches."""
        dev = self.exe.device
        self.step_t.fill_(start)
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            warm = self._step()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # one memory pool for the program's captures: they replay one at
        # a time on one stream, and what outlives a replay (state, feeds,
        # fetches) is allocated outside it or stays allocated
        pool = self.exe._pools.setdefault(
            (self.program._uid, self.program._version),
            torch.cuda.graph_pool_handle())
        # thread_local: CUDA calls of the process's other threads (a
        # server's) do not invalidate this thread's capture
        with self.recorded, \
                torch.cuda.graph(graph, pool=pool,
                                 capture_error_mode="thread_local"):
            self.fetches = self._step()
        self.graph = graph
        graph_launches["captures"] += 1
        return warm

    def replay(self, scope, feed_vals, start, n_steps):
        """Load the feed, the executor's step, and any state the scope
        holds in other tensors (``run`` and a checkpoint restore replace
        them) into the static tensors; then ``n_steps`` replays."""
        for n, t in self.state.items():
            val = scope.find_var(n)
            if val is None or val is t:
                continue
            val = val if isinstance(val, torch.Tensor) \
                else torch.as_tensor(np.asarray(val))
            if tuple(val.shape) != tuple(t.shape) or val.dtype != t.dtype:
                raise ValueError(
                    "run_steps: the scope's %r is %s %s, the captured "
                    "step's %s %s" % (n, tuple(val.shape), val.dtype,
                                      tuple(t.shape), t.dtype))
            t.copy_(val)
        for n, t in feed_vals.items():
            if t is not self.feed[n]:
                # a ragged feed: its data and its lengths
                for dst, src in zip(pytree.tree_leaves(self.feed[n]),
                                    pytree.tree_leaves(t)):
                    dst.copy_(src)
        self.step_t.fill_(start)
        return self.replays(n_steps)

    def replays(self, n):
        for _ in range(n):
            self.graph.replay()
            graph_launches["replays"] += 1
        self.recorded.replayed(n)
        return self.fetches
