"""Executor + Scope: run a Program block op by op on one device — the port
of ``paddle_tpu/executor.py``'s ``Scope``, ``trace_ops``,
``Executor.run`` and ``Executor.run_steps``.

The reference traces a block once into one jitted XLA computation; the
port's ``run`` runs the same lowerings eagerly (PyTorch dispatches each
op's kernels as it goes), so it has no compile step and no compile
cache. Parameters and optimizer state live in a :class:`Scope` as
tensors on the executor's device; a step reads the program's
persistables from it and writes back every persistable the step
produced. A step drops each intermediate after its last reader, as
XLA reuses a dead buffer.

``run_steps`` on the card captures one step as a CUDA graph and replays
it: the port's counterpart of the reference's on-device step loop (see
:meth:`Executor.run_steps`).
"""

import contextlib

import numpy as np
import torch

from .core import Place, torch_dtype
from .framework import default_main_program
from .registry import LoweringContext, get_op_info

__all__ = ["Executor", "Scope", "global_scope", "scope_guard", "trace_ops",
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
              drop=None, graphed=False):
    """Run every op of ``block`` over ``env`` (name → tensor), mutating and
    returning env. Each op runs inside a ``torch.profiler`` range named
    by its type, so a profile attributes host and device time per op
    type (a no-op unless a profiler is recording). ``drop[i]`` (see
    :func:`liveness`) lists the names to remove from env after op i;
    ``graphed`` marks a step being captured (``LoweringContext``)."""
    amp = bool(getattr(block.program, "_amp", False))
    for i, op in enumerate(block.ops):
        info = get_op_info(op.type)
        if info.lowering is not None:
            ctx = LoweringContext(op, step_key=step_key, is_test=is_test,
                                  device=device, amp=amp, graphed=graphed)
            ins = {slot: [env.get(n) if n else None for n in names]
                   for slot, names in op.inputs.items()}
            with torch.profiler.record_function(op.type):
                outs = info.lowering(ctx, ins)
            for slot, names in op.outputs.items():
                for name, val in zip(names, outs.get(slot) or ()):
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
    t = t.detach()
    if t.dtype == torch.bfloat16:   # numpy has no bfloat16: widen exactly
        t = t.float()
    return t.cpu().numpy()


class Executor:
    """``run(program, feed, fetch_list)``: convert feeds to tensors on the
    executor's device, run the block's ops, write updated persistables
    back to the scope, return the fetched values (numpy by default).

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
        self._drops = {}        # liveness plans by (program, version, keep)
        self._graphs = {}       # run_steps' captured steps by their key

    def _drop_plan(self, program, keep):
        key = (program._uid, program._version, frozenset(keep))
        if key not in self._drops:
            self._drops[key] = liveness(program.global_block(), keep)
        return self._drops[key]

    def _convert_feed(self, program, feed):
        block = program.global_block()
        out = {}
        for name, val in (feed or {}).items():
            var = block.vars.get(name)
            t = val if isinstance(val, torch.Tensor) else \
                torch.as_tensor(np.asarray(val))
            dtype = torch_dtype(var.dtype) if var is not None and \
                var.dtype is not None else t.dtype
            # int ids arrive as int32 or int64 alike: cast to the var's
            out[name] = t.to(device=self.device, dtype=dtype)
        return out

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        program = program or default_main_program()
        scope = scope or global_scope()
        fetch_names = [f if isinstance(f, str) else f.name
                       for f in (fetch_list or [])]
        block = program.global_block()
        persist = [n for n, v in block.vars.items() if v.persistable]
        env = {}
        for n in persist:
            val = scope.find_var(n)
            if val is None:
                continue
            env[n] = (val if isinstance(val, torch.Tensor)
                      else torch.as_tensor(np.asarray(val))).to(self.device)
        env.update(self._convert_feed(program, feed))
        step_key = (program.random_seed or 0, self._step)
        self._step += 1
        with torch.no_grad():
            trace_ops(block, env, step_key=step_key,
                      is_test=program._is_test, device=self.device,
                      drop=self._drop_plan(program,
                                           set(persist) | set(fetch_names)))
        for n in persist:
            if n in env:
                scope.set_var(n, env[n])
        missing = [n for n in fetch_names if n not in env]
        if missing:
            raise KeyError("fetch target(s) %r were never computed by the "
                           "program" % missing)
        fetched = [env[n] for n in fetch_names]
        return [_to_numpy(t) for t in fetched] if return_numpy else fetched

    def run_steps(self, program=None, feed=None, n_steps=1, fetch_list=None,
                  scope=None, return_numpy=True):
        """Run ``n_steps`` steps of ``program`` with ``feed`` held constant
        and return the last step's fetches; the scope afterwards holds
        what ``n_steps`` calls to :meth:`run` would leave. Programs with
        host-side ops are refused.

        On the card the step is captured as one CUDA graph and replayed:
        every persistable the block reads or writes, and every feed, is
        a static tensor on the device; the captured step reads only
        those and ends by copying each persistable it produced into its
        static tensor, so a replay carries the state to the next with no
        host work. The first call for a program, feed signature, fetch
        list, written state, ``is_test`` and amp runs step 1 eagerly on
        a side stream (cuDNN picks its algorithms, lowerings build what
        they cache), captures step 2 and replays it ``n_steps`` − 1
        times; later calls replay ``n_steps`` times after copying their
        feed (and any state a ``run`` call replaced in the scope) into
        the static tensors. A random op raises: a graph would repeat one
        step's draws. A failure to capture raises — the step is never
        run eagerly instead.

        On the CPU there is nothing to capture: ``n_steps`` calls to
        :meth:`run`."""
        program = program or default_main_program()
        scope = scope or global_scope()
        n_steps = int(n_steps)
        if n_steps < 1:
            raise ValueError("n_steps must be >= 1 (got %d)" % n_steps)
        fetch_names = [f if isinstance(f, str) else f.name
                       for f in (fetch_list or [])]
        block = program.global_block()
        host = sorted({op.type for op in block.ops
                       if get_op_info(op.type).host})
        if host:
            raise RuntimeError(
                "run_steps cannot capture programs with host-side ops (%s) "
                "— use run() per step" % ", ".join(host))
        if self.device.type != "cuda":
            for _ in range(n_steps):
                out = self.run(program, feed, fetch_names, scope,
                               return_numpy)
            return out
        feed_vals = self._convert_feed(program, feed)
        persist = {n for n, v in block.vars.items() if v.persistable}
        read = {n for op in block.ops for n in _names(op.inputs)}
        written = sorted(persist & {n for op in block.ops
                                    for n in _names(op.outputs)})
        key = (program._uid, program._version,
               tuple((n, tuple(t.shape), str(t.dtype))
                     for n, t in sorted(feed_vals.items())),
               tuple(fetch_names), tuple(written), program._is_test,
               bool(getattr(program, "_amp", False)))
        step = self._graphs.get(key)
        if step is None:
            step = _CapturedStep(self, program, scope, feed_vals,
                                 fetch_names, sorted(persist & read),
                                 written)
            fetched = step.first(n_steps)
            self._graphs[key] = step
        else:
            fetched = step.replay(scope, feed_vals, n_steps)
        self._step += n_steps
        for n, t in step.state.items():
            scope.set_var(n, t)
        fetched = [t.clone() for t in fetched]
        return [_to_numpy(t) for t in fetched] if return_numpy else fetched


class _CapturedStep:
    """One program step captured as a CUDA graph over static tensors
    (``state``: persistables by name; ``feed``: feeds by name), and the
    fetch tensors its replays write."""

    def __init__(self, exe, program, scope, feed_vals, fetch_names, reads,
                 written):
        self.exe, self.program = exe, program
        self.fetch_names, self.written = fetch_names, written
        self.state = {}
        for n in sorted(set(reads) | set(written)):
            val = scope.find_var(n)
            if val is None:
                if n in reads:
                    raise KeyError("run_steps: persistable %r is read by "
                                   "the program but not in the scope" % n)
                continue
            val = val if isinstance(val, torch.Tensor) \
                else torch.as_tensor(np.asarray(val))
            self.state[n] = val.to(exe.device, copy=True)
        self.feed = {n: t.clone() for n, t in feed_vals.items()}
        self.drop = exe._drop_plan(program, set(self.state) |
                                   set(written) | set(fetch_names))
        self.graph = None
        self.fetches = None

    def _step(self, step_key):
        """One step over the static tensors: trace the block, copy each
        persistable it wrote into its static tensor; the fetches."""
        env = dict(self.state)
        env.update(self.feed)
        with torch.no_grad():
            trace_ops(self.program.global_block(), env, step_key=step_key,
                      is_test=self.program._is_test, device=self.exe.device,
                      drop=self.drop, graphed=True)
            for n in self.written:
                if n not in env:
                    continue
                if n in self.state:
                    self.state[n].copy_(env[n])
                else:           # first written here: its static tensor
                    self.state[n] = env[n].clone()
        missing = [n for n in self.fetch_names if n not in env]
        if missing:
            raise KeyError("fetch target(s) %r were never computed by the "
                           "program" % missing)
        return [env[n] for n in self.fetch_names]

    def first(self, n_steps):
        """Step 1 eagerly on a side stream, then the capture of step 2 and
        n_steps − 1 replays of it."""
        exe = self.exe
        seed = self.program.random_seed or 0
        side = torch.cuda.Stream(device=exe.device)
        side.wait_stream(torch.cuda.current_stream(exe.device))
        with torch.cuda.stream(side):
            warm = self._step((seed, exe._step))
        torch.cuda.current_stream(exe.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # thread_local: CUDA calls of the process's other threads (a
        # server's) do not invalidate this thread's capture
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self.fetches = self._step((seed, exe._step + 1))
        self.graph = graph
        graph_launches["captures"] += 1
        if n_steps == 1:
            return warm
        return self._replays(n_steps - 1)

    def replay(self, scope, feed_vals, n_steps):
        """Load the feed, and any state the scope holds in other tensors
        (a ``run`` call replaces them), into the static tensors; then
        ``n_steps`` replays."""
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
                self.feed[n].copy_(t)
        return self._replays(n_steps)

    def _replays(self, n):
        for _ in range(n):
            self.graph.replay()
            graph_launches["replays"] += 1
        return self.fetches
