"""Executor + Scope: run a Program block op by op on one device — the port
of ``paddle_tpu/executor.py``'s ``Scope``, ``trace_ops`` and
``Executor.run``.

The reference traces a block once into one jitted XLA computation; the
port runs the same lowerings eagerly (PyTorch dispatches each op's
kernels as it goes), so there is no compile step and no compile cache.
Parameters and optimizer state live in a :class:`Scope` as tensors on
the executor's device; a step reads the program's persistables from it
and writes back every persistable the step produced.
"""

import contextlib

import numpy as np
import torch

from .core import Place, torch_dtype
from .framework import default_main_program
from .registry import LoweringContext, get_op_info

__all__ = ["Executor", "Scope", "global_scope", "scope_guard", "trace_ops"]


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


def trace_ops(block, env, *, step_key=None, is_test=False, device=None):
    """Run every op of ``block`` over ``env`` (name → tensor), mutating and
    returning env. Each op runs inside a ``torch.profiler`` range named
    by its type, so a profile attributes host and device time per op
    type (a no-op unless a profiler is recording)."""
    amp = bool(getattr(block.program, "_amp", False))
    for op in block.ops:
        info = get_op_info(op.type)
        if info.lowering is None:
            continue
        ctx = LoweringContext(op, step_key=step_key, is_test=is_test,
                              device=device, amp=amp)
        ins = {slot: [env.get(n) if n else None for n in names]
               for slot, names in op.inputs.items()}
        with torch.profiler.record_function(op.type):
            outs = info.lowering(ctx, ins)
        for slot, names in op.outputs.items():
            for name, val in zip(names, outs.get(slot) or ()):
                if name and val is not None:
                    env[name] = val
    return env


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
                      is_test=program._is_test, device=self.device)
        for n in persist:
            if n in env:
                scope.set_var(n, env[n])
        missing = [n for n in fetch_names if n not in env]
        if missing:
            raise KeyError("fetch target(s) %r were never computed by the "
                           "program" % missing)
        fetched = [env[n] for n in fetch_names]
        return [_to_numpy(t) for t in fetched] if return_numpy else fetched
