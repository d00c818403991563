"""The IR: Program / Block / Operator / Variable, built by the layers DSL —
the port of ``paddle_tpu/framework.py``, trimmed to the training slice
(one global block, dense tensors; no control-flow blocks, LoD,
serialization or pruning yet).

Shape inference: each op of the slice registers an analytic rule
(``OpInfo.infer_shape``, the reference's ``shape_rules.py`` for these
ops); an op without one keeps the shapes its layer declared.
"""

import contextlib

from . import unique_name
from .core import convert_dtype
from .registry import get_op_info, grad_var_name, is_registered

__all__ = [
    "Program", "Block", "Operator", "Variable", "Parameter", "VarType",
    "program_guard", "default_main_program", "default_startup_program",
    "switch_main_program", "switch_startup_program", "grad_var_name",
    "ShapeInferenceError", "in_var", "set_out", "same_shape_rule",
]


class VarType:
    LOD_TENSOR = "lod_tensor"


class ShapeInferenceError(Exception):
    """An op's output shapes could not be inferred at build time."""


class Variable:
    """A typed symbolic value in a Block. ``shape`` uses -1 for a
    data-dependent dim."""

    def __init__(self, block, name=None, shape=None, dtype=None, lod_level=0,
                 persistable=False, stop_gradient=False,
                 type=VarType.LOD_TENSOR, is_data=False):
        self.block = block
        self.name = name or unique_name.generate("_generated_var")
        self.shape = list(shape) if shape is not None else None
        self.dtype = convert_dtype(dtype) if dtype is not None else None
        if lod_level:
            raise NotImplementedError(
                "ragged (lod_level > 0) variables are not ported yet")
        self.lod_level = 0
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.type = type
        self.is_data = is_data

    def __repr__(self):
        return "Variable(%s, shape=%s, dtype=%s)" % (self.name, self.shape,
                                                     self.dtype)


class Parameter(Variable):
    """A trainable persistable variable."""

    def __init__(self, block, shape, dtype, **kwargs):
        self.trainable = kwargs.pop("trainable", True)
        self.regularizer = kwargs.pop("regularizer", None)
        self.gradient_clip_attr = kwargs.pop("gradient_clip_attr", None)
        self.optimize_attr = kwargs.pop("optimize_attr",
                                        {"learning_rate": 1.0})
        self.do_model_average = kwargs.pop("do_model_average", None)
        kwargs.pop("sharding", None)
        kwargs.setdefault("persistable", True)
        super().__init__(block, shape=shape, dtype=dtype, **kwargs)


class Operator:
    """One op invocation: type + named input/output var lists + attrs.
    ``inputs``/``outputs`` map slot name → list of variable names."""

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        if not is_registered(type):
            raise ValueError("operator %r is not registered" % type)
        self.block = block
        self.type = type
        self.inputs = {k: [_name(v) for v in _as_list(vs)]
                       for k, vs in (inputs or {}).items() if vs is not None}
        self.outputs = {k: [_name(v) for v in _as_list(vs)]
                        for k, vs in (outputs or {}).items()
                        if vs is not None}
        self.attrs = dict(attrs or {})
        program = block.program
        program._op_uid_counter += 1   # rng identity, per program
        self.op_uid = program._op_uid_counter
        self.forward_op = None  # set on grad ops, links to the forward op

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    def all_output_vars(self):
        return [n for vs in self.outputs.values() for n in vs]

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def __repr__(self):
        return "Op(%s, in=%s, out=%s)" % (self.type, self.inputs,
                                          self.outputs)


def _name(v):
    return v.name if isinstance(v, Variable) else v


def _as_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


class Block:
    """An ordered list of ops over a scope of variables."""

    def __init__(self, program, idx):
        self.program = program
        self.idx = idx
        self.vars = {}
        self.ops = []

    def create_var(self, **kwargs):
        name = kwargs.get("name")
        if name and name in self.vars:
            return self.vars[name]
        var = Variable(self, **kwargs)
        self.vars[var.name] = var
        return var

    def create_parameter(self, **kwargs):
        param = Parameter(self, **kwargs)
        self.vars[param.name] = param
        return param

    def var(self, name):
        if name not in self.vars:
            raise KeyError("variable %r not found in block %d"
                           % (name, self.idx))
        return self.vars[name]

    def has_var_local(self, name):
        return name in self.vars

    def _find_var_recursive(self, name):
        return self.vars.get(name)

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def append_op(self, type, inputs=None, outputs=None, attrs=None,
                  infer_shape=True):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        if infer_shape:
            infer_op_shape(self, op)
        return op


class Program:
    """Block 0 of a program (the only one the slice builds). Two default
    instances exist at any time: the *startup* program (parameter
    initialization, run once) and the *main* program."""

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.random_seed = 0
        self._is_test = False
        self._op_uid_counter = 0
        # mixed precision: bf16 compute on matmul/attention ops, fp32
        # master weights (enable_mixed_precision)
        self._amp = False

    def global_block(self):
        return self.blocks[0]

    current_block = global_block

    def list_vars(self):
        for blk in self.blocks:
            yield from blk.vars.values()


def in_var(block, op, slot, i=0):
    """The ``i``-th input variable of ``op``'s ``slot`` (None if unset)."""
    names = op.input(slot)
    if not names or i >= len(names) or not names[i]:
        return None
    return block.var(names[i])


def set_out(block, op, slot, shape, dtype=None, i=0):
    """Shape rules' writer: the ``i``-th output of ``slot`` gets
    ``shape`` (and ``dtype`` where the layer declared none)."""
    names = op.output(slot)
    if not names or i >= len(names) or not names[i]:
        return
    v = block.vars.get(names[i])
    if v is None or v.is_data:
        return
    v.shape = list(shape)
    if v.dtype is None and dtype is not None:
        v.dtype = convert_dtype(dtype)


def same_shape_rule(in_slot="X", out_slot="Out"):
    def rule(block, op):
        x = in_var(block, op, in_slot)
        if x is not None and x.shape is not None:
            set_out(block, op, out_slot, x.shape, dtype=x.dtype)
    return rule


def infer_op_shape(block, op):
    info = get_op_info(op.type)
    if info.infer_shape is None:
        return
    try:
        info.infer_shape(block, op)
    except ShapeInferenceError:
        raise
    except Exception as e:
        raise ShapeInferenceError(
            "shape inference for op %r failed: %s: %s"
            % (op.type, type(e).__name__, e)) from e


_main_program_ = Program()
_startup_program_ = Program()


def default_main_program():
    return _main_program_


def default_startup_program():
    return _startup_program_


def switch_main_program(program):
    global _main_program_
    old, _main_program_ = _main_program_, program
    return old


def switch_startup_program(program):
    global _startup_program_
    old, _startup_program_ = _startup_program_, program
    return old


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    old_main = switch_main_program(main_program)
    old_startup = None
    if startup_program is not None:
        old_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_startup is not None:
            switch_startup_program(old_startup)
