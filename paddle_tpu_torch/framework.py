"""The IR: Program / Block / Operator / Variable, built by the layers DSL —
the port of ``paddle_tpu/framework.py``, trimmed to one global block
(dense tensors and one level of LoD; no control-flow blocks or nested
LoD yet).

Serialization (``to_dict`` / ``Program.from_dict``, the reference's
``framework.py:97-529``) writes the reference's dict: either package
reads the other's. ``op_uid`` rides each op (the counter-hash random
streams key on it) and ``amp`` the program; ``accumulator_owner`` and
``sharding_plan`` (the reference's parallelism records) and a
parameter's ``sharding`` are kept as read and written back, not
interpreted. ``Program.clone(for_test)``, ``prune(targets)`` and
``inference_optimize()`` are the reference's Python path (its native C++
tier is not ported).

A ragged var (``lod_level=1``) has the IR shape ``[-1, *feat]`` (the
batch, then each token's features) and is a ``core.LoDArray`` at run time:
``data`` ``[B, L, *feat]`` and ``length`` ``[B]``. Integer ids declared
``[-1, 1]`` are stored token-scalar, ``[B, L]``. A dense ``[-1, -1, d]``
is a padded ``[B, L, d]`` sharing the ragged inputs' sequence dim.

Shape inference: each op of the slice registers an analytic rule
(``OpInfo.infer_shape``, the reference's ``shape_rules.py`` for these
ops); an op without one keeps the shapes its layer declared.
"""

import contextlib
import itertools
import json

import numpy as np

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
        if lod_level and lod_level >= 2:
            raise NotImplementedError(
                "variable %r: lod_level %d (nested LoD, the reference's "
                "LoDArray2) is not ported; one ragged level is"
                % (name, lod_level))
        self.lod_level = int(lod_level or 0)
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.type = type
        self.is_data = is_data

    def to_dict(self):
        return {
            "name": self.name, "shape": self.shape, "dtype": self.dtype,
            "lod_level": self.lod_level, "persistable": self.persistable,
            "stop_gradient": self.stop_gradient, "type": self.type,
            "is_data": self.is_data, "is_parameter": False,
        }

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
        # the reference's PartitionSpec hint in its JSON form, kept as
        # read (parallelism is not ported)
        self.sharding = kwargs.pop("sharding", None)
        kwargs.setdefault("persistable", True)
        super().__init__(block, shape=shape, dtype=dtype, **kwargs)

    def to_dict(self):
        d = super().to_dict()
        d.update(is_parameter=True, trainable=self.trainable,
                 optimize_attr=self.optimize_attr, sharding=self.sharding)
        return d


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

    def all_input_vars(self):
        return [n for vs in self.inputs.values() for n in vs]

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def to_dict(self):
        return {"type": self.type, "inputs": self.inputs,
                "outputs": self.outputs, "attrs": _serialize_attrs(self.attrs),
                "op_uid": self.op_uid}

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


def _serialize_attrs(attrs):
    """Attrs in their JSON form, as the reference writes them: tuples as
    lists, numpy scalars as Python numbers, arrays tagged
    ``__ndarray__``."""
    out = {}
    for k, v in attrs.items():
        if isinstance(v, np.ndarray):
            out[k] = {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
        elif isinstance(v, np.integer):
            out[k] = int(v)
        elif isinstance(v, np.floating):
            out[k] = float(v)
        elif isinstance(v, tuple):
            out[k] = list(v)
        else:
            out[k] = v
    return out


def _deserialize_attrs(attrs):
    out = {}
    for k, v in attrs.items():
        if isinstance(v, dict) and "__block__" in v:
            raise NotImplementedError(
                "attr %r refers to block %s: control-flow blocks are not "
                "ported" % (k, v["__block__"]))
        if isinstance(v, dict) and "__ndarray__" in v:
            v = np.array(v["__ndarray__"], dtype=v["dtype"])
        out[k] = v
    return out


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

    def to_dict(self):
        return {"idx": self.idx, "parent_idx": -1, "forward_block_idx": -1,
                "vars": [v.to_dict() for v in self.vars.values()],
                "ops": [op.to_dict() for op in self.ops]}

    def append_op(self, type, inputs=None, outputs=None, attrs=None,
                  infer_shape=True):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        # the executor's caches (liveness, captured graphs) key on it
        self.program._version += 1
        if infer_shape:
            infer_op_shape(self, op)
        return op


class Program:
    """Block 0 of a program (the only one the slice builds). Two default
    instances exist at any time: the *startup* program (parameter
    initialization, run once) and the *main* program. ``_uid`` names the
    program for the executor's caches; ``_version`` counts its ops'
    appends."""

    _uid_counter = itertools.count(1)

    def __init__(self):
        self._uid = next(Program._uid_counter)
        self._version = 0
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

    # -- cloning / pruning (the reference's Python path) --------------
    def clone(self, for_test=False):
        """A deep copy through the dict; ``for_test`` sets every op's
        ``is_test`` attr (dropout and batch norm then use their inference
        behaviour) and the program's."""
        p = Program.from_dict(self.to_dict())
        p.random_seed = self.random_seed
        if for_test:
            p._is_test = True
            for op in p.global_block().ops:
                if "is_test" in op.attrs:
                    op.attrs["is_test"] = True
        return p

    def prune(self, targets):
        """The ops ``targets`` (variables or names) depend on, walking
        back from them, and the variables those ops touch (persistables
        and data vars kept)."""
        target_names = {t.name if isinstance(t, Variable) else t
                        for t in targets}
        p = Program.from_dict(self.to_dict())
        p.random_seed = self.random_seed
        blk = p.global_block()
        needed = set(target_names)
        keep = []
        for op in reversed(blk.ops):
            if any(o in needed for o in op.all_output_vars()):
                keep.append(op)
                needed.update(op.all_input_vars())
        blk.ops = list(reversed(keep))
        used = set(target_names)
        for op in blk.ops:
            used.update(op.all_input_vars())
            used.update(op.all_output_vars())
        blk.vars = {n: v for n, v in blk.vars.items()
                    if n in used or v.persistable or v.is_data}
        return p

    def inference_optimize(self):
        return self.clone(for_test=True)

    # -- serialization -------------------------------------------------
    def to_dict(self):
        d = {"version": 1, "random_seed": self.random_seed,
             "amp": self._amp,
             "blocks": [b.to_dict() for b in self.blocks]}
        if getattr(self, "_accumulator_owner", None):
            d["accumulator_owner"] = dict(self._accumulator_owner)
        if getattr(self, "_sharding_plan", None):
            d["sharding_plan"] = self._sharding_plan
        return d

    def to_string(self, throw_on_error=False):
        return json.dumps(self.to_dict(), indent=1, default=str)

    __str__ = to_string

    @staticmethod
    def from_dict(d):
        """A program from its dict (either package's). A var's ``op``
        links and shapes are taken as written: no shape inference runs."""
        if len(d["blocks"]) > 1:
            raise NotImplementedError(
                "program has %d blocks: control-flow blocks are not "
                "ported" % len(d["blocks"]))
        p = Program()
        p.random_seed = d.get("random_seed", 0)
        p._amp = bool(d.get("amp", False))
        if d.get("accumulator_owner"):
            p._accumulator_owner = dict(d["accumulator_owner"])
        if d.get("sharding_plan"):
            p._sharding_plan = d["sharding_plan"]
        blk = p.global_block()
        for bd in d["blocks"]:
            for vd in bd["vars"]:
                vd = dict(vd)
                is_param = vd.pop("is_parameter", False)
                if is_param:
                    par = Parameter(blk, vd.pop("shape"), vd.pop("dtype"),
                                    **vd)
                    blk.vars[par.name] = par
                else:
                    for k in ("trainable", "optimize_attr", "sharding"):
                        vd.pop(k, None)
                    blk.create_var(**vd)
            for od in bd["ops"]:
                op = Operator(blk, od["type"], od["inputs"], od["outputs"],
                              _deserialize_attrs(od["attrs"]))
                if "op_uid" in od:
                    # the random streams key on it: keep the writer's
                    op.op_uid = od["op_uid"]
                    p._op_uid_counter = max(p._op_uid_counter, op.op_uid)
                blk.ops.append(op)
        p._version += 1
        return p

    @staticmethod
    def parse_from_string(s):
        return Program.from_dict(json.loads(s))


def in_var(block, op, slot, i=0):
    """The ``i``-th input variable of ``op``'s ``slot`` (None if unset)."""
    names = op.input(slot)
    if not names or i >= len(names) or not names[i]:
        return None
    return block.var(names[i])


def set_out(block, op, slot, shape, dtype=None, i=0, lod_level=None):
    """Shape rules' writer: the ``i``-th output of ``slot`` gets
    ``shape`` (and ``dtype`` where the layer declared none); a
    ``lod_level`` marks it ragged (the lowering's output type decides,
    whatever the layer declared)."""
    names = op.output(slot)
    if not names or i >= len(names) or not names[i]:
        return
    v = block.vars.get(names[i])
    if v is None or v.is_data:
        return
    v.shape = list(shape)
    if v.dtype is None and dtype is not None:
        v.dtype = convert_dtype(dtype)
    if lod_level:
        v.lod_level = max(v.lod_level, lod_level)


def same_shape_rule(in_slot="X", out_slot="Out"):
    """The output is shaped (and ragged) like the input."""
    def rule(block, op):
        x = in_var(block, op, in_slot)
        if x is not None and x.shape is not None:
            set_out(block, op, out_slot, x.shape, dtype=x.dtype,
                    lod_level=x.lod_level)
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
