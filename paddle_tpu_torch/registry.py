"""Operator registry: op type → PyTorch lowering, grad lowering and shape
rule — the port of ``paddle_tpu/registry.py``.

Each op registers one **lowering**, a plain function from tensors to
tensors (``fn(ctx, ins: {slot: [tensors]}) -> {slot: [tensors]}``); the
executor runs a block's ops through their lowerings eagerly. An op's
gradient is either a registered ``<type>_grad`` lowering (the flash
attention backward, the analytic softmax cross-entropy, the embedding
scatter) or the **generic** one, ``torch.func.vjp`` of the forward
lowering — which recomputes that forward inside the grad op (the
reference leaves the duplicate to XLA's CSE; eager PyTorch pays it).
"""

import dataclasses
import hashlib
import typing

import torch

__all__ = ["GRAD_SUFFIX", "OpInfo", "OP_REGISTRY", "register_op",
           "get_op_info", "is_registered", "grad_var_name",
           "LoweringContext", "make_generic_grad_lowering",
           "ensure_grad_op_registered"]

GRAD_SUFFIX = "@GRAD"


def grad_var_name(name):
    return name + GRAD_SUFFIX


@dataclasses.dataclass
class OpInfo:
    type: str
    lowering: typing.Callable = None     # fn(ctx, ins) -> {slot: [tensors]}
    no_grad: bool = False                # op is non-differentiable
    infer_shape: typing.Callable = None  # fn(block, op): sets output shapes
    generic_grad: bool = False           # grad = torch.func.vjp of the fwd


OP_REGISTRY: typing.Dict[str, OpInfo] = {}


def register_op(op_type, lowering=None, no_grad=False, infer_shape=None):
    """Register an op. Usable directly or as a decorator on the lowering."""

    def _register(fn):
        if op_type in OP_REGISTRY:
            raise ValueError("op %r registered twice" % op_type)
        OP_REGISTRY[op_type] = OpInfo(
            type=op_type, lowering=fn, no_grad=no_grad,
            infer_shape=infer_shape)
        return fn

    if lowering is not None:
        return _register(lowering)
    return _register


def get_op_info(op_type) -> OpInfo:
    if op_type not in OP_REGISTRY:
        raise KeyError("operator %r is not registered" % op_type)
    return OP_REGISTRY[op_type]


def is_registered(op_type):
    return op_type in OP_REGISTRY


def _mix(*parts):
    """A 63-bit seed from integers, stable across processes."""
    digest = hashlib.sha256(repr(tuple(int(p) for p in parts)).encode())
    return int.from_bytes(digest.digest()[:8], "little") >> 1


class LoweringContext:
    """Per-op context handed to lowerings: the op's attributes, the
    device, execution-mode flags and a deterministic random stream.

    ``step_key`` is ``(program seed, executor step)``; :meth:`rng` returns
    a ``torch.Generator`` on the device seeded from (step_key, op uid,
    call #), so random ops reproduce run to run. Its numbers are not
    ``jax.random``'s: parity tests carry initial state across instead."""

    def __init__(self, op, step_key=None, is_test=False, device=None,
                 amp=False):
        self.op = op
        self.attrs = op.attrs
        self.step_key = step_key
        self.is_test = is_test
        self.device = torch.device("cpu") if device is None else device
        self.amp = amp          # bf16 compute / fp32 master weights
        self._rng_calls = 0

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def rng(self):
        if self.step_key is None:
            raise RuntimeError(
                "op %r needs a random stream but the executor did not "
                "provide a step key" % self.op.type)
        self._rng_calls += 1
        gen = torch.Generator(device=self.device)
        gen.manual_seed(_mix(*self.step_key, self.op.op_uid,
                             self._rng_calls))
        return gen


# ---------------------------------------------------------------------------
# Generic vjp-based grad lowering
# ---------------------------------------------------------------------------

def _coerce_cotangent(g, y):
    """Match an incoming grad to the primal's shape and dtype: the IR
    carries scalar losses as [1] while a lowering may produce ()."""
    if tuple(g.shape) != tuple(y.shape):
        if g.numel() == y.numel():
            g = g.reshape(y.shape)
        else:
            g = g.reshape(-1)[0].expand(y.shape)
    return g.to(y.dtype)


def make_generic_grad_lowering(fwd_type):
    """Lowering for ``<fwd_type>_grad``: ``torch.func.vjp`` of the forward
    lowering, with the reference's grad-op calling convention —
      inputs:  every forward input and output slot, and ``<slot>@GRAD``
               for each forward output slot that has a grad;
      outputs: ``<slot>@GRAD`` for each forward input slot needing one;
      attrs:   the forward attrs plus ``__fwd_input_slots__`` /
               ``__fwd_output_slots__`` / ``__fwd_op_uid__``."""
    fwd_info = get_op_info(fwd_type)

    def _grad_lowering(ctx, ins):
        in_slots = ctx.attr("__fwd_input_slots__")
        out_slots = ctx.attr("__fwd_output_slots__")
        fwd_ins = {s: ins.get(s, []) for s in in_slots}
        out_grads = {s: ins.get(grad_var_name(s)) for s in out_slots}
        want = {}
        for s in in_slots:
            gs = ctx.op.outputs.get(grad_var_name(s))
            if gs:
                want[s] = [i for i in range(len(fwd_ins[s]))
                           if i < len(gs) and gs[i]]
        diff_ins = {s: [fwd_ins[s][i] for i in idxs]
                    for s, idxs in want.items()}
        fwd_ctx = LoweringContext(
            ctx.op.forward_op or _FakeFwdOp(ctx, fwd_type),
            step_key=ctx.step_key, is_test=ctx.is_test, device=ctx.device,
            amp=ctx.amp)

        def fwd_fn(d_ins):
            merged = {s: list(v) for s, v in fwd_ins.items()}
            for s, idxs in want.items():
                for j, i in enumerate(idxs):
                    merged[s][i] = d_ins[s][j]
            outs = fwd_info.lowering(fwd_ctx, merged)
            return {s: list(outs.get(s, [])) for s in out_slots}

        primal_out, vjp_fn = torch.func.vjp(fwd_fn, diff_ins)
        cot = {}
        for s in out_slots:
            gs = out_grads.get(s)
            cot[s] = []
            for i, y in enumerate(primal_out[s]):
                g = gs[i] if gs and i < len(gs) and gs[i] is not None \
                    else None
                cot[s].append(torch.zeros_like(y) if g is None
                              else _coerce_cotangent(g, y))
        (gins,) = vjp_fn(cot)
        outs = {}
        for s, idxs in want.items():
            gs_list = [None] * len(fwd_ins[s])
            for j, i in enumerate(idxs):
                gs_list[i] = gins[s][j]
            outs[grad_var_name(s)] = gs_list
        return outs

    return _grad_lowering


class _FakeFwdOp:
    """Stand-in forward op for a grad op whose forward op object is gone:
    the attrs and a stable uid."""

    def __init__(self, grad_ctx, fwd_type):
        self.type = fwd_type
        self.attrs = {k: v for k, v in grad_ctx.attrs.items()
                      if not k.startswith("__")}
        self.op_uid = grad_ctx.attr("__fwd_op_uid__", grad_ctx.op.op_uid)
        self.inputs = {}
        self.outputs = {}
        self.forward_op = None


def ensure_grad_op_registered(fwd_type):
    """Register ``<fwd_type>_grad`` with the generic vjp lowering unless
    the op has its own grad lowering."""
    gtype = fwd_type + "_grad"
    if gtype not in OP_REGISTRY:
        OP_REGISTRY[gtype] = OpInfo(
            type=gtype, lowering=make_generic_grad_lowering(fwd_type),
            no_grad=True, generic_grad=True)
    return gtype
