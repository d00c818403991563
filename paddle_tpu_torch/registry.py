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
import typing

import torch

__all__ = ["GRAD_SUFFIX", "OpInfo", "OP_REGISTRY", "register_op",
           "get_op_info", "is_registered", "grad_var_name",
           "LoweringContext", "CounterStream", "seeded_stream",
           "make_generic_grad_lowering", "ensure_grad_op_registered"]

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
    host: bool = False                   # host side effects (save/print):
                                         # Executor.run_steps refuses it


OP_REGISTRY: typing.Dict[str, OpInfo] = {}


def register_op(op_type, lowering=None, no_grad=False, infer_shape=None,
                host=False):
    """Register an op. Usable directly or as a decorator on the lowering."""

    def _register(fn):
        if op_type in OP_REGISTRY:
            raise ValueError("op %r registered twice" % op_type)
        OP_REGISTRY[op_type] = OpInfo(
            type=op_type, lowering=fn, no_grad=no_grad,
            infer_shape=infer_shape, host=host)
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


_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mul32(x, c):
    """``x * c mod 2**32`` for ``x`` in [0, 2**32) (a Python int or an
    int64 tensor) and a 32-bit constant ``c``, split at 16 bits so no
    product leaves int64."""
    return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) & _M32


def _mix32(h):
    """MurmurHash3's 32-bit finalizer: a bijection of [0, 2**32) whose
    output bits each depend on every input bit."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _fold(key, value):
    """``key`` (an int or an int64 device tensor) with ``value`` folded
    in: the next key of the chain."""
    return _mix32(key ^ _mix32((value + _GOLDEN) & _M32))


class CounterStream:
    """Random numbers that are a pure function of integers: element ``i``
    of a draw under ``key`` comes from ``_mix32`` of (key, i), a counter
    hash evaluated on the device. ``key`` may be an int64 device tensor
    (a captured step's counter), so a CUDA graph that replays the draw
    reads the key anew each time; an int and a tensor of the same value
    give the same numbers bit for bit."""

    def __init__(self, key, device):
        self.key = key
        self.device = device

    def _bits(self, n):
        """[n] int64 of 24 random bits each: element i folded into the
        key."""
        idx = torch.arange(n, device=self.device, dtype=torch.int64)
        return _fold(self.key, idx) >> 8

    def uniform(self, shape):
        """fp32 uniforms in (0, 1) on a 2**-24 grid."""
        n = int(torch.Size(shape).numel())
        u = (self._bits(n).float() + 0.5) * (1.0 / (1 << 24))
        return u.reshape(tuple(shape))

    def normal(self, shape):
        """fp32 standard normals (Box-Muller over two uniforms an
        element)."""
        n = int(torch.Size(shape).numel())
        u = (self._bits(2 * n).float() + 0.5) * (1.0 / (1 << 24))
        r = torch.sqrt(-2.0 * torch.log(u[:n]))
        return (r * torch.cos((2.0 * torch.pi) * u[n:])).reshape(
            tuple(shape))


def seeded_stream(seed, device):
    """The fixed stream of an op's explicit ``seed`` attribute: the same
    numbers at every step and for every op with that seed."""
    return CounterStream(_fold(_mix32(int(seed) & _M32), 0), device)


class LoweringContext:
    """Per-op context handed to lowerings: the op's attributes, the
    device, execution-mode flags and a deterministic random stream.

    ``step_key`` is ``(program seed, executor step)``; the step is an int
    (``Executor.run``) or an int64 device scalar that a captured step
    advances on the device at each replay (``Executor.run_steps``).
    :meth:`rng` returns a :class:`CounterStream` keyed by (seed, step, op
    uid, call #), so random ops reproduce run to run, and ``run_steps(n)``
    draws what ``n`` ``run()`` calls draw. Its numbers are not
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
        seed, step = self.step_key
        key = _fold(_mix32(int(seed) & _M32), step & _M32)
        key = _fold(_fold(key, int(self.op.op_uid)), self._rng_calls)
        return CounterStream(key, self.device)


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
