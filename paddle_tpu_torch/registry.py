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
Ragged values (``core.LoDArray``) pass through the vjp as their
``data``: lengths and other integer leaves are constants of the
differentiated function, and a ragged input's grad is a ``LoDArray``
of the data's grad with the input's lengths. A lowering that does not
declare ``ragged=True`` refuses a ragged input by name (the executor's
``trace_ops`` checks).

fp8 is a storage format (``PADDLE_TPU_FP8_ACTS``,
``PADDLE_TPU_FP8_CONV_OUT``): ``cast_fp8`` is the one cast every store
goes through, ``dense`` the one dequant every consumer calls,
``no_fp8_store`` turns the stores off for a grad op's re-run of its
forward, and ``register_fp8_transparent_grad`` dequantizes a grad op's
fp8 inputs before the generic vjp, so no gradient is ever fp8.
"""

import contextlib
import dataclasses
import threading
import typing

import torch
import torch.utils._pytree as pytree

from .core import LoDArray, ScaledFp8

__all__ = ["GRAD_SUFFIX", "OpInfo", "OP_REGISTRY", "register_op",
           "get_op_info", "is_registered", "grad_var_name",
           "LoweringContext", "CounterStream", "seeded_stream",
           "make_generic_grad_lowering", "ensure_grad_op_registered",
           "output_consumed", "FP8_DTYPES", "cast_fp8", "dense",
           "fp8_store_enabled", "no_fp8_store",
           "register_fp8_transparent_grad", "refuse_ragged"]

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
    ragged: bool = False                 # takes core.LoDArray inputs


OP_REGISTRY: typing.Dict[str, OpInfo] = {}


def register_op(op_type, lowering=None, no_grad=False, infer_shape=None,
                host=False, ragged=False):
    """Register an op. Usable directly or as a decorator on the lowering.
    ``ragged``: the lowering takes ``LoDArray`` inputs (any other op
    refuses them, :func:`refuse_ragged`)."""

    def _register(fn):
        if op_type in OP_REGISTRY:
            raise ValueError("op %r registered twice" % op_type)
        OP_REGISTRY[op_type] = OpInfo(
            type=op_type, lowering=fn, no_grad=no_grad,
            infer_shape=infer_shape, host=host, ragged=ragged)
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


def refuse_ragged(info, ins):
    """Raise ``NotImplementedError`` naming the op when a lowering without
    a ragged pass-through (``OpInfo.ragged``) is given a ``LoDArray``."""
    if info.ragged:
        return
    for slot, vals in ins.items():
        if any(isinstance(v, LoDArray) for v in vals):
            raise NotImplementedError(
                "op %r has no pass-through for ragged input (a LoDArray in "
                "slot %r): it is not ported for ragged (LoD) values"
                % (info.type, slot))


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
        # set by trace_ops: the block run and the step's fetch targets
        # (None: unknown — ``output_consumed`` then counts every output)
        self.block = None
        self.fetch_names = None

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
    carries scalar losses as [1] while a lowering may produce (). A
    ragged primal's cotangent acts on its data and keeps its lengths."""
    if isinstance(y, LoDArray):
        gd = g.data if isinstance(g, LoDArray) else g
        return LoDArray(_coerce_cotangent(gd, y.data), y.length)
    if isinstance(g, LoDArray):
        g = g.data
    if tuple(g.shape) != tuple(y.shape):
        if g.numel() == y.numel():
            g = g.reshape(y.shape)
        else:
            g = g.reshape(-1)[0].expand(y.shape)
    return g.to(y.dtype)


def _is_float(v):
    return isinstance(v, torch.Tensor) and (v.is_floating_point() or
                                            v.is_complex())


def _refuse_fp8(fwd_type, what, values):
    """The generic grad never differentiates an fp8 value: an fp8 input
    would get an fp8 grad, and an fp8 output (a store left on in the
    re-run) would quantize its cotangent. Raises naming the op and the
    slot; :func:`register_fp8_transparent_grad` is the fix."""
    for slot, v in values.items():
        if any(isinstance(t, torch.Tensor) and t.dtype in FP8_DTYPES
               for t in pytree.tree_leaves(v)):
            raise TypeError(
                "%s_grad: the forward %s %r is fp8; fp8 is a storage "
                "format and is never differentiated — dequantize it "
                "(register_fp8_transparent_grad) or turn the store off "
                "in the re-run (no_fp8_store)" % (fwd_type, what, slot))


def make_generic_grad_lowering(fwd_type):
    """Lowering for ``<fwd_type>_grad``: ``torch.func.vjp`` of the forward
    lowering, with the reference's grad-op calling convention —
      inputs:  every forward input and output slot, and ``<slot>@GRAD``
               for each forward output slot that has a grad;
      outputs: ``<slot>@GRAD`` for each forward input slot needing one;
      attrs:   the forward attrs plus ``__fwd_input_slots__`` /
               ``__fwd_output_slots__`` / ``__fwd_op_uid__``.
    The vjp differentiates the float leaves of the wanted inputs (a
    ``LoDArray``'s data, not its lengths) and of the outputs that have an
    incoming grad; an output without one adds a zero cotangent, so it is
    left out."""
    fwd_info = get_op_info(fwd_type)

    def _grad_lowering(ctx, ins):
        in_slots = ctx.attr("__fwd_input_slots__")
        out_slots = ctx.attr("__fwd_output_slots__")
        fwd_ins = {s: ins.get(s, []) for s in in_slots}
        out_grads = {s: ins.get(grad_var_name(s)) or [] for s in out_slots}
        want = {}
        for s in in_slots:
            gs = ctx.op.outputs.get(grad_var_name(s))
            if gs:
                want[s] = [i for i in range(len(fwd_ins[s]))
                           if i < len(gs) and gs[i]]
        diff_ins = {s: [fwd_ins[s][i] for i in idxs]
                    for s, idxs in want.items()}
        leaves, spec = pytree.tree_flatten(diff_ins)
        _refuse_fp8(fwd_type, "input", diff_ins)
        diff_at = [j for j, v in enumerate(leaves) if _is_float(v)]
        fwd_ctx = LoweringContext(
            ctx.op.forward_op or _FakeFwdOp(ctx, fwd_type),
            step_key=ctx.step_key, is_test=ctx.is_test, device=ctx.device,
            amp=ctx.amp)
        fwd_ctx.block, fwd_ctx.fetch_names = ctx.block, ctx.fetch_names
        graded = [(s, i) for s in out_slots
                  for i, g in enumerate(out_grads[s]) if g is not None]
        kept = []       # the graded outputs with a float value

        def fwd_fn(d_leaves):
            merged_leaves = list(leaves)
            for j, v in zip(diff_at, d_leaves):
                merged_leaves[j] = v
            d_ins = pytree.tree_unflatten(merged_leaves, spec)
            merged = {s: list(v) for s, v in fwd_ins.items()}
            for s, idxs in want.items():
                for j, i in enumerate(idxs):
                    merged[s][i] = d_ins[s][j]
            outs = fwd_info.lowering(fwd_ctx, merged)
            kept.clear()
            ys = []
            for s, i in graded:
                y = outs[s][i]
                y = y.data if isinstance(y, LoDArray) else y
                if _is_float(y):
                    kept.append((s, i))
                    ys.append(y)
            return ys

        primal, vjp_fn = torch.func.vjp(
            fwd_fn, [leaves[j] for j in diff_at])
        _refuse_fp8(fwd_type, "output", dict(zip(kept, primal)))
        cot = [_coerce_cotangent(out_grads[s][i], y)
               for (s, i), y in zip(kept, primal)]
        (d_leaves,) = vjp_fn(cot) if primal else \
            ([torch.zeros_like(leaves[j]) for j in diff_at],)
        g_leaves = [None] * len(leaves)
        for j, g in zip(diff_at, d_leaves):
            g_leaves[j] = g
        g_ins = pytree.tree_unflatten(g_leaves, spec)
        outs = {}
        for s, idxs in want.items():
            gs_list = [None] * len(fwd_ins[s])
            for j, i in enumerate(idxs):
                x, g = diff_ins[s][j], g_ins[s][j]
                gs_list[i] = LoDArray(g.data, x.length) \
                    if isinstance(x, LoDArray) else g
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
            no_grad=True, generic_grad=True,
            ragged=get_op_info(fwd_type).ragged)
    return gtype


# ---------------------------------------------------------------------------
# fp8 storage
# ---------------------------------------------------------------------------

FP8_DTYPES = (torch.float8_e4m3fn, torch.float8_e5m2)


def cast_fp8(x, dtype):
    """``x`` (bf16 or fp32) stored as the fp8 ``dtype`` with the
    reference's semantics: round to nearest even inside the range, and
    past it NaN (e4m3fn) or ±infinity (e5m2). Every fp8 store of the port
    goes through it. e5m2 is ``x.to(dtype)``, which gives the reference's
    bits on both backends, overflow included. e4m3fn has no infinity: the
    reference gives NaN past 464 (the tie at 464 rounds to even, 448),
    where the CPU's ``x.to(dtype)`` saturates to ±448 from 480; so the
    cast takes ``x`` clamped to ±448 (in range on every backend, ±448 the
    byte 0x7E under its sign) and sets the low bit past 464, which makes
    it the NaN 0x7F under the same sign. A NaN input stays NaN (its sign
    and payload bits are the backend's)."""
    if dtype == torch.float8_e5m2:
        return x.to(dtype)
    q = x.clamp(-448.0, 448.0).to(dtype).view(torch.uint8)
    return (q | (x.abs() > 464.0).view(torch.uint8)).view(dtype)


def dense(v, dtype=torch.bfloat16):
    """A stored fp8 value as a dense ``dtype`` (bf16) one — the one
    dequant of the port: a ``ScaledFp8``'s dequant, a raw fp8 tensor
    widened, a ``LoDArray`` of fp8 data rebuilt with its lengths;
    anything else is returned as it is."""
    if isinstance(v, ScaledFp8):
        return v.dequant(dtype)
    if isinstance(v, LoDArray):
        return LoDArray(dense(v.data, dtype), v.length) \
            if v.data.dtype in FP8_DTYPES else v
    if isinstance(v, torch.Tensor) and v.dtype in FP8_DTYPES:
        return v.to(dtype)
    return v


# the gate of the stores: thread-local, so one thread's grad re-run does
# not turn the stores off (or back on) under another thread's step
_fp8_tls = threading.local()


def fp8_store_enabled():
    return getattr(_fp8_tls, "on", True)


@contextlib.contextmanager
def no_fp8_store():
    """Turn this thread's fp8 stores off for the block (a grad op's
    re-run of its forward: its primal output stays bf16)."""
    old = fp8_store_enabled()
    _fp8_tls.on = False
    try:
        yield
    finally:
        _fp8_tls.on = old


def register_fp8_transparent_grad(fwd_type, slots, around_vjp=None):
    """Register ``<fwd_type>_grad`` as the generic vjp with the fp8
    inputs of ``slots`` dequantized to bf16 (``dense``) before it: the
    backward is the straight-through estimator, and the grads of those
    inputs are bf16, never a quantized cotangent. ``around_vjp``: a
    context-manager factory around the vjp (``no_fp8_store`` for an op
    whose forward stores fp8). The forward must be registered."""
    gen = make_generic_grad_lowering(fwd_type)

    def lowering(ctx, ins):
        ins = dict(ins)
        for s in slots:
            if ins.get(s):
                ins[s] = [dense(v) for v in ins[s]]
        with (around_vjp or contextlib.nullcontext)():
            return gen(ctx, ins)

    gtype = fwd_type + "_grad"
    if gtype in OP_REGISTRY:
        raise ValueError("op %r registered twice" % gtype)
    OP_REGISTRY[gtype] = OpInfo(type=gtype, lowering=lowering, no_grad=True,
                                generic_grad=True,
                                ragged=get_op_info(fwd_type).ragged)


def _consumer_index(program):
    """name → [(op, slot), ...] over every op input of the program, built
    once per program version (cached on the program)."""
    cached = getattr(program, "_consumer_index", None)
    if cached is not None and cached[0] == program._version:
        return cached[1]
    index = {}
    for blk in program.blocks:
        for op in blk.ops:
            for slot, names in op.inputs.items():
                for n in names:
                    if n:
                        index.setdefault(n, []).append((op, slot))
    program._consumer_index = (program._version, index)
    return index


def output_consumed(ctx, name):
    """Is this op output read by another op of the program or fetched?
    Lowerings use it to skip producing dead outputs, never to change live
    ones, so every unknown counts as consumed: a stand-in op with no
    recorded outputs, or a context with no fetch list. A generic grad
    op's copy of a forward output is calling-convention baggage, never
    read."""
    if not getattr(ctx.op, "outputs", None):
        return True
    if not name:
        return False
    if ctx.fetch_names is None or ctx.block is None:
        return True
    if name in ctx.fetch_names:
        return True
    fwd_out_slots = set(ctx.op.outputs)
    for op, slot in _consumer_index(ctx.block.program).get(name, ()):
        if op is ctx.op:
            continue
        info = OP_REGISTRY.get(op.type)
        if op.type == ctx.op.type + "_grad" and info is not None \
                and info.generic_grad and slot in fwd_out_slots:
            continue
        return True
    return False
