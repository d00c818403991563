"""Tensor ops of the training slice — ports of
``paddle_tpu/ops/tensor_ops.py``: ``reshape``, ``transpose``, ``split``,
``cast``, ``fill_constant``, ``uniform_random``, ``gaussian_random``,
``slice``, and ``concat``; ``cast`` and ``concat`` take ragged inputs.

The random ops draw from the op's counter stream (``ctx.rng()``: a pure
function of the program seed, the step, the op and the element), or from
the fixed stream of the op's ``seed`` attr, on the executor's device —
so a captured step replays them with the step it reads on the device.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..core import LoDArray, torch_dtype
from ..framework import in_var, set_out
from ..registry import dense, register_op, seeded_stream


def _reshape_target(in_shape, target):
    """0 copies the input dim; one -1 is inferred."""
    out = [in_shape[i] if d == 0 else int(d) for i, d in enumerate(target)]
    if out.count(-1) == 1 and -1 not in in_shape:
        known = int(np.prod([d for d in out if d != -1]))
        out[out.index(-1)] = int(np.prod(in_shape)) // max(known, 1)
    return out


def _reshape_rule(block, op):
    x = in_var(block, op, "X")
    set_out(block, op, "Out", _reshape_target(list(x.shape),
                                              op.attr("shape")),
            dtype=x.dtype)


@register_op("reshape", infer_shape=_reshape_rule)
def _reshape(ctx, ins):
    x = ins["X"][0]
    return {"Out": [x.reshape(_reshape_target(list(x.shape),
                                              ctx.attr("shape")))]}


def _transpose_rule(block, op):
    x = in_var(block, op, "X")
    set_out(block, op, "Out", [x.shape[p] for p in op.attr("axis")],
            dtype=x.dtype)


@register_op("transpose", infer_shape=_transpose_rule)
def _transpose(ctx, ins):
    """The permuted view; its grad is the generic vjp (the inverse
    permutation)."""
    return {"Out": [ins["X"][0].permute(*ctx.attr("axis"))]}


def _sections(op_or_ctx, dim_size, n_outputs):
    sections = op_or_ctx.attr("sections", None)
    if sections:
        return list(sections)
    n = op_or_ctx.attr("num", 0) or n_outputs
    return [dim_size // n] * n


def _split_rule(block, op):
    x = in_var(block, op, "X")
    axis = op.attr("axis", 0)
    axis = axis if axis >= 0 else axis + len(x.shape)
    names = op.output("Out")
    for i, sec in enumerate(_sections(op, x.shape[axis], len(names))):
        shape = list(x.shape)
        shape[axis] = sec
        set_out(block, op, "Out", shape, dtype=x.dtype, i=i)


@register_op("split", infer_shape=_split_rule)
def _split(ctx, ins):
    x = ins["X"][0]
    axis = ctx.attr("axis", 0)
    secs = _sections(ctx, x.shape[axis], len(ctx.op.outputs.get("Out", [1])))
    return {"Out": list(torch.split(x, secs, dim=axis))}


def _cast_rule(block, op):
    x = in_var(block, op, "X")
    set_out(block, op, "Out", x.shape, dtype=op.attr("out_dtype"))


@register_op("cast", infer_shape=_cast_rule, ragged=True)
def _cast(ctx, ins):
    """X in ``out_dtype``; a ragged X keeps its lengths, a stored fp8 X
    is dequantized to it."""
    x = ins["X"][0]
    dt = torch_dtype(ctx.attr("out_dtype"))
    if isinstance(x, LoDArray):
        return {"Out": [LoDArray(dense(x.data, dt).to(dt), x.length)]}
    return {"Out": [dense(x, dt).to(dt)]}


def _fill_rule(block, op):
    set_out(block, op, "Out", list(op.attr("shape")),
            dtype=op.attr("dtype", "float32"))


@register_op("fill_constant", no_grad=True, infer_shape=_fill_rule)
def _fill_constant(ctx, ins):
    return {"Out": [torch.full(tuple(ctx.attr("shape")),
                               ctx.attr("value", 0.0),
                               dtype=torch_dtype(ctx.attr("dtype",
                                                          "float32")),
                               device=ctx.device)]}


def _stream(ctx):
    seed = ctx.attr("seed", 0)
    return seeded_stream(seed, ctx.device) if seed else ctx.rng()


@register_op("uniform_random", no_grad=True, infer_shape=_fill_rule)
def _uniform_random(ctx, ins):
    lo, hi = ctx.attr("min", -1.0), ctx.attr("max", 1.0)
    u = _stream(ctx).uniform(tuple(ctx.attr("shape")))
    out = u * (hi - lo) + lo
    return {"Out": [out.to(torch_dtype(ctx.attr("dtype", "float32")))]}


@register_op("gaussian_random", no_grad=True, infer_shape=_fill_rule)
def _gaussian_random(ctx, ins):
    n = _stream(ctx).normal(tuple(ctx.attr("shape")))
    out = n * ctx.attr("std", 1.0) + ctx.attr("mean", 0.0)
    return {"Out": [out.to(torch_dtype(ctx.attr("dtype", "float32")))]}


def _slice_index(ndim, axes, starts, ends):
    idx = [slice(None)] * ndim
    for ax, s, e in zip(axes, starts, ends):
        idx[ax] = slice(s, e)
    return tuple(idx)


def _slice_rule(block, op):
    x = in_var(block, op, "Input")
    idx = _slice_index(len(x.shape), op.attr("axes"), op.attr("starts"),
                       op.attr("ends"))
    shape = [len(range(*sl.indices(d))) if d >= 0 else -1
             for sl, d in zip(idx, x.shape)]
    set_out(block, op, "Out", shape, dtype=x.dtype)


@register_op("slice", infer_shape=_slice_rule)
def _slice(ctx, ins):
    x = ins["Input"][0]
    return {"Out": [x[_slice_index(x.dim(), ctx.attr("axes"),
                                   ctx.attr("starts"), ctx.attr("ends"))]]}


def _concat_rule(block, op):
    vs = [block.var(n) for n in op.input("X")]
    out = list(vs[0].shape)
    axis = op.attr("axis", 0)
    axis = axis if axis >= 0 else axis + len(out)
    dims = [v.shape[axis] for v in vs]
    out[axis] = -1 if min(dims) < 0 else sum(dims)
    set_out(block, op, "Out", out, dtype=vs[0].dtype,
            lod_level=max(v.lod_level for v in vs))


@register_op("concat", infer_shape=_concat_rule, ragged=True)
def _concat(ctx, ins):
    """Concatenation along ``axis``. Ragged inputs (all of them, or
    none): the axis counts the batch and each token's dims, so axis >= 1
    joins features and keeps the first input's lengths; axis 0 joins the
    batches, padded to a common ``max_len``, and their lengths."""
    vs = [v for v in ins["X"] if v is not None]
    axis = ctx.attr("axis", 0)
    if not any(isinstance(v, LoDArray) for v in vs):
        return {"Out": [torch.cat(vs, dim=axis)]}
    if not all(isinstance(v, LoDArray) for v in vs):
        raise TypeError("concat cannot mix ragged (LoD) and dense inputs")
    xs = [v.data for v in vs]
    if axis < 0:
        axis += xs[0].dim() - 1
    if axis >= 1:
        return {"Out": [LoDArray(torch.cat(xs, dim=axis + 1),
                                 vs[0].length)]}
    ml = max(x.shape[1] for x in xs)
    xs = [F.pad(x, (0, 0) * (x.dim() - 2) + (0, ml - x.shape[1]))
          for x in xs]
    return {"Out": [LoDArray(torch.cat(xs, dim=0),
                             torch.cat([v.length for v in vs]))]}
