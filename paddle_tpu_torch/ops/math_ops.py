"""Math ops of the training slice — ports of ``paddle_tpu/ops/math_ops.py``
(``mul``, ``elementwise_add``, ``sum``, ``scale``, ``lookup_table`` and
its grad) and ``tensor_ops.py``'s ``mean``. Plain PyTorch: the reference
leaves them to XLA.

Mixed precision (``ctx.amp``) follows the reference: matmul operands in
bf16 with fp32 accumulation, a bf16 x fp32 elementwise pair computes in
bf16, the embedding emits bf16 rows from its fp32 table.
"""

import numpy as np
import torch

from ..framework import in_var, same_shape_rule, set_out
from ..registry import register_op


def _matmul_f32_acc(a, b):
    """``a @ b`` accumulated in fp32, returned in a's dtype. cuBLAS
    accumulates bf16 products in fp32 itself; on the CPU the product is
    taken in fp32 (exact for bf16 operands) and rounded once."""
    if a.dtype == torch.bfloat16 and a.device.type == "cpu":
        return torch.matmul(a.float(), b.float()).to(a.dtype)
    return torch.matmul(a, b)


def _mul_rule(block, op):
    x, y = in_var(block, op, "X"), in_var(block, op, "Y")
    xn, yn = op.attr("x_num_col_dims", 1), op.attr("y_num_col_dims", 1)
    set_out(block, op, "Out", list(x.shape[:xn]) + list(y.shape[yn:]),
            dtype=x.dtype)


@register_op("mul", infer_shape=_mul_rule)
def _mul(ctx, ins):
    x, y = ins["X"][0], ins["Y"][0]
    xn = ctx.attr("x_num_col_dims", 1)
    yn = ctx.attr("y_num_col_dims", 1)
    if ctx.amp:
        x, y = x.to(torch.bfloat16), y.to(torch.bfloat16)
    rows = int(np.prod(x.shape[:xn]))
    out = _matmul_f32_acc(x.reshape(rows, -1),
                         y.reshape(int(np.prod(y.shape[:yn])), -1))
    return {"Out": [out.reshape(tuple(x.shape[:xn]) + tuple(y.shape[yn:]))]}


def _bcast_y(x, y, axis):
    """Reference broadcast: y's dims align to x's dims starting at
    ``axis``."""
    if x.dim() == y.dim():
        return y
    if axis is None or axis == -1:
        axis = x.dim() - y.dim()
    return y.reshape([1] * axis + list(y.shape) +
                     [1] * (x.dim() - axis - y.dim()))


@register_op("elementwise_add", infer_shape=same_shape_rule())
def _elementwise_add(ctx, ins):
    x, y = ins["X"][0], ins["Y"][0]
    y = _bcast_y(x, y, ctx.attr("axis", -1))
    if ctx.amp and x.dtype != y.dtype and \
            {x.dtype, y.dtype} == {torch.bfloat16, torch.float32}:
        x, y = x.to(torch.bfloat16), y.to(torch.bfloat16)
    return {"Out": [x + y]}


def _sum_rule(block, op):
    x = in_var(block, op, "X")
    set_out(block, op, "Out", x.shape, dtype=x.dtype)


@register_op("sum", infer_shape=_sum_rule)
def _sum(ctx, ins):
    xs = [v for v in ins["X"] if v is not None]
    out = xs[0]
    for v in xs[1:]:
        out = out + v
    return {"Out": [out]}


@register_op("scale", infer_shape=same_shape_rule())
def _scale(ctx, ins):
    x = ins["X"][0]
    s, b = ctx.attr("scale", 1.0), ctx.attr("bias", 0.0)
    out = x * s + b if ctx.attr("bias_after_scale", True) else (x + b) * s
    return {"Out": [out]}


def _mean_rule(block, op):
    set_out(block, op, "Out", [1], dtype=in_var(block, op, "X").dtype)


@register_op("mean", infer_shape=_mean_rule)
def _mean(ctx, ins):
    return {"Out": [torch.mean(ins["X"][0])]}


def _lookup_ids(ids):
    """Token ids without a trailing feature axis of 1 ([b, 1] or
    [b, t, 1]), as longs."""
    if ids.dim() >= 2 and ids.shape[-1] == 1:
        ids = ids.squeeze(-1)
    return ids.long()


def _lookup_table_rule(block, op):
    w, ids = in_var(block, op, "W"), in_var(block, op, "Ids")
    out = list(ids.shape)
    if out and out[-1] == 1:
        out = out[:-1]
    set_out(block, op, "Out", out + [w.shape[-1]], dtype=w.dtype)


@register_op("lookup_table", infer_shape=_lookup_table_rule)
def _lookup_table(ctx, ins):
    w, ids = ins["W"][0], _lookup_ids(ins["Ids"][0])
    out = w[ids.clamp(0, w.shape[0] - 1)]
    if ctx.amp and out.dtype == torch.float32:
        out = out.to(torch.bfloat16)
    padding_idx = ctx.attr("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        out = out.masked_fill((ids == padding_idx)[..., None], 0.0)
    return {"Out": [out]}


@register_op("lookup_table_grad", no_grad=True)
def _lookup_table_grad(ctx, ins):
    """Dense scatter-add of the output grad into the table's rows (the
    reference's custom grad; sparse SelectedRows grads are not ported)."""
    if ctx.attr("is_sparse", False):
        raise NotImplementedError("is_sparse embeddings (SelectedRows "
                                  "grads) are not ported yet")
    w = ins["W"][0]
    ids = _lookup_ids(ins["Ids"][0]).reshape(-1)
    g = ins["Out@GRAD"][0]
    g = g.reshape((ids.shape[0],) + tuple(g.shape[-(w.dim() - 1):]))
    gw = torch.zeros_like(w).index_add_(0, ids.clamp(0, w.shape[0] - 1),
                                        g.to(w.dtype))
    return {"W@GRAD": [gw]}
