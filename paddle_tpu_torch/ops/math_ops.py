"""Math ops of the training slice — ports of ``paddle_tpu/ops/math_ops.py``
(``mul``, ``elementwise_add``, ``sum``, ``scale``, ``lookup_table`` and
its grad) and ``tensor_ops.py``'s ``mean``. Plain PyTorch: the reference
leaves them to XLA.

Mixed precision (``ctx.amp``) follows the reference: matmul operands in
bf16 with fp32 accumulation, a bf16 x fp32 elementwise pair computes in
bf16, the embedding emits bf16 rows from its fp32 table.

Ragged inputs (``core.LoDArray``): ``mul`` flattens a ragged X's padded
tokens into rows (``x_num_col_dims + 1``), ``elementwise_add`` aligns a
dense Y's IR axis one further (the padded sequence axis),
``elementwise_add``, ``sum`` and ``scale`` pass X's lengths through,
``mean`` averages the valid tokens only (its count in fp32), and
``lookup_table`` reads token-scalar ids ``[B, L]`` and its grad drops
the padding tokens.

Stored fp8 values (``registry.FP8_DTYPES``, ``core.ScaledFp8``): under amp
``elementwise_add`` computes in bf16 when either input is fp8, ``mul``
dequantizes its operands, and both grads dequantize X and Y before the
generic vjp (``register_fp8_transparent_grad``).
"""

import numpy as np
import torch

from ..core import LoDArray
from ..framework import in_var, same_shape_rule, set_out
from ..registry import FP8_DTYPES, dense, register_op, \
    register_fp8_transparent_grad


def _data(x):
    """A ragged value's padded data; a dense value itself."""
    return x.data if isinstance(x, LoDArray) else x


def _rewrap(template, val):
    """``val`` with ``template``'s lengths when ``template`` is ragged."""
    return LoDArray(val, template.length) \
        if isinstance(template, LoDArray) else val


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
            dtype=x.dtype, lod_level=x.lod_level)


@register_op("mul", infer_shape=_mul_rule, ragged=True)
def _mul(ctx, ins):
    x0, y = ins["X"][0], dense(_data(ins["Y"][0]))
    x = dense(_data(x0))
    xn = ctx.attr("x_num_col_dims", 1)
    yn = ctx.attr("y_num_col_dims", 1)
    if isinstance(x0, LoDArray):
        # the IR's [-1, feat] is [B, L, *feat]: the rows are the tokens
        xn += 1
    if ctx.amp:
        x, y = x.to(torch.bfloat16), y.to(torch.bfloat16)
    rows = int(np.prod(x.shape[:xn]))
    out = _matmul_f32_acc(x.reshape(rows, -1),
                         y.reshape(int(np.prod(y.shape[:yn])), -1))
    out = out.reshape(tuple(x.shape[:xn]) + tuple(y.shape[yn:]))
    return {"Out": [_rewrap(x0, out)]}


def _bcast_y(x, y, axis):
    """Reference broadcast: y's dims align to x's dims starting at
    ``axis``."""
    if x.dim() == y.dim():
        return y
    if axis is None or axis == -1:
        axis = x.dim() - y.dim()
    return y.reshape([1] * axis + list(y.shape) +
                     [1] * (x.dim() - axis - y.dim()))


@register_op("elementwise_add", infer_shape=same_shape_rule(), ragged=True)
def _elementwise_add(ctx, ins):
    x0, y0 = ins["X"][0], ins["Y"][0]
    x, y = _data(x0), _data(y0)
    if ctx.amp and (x.dtype in FP8_DTYPES or y.dtype in FP8_DTYPES):
        # stored fp8 computes in bf16 (also when both sides are fp8)
        x, y = dense(x).to(torch.bfloat16), dense(y).to(torch.bfloat16)
    axis = ctx.attr("axis", -1)
    if isinstance(x0, LoDArray) and not isinstance(y0, LoDArray) and \
            axis is not None and axis >= 1:
        # a ragged X's IR axes count per-token dims; its data has the
        # padded sequence axis at 1
        axis += 1
    y = _bcast_y(x, y, axis)
    if ctx.amp and x.dtype != y.dtype and \
            {x.dtype, y.dtype} == {torch.bfloat16, torch.float32}:
        x, y = x.to(torch.bfloat16), y.to(torch.bfloat16)
    return {"Out": [_rewrap(x0, x + y)]}


register_fp8_transparent_grad("elementwise_add", ("X", "Y"))
register_fp8_transparent_grad("mul", ("X", "Y"))


def _sum_rule(block, op):
    x = in_var(block, op, "X")
    set_out(block, op, "Out", x.shape, dtype=x.dtype,
            lod_level=x.lod_level)


@register_op("sum", infer_shape=_sum_rule, ragged=True)
def _sum(ctx, ins):
    xs = [v for v in ins["X"] if v is not None]
    out = _data(xs[0])
    for v in xs[1:]:
        out = out + _data(v)
    return {"Out": [_rewrap(xs[0], out)]}


@register_op("scale", infer_shape=same_shape_rule(), ragged=True)
def _scale(ctx, ins):
    x0 = ins["X"][0]
    x = _data(x0)
    s, b = ctx.attr("scale", 1.0), ctx.attr("bias", 0.0)
    out = x * s + b if ctx.attr("bias_after_scale", True) else (x + b) * s
    return {"Out": [_rewrap(x0, out)]}


def _mean_rule(block, op):
    set_out(block, op, "Out", [1], dtype=in_var(block, op, "X").dtype)


@register_op("mean", infer_shape=_mean_rule, ragged=True)
def _mean(ctx, ins):
    """The mean of X; of a ragged X over its valid tokens only (the
    padding does not dilute it), its mask and count summed in fp32
    whatever the data's dtype (a bf16 count stops at 256 tokens)."""
    x = ins["X"][0]
    if not isinstance(x, LoDArray):
        return {"Out": [torch.mean(x)]}
    m = x.mask(torch.float32)
    m = m.reshape(tuple(m.shape) + (1,) * (x.data.dim() - m.dim()))
    denom = torch.clamp_min(m.sum(), 1.0) * (x.data.numel() / m.numel())
    return {"Out": [((x.data.float() * m).sum() / denom).to(x.data.dtype)]}


def _lookup_ids(ids):
    """Token ids without a trailing feature axis of 1 ([b, 1] dense,
    [b, t, 1] ragged — ragged ids are token-scalar [b, t] already), as
    longs."""
    d = _data(ids)
    min_dim = 3 if isinstance(ids, LoDArray) else 2
    if d.dim() >= min_dim and d.shape[-1] == 1:
        d = d.squeeze(-1)
    return d.long()


def _lookup_table_rule(block, op):
    w, ids = in_var(block, op, "W"), in_var(block, op, "Ids")
    if ids.lod_level:
        set_out(block, op, "Out", [-1, w.shape[-1]], dtype=w.dtype,
                lod_level=ids.lod_level)
        return
    out = list(ids.shape)
    if out and out[-1] == 1:
        out = out[:-1]
    set_out(block, op, "Out", out + [w.shape[-1]], dtype=w.dtype)


@register_op("lookup_table", infer_shape=_lookup_table_rule, ragged=True)
def _lookup_table(ctx, ins):
    w, ids0 = ins["W"][0], ins["Ids"][0]
    ids = _lookup_ids(ids0)
    out = w[ids.clamp(0, w.shape[0] - 1)]
    if ctx.amp and out.dtype == torch.float32:
        out = out.to(torch.bfloat16)
    padding_idx = ctx.attr("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        out = out.masked_fill((ids == padding_idx)[..., None], 0.0)
    return {"Out": [_rewrap(ids0, out)]}


@register_op("lookup_table_grad", no_grad=True, ragged=True)
def _lookup_table_grad(ctx, ins):
    """Dense scatter-add of the output grad into the table's rows (the
    reference's custom grad; sparse SelectedRows grads are not ported)."""
    if ctx.attr("is_sparse", False):
        raise NotImplementedError("is_sparse embeddings (SelectedRows "
                                  "grads) are not ported yet")
    w, ids0 = ins["W"][0], ins["Ids"][0]
    ids = _lookup_ids(ids0).reshape(-1)
    g = _data(ins["Out@GRAD"][0])
    g = g.reshape((ids.shape[0],) + tuple(g.shape[-(w.dim() - 1):]))
    if isinstance(ids0, LoDArray):
        # padding tokens add nothing (the reference points them past the
        # table, then clips them onto its last row with a zero grad)
        valid = ids0.bool_mask().reshape(-1)
        g = torch.where(valid[:, None], g, 0.0)
        ids = torch.where(valid, ids, w.shape[0])
    gw = torch.zeros_like(w).index_add_(0, ids.clamp(0, w.shape[0] - 1),
                                        g.to(w.dtype))
    return {"W@GRAD": [gw]}
