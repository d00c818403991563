"""Convolution, pooling, normalization, activation and loss ops of the
training slices — ports of ``paddle_tpu/ops/nn_ops.py``'s ``conv2d``,
``pool2d``, ``batch_norm``, ``layer_norm`` and ``dropout``,
``activation_ops.py``'s ``gelu`` and ``relu`` (with its analytic grad),
and ``loss_ops.py``'s ``softmax``, ``cross_entropy`` and
``softmax_with_cross_entropy`` (with its analytic grad). Plain PyTorch:
the reference leaves them to XLA, and no TPU kernel computes them.
``conv2d`` and its analytic grad call cuDNN on the card (``F.conv2d``,
``aten.convolution_backward``); the other convolution ops (3-D,
depthwise, transposed) are not ported and are not registered.
Statistics (layer-norm and batch-norm mean/var, the softmaxes) stay fp32
under amp. ``softmax_with_cross_entropy`` and its grad take ragged
logits and labels (``core.LoDArray``) and keep their lengths, so a
``sequence_pool`` after it leaves the padding out; ``relu``, ``gelu``
and ``dropout`` keep a ragged input's lengths, and ``layer_norm`` of a
ragged input returns a dense ``Y``, as the reference's does.

The reference's fp8 stores, under amp: ``PADDLE_TPU_FP8_ACTS`` stores
relu, gelu and layer-norm outputs as e4m3 (``activation_ops._store_fp8``),
``PADDLE_TPU_FP8_CONV_OUT`` a 2-D conv's output as e4m3 (``1``/``e4m3``),
e5m2, a ``core.ScaledFp8`` (``scaled``), or a ``ScaledFp8`` under the
scale the layer's state carried from the last step (``delayed``).
``pool2d``, ``batch_norm`` and the conv read them dequantized
(``registry.dense``); the grads of ``pool2d``, ``batch_norm``,
``layer_norm`` and ``gelu`` dequantize their input before the generic
vjp, the last two with the stores off in the re-run; ``conv2d_grad`` and
``relu_grad`` are analytic and never store.
"""

import os

import numpy as np
import torch
import torch.nn.functional as F

from ..core import ScaledFp8
from ..framework import in_var, same_shape_rule, set_out
from ..registry import FP8_DTYPES, cast_fp8, dense, fp8_store_enabled, \
    make_generic_grad_lowering, no_fp8_store, register_fp8_transparent_grad, \
    register_op
from .activation_ops import _store_fp8
from .math_ops import _data, _rewrap


def _layer_norm_rule(block, op):
    x = in_var(block, op, "X")
    begin = op.attr("begin_norm_axis", 1)
    set_out(block, op, "Y", x.shape, dtype=x.dtype)
    set_out(block, op, "Mean", x.shape[:begin], dtype="float32")
    set_out(block, op, "Variance", x.shape[:begin], dtype="float32")


@register_op("layer_norm", infer_shape=_layer_norm_rule, ragged=True)
def _layer_norm(ctx, ins):
    """Normalized over the axes from ``begin_norm_axis`` on, statistics in
    fp32, Y in X's dtype (stored as e4m3 under ``PADDLE_TPU_FP8_ACTS``).
    A ragged X is normalized as its padded data, and Y is dense."""
    x0 = _data(ins["X"][0])
    x = dense(x0, torch.float32).float()
    eps = ctx.attr("epsilon", 1e-5)
    begin = ctx.attr("begin_norm_axis", 1)
    red = tuple(range(begin, x.dim()))
    mean = x.mean(dim=red, keepdim=True)
    var = (x - mean).square().mean(dim=red, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    feat_shape = [1] * begin + list(x.shape[begin:])
    if ins.get("Scale") and ins["Scale"][0] is not None:
        y = y * ins["Scale"][0].reshape(feat_shape)
    if ins.get("Bias") and ins["Bias"][0] is not None:
        y = y + ins["Bias"][0].reshape(feat_shape)
    y = cast_fp8(y, x0.dtype) if x0.dtype in FP8_DTYPES else y.to(x0.dtype)
    return {"Y": [_store_fp8(ctx, y)],
            "Mean": [mean.reshape(mean.shape[:begin])],
            "Variance": [var.reshape(var.shape[:begin])]}


@register_op("gelu", infer_shape=same_shape_rule(), ragged=True)
def _gelu(ctx, ins):
    """The exact erf form by default, tanh under attr approximate=True;
    stored as e4m3 under ``PADDLE_TPU_FP8_ACTS``. A raw fp8 X gives an
    Out in its own format, as the reference's does (there ``jax.nn.gelu``
    computes in that format; here from the bf16 dequant, rounded once)."""
    x0 = ins["X"][0]
    x = _data(x0)
    out = F.gelu(dense(x), approximate="tanh" if ctx.attr(
        "approximate", False) else "none")
    out = cast_fp8(out, x.dtype) if _raw_fp8(x) else _store_fp8(ctx, out)
    return {"Out": [_rewrap(x0, out)]}


# the re-run of a storing forward keeps its output bf16 (no_fp8_store), so
# the cotangent is never coerced to e4m3
register_fp8_transparent_grad("gelu", ("X",), around_vjp=no_fp8_store)
register_fp8_transparent_grad("layer_norm", ("X",), around_vjp=no_fp8_store)


def _softmax_with_ce_rule(block, op):
    x = in_var(block, op, "Logits")
    set_out(block, op, "Softmax", x.shape, dtype=x.dtype,
            lod_level=x.lod_level)
    set_out(block, op, "Loss", list(x.shape[:-1]) + [1], dtype=x.dtype,
            lod_level=x.lod_level)


def _hard_labels(label, logits):
    if label.dim() == logits.dim() and label.shape[-1] == 1:
        label = label.squeeze(-1)
    return label.long()


@register_op("softmax_with_cross_entropy", infer_shape=_softmax_with_ce_rule,
             ragged=True)
def _softmax_with_ce(ctx, ins):
    """Loss = lse − logits[label] in fp32 (or Σ label·(lse − logits) for
    soft labels); Softmax = exp(logits − lse)."""
    x0 = ins["Logits"][0]
    logits, label = _data(x0), _data(ins["Label"][0])
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1, keepdim=True)
    if ctx.attr("soft_label", False):
        loss = (label * (lse - lf)).sum(-1, keepdim=True)
    else:
        picked = lf.gather(-1, _hard_labels(label, logits)[..., None])
        loss = lse - picked
    return {"Softmax": [_rewrap(x0, torch.exp(lf - lse))],
            "Loss": [_rewrap(x0, loss)]}


@register_op("softmax_with_cross_entropy_grad", no_grad=True, ragged=True)
def _softmax_with_ce_grad(ctx, ins):
    """Analytic grad: dLogits = (softmax − target) · dLoss, in the logits'
    dtype. The hard-label target is subtracted in place at the label
    column instead of materializing a one-hot [rows, classes] tensor.
    Falls back to the generic vjp when Softmax itself has a grad."""
    if ins.get("Softmax@GRAD", [None])[0] is not None \
            or ctx.op.outputs.get("Label@GRAD"):
        return make_generic_grad_lowering("softmax_with_cross_entropy")(
            ctx, ins)
    x0 = ins["Logits"][0]
    logits, label = _data(x0), _data(ins["Label"][0])
    g = _data(ins["Loss@GRAD"][0]).float()
    p = torch.softmax(logits.float(), dim=-1)
    if ctx.attr("soft_label", False):
        p = p - label.float()
    else:
        p.scatter_add_(-1, _hard_labels(label, logits)[..., None],
                       torch.full(p.shape[:-1] + (1,), -1.0,
                                  device=p.device))
    g = g.reshape(g.shape + (1,) * (p.dim() - g.dim())) \
        if g.dim() < p.dim() else g
    return {"Logits@GRAD": [_rewrap(x0, (p * g).to(logits.dtype))]}


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v]


def _to_nchw(x, fmt):
    """An NHWC tensor as the NCHW view cuDNN takes its channels-last
    kernels for (a copy only where x's memory is not NHWC already)."""
    if fmt != "NHWC":
        return x
    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _from_nchw(y, fmt):
    return y.permute(0, 2, 3, 1) if fmt == "NHWC" else y


# -- conv2d ------------------------------------------------------------------

def _conv_out_dim(d, k, pad, stride, dil):
    return -1 if d < 0 else (d + 2 * pad - (dil * (k - 1) + 1)) // stride + 1


def _conv2d_rule(block, op):
    x, w = in_var(block, op, "Input"), in_var(block, op, "Filter")
    nhwc = op.attr("data_format", "NCHW") == "NHWC"
    spatial = [_conv_out_dim(d, k, p, s, dl) for d, k, p, s, dl in zip(
        x.shape[1:3] if nhwc else x.shape[2:], w.shape[2:],
        _pair(op.attr("paddings", 0)), _pair(op.attr("strides", 1)),
        _pair(op.attr("dilations", 1)))]
    out_c = w.shape[0]          # the filter is OIHW in either layout
    set_out(block, op, "Output",
            [x.shape[0]] + spatial + [out_c] if nhwc
            else [x.shape[0], out_c] + spatial, dtype=x.dtype)


def _conv_operands(ctx, ins):
    """(x as NCHW, filter, compute dtype, conv args): bf16 operands under
    amp, a stored fp8 input dequantized. On the CPU a bf16 conv is taken
    in fp32 from the bf16 operands and rounded once, as cuDNN accumulates
    bf16 products in fp32."""
    fmt = ctx.attr("data_format", "NCHW")
    x, w = dense(ins["Input"][0]), ins["Filter"][0]
    dtype = torch.bfloat16 if ctx.amp else x.dtype
    x, w = _to_nchw(x.to(dtype), fmt), w.to(dtype)
    if dtype == torch.bfloat16 and x.device.type == "cpu":
        x, w = x.float(), w.float()
    args = (_pair(ctx.attr("strides", 1)), _pair(ctx.attr("paddings", 0)),
            _pair(ctx.attr("dilations", 1)), ctx.attr("groups", 1) or 1)
    return x, w, dtype, fmt, args


@register_op("conv2d", infer_shape=_conv2d_rule)
def _conv2d(ctx, ins):
    """2-D convolution, NCHW or NHWC activations, OIHW filter; strides,
    paddings, dilations and groups. Under amp bf16 operands, fp32 sums,
    bf16 output — stored as fp8 under ``PADDLE_TPU_FP8_CONV_OUT``
    (``_conv_out_store``)."""
    x, w, dtype, fmt, (stride, pad, dil, groups) = _conv_operands(ctx, ins)
    out = F.conv2d(x, w, None, stride, pad, dil, groups)
    return _conv_out_store(ctx, ins, _from_nchw(out.to(dtype), fmt))


_CONV_OUT_MODES = ("1", "e4m3", "e5m2", "scaled", "delayed")


def _conv_out_store(ctx, ins, out):
    """The conv's outputs under ``PADDLE_TPU_FP8_CONV_OUT``: with amp, a
    bf16 output and the store enabled, ``1``/``e4m3`` stores e4m3,
    ``e5m2`` e5m2, ``scaled`` a ``ScaledFp8`` of this output's amax, and
    ``delayed`` (with the layer's ``Fp8Scale`` state; without it, as
    ``scaled``) a ``ScaledFp8`` under last step's scale, with the next
    step's scale as ``Fp8ScaleOut``."""
    mode = os.environ.get("PADDLE_TPU_FP8_CONV_OUT", "0")
    if not (ctx.amp and mode not in ("", "0") and
            out.dtype == torch.bfloat16 and fp8_store_enabled()):
        return {"Output": [out]}
    if mode not in _CONV_OUT_MODES:
        raise ValueError(
            "PADDLE_TPU_FP8_CONV_OUT must be one of '', '0', '1', "
            "'e4m3', 'e5m2', 'scaled', 'delayed'; got %r" % mode)
    scale_in = (ins.get("Fp8Scale") or [None])[0]
    if mode == "delayed" and scale_in is not None:
        return _delayed_fp8(out, scale_in)
    if mode in ("scaled", "delayed"):
        return {"Output": [ScaledFp8.quantize(out)]}
    return {"Output": [cast_fp8(out, torch.float8_e5m2 if mode == "e5m2"
                                else torch.float8_e4m3fn)]}


def _delayed_fp8(out, scale_in):
    """Delayed per-tensor scaling, the reference's rules: quantize with
    the scale state of the last step (0.0, unseeded: this step's amax x
    1.1/448), clamped to ±448 (e4m3fn has no infinity); the next step's
    scale doubles when the payload saturated (max|q| >= 447), else
    max(max|q|, 1e-3) x scale x 1.1/448. The seed is a ``torch.where``
    over both branches, with no host read: it runs inside a captured
    step."""
    sc = scale_in.reshape(()).float()
    outf = out.float()
    seed = torch.clamp_min(outf.abs().amax(), 1e-3) * (1.1 / 448.0)
    sc = torch.where(sc > 0.0, sc, seed)
    q = cast_fp8((outf / sc).clamp(-448.0, 448.0), torch.float8_e4m3fn)
    maxq = q.float().abs().amax()
    new_scale = torch.where(maxq >= 447.0, sc * 2.0,
                            torch.clamp_min(maxq, 1e-3) * sc * (1.1 / 448.0))
    return {"Output": [ScaledFp8(q, sc)],
            "Fp8ScaleOut": [new_scale.reshape(scale_in.shape).float()]}


@register_op("conv2d_grad", no_grad=True)
def _conv2d_grad(ctx, ins):
    """Analytic grad: dInput and dFilter from the saved input and filter
    (``aten.convolution_backward``, cuDNN's backward-data and
    backward-filter on the card) — the generic vjp would re-run the
    forward convolution. Each grad is rounded to the compute dtype, then
    cast to its variable's dtype (bf16 dFilter → the fp32 filter's). A
    stored fp8 input is dequantized; nothing is stored."""
    want_x = bool(ctx.op.outputs.get("Input@GRAD", [""])[0])
    want_w = bool(ctx.op.outputs.get("Filter@GRAD", [""])[0])
    x, w, dtype, fmt, (stride, pad, dil, groups) = _conv_operands(ctx, ins)
    g = _to_nchw(ins["Output@GRAD"][0].to(dtype), fmt).to(x.dtype)
    dx, dw, _ = torch.ops.aten.convolution_backward(
        g, x, w, None, stride, pad, dil, False, [0, 0], groups,
        [want_x, want_w, False])
    outs = {}
    if want_x:
        # a stored fp8 input's grad is bf16, its dequant's dtype
        xdt = ins["Input"][0].dtype
        dx = _from_nchw(dx.to(dtype), fmt)
        outs["Input@GRAD"] = [dx.to(
            torch.bfloat16 if xdt in FP8_DTYPES else xdt)]
    if want_w:
        outs["Filter@GRAD"] = [dw.to(dtype).to(ins["Filter"][0].dtype)]
    return outs


# -- pool2d ------------------------------------------------------------------

def _pool_geometry(attr, spatial):
    """(ksize, strides, paddings); global pooling takes the whole map."""
    if attr("global_pooling", False):
        return list(spatial), [1, 1], [0, 0]
    return (_pair(attr("ksize", 2)), _pair(attr("strides", 1)),
            _pair(attr("paddings", 0)))


def _pool2d_rule(block, op):
    if op.attr("ceil_mode", False):
        raise NotImplementedError("pool2d ceil_mode is not ported")
    x = in_var(block, op, "X")
    nhwc = op.attr("data_format", "NCHW") == "NHWC"
    in_spatial = x.shape[1:3] if nhwc else x.shape[2:]
    ksize, strides, paddings = _pool_geometry(op.attr, in_spatial)
    spatial = [-1 if d < 0 else (d + 2 * p - k) // s + 1
               for d, k, p, s in zip(in_spatial, ksize, paddings, strides)]
    set_out(block, op, "Out",
            [x.shape[0]] + spatial + [x.shape[-1]] if nhwc
            else list(x.shape[:2]) + spatial, dtype=x.dtype)


@register_op("pool2d", infer_shape=_pool2d_rule)
def _pool2d(ctx, ins):
    """Max or average pooling, NCHW or NHWC. Max pads with −inf; average
    sums the window and divides by its size, or — when ``exclusive``
    (the default) and there is padding — by the count of real inputs
    in it."""
    fmt = ctx.attr("data_format", "NCHW")
    x = _to_nchw(dense(ins["X"][0]), fmt)
    spatial = tuple(x.shape[2:])
    ksize, strides, (ph, pw) = _pool_geometry(ctx.attr, spatial)
    is_max = ctx.attr("pooling_type", "max") == "max"
    padded = bool(ph or pw)
    if padded:
        x = F.pad(x, (pw, pw, ph, ph), value=-float("inf") if is_max
                  else 0.0)
    if is_max:
        out = F.max_pool2d(x, ksize, strides)
    else:
        out = F.avg_pool2d(x, ksize, strides, divisor_override=1)
        if ctx.attr("exclusive", True) and padded:
            ones = torch.ones((1, 1) + spatial, dtype=x.dtype,
                              device=x.device)
            counts = F.avg_pool2d(F.pad(ones, (pw, pw, ph, ph)), ksize,
                                  strides, divisor_override=1)
            out = out / counts
        else:
            out = out / float(np.prod(ksize))
    return {"Out": [_from_nchw(out, fmt)]}


register_fp8_transparent_grad("pool2d", ("X",))


# -- batch_norm --------------------------------------------------------------

def _batch_norm_rule(block, op):
    x = in_var(block, op, "X")
    axis = 1 if op.attr("data_layout", "NCHW") == "NCHW" else len(x.shape) - 1
    set_out(block, op, "Y", x.shape, dtype=x.dtype)
    for slot in ("MeanOut", "VarianceOut", "SavedMean", "SavedVariance"):
        set_out(block, op, slot, [x.shape[axis]], dtype="float32")


_CANCEL_FLOOR = float(np.finfo(np.float32).eps) / 4


@register_op("batch_norm", infer_shape=_batch_norm_rule)
def _batch_norm(ctx, ins):
    """Batch normalization as the reference computes it: in training,
    fp32 statistics from one read of x shifted by the running mean m0
    (detached), var = E[(x−m0)²] − E[x−m0]², floored straight-through at
    eps/4·E[x−m0]² against fp32 cancellation; the moving statistics
    updated with ``momentum``; y = x·a + b per channel, cast back to x's
    dtype (bf16 for a stored fp8 x, normalized from its dequant).
    ``is_test`` normalizes with the moving statistics."""
    x = dense(ins["X"][0])
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    mean, var = ins["Mean"][0], ins["Variance"][0]
    eps = ctx.attr("epsilon", 1e-5)
    momentum = ctx.attr("momentum", 0.9)
    axis = 1 if ctx.attr("data_layout", "NCHW") == "NCHW" else x.dim() - 1
    red = tuple(i for i in range(x.dim()) if i != axis)
    bshape = [1] * x.dim()
    bshape[axis] = x.shape[axis]
    if ctx.attr("is_test", False) or ctx.is_test:
        use_mean, use_var = mean, var
        mean_out, var_out = mean, var
    else:
        m0 = mean.float().detach()
        xs = x.float() - m0.reshape(bshape)
        d_mean = xs.mean(dim=red)
        use_mean = d_mean + m0
        v1 = xs.square().mean(dim=red) - d_mean.square()
        floor = _CANCEL_FLOOR * d_mean.square()
        use_var = v1 + (floor - v1).clamp_min(0.0).detach()
        mean_out = momentum * mean + (1 - momentum) * use_mean
        var_out = momentum * var + (1 - momentum) * use_var
    inv_std = torch.rsqrt(use_var + eps)
    scale = scale.reshape(use_var.shape)
    a = inv_std * scale
    b = bias.reshape(use_var.shape) - use_mean * inv_std * scale
    y = x * a.reshape(bshape) + b.reshape(bshape)
    return {"Y": [y.to(x.dtype)], "MeanOut": [mean_out],
            "VarianceOut": [var_out], "SavedMean": [use_mean],
            "SavedVariance": [use_var]}


register_fp8_transparent_grad("batch_norm", ("X",))


# -- dropout -----------------------------------------------------------------

def _dropout_rule(block, op):
    x = in_var(block, op, "X")
    if x is not None and x.shape is not None:
        set_out(block, op, "Out", x.shape, dtype=x.dtype)
        set_out(block, op, "Mask", x.shape, dtype=x.dtype)


@register_op("dropout", infer_shape=_dropout_rule, ragged=True)
def _dropout(ctx, ins):
    """The reference's "downgrade_in_infer" dropout: in training
    ``Out = X * Mask`` with ``Mask`` kept with probability 1 - p and no
    rescale; in test ``Out = X * (1 - p)`` and ``Mask`` all ones. The
    draw is the op's counter stream (``ctx.rng()``), so a captured step
    draws a fresh mask at every replay. A ragged X's ``Out`` keeps its
    lengths; ``Mask`` is dense."""
    x0 = ins["X"][0]
    x = _data(x0)
    p = ctx.attr("dropout_prob", 0.5)
    if ctx.attr("is_test", False) or ctx.is_test:
        return {"Out": [_rewrap(x0, x * (1.0 - p))],
                "Mask": [torch.ones_like(x)]}
    keep = ctx.rng().uniform(x.shape) < (1.0 - p)
    mask = keep.to(x.dtype)
    return {"Out": [_rewrap(x0, x * mask)], "Mask": [mask]}


@register_op("dropout_grad", no_grad=True, ragged=True)
def _dropout_grad(ctx, ins):
    """dx = g·Mask, from the forward's saved mask: the backward never
    draws again. A ragged X's grad keeps its lengths."""
    g, mask = _data(ins["Out@GRAD"][0]), ins["Mask"][0]
    return {"X@GRAD": [_rewrap(ins["X"][0], g * mask.to(g.dtype))]}


# -- relu, softmax, cross_entropy --------------------------------------------

@register_op("relu", infer_shape=same_shape_rule(), ragged=True)
def _relu(ctx, ins):
    """max(x, 0), stored as e4m3 under ``PADDLE_TPU_FP8_ACTS``. A raw fp8
    X keeps its format (``_relu_fp8``), as the reference's does."""
    x0 = ins["X"][0]
    x = _data(x0)
    out = _relu_fp8(x) if _raw_fp8(x) else \
        _store_fp8(ctx, torch.relu(dense(x)))
    return {"Out": [_rewrap(x0, out)]}


def _raw_fp8(x):
    """An fp8 tensor (not a ``ScaledFp8``, which reads as its bf16
    dequant)."""
    return isinstance(x, torch.Tensor) and x.dtype in FP8_DTYPES


def _relu_fp8(x):
    """relu of a raw fp8 tensor in its own format, on its bytes, as the
    reference's ``jax.nn.relu`` gives it: the negatives and -0 give +0,
    the rest stay — NaN too, with its sign and payload bits (the
    reference's vary with XLA's code path). A NaN's magnitude byte is
    0x7F in e4m3fn and 0x7D-0x7F in e5m2."""
    b = x.view(torch.uint8)
    nan_from = 0x7F if x.dtype == torch.float8_e4m3fn else 0x7D
    neg = (b >= 0x80) & (b < 0x80 + nan_from)
    return torch.where(neg, 0, b).view(x.dtype)


@register_op("relu_grad", no_grad=True, ragged=True)
def _relu_grad(ctx, ins):
    """dx = g·(x > 0), from the forward's input. Analytic, not the
    generic vjp, whose cotangent would take the stored output's fp8
    dtype; an fp8 incoming grad is widened to bf16."""
    x0 = ins["X"][0]
    x, g = dense(_data(x0)), dense(_data(ins["Out@GRAD"][0]))
    return {"X@GRAD": [_rewrap(x0, torch.where(x > 0, g, 0.0))]}


@register_op("softmax", infer_shape=same_shape_rule(), ragged=True)
def _softmax(ctx, ins):
    """Normalized in fp32; the output stays fp32 under amp."""
    x0 = ins["X"][0]
    x = _data(x0)
    out = torch.softmax(x.float(), dim=-1)
    return {"Out": [_rewrap(x0, out if ctx.amp else out.to(x.dtype))]}


def _cross_entropy_rule(block, op):
    x = in_var(block, op, "X")
    set_out(block, op, "Y", list(x.shape[:-1]) + [1], dtype=x.dtype)


@register_op("cross_entropy", infer_shape=_cross_entropy_rule)
def _cross_entropy(ctx, ins):
    """−log(p[label] + 1e-8) for hard labels ([N, 1] ints), or
    −Σ label·log(p + 1e-8) for soft ones, over probabilities p."""
    x, label = ins["X"][0], ins["Label"][0]
    eps = 1e-8
    if ctx.attr("soft_label", False):
        y = -(label * torch.log(x + eps)).sum(-1, keepdim=True)
    else:
        y = -torch.log(x.gather(-1, _hard_labels(label, x)[..., None]) + eps)
    return {"Y": [y]}
