"""Normalization, activation and loss ops of the training slice — ports of
``paddle_tpu/ops/nn_ops.py``'s ``layer_norm``, ``activation_ops.py``'s
``gelu`` and ``loss_ops.py``'s ``softmax_with_cross_entropy`` with its
analytic grad. Plain PyTorch: the reference leaves them to XLA.
Statistics (layer-norm mean/var, the softmax) stay fp32 under amp.
"""

import torch
import torch.nn.functional as F

from ..framework import in_var, same_shape_rule, set_out
from ..registry import make_generic_grad_lowering, register_op


def _layer_norm_rule(block, op):
    x = in_var(block, op, "X")
    begin = op.attr("begin_norm_axis", 1)
    set_out(block, op, "Y", x.shape, dtype=x.dtype)
    set_out(block, op, "Mean", x.shape[:begin], dtype="float32")
    set_out(block, op, "Variance", x.shape[:begin], dtype="float32")


@register_op("layer_norm", infer_shape=_layer_norm_rule)
def _layer_norm(ctx, ins):
    x0 = ins["X"][0]
    x = x0.float()
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
    return {"Y": [y.to(x0.dtype)],
            "Mean": [mean.reshape(mean.shape[:begin])],
            "Variance": [var.reshape(var.shape[:begin])]}


@register_op("gelu", infer_shape=same_shape_rule())
def _gelu(ctx, ins):
    # the exact erf form by default, tanh under attr approximate=True
    return {"Out": [F.gelu(ins["X"][0], approximate="tanh" if ctx.attr(
        "approximate", False) else "none")]}


def _softmax_with_ce_rule(block, op):
    x = in_var(block, op, "Logits")
    set_out(block, op, "Softmax", x.shape, dtype=x.dtype)
    set_out(block, op, "Loss", list(x.shape[:-1]) + [1], dtype=x.dtype)


def _hard_labels(label, logits):
    if label.dim() == logits.dim() and label.shape[-1] == 1:
        label = label.squeeze(-1)
    return label.long()


@register_op("softmax_with_cross_entropy", infer_shape=_softmax_with_ce_rule)
def _softmax_with_ce(ctx, ins):
    """Loss = lse − logits[label] in fp32 (or Σ label·(lse − logits) for
    soft labels); Softmax = exp(logits − lse)."""
    logits, label = ins["Logits"][0], ins["Label"][0]
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1, keepdim=True)
    if ctx.attr("soft_label", False):
        loss = (label * (lse - lf)).sum(-1, keepdim=True)
    else:
        picked = lf.gather(-1, _hard_labels(label, logits)[..., None])
        loss = lse - picked
    return {"Softmax": [torch.exp(lf - lse)], "Loss": [loss]}


@register_op("softmax_with_cross_entropy_grad", no_grad=True)
def _softmax_with_ce_grad(ctx, ins):
    """Analytic grad: dLogits = (softmax − target) · dLoss, in the logits'
    dtype. The hard-label target is subtracted in place at the label
    column instead of materializing a one-hot [rows, classes] tensor.
    Falls back to the generic vjp when Softmax itself has a grad."""
    if ins.get("Softmax@GRAD", [None])[0] is not None \
            or ctx.op.outputs.get("Label@GRAD"):
        return make_generic_grad_lowering("softmax_with_cross_entropy")(
            ctx, ins)
    logits, label = ins["Logits"][0], ins["Label"][0]
    g = ins["Loss@GRAD"][0].float()
    p = torch.softmax(logits.float(), dim=-1)
    if ctx.attr("soft_label", False):
        p = p - label.float()
    else:
        p.scatter_add_(-1, _hard_labels(label, logits)[..., None],
                       torch.full(p.shape[:-1] + (1,), -1.0,
                                  device=p.device))
    g = g.reshape(g.shape + (1,) * (p.dim() - g.dim())) \
        if g.dim() < p.dim() else g
    return {"Logits@GRAD": [(p * g).to(logits.dtype)]}
