"""Optimizer ops — ports of ``paddle_tpu/ops/optimizer_ops.py``'s ``sgd``
and per-parameter ``adam`` (dense gradients; SelectedRows are not
ported). Plain PyTorch, arithmetic in the reference's order. The executor
writes ParamOut / moment outputs back to the scope under the parameter's
name, as the reference threads them through its compiled step.
"""

import torch

from ..registry import register_op


@register_op("sgd", no_grad=True)
def _sgd(ctx, ins):
    p, g = ins["Param"][0], ins["Grad"][0]
    lr = ins["LearningRate"][0].reshape(())
    return {"ParamOut": [p - lr * g]}


@register_op("adam", no_grad=True)
def _adam(ctx, ins):
    p, g = ins["Param"][0], ins["Grad"][0]
    lr = ins["LearningRate"][0].reshape(())
    m1, m2 = ins["Moment1"][0], ins["Moment2"][0]
    b1p = ins["Beta1Pow"][0].reshape(())
    b2p = ins["Beta2Pow"][0].reshape(())
    b1, b2 = ctx.attr("beta1", 0.9), ctx.attr("beta2", 0.999)
    eps = ctx.attr("epsilon", 1e-8)
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    m1o = b1 * m1 + (1 - b1) * g
    m2o = b2 * m2 + (1 - b2) * g * g
    p_out = p - lr_t * m1o / (torch.sqrt(m2o) + eps)
    return {"ParamOut": [p_out], "Moment1Out": [m1o], "Moment2Out": [m2o]}
