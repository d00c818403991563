"""Optimizer ops — ports of ``paddle_tpu/ops/optimizer_ops.py``'s ``sgd``,
``momentum``, per-parameter ``adam`` and whole-model ``fused_adam`` (dense gradients;
SelectedRows are not ported). Arithmetic in the reference's order;
``fused_adam``'s update is K4 (``ops.fused_adam``). The executor writes
ParamOut / moment outputs back to the scope under the parameter's name,
as the reference threads them through its compiled step.
"""

import torch

from ..registry import register_op
from . import fused_adam


@register_op("sgd", no_grad=True)
def _sgd(ctx, ins):
    p, g = ins["Param"][0], ins["Grad"][0]
    lr = ins["LearningRate"][0].reshape(())
    return {"ParamOut": [p - lr * g]}


@register_op("momentum", no_grad=True)
def _momentum(ctx, ins):
    """v' = mu·v + g; p' = p − lr·v', or p − (g + mu·v')·lr with
    ``use_nesterov``."""
    p, v, g = ins["Param"][0], ins["Velocity"][0], ins["Grad"][0]
    lr = ins["LearningRate"][0].reshape(())
    mu = ctx.attr("mu")
    v_out = mu * v + g
    if ctx.attr("use_nesterov", False):
        p_out = p - (g + mu * v_out) * lr
    else:
        p_out = p - lr * v_out
    return {"ParamOut": [p_out], "VelocityOut": [v_out]}


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


def fused_adam_scalars(ins, clip_norm):
    """``(lr_t, gscale)`` of the ``fused_adam`` op as fp32 scalar tensors
    on the params' device, read by K4 from memory (no host sync):
    ``lr_t = lr·sqrt(1 − β2^t)/(1 − β1^t)``; ``gscale`` = 1 / LossScale
    (when given) times the global-norm clip factor ``clip_norm /
    max(‖g·gscale‖, clip_norm)`` (when ``clip_norm`` > 0), the norm summed
    over the gradients in a fixed order, as the reference does."""
    lr = ins["LearningRate"][0].reshape(())
    b1p = ins["Beta1Pow"][0].reshape(())
    b2p = ins["Beta2Pow"][0].reshape(())
    grads = ins["Grad"]
    gscale = torch.ones((), dtype=torch.float32, device=grads[0].device)
    loss_scale = ins.get("LossScale", [None])[0]
    if loss_scale is not None:
        gscale = 1.0 / loss_scale.reshape(()).float()
    if clip_norm and clip_norm > 0:
        gsq = sum(torch.sum(torch.square(g.float() * gscale)) for g in grads)
        gnorm = torch.sqrt(gsq)
        gscale = gscale * (clip_norm / torch.clamp_min(gnorm, clip_norm))
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    return lr_t.float(), gscale.float()


@register_op("fused_adam", no_grad=True)
def _fused_adam(ctx, ins):
    """Whole-model Adam step (the reference's ``fused_adam``): duplicable
    Param/Grad/Moment1/Moment2 slots carry every parameter;
    LearningRate/Beta1Pow/Beta2Pow as in ``adam``; optional LossScale [1]
    divides the gradients first; attr ``clip_norm`` > 0 fuses global-norm
    gradient clipping. One K4 launch on the card, the plain version on
    the CPU."""
    lr_t, gscale = fused_adam_scalars(ins, ctx.attr("clip_norm", 0.0))
    pos, m1os, m2os = fused_adam.fused_adam_update(
        ins["Param"], ins["Grad"], ins["Moment1"], ins["Moment2"], lr_t,
        gscale, ctx.attr("beta1", 0.9), ctx.attr("beta2", 0.999),
        ctx.attr("epsilon", 1e-8))
    return {"ParamOut": pos, "Moment1Out": m1os, "Moment2Out": m2os}
