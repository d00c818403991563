"""Activation ops on dense and ragged inputs — the port of
``paddle_tpu/ops/activation_ops.py``'s ``_unary`` for ``tanh`` and
``sigmoid`` (the activations an ``fc(act=...)`` of the sequence models
emits). A ragged input's lengths pass through unchanged; the grads are
the generic vjp. ``relu`` and ``gelu`` live in ``nn_ops``; the
reference's other activations are not ported yet.
"""

import torch

from ..core import LoDArray
from ..framework import same_shape_rule
from ..registry import register_op


def _unary(op_type, fn):
    def lowering(ctx, ins):
        x = ins["X"][0]
        if isinstance(x, LoDArray):
            return {"Out": [LoDArray(fn(x.data), x.length)]}
        return {"Out": [fn(x)]}
    register_op(op_type, lowering=lowering, infer_shape=same_shape_rule())


_unary("sigmoid", torch.sigmoid)
_unary("tanh", torch.tanh)
