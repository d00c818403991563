"""Activation ops on dense and ragged inputs — the port of
``paddle_tpu/ops/activation_ops.py``'s ``_unary`` for ``tanh`` and
``sigmoid`` (the activations an ``fc(act=...)`` of the sequence models
emits). A ragged input's lengths pass through unchanged; the grads are
the generic vjp. ``relu`` and ``gelu`` live in ``nn_ops``; the
reference's other activations are not ported yet.

``_store_fp8`` is the reference's one activation-store tail (relu, gelu
and layer_norm's Y share it): under ``PADDLE_TPU_FP8_ACTS`` and amp a
bf16 output is stored as e4m3 while the store is enabled.
"""

import os

import torch

from ..core import LoDArray
from ..framework import same_shape_rule
from ..registry import cast_fp8, fp8_store_enabled, register_op


def _fp8_acts_on(ctx, out):
    """``PADDLE_TPU_FP8_ACTS`` set (not "" or "0"), amp, a bf16 value, and
    the store enabled (not a grad op's re-run, ``no_fp8_store``)."""
    return (ctx.amp and
            os.environ.get("PADDLE_TPU_FP8_ACTS", "0") not in ("", "0")
            and out.dtype == torch.bfloat16 and fp8_store_enabled())


def _store_fp8(ctx, out):
    """``out`` stored as e4m3 when ``_fp8_acts_on``, else itself."""
    if _fp8_acts_on(ctx, out):
        return cast_fp8(out, torch.float8_e4m3fn)
    return out


def _unary(op_type, fn):
    def lowering(ctx, ins):
        x = ins["X"][0]
        if isinstance(x, LoDArray):
            return {"Out": [LoDArray(fn(x.data), x.length)]}
        return {"Out": [fn(x)]}
    register_op(op_type, lowering=lowering, infer_shape=same_shape_rule(),
                ragged=True)


_unary("sigmoid", torch.sigmoid)
_unary("tanh", torch.tanh)
