"""Weights carried across from the JAX package.

``params_from_jax(tree)`` takes the reference decoder's parameter pytree
as numpy arrays (``TransformerDecoderModel.init_params`` output passed
through ``np.asarray`` leaf by leaf) and returns the port's parameter
dict: the same tree of names, each leaf a tensor. The on-disk route is
``serving.load_decoder`` on a directory the JAX ``save_decoder`` wrote.
"""

import numpy as np
import torch

from . import resolve_device

__all__ = ["params_from_jax", "array_to_tensor"]


def array_to_tensor(arr, dtype=None, device="cpu"):
    """A numpy float array as a tensor on ``device`` (cast to ``dtype``
    when given). bfloat16 arrays — ml_dtypes' type, or the 2-byte void
    records ``np.load`` returns for them — are widened exactly to fp32
    first: numpy itself has no bfloat16."""
    arr = np.asarray(arr)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:   # bf16 bits
        arr = (arr.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    t = torch.tensor(arr)   # a copy: the source may be read-only
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_jax(tree, device=None):
    """The port's parameter dict from a reference params pytree of numpy
    arrays, on ``device``. Each leaf keeps its float width; bfloat16
    leaves arrive as float32 (exact — cast with ``.to`` to serve them in
    bf16). Weight-quantized leaves (``{"qw", "scale"}``) are refused:
    quantized weights are not ported yet."""
    dev = resolve_device(device)

    def leaf(name, v):
        if isinstance(v, dict):
            raise ValueError("parameter %r is weight-quantized; quantized "
                             "weights are not ported yet" % name)
        return array_to_tensor(v, device=dev)

    out = {}
    for key, value in tree.items():
        if key == "blocks":
            out[key] = [{n: leaf("blocks.%d.%s" % (i, n), a)
                         for n, a in blk.items()}
                        for i, blk in enumerate(value)]
        else:
            out[key] = leaf(key, value)
    return out
