"""Weights and training state carried across from the JAX package.

``params_from_jax(tree)`` takes the reference decoder's parameter pytree
as numpy arrays (``TransformerDecoderModel.init_params`` output passed
through ``np.asarray`` leaf by leaf) and returns the port's parameter
dict: the same tree of names, each leaf a tensor. The on-disk route is
``serving.load_decoder`` on a directory the JAX ``save_decoder`` wrote.

``scope_from_jax(persistables)`` takes a reference training scope's
persistables (parameters, Adam moments, beta powers, learning rate) as a
name → numpy dict and returns the port's ``Scope`` holding them as
tensors, so a program built in both packages starts from one state.
"""

import numpy as np
import torch

from . import resolve_device

__all__ = ["params_from_jax", "array_to_tensor", "quant_payload_to_tensor",
           "scope_from_jax"]


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


def quant_payload_to_tensor(arr, mode=None, device="cpu"):
    """A weight-quantized payload (numpy) as an int8 or float8_e4m3fn
    tensor on ``device``, bit for bit. ``mode`` (``int8|fp8``) names the
    storage type of raw bytes (uint8, as npz files store fp8); without it
    the array's own type decides (int8, or the reference's in-memory
    float8_e4m3fn)."""
    arr = np.ascontiguousarray(arr)
    if mode is None:
        mode = {"int8": "int8", "float8_e4m3fn": "fp8"}.get(arr.dtype.name)
    if mode not in ("int8", "fp8") or arr.dtype.itemsize != 1:
        raise ValueError("a quantized weight payload is int8 or "
                         "float8_e4m3fn bytes (got %s, mode %r)"
                         % (arr.dtype, mode))
    raw = torch.from_numpy(arr.view(np.uint8).copy())
    return raw.view(torch.int8 if mode == "int8"
                    else torch.float8_e4m3fn).to(device)


def params_from_jax(tree, device=None):
    """The port's parameter dict from a reference params pytree of numpy
    arrays, on ``device``. Each leaf keeps its float width; bfloat16
    leaves arrive as float32 (exact — cast with ``.to`` to serve them in
    bf16). Weight-quantized leaves (``{"qw", "scale"}``) carry their
    int8/fp8 payload bit for bit and their fp32 scales."""
    dev = resolve_device(device)

    def leaf(name, v):
        if isinstance(v, dict):
            if set(v) != {"qw", "scale"}:
                raise ValueError("parameter %r: a quantized leaf has qw and "
                                 "scale (got %s)" % (name, sorted(v)))
            return {"qw": quant_payload_to_tensor(v["qw"], device=dev),
                    "scale": array_to_tensor(v["scale"], torch.float32,
                                             dev)}
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


def scope_from_jax(persistables, device=None):
    """A port ``Scope`` holding each name → numpy array of
    ``persistables`` as a tensor on ``device`` (None → cuda).
    Float arrays keep their width (bf16 arrives as exact fp32); integer
    arrays keep their type."""
    from .executor import Scope
    dev = resolve_device(device)
    scope = Scope()
    for name, arr in persistables.items():
        scope.set_var(name, array_to_tensor(arr, device=dev))
    return scope
