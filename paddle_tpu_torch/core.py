"""Places and dtypes of the training path — the port of
``paddle_tpu/core.py``'s places and ``convert_dtype``.

A place names a ``torch.device``: ``CUDAPlace(i)`` is ``cuda:i`` and
raises without a GPU (through :func:`paddle_tpu_torch.resolve_device`),
``CPUPlace()`` is the CPU. Ragged (LoD) values are not ported yet.
"""

import numpy as np
import torch

from . import resolve_device

__all__ = ["Place", "CPUPlace", "CUDAPlace", "SUPPORTED_DTYPES",
           "convert_dtype", "torch_dtype"]

# VarDesc dtype names, as numpy-style strings (the reference's list)
SUPPORTED_DTYPES = (
    "bool", "int8", "uint8", "int16", "int32", "int64",
    "float16", "bfloat16", "float32", "float64",
)


def convert_dtype(dtype):
    """A user dtype (str, numpy or torch dtype) as its canonical name."""
    if dtype is None:
        return None
    if isinstance(dtype, str):
        name = dtype
    elif isinstance(dtype, torch.dtype):
        name = str(dtype).split(".")[-1]
    else:
        name = np.dtype(dtype).name
    if name not in SUPPORTED_DTYPES:
        raise ValueError("unsupported dtype %r" % (dtype,))
    return name


def torch_dtype(dtype):
    return getattr(torch, convert_dtype(dtype))


class Place:
    """Device identity (the reference's Place)."""

    device_type = None

    def __init__(self, device_id=0):
        self.device_id = device_id

    def __repr__(self):
        return "%s(%d)" % (type(self).__name__, self.device_id)

    def torch_device(self):
        return resolve_device(torch.device(self.device_type, self.device_id)
                              if self.device_type == "cuda"
                              else self.device_type)


class CPUPlace(Place):
    device_type = "cpu"


class CUDAPlace(Place):
    device_type = "cuda"
