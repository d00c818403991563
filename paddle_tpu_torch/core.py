"""Places and dtypes of the training path — the port of
``paddle_tpu/core.py``'s places and ``convert_dtype``.

A place names a ``torch.device``: ``CUDAPlace(i)`` is ``cuda:i`` and
raises without a GPU (through :func:`paddle_tpu_torch.resolve_device`),
``CPUPlace()`` is the CPU.

Ragged values (``LoDArray``) carry one level of LoD as padded ``data``
and per-sequence ``length``, the reference's static-shape encoding; the
nested ``LoDArray2`` is not ported yet.
"""

import numpy as np
import torch
import torch.utils._pytree as pytree

from . import resolve_device

__all__ = ["Place", "CPUPlace", "CUDAPlace", "SUPPORTED_DTYPES",
           "convert_dtype", "torch_dtype", "LoDArray"]

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


class LoDArray:
    """A batch of variable-length sequences (one ragged level), as the
    reference stores it:

    - ``data``:   ``[batch, max_len, *feature]`` padded values;
    - ``length``: ``[batch]`` int32 valid lengths.

    The fields are tensors inside a step and numpy arrays on the host
    (``from_sequences``, a ``return_numpy`` fetch). Registered as a
    ``torch.utils._pytree`` node, so ``tree_map`` and the generic grad's
    flattening reach both fields; ``max_len`` is the padded shape, so no
    op needs the lengths on the host."""

    __slots__ = ("data", "length")

    def __init__(self, data, length):
        self.data = data
        self.length = length

    def __repr__(self):
        return "LoDArray(data=%r, length=%r)" % (self.data, self.length)

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def batch(self):
        return self.data.shape[0]

    @property
    def max_len(self):
        return self.data.shape[1]

    def bool_mask(self):
        """[batch, max_len] validity mask, on the data's device."""
        length = torch.as_tensor(self.length)
        pos = torch.arange(self.max_len, device=length.device)
        return pos[None, :] < length[:, None]

    def mask(self, dtype=torch.float32):
        """[batch, max_len] validity mask as ``dtype``."""
        return self.bool_mask().to(dtype)

    @staticmethod
    def from_sequences(seqs, dtype=None, max_len=None, pad_to_multiple=None):
        """Build from a list of per-sequence numpy arrays (host side): the
        padded length is the longest sequence (at least 1), rounded up to
        ``pad_to_multiple``, at least ``max_len``."""
        seqs = [np.asarray(s) for s in seqs]
        lens = np.array([len(s) for s in seqs], dtype=np.int32)
        ml = max(1, int(lens.max()) if len(lens) else 1)
        if pad_to_multiple:
            ml = -(-ml // pad_to_multiple) * pad_to_multiple
        if max_len:
            ml = max(ml, max_len)
        feat = seqs[0].shape[1:] if seqs else ()
        dt = dtype or (seqs[0].dtype if seqs else np.float32)
        out = np.zeros((len(seqs), ml) + tuple(feat), dtype=dt)
        for i, s in enumerate(seqs):
            out[i, : len(s)] = s
        return LoDArray(data=out, length=lens)

    def to_sequences(self):
        """Back to a list of numpy arrays (host side), dropping padding."""
        data = np.asarray(self.data)
        lens = np.asarray(self.length)
        return [data[i, : lens[i]] for i in range(data.shape[0])]


pytree.register_pytree_node(
    LoDArray, lambda x: ([x.data, x.length], None),
    lambda children, _: LoDArray(*children),
    serialized_type_name="paddle_tpu_torch.core.LoDArray")
