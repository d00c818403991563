"""Places and dtypes of the training path — the port of
``paddle_tpu/core.py``'s places and ``convert_dtype``.

A place names a ``torch.device``: ``CUDAPlace(i)`` is ``cuda:i`` and
raises without a GPU (through :func:`paddle_tpu_torch.resolve_device`),
``CPUPlace()`` is the CPU.

Ragged values (``LoDArray``) carry one level of LoD as padded ``data``
and per-sequence ``length``, the reference's static-shape encoding; the
nested ``LoDArray2`` is not ported yet.

``ScaledFp8`` is a per-tensor scaled fp8 storage value (the conv output
of ``PADDLE_TPU_FP8_CONV_OUT=scaled|delayed``). Torch has no
``__jax_array__``: a consumer dequantizes it explicitly
(``registry.dense``).
"""

import numpy as np
import torch
import torch.utils._pytree as pytree

from . import resolve_device

__all__ = ["Place", "CPUPlace", "CUDAPlace", "SUPPORTED_DTYPES",
           "convert_dtype", "torch_dtype", "LoDArray", "ScaledFp8"]

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


class ScaledFp8:
    """A per-tensor amax-scaled fp8 storage value, dense ≈ data · scale:
    ``data`` the fp8 payload (e4m3fn by default), ``scale`` a () fp32
    tensor. A ``torch.utils._pytree`` node, as ``LoDArray`` is, so the
    generic grad, the step's liveness, a captured step's fetches and
    ``FetchHandle`` carry it. A host fetch comes back as a ``ScaledFp8``
    of numpy arrays (the payload widened exactly to fp32), as the
    reference returns the object itself."""

    __slots__ = ("data", "scale")

    def __init__(self, data, scale):
        self.data = data
        self.scale = scale

    def __repr__(self):
        return "ScaledFp8(data=%r, scale=%r)" % (self.data, self.scale)

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def dtype(self):
        return self.data.dtype

    def dequant(self, dtype=torch.bfloat16):
        """``data`` in fp32 times ``scale``, cast to ``dtype``."""
        data, scale = torch.as_tensor(self.data), torch.as_tensor(self.scale)
        return (data.float() * scale).to(dtype)

    @staticmethod
    def quantize(x, dtype=torch.float8_e4m3fn):
        """``x`` (bf16 or fp32) as a ``ScaledFp8``: scale = max(amax,
        1e-12) / the format's largest finite value, payload = x / scale
        through ``registry.cast_fp8``. Divides by tensors only (CUDA
        divides by a Python scalar through its reciprocal); the divisor is
        filled on the device, so a captured step can run it."""
        from .registry import cast_fp8
        xf = x.float()
        amax = torch.clamp_min(xf.abs().amax(), 1e-12)
        scale = amax / torch.full_like(amax, torch.finfo(dtype).max)
        return ScaledFp8(cast_fp8(xf / scale, dtype), scale)


pytree.register_pytree_node(
    ScaledFp8, lambda x: ([x.data, x.scale], None),
    lambda children, _: ScaledFp8(*children),
    serialized_type_name="paddle_tpu_torch.core.ScaledFp8")
