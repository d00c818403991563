"""Ops of the port. Importing this package registers the training path's
op lowerings (``math_ops``, ``tensor_ops``, ``nn_ops``,
``optimizer_ops``, and ``attention``'s ``fused_attention``). The serving
path's attention is plain PyTorch (``attention``), and so is the
quantized KV append and weight dequant (``kv_quant``); the hand-written
kernels sit behind ``paged_attention`` (K3, K3-quant), ``flash_attention``
(K1, K2, K5) and ``fused_adam`` (K4)."""

from . import attention, math_ops, nn_ops, optimizer_ops, tensor_ops  # noqa
