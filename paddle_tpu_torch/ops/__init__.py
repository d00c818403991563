"""Ops of the port. Importing this package registers the training path's
op lowerings (``math_ops``, ``tensor_ops``, ``nn_ops``,
``optimizer_ops``, and ``attention``'s ``fused_attention``). The serving
path's attention is plain PyTorch (``attention``); the hand-written
kernels sit behind ``paged_attention`` (K3) and ``flash_attention``
(K1, K2)."""

from . import attention, math_ops, nn_ops, optimizer_ops, tensor_ops  # noqa
