"""Ops of the port. Importing this package registers the training path's
op lowerings (``math_ops``, ``tensor_ops``, ``nn_ops``,
``activation_ops``, ``sequence_ops`` (``sequence_pool``, ``lstm``),
``optimizer_ops``, ``attention``'s ``fused_attention``, and the host
ops ``save``/``load``/``save_combine``/``load_combine`` of ``io_ops``). The serving
path's attention is plain PyTorch (``attention``), and so is the
quantized KV append and weight dequant (``kv_quant``); the hand-written
kernels sit behind ``paged_attention`` (K3, K3-quant), ``flash_attention``
(K1, K2, K5) and ``fused_adam`` (K4), which count their launches, through
CUDA-graph replays too, with ``launch_count``."""

from . import activation_ops, attention, io_ops, math_ops, nn_ops, \
    optimizer_ops, sequence_ops, tensor_ops  # noqa
