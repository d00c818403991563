"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

This package is a second implementation beside ``paddle_tpu/`` (the JAX
reference), written for PyTorch on an NVIDIA H100. It imports torch,
numpy and the standard library only — never jax and never a module of
``paddle_tpu`` — and keeps its own trimmed copies of the backend-neutral
pieces it needs (flags, profiler counters, metric catalogue, tracing).

These paths are ported:

- paged-KV generation serving (``serving``): the decoder model, the paged
  decode engine, the continuous-batching scheduler and the HTTP server,
  with the paged-decode kernel written by hand in CUDA C++ for
  ``sm_90a`` (``csrc/paged_decode.cu``);
- Fluid training of the transformer LM: the Program IR and ``layers``
  DSL, ``append_backward``, the ``SGD``/``Adam`` optimizers, the eager
  ``Executor`` and ``models.transformer_lm``, whose ``fused_attention``
  runs the flash-attention kernels (``csrc/flash_attention.cu``).
  ``import paddle_tpu_torch as fluid`` reads like the reference;
- packed-document LM training: ``data.decorator.pack_segments`` packs
  documents into rows with segment ids, ``transformer_lm(segment_ids=)``
  attends through the packed-segment flash kernels
  (``csrc/flash_segment.cu``), and ``optimizer.FusedAdam`` updates every
  parameter in one launch of the fused Adam kernel
  (``csrc/fused_adam.cu``);
- ResNet training as ``bench.py`` runs it: ``models.resnet_imagenet``
  (conv2d through cuDNN, batch norm, pooling), ``optimizer.Momentum``,
  and ``Executor.run_steps``, which captures a step as one CUDA graph
  and replays it;
- LM training as ``bench_lm.py`` measures it (``benchmarks.lm``):
  captured ``run_steps`` rounds returning a ``FetchHandle``, under the
  fault-tolerant ``robustness.train_loop`` with checkpoints (``io``,
  ``robustness.CheckpointManager``), with step telemetry
  (``observability.steps``) and random ops (``dropout``) that a captured
  step replays with fresh draws;
- inference deployment: ``Program`` serialization, ``clone`` /
  ``prune``, ``io.save_inference_model`` / ``load_inference_model``, an
  exported ``torch.export`` artifact (``inference_export``; the flash
  forwards recorded as ``paddle_tpu::`` custom ops) served through
  ``serving.InferenceSession``, the ``MicroBatcher`` and ``POST
  /v1/infer`` (``serving.serve --artifact``), and
  ``models.stacked_lstm_net``;
- seq2seq NMT training as ``bench_nmt.py`` measures it
  (``benchmarks.nmt``): ragged ``LoDArray`` values (one LoD level)
  through the IR, the executor and autodiff, ``dynamic_lstm``,
  ``sequence_pool``, ``models.seq2seq_net`` and length-pooled batches
  (``data.decorator.pool_batch_by_length``), one captured step per
  padded shape.

Device rule: every entry point takes a device (``device=``, or a place
for the ``Executor``). The default is CUDA, which raises when no GPU is
present; the CPU runs only when the caller asks for it (``"cpu"``,
``CPUPlace()``), as the tests do. On a CUDA tensor a kernel wrapper
launches its kernel or raises — it never falls back to the plain
PyTorch version.
"""

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device", "CPUPlace", "CUDAPlace",
           "LoDArray", "Tensor", "LoDTensor",
           "Program", "Variable", "Parameter", "program_guard",
           "default_main_program", "default_startup_program", "layers",
           "optimizer", "models", "data", "Executor", "Scope",
           "global_scope", "scope_guard", "append_backward", "ParamAttr",
           "unique_name", "enable_mixed_precision", "io"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device=None):
    """``device`` (None → ``"cuda"``) as a ``torch.device``. A CUDA device
    without an available GPU raises instead of silently running on the
    CPU: a measurement or a serving process that asked for the card must
    not quietly become a CPU run."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("device must be a cuda or cpu device (got %r)"
                         % str(dev))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device %r requested but torch.cuda.is_available() is "
                "False — pass device='cpu' to run on the CPU" % str(dev))
        if dev.index is None:
            # an indexed device: threads that own an engine set it as
            # their current device (torch.cuda.set_device needs the index)
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def enable_mixed_precision(program=None, enable=True):
    """bf16 compute on the matmul and attention ops, fp32 master weights
    and optimizer state, fp32 softmax/normalization statistics."""
    p = program or default_main_program()
    p._amp = bool(enable)


# the training path (imported after resolve_device, which core needs)
from . import unique_name                                   # noqa: E402
from .core import CPUPlace, CUDAPlace, LoDArray             # noqa: E402
from .framework import (Parameter, Program, Variable,       # noqa: E402
                        default_main_program, default_startup_program,
                        program_guard)
from . import ops as _ops       # noqa: E402,F401  registers the lowerings
from . import data, layers, optimizer                       # noqa: E402
from .backward import append_backward                       # noqa: E402
from .executor import Executor, Scope, global_scope, scope_guard  # noqa
from . import io                                            # noqa: E402
from .param_attr import ParamAttr                           # noqa: E402

Tensor = LoDArray
LoDTensor = LoDArray


def __getattr__(name):
    # the model zoo loads on first use: a process that only runs an
    # exported artifact never imports model-building code
    if name == "models":
        import importlib
        return importlib.import_module(".models", __name__)
    raise AttributeError("module %r has no attribute %r" % (__name__, name))
