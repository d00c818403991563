"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

This package is a second implementation beside ``paddle_tpu/`` (the JAX
reference), written for PyTorch on an NVIDIA H100. It imports torch,
numpy and the standard library only — never jax and never a module of
``paddle_tpu`` — and keeps its own trimmed copies of the backend-neutral
pieces it needs (flags, profiler counters, metric catalogue, tracing).

The first slice ported is paged-KV generation serving: the decoder model,
the paged decode engine, the continuous-batching scheduler and the HTTP
server, with the paged-decode attention kernel written by hand in CUDA
C++ for ``sm_90a`` (``csrc/paged_decode.cu``).

Device rule: every entry point (engine, scheduler, server CLI) takes
``device=``. The default is ``"cuda"``, which raises when no GPU is
present; the CPU runs only when the caller asks for ``"cpu"``, as the
tests do. On a CUDA tensor a kernel wrapper launches its kernel or
raises — it never falls back to the plain PyTorch version.
"""

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device"]

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
