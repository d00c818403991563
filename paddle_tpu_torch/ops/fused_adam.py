"""Fused Adam (K4): one kernel launch updates every parameter — the
wrapper of the hand-written CUDA kernel ``csrc/fused_adam.cu`` and its
plain PyTorch version.

It replaces ``paddle_tpu/ops/pallas_optimizer.py``'s ``fused_adam_flat``
and the per-tensor fallback of ``optimizer_ops._fused_adam_update``:
Adam with the bias-corrected step size ``lr_t`` and the gradient factor
``gscale`` (loss-scale unscale times the global-norm clip), both scalar
tensors, so nothing is read back to the host.

:func:`fused_adam_update` takes the plain version for tensors on the CPU.
For CUDA tensors it builds the kernel's table of per-tensor pointers and
prefix offsets, copies it to the device (from pinned memory, without a
sync), and launches once, or raises: there is no fallback. Outputs are
fresh tensors, as the op returns new values: views into one flat buffer
per role (three allocations a step, not three per parameter). The
kernel rounds each operation on its own, so it equals the plain
version's eager kernels; the contract it is held to is the reference's,
at most 2 ulp.
``launches`` counts kernel launches; a call under CUDA-graph capture is
counted at each replay, and its pinned pointer table, which the graph's
copy node reads at every replay, is kept alive with the graph
(``launch_count``).
"""

import ctypes

import torch

from . import launch_count

__all__ = ["fused_adam_update", "fused_adam_update_plain", "launches"]

launches = {"fused_adam": 0}


def _add(name, n):
    launches[name] += n


def _check(params, grads, m1s, m2s):
    n = len(params)
    if not n or len(grads) != n or len(m1s) != n or len(m2s) != n:
        raise ValueError("fused Adam takes one grad and two moments per "
                         "parameter (got %d params, %d grads, %d/%d "
                         "moments)" % (n, len(grads), len(m1s), len(m2s)))
    for p, g, m1, m2 in zip(params, grads, m1s, m2s):
        if not (p.shape == g.shape == m1.shape == m2.shape):
            raise ValueError("param %s, grad %s and moments %s/%s differ in "
                             "shape" % (tuple(p.shape), tuple(g.shape),
                                        tuple(m1.shape), tuple(m2.shape)))


def fused_adam_update_plain(params, grads, m1s, m2s, lr_t, gscale, beta1,
                            beta2, epsilon):
    """The update tensor by tensor in plain PyTorch, with the expressions
    of the per-parameter ``adam`` op (the reference's ``_kernel``, token
    for token). Returns ``(params_out, moment1_out, moment2_out)``."""
    _check(params, grads, m1s, m2s)
    pos, m1os, m2os = [], [], []
    for p, g0, m1, m2 in zip(params, grads, m1s, m2s):
        g = g0.float() * gscale
        m1o = beta1 * m1 + (1 - beta1) * g
        m2o = beta2 * m2 + (1 - beta2) * g * g
        pos.append(p - lr_t * m1o / (torch.sqrt(m2o) + epsilon))
        m1os.append(m1o)
        m2os.append(m2o)
    return pos, m1os, m2os


def _bind():
    from .. import _build
    lib = _build.load("fused_adam")
    if not getattr(lib, "_bound", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.paddle_fused_adam.argtypes = [ptr, i32, ctypes.c_longlong] + \
            [ptr] * 5 + [f32] * 5 + [ptr]
        lib.paddle_fused_adam.restype = ctypes.c_int
        lib.paddle_fused_adam_error_string.argtypes = [i32]
        lib.paddle_fused_adam_error_string.restype = ctypes.c_char_p
        lib._bound = True
    return lib


def fused_adam_update(params, grads, m1s, m2s, lr_t, gscale, beta1, beta2,
                      epsilon):
    """K4: Adam over every (param, grad, moment1, moment2) in one launch.
    ``lr_t``, ``gscale``: one-element fp32 tensors on the params' device.
    CPU tensors take :func:`fused_adam_update_plain`; CUDA tensors
    (fp32 params and moments, contiguous; grads cast to fp32) launch the
    kernel or raise. Returns ``(params_out, moment1_out, moment2_out)``."""
    _check(params, grads, m1s, m2s)
    tensors = list(params) + list(grads) + list(m1s) + list(m2s) + \
        [lr_t, gscale]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError("fused_adam inputs span devices %s"
                         % sorted(str(d) for d in devices))
    dev = devices.pop()
    if dev.type == "cpu":
        return fused_adam_update_plain(params, grads, m1s, m2s, lr_t,
                                       gscale, beta1, beta2, epsilon)
    if dev.type != "cuda":
        raise ValueError("fused_adam runs on cpu or cuda tensors (got %s)"
                         % dev)
    for t in list(params) + list(m1s) + list(m2s) + [lr_t, gscale]:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError("fused_adam takes contiguous float32 params, "
                            "moments, lr_t and gscale (got %s)" % t.dtype)
    if lr_t.numel() != 1 or gscale.numel() != 1:
        raise ValueError("lr_t and gscale must hold one element each")
    grads = [g.float().contiguous() for g in grads]
    lib = _bind()
    sizes = [p.numel() for p in params]
    offsets = [0]
    for n in sizes:
        offsets.append(offsets[-1] + n)
    total = offsets[-1]
    flat = [torch.empty(total, dtype=torch.float32, device=dev)
            for _ in range(3)]
    outs = tuple([t.view(p.shape) for t, p in zip(f.split(sizes), params)]
                 for f in flat)
    if total == 0:
        return outs
    host = torch.tensor([t.data_ptr() for col in (params, grads, m1s, m2s)
                         for t in col] + offsets,
                        dtype=torch.int64).pin_memory()
    with torch.cuda.device(dev):
        table = host.to(dev, non_blocking=True)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.paddle_fused_adam(
            table.data_ptr(), len(params), total, lr_t.data_ptr(),
            gscale.data_ptr(), *[f.data_ptr() for f in flat], beta1,
            1 - beta1, beta2, 1 - beta2, epsilon, stream)
    if err != 0:
        raise RuntimeError("fused_adam kernel launch failed: CUDA error %d "
                           "(%s)" % (err, lib.paddle_fused_adam_error_string(
                               err).decode()))
    launch_count.keep_alive(host)
    launch_count.launched("fused_adam", _add)
    return outs
