"""Flash attention on ``[b, s, h, d]``: the wrappers of the hand-written
CUDA kernels, their plain PyTorch versions, and the
``torch.autograd.Function``s that tie each forward to its backward.

They replace ``paddle_tpu/ops/pallas_attention.py``'s bshd kernels, the
``pallas_saved`` path of ``fused_attention``:

- K1/K2 (``csrc/flash_attention.cu``), no mask or a factored padding
  mask: :func:`flash_fwd` (K1, ``_flash_fwd_bshd``) returns ``(o,
  lse)``: O in q's dtype, Lse fp32 ``[b*h, s, 8]`` (row ``bi*h + head``,
  value repeated over the 8 lanes, the TPU kernel's layout);
  :func:`flash_bwd_dq` (K2-dQ) and :func:`flash_bwd_dkv` (K2-dKV)
  compute the gradients from the saved (q, k, v, lse) and Δ =
  rowsum(dO∘O), which :func:`flash_bwd` reduces in torch first, as the
  reference leaves Δ to XLA; dk/dv come out at the kv heads (GQA group
  summed).
- K5 (``csrc/flash_segment.cu``), packed segment ids
  (``segment_mask.SegmentIds``, ``_flash_fwd_segment`` /
  ``_flash_bwd_segment``): :func:`flash_fwd_segment` (K5-fwd),
  :func:`flash_bwd_segment_dq` (K5-dQ), :func:`flash_bwd_segment_dkv`
  (K5-dKV) and :func:`flash_bwd_segment`, the same contract with
  visibility ``q_seg[b, i] == kv_seg[b, j]``. The kernels walk only the
  key (for dK/dV the query) tiles that a block can see, found inside the
  kernel from the non-decreasing ids.

Semantics shared with the TPU kernels: masked logits are ``NEG_INF =
-1e30`` (finite, so a row with no visible key is the uniform average of
V), every product runs in fp32, ``l`` is clamped at 1e-20. ``k_valid``
(``[1|b, s]`` bool) is the key factor of a factored padding mask; the
query factor is applied by the op (``ops.attention``), outside the
kernels. The backward takes a query row with no visible key to carry a
zero cotangent, which the op guarantees for padded rows; under segment
ids every row sees its own key.

Each wrapper takes its plain version only for tensors on the CPU. For
CUDA tensors it checks what the kernel takes and launches on the
current stream, or raises: there is no fallback. ``launches`` counts
kernel launches per kernel (and nothing else).
"""

import ctypes

import numpy as np
import torch

from .segment_mask import is_segment_mask

__all__ = ["flash_fwd", "flash_bwd", "flash_bwd_dq", "flash_bwd_dkv",
           "flash_fwd_plain", "flash_bwd_plain", "FlashAttention",
           "flash_fwd_segment", "flash_bwd_segment", "flash_bwd_segment_dq",
           "flash_bwd_segment_dkv", "flash_fwd_segment_plain",
           "flash_bwd_segment_plain", "FlashSegmentAttention",
           "flash_fwd_saving_lse", "flash_bwd_from_saved", "launches",
           "NEG_INF", "LSE_LANES", "MAX_HEAD_DIM", "MAX_GROUP"]

NEG_INF = -1e30
LSE_LANES = 8
MAX_HEAD_DIM = 256
MAX_GROUP = 64              # query heads per kv head a kernel block folds
_SMEM_LIMIT = 232448        # bytes of shared memory one H100 block may use
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# kernel name -> (library, its C prefix, kernel index in that library)
_KERNELS = {
    "flash_fwd": ("flash_attention", "paddle_flash_", 0),
    "flash_bwd_dq": ("flash_attention", "paddle_flash_", 1),
    "flash_bwd_dkv": ("flash_attention", "paddle_flash_", 2),
    "flash_segment_fwd": ("flash_segment", "paddle_flash_segment_", 0),
    "flash_segment_bwd_dq": ("flash_segment", "paddle_flash_segment_", 1),
    "flash_segment_bwd_dkv": ("flash_segment", "paddle_flash_segment_", 2),
}

launches = {name: 0 for name in _KERNELS}


def _scale(q, scale):
    return float(scale) if scale is not None else \
        1.0 / float(np.sqrt(q.shape[-1]))


def _check_shapes(q, k, v, k_valid=None, seg=None):
    if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError("flash attention takes q [b, s, h, d] and k, v "
                         "[b, s, hkv, d] (got %s, %s, %s)"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    b, s, h, d = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        raise ValueError("k/v %s do not match q %s (self-attention: same "
                         "batch, sequence and head_dim)"
                         % (tuple(k.shape), tuple(q.shape)))
    if h % k.shape[2]:
        raise ValueError("heads %d not divisible by kv_heads %d"
                         % (h, k.shape[2]))
    if k_valid is not None and (k_valid.dim() != 2 or
                                k_valid.shape[0] not in (1, b) or
                                k_valid.shape[1] != s):
        raise ValueError("k_valid must be [1|b, s] = [1|%d, %d] (got %s)"
                         % (b, s, tuple(k_valid.shape)))
    if seg is not None:
        if not is_segment_mask(seg):
            raise TypeError("segment masks are SegmentIds (got %r)"
                            % type(seg).__name__)
        for name, ids in (("q", seg.q), ("kv", seg.kv)):
            if tuple(ids.shape) != (b, s) or ids.is_floating_point():
                raise ValueError("segment ids %s must be integer [b, s] = "
                                 "%s (got %s %s)" % (name, (b, s),
                                                     ids.dtype,
                                                     tuple(ids.shape)))


# -- plain versions ----------------------------------------------------------

def _logits(q, k, scale, causal, k_valid, seg=None):
    """fp32 masked logits [b, h, s, s] (head = kv_head * g + i)."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    qf = q.float().reshape(b, s, hkv, h // hkv, d)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * scale
    hidden = torch.zeros((s, s), dtype=torch.bool, device=q.device)
    if causal:
        hidden = torch.ones_like(hidden).triu_(1)
    hidden = hidden[None, None, None]
    if k_valid is not None:
        hidden = hidden | ~k_valid.bool()[:, None, None, None, :]
    if seg is not None:
        hidden = hidden | (seg.q[:, :, None] != seg.kv[:, None, :]) \
            [:, None, None]
    logits = logits.masked_fill(hidden, NEG_INF)
    return logits.reshape(b, h, s, s)


def _kv_heads(x, h):
    """[b, s, hkv, d] → fp32 [b, h, s, d], each kv head repeated over its
    query group."""
    return x.float().repeat_interleave(h // x.shape[2], dim=2) \
        .permute(0, 2, 1, 3)


def _fwd_plain(q, k, v, scale, causal, k_valid, seg):
    b, s, h, d = q.shape
    logits = _logits(q, k, _scale(q, scale), causal, k_valid, seg)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-20)
    o = torch.matmul(p, _kv_heads(v, h)) / l            # [b, h, s, d]
    lse = (m + torch.log(l)).reshape(b * h, s, 1)
    return (o.permute(0, 2, 1, 3).to(q.dtype).contiguous(),
            lse.expand(b * h, s, LSE_LANES).contiguous())


def flash_fwd_plain(q, k, v, scale=None, causal=False, k_valid=None):
    """K1's function in plain PyTorch: ``(o, lse)`` as the kernel returns
    them. Used for CPU tensors and as the reference the kernel is held
    against on the card."""
    _check_shapes(q, k, v, k_valid)
    return _fwd_plain(q, k, v, scale, causal, k_valid, None)


def flash_fwd_segment_plain(q, k, v, seg, scale=None, causal=False):
    """K5-fwd's function in plain PyTorch: ``(o, lse)`` under the segment
    mask ``seg`` (a :class:`SegmentIds` of [b, s] ids)."""
    _check_shapes(q, k, v, seg=seg)
    return _fwd_plain(q, k, v, scale, causal, None, seg)


def _delta(o, do):
    """Δ = rowsum(dO∘O) in fp32, [b, s, h]."""
    return (do.float() * o.float()).sum(-1)


def _bwd_plain(q, k, v, o, lse, do, scale, causal, k_valid, seg):
    b, s, h, d = q.shape
    hkv = k.shape[2]
    sc = _scale(q, scale)
    p = torch.exp(_logits(q, k, sc, causal, k_valid, seg) -
                  lse[..., 0].reshape(b, h, s, 1))
    dof = do.float().permute(0, 2, 1, 3)                 # [b, h, s, d]
    dp = torch.matmul(dof, _kv_heads(v, h).transpose(-1, -2))
    ds = p * (dp - _delta(o, do).permute(0, 2, 1)[..., None])
    dq = torch.matmul(ds, _kv_heads(k, h)) * sc
    dk = torch.matmul(ds.transpose(-1, -2), q.float().permute(0, 2, 1, 3)) * sc
    dv = torch.matmul(p.transpose(-1, -2), dof)

    def kv_grad(x):                                      # [b, h, s, d]
        return x.reshape(b, hkv, h // hkv, s, d).sum(2).permute(0, 2, 1, 3)
    return (dq.permute(0, 2, 1, 3).to(q.dtype).contiguous(),
            kv_grad(dk).to(k.dtype).contiguous(),
            kv_grad(dv).to(v.dtype).contiguous())


def flash_bwd_plain(q, k, v, o, lse, do, scale=None, causal=False,
                    k_valid=None):
    """K2's function in plain PyTorch: ``(dq, dk, dv)`` from the saved
    forward residuals, dk/dv summed over each kv head's query group."""
    _check_shapes(q, k, v, k_valid)
    return _bwd_plain(q, k, v, o, lse, do, scale, causal, k_valid, None)


def flash_bwd_segment_plain(q, k, v, o, lse, do, seg, scale=None,
                            causal=False):
    """K5's backward in plain PyTorch: ``(dq, dk, dv)`` under ``seg``."""
    _check_shapes(q, k, v, seg=seg)
    return _bwd_plain(q, k, v, o, lse, do, scale, causal, None, seg)


# -- the kernels -------------------------------------------------------------

def _bind(source, prefix):
    from .. import _build
    lib = _build.load(source)
    if not getattr(lib, "_bound", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        dims = [i32] * 5 + [f32, i32, i32, ptr]   # b s h hkv d scale causal dtype stream
        # the mask: (k_valid, its rows) or (q_seg, kv_seg)
        mask = [ptr, i32] if source == "flash_attention" else [ptr, ptr]
        fns = {"fwd": [ptr] * 3 + mask + [ptr] * 2 + dims,
               "bwd_dq": [ptr] * 6 + mask + [ptr] + dims,
               "bwd_dkv": [ptr] * 6 + mask + [ptr] * 2 + dims}
        for fn_name, argtypes in fns.items():
            fn = getattr(lib, prefix + fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        smem = getattr(lib, prefix + "smem_bytes")
        smem.argtypes = [i32, i32]
        smem.restype = ctypes.c_size_t
        err = getattr(lib, prefix + "error_string")
        err.argtypes = [i32]
        err.restype = ctypes.c_char_p
        lib._bound = True
    return lib


def _same_device(name, tensors, *masks):
    devices = {t.device for t in tensors.values()}
    devices.update(m.device for m in masks if m is not None)
    if len(devices) != 1:
        raise ValueError("%s inputs span devices %s"
                         % (name, sorted(str(d) for d in devices)))
    return devices.pop()


def _check_kernel_inputs(name, tensors, k_valid=None, seg=None):
    """What every kernel takes: fp32 or bf16 q, k, v (and O, dO) of one
    dtype, fp32 ``lse``/``delta``, contiguous, head_dim <= 256, at most
    MAX_GROUP query heads per kv head, contiguous int32 segment ids, on a
    CUDA device. Returns the bound library."""
    q = tensors["q"]
    for n, t in tensors.items():
        want = torch.float32 if n in ("lse", "delta") else q.dtype
        if t.dtype != want or q.dtype not in _DTYPES:
            raise TypeError("%s takes float32 or bfloat16 q, k, v (and "
                            "O, dO) of one dtype and float32 lse (got %s "
                            "%s with q %s)" % (name, n, t.dtype, q.dtype))
        if not t.is_contiguous():
            raise ValueError("%s: %s must be contiguous" % (name, n))
    if k_valid is not None and (k_valid.dtype not in (torch.bool,
                                                      torch.uint8) or
                                not k_valid.is_contiguous()):
        raise TypeError("%s: k_valid must be a contiguous bool or uint8 "
                        "tensor (got %s)" % (name, k_valid.dtype))
    if seg is not None:
        for ids in (seg.q, seg.kv):
            if ids.dtype != torch.int32 or not ids.is_contiguous():
                raise TypeError("%s: segment ids must be contiguous int32 "
                                "(got %s)" % (name, ids.dtype))
    b, s, h, d = q.shape
    if d > MAX_HEAD_DIM:
        raise ValueError("%s supports head_dim <= %d (got %d)"
                         % (name, MAX_HEAD_DIM, d))
    group = h // tensors["k"].shape[2]
    if group > MAX_GROUP:
        raise ValueError("%s folds at most %d query heads per kv head "
                         "(got %d)" % (name, MAX_GROUP, group))
    if "lse" in tensors and tuple(tensors["lse"].shape) != \
            (b * h, s, LSE_LANES):
        raise ValueError("%s: lse must be [b*h, s, %d] = %s (got %s)"
                         % (name, LSE_LANES, (b * h, s, LSE_LANES),
                            tuple(tensors["lse"].shape)))
    if "delta" in tensors and tuple(tensors["delta"].shape) != (b, s, h):
        raise ValueError("%s: delta must be [b, s, h] = %s (got %s)"
                         % (name, (b, s, h), tuple(tensors["delta"].shape)))
    if q.device.type != "cuda":
        raise ValueError("%s runs on cpu or cuda tensors (got %s)"
                         % (name, q.device))
    source, prefix, index = _KERNELS[name]
    lib = _bind(source, prefix)
    smem = getattr(lib, prefix + "smem_bytes")(index, d)
    if smem > _SMEM_LIMIT:
        raise ValueError("%s at head_dim %d needs %d bytes of shared "
                         "memory per block (limit %d)"
                         % (name, d, smem, _SMEM_LIMIT))
    return lib


def _mask_args(k_valid=None, seg=None):
    """The C entry points' mask arguments: (k_valid, its rows) for K1/K2,
    (q_seg, kv_seg) for K5."""
    if seg is not None:
        return [seg.q.data_ptr(), seg.kv.data_ptr()]
    return [None if k_valid is None else k_valid.data_ptr(),
            0 if k_valid is None else k_valid.shape[0]]


def _launch(name, lib, ins, mask, outs, scale, causal):
    """One kernel launch on the current stream: ``ins``, then the mask
    arguments, then ``outs`` as the C entry point orders its pointers."""
    q, k = ins[0], ins[1]
    b, s, h, d = q.shape
    _, prefix, _ = _KERNELS[name]
    fn = getattr(lib, "paddle_" + name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*[t.data_ptr() for t in ins], *mask,
                 *[t.data_ptr() for t in outs],
                 b, s, h, k.shape[2], d, scale, int(bool(causal)),
                 _DTYPES[q.dtype], stream)
    if err != 0:
        msg = getattr(lib, prefix + "error_string")(err).decode()
        raise RuntimeError("%s kernel launch failed: CUDA error %d (%s)"
                           % (name, err, msg))
    launches[name] += 1


def _fwd_kernel(name, q, k, v, scale, causal, k_valid=None, seg=None):
    lib = _check_kernel_inputs(name, {"q": q, "k": k, "v": v}, k_valid, seg)
    b, s, h, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b * h, s, LSE_LANES), dtype=torch.float32,
                      device=q.device)
    _launch(name, lib, (q, k, v), _mask_args(k_valid, seg), (out, lse),
            _scale(q, scale), causal)
    return out, lse


def _bwd_kernel(name, q, k, v, do, lse, delta, scale, causal, k_valid=None,
                seg=None):
    ins = {"q": q, "k": k, "v": v, "do": do, "lse": lse, "delta": delta}
    lib = _check_kernel_inputs(name, ins, k_valid, seg)
    outs = (torch.empty_like(q),) if name.endswith("_dq") else \
        (torch.empty_like(k), torch.empty_like(v))
    _launch(name, lib, tuple(ins.values()), _mask_args(k_valid, seg), outs,
            _scale(q, scale), causal)
    return outs[0] if len(outs) == 1 else outs


def flash_fwd(q, k, v, scale=None, causal=False, k_valid=None):
    """K1: ``(o, lse)`` of causal/unmasked/key-padded attention on
    ``[b, s, h, d]``. CPU tensors take :func:`flash_fwd_plain`; CUDA
    tensors launch the kernel or raise."""
    _check_shapes(q, k, v, k_valid)
    dev = _same_device("flash_fwd", {"q": q, "k": k, "v": v}, k_valid)
    if dev.type == "cpu":
        return flash_fwd_plain(q, k, v, scale, causal, k_valid)
    return _fwd_kernel("flash_fwd", q, k, v, scale, causal, k_valid=k_valid)


def flash_bwd_dq(q, k, v, do, lse, delta, scale=None, causal=False,
                 k_valid=None):
    """K2-dQ: dq from the saved (q, k, v, lse), the cotangent ``do`` and
    ``delta`` = rowsum(dO∘O) [b, s, h] fp32. CUDA tensors only (the CPU
    computes the whole backward in :func:`flash_bwd_plain`)."""
    _check_shapes(q, k, v, k_valid)
    _same_device("flash_bwd_dq", {"q": q, "k": k, "v": v, "do": do,
                                  "lse": lse, "delta": delta}, k_valid)
    return _bwd_kernel("flash_bwd_dq", q, k, v, do, lse, delta, scale,
                       causal, k_valid=k_valid)


def flash_bwd_dkv(q, k, v, do, lse, delta, scale=None, causal=False,
                  k_valid=None):
    """K2-dKV: (dk, dv) at the kv heads from the same inputs as
    :func:`flash_bwd_dq`. CUDA tensors only."""
    _check_shapes(q, k, v, k_valid)
    _same_device("flash_bwd_dkv", {"q": q, "k": k, "v": v, "do": do,
                                   "lse": lse, "delta": delta}, k_valid)
    return _bwd_kernel("flash_bwd_dkv", q, k, v, do, lse, delta, scale,
                       causal, k_valid=k_valid)


def flash_bwd(q, k, v, o, lse, do, scale=None, causal=False, k_valid=None):
    """K2: ``(dq, dk, dv)`` from the saved forward residuals. CPU tensors
    take :func:`flash_bwd_plain`; CUDA tensors reduce Δ in torch and
    launch K2-dQ and K2-dKV, or raise."""
    _check_shapes(q, k, v, k_valid)
    dev = _same_device("flash_bwd", {"q": q, "k": k, "v": v, "o": o,
                                     "lse": lse, "do": do}, k_valid)
    if dev.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, scale, causal, k_valid)
    do = do.contiguous()
    delta = _delta(o, do)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, scale, causal, k_valid)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal, k_valid)
    return dq, dk, dv


def flash_fwd_segment(q, k, v, seg, scale=None, causal=False):
    """K5-fwd: ``(o, lse)`` on ``[b, s, h, d]`` under the segment mask
    ``seg`` (int32 [b, s] ids, non-decreasing along each row). CPU
    tensors take :func:`flash_fwd_segment_plain`; CUDA tensors launch the
    kernel or raise."""
    _check_shapes(q, k, v, seg=seg)
    dev = _same_device("flash_segment_fwd", {"q": q, "k": k, "v": v},
                       seg.q, seg.kv)
    if dev.type == "cpu":
        return flash_fwd_segment_plain(q, k, v, seg, scale, causal)
    return _fwd_kernel("flash_segment_fwd", q, k, v, scale, causal, seg=seg)


def flash_bwd_segment_dq(q, k, v, do, lse, delta, seg, scale=None,
                         causal=False):
    """K5-dQ: dq under ``seg`` from the same inputs as
    :func:`flash_bwd_dq`. CUDA tensors only."""
    _check_shapes(q, k, v, seg=seg)
    _same_device("flash_segment_bwd_dq", {"q": q, "k": k, "v": v, "do": do,
                                          "lse": lse, "delta": delta},
                 seg.q, seg.kv)
    return _bwd_kernel("flash_segment_bwd_dq", q, k, v, do, lse, delta,
                       scale, causal, seg=seg)


def flash_bwd_segment_dkv(q, k, v, do, lse, delta, seg, scale=None,
                          causal=False):
    """K5-dKV: (dk, dv) at the kv heads under ``seg``. CUDA tensors
    only."""
    _check_shapes(q, k, v, seg=seg)
    _same_device("flash_segment_bwd_dkv", {"q": q, "k": k, "v": v,
                                           "do": do, "lse": lse,
                                           "delta": delta}, seg.q, seg.kv)
    return _bwd_kernel("flash_segment_bwd_dkv", q, k, v, do, lse, delta,
                       scale, causal, seg=seg)


def flash_bwd_segment(q, k, v, o, lse, do, seg, scale=None, causal=False):
    """K5's backward: ``(dq, dk, dv)`` under ``seg``. CPU tensors take
    :func:`flash_bwd_segment_plain`; CUDA tensors reduce Δ in torch and
    launch K5-dQ and K5-dKV, or raise."""
    _check_shapes(q, k, v, seg=seg)
    dev = _same_device("flash_bwd_segment", {"q": q, "k": k, "v": v,
                                             "o": o, "lse": lse, "do": do},
                       seg.q, seg.kv)
    if dev.type == "cpu":
        return flash_bwd_segment_plain(q, k, v, o, lse, do, seg, scale,
                                       causal)
    do = do.contiguous()
    delta = _delta(o, do)
    dq = flash_bwd_segment_dq(q, k, v, do, lse, delta, seg, scale, causal)
    dk, dv = flash_bwd_segment_dkv(q, k, v, do, lse, delta, seg, scale,
                                   causal)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """K1 forward with K2 as its backward — the counterpart of the
    reference's ``flash_fwd_saving_lse`` custom vjp. Returns ``(o, lse)``;
    lse is a saved statistic and takes no gradient."""

    @staticmethod
    def forward(q, k, v, scale, causal, k_valid):
        return flash_fwd(q, k, v, scale, causal, k_valid)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, scale, causal, k_valid = inputs
        o, lse = output
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal, ctx.k_valid = scale, causal, k_valid
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do, ctx.scale, ctx.causal,
                               ctx.k_valid)
        return dq, dk, dv, None, None, None


class FlashSegmentAttention(torch.autograd.Function):
    """K5-fwd with K5-dQ/K5-dKV as its backward, under a
    :class:`SegmentIds` mask. Returns ``(o, lse)``; lse takes no
    gradient."""

    @staticmethod
    def forward(q, k, v, seg, scale, causal):
        return flash_fwd_segment(q, k, v, seg, scale, causal)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, seg, scale, causal = inputs
        o, lse = output
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.seg, ctx.scale, ctx.causal = seg, scale, causal
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd_segment(q, k, v, o, lse, do, ctx.seg,
                                       ctx.scale, ctx.causal)
        return dq, dk, dv, None, None, None


def flash_fwd_saving_lse(q, k, v, scale=None, causal=False, mask=None):
    """``(o, lse)``, differentiable in q, k, v. ``mask``: None or a
    factored ``(q_valid, k_valid)`` padding mask (K1 with K2 as its
    backward; the kernels stream the key factor, the op applies the query
    factor), or a :class:`SegmentIds` (K5)."""
    if is_segment_mask(mask):
        return FlashSegmentAttention.apply(q, k, v, mask, scale, causal)
    k_valid = None if mask is None else mask[1]
    return FlashAttention.apply(q, k, v, scale, causal, k_valid)


def flash_bwd_from_saved(q, k, v, o, lse, g, scale=None, causal=False,
                         mask=None):
    """``(dq, dk, dv)`` from the saved forward residuals — what the IR's
    ``fused_attention_grad`` op calls; it never re-runs the forward.
    ``mask`` as for :func:`flash_fwd_saving_lse`."""
    if is_segment_mask(mask):
        return flash_bwd_segment(q, k, v, o, lse, g, mask, scale, causal)
    k_valid = None if mask is None else mask[1]
    return flash_bwd(q, k, v, o, lse, g, scale, causal, k_valid)
