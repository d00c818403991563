"""Flash attention: the wrappers of the hand-written CUDA kernels, their
plain PyTorch versions, and the ``torch.autograd.Function``s that tie
each forward to its backward.

They replace ``paddle_tpu/ops/pallas_attention.py``'s kernels, the
Pallas paths of ``fused_attention``. Two layouts: ``"bshd"`` ``[b, s, h,
d]`` (the transformer LM's, the default of these functions) and
``"bhsd"`` ``[b, h, s, d]`` (the op's default); k and v carry ``hkv``
heads in the same layout.

- K1/K2 (``csrc/flash_attention.cu``), bshd, no mask or a factored
  padding mask: :func:`flash_fwd` (K1, ``_flash_fwd_bshd``) returns ``(o,
  lse)``: O in q's dtype, Lse fp32 ``[b*h, s, 8]`` (row ``bi*h + head``,
  value repeated over the 8 lanes, the TPU kernel's layout);
  :func:`flash_bwd_dq` (K2-dQ) and :func:`flash_bwd_dkv` (K2-dKV)
  compute the gradients from the saved (q, k, v, lse) and Δ =
  rowsum(dO∘O), which :func:`flash_bwd` reduces in torch first, as the
  reference leaves Δ to XLA; dk/dv come out at the kv heads (GQA group
  summed).
- K6 (``csrc/flash_bhsd.cu``): the same functions with ``layout="bhsd"``
  (``_flash_fwd_dispatch`` / ``_flash_bwd_dispatch``): K6-fwd, K6-dQ,
  K6-dKV. The TPU backward takes full heads; K6 folds each kv head's
  query group as K2 does, which gives the reference's expand-and-sum.
- Dense masks: ``mask=`` a bool ``[b|1, h|1, s, s]`` tensor (bshd:
  ``[b|1, 1, s, s]``) takes the forward only — K1-dense in bshd, K6-fwd's
  dense instantiation in bhsd (each counted apart). Its backward is the
  plain composition's vjp (:class:`FlashAttention`), as the reference's.
- K5 (``csrc/flash_segment.cu``), bshd, packed segment ids
  (``segment_mask.SegmentIds``, ``_flash_fwd_segment`` /
  ``_flash_bwd_segment``): :func:`flash_fwd_segment` (K5-fwd),
  :func:`flash_bwd_segment_dq` (K5-dQ), :func:`flash_bwd_segment_dkv`
  (K5-dKV) and :func:`flash_bwd_segment`, the same contract with
  visibility ``q_seg[b, i] == kv_seg[b, j]``. The kernels walk only the
  key (for dK/dV the query) tiles that a block can see, found inside the
  kernel from the non-decreasing ids.

Semantics shared with the TPU kernels: masked logits are ``NEG_INF =
-1e30`` (finite, so a row with no visible key is the uniform average of
V), ``l`` is clamped at 1e-20, products accumulate in fp32. Their
operands P and dS follow each TPU kernel: K1/K2/K5 keep them in fp32
(the bf16 tensor-core kernels of K1, K1-dense, K2 and K5 carry them
as hi + lo bf16 halves); K6 rounds them to bf16 under bf16
inputs (P before P·V, dS before dS·K, P before Pᵀ·dO, dS before dSᵀ·Q),
and so does its plain version, which rounds the forward's P at the
running row max of each key tile of the kernel's width
(:func:`key_tile`), where an online softmax rounds it. K6's bf16 kernels take S (and dP) as correctly rounded fp32
sums (fp64 on the card's FP64 tensor cores; :func:`_exact_bmm` and
``_logits(exact=True)`` in the plain version), so that its roundings do
not follow a summation order, under a dense mask too.
``k_valid`` (``[1|b, s]`` bool) is the key factor of a
factored padding mask; the
query factor is applied by the op (``ops.attention``), outside the
kernels. The backward takes a query row with no visible key to carry a
zero cotangent, which the op guarantees for padded rows; under segment
ids every row sees its own key.

Each wrapper takes its plain version only for tensors on the CPU. For
CUDA tensors it checks what the kernel takes and launches on the
current stream, or raises: there is no fallback. ``launches`` counts
kernel launches per kernel (and nothing else); a call made while the
current stream is being captured into a CUDA graph is counted at each
replay of the graph (``launch_count``).
"""

import ctypes

import numpy as np
import torch

from . import launch_count
from .segment_mask import is_segment_mask

__all__ = ["flash_fwd", "flash_bwd", "flash_bwd_dq", "flash_bwd_dkv",
           "kernel_name", "dims",
           "flash_fwd_plain", "flash_bwd_plain", "FlashAttention",
           "flash_fwd_segment", "flash_bwd_segment", "flash_bwd_segment_dq",
           "flash_bwd_segment_dkv", "flash_fwd_segment_plain",
           "flash_bwd_segment_plain", "FlashSegmentAttention",
           "flash_fwd_saving_lse", "flash_bwd_from_saved", "plain_vjp",
           "launches", "key_tile",
           "smem_bytes",
           "NEG_INF", "LSE_LANES", "MAX_HEAD_DIM", "takes_dense_mask"]

NEG_INF = -1e30
LSE_LANES = 8
MAX_HEAD_DIM = 256
_SMEM_LIMIT = 232448        # bytes of shared memory one H100 block may use
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# kernel name -> (library, its C prefix, kernel index in that library,
# mask kind); the bhsd library holds the per-head layout's kernels. The
# mask kind's value in the C sources (kMask) picks the body, and with it
# the shared memory, that a library reports for a kernel index.
_KERNELS = {
    "flash_fwd": ("flash_attention", "paddle_flash_", 0, "valid"),
    "flash_fwd_dense": ("flash_attention", "paddle_flash_", 0, "dense"),
    "flash_bwd_dq": ("flash_attention", "paddle_flash_", 1, "valid"),
    "flash_bwd_dkv": ("flash_attention", "paddle_flash_", 2, "valid"),
    "flash_segment_fwd": ("flash_segment", "paddle_flash_segment_", 0,
                          "seg"),
    "flash_segment_bwd_dq": ("flash_segment", "paddle_flash_segment_", 1,
                             "seg"),
    "flash_segment_bwd_dkv": ("flash_segment", "paddle_flash_segment_", 2,
                              "seg"),
    "flash_bhsd_fwd": ("flash_bhsd", "paddle_flash_bhsd_", 0, "valid"),
    "flash_bhsd_fwd_dense": ("flash_bhsd", "paddle_flash_bhsd_", 0,
                             "dense"),
    "flash_bhsd_bwd_dq": ("flash_bhsd", "paddle_flash_bhsd_", 1, "valid"),
    "flash_bhsd_bwd_dkv": ("flash_bhsd", "paddle_flash_bhsd_", 2, "valid"),
}

_MASK_KINDS = {"valid": 0, "seg": 1, "dense": 2}

launches = {name: 0 for name in _KERNELS}


def _add(name, n):
    launches[name] += n


def _scale(q, scale):
    return float(scale) if scale is not None else \
        1.0 / float(np.sqrt(q.shape[-1]))


def kernel_name(role, layout="bshd", dense=False):
    """The ``launches`` key of the kernel that computes ``role`` ("fwd",
    "bwd_dq" or "bwd_dkv") in ``layout``, under a dense mask when
    ``dense`` (forward only)."""
    return ("flash_bhsd_" if layout == "bhsd" else "flash_") + role + \
        ("_dense" if dense else "")


def dims(q, k, layout):
    """(b, s, h, hkv, d) of q and k in ``layout``."""
    if layout == "bhsd":
        return q.shape[0], q.shape[2], q.shape[1], k.shape[1], q.shape[3]
    return q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.shape[3]


def _to_bshd(x, layout):
    return x.transpose(1, 2) if layout == "bhsd" else x


def _dense_heads(h, layout):
    """The head extents a kernel takes in a dense mask: 1 or h in bhsd,
    1 (a head-broadcast mask) in bshd."""
    return (1, h) if layout == "bhsd" else (1,)


def takes_dense_mask(q, k, mask, layout):
    """Whether a kernel takes the dense ``mask`` over q, k in
    ``layout``: a 4-d [b|1, h|1, s, s] mask in bhsd, [b|1, 1, s, s] in
    bshd."""
    b, s, h, _, _ = dims(q, k, layout)
    return mask.dim() == 4 and mask.shape[0] in (1, b) and \
        mask.shape[1] in _dense_heads(h, layout) and \
        tuple(mask.shape[2:]) == (s, s)


def _check_shapes(q, k, v, k_valid=None, seg=None, mask=None,
                  layout="bshd"):
    if layout not in ("bshd", "bhsd"):
        raise ValueError("layout must be 'bshd' or 'bhsd' (got %r)"
                         % (layout,))
    if q.dim() != 4 or k.dim() != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError("flash attention takes q [b, s, h, d] and k, v "
                         "[b, s, hkv, d] (bhsd: [b, h, s, d], [b, hkv, s, "
                         "d]; got %s, %s, %s)"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    b, s, h, hkv, d = dims(q, k, layout)
    if k.shape[0] != b or dims(k, k, layout)[1] != s or k.shape[3] != d:
        raise ValueError("k/v %s do not match q %s (self-attention: same "
                         "batch, sequence and head_dim)"
                         % (tuple(k.shape), tuple(q.shape)))
    if h % hkv:
        raise ValueError("heads %d not divisible by kv_heads %d" % (h, hkv))
    if sum(m is not None for m in (k_valid, seg, mask)) > 1:
        raise ValueError("pass one mask: k_valid, segment ids or a dense "
                         "mask")
    if k_valid is not None and (k_valid.dim() != 2 or
                                k_valid.shape[0] not in (1, b) or
                                k_valid.shape[1] != s):
        raise ValueError("k_valid must be [1|b, s] = [1|%d, %d] (got %s)"
                         % (b, s, tuple(k_valid.shape)))
    if seg is not None:
        if not is_segment_mask(seg):
            raise TypeError("segment masks are SegmentIds (got %r)"
                            % type(seg).__name__)
        if layout != "bshd":
            raise ValueError("segment masks take the bshd layout")
        for name, ids in (("q", seg.q), ("kv", seg.kv)):
            if tuple(ids.shape) != (b, s) or ids.is_floating_point():
                raise ValueError("segment ids %s must be integer [b, s] = "
                                 "%s (got %s %s)" % (name, (b, s),
                                                     ids.dtype,
                                                     tuple(ids.shape)))
    if mask is not None and not takes_dense_mask(q, k, mask, layout):
        raise ValueError("a dense %s mask must be [1|%d, %s, %d, %d] "
                         "(got %s)" % (layout, b, "|".join(
                             map(str, _dense_heads(h, layout))), s, s,
                                       tuple(mask.shape)))


# -- plain versions ----------------------------------------------------------
# They compute on bshd views; bhsd inputs are transposed views, so the
# arithmetic is the same in both layouts.

def _logits(q, k, scale, causal, k_valid, seg=None, mask=None,
            exact=False):
    """fp32 masked logits [b, h, s, s] (head = kv_head * g + i) of bshd
    q, k; ``exact``: each Q.K^T sum taken in fp64 and rounded to fp32
    once before the scale (:func:`_exact_bmm`)."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    qf = q.float().reshape(b, s, hkv, h // hkv, d)
    kf = k.float()
    if exact:
        qf, kf = qf.double(), kf.double()
    logits = torch.einsum("bqkgd,bskd->bkgqs", qf, kf).float() * scale
    hidden = torch.zeros((s, s), dtype=torch.bool, device=q.device)
    if causal:
        hidden = torch.ones_like(hidden).triu_(1)
    hidden = hidden[None, None, None]
    if k_valid is not None:
        hidden = hidden | ~k_valid.bool()[:, None, None, None, :]
    if seg is not None:
        hidden = hidden | (seg.q[:, :, None] != seg.kv[:, None, :]) \
            [:, None, None]
    if mask is not None:      # [mb, 1|h, s, s] → [mb, 1|hkv, 1|g, s, s]
        m = mask.bool()
        m = m[:, :, None] if m.shape[1] == 1 else \
            m.reshape(m.shape[0], hkv, h // hkv, s, s)
        hidden = hidden | ~m
    logits = logits.masked_fill(hidden, NEG_INF)
    return logits.reshape(b, h, s, s)


def _kv_heads(x, h):
    """[b, s, hkv, d] → fp32 [b, h, s, d], each kv head repeated over its
    query group."""
    return x.float().repeat_interleave(h // x.shape[2], dim=2) \
        .permute(0, 2, 1, 3)


def key_tile(d):
    """The key tile of the CUDA-core flash bodies at head_dim ``d``
    (``block_k`` in ``csrc/flash_kernels.cuh``): the step of the forward's
    online softmax."""
    return 64 if d <= 128 else 32


def _rounds_operands(dtype, layout):
    """Whether P and dS enter their products rounded to the input
    dtype: K6 (bhsd) under bf16, as the TPU's K6 rounds them; K1, K2 and
    K5 keep them in fp32, as theirs do."""
    return layout == "bhsd" and dtype == torch.bfloat16


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _exact_bmm(a, b):
    """a @ b of fp32 tensors holding bf16 values, each sum taken in fp64
    (the products are exact there) and rounded to fp32 once: the
    correctly rounded sums, whatever the order. The backward that rounds
    P and dS to bf16 (K6 under bf16) takes S and dP so, as its kernels do
    on the FP64 tensor cores: a rounding then depends on the last bit of
    S and dP, which two fp32 summation orders would set apart."""
    return torch.matmul(a.double(), b.double()).float()


def _online_p(logits, m, tile):
    """P as an online softmax over key tiles of width ``tile`` feeds it
    to P·V rounded to bf16: each tile's exp(x - m_t), m_t the row's
    running max through that tile, rounded, then carried to the row max
    ``m`` by exp(m_t - m), the rescaling the kernel applies after."""
    b, h, s, _ = logits.shape
    n = -(-s // tile)
    x = torch.nn.functional.pad(logits, (0, n * tile - s),
                                value=-float("inf")).reshape(b, h, s, n, tile)
    m_t = x.amax(-1).cummax(-1).values                   # [b, h, s, n]
    p = _bf16(torch.exp(x - m_t[..., None])) * torch.exp(m_t - m)[..., None]
    return p.reshape(b, h, s, n * tile)[..., :s]


def _fwd_plain(q, k, v, scale, causal, k_valid, seg, mask=None,
               layout="bshd"):
    q, k, v = (_to_bshd(x, layout) for x in (q, k, v))
    b, s, h, d = q.shape
    # S as its kernel sums it: correctly rounded where K6 (with or
    # without a dense mask) rounds P from it on the tensor cores
    logits = _logits(q, k, _scale(q, scale), causal, k_valid, seg, mask,
                     exact=_rounds_operands(q.dtype, layout))
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-20)         # unrounded P
    if _rounds_operands(q.dtype, layout):
        p = _online_p(logits, m, key_tile(d))
    o = torch.matmul(p, _kv_heads(v, h)) / l            # [b, h, s, d]
    lse = (m + torch.log(l)).reshape(b * h, s, 1)
    o = o if layout == "bhsd" else o.permute(0, 2, 1, 3)
    return (o.to(q.dtype).contiguous(),
            lse.expand(b * h, s, LSE_LANES).contiguous())


def flash_fwd_plain(q, k, v, scale=None, causal=False, k_valid=None,
                    mask=None, layout="bshd"):
    """The forward kernels' function in plain PyTorch (K1, K1-dense, K6-fwd
    by ``layout`` and ``mask``): ``(o, lse)`` as the kernels return them.
    Used for CPU tensors and as the reference the kernels are held
    against on the card."""
    _check_shapes(q, k, v, k_valid, mask=mask, layout=layout)
    return _fwd_plain(q, k, v, scale, causal, k_valid, None, mask, layout)


def flash_fwd_segment_plain(q, k, v, seg, scale=None, causal=False):
    """K5-fwd's function in plain PyTorch: ``(o, lse)`` under the segment
    mask ``seg`` (a :class:`SegmentIds` of [b, s] ids)."""
    _check_shapes(q, k, v, seg=seg)
    return _fwd_plain(q, k, v, scale, causal, None, seg)


def _delta(o, do):
    """Δ = rowsum(dO∘O) in fp32, in O's layout without d: [b, s, h]
    (bhsd: [b, h, s])."""
    return (do.float() * o.float()).sum(-1)


def _bwd_plain(q, k, v, o, lse, do, scale, causal, k_valid, seg,
               layout="bshd"):
    q, k, v, o, do = (_to_bshd(x, layout) for x in (q, k, v, o, do))
    b, s, h, d = q.shape
    hkv = k.shape[2]
    sc = _scale(q, scale)
    rounds = _rounds_operands(q.dtype, layout)
    p = torch.exp(_logits(q, k, sc, causal, k_valid, seg, exact=rounds) -
                  lse[..., 0].reshape(b, h, s, 1))
    dof = do.float().permute(0, 2, 1, 3)                 # [b, h, s, d]
    vt = _kv_heads(v, h).transpose(-1, -2)
    dp = _exact_bmm(dof, vt) if rounds else torch.matmul(dof, vt)
    ds = p * (dp - _delta(o, do).permute(0, 2, 1)[..., None])
    if rounds:
        p, ds = _bf16(p), _bf16(ds)
    dq = torch.matmul(ds, _kv_heads(k, h)) * sc
    dk = torch.matmul(ds.transpose(-1, -2), q.float().permute(0, 2, 1, 3)) * sc
    dv = torch.matmul(p.transpose(-1, -2), dof)

    def kv_grad(x):                                      # [b, h, s, d]
        x = x.reshape(b, hkv, h // hkv, s, d).sum(2)
        return x if layout == "bhsd" else x.permute(0, 2, 1, 3)
    dq = dq if layout == "bhsd" else dq.permute(0, 2, 1, 3)
    return (dq.to(q.dtype).contiguous(),
            kv_grad(dk).to(k.dtype).contiguous(),
            kv_grad(dv).to(v.dtype).contiguous())


def flash_bwd_plain(q, k, v, o, lse, do, scale=None, causal=False,
                    k_valid=None, layout="bshd"):
    """The backward kernels' function in plain PyTorch (K2, K6 by
    ``layout``): ``(dq, dk, dv)`` from the saved forward residuals, dk/dv
    summed over each kv head's query group."""
    _check_shapes(q, k, v, k_valid, layout=layout)
    return _bwd_plain(q, k, v, o, lse, do, scale, causal, k_valid, None,
                      layout)


def flash_bwd_segment_plain(q, k, v, o, lse, do, seg, scale=None,
                            causal=False):
    """K5's backward in plain PyTorch: ``(dq, dk, dv)`` under ``seg``."""
    _check_shapes(q, k, v, seg=seg)
    return _bwd_plain(q, k, v, o, lse, do, scale, causal, None, seg)


# -- the kernels -------------------------------------------------------------

_MASK_ARGTYPES = {"valid": [ctypes.c_void_p, ctypes.c_int],   # k_valid, rows
                  "seg": [ctypes.c_void_p, ctypes.c_void_p],  # q_seg, kv_seg
                  "dense": [ctypes.c_void_p, ctypes.c_int,    # mask, mb, mh
                            ctypes.c_int]}


def _bind(source, prefix):
    from .. import _build
    lib = _build.load(source)
    if not getattr(lib, "_bound", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        dims = [i32] * 5 + [f32, i32, i32, ptr]   # b s h hkv d scale causal dtype stream
        for name, (src, _, index, kind) in _KERNELS.items():
            if src != source:
                continue
            mask = _MASK_ARGTYPES[kind]
            fn = getattr(lib, "paddle_" + name)
            fn.argtypes = [[ptr] * 3 + mask + [ptr] * 2,       # fwd
                           [ptr] * 6 + mask + [ptr],           # dQ
                           [ptr] * 6 + mask + [ptr] * 2][index] + dims
            fn.restype = ctypes.c_int
        smem = getattr(lib, prefix + "smem_bytes")
        smem.argtypes = [i32] * 4        # kernel, mask kind, d, dtype
        smem.restype = ctypes.c_size_t
        err = getattr(lib, prefix + "error_string")
        err.argtypes = [i32]
        err.restype = ctypes.c_char_p
        lib._bound = True
    return lib


def _kernel_layout(name):
    """The layout of kernel ``name``'s tensors: its library's."""
    return "bhsd" if _KERNELS[name][0] == "flash_bhsd" else "bshd"


def _same_device(name, tensors, *masks):
    devices = {t.device for t in tensors.values()}
    devices.update(m.device for m in masks if m is not None)
    if len(devices) != 1:
        raise ValueError("%s inputs span devices %s"
                         % (name, sorted(str(d) for d in devices)))
    return devices.pop()


def smem_bytes(name, d, dtype):
    """Shared memory of one block of kernel ``name`` at head_dim ``d`` and
    ``dtype`` (torch.float32 or torch.bfloat16), as its library reports
    it: that of the body its dispatch launches (builds the library)."""
    source, prefix, index, kind = _KERNELS[name]
    lib = _bind(source, prefix)
    return getattr(lib, prefix + "smem_bytes")(index, _MASK_KINDS[kind], d,
                                               _DTYPES[dtype])


def _check_kernel_inputs(name, tensors, k_valid=None, seg=None, mask=None):
    """What every kernel takes: fp32 or bf16 q, k, v (and O, dO) of one
    dtype, fp32 ``lse``/``delta``, contiguous, head_dim <= 256,
    contiguous int32 segment ids, a contiguous bool or uint8 mask, on a
    CUDA device. Returns the bound library."""
    source, prefix, _, _ = _KERNELS[name]
    layout = _kernel_layout(name)
    q = tensors["q"]
    for n, t in tensors.items():
        want = torch.float32 if n in ("lse", "delta") else q.dtype
        if t.dtype != want or q.dtype not in _DTYPES:
            raise TypeError("%s takes float32 or bfloat16 q, k, v (and "
                            "O, dO) of one dtype and float32 lse (got %s "
                            "%s with q %s)" % (name, n, t.dtype, q.dtype))
        if not t.is_contiguous():
            raise ValueError("%s: %s must be contiguous" % (name, n))
    for n, m in (("k_valid", k_valid), ("mask", mask)):
        if m is not None and (m.dtype not in (torch.bool, torch.uint8) or
                              not m.is_contiguous()):
            raise TypeError("%s: %s must be a contiguous bool or uint8 "
                            "tensor (got %s)" % (name, n, m.dtype))
    if seg is not None:
        for ids in (seg.q, seg.kv):
            if ids.dtype != torch.int32 or not ids.is_contiguous():
                raise TypeError("%s: segment ids must be contiguous int32 "
                                "(got %s)" % (name, ids.dtype))
    b, s, h, hkv, d = dims(q, tensors["k"], layout)
    if d > MAX_HEAD_DIM:
        raise ValueError("%s supports head_dim <= %d (got %d)"
                         % (name, MAX_HEAD_DIM, d))
    if "lse" in tensors and tuple(tensors["lse"].shape) != \
            (b * h, s, LSE_LANES):
        raise ValueError("%s: lse must be [b*h, s, %d] = %s (got %s)"
                         % (name, LSE_LANES, (b * h, s, LSE_LANES),
                            tuple(tensors["lse"].shape)))
    want = (b, h, s) if layout == "bhsd" else (b, s, h)
    if "delta" in tensors and tuple(tensors["delta"].shape) != want:
        raise ValueError("%s: delta must be %s = %s (got %s)"
                         % (name, "[b, h, s]" if layout == "bhsd"
                            else "[b, s, h]", want,
                            tuple(tensors["delta"].shape)))
    if q.device.type != "cuda":
        raise ValueError("%s runs on cpu or cuda tensors (got %s)"
                         % (name, q.device))
    lib = _bind(source, prefix)
    smem = smem_bytes(name, d, q.dtype)
    if smem > _SMEM_LIMIT:
        raise ValueError("%s at head_dim %d in %s needs %d bytes of shared "
                         "memory per block (limit %d)"
                         % (name, d, q.dtype, smem, _SMEM_LIMIT))
    return lib


def _mask_args(k_valid=None, seg=None, mask=None):
    """The C entry points' mask arguments: (k_valid, its rows) for K1/K2
    and K6, (q_seg, kv_seg) for K5, (mask, mb, mh) for a dense mask."""
    if seg is not None:
        return [seg.q.data_ptr(), seg.kv.data_ptr()]
    if mask is not None:
        return [mask.data_ptr(), mask.shape[0], mask.shape[1]]
    return [None if k_valid is None else k_valid.data_ptr(),
            0 if k_valid is None else k_valid.shape[0]]


def _launch(name, lib, ins, mask, outs, scale, causal):
    """One kernel launch on the current stream: ``ins``, then the mask
    arguments, then ``outs`` as the C entry point orders its pointers."""
    q, k = ins[0], ins[1]
    prefix = _KERNELS[name][1]
    b, s, h, hkv, d = dims(q, k, _kernel_layout(name))
    fn = getattr(lib, "paddle_" + name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(*[t.data_ptr() for t in ins], *mask,
                 *[t.data_ptr() for t in outs],
                 b, s, h, hkv, d, scale, int(bool(causal)),
                 _DTYPES[q.dtype], stream)
    if err != 0:
        msg = getattr(lib, prefix + "error_string")(err).decode()
        raise RuntimeError("%s kernel launch failed: CUDA error %d (%s)"
                           % (name, err, msg))
    launch_count.launched(name, _add)


def _fwd_kernel(name, q, k, v, scale, causal, k_valid=None, seg=None,
                mask=None):
    lib = _check_kernel_inputs(name, {"q": q, "k": k, "v": v}, k_valid, seg,
                               mask)
    b, s, h, _, _ = dims(q, k, _kernel_layout(name))
    out = torch.empty_like(q)
    lse = torch.empty((b * h, s, LSE_LANES), dtype=torch.float32,
                      device=q.device)
    _launch(name, lib, (q, k, v), _mask_args(k_valid, seg, mask),
            (out, lse), _scale(q, scale), causal)
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


def flash_fwd(q, k, v, scale=None, causal=False, k_valid=None, mask=None,
              layout="bshd"):
    """``(o, lse)`` of causal/unmasked/key-padded attention, or under the
    dense bool ``mask``: K1 (bshd), K6-fwd (bhsd), K1-dense or K6-fwd's
    dense instantiation (``mask``). CPU tensors take
    :func:`flash_fwd_plain`; CUDA tensors launch the kernel or raise."""
    _check_shapes(q, k, v, k_valid, mask=mask, layout=layout)
    name = kernel_name("fwd", layout, mask is not None)
    dev = _same_device(name, {"q": q, "k": k, "v": v}, k_valid, mask)
    if dev.type == "cpu":
        return flash_fwd_plain(q, k, v, scale, causal, k_valid, mask, layout)
    return _fwd_kernel(name, q, k, v, scale, causal, k_valid=k_valid,
                       mask=mask)


def flash_bwd_dq(q, k, v, do, lse, delta, scale=None, causal=False,
                 k_valid=None, layout="bshd"):
    """K2-dQ (bshd) or K6-dQ (bhsd): dq from the saved (q, k, v, lse), the
    cotangent ``do`` and ``delta`` = rowsum(dO∘O) fp32 in O's layout
    without d. CUDA tensors only (the CPU computes the whole backward in
    :func:`flash_bwd_plain`)."""
    _check_shapes(q, k, v, k_valid, layout=layout)
    name = kernel_name("bwd_dq", layout)
    _same_device(name, {"q": q, "k": k, "v": v, "do": do, "lse": lse,
                        "delta": delta}, k_valid)
    return _bwd_kernel(name, q, k, v, do, lse, delta, scale, causal,
                       k_valid=k_valid)


def flash_bwd_dkv(q, k, v, do, lse, delta, scale=None, causal=False,
                  k_valid=None, layout="bshd"):
    """K2-dKV (bshd) or K6-dKV (bhsd): (dk, dv) at the kv heads from the
    same inputs as :func:`flash_bwd_dq`. CUDA tensors only."""
    _check_shapes(q, k, v, k_valid, layout=layout)
    name = kernel_name("bwd_dkv", layout)
    _same_device(name, {"q": q, "k": k, "v": v, "do": do, "lse": lse,
                        "delta": delta}, k_valid)
    return _bwd_kernel(name, q, k, v, do, lse, delta, scale, causal,
                       k_valid=k_valid)


def flash_bwd(q, k, v, o, lse, do, scale=None, causal=False, k_valid=None,
              layout="bshd"):
    """K2 (bshd) or K6 (bhsd): ``(dq, dk, dv)`` from the saved forward
    residuals. CPU tensors take :func:`flash_bwd_plain`; CUDA tensors
    reduce Δ in torch and launch the dQ and dK/dV kernels, or raise."""
    _check_shapes(q, k, v, k_valid, layout=layout)
    dev = _same_device("flash_bwd", {"q": q, "k": k, "v": v, "o": o,
                                     "lse": lse, "do": do}, k_valid)
    if dev.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, scale, causal, k_valid,
                               layout)
    do = do.contiguous()
    delta = _delta(o, do)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, scale, causal, k_valid,
                      layout)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal, k_valid,
                           layout)
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
    """The flash forward (K1, K6-fwd, or their dense-mask variants) with
    its backward — the counterpart of the reference's
    ``flash_fwd_saving_lse`` and ``flash_attention`` custom vjps. Returns
    ``(o, lse)``; lse is a saved statistic and takes no gradient. Without
    a mask or with ``k_valid`` the backward is K2 or K6 on the saved
    residuals; under a dense ``mask`` it is the vjp of the plain
    composition (``attention.dot_product_attention``), as the reference
    recomputes a dense-masked backward outside any kernel."""

    @staticmethod
    def forward(q, k, v, scale, causal, k_valid, mask, layout):
        return flash_fwd(q, k, v, scale, causal, k_valid, mask, layout)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, scale, causal, k_valid, mask, layout = inputs
        o, lse = output
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal, ctx.k_valid = scale, causal, k_valid
        ctx.mask, ctx.layout = mask, layout
        ctx.mark_non_differentiable(lse)

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if ctx.mask is not None:
            dq, dk, dv = plain_vjp(q, k, v, do, ctx.scale, ctx.causal,
                                        ctx.mask, ctx.layout)
        else:
            dq, dk, dv = flash_bwd(q, k, v, o, lse, do, ctx.scale,
                                   ctx.causal, ctx.k_valid, ctx.layout)
        return dq, dk, dv, None, None, None, None, None


def plain_vjp(q, k, v, do, scale, causal, mask, layout):
    """``(dq, dk, dv)`` by the vjp of the plain composition
    (``attention.dot_product_attention``) under ``mask`` (any mask it
    takes), recomputed from q, k, v: the backward of a dense mask, which
    no kernel takes."""
    from .attention import dot_product_attention

    def fwd(q, k, v):
        return dot_product_attention(q, k, v, causal=causal, scale=scale,
                                     mask=mask, layout=layout)
    out, vjp = torch.func.vjp(fwd, q, k, v)
    return vjp(do.to(out.dtype))


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


def flash_fwd_saving_lse(q, k, v, scale=None, causal=False, mask=None,
                         layout="bshd"):
    """``(o, lse)``, differentiable in q, k, v. ``mask``: None or a
    factored ``(q_valid, k_valid)`` padding mask (K1/K6 with K2/K6 as the
    backward; the kernels stream the key factor, the op applies the query
    factor), a :class:`SegmentIds` (K5, bshd), or a dense bool tensor
    (K1-dense/K6-fwd; the backward recomputes)."""
    if is_segment_mask(mask):
        if layout != "bshd":
            raise ValueError("segment masks take the bshd layout")
        return FlashSegmentAttention.apply(q, k, v, mask, scale, causal)
    if isinstance(mask, (tuple, list)):
        return FlashAttention.apply(q, k, v, scale, causal, mask[1], None,
                                    layout)
    return FlashAttention.apply(q, k, v, scale, causal, None, mask, layout)


def flash_bwd_from_saved(q, k, v, o, lse, g, scale=None, causal=False,
                         mask=None, layout="bshd"):
    """``(dq, dk, dv)`` from the saved forward residuals — what the IR's
    ``fused_attention_grad`` op calls; it never re-runs the forward.
    ``mask``: None, a factored pair or a :class:`SegmentIds` (a dense
    mask's backward recomputes: :func:`plain_vjp`)."""
    if is_segment_mask(mask):
        if layout != "bshd":
            raise ValueError("segment masks take the bshd layout")
        return flash_bwd_segment(q, k, v, o, lse, g, mask, scale, causal)
    if mask is not None and not isinstance(mask, (tuple, list)):
        raise ValueError("no saved-residual backward takes a dense mask: "
                         "it recomputes (plain_vjp)")
    k_valid = None if mask is None else mask[1]
    return flash_bwd(q, k, v, o, lse, g, scale, causal, k_valid, layout)
