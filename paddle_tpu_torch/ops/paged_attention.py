"""Paged decode attention (K3 and K3-quant): the wrapper of the
hand-written CUDA kernel ``csrc/paged_decode.cu`` and its plain PyTorch
version.

It replaces ``paddle_tpu/ops/pallas_paged_attention.py::
paged_flash_decode`` (the Pallas TPU kernel): single-token attention per
slot over the live positions ``< max(len, 1)`` of its pages, GQA (``H %
KVH == 0``), online softmax with fp32 statistics, output ``acc / max(l,
1e-30)`` in q's dtype. K3 takes full-precision pools (fp32/bf16, q's
dtype); K3-quant, the same kernel body instantiated with a one-byte
storage type, takes int8 or fp8 (e4m3fn) pools with per-(page, group,
kv-head) fp32 scales: token ``t`` of page ``p`` for kv head ``h`` is
``float(x) * scale[p, t // group, h]``, dequantized in fp32 as the TPU
kernel does. What bounds the kernel on the H100 (device-memory bytes)
and how it is laid out is written at the top of the CUDA source.

The kernel splits each slot's page table into chunks of
:func:`split_plan`'s pages, one block per (kv head, slot, chunk), and
merges the chunks' partial softmax states in the same launch; the
wrapper hands it the workspace and ticket counters for that merge, kept
per (device, stream) from PyTorch's caching allocator (the counters are
zeroed once per buffer and left at zero by every call).

:func:`paged_decode_attention` takes the plain version only for tensors
that lie on the CPU. For CUDA tensors it checks what the kernel takes
and launches it on the current stream, or raises: there is no fallback.
``launches`` counts K3's launches and ``launches_quant`` K3-quant's (and
nothing else), so a run can show that its decode steps went through the
kernel. A call made while its stream is being captured into a CUDA graph
is counted at each replay of the graph (``launch_count``).
"""

import ctypes

import numpy as np
import torch

from . import kv_quant, launch_count

__all__ = ["paged_decode_attention", "paged_decode_attention_plain",
           "split_plan", "launches", "launches_quant", "MAX_HEAD_DIM",
           "NEG_INF", "SPLIT_TOKENS"]

NEG_INF = -1e30
MAX_HEAD_DIM = 256
_SMEM_LIMIT = 232448        # bytes of shared memory one H100 block may use
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.int8: 1, torch.float8_e4m3fn: 2}   # quantized pools
# tokens of a split (rounded down to whole pages), by pool: fp32/bf16
# pools take 512, one-byte pools 128. Measured in turns on the H100 80GB
# HBM3 (700 W) over 128, 256 and 512: bf16 K3 at the 32-slot decode step
# 0.0224 ms at 512 against 0.0233 at 128 (most slots then need no merge)
# and 0.0282 against 0.0339 at 4 slots of 4096 tokens; int8 K3-quant
# 0.0218 at 128 against 0.0234 at 512
SPLIT_TOKENS = {False: 512, True: 128}  # keyed by "the pools are quantized"
_MAX_SPLIT_PAGES = 32       # page ids one warp holds in its lanes

launches = 0
launches_quant = 0
_workspaces = {}            # (device index, stream) -> (part, tickets)
_plans = {}                 # call geometry -> _plan's answer


def split_plan(max_pages, page, quant=False):
    """``(pages per split, splits)`` of a page table ``max_pages`` wide
    (int8/fp8 pools when ``quant``): chunks of whole pages, about
    ``SPLIT_TOKENS[quant]`` tokens (at most 32 pages, at least one, never
    wider than the table); split ``i`` covers tokens
    ``[i * pages * page, min((i + 1) * pages, max_pages) * page)``, so the
    splits cover the table once. The kernel launches ``splits`` blocks per
    (slot, kv head) and those past a slot's live frontier return at
    once."""
    pages = max(1, min(_MAX_SPLIT_PAGES, SPLIT_TOKENS[quant] // page,
                       max_pages))
    return pages, -(-max_pages // pages)


def _check_shapes(q, k_pool, v_pool, page_table, lengths, k_scale, v_scale,
                  quant):
    if q.dim() != 3 or k_pool.dim() != 4 or page_table.dim() != 2:
        raise ValueError(
            "paged decode attention takes q [S, H, D], pools [P+1, page, "
            "KVH, D] and page_table [S, MP] (got %s, %s, %s)"
            % (tuple(q.shape), tuple(k_pool.shape), tuple(page_table.shape)))
    if tuple(v_pool.shape) != tuple(k_pool.shape):
        raise ValueError("k_pool %s and v_pool %s differ in shape"
                         % (tuple(k_pool.shape), tuple(v_pool.shape)))
    S, H, D = q.shape
    if k_pool.shape[3] != D:
        raise ValueError("pool head_dim %d != q head_dim %d"
                         % (k_pool.shape[3], D))
    if H % k_pool.shape[2]:
        raise ValueError("heads %d not divisible by kv_heads %d"
                         % (H, k_pool.shape[2]))
    if page_table.shape[0] != S or lengths.numel() != S:
        raise ValueError("page_table %s / lengths %s do not match %d slots"
                         % (tuple(page_table.shape), tuple(lengths.shape),
                            S))
    quantized = k_pool.dtype in _KV_DTYPES or v_pool.dtype in _KV_DTYPES
    if quantized != (quant is not None):
        raise ValueError(
            "int8/fp8 pools need quant= (a KVQuantConfig) with k_scale and "
            "v_scale, and quant= needs int8/fp8 pools (got pools %s/%s, "
            "quant %r)" % (k_pool.dtype, v_pool.dtype, quant))
    if quant is None:
        return
    if k_pool.dtype != quant.storage_dtype or \
            v_pool.dtype != quant.storage_dtype:
        raise TypeError("pools %s/%s are not the %s storage dtype %s"
                        % (k_pool.dtype, v_pool.dtype, quant.mode,
                           quant.storage_dtype))
    if k_pool.shape[1] != quant.page_size:
        raise ValueError("pool page %d != quant page_size %d"
                         % (k_pool.shape[1], quant.page_size))
    want = quant.scale_shape(k_pool.shape[0], k_pool.shape[2])
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t is None or tuple(t.shape) != want or t.dtype != torch.float32:
            raise ValueError("%s must be float32 %s (got %s)" % (
                name, want, None if t is None else
                "%s %s" % (t.dtype, tuple(t.shape))))


def paged_decode_attention_plain(q, k_pool, v_pool, page_table, lengths,
                                 scale=None, k_scale=None, v_scale=None,
                                 quant=None):
    """The kernel's function in plain PyTorch: gather each slot's pages
    (dequantized in fp32 for int8/fp8 pools), mask positions ``>= max(len,
    1)``, softmax and weighted sum in fp32, cast to q's dtype. Used for
    CPU tensors and as the reference the kernel is held against on the
    card."""
    S, H, D = q.shape
    _, page, KVH, _ = k_pool.shape
    MP = page_table.shape[1]
    scale = float(scale) if scale is not None else 1.0 / float(np.sqrt(D))
    n = lengths.reshape(-1).long().clamp(min=1, max=MP * page)
    idx = page_table.long()
    if quant is not None:
        kc = kv_quant.dequant_pages(kv_quant.gather_rows(k_pool, idx),
                                    k_scale[idx], quant)
        vc = kv_quant.dequant_pages(kv_quant.gather_rows(v_pool, idx),
                                    v_scale[idx], quant)
    else:
        kc, vc = k_pool[idx].float(), v_pool[idx].float()
    kc = kc.reshape(S, MP * page, KVH, D)
    vc = vc.reshape(S, MP * page, KVH, D)
    qg = q.float().reshape(S, KVH, H // KVH, D)
    logits = torch.einsum("skgd,stkd->skgt", qg, kc) * scale
    valid = torch.arange(MP * page, device=q.device)[None, :] < n[:, None]
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("skgt,stkd->skgd", probs, vc)
    return out.reshape(S, H, D).to(q.dtype)


def _bind():
    from .. import _build
    lib = _build.load("paged_decode")
    if not getattr(lib, "_bound", False):
        lib.paddle_paged_decode.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 +
            [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.paddle_paged_decode.restype = ctypes.c_int
        lib.paddle_paged_decode_quant.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 +
            [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        lib.paddle_paged_decode_quant.restype = ctypes.c_int
        lib.paddle_paged_decode_smem_bytes.argtypes = [ctypes.c_int] * 6
        lib.paddle_paged_decode_smem_bytes.restype = ctypes.c_size_t
        lib.paddle_paged_decode_workspace.argtypes = (
            [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_size_t)] * 2)
        lib.paddle_paged_decode_workspace.restype = None
        lib.paddle_cuda_error_string.argtypes = [ctypes.c_int]
        lib.paddle_cuda_error_string.restype = ctypes.c_char_p
        lib._bound = True
    return lib


def paged_decode_attention(q, k_pool, v_pool, page_table, lengths,
                           scale=None, k_scale=None, v_scale=None,
                           quant=None):
    """Single-token attention against a paged KV pool (K3, or K3-quant
    for quantized pools).

      q:          [slots, heads, head_dim]  (this step's token)
      k/v pools:  [num_pages + 1, page_size, kv_heads, head_dim]
      page_table: [slots, max_pages] int32 page ids in sequence order
      lengths:    [slots] int32; positions < max(length, 1) are live and
                  the current token's K/V is already written
      quant:      None, or the ``KVQuantConfig`` of int8/fp8 pools, with
                  ``k_scale``/``v_scale`` [num_pages + 1, G, kv_heads] fp32

    CPU tensors take :func:`paged_decode_attention_plain`. CUDA tensors
    launch the kernel; anything it does not take (other dtypes, head_dim
    > 256, non-contiguous inputs, mixed devices) raises."""
    _check_shapes(q, k_pool, v_pool, page_table, lengths, k_scale, v_scale,
                  quant)
    tensors = [q, k_pool, v_pool, page_table, lengths]
    if quant is not None:
        tensors += [k_scale, v_scale]
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError("paged decode attention inputs span devices %s"
                         % sorted(str(d) for d in devices))
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, page_table,
                                            lengths, scale, k_scale,
                                            v_scale, quant)
    if q.device.type != "cuda":
        raise ValueError("paged decode attention runs on cpu or cuda "
                         "tensors (got %s)" % q.device)
    if q.dtype not in _DTYPES or (quant is None and (
            k_pool.dtype != q.dtype or v_pool.dtype != q.dtype)):
        raise TypeError(
            "the paged decode kernel takes float32 or bfloat16 q with pools "
            "of q's dtype, or int8/fp8 pools with scales (got q %s, pools "
            "%s/%s)" % (q.dtype, k_pool.dtype, v_pool.dtype))
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("page_table and lengths must be int32 (got %s, %s)"
                        % (page_table.dtype, lengths.dtype))
    named = [("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
             ("page_table", page_table), ("lengths", lengths)]
    if quant is not None:
        named += [("k_scale", k_scale), ("v_scale", v_scale)]
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
    S, H, D = q.shape
    _, page, KVH, _ = k_pool.shape
    if D > MAX_HEAD_DIM or D % 8:
        raise ValueError("the paged decode kernel supports head_dim <= %d "
                         "and a multiple of 8 (got %d)" % (MAX_HEAD_DIM, D))
    for name, t in named[:3]:
        if t.data_ptr() % 16:
            raise ValueError("%s must be 16-byte aligned (vector loads)"
                             % name)
    lib = _bind()
    per, smem, need = _plan(lib, S, H, KVH, D, k_pool.element_size(),
                            quant is not None, page, page_table.shape[1])
    if smem > _SMEM_LIMIT:
        raise ValueError(
            "group %d x head_dim %d needs %d bytes of shared memory per "
            "block (limit %d)" % (H // KVH, D, smem, _SMEM_LIMIT))
    out = torch.empty_like(q)
    if S == 0:
        return out
    scale = float(scale) if scale is not None else 1.0 / float(np.sqrt(D))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        part, tickets = _workspace(q.device, stream, need)
        if quant is None:
            err = lib.paddle_paged_decode(
                q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                part, tickets, S, H, KVH, D, page, page_table.shape[1],
                k_pool.shape[0], per, scale, _DTYPES[q.dtype], stream)
        else:
            err = lib.paddle_paged_decode_quant(
                q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                k_scale.data_ptr(), v_scale.data_ptr(),
                page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                part, tickets, S, H, KVH, D, page, quant.group,
                page_table.shape[1], k_pool.shape[0], per, scale,
                _DTYPES[q.dtype], _KV_DTYPES[k_pool.dtype], stream)
    if err != 0:
        raise RuntimeError("paged decode kernel launch failed: CUDA error "
                           "%d (%s)" % (err, lib.paddle_cuda_error_string(
                               err).decode()))
    launch_count.launched("k3" if quant is None else "k3_quant", _add)
    return out


def _add(name, n):
    global launches, launches_quant
    if name == "k3":
        launches += n
    else:
        launches_quant += n


def _plan(lib, S, H, KVH, D, kv_bytes, quant, page, max_pages):
    """(pages per split, shared memory per block, (workspace floats,
    ticket counters)) of a call's geometry, as the library computes them;
    cached, since a serving step makes the same call once per layer."""
    key = (S, H, KVH, D, kv_bytes, quant, page, max_pages,
           SPLIT_TOKENS[quant])
    if key not in _plans:
        per, _ = split_plan(max_pages, page, quant)
        smem = lib.paddle_paged_decode_smem_bytes(H // KVH, D, kv_bytes,
                                                  int(quant), page, per)
        part, tickets = ctypes.c_size_t(), ctypes.c_size_t()
        lib.paddle_paged_decode_workspace(S, H, KVH, D, max_pages, per,
                                          ctypes.byref(part),
                                          ctypes.byref(tickets))
        _plans[key] = (per, smem, (part.value, tickets.value))
    return _plans[key]


def _workspace(device, stream, need):
    """Pointers to the split merge's fp32 workspace and int32 ticket
    counters of ``need`` = (floats, counters) for a call on ``stream``
    (None when the table is one split): kept per (device, stream) and
    grown as calls need, so calls on one stream, which run in order, share
    them; new counters start at zero and every call leaves them so."""
    if need[0] == 0:
        return None, None
    key = (device.index, stream)
    part, tickets = _workspaces.get(key, (None, None))
    if part is None or part.numel() < need[0]:
        part = torch.empty(need[0], dtype=torch.float32, device=device)
    if tickets is None or tickets.numel() < need[1]:
        tickets = torch.zeros(need[1], dtype=torch.int32, device=device)
    _workspaces[key] = (part, tickets)
    return part.data_ptr(), tickets.data_ptr()
