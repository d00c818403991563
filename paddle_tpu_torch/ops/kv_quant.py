"""Quantized KV-page storage and weight-only quantization — the port of
``paddle_tpu/ops/kv_quant.py`` (a trimmed copy: the port never imports
the JAX package).

* **KV pages.** The paged engine's pools are stored int8 or fp8
  (``torch.float8_e4m3fn``) with one fp32 scale per (page, token group,
  kv head) in a ``[num_pages + 1, G, kv_heads]`` tensor per layer beside
  the page table. :func:`paged_quant_append` is the append: gather the
  touched pages, dequantize, insert the new values, grow the touched
  groups' scales, requantize. It RETURNS the window's new rows and
  scales; the engine writes them back into its pools in place
  (:func:`write_window`). Scales only grow, so dequant → requant at an
  unchanged scale is the identity and repeated appends add no error to
  resident tokens; a virgin group (scale 0) dequantizes to exact zeros.
  The decode attention dequantizes inside the K3-quant kernel
  (``ops.paged_attention``); the prefill's gather dequantizes here.

* **Weights.** :func:`quantize_weight` gives per-output-channel int8 or
  fp8 payloads of a 2-D matrix; the model dequantizes each one before
  its matmul (:func:`dequantize_weight`).

Every function runs the reference's elementwise IEEE operations in the
same order (fp32 multiply and divide, ``round`` half to even, clamp, one
cast), so the same inputs give the same bits on the CPU and on the card.
"""

import numpy as np
import torch

__all__ = [
    "KVQuantConfig", "QUANT_DTYPES", "WEIGHT_QUANT_DTYPES",
    "dequant_pages", "equal_memory_pages", "gather_rows",
    "paged_quant_append", "write_window", "quantize_weight",
    "dequantize_weight", "storage_dtype",
]

# kv_quant_dtype and weight-quantization modes ("off" = disabled)
QUANT_DTYPES = ("off", "fp8", "int8")
WEIGHT_QUANT_DTYPES = QUANT_DTYPES

_QMAX = {"int8": 127.0, "fp8": 448.0}  # e4m3fn max finite


def storage_dtype(mode):
    """The element dtype of quantized storage."""
    return torch.int8 if mode == "int8" else torch.float8_e4m3fn


class KVQuantConfig:
    """Static description of a quantized page pool: storage dtype and
    scale-group geometry."""

    def __init__(self, mode, page_size, group=0):
        if mode not in ("fp8", "int8"):
            raise ValueError("kv quant mode must be fp8|int8 (got %r)"
                             % (mode,))
        page_size = int(page_size)
        group = int(group) or page_size
        if page_size % group:
            raise ValueError("quant group %d must divide page_size %d"
                             % (group, page_size))
        self.mode = mode
        self.page_size = page_size
        self.group = group                      # tokens per scale group
        self.groups_per_page = page_size // group
        self.qmax = _QMAX[mode]
        self.storage_dtype = storage_dtype(mode)

    def scale_shape(self, n_pages, kv_heads):
        """Per-pool scale tensor shape: one fp32 scale per (page,
        token group, kv head)."""
        return (int(n_pages), self.groups_per_page, int(kv_heads))

    def page_bytes(self, kv_heads, head_dim):
        """Storage bytes of ONE pool row and its scales (K or V)."""
        return (self.page_size * int(kv_heads) * int(head_dim)
                + 4 * self.groups_per_page * int(kv_heads))

    def describe(self):
        return {"kv_quant_dtype": self.mode, "kv_quant_group": self.group}


def equal_memory_pages(dense_pages, page_size, kv_heads, head_dim, cfg,
                       reference_bytes=2):
    """How many quantized pages fit in the memory of ``dense_pages``
    full-precision pages (``reference_bytes`` per element: 2 for bf16),
    counting the fp32 scale overhead."""
    dense_row = page_size * int(kv_heads) * int(head_dim) \
        * int(reference_bytes)
    return int(dense_pages) * dense_row // cfg.page_bytes(kv_heads,
                                                          head_dim)


# -- page-pool quantization --------------------------------------------------

def _expand_scales(scales, cfg):
    """[..., G, kv_heads] scale groups → [..., page, kv_heads, 1]
    per-position multipliers."""
    return scales.repeat_interleave(cfg.group, dim=-2)[..., None]


def gather_rows(t, idx):
    """``t[idx]`` along dim 0; fp8 tensors are indexed through a byte
    view (the indexing kernels cover the integer types on every device)."""
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8)[idx].view(t.dtype)
    return t[idx]


def dequant_pages(rows, scales, cfg, out_dtype=torch.float32):
    """Dequantize gathered pool rows: ``rows`` [..., page, kv_heads,
    head_dim] (storage dtype), ``scales`` [..., G, kv_heads] fp32."""
    return (rows.float() * _expand_scales(scales, cfg)).to(out_dtype)


def _quantize_rows(rows_f32, scales, cfg):
    """Quantize fp32 rows at the given (final) group scales. Scale-0
    groups divide by 1 and store exact zeros."""
    safe = _expand_scales(torch.where(scales > 0, scales,
                                      torch.ones_like(scales)), cfg)
    scaled = rows_f32 / safe
    if cfg.mode == "int8":
        return torch.clamp(torch.round(scaled), -cfg.qmax,
                           cfg.qmax).to(torch.int8)
    return torch.clamp(scaled, -cfg.qmax, cfg.qmax).to(cfg.storage_dtype)


def paged_quant_append(pool, scales, win_pids, w_idx, offs, vals, cfg):
    """Append ``vals`` into a quantized pool's write window:

      pool     [num_pages + 1, page, kv_heads, head_dim] storage dtype
      scales   [num_pages + 1, G, kv_heads] fp32
      win_pids [S, W] — page ids of each slot's write window (padded or
               redirected entries name the scratch page)
      w_idx    [S, T] — the window column chunk position j writes into
      offs     [S, T] — its offset within that page
      vals     [S, T, kv_heads, head_dim] — the new K or V values

    Returns ``(rows, new_scales)``: the window's requantized pages [S, W,
    page, kv_heads, head_dim] and their scales [S, W, G, kv_heads], to be
    written at ``win_pids`` (:func:`write_window`). Window pages that
    receive no write come back bitwise as they were. Duplicate window
    entries only ever name the scratch page, whose contents stay finite.
    """
    S = vals.shape[0]
    idx = win_pids.long()
    rows = gather_rows(pool, idx)               # [S, W, page, h, d]
    old = scales[idx]                           # [S, W, G, h]
    deq = dequant_pages(rows, old, cfg)         # fp32
    s_ix = torch.arange(S, device=vals.device)[:, None].expand_as(w_idx)
    w_idx, offs = w_idx.long(), offs.long()
    v32 = vals.float()
    deq[s_ix, w_idx, offs] = v32
    # per-token amax per kv head, max-reduced into the touched groups
    tok_amax = v32.abs().amax(dim=-1)           # [S, T, h]
    W, G, KVH = old.shape[1], old.shape[2], old.shape[3]
    flat = ((s_ix * W + w_idx) * G + torch.div(
        offs, cfg.group, rounding_mode="floor")).reshape(-1)
    gmax = torch.zeros(S * W * G, KVH, dtype=torch.float32,
                       device=vals.device)
    gmax.scatter_reduce_(0, flat[:, None].expand(-1, KVH),
                         tok_amax.reshape(-1, KVH), "amax")
    # divide by a tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not the IEEE quotient
    new = torch.maximum(old, gmax.reshape(old.shape)
                        / gmax.new_full((), cfg.qmax))
    return _quantize_rows(deq, new, cfg), new


def write_window(pool, scales, win_pids, rows, new_scales):
    """Write :func:`paged_quant_append`'s window back in place."""
    idx = win_pids.long()
    if pool.dtype == torch.float8_e4m3fn:
        pool, rows = pool.view(torch.uint8), rows.view(torch.uint8)
    pool.index_put_((idx,), rows)
    scales.index_put_((idx,), new_scales)


# -- weight-only quantization ------------------------------------------------

def quantize_weight(arr, mode):
    """Per-output-channel quantization of a 2-D matrix (numpy array or
    tensor): ``(qw, scale)`` with ``qw`` [rows, cols] in the storage
    dtype and ``scale`` fp32 [cols], both CPU tensors (dequant = qw *
    scale). All-zero columns keep scale 0 and quantize to exact zeros."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().to(device="cpu", dtype=torch.float32).numpy()
    a = np.asarray(arr, np.float32)
    if a.ndim != 2:
        raise ValueError("weight quantization needs a 2-D matrix "
                         "(got shape %r)" % (a.shape,))
    qmax = _QMAX[mode]
    amax = np.abs(a).max(axis=0)
    scale = np.where(amax > 0, amax / qmax, 0.0).astype(np.float32)
    scaled = a / np.where(scale > 0, scale, 1.0)[None, :]
    if mode == "int8":
        qw = torch.from_numpy(
            np.clip(np.rint(scaled), -qmax, qmax).astype(np.int8))
    else:
        qw = torch.from_numpy(np.ascontiguousarray(scaled, np.float32)).to(
            storage_dtype(mode))
    return qw, torch.from_numpy(scale)


def dequantize_weight(qw, scale, out_dtype=torch.float32):
    """Dequant-on-use half of :func:`quantize_weight`, run before each
    matmul that consumes the weight."""
    return (qw.float() * scale[None, :]).to(out_dtype)
