"""Attention ops — ports of ``paddle_tpu/ops/attention_ops.py``.

Serving: ``dot_product_attention`` (causal, bshd/bhsd, GQA),
``decode_cache_attention`` (the dense engine's decode step, also the
``decode_cache_attention`` graph op) and ``paged_chunk_attention`` (the
paged prefill and the speculative verify chunk) stay plain PyTorch, as
the JAX package computes them outside any Pallas kernel. The reference's
``decode_paged_attention`` (the paged decode step) is the K3 wrapper
itself: ``ops.paged_attention.paged_decode_attention``.

Training: the IR ops ``fused_attention`` and ``fused_attention_grad``,
in both layouts (``layout`` attr, default ``"bhsd"`` [b, h, s, d];
``"bshd"`` [b, s, h, d]) and under every mask input the reference takes
(``Mask`` > ``QSegIds``/``KSegIds`` > ``QValid``/``KValid``).
:func:`dispatch_path`, a pure function of shapes, picks one of:

- ``"saved"`` (the reference's ``pallas_saved``): no mask, a factored
  padding mask or segment ids (bshd). The forward runs K1, K6-fwd or K5
  from ``ops.flash_attention`` and stores its logsumexp as the op's
  ``Lse`` output; the grad op runs K2, K6 or K5's backward on the saved
  (Q, K, V, Out, Lse) without re-running the forward. The reference
  picks that path from TPU-measured thresholds (seq >= 512 for bshd,
  4096 for bhsd); the port takes it at every length.
- ``"dense"`` (the reference's ``pallas``): a dense mask the kernels take
  ([b|1, h|1, s, s] in bhsd, head-broadcast [b|1, 1, s, s] in bshd). The
  forward runs K6-fwd or K1-dense and stores a real ``Lse`` (the
  reference's is zeros there); the grad op recomputes through the plain
  composition, as the reference's generic grad does.
- ``"plain"`` (the reference's ``xla``): what no kernel takes — a bshd
  per-head mask, segment ids in bhsd, a mask of another shape, head_dim
  above 256 — runs :func:`dot_product_attention`, forward and backward;
  ``Lse`` is zeros, as the reference's.

CPU tensors take the kernels' plain versions.

Numerics follow the reference: logits in fp32 (the reference's
``preferred_element_type=float32``), masked with -1e9, softmax in fp32,
probabilities cast to q's dtype before the product with V.
"""

import numpy as np
import torch

from ..framework import in_var, same_shape_rule, set_out
from ..registry import register_op
from . import flash_attention, kv_quant
from .segment_mask import SegmentIds, densify_segment_mask

__all__ = ["dot_product_attention", "decode_cache_attention", "dense_mask",
           "dispatch_path", "paged_chunk_attention", "NEG_INF"]

NEG_INF = -1e9


def _expand_kv(k, v, heads, head_ax):
    """GQA/MQA: repeat each kv head over its contiguous query group."""
    if k.shape[head_ax] != heads:
        group = heads // k.shape[head_ax]
        k = k.repeat_interleave(group, dim=head_ax)
        v = v.repeat_interleave(group, dim=head_ax)
    return k, v


def dense_mask(mask):
    """A mask of the op (a bool tensor broadcastable to [b, h, s_q, s_k],
    a factored ``(q_valid, k_valid)`` pair or :class:`SegmentIds`) as a
    dense bool [b|1, h|1, s_q, s_k] (True = visible)."""
    if isinstance(mask, (tuple, list)):
        return mask[0].bool()[:, None, :, None] & \
            mask[1].bool()[:, None, None, :]
    if isinstance(mask, SegmentIds):
        return densify_segment_mask(mask)
    return mask.bool()


def dot_product_attention(q, k, v, *, causal=False, scale=None, mask=None,
                          layout="bhsd"):
    """q, k, v: [batch, heads, seq, head_dim] (``layout="bshd"``: [batch,
    seq, heads, head_dim]); q may have its own seq length. Causal masking
    aligns q's last row with k's last row. ``mask``: any mask of
    :func:`dense_mask`; hidden logits are -1e9, as causal ones."""
    head_ax = 2 if layout == "bshd" else 1
    k, v = _expand_kv(k, v, q.shape[head_ax], head_ax)
    scale = scale if scale is not None else 1.0 / float(np.sqrt(q.shape[-1]))
    if layout == "bshd":
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    else:
        logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    logits = logits * scale
    if causal:
        qlen, klen = logits.shape[-2], logits.shape[-1]
        idx_q = torch.arange(qlen, device=q.device)[:, None] + (klen - qlen)
        idx_k = torch.arange(klen, device=q.device)[None, :]
        logits = logits.masked_fill(~(idx_k <= idx_q), NEG_INF)
    if mask is not None:
        logits = logits.masked_fill(~dense_mask(mask), NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if layout == "bshd":
        return torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def decode_cache_attention(q, k_cache, v_cache, cache_lengths, *,
                           scale=None):
    """One query token per slot against a dense per-slot KV cache, masked
    by the slot's live length:

      q:               [slots, heads, head_dim]
      k/v caches:      [slots, max_len, kv_heads, head_dim]
      cache_lengths:   [slots] (or [slots, 1]); positions < length are
                       valid, and the current token's K/V is already
                       written at position length - 1

    The mask comes from the lengths alone: rows past a slot's length may
    hold a rewound speculative tail or a previous occupant's values and
    are never read. GQA/MQA: heads % kv_heads == 0."""
    lengths = cache_lengths.reshape(-1).long()
    k_cache, v_cache = _expand_kv(k_cache, v_cache, q.shape[1], 2)
    scale = scale if scale is not None else 1.0 / float(np.sqrt(q.shape[-1]))
    logits = torch.einsum("shd,sthd->sht", q.float(), k_cache.float()) * \
        scale
    valid = torch.arange(k_cache.shape[1], device=q.device)[None, :] < \
        lengths[:, None]
    logits = logits.masked_fill(~valid[:, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("sht,sthd->shd", probs, v_cache)


@register_op("decode_cache_attention", no_grad=True,
             infer_shape=same_shape_rule("Q"))
def _decode_cache_attention(ctx, ins):
    """Graph-level variant (inference only): Q [slots, heads, dim],
    KCache/VCache [slots, max_len, kv_heads, dim], CacheLengths
    [slots]."""
    out = decode_cache_attention(
        ins["Q"][0], ins["KCache"][0], ins["VCache"][0],
        ins["CacheLengths"][0], scale=ctx.attr("scale", None))
    return {"Out": [out]}


def paged_chunk_attention(q, k_pool, v_pool, page_table, base_lengths, *,
                          scale=None, k_scale=None, v_scale=None, quant=None):
    """Chunked attention against a paged KV pool:

      q:          [slots, chunk, heads, head_dim]; chunk token j sits at
                  cache position ``base_lengths[s] + j`` and its K/V is
                  already written into the pool
      k/v pools:  [num_pages + 1, page_size, kv_heads, head_dim]
      page_table: [slots, max_pages] int32 (entries past a slot's pages
                  may point anywhere: they are masked)
      base_lengths: [slots]; token j attends over positions
                  < base + j + 1

    The named pool rows are gathered into each slot's logical sequence;
    positions past the mask hold finite stale or scratch values and are
    excluded by the -1e9 mask. Quantized pools (``quant`` a
    ``KVQuantConfig`` with per-(page, group, kv-head) ``k_scale`` /
    ``v_scale``) are dequantized in the gather to q's dtype, as the
    reference's lowering does."""
    S, T, H = q.shape[0], q.shape[1], q.shape[2]
    base = base_lengths.reshape(-1).long()
    idx = page_table.long()
    if quant is not None:
        kc = kv_quant.dequant_pages(kv_quant.gather_rows(k_pool, idx),
                                    k_scale[idx], quant, out_dtype=q.dtype)
        vc = kv_quant.dequant_pages(kv_quant.gather_rows(v_pool, idx),
                                    v_scale[idx], quant, out_dtype=q.dtype)
    else:
        kc, vc = k_pool[idx], v_pool[idx]
    kc = kc.reshape(S, -1, *k_pool.shape[2:])
    vc = vc.reshape(S, -1, *v_pool.shape[2:])
    kc, vc = _expand_kv(kc, vc, H, 2)
    scale = scale if scale is not None else 1.0 / float(np.sqrt(q.shape[-1]))
    logits = torch.einsum("sjhd,sthd->shjt", q.float(), kc.float()) * scale
    pos = torch.arange(kc.shape[1], device=q.device)[None, None, :]
    limit = base[:, None, None] + \
        torch.arange(T, device=q.device)[None, :, None] + 1
    logits = logits.masked_fill(~(pos < limit)[:, None, :, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("shjt,sthd->sjhd", probs, vc)


# -- fused_attention (training) ----------------------------------------------

def _resolve_mask(ins):
    """The op's mask inputs, with the reference's precedence Mask > SegIds
    > Valid: a dense bool tensor from "Mask" ([b|1, h|1, s, s]), a
    :class:`SegmentIds` of int32 [b, s] ids from "QSegIds"/"KSegIds",
    else None or the factored ``(q_valid, k_valid)`` pair ([b|1, s] bool
    each) from "QValid"/"KValid"."""
    mask = ins.get("Mask", [None])[0]
    if mask is not None:
        return mask.bool().contiguous()
    qs = ins.get("QSegIds", [None])[0]
    ks = ins.get("KSegIds", [None])[0]
    if qs is not None or ks is not None:
        if qs is None or ks is None:
            raise ValueError("segment masks need BOTH QSegIds and KSegIds")
        return SegmentIds(qs.to(torch.int32).contiguous(),
                          ks.to(torch.int32).contiguous())
    qv = ins.get("QValid", [None])[0]
    kv = ins.get("KValid", [None])[0]
    if qv is None and kv is None:
        return None
    if qv is None or kv is None:
        raise ValueError("factored masks need BOTH QValid and KValid")
    return qv.bool(), kv.bool().contiguous()


def dispatch_path(q, k, mask, layout):
    """``"saved"``, ``"dense"`` or ``"plain"`` (see the module docstring)
    for q, k in ``layout`` under ``mask`` (as :func:`_resolve_mask` gives
    it) — decided from shapes alone, before any launch, so the forward
    and the grad op take the same path. The counterpart of the
    reference's ``_dispatch_path`` and ``pallas_attention.supports``."""
    if flash_attention.dims(q, k, layout)[4] > flash_attention.MAX_HEAD_DIM:
        return "plain"
    if isinstance(mask, SegmentIds):
        return "saved" if layout == "bshd" else "plain"
    if mask is None or isinstance(mask, (tuple, list)):
        return "saved"
    if flash_attention.takes_dense_mask(q, k, mask, layout):
        return "dense"
    return "plain"


def _mask_padded_q_rows(x, mask, layout):
    """Zero padded query rows of an output or cotangent in ``layout`` (the
    reference's op-boundary rule: the kernels stream only the key
    factor). Other masks leave it as it is: a segment-masked row's padding
    segment attends itself, as in the reference."""
    if not isinstance(mask, tuple):
        return x
    qv = mask[0].to(x.dtype)
    if layout == "bshd":
        return x * qv[:, :, None, None]
    return x * qv[:, None, :, None]


def _qkv(ctx, ins):
    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
    if ctx.amp:
        q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    return q.contiguous(), k.contiguous(), v.contiguous()


def _attrs(ctx):
    return (ctx.attr("scale", None), ctx.attr("causal", False),
            ctx.attr("layout", "bhsd"))


def _bhs(shape, layout):
    return (shape[0], shape[2], shape[1]) if layout == "bshd" else \
        (shape[0], shape[1], shape[2])


def _fused_attention_rule(block, op):
    q = in_var(block, op, "Q")
    b, h, s = _bhs(q.shape, op.attr("layout", "bhsd"))
    set_out(block, op, "Out", q.shape, dtype=q.dtype)
    set_out(block, op, "Lse", [b * h if b >= 0 else -1, s,
                               flash_attention.LSE_LANES], dtype="float32")


@register_op("fused_attention", infer_shape=_fused_attention_rule)
def _fused_attention(ctx, ins):
    q, k, v = _qkv(ctx, ins)
    scale, causal, layout = _attrs(ctx)
    mask = _resolve_mask(ins)
    if dispatch_path(q, k, mask, layout) == "plain":
        out = dot_product_attention(q, k, v, causal=causal, scale=scale,
                                    mask=mask, layout=layout)
        b, h, s = _bhs(q.shape, layout)
        lse = torch.zeros((b * h, s, flash_attention.LSE_LANES),
                          dtype=torch.float32, device=q.device)
    else:
        out, lse = flash_attention.flash_fwd_saving_lse(
            q, k, v, scale, causal, mask, layout)
    return {"Out": [_mask_padded_q_rows(out, mask, layout)], "Lse": [lse]}


@register_op("fused_attention_grad", no_grad=True)
def _fused_attention_grad(ctx, ins):
    """On the saved path, K2, K6 or K5's backward on the saved (Q, K, V,
    Out, Lse): the forward never runs again. Padded query rows get a
    zeroed cotangent, so their dq rows and dk/dv contributions vanish
    inside the kernels. Elsewhere (a dense mask, what no kernel takes),
    the vjp of the plain composition, recomputed from Q, K, V — what the
    reference's generic grad computes there."""
    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
    qb, kb, vb = _qkv(ctx, ins)
    scale, causal, layout = _attrs(ctx)
    mask = _resolve_mask(ins)
    g = _mask_padded_q_rows(ins["Out@GRAD"][0].to(qb.dtype), mask, layout)
    if dispatch_path(qb, kb, mask, layout) == "saved":
        o = ins["Out"][0].to(qb.dtype).contiguous()
        dq, dk, dv = flash_attention.flash_bwd_from_saved(
            qb, kb, vb, o, ins["Lse"][0], g.contiguous(), scale, causal,
            mask, layout)
    else:
        dq, dk, dv = flash_attention.plain_vjp(
            qb, kb, vb, g, scale, causal, mask, layout)
    return {"Q@GRAD": [dq.to(q.dtype)], "K@GRAD": [dk.to(k.dtype)],
            "V@GRAD": [dv.to(v.dtype)]}
