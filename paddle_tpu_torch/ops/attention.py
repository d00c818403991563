"""Attention ops — ports of ``paddle_tpu/ops/attention_ops.py``.

Serving: ``dot_product_attention`` (causal, bshd/bhsd, GQA) and
``paged_chunk_attention`` (the paged prefill) stay plain PyTorch, as the
JAX package computes them outside any Pallas kernel. The reference's
``decode_paged_attention`` (the paged decode step) is the K3 wrapper
itself: ``ops.paged_attention.paged_decode_attention``.

Training: the IR ops ``fused_attention`` and ``fused_attention_grad``.
On every device they take the reference's ``pallas_saved`` path: the
forward runs K1 (``ops.flash_attention``) and stores its logsumexp as
the op's ``Lse`` output, and the grad op runs K2 on the saved (Q, K, V,
Out, Lse) without re-running the forward. The reference picks that path
from a TPU-measured threshold (seq >= 512 for bshd); the port takes it
at every length, and CPU tensors take the kernels' plain versions.
Unported: segment ids (K5), dense masks and the bhsd layout (K1's dense
variant and K6) raise ``NotImplementedError``.

Numerics follow the reference: logits in fp32 (the reference's
``preferred_element_type=float32``), masked with -1e9, softmax in fp32,
probabilities cast to q's dtype before the product with V.
"""

import numpy as np
import torch

from ..framework import in_var, set_out
from ..registry import register_op
from . import flash_attention

__all__ = ["dot_product_attention", "paged_chunk_attention", "NEG_INF"]

NEG_INF = -1e9


def _expand_kv(k, v, heads, head_ax):
    """GQA/MQA: repeat each kv head over its contiguous query group."""
    if k.shape[head_ax] != heads:
        group = heads // k.shape[head_ax]
        k = k.repeat_interleave(group, dim=head_ax)
        v = v.repeat_interleave(group, dim=head_ax)
    return k, v


def dot_product_attention(q, k, v, *, causal=False, scale=None,
                          layout="bhsd"):
    """q, k, v: [batch, heads, seq, head_dim] (``layout="bshd"``: [batch,
    seq, heads, head_dim]); q may have its own seq length. Causal masking
    aligns q's last row with k's last row."""
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
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    if layout == "bshd":
        return torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def paged_chunk_attention(q, k_pool, v_pool, page_table, base_lengths, *,
                          scale=None):
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
    excluded by the -1e9 mask."""
    S, T, H = q.shape[0], q.shape[1], q.shape[2]
    base = base_lengths.reshape(-1).long()
    idx = page_table.long()
    kc = k_pool[idx].reshape(S, -1, *k_pool.shape[2:])
    vc = v_pool[idx].reshape(S, -1, *v_pool.shape[2:])
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
    """The op's mask inputs → None or the factored ``(q_valid, k_valid)``
    pair ([b|1, s] bool each) from "QValid"/"KValid"."""
    if ins.get("Mask", [None])[0] is not None:
        raise NotImplementedError(
            "fused_attention with a dense Mask is not ported yet (K1's "
            "dense-mask variant and K6)")
    if ins.get("QSegIds", [None])[0] is not None or \
            ins.get("KSegIds", [None])[0] is not None:
        raise NotImplementedError("fused_attention with segment ids "
                                  "(packed-segment kernels, K5) is not "
                                  "ported yet")
    qv = ins.get("QValid", [None])[0]
    kv = ins.get("KValid", [None])[0]
    if qv is None and kv is None:
        return None
    if qv is None or kv is None:
        raise ValueError("factored masks need BOTH QValid and KValid")
    return qv.bool(), kv.bool().contiguous()


def _mask_padded_q_rows(x, mask):
    """Zero padded query rows of a bshd output or cotangent (the
    reference's op-boundary rule: the kernels stream only the key
    factor)."""
    if mask is None:
        return x
    return x * mask[0].to(x.dtype)[:, :, None, None]


def _qkv(ctx, ins):
    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
    if ctx.attr("layout", "bhsd") != "bshd":
        raise NotImplementedError(
            "fused_attention with layout %r is not ported yet (the per-head "
            "kernels, K6); the port takes bshd" % ctx.attr("layout", "bhsd"))
    if ctx.amp:
        q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    return q.contiguous(), k.contiguous(), v.contiguous()


def _fused_attention_rule(block, op):
    q = in_var(block, op, "Q")
    b, s, h = q.shape[0], q.shape[1], q.shape[2]
    set_out(block, op, "Out", q.shape, dtype=q.dtype)
    set_out(block, op, "Lse", [b * h, s, flash_attention.LSE_LANES],
            dtype="float32")


@register_op("fused_attention", infer_shape=_fused_attention_rule)
def _fused_attention(ctx, ins):
    q, k, v = _qkv(ctx, ins)
    mask = _resolve_mask(ins)
    out, lse = flash_attention.flash_fwd_saving_lse(
        q, k, v, ctx.attr("scale", None), ctx.attr("causal", False), mask)
    return {"Out": [_mask_padded_q_rows(out, mask)], "Lse": [lse]}


@register_op("fused_attention_grad", no_grad=True)
def _fused_attention_grad(ctx, ins):
    """K2 on the saved (Q, K, V, Out, Lse): the forward never runs again.
    Padded query rows get a zeroed cotangent, so their dq rows and dk/dv
    contributions vanish inside the kernels."""
    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
    qb, kb, vb = _qkv(ctx, ins)
    mask = _resolve_mask(ins)
    o = ins["Out"][0].to(qb.dtype).contiguous()
    g = _mask_padded_q_rows(ins["Out@GRAD"][0].to(qb.dtype), mask)
    dq, dk, dv = flash_attention.flash_bwd_from_saved(
        qb, kb, vb, o, ins["Lse"][0], g.contiguous(), ctx.attr("scale", None),
        ctx.attr("causal", False), mask)
    return {"Q@GRAD": [dq.to(q.dtype)], "K@GRAD": [dk.to(k.dtype)],
            "V@GRAD": [dv.to(v.dtype)]}
