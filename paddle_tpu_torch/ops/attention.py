"""Attention ops of the serving slice — ports of
``paddle_tpu/ops/attention_ops.py``: ``dot_product_attention`` (causal,
bshd/bhsd, GQA) and ``paged_chunk_attention`` (the paged prefill).

Both stay plain PyTorch, as the JAX package computes them outside any
Pallas kernel. The reference's third op, ``decode_paged_attention``
(the paged decode step), is the K3 wrapper itself:
``ops.paged_attention.paged_decode_attention`` runs the hand-written
kernel on CUDA tensors and its plain version on CPU tensors.

Numerics follow the reference: logits in fp32 (the reference's
``preferred_element_type=float32``), masked with -1e9, softmax in fp32,
probabilities cast to q's dtype before the product with V.
"""

import numpy as np
import torch

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

