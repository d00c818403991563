"""Segment-id attention masks for packed batches — the port of
``paddle_tpu/ops/segment_mask.py``.

A packed batch concatenates several documents into each row of a
``[rows, seq]`` grid. :class:`SegmentIds` carries the O(s) form of the
mask that confines attention to each document: one int32 id per
position, and visibility by equality,

    position i may attend position j  <=>  q_seg[b, i] == kv_seg[b, j]
                                           (and j <= i when causal).

Conventions (``data.decorator.pack_segments`` produces them): segments
are numbered 0, 1, 2, ... in row order, so ids never decrease along a
row; the padded tail of a row is its last segment (one more id), whose
positions attend only each other. The flash kernels rely on the ids not
decreasing: the keys a query tile can see then form one contiguous
range (:func:`segment_block_windows`).
"""

import torch

__all__ = ["SegmentIds", "is_segment_mask", "densify_segment_mask",
           "segment_block_windows"]


class SegmentIds:
    """Factored segment mask: ``q`` [b, s_q] and ``kv`` [b, s_k] int32
    position → segment id. Deliberately not a tuple, so it is never taken
    for the factored padding mask ``(q_valid, k_valid)``."""

    def __init__(self, q, kv):
        self.q = q
        self.kv = kv


def is_segment_mask(mask):
    return isinstance(mask, SegmentIds)


def densify_segment_mask(mask):
    """SegmentIds → dense bool ``[b, 1, s_q, s_k]`` (True = visible, causal
    not applied)."""
    q = torch.as_tensor(mask.q)
    kv = torch.as_tensor(mask.kv)
    return q[:, None, :, None] == kv[:, None, None, :]


def segment_block_windows(q_seg, kv_seg, block_q, block_k, causal,
                          for_dkv=False):
    """Per-(batch, block) windows ``(lo, hi)`` of blocks, each [b, n]
    int32: for query block ``iq`` the key blocks ``lo..hi`` that can hold
    a key visible to one of its positions — from the segment start of the
    block's first position to the segment end of its last, cut by
    causality.

    ``for_dkv=True`` gives the transposed windows: for each key block the
    query blocks that can see it (pass ``block_q`` = the key block size,
    ``block_k`` = the query block size). A window with no visible block
    keeps one block (``hi = max(hi, lo)``), as the TPU kernels' index
    maps need."""
    q_seg = torch.as_tensor(q_seg).to(torch.int32)
    kv_seg = torch.as_tensor(kv_seg).to(torch.int32)
    outer, inner = (kv_seg, q_seg) if for_dkv else (q_seg, kv_seg)
    n_blocks = outer.shape[1] // block_q
    starts = torch.arange(n_blocks, device=outer.device) * block_q
    lasts = starts + block_q - 1
    inner = inner.contiguous()
    lo_pos = torch.searchsorted(inner, outer[:, starts].contiguous(),
                                side="left")
    hi_pos = torch.searchsorted(inner, outer[:, lasts].contiguous(),
                                side="right") - 1
    if causal:
        if for_dkv:   # key block j is visible only from its first position
            lo_pos = torch.maximum(lo_pos, starts[None, :])
        else:         # query block iq sees only keys up to its last position
            hi_pos = torch.minimum(hi_pos, lasts[None, :])
    lo_blk = torch.div(lo_pos, block_k, rounding_mode="floor")
    hi_blk = torch.maximum(torch.div(hi_pos, block_k, rounding_mode="floor"),
                           lo_blk)
    return lo_blk.to(torch.int32), hi_blk.to(torch.int32)
