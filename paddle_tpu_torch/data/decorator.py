"""Segment packing of documents into fixed-length rows — the port of
``paddle_tpu/data/decorator.py``'s ``pack_segments`` and
``packed_next_token_labels`` (numpy only; both produce the reference's
arrays exactly).

Conventions, which the segment flash kernels rely on: segment ids are
0, 1, 2, ... in row order (never decreasing along a row), and a row's
padded tail is its last segment, with id = the number of real segments.
"""

import numpy as np

__all__ = ["pack_segments", "packed_next_token_labels"]


def pack_segments(samples, seq_len, key=None, pad_id=0):
    """First-fit-decreasing packing of 1-D token sequences into
    ``[seq_len]`` rows. Returns a list of ``(tokens, seg_ids)`` pairs of
    ``[seq_len]`` arrays: tokens in the samples' dtype padded with
    ``pad_id``, seg ids int32. Every sample lands whole in one row; empty
    samples are dropped; a sample longer than ``seq_len`` raises
    ValueError. ``key`` orders the samples (default ``len``)."""
    key = key or len
    seqs = [np.asarray(s) for s in samples]
    order = sorted(range(len(seqs)), key=lambda i: key(seqs[i]),
                   reverse=True)
    rows = []   # [used, [sample indices]]
    for i in order:
        n = len(seqs[i])
        if n > seq_len:
            raise ValueError(
                "pack_segments: sample of length %d exceeds the packed "
                "row length %d" % (n, seq_len))
        if n == 0:
            continue
        for row in rows:
            if row[0] + n <= seq_len:
                row[0] += n
                row[1].append(i)
                break
        else:
            rows.append([n, [i]])
    out = []
    for _used, members in rows:
        tokens = np.full(seq_len, pad_id, dtype=seqs[members[0]].dtype)
        seg = np.zeros(seq_len, np.int32)
        pos = 0
        for si, i in enumerate(members):
            s = seqs[i]
            tokens[pos:pos + len(s)] = s
            seg[pos:pos + len(s)] = si
            pos += len(s)
        seg[pos:] = len(members)   # padding = the row's final segment
        out.append((tokens, seg))
    return out


def packed_next_token_labels(tokens, seg_ids, ignore_id=-1, pad_id=0):
    """Next-token labels of a packed row (or ``[rows, seq]`` batch):
    ``label[i] = tokens[i + 1]`` where position i + 1 continues position
    i's segment and is not in the row's trailing padding, else
    ``ignore_id``."""
    tokens = np.asarray(tokens)
    seg = np.asarray(seg_ids)
    lab = np.full(tokens.shape, ignore_id,
                  np.int64 if tokens.dtype.kind in "iu" else tokens.dtype)
    cont = seg[..., 1:] == seg[..., :-1]
    # the trailing run of pad tokens in the row's final segment
    in_last = (seg == seg[..., -1:]) & (tokens == pad_id)
    trailing_pad = np.flip(np.cumprod(
        np.flip(in_last, axis=-1), axis=-1), axis=-1).astype(bool)
    lab[..., :-1] = np.where(cont & ~trailing_pad[..., 1:],
                             tokens[..., 1:], ignore_id)
    return lab
