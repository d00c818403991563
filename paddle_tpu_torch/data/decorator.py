"""Batching of ragged samples — the port of ``paddle_tpu/data/decorator.py``'s
``batch``, its length-pooled batcher (``default_length_key``,
``snap_length``, ``pad_waste_fraction``, ``slice_length_pool``,
``pool_batch_by_length``) and its segment packing (``pack_segments``,
``packed_next_token_labels``). Host-side Python and numpy only; each
gives the reference's batches and arrays exactly.

Length pooling: ``batch`` on unsorted ragged samples pads every batch to
nearly the global max length. Buffering ``pool_factor x batch_size``
samples, sorting the pool by length and slicing batches off it gives
near-uniform lengths per batch; snapping each batch's padded length to a
``bucket_multiple`` grid bounds the number of distinct padded shapes
(one captured step each) by the length range over the grid.

Segment packing conventions, which the segment flash kernels rely on:
segment ids are 0, 1, 2, ... in row order (never decreasing along a
row), and a row's padded tail is its last segment, with id = the number
of real segments.
"""

import random

import numpy as np

__all__ = ["batch", "default_length_key", "snap_length",
           "pad_waste_fraction", "slice_length_pool", "pool_batch_by_length",
           "pack_segments", "packed_next_token_labels"]


def batch(reader, batch_size, drop_last=False):
    """paddle.batch: a reader of lists of ``batch_size`` samples."""
    def batch_reader():
        b = []
        for instance in reader():
            b.append(instance)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b
    return batch_reader


def default_length_key(sample):
    """Length of a sample: its first sized slot (tuple rows) or itself.
    Raises TypeError when no slot has a length — sorting by tuple arity
    would make pooling a silent no-op; pass ``key=`` then."""
    if isinstance(sample, (tuple, list)):
        for slot in sample:
            try:
                return len(slot)
            except TypeError:
                continue
        raise TypeError(
            "default_length_key: no slot in the sample has a length; "
            "pass an explicit key= to the pooled/token-budget batcher")
    return len(sample)


def snap_length(n, multiple):
    """Round ``n`` up to the bucket grid (min one bucket)."""
    n = max(1, n)
    if not multiple or multiple <= 1:
        return n
    return -(-n // multiple) * multiple


def pad_waste_fraction(batches, key=None, bucket_multiple=None):
    """Fraction of padded tokens that are padding when every batch is
    padded to its snapped max length: 1 - real / (batch x snap(max_len))."""
    key = key or default_length_key
    real = padded = 0
    for b in batches:
        lens = [key(s) for s in b]
        if not lens:
            continue
        real += sum(lens)
        padded += len(lens) * snap_length(max(lens), bucket_multiple)
    return 1.0 - real / padded if padded else 0.0


def slice_length_pool(pool, batch_size, key=None, shuffle_batches=True,
                      rng=None, drop_last=False):
    """Sort ``pool`` in place by ``key``, slice ``batch_size`` batches off
    it, and return them in emission order: shuffled (``rng``, else the
    ``random`` module), with a short final slice kept out of the shuffle
    and emitted last (or dropped with ``drop_last``)."""
    key = key or default_length_key
    pool.sort(key=key)
    batches = [pool[i:i + batch_size]
               for i in range(0, len(pool), batch_size)]
    short = None
    if batches and len(batches[-1]) < batch_size:
        short = batches.pop()
        if drop_last:
            short = None
    if shuffle_batches:
        (rng or random).shuffle(batches)
    if short:
        batches.append(short)
    return batches


def pool_batch_by_length(reader, batch_size, pool_factor=None, key=None,
                         shuffle_batches=True, drop_last=False):
    """Batch a sample reader with length pooling: buffer ``pool_factor x
    batch_size`` samples, sort them by ``key``, slice batches off the
    sorted pool and emit them (shuffled within the pool unless
    ``shuffle_batches=False``). Every sample is emitted exactly once.
    ``pool_factor`` defaults to ``flags.length_pool_factor``; the padding
    happens downstream (``LoDArray.from_sequences(pad_to_multiple=)``)."""
    key = key or default_length_key
    if pool_factor is None:
        from .. import flags
        pool_factor = flags.length_pool_factor

    def pooled_reader():
        pool = []

        def drain():
            # a short slice appears only on the final drain: mid-stream
            # drains fire at exactly pool_factor x batch_size samples
            yield from slice_length_pool(pool, batch_size, key=key,
                                         shuffle_batches=shuffle_batches,
                                         drop_last=drop_last)
            pool.clear()

        for sample in reader():
            pool.append(sample)
            if len(pool) >= pool_factor * batch_size:
                yield from drain()
        if pool:
            yield from drain()
    return pooled_reader


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
