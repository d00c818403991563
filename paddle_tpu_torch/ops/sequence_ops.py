"""Sequence ops over ragged values (``core.LoDArray``: padded data and
lengths) — the port of ``paddle_tpu/ops/sequence_ops.py``'s
``sequence_pool`` (SUM, AVERAGE, SQRT, MAX with MaxIndex, FIRST, LAST)
and ``lstm``, the full recurrence of ``dynamic_lstm``. Plain PyTorch:
the reference runs the recurrence as a ``lax.scan`` and no TPU kernel
computes either op. The other sequence ops (GRU, ``lstmp``, the
expand/softmax/conv family, beam search) are not ported yet.

Nothing here reads the lengths on the host: the padded length is the
data's shape, and the masks, the reverse flip and the LAST gather are
device ops, so a captured step replays them with new lengths.
"""

import torch

from ..core import LoDArray
from ..framework import in_var, set_out
from ..registry import output_consumed, register_op
from .math_ops import _matmul_f32_acc


def _as_lod(x):
    """A ragged value; a dense ``[B, L, ...]`` one as full-length
    sequences."""
    if isinstance(x, LoDArray):
        return x
    return LoDArray(x, torch.full((x.shape[0],), x.shape[1],
                                  dtype=torch.int32, device=x.device))


def _pool_reduce(ptype, data, mask, lengths, axis):
    """One pooltype over the ragged ``axis`` of ``data``. ``mask`` is the
    validity mask broadcastable to ``data``, ``lengths`` the raw lengths
    (shape ``data.shape[:axis]``). Returns (out, MaxIndex or None)."""
    feat_dims = data.dim() - axis - 1
    lens = torch.clamp(lengths.to(data.dtype), min=1)
    lens = lens.reshape(tuple(lengths.shape) + (1,) * feat_dims)
    idx = None
    if ptype == "SUM":
        out = torch.sum(data * mask, dim=axis)
    elif ptype == "AVERAGE":
        out = torch.sum(data * mask, dim=axis) / lens
    elif ptype == "SQRT":
        out = torch.sum(data * mask, dim=axis) / torch.sqrt(lens)
    elif ptype == "MAX":
        neg = torch.where(mask > 0, data, float("-inf"))
        # amax: a tie shares the grad, as the reference's max does
        out = torch.amax(neg, dim=axis)
        idx = torch.argmax(neg, dim=axis).to(torch.int32)
        raw = lengths.reshape(tuple(lengths.shape) + (1,) * feat_dims)
        out = torch.where(raw > 0, out, 0.0)    # an empty sequence: 0
    elif ptype == "FIRST":
        out = data.select(axis, 0)
    elif ptype == "LAST":
        last = torch.clamp(lengths.long() - 1, min=0)
        last = last.reshape(tuple(lengths.shape) + (1,) * (feat_dims + 1))
        shape = list(data.shape)
        shape[axis] = 1
        out = torch.gather(data, axis, last.expand(shape)).squeeze(axis)
    else:
        raise ValueError("unknown pooltype %r" % ptype)
    return out, idx


def _sequence_pool_rule(block, op):
    x = in_var(block, op, "X")
    feat = list(x.shape[1:]) if x.lod_level else list(x.shape[2:])
    set_out(block, op, "Out", [-1] + feat, dtype=x.dtype)
    if op.attr("pooltype", "AVERAGE").upper() == "MAX":
        set_out(block, op, "MaxIndex", [-1] + feat, dtype="int32")


@register_op("sequence_pool", infer_shape=_sequence_pool_rule,
             ragged=True)
def _sequence_pool(ctx, ins):
    """Each sequence pooled to one row: a dense ``[B, *feat]``."""
    ptype = ctx.attr("pooltype", "AVERAGE").upper()
    x = _as_lod(ins["X"][0])
    data, mask = x.data, x.mask(x.data.dtype)
    mask = mask.reshape(tuple(mask.shape) + (1,) * (data.dim() - 2))
    out, idx = _pool_reduce(ptype, data, mask, x.length, axis=1)
    res = {"Out": [out]}
    if idx is not None:
        res["MaxIndex"] = [idx]
    return res


# -- the LSTM recurrence ------------------------------------------------------

_ACTS = {"sigmoid": torch.sigmoid, "tanh": torch.tanh, "relu": torch.relu,
         "identity": lambda x: x}


def _lstm_step(h, c, gates4h, w_h, use_peepholes, peep, act_gate, act_cell,
               act_cand):
    """One step: the recurrent product in the promoted dtype of ``h`` and
    ``w_h`` (JAX's ``matmul`` promotes a bf16 x fp32 pair to fp32, and so
    does this) added in the gates' dtype; gate order i, f, c, o."""
    dt = torch.promote_types(h.dtype, w_h.dtype)
    g = gates4h + _matmul_f32_acc(h.to(dt), w_h.to(dt)).to(gates4h.dtype)
    gi, gf, gc, go = torch.chunk(g, 4, dim=-1)
    if use_peepholes:
        wic, wfc, woc = peep
        gi = gi + wic * c
        gf = gf + wfc * c
    i = act_gate(gi)
    f = act_gate(gf)
    cand = act_cand(gc)
    c_new = f * c + i * cand
    if use_peepholes:
        go = go + woc * c_new
    o = act_gate(go)
    h_new = o * act_cell(c_new)
    return h_new, c_new


def _reverse_index(length, t):
    """[b, t] positions that read each sequence's valid tokens back to
    front (the padding clipped to 0, masked later)."""
    pos = torch.arange(t, device=length.device)
    return torch.clamp(length.long()[:, None] - 1 - pos[None, :], 0, t - 1)


def _take_time(x, idx):
    """``x[b, idx[b, s], ...]``: ``take_along_axis`` on the time axis."""
    idx = idx.reshape(tuple(idx.shape) + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(tuple(idx.shape[:2]) +
                                         tuple(x.shape[2:])))


def _lstm_rule(block, op):
    w, x = in_var(block, op, "Weight"), in_var(block, op, "Input")
    h = w.shape[0]
    for slot, width in (("Hidden", h), ("Cell", h), ("BatchGate", 4 * h),
                        ("BatchCellPreAct", h)):
        set_out(block, op, slot, [-1, width], dtype=x.dtype, lod_level=1)


@register_op("lstm", infer_shape=_lstm_rule, ragged=True)
def _lstm(ctx, ins):
    """The full LSTM recurrence (reference lstm_op.cc). Input ``[b, t,
    4h]`` (projected by the fc before it), Weight ``[h, 4h]``, Bias
    ``[1, 4h]`` (``[1, 7h]`` with the peepholes ``W_ic, W_fc, W_oc``
    after the gate biases), optional H0 / C0 ``[b, h]``.

    Each step's new state is kept only where the step is inside the
    sequence (a masked carry); ``is_reverse`` runs each sequence from its
    last valid token by flipping inside its window, and flips the
    outputs back. The steps are collected in lists and stacked once,
    with no in-place write, so ``torch.func.vjp`` (the generic grad)
    differentiates the loop as written. Cell is stacked only when an op
    reads it or it is fetched."""
    x = _as_lod(ins["Input"][0])
    w = ins["Weight"][0]
    bias = (ins.get("Bias") or [None])[0]
    use_peep = ctx.attr("use_peepholes", False)
    is_rev = ctx.attr("is_reverse", False)
    act_gate = _ACTS[ctx.attr("gate_activation", "sigmoid")]
    act_cell = _ACTS[ctx.attr("cell_activation", "tanh")]
    act_cand = _ACTS[ctx.attr("candidate_activation", "tanh")]
    b, t, fourh = x.data.shape
    h_dim = fourh // 4
    data = x.data
    peep = None
    if bias is not None:
        main = bias[..., :fourh] if use_peep else bias
        if use_peep:
            peep = torch.chunk(bias[..., fourh:].reshape(-1), 3)
        # a bf16 input plus the fp32 bias is fp32, as in JAX: under amp
        # the recurrence runs in fp32
        data = data + main.reshape(1, 1, fourh)
    mask = x.mask(data.dtype)
    h0 = (ins.get("H0") or [None])[0]
    c0 = (ins.get("C0") or [None])[0]
    h = torch.zeros((b, h_dim), dtype=data.dtype, device=data.device) \
        if h0 is None else h0.to(data.dtype)
    c = torch.zeros((b, h_dim), dtype=data.dtype, device=data.device) \
        if c0 is None else c0.to(data.dtype)
    xs = _take_time(data, _reverse_index(x.length, t)) if is_rev else data

    cell_used = output_consumed(
        ctx, ctx.op.outputs.get("Cell", [""])[0]) or output_consumed(
        ctx, ctx.op.outputs.get("BatchCellPreAct", [""])[0])
    hs, cs = [], []
    for s in range(t):
        h_new, c_new = _lstm_step(h, c, xs[:, s], w, use_peep, peep,
                                  act_gate, act_cell, act_cand)
        m1 = mask[:, s, None]
        h = m1 * h_new + (1 - m1) * h
        c = m1 * c_new + (1 - m1) * c
        hs.append(h)
        if cell_used:
            cs.append(c)
    hidden = torch.stack(hs, dim=1)
    cell = torch.stack(cs, dim=1) if cell_used else None
    if is_rev:
        idx = _reverse_index(x.length, t)
        hidden = _take_time(hidden, idx)
        if cell is not None:
            cell = _take_time(cell, idx)
    hidden = hidden * mask[..., None]
    out_cell = None
    if cell is not None:
        out_cell = LoDArray(cell * mask[..., None], x.length)
    return {"Hidden": [LoDArray(hidden, x.length)],
            "Cell": [out_cell],
            "BatchGate": [LoDArray(data, x.length)],
            "BatchCellPreAct": [out_cell]}
