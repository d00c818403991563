"""Analytic FLOP estimation over a Program, for MFU reporting — a trimmed
copy of ``paddle_tpu/flops.py``: the matmul-class FLOPs of each op from
its inferred shapes (elementwise and normalization ops are not counted:
MFU counts model FLOPs), and the card's published dense bf16 peak.
"""

__all__ = ["estimate_program_flops", "device_peak_flops"]


def _prod(xs):
    n = 1
    for x in xs:
        n *= x
    return n


def _resolve(shape, batch):
    return [batch if d == -1 else d for d in shape]


def _op_flops(block, op, batch):
    """Forward FLOPs of one op (2 FLOPs per multiply-add)."""
    t = op.type
    if t in ("conv2d", "conv3d", "depthwise_conv2d", "conv2d_transpose",
             "conv3d_transpose"):
        w = block.var(op.input("Filter")[0])
        if t.endswith("transpose"):
            # gradient-of-conv view: every input element is multiplied
            # into out_c/groups * prod(kernel) outputs
            x = block.var(op.input("Input")[0])
            in_shape = _resolve(x.shape, batch)
            return 2 * _prod(in_shape) * w.shape[1] * _prod(w.shape[2:])
        out = block.var(op.output("Output")[0])
        # per output element: 2 * (in_c/groups) * prod(kernel)
        return _prod(_resolve(out.shape, batch)) * 2 * w.shape[1] * \
            _prod(w.shape[2:])
    if t == "mul":
        x = block.var(op.input("X")[0])
        y = block.var(op.input("Y")[0])
        xn = op.attr("x_num_col_dims", 1)
        yn = op.attr("y_num_col_dims", 1)
        m = _prod(_resolve(x.shape[:xn], batch))
        return 2 * m * _prod(x.shape[xn:]) * _prod(y.shape[yn:])
    if t == "fused_attention":
        # q·kᵀ and p·v: 2 · 2·b·h·s_q·s_k·d, halved when causal
        q = block.var(op.input("Q")[0])
        kk = block.var(op.input("K")[0])
        qs = _resolve(list(q.shape), batch)
        ks = _resolve(list(kk.shape), batch)
        if op.attr("layout", "bhsd") == "bshd":
            b, s_q, h, d = qs
            s_k = ks[1]
        else:
            b, h, s_q, d = qs
            s_k = ks[2]
        total = 2 * 2 * b * h * s_q * s_k * d
        return total // 2 if op.attr("causal", False) else total
    if t == "matmul":
        x = block.var(op.input("X")[0])
        y = block.var(op.input("Y")[0])
        xs = _resolve(list(x.shape), batch)
        ys = _resolve(list(y.shape), batch)
        if op.attr("transpose_X", False):
            xs[-2], xs[-1] = xs[-1], xs[-2]
        if op.attr("transpose_Y", False):
            ys[-2], ys[-1] = ys[-1], ys[-2]
        batch_dims = _prod(xs[:-2]) if len(xs) > 2 else _prod(ys[:-2])
        return 2 * max(batch_dims, 1) * xs[-2] * xs[-1] * ys[-1]
    return 0


def estimate_program_flops(program, batch_size, training=True):
    """Matmul-class FLOPs of one execution of ``program`` at
    ``batch_size``. ``training=True`` triples the forward ops' FLOPs (each
    GEMM/conv has two backward GEMMs of its size); grad ops in the
    program are skipped so nothing is counted twice."""
    total = 0
    for block in program.blocks:
        for op in block.ops:
            if op.type.endswith("_grad"):
                continue
            try:
                total += _op_flops(block, op, batch_size)
            except Exception:
                continue  # missing shape info: undercount, never crash
    return total * (3 if training else 1)


# Published dense (not 2:4 sparse) bf16 tensor-core peaks, FLOP/s, by a
# substring of ``torch.cuda.get_device_name()``; the first match wins.
_PEAK_BY_NAME = [
    ("H100 PCIe", 756e12),
    ("H100 NVL", 835e12),
    ("H100", 989.4e12),          # SXM5 ("NVIDIA H100 80GB HBM3")
    ("A100", 312e12),
]


def device_peak_flops(device=None):
    """The dense bf16 peak FLOP/s of CUDA device ``device`` (default: the
    current one), or None off the card or for a card not in the table —
    it never guesses."""
    import torch
    if not torch.cuda.is_available():
        return None
    name = torch.cuda.get_device_name(device)
    for tag, peak in _PEAK_BY_NAME:
        if tag in name:
            return peak
    return None
