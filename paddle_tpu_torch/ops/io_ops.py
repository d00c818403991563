"""IO ops: ``save``, ``load``, ``save_combine`` and ``load_combine`` — the
port of ``paddle_tpu/ops/io_ops.py``'s host ops and its npz schema.

Save/load are host ops (``OpInfo.host``: the executor runs such programs
through ``run``, and ``run_steps`` refuses them). A tensor serializes to
an ``.npz`` archive with one ``data`` key (``save``: one extensionless
file per var) or ``<var>::data`` keys (``save_combine``: one archive) —
the reference's files, which either package reads.

bfloat16: numpy has no bfloat16, so the port widens it to float32 on
write (exact) and reads the reference's bfloat16 records (2-byte void
arrays) back as float32 too (``convert.array_to_tensor``).
"""

import os

import numpy as np
import torch

from ..convert import array_to_tensor
from ..registry import register_op

__all__ = ["to_np", "from_np", "savez_exact"]


def to_np(v):
    """Tensor value → the npz schema (``{"data": array}``) — THE
    checkpoint file format; ``robustness.checkpoint`` writes it too."""
    if isinstance(v, torch.Tensor):
        t = v.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return {"data": t.cpu().numpy()}
    return {"data": np.asarray(v)}


def from_np(d, device="cpu"):
    """The npz schema → a tensor on ``device``."""
    if "length" in d:
        raise NotImplementedError(
            "ragged (LoD) checkpoint values are not ported yet")
    return array_to_tensor(d["data"], device=device)


def savez_exact(path, arrays):
    """np.savez to EXACTLY ``path`` (numpy appends .npz; checkpoint
    files are named after their var, extensionless)."""
    np.savez(path, **arrays)
    if not path.endswith(".npz"):
        os.replace(path + ".npz", path)


@register_op("save", no_grad=True, host=True)
def _save(ctx, ins):
    path = ctx.attr("file_path")
    if os.path.exists(path) and not ctx.attr("overwrite", True):
        raise RuntimeError("%r exists and overwrite is False" % path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    savez_exact(path, to_np(ins["X"][0]))
    return None


@register_op("load", no_grad=True, host=True)
def _load(ctx, ins):
    with np.load(ctx.attr("file_path"), allow_pickle=False) as f:
        return {"Out": [from_np(dict(f), ctx.device)]}


@register_op("save_combine", no_grad=True, host=True)
def _save_combine(ctx, ins):
    path = ctx.attr("file_path")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {}
    for name, v in zip(ctx.op.input("X"), ins["X"]):
        for k, arr in to_np(v).items():
            arrays["%s::%s" % (name, k)] = arr
    savez_exact(path, arrays)
    return None


@register_op("load_combine", no_grad=True, host=True)
def _load_combine(ctx, ins):
    with np.load(ctx.attr("file_path"), allow_pickle=False) as f:
        stash = {}
        for k in f.files:
            name, field = k.rsplit("::", 1)
            stash.setdefault(name, {})[field] = f[k]
    return {"Out": [from_np(stash[n], ctx.device)
                    for n in ctx.op.output("Out")]}
