"""IR-level autodiff: walk ops in reverse, emit ``<type>_grad`` ops — the
port of ``paddle_tpu/backward.py``'s ``append_backward`` (the loss seed
is a ``fill_constant`` op, fan-out grads are summed by a ``sum`` op).
All differentiation happens on the Program before execution; there is
no tape. An op without its own grad lowering gets the generic one,
``torch.func.vjp`` of its forward lowering
(``registry.make_generic_grad_lowering``).
"""

from .framework import Variable
from .registry import ensure_grad_op_registered, get_op_info, grad_var_name

__all__ = ["append_backward"]

_FLOAT_DTYPES = ("float16", "bfloat16", "float32", "float64")


def _wants_grad(var, no_grad_set):
    if var is None or var.name in no_grad_set:
        return False
    if var.stop_gradient:
        return False
    if var.dtype is not None and var.dtype not in _FLOAT_DTYPES:
        return False
    return True


def _create_grad_var(block, fwd_var, name=None):
    name = name or grad_var_name(fwd_var.name)
    if block.has_var_local(name):
        return block.vars[name]
    return block.create_var(
        name=name, shape=fwd_var.shape, dtype=fwd_var.dtype,
        lod_level=fwd_var.lod_level, type=fwd_var.type, stop_gradient=True)


def _make_grad_op_desc(op, have_grad, no_grad_set, block):
    """Build the description of ``<op.type>_grad`` for forward ``op``.
    Returns (desc dict, grad-output var names) or None if nothing to do."""
    info = get_op_info(op.type)
    if info.no_grad:
        return None

    # outputs of the forward op that have incoming grads
    out_grad_inputs = {}
    any_out_grad = False
    for slot, names in op.outputs.items():
        gnames = []
        for n in names:
            if n in have_grad:
                gnames.append(grad_var_name(n))
                any_out_grad = True
            else:
                gnames.append("")  # keep index alignment with forward outputs
        if any(gnames):
            out_grad_inputs[grad_var_name(slot)] = gnames
    if not any_out_grad:
        return None

    # forward inputs needing grads
    grad_outputs = {}
    for slot, names in op.inputs.items():
        gnames = []
        need_any = False
        for n in names:
            v = block._find_var_recursive(n)
            if _wants_grad(v, no_grad_set):
                gnames.append(grad_var_name(n))
                need_any = True
            else:
                gnames.append("")
        if need_any:
            grad_outputs[grad_var_name(slot)] = gnames
    if not grad_outputs:
        return None

    gtype = ensure_grad_op_registered(op.type)
    inputs = {}
    for slot, names in op.inputs.items():
        inputs[slot] = list(names)
    for slot, names in op.outputs.items():
        inputs[slot] = list(names)
    inputs.update(out_grad_inputs)
    attrs = dict(op.attrs)
    attrs["__fwd_input_slots__"] = list(op.inputs)
    attrs["__fwd_output_slots__"] = list(op.outputs)
    attrs["__fwd_op_uid__"] = op.op_uid
    return {"type": gtype, "inputs": inputs, "outputs": grad_outputs,
            "attrs": attrs, "forward_op": op}


def _dedup_grad_outputs(grad_descs):
    """Reference _addup_repetitive_outputs_ (backward.py:117): when several
    grad ops produce the same X@GRAD (fan-out in forward), rename each
    contribution and insert a sum op after the last one."""
    counts = {}
    for desc in grad_descs:
        for slot, names in desc["outputs"].items():
            for n in names:
                if n:
                    counts[n] = counts.get(n, 0) + 1
    dup = {n for n, c in counts.items() if c > 1}
    if not dup:
        return grad_descs

    seen = {}
    out = []
    last_producer = {}
    for i, desc in enumerate(grad_descs):
        for slot, names in desc["outputs"].items():
            for j, n in enumerate(names):
                if n in dup:
                    k = seen.get(n, 0)
                    seen[n] = k + 1
                    names[j] = "%s@RENAME@%d" % (n, k)
                    last_producer[n] = i
        out.append(desc)

    result = []
    for i, desc in enumerate(out):
        result.append(desc)
        for n, last in last_producer.items():
            if last == i:
                renames = ["%s@RENAME@%d" % (n, k) for k in range(seen[n])]
                result.append({"type": "sum", "inputs": {"X": renames},
                               "outputs": {"Out": [n]}, "attrs": {},
                               "forward_op": None})
    return result


def _append_backward_ops(block, loss_name, no_grad_set):
    """Emit grad ops for ``block`` in reverse order; returns the set of
    var names that received grads."""
    have_grad = {loss_name}
    grad_descs = []
    for op in reversed(block.ops):
        if not any(n in have_grad for n in op.all_output_vars()):
            continue
        desc = _make_grad_op_desc(op, have_grad, no_grad_set, block)
        if desc is None:
            continue
        descs = desc if isinstance(desc, list) else [desc]
        for d in descs:
            for slot, names in d["outputs"].items():
                for n in names:
                    if n:
                        base = n[: -len("@GRAD")] if n.endswith("@GRAD") else n
                        have_grad.add(base)
        grad_descs.extend(descs)

    grad_descs = _dedup_grad_outputs(grad_descs)

    # materialize: create grad vars + append ops
    for d in grad_descs:
        for slot, names in d["outputs"].items():
            for n in names:
                if not n:
                    continue
                base = n.split("@GRAD")[0]
                fwd = block._find_var_recursive(base)
                if fwd is not None:
                    _create_grad_var(block, fwd, name=n)
                else:
                    block.create_var(name=n, stop_gradient=True)
        # infer_shape=False: every t@GRAD output's shape was just
        # mirrored from its forward var by _create_grad_var
        op = block.append_op(type=d["type"], inputs=d["inputs"],
                             outputs=d["outputs"], attrs=d["attrs"],
                             infer_shape=False)
        op.forward_op = d.get("forward_op")
    return have_grad


def append_backward(loss, parameter_list=None, no_grad_set=None):
    """Append grad ops computing d(loss)/d(params)
    (reference backward.py:425). Returns [(param, grad_var)]."""
    assert isinstance(loss, Variable)
    program = loss.block.program
    block = program.global_block()
    no_grad_set = set(no_grad_set or [])
    for v in block.vars.values():
        if v.stop_gradient:
            no_grad_set.add(v.name)

    # d(loss)/d(loss) = 1 (loss_grad's shape mirrors the loss var)
    loss_grad = _create_grad_var(block, loss)
    block.append_op(
        type="fill_constant",
        outputs={"Out": [loss_grad.name]},
        attrs={"shape": [d if d > 0 else 1 for d in (loss.shape or [1])],
               "value": 1.0, "dtype": loss.dtype or "float32"},
        infer_shape=False)

    _append_backward_ops(block, loss.name, no_grad_set)

    if parameter_list is not None:
        params = [block.var(p) if isinstance(p, str) else p
                  for p in parameter_list]
    else:
        params = [p for p in block.all_parameters() if p.trainable]

    params_and_grads = []
    for p in params:
        gname = grad_var_name(p.name)
        if block.has_var_local(gname):
            params_and_grads.append((p, block.vars[gname]))
    return params_and_grads
