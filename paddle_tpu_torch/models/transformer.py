"""Decoder-only transformer language model — the port of
``paddle_tpu/models/transformer.py`` (``transformer_lm``,
``transformer_layer``, ``multi_head_attention``), built from the same IR
ops in the same order, so both packages name every variable alike.

Not ported yet (each raises ``NotImplementedError``): MoE FFNs, pipeline
stages, recompute, and packed-segment masks (``segment_ids``, K5).
"""

import numpy as np

from .. import layers
from ..layer_helper import LayerHelper

__all__ = ["transformer_lm", "multi_head_attention", "transformer_layer"]


def multi_head_attention(x, num_heads, causal=True, name=None,
                         num_kv_heads=None, valid=None):
    """x: [N, T, D] → [N, T, D] self-attention via the fused_attention op.
    ``num_kv_heads`` < num_heads enables grouped-query attention (one
    fused projection split into q/k/v; the flash kernels fold each kv
    head's query group). ``valid``: optional [N, T] 0/1 padding mask,
    wired as the factored QValid/KValid inputs."""
    n, t, d = x.shape
    assert d % num_heads == 0
    head_dim = d // num_heads
    hkv = num_kv_heads or num_heads
    assert num_heads % hkv == 0

    # transpose-free head split: q/k/v stay [N, T, H, hd] ("bshd") all
    # the way into the attention op
    if hkv == num_heads:
        q = layers.fc(input=x, size=d, num_flatten_dims=2, bias_attr=True)
        k = layers.fc(input=x, size=d, num_flatten_dims=2, bias_attr=True)
        v = layers.fc(input=x, size=d, num_flatten_dims=2, bias_attr=True)
        q = layers.reshape(q, [n, t, num_heads, head_dim])
        k = layers.reshape(k, [n, t, num_heads, head_dim])
        v = layers.reshape(v, [n, t, num_heads, head_dim])
    else:
        # GQA: one fused projection of width (h + 2·hkv)·hd, split after
        fused = layers.fc(input=x, size=(num_heads + 2 * hkv) * head_dim,
                          num_flatten_dims=2, bias_attr=True)
        q, k, v = layers.split(
            fused, [d, hkv * head_dim, hkv * head_dim], dim=2)
        q = layers.reshape(q, [n, t, num_heads, head_dim])
        k = layers.reshape(k, [n, t, hkv, head_dim])
        v = layers.reshape(v, [n, t, hkv, head_dim])

    helper = LayerHelper("fused_attention", name=name)
    out = helper.create_tmp_variable(dtype=x.dtype)
    # lse residual ([b*h, s, 8] fp32, stop_gradient): stored so the grad
    # op runs the flash backward (K2) without re-running the forward
    lse = helper.create_tmp_variable(dtype="float32")
    lse.stop_gradient = True
    inputs = {"Q": [q], "K": [k], "V": [v]}
    if valid is not None:
        inputs["QValid"] = [valid]
        inputs["KValid"] = [valid]
    helper.append_op(type="fused_attention",
                     inputs=inputs,
                     outputs={"Out": [out], "Lse": [lse]},
                     attrs={"causal": causal, "layout": "bshd",
                            "scale": 1.0 / float(np.sqrt(head_dim))})
    attn = layers.reshape(out, [n, t, d])
    return layers.fc(input=attn, size=d, num_flatten_dims=2, bias_attr=True)


def transformer_layer(x, num_heads, ffn_mult=4, causal=True,
                      num_kv_heads=None, valid=None):
    """Pre-LN block: x + MHA(LN(x)); x + FFN(LN(x))."""
    n, t, d = x.shape
    ln1 = layers.layer_norm(x, begin_norm_axis=2)
    attn = multi_head_attention(ln1, num_heads, causal=causal,
                                num_kv_heads=num_kv_heads, valid=valid)
    x = layers.elementwise_add(x=x, y=attn)
    ln2 = layers.layer_norm(x, begin_norm_axis=2)
    # tanh-approximate gelu, as the reference model uses
    ffn = layers.fc(input=ln2, size=d * ffn_mult, num_flatten_dims=2,
                    act={"type": "gelu", "approximate": True})
    ffn = layers.fc(input=ffn, size=d, num_flatten_dims=2)
    return layers.elementwise_add(x=x, y=ffn)


def transformer_lm(ids, vocab_size, num_layers=4, d_model=256, num_heads=8,
                   max_len=2048, ffn_mult=4, recompute=False,
                   num_kv_heads=None, moe_experts=0,
                   moe_capacity_factor=1.25, pipeline_stages=0,
                   n_microbatches=1, valid=None, segment_ids=None):
    """ids: [N, T] int — returns logits [N, T, vocab_size]. ``valid``:
    optional [N, T] 0/1 padding mask threaded to every attention as a
    factored mask (the flash kernels and the saved-lse backward keep
    running). ``num_kv_heads`` < num_heads: grouped-query attention."""
    if recompute or moe_experts or pipeline_stages or \
            segment_ids is not None:
        raise NotImplementedError(
            "transformer_lm: recompute, moe_experts, pipeline_stages and "
            "segment_ids are not ported yet")
    n, t = ids.shape
    tok = layers.embedding(input=ids, size=[vocab_size, d_model])
    # learned positional table, sliced to the first T positions
    helper = LayerHelper("transformer_pos")
    pos_table = helper.create_parameter(None, [max_len, d_model], "float32")
    pos = layers.slice(pos_table, axes=[0], starts=[0], ends=[t])
    x = layers.elementwise_add(x=tok, y=pos, axis=1)

    for _ in range(num_layers):
        x = transformer_layer(x, num_heads, ffn_mult=ffn_mult, causal=True,
                              num_kv_heads=num_kv_heads, valid=valid)
    x = layers.layer_norm(x, begin_norm_axis=2)
    logits = layers.fc(input=x, size=vocab_size, num_flatten_dims=2)
    return logits
