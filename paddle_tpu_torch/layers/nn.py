"""Neural-network layers of the training slices: copies of
``paddle_tpu/layers/nn.py``'s ``fc``, ``embedding``, ``conv2d``,
``pool2d``, ``batch_norm``, ``layer_norm``, ``cross_entropy``,
``softmax_with_cross_entropy``, ``reshape``, ``transpose``, ``split``,
``mean``, ``slice``, ``dropout``, ``decode_cache_attention``,
``dynamic_lstm`` and ``sequence_pool`` (with ``sequence_first_step`` /
``sequence_last_step``), and of ``layers/ops.py``'s ``elementwise_add``,
``scale`` and the generated ``relu`` and ``gelu``.
``fc``, ``embedding`` and the activations take ragged inputs and give
ragged outputs.
Each appends ops to the current Program; the executor runs them.
"""

import os

import numpy as np

from ..initializer import ConstantInitializer, NormalInitializer
from ..layer_helper import LayerHelper

__all__ = ["fc", "embedding", "conv2d", "pool2d", "batch_norm",
           "layer_norm", "dropout", "cross_entropy",
           "softmax_with_cross_entropy",
           "reshape", "transpose", "split", "mean", "slice",
           "elementwise_add", "relu", "gelu", "scale",
           "decode_cache_attention", "dynamic_lstm",
           "sequence_pool", "sequence_first_step", "sequence_last_step"]


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       use_mkldnn=False, act=None, is_test=False, name=None):
    """Fully-connected layer (reference nn.py:85): Out = act(Σ_i X_i W_i + b).
    Lowers to MXU matmuls via the ``mul`` op."""
    helper = LayerHelper("fc", **locals())
    dtype = helper.input_dtype()
    mul_results = []
    for input_var, param_attr_ in zip(helper.input(),
                                      helper.multiple_param_attr(
                                          len(helper.input()))):
        shape = input_var.shape
        in_features = int(np.prod([abs(d) for d in shape[num_flatten_dims:]]))
        w = helper.create_parameter(param_attr_, [in_features, size], dtype)
        tmp = helper.create_tmp_variable(dtype=dtype,
                                         lod_level=input_var.lod_level)
        helper.append_op(type="mul", inputs={"X": [input_var], "Y": [w]},
                         outputs={"Out": [tmp]},
                         attrs={"x_num_col_dims": num_flatten_dims,
                                "y_num_col_dims": 1})
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_tmp_variable(
            dtype=dtype, lod_level=max(v.lod_level for v in mul_results))
        helper.append_op(type="sum", inputs={"X": mul_results},
                         outputs={"Out": [pre_bias]})
    pre_act = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    """Embedding lookup (reference nn.py:225 / lookup_table_op.cc).
    is_sparse → SelectedRows gradient; is_distributed → table sharded over
    the mesh by the distribute transpiler."""
    helper = LayerHelper("embedding", **locals())
    w = helper.create_parameter(helper.param_attr, size, dtype)
    out = helper.create_tmp_variable(dtype=dtype, lod_level=input.lod_level)
    padding_idx = -1 if padding_idx is None else \
        padding_idx if padding_idx >= 0 else (size[0] + padding_idx)
    helper.append_op(type="lookup_table",
                     inputs={"Ids": [input], "W": [w]},
                     outputs={"Out": [out]},
                     attrs={"is_sparse": is_sparse,
                            "is_distributed": is_distributed,
                            "padding_idx": padding_idx})
    return out


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           use_mkldnn=False, act=None, name=None, data_format="NCHW"):
    """2-D convolution (reference nn.py:302). ``data_format='NHWC'`` runs
    channels-last; the filter stays OIHW either way, initialized from
    Normal(0, sqrt(2 / (kh·kw·c_in))). Under
    ``PADDLE_TPU_FP8_CONV_OUT=delayed`` at build time the conv carries its
    delayed fp8 scale: a persistable ``[1]`` fp32 global var (initialized
    to 0.0, the "unseeded" value; ``stop_gradient``) threaded in as
    ``Fp8Scale`` and out as ``Fp8ScaleOut``, as batch norm threads its
    moving statistics."""
    helper = LayerHelper("conv2d", **locals())
    dtype = helper.input_dtype()
    num_channels = input.shape[-1] if data_format == "NHWC" \
        else input.shape[1]
    groups = groups or 1
    if isinstance(filter_size, int):
        filter_size = [filter_size, filter_size]
    stride = [stride, stride] if isinstance(stride, int) else list(stride)
    padding = [padding, padding] if isinstance(padding, int) \
        else list(padding)
    dilation = [dilation, dilation] if isinstance(dilation, int) \
        else list(dilation)
    filter_shape = [num_filters, num_channels // groups] + list(filter_size)
    std = (2.0 / (filter_size[0] * filter_size[1] * num_channels)) ** 0.5
    filter_param = helper.create_parameter(
        helper.param_attr, filter_shape, dtype,
        default_initializer=NormalInitializer(0.0, std))
    pre_bias = helper.create_tmp_variable(dtype=dtype)
    conv_inputs = {"Input": [input], "Filter": [filter_param]}
    conv_outputs = {"Output": [pre_bias]}
    if os.environ.get("PADDLE_TPU_FP8_CONV_OUT") == "delayed":
        fp8_scale = helper.create_global_variable(
            persistable=True, dtype="float32", shape=[1])
        fp8_scale.stop_gradient = True
        helper.set_variable_initializer(fp8_scale, ConstantInitializer(0.0))
        conv_inputs["Fp8Scale"] = [fp8_scale]
        conv_outputs["Fp8ScaleOut"] = [fp8_scale]
    helper.append_op(type="conv2d",
                     inputs=conv_inputs,
                     outputs=conv_outputs,
                     attrs={"strides": stride, "paddings": padding,
                            "dilations": dilation, "groups": groups,
                            "data_format": data_format})
    if data_format == "NHWC":
        pre_act = helper.append_bias_op(pre_bias, dim_start=3, dim_end=4)
    else:
        pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, use_mkldnn=False, name=None,
           data_format="NCHW"):
    """Max or average pooling (reference nn.py:474)."""
    helper = LayerHelper("pool2d", **locals())
    if isinstance(pool_size, int):
        pool_size = [pool_size, pool_size]
    if isinstance(pool_stride, int):
        pool_stride = [pool_stride, pool_stride]
    if isinstance(pool_padding, int):
        pool_padding = [pool_padding, pool_padding]
    out = helper.create_tmp_variable(dtype=helper.input_dtype())
    helper.append_op(type="pool2d", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"pooling_type": pool_type, "ksize": pool_size,
                            "global_pooling": global_pooling,
                            "strides": pool_stride, "paddings": pool_padding,
                            "ceil_mode": ceil_mode,
                            "data_format": data_format})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, use_mkldnn=False, name=None,
               moving_mean_name=None, moving_variance_name=None):
    """Batch normalization (reference nn.py:516): Scale 1, Bias 0, and the
    moving mean (0) and variance (1) as persistable state that the op
    reads as Mean/Variance and writes back as MeanOut/VarianceOut."""
    helper = LayerHelper("batch_norm", **locals())
    dtype = helper.input_dtype()
    channel_num = input.shape[1] if data_layout == "NCHW" \
        else input.shape[-1]
    param_shape = [channel_num]
    scale = helper.create_parameter(
        helper.param_attr, param_shape, dtype,
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(helper.bias_attr, param_shape, dtype,
                                   is_bias=True)
    mean = helper.create_global_variable(
        persistable=True, dtype=dtype, shape=param_shape)
    if moving_mean_name:
        mean = helper.main_program.global_block().create_var(
            name=moving_mean_name, dtype=dtype, shape=param_shape,
            persistable=True)
    helper.set_variable_initializer(mean, ConstantInitializer(0.0))
    variance = helper.create_global_variable(
        persistable=True, dtype=dtype, shape=param_shape)
    if moving_variance_name:
        variance = helper.main_program.global_block().create_var(
            name=moving_variance_name, dtype=dtype, shape=param_shape,
            persistable=True)
    helper.set_variable_initializer(variance, ConstantInitializer(1.0))
    saved_mean = helper.create_tmp_variable(dtype=dtype, stop_gradient=True)
    saved_variance = helper.create_tmp_variable(dtype=dtype,
                                                stop_gradient=True)
    batch_norm_out = input if in_place else \
        helper.create_tmp_variable(dtype=dtype)
    helper.append_op(type="batch_norm",
                     inputs={"X": [input], "Scale": [scale], "Bias": [bias],
                             "Mean": [mean], "Variance": [variance]},
                     outputs={"Y": [batch_norm_out], "MeanOut": [mean],
                              "VarianceOut": [variance],
                              "SavedMean": [saved_mean],
                              "SavedVariance": [saved_variance]},
                     attrs={"momentum": momentum, "epsilon": epsilon,
                            "is_test": is_test, "data_layout": data_layout})
    return helper.append_activation(batch_norm_out)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", **locals())
    dtype = helper.input_dtype()
    param_shape = [int(np.prod([abs(d) for d in
                                input.shape[begin_norm_axis:]]))]
    inputs = {"X": [input]}
    if scale:
        s = helper.create_parameter(
            helper.param_attr, param_shape, dtype,
            default_initializer=ConstantInitializer(1.0))
        inputs["Scale"] = [s]
    if shift:
        b = helper.create_parameter(helper.bias_attr, param_shape, dtype,
                                    is_bias=True)
        inputs["Bias"] = [b]
    mean_out = helper.create_tmp_variable(dtype=dtype, stop_gradient=True)
    variance_out = helper.create_tmp_variable(dtype=dtype, stop_gradient=True)
    layer_norm_out = helper.create_tmp_variable(dtype=dtype)
    helper.append_op(type="layer_norm", inputs=inputs,
                     outputs={"Y": [layer_norm_out], "Mean": [mean_out],
                              "Variance": [variance_out]},
                     attrs={"epsilon": epsilon,
                            "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(layer_norm_out)


def dropout(x, dropout_prob, is_test=False, seed=None, name=None):
    """Dropout (reference nn.py:589), "downgrade_in_infer": training
    multiplies by a 0/1 mask (no rescale), test by 1 - dropout_prob."""
    helper = LayerHelper("dropout", **locals())
    out = helper.create_tmp_variable(dtype=x.dtype, lod_level=x.lod_level)
    mask = helper.create_tmp_variable(dtype=x.dtype, stop_gradient=True)
    helper.append_op(type="dropout", inputs={"X": [x]},
                     outputs={"Out": [out], "Mask": [mask]},
                     attrs={"dropout_prob": dropout_prob, "is_test": is_test,
                            "seed": seed if seed is not None else 0})
    return out


def cross_entropy(input, label, soft_label=False):
    helper = LayerHelper("cross_entropy", **locals())
    out = helper.create_tmp_variable(dtype=input.dtype,
                                     lod_level=input.lod_level)
    helper.append_op(type="cross_entropy",
                     inputs={"X": [input], "Label": [label]},
                     outputs={"Y": [out]}, attrs={"soft_label": soft_label})
    return out


def softmax_with_cross_entropy(logits, label, soft_label=False):
    helper = LayerHelper("softmax_with_cross_entropy", **locals())
    softmax_out = helper.create_tmp_variable(dtype=logits.dtype)
    loss = helper.create_tmp_variable(dtype=logits.dtype)
    helper.append_op(type="softmax_with_cross_entropy",
                     inputs={"Logits": [logits], "Label": [label]},
                     outputs={"Softmax": [softmax_out], "Loss": [loss]},
                     attrs={"soft_label": soft_label})
    return loss


def reshape(x, shape, actual_shape=None, act=None, inplace=True, name=None):
    helper = LayerHelper("reshape", **locals())
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="reshape", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"shape": list(shape)})
    return helper.append_activation(out)


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose", **locals())
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="transpose", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": list(perm)})
    return out


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", **locals())
    input_shape = input.shape
    dim = (len(input_shape) + dim) if dim < 0 else dim
    if isinstance(num_or_sections, int):
        num = num_or_sections
        attrs = {"num": num_or_sections, "axis": dim}
    else:
        num = len(num_or_sections)
        attrs = {"sections": list(num_or_sections), "axis": dim}
    outs = [helper.create_tmp_variable(dtype=input.dtype)
            for _ in range(num)]
    helper.append_op(type="split", inputs={"X": [input]},
                     outputs={"Out": outs}, attrs=attrs)
    return outs


def mean(x, name=None):
    helper = LayerHelper("mean", name=name)
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="mean", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def slice(input, axes, starts, ends):
    helper = LayerHelper("slice", **locals())
    out = helper.create_tmp_variable(dtype=input.dtype)
    helper.append_op(type="slice", inputs={"Input": [input]},
                     outputs={"Out": [out]},
                     attrs={"axes": list(axes), "starts": list(starts),
                            "ends": list(ends)})
    return out


def elementwise_add(x, y, axis=-1, act=None, name=None):
    helper = LayerHelper("elementwise_add", name=name, act=act)
    out = helper.create_tmp_variable(dtype=x.dtype, lod_level=x.lod_level)
    helper.append_op(type="elementwise_add", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return helper.append_activation(out)


def _unary_layer(op_type):
    """The reference's generated X -> Out layer (``layers/ops.py``): the
    output keeps X's lod level; extra keywords are the op's attrs."""
    def layer(x=None, name=None, **attrs):
        if x is None:
            x = attrs.pop("input")
        helper = LayerHelper(op_type, name=name)
        out = helper.create_tmp_variable(dtype=x.dtype, lod_level=x.lod_level)
        helper.append_op(type=op_type, inputs={"X": [x]},
                         outputs={"Out": [out]}, attrs=attrs)
        return out
    layer.__name__ = op_type
    return layer


relu = _unary_layer("relu")
gelu = _unary_layer("gelu")


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    """Out = X·scale + bias (or (X + bias)·scale); X's lod level kept."""
    helper = LayerHelper("scale", name=name, act=act)
    out = helper.create_tmp_variable(dtype=x.dtype, lod_level=x.lod_level)
    helper.append_op(type="scale", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"scale": float(scale), "bias": float(bias),
                            "bias_after_scale": bias_after_scale})
    return helper.append_activation(out)


def decode_cache_attention(q, k_cache, v_cache, cache_lengths, scale=None,
                           name=None):
    """Incremental-decoding attention (inference only): one query token
    per slot against a per-slot KV cache, masked by live per-slot
    lengths. ``q`` [slots, heads, head_dim]; ``k_cache`` / ``v_cache``
    [slots, max_len, kv_heads, head_dim]; ``cache_lengths`` [slots] int
    (``ops.attention.decode_cache_attention``)."""
    helper = LayerHelper("decode_cache_attention", **locals())
    out = helper.create_tmp_variable(dtype=q.dtype)
    helper.append_op(type="decode_cache_attention",
                     inputs={"Q": [q], "KCache": [k_cache],
                             "VCache": [v_cache],
                             "CacheLengths": [cache_lengths]},
                     outputs={"Out": [out]},
                     attrs={"scale": scale})
    return out


def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=True, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None):
    """LSTM over a ragged sequence (reference nn.py:288 / lstm_op.cc).
    ``input`` is the 4h-wide projection (an fc before this layer, as in
    the reference API). Returns (hidden, cell)."""
    helper = LayerHelper("lstm", **locals())
    hidden_size = size // 4
    weight = helper.create_parameter(helper.param_attr,
                                     [hidden_size, 4 * hidden_size], dtype)
    bias_size = [1, 7 * hidden_size if use_peepholes else 4 * hidden_size]
    bias = helper.create_parameter(helper.bias_attr, bias_size, dtype,
                                   is_bias=True)
    hidden = helper.create_tmp_variable(dtype=dtype, lod_level=1)
    cell = helper.create_tmp_variable(dtype=dtype, lod_level=1)
    batch_gate = helper.create_tmp_variable(dtype=dtype, lod_level=1)
    batch_cell_pre_act = helper.create_tmp_variable(dtype=dtype, lod_level=1)
    inputs = {"Input": [input], "Weight": [weight], "Bias": [bias]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    if c_0 is not None:
        inputs["C0"] = [c_0]
    helper.append_op(type="lstm", inputs=inputs,
                     outputs={"Hidden": [hidden], "Cell": [cell],
                              "BatchGate": [batch_gate],
                              "BatchCellPreAct": [batch_cell_pre_act]},
                     attrs={"use_peepholes": use_peepholes,
                            "is_reverse": is_reverse,
                            "gate_activation": gate_activation,
                            "cell_activation": cell_activation,
                            "candidate_activation": candidate_activation})
    return hidden, cell


def sequence_pool(input, pool_type):
    """Pool each sequence of a ragged ``input`` to one row: ``sum``,
    ``average``, ``sqrt``, ``max``, ``first`` or ``last``."""
    helper = LayerHelper("sequence_pool", **locals())
    dtype = helper.input_dtype()
    pool_out = helper.create_tmp_variable(dtype=dtype)
    max_index = helper.create_tmp_variable(dtype="int32")
    helper.append_op(type="sequence_pool", inputs={"X": [input]},
                     outputs={"Out": [pool_out], "MaxIndex": [max_index]},
                     attrs={"pooltype": pool_type.upper()})
    return pool_out


def sequence_first_step(input):
    return sequence_pool(input, "first")


def sequence_last_step(input):
    return sequence_pool(input, "last")
