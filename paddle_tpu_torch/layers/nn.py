"""Neural-network layers of the training slice: copies of
``paddle_tpu/layers/nn.py``'s ``fc``, ``embedding``, ``layer_norm``,
``softmax_with_cross_entropy``, ``reshape``, ``split``, ``mean`` and
``slice``, and of ``layers/ops.py``'s ``elementwise_add``. Each appends
ops to the current Program; the executor runs them.
"""

import numpy as np

from ..initializer import ConstantInitializer
from ..layer_helper import LayerHelper

__all__ = ["fc", "embedding", "layer_norm", "softmax_with_cross_entropy",
           "reshape", "split", "mean", "slice", "elementwise_add"]


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
