"""LayerHelper — a copy of ``paddle_tpu/layer_helper.py``: shared plumbing
for layer functions (parameters in the main program's global block plus
their init ops in the startup program, temp output vars, bias and
activation appending).
"""

import copy

from . import unique_name
from .framework import Variable, default_main_program, \
    default_startup_program
from .param_attr import ParamAttr

__all__ = ["LayerHelper"]


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = self.kwargs.get("name")
        if name is None:
            self.kwargs["name"] = unique_name.generate(layer_type)

    @property
    def name(self):
        return self.kwargs["name"]

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    @property
    def param_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("param_attr"))

    @property
    def bias_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("bias_attr"))

    def multiple_param_attr(self, length):
        attr = self.param_attr
        if isinstance(attr, ParamAttr):
            attr = [attr] + [copy.deepcopy(attr) for _ in range(length - 1)]
        return attr

    def input(self, input_param_name="input"):
        inputs = self.kwargs.get(input_param_name)
        if isinstance(inputs, (list, tuple)):
            return list(inputs)
        return [inputs]

    def input_dtype(self, input_param_name="input"):
        for v in self.input(input_param_name):
            if isinstance(v, Variable) and v.dtype is not None:
                return v.dtype
        return "float32"

    def create_parameter(self, attr, shape, dtype, is_bias=False,
                         default_initializer=None):
        if attr is False:
            return None
        attr = copy.deepcopy(attr) if attr is not None else ParamAttr()
        if default_initializer is None:
            if is_bias:
                attr._set_default_bias_initializer()
            else:
                attr._set_default_param_initializer()
        else:
            attr._set_default_initializer(default_initializer)
        if attr.name is None:
            attr.name = unique_name.generate(".".join([self.name,
                                                       "b" if is_bias else "w"]))
        shape = [int(d) for d in shape]
        main_block = self.main_program.global_block()
        param = main_block.create_parameter(
            shape=shape, dtype=dtype, **attr.to_kwargs())
        # mirrored var + init op in the startup program
        startup_block = self.startup_program.global_block()
        if not startup_block.has_var_local(param.name):
            sv = startup_block.create_var(
                name=param.name, shape=shape, dtype=dtype, persistable=True)
            attr.initializer(sv, startup_block)
        return param

    def create_tmp_variable(self, dtype=None, stop_gradient=False,
                            lod_level=0):
        return self.main_program.current_block().create_var(
            name=unique_name.generate(".".join([self.name, "tmp"])),
            dtype=dtype, stop_gradient=stop_gradient, lod_level=lod_level)

    def set_variable_initializer(self, var, initializer):
        """Create the same-named var in startup program with an init op."""
        sb = self.startup_program.global_block()
        if not sb.has_var_local(var.name):
            sv = sb.create_var(name=var.name, shape=var.shape, dtype=var.dtype,
                               persistable=True)
            initializer(sv, sb)
        return var

    def append_op(self, **kwargs):
        return self.main_program.current_block().append_op(**kwargs)

    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        bias_attr = self.bias_attr
        if bias_attr is False:
            return input_var
        size = list(input_var.shape[dim_start:dim_end]) if input_var.shape \
            else [1]
        size = [d if d > 0 else 1 for d in size]
        b = self.create_parameter(bias_attr, shape=size,
                                  dtype=input_var.dtype, is_bias=True)
        tmp = self.create_tmp_variable(dtype=input_var.dtype,
                                       lod_level=input_var.lod_level)
        self.append_op(type="elementwise_add",
                       inputs={"X": [input_var], "Y": [b]},
                       outputs={"Out": [tmp]}, attrs={"axis": dim_start})
        return tmp

    def append_activation(self, input_var):
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        act = dict(act)
        act_type = act.pop("type")
        tmp = self.create_tmp_variable(dtype=input_var.dtype,
                                       lod_level=input_var.lod_level)
        self.append_op(type=act_type, inputs={"X": [input_var]},
                       outputs={"Out": [tmp]}, attrs=act)
        return tmp
