"""Parameter initializers, emitted as ops into the startup program — a
copy of ``paddle_tpu/initializer.py``'s Constant, Uniform, Normal and
Xavier (what ``fc``, ``embedding``, ``layer_norm`` and
``create_parameter`` use by default). The startup program runs them on
the executor's device; their random streams are the port's own (a counter
hash, ``registry.CounterStream``), not ``jax.random``'s.
"""

import math

import numpy as np

__all__ = ["Constant", "Uniform", "Normal", "Xavier",
           "ConstantInitializer", "UniformInitializer", "NormalInitializer",
           "XavierInitializer"]


class Initializer:
    # Every __call__ below appends its fill op with infer_shape=False:
    # the output is the parameter/state var itself, whose shape was
    # declared at creation and is echoed into the op's shape attr.

    def __call__(self, var, block):
        raise NotImplementedError

    def _shape(self, var):
        return [d if d > 0 else 1 for d in var.shape]


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0, force_cpu=False):
        self.value = value

    def __call__(self, var, block):
        block.append_op(type="fill_constant", outputs={"Out": [var.name]},
                       attrs={"shape": self._shape(var), "value": self.value,
                              "dtype": var.dtype or "float32"},
                       infer_shape=False)


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        block.append_op(type="uniform_random", outputs={"Out": [var.name]},
                       attrs={"shape": self._shape(var), "min": self.low,
                              "max": self.high, "seed": self.seed,
                              "dtype": var.dtype or "float32"},
                       infer_shape=False)


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.mean, self.std, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op(type="gaussian_random", outputs={"Out": [var.name]},
                       attrs={"shape": self._shape(var), "mean": self.mean,
                              "std": self.std, "seed": self.seed,
                              "dtype": var.dtype or "float32"},
                       infer_shape=False)


def _fan_in_out(var):
    shape = [d if d > 0 else 1 for d in var.shape]
    if len(shape) <= 1:
        return shape[0] if shape else 1, shape[0] if shape else 1
    receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    fan_in = shape[0] * receptive if len(shape) == 2 else shape[1] * receptive
    fan_out = shape[1] * receptive if len(shape) == 2 else shape[0] * receptive
    return fan_in, fan_out


class XavierInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out, self.seed = \
            uniform, fan_in, fan_out, seed

    def __call__(self, var, block):
        fi, fo = _fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / (fi + fo))
            NormalInitializer(0.0, std, self.seed)(var, block)


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer
