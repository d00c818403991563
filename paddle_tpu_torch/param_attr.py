"""ParamAttr — a copy of ``paddle_tpu/param_attr.py``: per-parameter
configuration (name, initializer, lr scale, regularizer, clipping,
trainable). ``sharding`` is accepted and ignored: the port has no mesh
yet."""

from .initializer import ConstantInitializer, XavierInitializer

__all__ = ["ParamAttr"]


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, gradient_clip=None,
                 do_model_average=None, sharding=None):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip
        self.do_model_average = do_model_average
        self.sharding = sharding

    @staticmethod
    def _to_attr(arg):
        if arg is None:
            return ParamAttr()
        if isinstance(arg, (list, tuple)):
            return [ParamAttr._to_attr(a) for a in arg]
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, bool):
            return ParamAttr() if arg else False
        raise TypeError("invalid ParamAttr %r" % (arg,))

    def _set_default_initializer(self, initializer):
        if self.initializer is None:
            self.initializer = initializer

    def _set_default_param_initializer(self):
        self._set_default_initializer(XavierInitializer())

    def _set_default_bias_initializer(self):
        self._set_default_initializer(ConstantInitializer(0.0))

    def to_kwargs(self, with_initializer=False):
        kw = {"name": self.name,
              "optimize_attr": {"learning_rate": self.learning_rate},
              "regularizer": self.regularizer,
              "gradient_clip_attr": self.gradient_clip,
              "trainable": self.trainable,
              "do_model_average": self.do_model_average,
              "sharding": self.sharding}
        if with_initializer:
            kw["initializer"] = self.initializer
        return kw
