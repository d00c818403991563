"""Optimizers: build the optimization pass on the IR — the port of
``paddle_tpu/optimizer.py``'s ``Optimizer`` base (the global learning-rate
variable, per-parameter accumulators), ``SGD`` and ``Adam`` (one ``adam``
op per parameter, beta powers advanced by ``scale`` ops).
``minimize`` = ``append_backward`` + one optimizer op per parameter.
Gradient clipping and regularization are not ported yet and raise.
"""

from collections import defaultdict

from . import unique_name
from .backward import append_backward
from .framework import Variable, default_main_program
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper

__all__ = ["SGD", "Adam", "SGDOptimizer", "AdamOptimizer", "Optimizer"]


class Optimizer:
    def __init__(self, learning_rate, regularization=None):
        if not isinstance(learning_rate, (float, Variable)):
            raise TypeError("learning rate must be float or Variable")
        if regularization is not None:
            raise NotImplementedError("regularization is not ported yet")
        self._learning_rate = learning_rate
        self._learning_rate_map = {}
        self._accumulators = defaultdict(dict)
        self.helper = None

    # -- learning rate -------------------------------------------------
    def _create_global_learning_rate(self):
        program = default_main_program()
        if program in self._learning_rate_map:
            return
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_map[program] = self._learning_rate
            return
        lr = program.global_block().create_var(
            name=unique_name.generate("learning_rate"), shape=[1],
            dtype="float32", persistable=True)
        self.helper.set_variable_initializer(
            lr, ConstantInitializer(float(self._learning_rate)))
        self._learning_rate_map[program] = lr

    def _create_param_lr(self, param_and_grad):
        param = param_and_grad[0]
        param_lr = (param.optimize_attr or {}).get("learning_rate", 1.0)
        glr = self._learning_rate_map[default_main_program()]
        if param_lr == 1.0:
            return glr
        block = default_main_program().global_block()
        tmp = block.create_var(
            name=unique_name.generate("%s.lr" % param.name), shape=[1],
            dtype="float32")
        block.append_op(type="scale", inputs={"X": [glr]},
                        outputs={"Out": [tmp]}, attrs={"scale": param_lr})
        return tmp

    # -- accumulators --------------------------------------------------
    def _add_accumulator(self, name, param, dtype=None, fill_value=0.0,
                         shape=None):
        if param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        shape = shape or [d if d > 0 else 1 for d in param.shape]
        block = default_main_program().global_block()
        var = block.create_var(
            name=unique_name.generate("%s_%s" % (param.name, name)),
            shape=shape, dtype=dtype or param.dtype, persistable=True)
        self.helper.set_variable_initializer(
            var, ConstantInitializer(fill_value))
        self._accumulators[name][param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    # -- per-optimizer hooks -------------------------------------------
    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def _finish_update(self, block):
        pass

    def _create_optimization_pass(self, parameters_and_grads, loss):
        self.helper = LayerHelper(self.__class__.__name__)
        self._create_accumulators(
            loss.block, [p for p, g in parameters_and_grads if g is not None])
        self._create_global_learning_rate()
        optimize_ops = []
        block = loss.block.program.global_block()
        for param_and_grad in parameters_and_grads:
            if param_and_grad[1] is not None and param_and_grad[0].trainable:
                optimize_ops.append(
                    self._append_optimize_op(block, param_and_grad))
        self._finish_update(block)
        return optimize_ops

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = append_backward(loss, parameter_list, no_grad_set)
        params_grads = sorted(params_grads, key=lambda x: x[0].name)
        for p, _ in params_grads:
            if p.gradient_clip_attr is not None or p.regularizer is not None:
                raise NotImplementedError(
                    "parameter %r asks for gradient clipping or "
                    "regularization, which are not ported yet" % p.name)
        optimize_ops = self._create_optimization_pass(params_grads, loss)
        return optimize_ops, params_grads


class SGDOptimizer(Optimizer):
    def __init__(self, learning_rate, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "sgd"

    def _append_optimize_op(self, block, param_and_grad):
        return block.append_op(
            type="sgd",
            inputs={"Param": [param_and_grad[0]], "Grad": [param_and_grad[1]],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]]}, infer_shape=False)


class AdamOptimizer(Optimizer):
    _moment1_acc_str = "moment1"
    _moment2_acc_str = "moment2"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "adam"
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment1_acc_str, p)
            self._add_accumulator(self._moment2_acc_str, p)
        self._beta1_pow = self._add_accumulator(
            "beta1_pow_acc", parameters[0], fill_value=self._beta1, shape=[1])
        self._beta2_pow = self._add_accumulator(
            "beta2_pow_acc", parameters[0], fill_value=self._beta2, shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        m1 = self._get_accumulator(self._moment1_acc_str, param_and_grad[0])
        m2 = self._get_accumulator(self._moment2_acc_str, param_and_grad[0])
        return block.append_op(
            type="adam",
            inputs={"Param": [param_and_grad[0]], "Grad": [param_and_grad[1]],
                    "LearningRate": [self._create_param_lr(param_and_grad)],
                    "Moment1": [m1], "Moment2": [m2],
                    "Beta1Pow": [self._beta1_pow],
                    "Beta2Pow": [self._beta2_pow]},
            outputs={"ParamOut": [param_and_grad[0]], "Moment1Out": [m1],
                     "Moment2Out": [m2]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon}, infer_shape=False)

    def _finish_update(self, block):
        # beta_pow *= beta, once per step
        for pow_acc, beta in ((self._beta1_pow, self._beta1),
                              (self._beta2_pow, self._beta2)):
            block.append_op(type="scale", inputs={"X": [pow_acc]},
                            outputs={"Out": [pow_acc]},
                            attrs={"scale": beta}, infer_shape=False)


SGD = SGDOptimizer
Adam = AdamOptimizer
