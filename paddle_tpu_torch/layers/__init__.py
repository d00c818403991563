"""The layers DSL — user-facing graph builders, the subset of
``paddle_tpu/layers`` the training slice needs."""

from . import io, nn, tensor
from .io import *              # noqa: F401,F403
from .nn import *              # noqa: F401,F403
from .tensor import *          # noqa: F401,F403

__all__ = io.__all__ + nn.__all__ + tensor.__all__
