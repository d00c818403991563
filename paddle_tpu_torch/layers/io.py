"""Data-input layers: ``data`` (a copy of ``paddle_tpu/layers/io.py``'s)."""

from ..framework import VarType
from ..layer_helper import LayerHelper

__all__ = ["data"]


def data(name, shape, dtype="float32", lod_level=0, type=VarType.LOD_TENSOR,
         append_batch_size=True, stop_gradient=True):
    """Declare a feed variable."""
    helper = LayerHelper("data")
    shape = list(shape)
    if append_batch_size:
        shape = [-1] + shape
    return helper.main_program.current_block().create_var(
        name=name, shape=shape, dtype=dtype, lod_level=lod_level, type=type,
        stop_gradient=stop_gradient, is_data=True)
