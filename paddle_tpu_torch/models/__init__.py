"""Models built with the port's layers DSL."""

from .transformer import (multi_head_attention, transformer_layer,  # noqa
                          transformer_lm)
