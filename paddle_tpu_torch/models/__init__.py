"""Models built with the port's layers DSL."""

from .resnet import resnet_cifar10, resnet_imagenet  # noqa
from .seq2seq import seq2seq_net  # noqa
from .stacked_lstm import stacked_lstm_net  # noqa
from .transformer import (multi_head_attention, transformer_layer,  # noqa
                          transformer_lm)
