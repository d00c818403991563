"""ResNet for CIFAR-10 and ImageNet — a copy of
``paddle_tpu/models/resnet.py`` on the port's layers: conv_bn stacks,
basicblock / bottleneck residual units, NCHW or NHWC. ``bench.py``
trains ``resnet_imagenet(depth=50)`` in NHWC; on the card its
convolutions are cuDNN's and its batch norms, pooling and activations
plain PyTorch (``ops.nn_ops``).
"""

from .. import layers

__all__ = ["resnet_cifar10", "resnet_imagenet"]


def conv_bn_layer(input, ch_out, filter_size, stride, padding, act="relu",
                  is_test=False, data_format="NCHW"):
    conv = layers.conv2d(input=input, num_filters=ch_out,
                         filter_size=filter_size, stride=stride,
                         padding=padding, act=None, bias_attr=False,
                         data_format=data_format)
    return layers.batch_norm(input=conv, act=act, is_test=is_test,
                             data_layout=data_format)


def shortcut(input, ch_out, stride, is_test=False, data_format="NCHW"):
    ch_in = input.shape[-1] if data_format == "NHWC" else input.shape[1]
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride, 0, None,
                             is_test=is_test, data_format=data_format)
    return input


def basicblock(input, ch_out, stride, is_test=False, data_format="NCHW"):
    short = shortcut(input, ch_out, stride, is_test=is_test,
                     data_format=data_format)
    conv1 = conv_bn_layer(input, ch_out, 3, stride, 1, is_test=is_test,
                          data_format=data_format)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, act=None, is_test=is_test,
                          data_format=data_format)
    return layers.elementwise_add(x=short, y=conv2, act="relu")


def bottleneck(input, ch_out, stride, is_test=False, data_format="NCHW"):
    short = shortcut(input, ch_out * 4, stride, is_test=is_test,
                     data_format=data_format)
    conv1 = conv_bn_layer(input, ch_out, 1, stride, 0, is_test=is_test,
                          data_format=data_format)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, is_test=is_test,
                          data_format=data_format)
    conv3 = conv_bn_layer(conv2, ch_out * 4, 1, 1, 0, act=None,
                          is_test=is_test, data_format=data_format)
    return layers.elementwise_add(x=short, y=conv3, act="relu")


def layer_warp(block_func, input, ch_out, count, stride, is_test=False,
               data_format="NCHW"):
    res_out = block_func(input, ch_out, stride, is_test=is_test,
                         data_format=data_format)
    for _ in range(count - 1):
        res_out = block_func(res_out, ch_out, 1, is_test=is_test,
                             data_format=data_format)
    return res_out


def resnet_imagenet(input, class_dim=1000, depth=50, is_test=False,
                    data_format="NCHW"):
    """ResNet-{18,34,50,101,152} backbone + classifier head. Input is NCHW
    [N, 3, 224, 224] either way; ``data_format='NHWC'`` transposes once at
    the stem and runs every conv/bn/pool channels-last (cuDNN's NHWC
    kernels on the card). Parameters are identical between the two
    variants (filters stay OIHW). Returns softmax predictions."""
    cfg = {
        18: ([2, 2, 2, 2], basicblock),
        34: ([3, 4, 6, 3], basicblock),
        50: ([3, 4, 6, 3], bottleneck),
        101: ([3, 4, 23, 3], bottleneck),
        152: ([3, 8, 36, 3], bottleneck),
    }
    stages, block_func = cfg[depth]
    if data_format == "NHWC":
        input = layers.transpose(input, perm=[0, 2, 3, 1])
    conv1 = conv_bn_layer(input, ch_out=64, filter_size=7, stride=2,
                          padding=3, is_test=is_test,
                          data_format=data_format)
    pool1 = layers.pool2d(input=conv1, pool_type="max", pool_size=3,
                          pool_stride=2, pool_padding=1,
                          data_format=data_format)
    res1 = layer_warp(block_func, pool1, 64, stages[0], 1, is_test=is_test,
                      data_format=data_format)
    res2 = layer_warp(block_func, res1, 128, stages[1], 2, is_test=is_test,
                      data_format=data_format)
    res3 = layer_warp(block_func, res2, 256, stages[2], 2, is_test=is_test,
                      data_format=data_format)
    res4 = layer_warp(block_func, res3, 512, stages[3], 2, is_test=is_test,
                      data_format=data_format)
    pool2 = layers.pool2d(input=res4, pool_type="avg", global_pooling=True,
                          data_format=data_format)
    out = layers.fc(input=pool2, size=class_dim, act="softmax")
    return out


def resnet_cifar10(input, class_dim=10, depth=32, is_test=False):
    """The CIFAR-10 variant: 6n+2 layers of basicblocks over 32x32 input."""
    assert (depth - 2) % 6 == 0
    n = (depth - 2) // 6
    conv1 = conv_bn_layer(input, ch_out=16, filter_size=3, stride=1,
                          padding=1, is_test=is_test)
    res1 = layer_warp(basicblock, conv1, 16, n, 1, is_test=is_test)
    res2 = layer_warp(basicblock, res1, 32, n, 2, is_test=is_test)
    res3 = layer_warp(basicblock, res2, 64, n, 2, is_test=is_test)
    pool = layers.pool2d(input=res3, pool_type="avg", pool_size=8,
                         pool_stride=1)
    out = layers.fc(input=pool, size=class_dim, act="softmax")
    return out
