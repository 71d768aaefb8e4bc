"""ResNet (a copy of ``mxnet_tpu/models/resnet.py``; parity:
example/image-classification/symbols/resnet.py).

Structure follows the reference generator: bottleneck residual units for
depth >= 50, basic units below; bn_mom 0.9, fix_gamma=False on BNs,
workspace attr dropped.  The units are pre-activation, so the residual
sum of a unit feeds the next unit's BatchNorm and, inside a stage, its
identity shortcut too: the graph passes fuse only the tails whose sum
has one consumer — the last unit of stages 1-3, read only by the next
stage's first BatchNorm (``stage{2,3,4}_unit1_relu1``), and the final
``relu1`` — into ``_residual_epilogue_bn``
(``passes/residual_epilogue.py``).  Node and
variable names are the JAX package's, so its params bind here as they
are.
"""
import numpy as np

from .. import symbol as sym


def residual_unit(data, num_filter, stride, dim_match, name, bottle_neck=True,
                  bn_mom=0.9):
    if bottle_neck:
        bn1 = sym.BatchNorm(data, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                            name=name + "_bn1")
        act1 = sym.Activation(bn1, act_type="relu", name=name + "_relu1")
        conv1 = sym.Convolution(act1, num_filter=int(num_filter * 0.25),
                                kernel=(1, 1), stride=(1, 1), pad=(0, 0),
                                no_bias=True, name=name + "_conv1")
        bn2 = sym.BatchNorm(conv1, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                            name=name + "_bn2")
        act2 = sym.Activation(bn2, act_type="relu", name=name + "_relu2")
        conv2 = sym.Convolution(act2, num_filter=int(num_filter * 0.25),
                                kernel=(3, 3), stride=stride, pad=(1, 1),
                                no_bias=True, name=name + "_conv2")
        bn3 = sym.BatchNorm(conv2, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                            name=name + "_bn3")
        act3 = sym.Activation(bn3, act_type="relu", name=name + "_relu3")
        conv3 = sym.Convolution(act3, num_filter=num_filter, kernel=(1, 1),
                                stride=(1, 1), pad=(0, 0), no_bias=True,
                                name=name + "_conv3")
        if dim_match:
            shortcut = data
        else:
            shortcut = sym.Convolution(act1, num_filter=num_filter, kernel=(1, 1),
                                       stride=stride, no_bias=True,
                                       name=name + "_sc")
        return conv3 + shortcut
    bn1 = sym.BatchNorm(data, fix_gamma=False, momentum=bn_mom, eps=2e-5,
                        name=name + "_bn1")
    act1 = sym.Activation(bn1, act_type="relu", name=name + "_relu1")
    conv1 = sym.Convolution(act1, num_filter=num_filter, kernel=(3, 3),
                            stride=stride, pad=(1, 1), no_bias=True,
                            name=name + "_conv1")
    bn2 = sym.BatchNorm(conv1, fix_gamma=False, momentum=bn_mom, eps=2e-5,
                        name=name + "_bn2")
    act2 = sym.Activation(bn2, act_type="relu", name=name + "_relu2")
    conv2 = sym.Convolution(act2, num_filter=num_filter, kernel=(3, 3),
                            stride=(1, 1), pad=(1, 1), no_bias=True,
                            name=name + "_conv2")
    if dim_match:
        shortcut = data
    else:
        shortcut = sym.Convolution(act1, num_filter=num_filter, kernel=(1, 1),
                                   stride=stride, no_bias=True, name=name + "_sc")
    return conv2 + shortcut


def resnet(units, num_stages, filter_list, num_classes, image_shape,
           bottle_neck=True, bn_mom=0.9, stem="default"):
    data = sym.Variable("data")
    data = sym.BatchNorm(data, fix_gamma=True, eps=2e-5, momentum=bn_mom,
                         name="bn_data")
    (nchannel, height, width) = image_shape
    if height <= 32:  # cifar-style stem
        body = sym.Convolution(data, num_filter=filter_list[0], kernel=(3, 3),
                               stride=(1, 1), pad=(1, 1), no_bias=True,
                               name="conv0")
    elif stem == "s2d":
        # space-to-depth stem (the MLPerf-ResNet trick): the 7x7/s2 conv on
        # [N,C,H,W] is reparameterized as a 4x4/s1 conv on the input
        # rearranged to [N,4C,H/2,W/2] — every weight of the original conv
        # maps into the (front-zero-padded-to-8) 4x4x4C kernel, so the
        # function class contains the original exactly.  Symmetric pad 2 +
        # crop of the trailing row/col realizes the (2,1) asymmetric
        # padding the reparameterization needs.
        s2d = sym.Reshape(data, shape=(-1, nchannel, height // 2, 2,
                                       width // 2, 2))
        s2d = sym.transpose(s2d, axes=(0, 1, 3, 5, 2, 4))
        s2d = sym.Reshape(s2d, shape=(-1, nchannel * 4, height // 2,
                                      width // 2))
        body = sym.Convolution(s2d, num_filter=filter_list[0], kernel=(4, 4),
                               stride=(1, 1), pad=(2, 2), no_bias=True,
                               name="conv0")
        body = sym.slice(body, begin=(None, None, 0, 0),
                         end=(None, None, height // 2, width // 2))
        body = sym.BatchNorm(body, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                             name="bn0")
        body = sym.Activation(body, act_type="relu", name="relu0")
        body = sym.Pooling(body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                           pool_type="max")
    else:  # imagenet stem
        body = sym.Convolution(data, num_filter=filter_list[0], kernel=(7, 7),
                               stride=(2, 2), pad=(3, 3), no_bias=True,
                               name="conv0")
        body = sym.BatchNorm(body, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                             name="bn0")
        body = sym.Activation(body, act_type="relu", name="relu0")
        body = sym.Pooling(body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                           pool_type="max")

    for i in range(num_stages):
        body = residual_unit(body, filter_list[i + 1],
                             (1 if i == 0 else 2,) * 2, False,
                             name=f"stage{i + 1}_unit1", bottle_neck=bottle_neck,
                             bn_mom=bn_mom)
        for j in range(units[i] - 1):
            body = residual_unit(body, filter_list[i + 1], (1, 1), True,
                                 name=f"stage{i + 1}_unit{j + 2}",
                                 bottle_neck=bottle_neck, bn_mom=bn_mom)
    bn1 = sym.BatchNorm(body, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                        name="bn1")
    relu1 = sym.Activation(bn1, act_type="relu", name="relu1")
    pool1 = sym.Pooling(relu1, global_pool=True, kernel=(7, 7), pool_type="avg",
                        name="pool1")
    flat = sym.Flatten(pool1)
    fc1 = sym.FullyConnected(flat, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(fc1, name="softmax")


def get_symbol(num_classes=1000, num_layers=50, image_shape=(3, 224, 224), **kwargs):
    """Parity: resnet.py get_symbol — depth -> unit configuration table."""
    (nchannel, height, width) = image_shape
    # mnist/cifar-style 3-stage variant for depths 6n+2 / 9n+2 (20, 50,
    # 56, 110, 164...); depths outside those families (18, 34...) use
    # the 4-stage imagenet topology even on small images
    if height <= 32 and ((num_layers - 2) % 9 == 0 and num_layers >= 164
                         or (num_layers - 2) % 6 == 0 and num_layers < 164):
        num_stages = 3
        if num_layers >= 164:
            per_unit = [(num_layers - 2) // 9]
            filter_list = [16, 64, 128, 256]
            bottle_neck = True
        else:
            per_unit = [(num_layers - 2) // 6]
            filter_list = [16, 16, 32, 64]
            bottle_neck = False
        units = per_unit * num_stages
    else:
        if num_layers >= 50:
            filter_list = [64, 256, 512, 1024, 2048]
            bottle_neck = True
        else:
            filter_list = [64, 64, 128, 256, 512]
            bottle_neck = False
        num_stages = 4
        units_map = {
            18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
            101: [3, 4, 23, 3], 152: [3, 8, 36, 3], 200: [3, 24, 36, 3],
            269: [3, 30, 48, 8],
        }
        if num_layers not in units_map:
            raise ValueError(f"no experiments done on num_layers {num_layers}")
        units = units_map[num_layers]
    return resnet(units, num_stages, filter_list, num_classes, image_shape,
                  bottle_neck, stem=kwargs.get("stem", "default"))


def random_params(symbol, seed=0, **input_shapes):
    """Seeded random weights for a ResNet symbol, as numpy float32 dicts
    ``(arg_params, aux_params)``: He-normal conv weights (std
    ``sqrt(2 / fan_in)``), gamma 1 and beta 0, moving mean U(-0.1, 0.1)
    and moving variance U(0.75, 1.25), FullyConnected weights N(0, 0.01)
    and zero biases.  The inputs named in ``input_shapes`` and the
    ``*_label`` arguments get none."""
    arg_shapes, _, aux_shapes = symbol.infer_shape(**input_shapes)
    rng = np.random.default_rng(seed)
    args = {}
    for name, shape in zip(symbol.list_arguments(), arg_shapes):
        if name in input_shapes or name.endswith("_label"):
            continue
        if name.endswith("_weight") and len(shape) == 4:
            std = np.sqrt(2.0 / np.prod(shape[1:]))
            args[name] = rng.normal(0.0, std, shape)
        elif name.endswith("_weight"):
            args[name] = rng.normal(0.0, 0.01, shape)
        elif name.endswith("_gamma"):
            args[name] = np.ones(shape)
        else:  # beta, bias
            args[name] = np.zeros(shape)
    aux = {}
    for name, shape in zip(symbol.list_auxiliary_states(), aux_shapes):
        lo, hi = (0.75, 1.25) if name.endswith("_var") else (-0.1, 0.1)
        aux[name] = rng.uniform(lo, hi, shape)
    return ({k: v.astype(np.float32) for k, v in args.items()},
            {k: v.astype(np.float32) for k, v in aux.items()})
