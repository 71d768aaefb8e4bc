"""ResNeXt (a copy of ``mxnet_tpu/models/resnext.py``; parity: the
grouped-convolution variant of resnet.py; the reference tracks it as a
BASELINE.md conv-stress config)."""
from .. import symbol as sym


def resnext_unit(data, num_filter, stride, dim_match, name, num_group=32,
                 bn_mom=0.9):
    bn1 = sym.BatchNorm(data, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                        name=name + "_bn1")
    act1 = sym.Activation(bn1, act_type="relu", name=name + "_relu1")
    conv1 = sym.Convolution(act1, num_filter=num_filter // 2, kernel=(1, 1),
                            stride=(1, 1), pad=(0, 0), no_bias=True,
                            name=name + "_conv1")
    bn2 = sym.BatchNorm(conv1, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                        name=name + "_bn2")
    act2 = sym.Activation(bn2, act_type="relu", name=name + "_relu2")
    conv2 = sym.Convolution(act2, num_filter=num_filter // 2, num_group=num_group,
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
                                   stride=stride, no_bias=True, name=name + "_sc")
    return conv3 + shortcut


def get_symbol(num_classes=1000, num_layers=101, num_group=32,
               image_shape=(3, 224, 224), bn_mom=0.9, **kwargs):
    units_map = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
    if num_layers not in units_map:
        raise ValueError(f"unsupported resnext depth {num_layers}")
    units = units_map[num_layers]
    filter_list = [64, 256, 512, 1024, 2048]

    data = sym.Variable("data")
    body = sym.Convolution(data, num_filter=filter_list[0], kernel=(7, 7),
                           stride=(2, 2), pad=(3, 3), no_bias=True, name="conv0")
    body = sym.BatchNorm(body, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                         name="bn0")
    body = sym.Activation(body, act_type="relu", name="relu0")
    body = sym.Pooling(body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                       pool_type="max")
    for i in range(4):
        body = resnext_unit(body, filter_list[i + 1], (1 if i == 0 else 2,) * 2,
                            False, name=f"stage{i + 1}_unit1",
                            num_group=num_group, bn_mom=bn_mom)
        for j in range(units[i] - 1):
            body = resnext_unit(body, filter_list[i + 1], (1, 1), True,
                                name=f"stage{i + 1}_unit{j + 2}",
                                num_group=num_group, bn_mom=bn_mom)
    bn1 = sym.BatchNorm(body, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                        name="bn1")
    relu1 = sym.Activation(bn1, act_type="relu", name="relu1")
    pool1 = sym.Pooling(relu1, global_pool=True, kernel=(7, 7), pool_type="avg",
                        name="pool1")
    flat = sym.Flatten(pool1)
    fc1 = sym.FullyConnected(flat, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(fc1, name="softmax")
