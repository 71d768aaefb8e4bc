"""Inception-ResNet-v2 (a copy of
``mxnet_tpu/models/inception_resnet.py``; parity:
example/image-classification/symbols/inception-resnet-v2.py)."""
from .. import symbol as sym


def ConvFactory(data, num_filter, kernel, stride=(1, 1), pad=(0, 0),
                act_type="relu", mirror_attr=None, with_act=True, name=None):
    conv = sym.Convolution(data, num_filter=num_filter, kernel=kernel,
                           stride=stride, pad=pad, name=name)
    bn = sym.BatchNorm(conv, name=f"{name}_bn" if name else None)
    if with_act:
        return sym.Activation(bn, act_type=act_type,
                              name=f"{name}_relu" if name else None)
    return bn


def block35(net, input_num_channels, scale=1.0, with_act=True, name=None):
    tower_conv = ConvFactory(net, 32, (1, 1), name=f"{name}_t1_c1")
    tower_conv1_0 = ConvFactory(net, 32, (1, 1), name=f"{name}_t2_c1")
    tower_conv1_1 = ConvFactory(tower_conv1_0, 32, (3, 3), pad=(1, 1),
                                name=f"{name}_t2_c2")
    tower_conv2_0 = ConvFactory(net, 32, (1, 1), name=f"{name}_t3_c1")
    tower_conv2_1 = ConvFactory(tower_conv2_0, 48, (3, 3), pad=(1, 1),
                                name=f"{name}_t3_c2")
    tower_conv2_2 = ConvFactory(tower_conv2_1, 64, (3, 3), pad=(1, 1),
                                name=f"{name}_t3_c3")
    tower_mixed = sym.Concat(tower_conv, tower_conv1_1, tower_conv2_2)
    tower_out = ConvFactory(tower_mixed, input_num_channels, (1, 1),
                            with_act=False, name=f"{name}_out")
    net = net + scale * tower_out
    if with_act:
        net = sym.Activation(net, act_type="relu")
    return net


def block17(net, input_num_channels, scale=1.0, with_act=True, name=None):
    tower_conv = ConvFactory(net, 192, (1, 1), name=f"{name}_t1_c1")
    tower_conv1_0 = ConvFactory(net, 129, (1, 1), name=f"{name}_t2_c1")
    tower_conv1_1 = ConvFactory(tower_conv1_0, 160, (1, 7), pad=(1, 2),
                                name=f"{name}_t2_c2")
    tower_conv1_2 = ConvFactory(tower_conv1_1, 192, (7, 1), pad=(2, 1),
                                name=f"{name}_t2_c3")
    tower_mixed = sym.Concat(tower_conv, tower_conv1_2)
    tower_out = ConvFactory(tower_mixed, input_num_channels, (1, 1),
                            with_act=False, name=f"{name}_out")
    net = net + scale * tower_out
    if with_act:
        net = sym.Activation(net, act_type="relu")
    return net


def block8(net, input_num_channels, scale=1.0, with_act=True, name=None):
    tower_conv = ConvFactory(net, 192, (1, 1), name=f"{name}_t1_c1")
    tower_conv1_0 = ConvFactory(net, 192, (1, 1), name=f"{name}_t2_c1")
    tower_conv1_1 = ConvFactory(tower_conv1_0, 224, (1, 3), pad=(0, 1),
                                name=f"{name}_t2_c2")
    tower_conv1_2 = ConvFactory(tower_conv1_1, 256, (3, 1), pad=(1, 0),
                                name=f"{name}_t2_c3")
    tower_mixed = sym.Concat(tower_conv, tower_conv1_2)
    tower_out = ConvFactory(tower_mixed, input_num_channels, (1, 1),
                            with_act=False, name=f"{name}_out")
    net = net + scale * tower_out
    if with_act:
        net = sym.Activation(net, act_type="relu")
    return net


def repeat(inputs, repetitions, layer, *args, name=None, **kwargs):
    outputs = inputs
    for i in range(repetitions):
        outputs = layer(outputs, *args, name=f"{name}_{i}", **kwargs)
    return outputs


def get_symbol(num_classes=1000, **kwargs):
    data = sym.Variable("data")
    conv1a_3_3 = ConvFactory(data, 32, (3, 3), stride=(2, 2),
                             name="conv1a_3_3")
    conv2a_3_3 = ConvFactory(conv1a_3_3, 32, (3, 3), name="conv2a_3_3")
    conv2b_3_3 = ConvFactory(conv2a_3_3, 64, (3, 3), pad=(1, 1),
                             name="conv2b_3_3")
    maxpool3a_3_3 = sym.Pooling(conv2b_3_3, kernel=(3, 3), stride=(2, 2),
                                pool_type="max")
    conv3b_1_1 = ConvFactory(maxpool3a_3_3, 80, (1, 1), name="conv3b_1_1")
    conv4a_3_3 = ConvFactory(conv3b_1_1, 192, (3, 3), name="conv4a_3_3")
    maxpool5a_3_3 = sym.Pooling(conv4a_3_3, kernel=(3, 3), stride=(2, 2),
                                pool_type="max")

    tower_conv = ConvFactory(maxpool5a_3_3, 96, (1, 1), name="tower_conv")
    tower_conv1_0 = ConvFactory(maxpool5a_3_3, 48, (1, 1),
                                name="tower_conv1_0")
    tower_conv1_1 = ConvFactory(tower_conv1_0, 64, (5, 5), pad=(2, 2),
                                name="tower_conv1_1")
    tower_conv2_0 = ConvFactory(maxpool5a_3_3, 64, (1, 1),
                                name="tower_conv2_0")
    tower_conv2_1 = ConvFactory(tower_conv2_0, 96, (3, 3), pad=(1, 1),
                                name="tower_conv2_1")
    tower_conv2_2 = ConvFactory(tower_conv2_1, 96, (3, 3), pad=(1, 1),
                                name="tower_conv2_2")
    tower_pool3_0 = sym.Pooling(maxpool5a_3_3, kernel=(3, 3), stride=(1, 1),
                                pad=(1, 1), pool_type="avg")
    tower_conv3_1 = ConvFactory(tower_pool3_0, 64, (1, 1),
                                name="tower_conv3_1")
    tower_5b_out = sym.Concat(tower_conv, tower_conv1_1, tower_conv2_2,
                              tower_conv3_1)

    net = repeat(tower_5b_out, 10, block35, 320, scale=0.17, name="block35")

    tower_conv = ConvFactory(net, 384, (3, 3), stride=(2, 2), name="rd1_t1")
    tower_conv1_0 = ConvFactory(net, 256, (1, 1), name="rd1_t2_c1")
    tower_conv1_1 = ConvFactory(tower_conv1_0, 256, (3, 3), pad=(1, 1),
                                name="rd1_t2_c2")
    tower_conv1_2 = ConvFactory(tower_conv1_1, 384, (3, 3), stride=(2, 2),
                                name="rd1_t2_c3")
    tower_pool = sym.Pooling(net, kernel=(3, 3), stride=(2, 2),
                             pool_type="max")
    net = sym.Concat(tower_conv, tower_conv1_2, tower_pool)

    net = repeat(net, 20, block17, 1088, scale=0.1, name="block17")

    tower_conv = ConvFactory(net, 256, (1, 1), name="rd2_t1_c1")
    tower_conv0_1 = ConvFactory(tower_conv, 384, (3, 3), stride=(2, 2),
                                name="rd2_t1_c2")
    tower_conv1 = ConvFactory(net, 256, (1, 1), name="rd2_t2_c1")
    tower_conv1_1 = ConvFactory(tower_conv1, 288, (3, 3), stride=(2, 2),
                                name="rd2_t2_c2")
    tower_conv2 = ConvFactory(net, 256, (1, 1), name="rd2_t3_c1")
    tower_conv2_1 = ConvFactory(tower_conv2, 288, (3, 3), pad=(1, 1),
                                name="rd2_t3_c2")
    tower_conv2_2 = ConvFactory(tower_conv2_1, 320, (3, 3), stride=(2, 2),
                                name="rd2_t3_c3")
    tower_pool = sym.Pooling(net, kernel=(3, 3), stride=(2, 2),
                             pool_type="max")
    net = sym.Concat(tower_conv0_1, tower_conv1_1, tower_conv2_2, tower_pool)

    net = repeat(net, 9, block8, 2080, scale=0.2, name="block8")
    net = block8(net, 2080, with_act=False, name="block8_final")

    net = ConvFactory(net, 1536, (1, 1), name="conv6_1_1")
    net = sym.Pooling(net, kernel=(8, 8), stride=(1, 1), global_pool=True,
                      pool_type="avg", name="global_pool")
    net = sym.Flatten(net, name="flatten")
    net = sym.Dropout(net, p=0.2)
    net = sym.FullyConnected(net, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(net, sym.Variable("softmax_label"),
                             name="softmax")
