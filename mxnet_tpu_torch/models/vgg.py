"""VGG-16 (a copy of ``mxnet_tpu/models/vgg.py``; parity:
example/image-classification/symbols/vgg.py)."""
from .. import symbol as sym


def get_symbol(num_classes=1000, **kwargs):
    data = sym.Variable("data")

    def block(src, num, filters, stage):
        body = src
        for i in range(num):
            body = sym.Convolution(body, kernel=(3, 3), pad=(1, 1),
                                   num_filter=filters,
                                   name=f"conv{stage}_{i + 1}")
            body = sym.Activation(body, act_type="relu",
                                  name=f"relu{stage}_{i + 1}")
        return sym.Pooling(body, pool_type="max", kernel=(2, 2), stride=(2, 2),
                           name=f"pool{stage}")

    body = block(data, 2, 64, 1)
    body = block(body, 2, 128, 2)
    body = block(body, 3, 256, 3)
    body = block(body, 3, 512, 4)
    body = block(body, 3, 512, 5)
    flatten = sym.Flatten(body, name="flatten")
    fc6 = sym.FullyConnected(flatten, num_hidden=4096, name="fc6")
    relu6 = sym.Activation(fc6, act_type="relu", name="relu6")
    drop6 = sym.Dropout(relu6, p=0.5, name="drop6")
    fc7 = sym.FullyConnected(drop6, num_hidden=4096, name="fc7")
    relu7 = sym.Activation(fc7, act_type="relu", name="relu7")
    drop7 = sym.Dropout(relu7, p=0.5, name="drop7")
    fc8 = sym.FullyConnected(drop7, num_hidden=num_classes, name="fc8")
    return sym.SoftmaxOutput(fc8, name="softmax")
