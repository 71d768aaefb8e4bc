"""AlexNet (a copy of ``mxnet_tpu/models/alexnet.py``; parity:
example/image-classification/symbols/alexnet.py)."""
from .. import symbol as sym


def get_symbol(num_classes=1000, **kwargs):
    input_data = sym.Variable("data")
    # stage 1
    conv1 = sym.Convolution(input_data, kernel=(11, 11), stride=(4, 4),
                            num_filter=96, name="conv1")
    relu1 = sym.Activation(conv1, act_type="relu")
    pool1 = sym.Pooling(relu1, pool_type="max", kernel=(3, 3), stride=(2, 2))
    lrn1 = sym.LRN(pool1, alpha=0.0001, beta=0.75, knorm=1, nsize=5)
    # stage 2
    conv2 = sym.Convolution(lrn1, kernel=(5, 5), pad=(2, 2), num_filter=256,
                            name="conv2")
    relu2 = sym.Activation(conv2, act_type="relu")
    pool2 = sym.Pooling(relu2, kernel=(3, 3), stride=(2, 2), pool_type="max")
    lrn2 = sym.LRN(pool2, alpha=0.0001, beta=0.75, knorm=1, nsize=5)
    # stage 3
    conv3 = sym.Convolution(lrn2, kernel=(3, 3), pad=(1, 1), num_filter=384,
                            name="conv3")
    relu3 = sym.Activation(conv3, act_type="relu")
    conv4 = sym.Convolution(relu3, kernel=(3, 3), pad=(1, 1), num_filter=384,
                            name="conv4")
    relu4 = sym.Activation(conv4, act_type="relu")
    conv5 = sym.Convolution(relu4, kernel=(3, 3), pad=(1, 1), num_filter=256,
                            name="conv5")
    relu5 = sym.Activation(conv5, act_type="relu")
    pool3 = sym.Pooling(relu5, kernel=(3, 3), stride=(2, 2), pool_type="max")
    # stage 4
    flatten = sym.Flatten(pool3)
    fc1 = sym.FullyConnected(flatten, num_hidden=4096, name="fc1")
    relu6 = sym.Activation(fc1, act_type="relu")
    dropout1 = sym.Dropout(relu6, p=0.5)
    # stage 5
    fc2 = sym.FullyConnected(dropout1, num_hidden=4096, name="fc2")
    relu7 = sym.Activation(fc2, act_type="relu")
    dropout2 = sym.Dropout(relu7, p=0.5)
    # stage 6
    fc3 = sym.FullyConnected(dropout2, num_hidden=num_classes, name="fc3")
    return sym.SoftmaxOutput(fc3, name="softmax")
