"""MLP (a copy of ``mxnet_tpu/models/mlp.py``; parity:
example/image-classification/symbols/mlp.py)."""
from .. import symbol as sym


def get_symbol(num_classes=10, **kwargs):
    data = sym.Variable("data")
    data = sym.Flatten(data)
    fc1 = sym.FullyConnected(data, name="fc1", num_hidden=128)
    act1 = sym.Activation(fc1, name="relu1", act_type="relu")
    fc2 = sym.FullyConnected(act1, name="fc2", num_hidden=64)
    act2 = sym.Activation(fc2, name="relu2", act_type="relu")
    fc3 = sym.FullyConnected(act2, name="fc3", num_hidden=num_classes)
    return sym.SoftmaxOutput(fc3, name="softmax")
