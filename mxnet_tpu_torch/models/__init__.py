"""Models of the port: the transformer LM's layout and its KV decoder,
ResNet, the MLP and LeNet, and :func:`get_symbol`, the dispatcher of
``mxnet_tpu/models/__init__.py`` (parity:
example/image-classification/train_model.py).

The reference's zoo names every builder below; the port has ResNet,
the transformer LM, the MLP and LeNet so far.  The rest raise "not ported yet" (ROADMAP
Queue 1 item 6), and a name neither package knows raises the
reference's ``ValueError``."""
from ..base import MXNetError
from . import decode, lenet, mlp, resnet, transformer  # noqa: F401

# the reference's builder names; None marks a builder not ported yet
_BUILDERS = {
    "mlp": mlp.get_symbol, "lenet": lenet.get_symbol, "alexnet": None, "vgg": None,
    "googlenet": None, "inception-bn": None, "inception-v3": None,
    "inception-resnet-v2": None, "resnet": resnet.get_symbol,
    "resnext": None, "ssd-vgg16": None,
    "transformer-lm": transformer.get_symbol,
}


def _not_ported(name):
    return MXNetError(f"models.get_symbol({name!r}): the {name} builder is "
                      "not ported yet (ROADMAP Queue 1 item 6)")


def get_symbol(name, num_classes=1000, **kwargs):
    """The Symbol of model ``name`` (``resnet-50``, ``transformer-lm``,
    ...) ending in a SoftmaxOutput named ``softmax``."""
    if name.startswith("resnet-"):
        return resnet.get_symbol(num_classes,
                                 num_layers=int(name.split("-")[1]), **kwargs)
    if name.startswith("resnext-"):
        raise _not_ported(name)
    if name not in _BUILDERS:
        raise ValueError(f"unknown model {name}; have {sorted(_BUILDERS)}")
    if _BUILDERS[name] is None:
        raise _not_ported(name)
    return _BUILDERS[name](num_classes, **kwargs)
