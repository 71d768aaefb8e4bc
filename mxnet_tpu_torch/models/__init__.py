"""Models of the port: the transformer LM's layout and its KV decoder,
the image-classification zoo, the unrolled LSTM language model
(``models.lstm``, which the dispatcher's table leaves out, as the
reference's does), and :func:`get_symbol`, the dispatcher of
``mxnet_tpu/models/__init__.py`` (parity:
example/image-classification/train_model.py).

Every builder of the reference's zoo is here but ``ssd-vgg16``, which
raises "not ported yet" (it waits for the vision ops, ROADMAP Queue 1
item 11); a name neither package knows raises the reference's
``ValueError``."""
from ..base import MXNetError
from . import (alexnet, decode, googlenet, inception_bn,  # noqa: F401
               inception_resnet, inception_v3, lenet, lstm, mlp, resnet,
               resnext, transformer, vgg)

# the reference's builder names; None marks a builder not ported yet
_BUILDERS = {
    "mlp": mlp.get_symbol, "lenet": lenet.get_symbol,
    "alexnet": alexnet.get_symbol, "vgg": vgg.get_symbol,
    "googlenet": googlenet.get_symbol,
    "inception-bn": inception_bn.get_symbol,
    "inception-v3": inception_v3.get_symbol,
    "inception-resnet-v2": inception_resnet.get_symbol,
    "resnet": resnet.get_symbol, "resnext": resnext.get_symbol,
    "ssd-vgg16": None, "transformer-lm": transformer.get_symbol,
}


def get_symbol(name, num_classes=1000, **kwargs):
    """The Symbol of model ``name`` (``resnet-50``, ``inception-v3``,
    ``transformer-lm``, ...) ending in a SoftmaxOutput named
    ``softmax``."""
    if name.startswith("resnet-"):
        return resnet.get_symbol(num_classes,
                                 num_layers=int(name.split("-")[1]), **kwargs)
    if name.startswith("resnext-"):
        return resnext.get_symbol(num_classes,
                                  num_layers=int(name.split("-")[1]),
                                  **kwargs)
    if name not in _BUILDERS:
        raise ValueError(f"unknown model {name}; have {sorted(_BUILDERS)}")
    if _BUILDERS[name] is None:
        raise MXNetError(f"models.get_symbol({name!r}): the {name} builder "
                         "is not ported yet (ROADMAP Queue 1 item 6, after "
                         "the vision ops of item 11)")
    return _BUILDERS[name](num_classes, **kwargs)
