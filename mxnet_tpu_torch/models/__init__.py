"""Models of the port: the transformer LM's layout and its KV decoder,
the image-classification zoo, the unrolled LSTM language model
(``models.lstm``, which the dispatcher's table leaves out, as the
reference's does), and :func:`get_symbol`, the dispatcher of
``mxnet_tpu/models/__init__.py`` (parity:
example/image-classification/train_model.py).

Every builder of the reference's zoo is here; ``ssd-vgg16`` is SSD's
training graph (:func:`ssd.get_symbol_train`), as in the reference.  A
name neither package knows raises the reference's ``ValueError``."""
from . import (alexnet, decode, googlenet, inception_bn,  # noqa: F401
               inception_resnet, inception_v3, lenet, lstm, mlp, resnet,
               resnext, ssd, transformer, vgg)

# the reference's builder names
_BUILDERS = {
    "mlp": mlp.get_symbol, "lenet": lenet.get_symbol,
    "alexnet": alexnet.get_symbol, "vgg": vgg.get_symbol,
    "googlenet": googlenet.get_symbol,
    "inception-bn": inception_bn.get_symbol,
    "inception-v3": inception_v3.get_symbol,
    "inception-resnet-v2": inception_resnet.get_symbol,
    "resnet": resnet.get_symbol, "resnext": resnext.get_symbol,
    "ssd-vgg16": ssd.get_symbol_train,
    "transformer-lm": transformer.get_symbol,
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
    return _BUILDERS[name](num_classes, **kwargs)
