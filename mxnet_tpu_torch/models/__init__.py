"""Models of the port: the transformer LM's layout and its KV decoder,
and ResNet."""
from . import decode, resnet, transformer  # noqa: F401
