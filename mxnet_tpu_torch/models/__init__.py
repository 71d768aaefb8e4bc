"""Models of the port: the transformer LM's layout and its KV decoder."""
from . import decode, transformer  # noqa: F401
