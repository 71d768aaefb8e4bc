"""The Module API of the port (``mxnet_tpu/module/``).  Only what the
fused trainer's ``fit`` and the callbacks share is here so far:
``BatchEndParam`` and ``_as_list``.  ``Module``, ``BaseModule.fit`` and
the executor group are ROADMAP Queue 1 item 6."""
from .base_module import BatchEndParam, _as_list  # noqa: F401
