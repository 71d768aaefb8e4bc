"""What the port has of ``mxnet_tpu/module/base_module.py``:
``BatchEndParam``, the argument of batch-end callbacks, and
``_as_list``.  ``BaseModule`` and ``Module`` themselves are ROADMAP
Queue 1 item 6."""
from __future__ import annotations

from collections import namedtuple

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def _as_list(obj):
    if obj is None:
        return []
    return obj if isinstance(obj, list) else [obj]
