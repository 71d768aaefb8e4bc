"""The Module API of the port (``mxnet_tpu/module/``): ``Module`` over
one device, ``BucketingModule``, ``BaseModule`` (``fit``, ``score``,
``predict``), the executor group, and ``BatchEndParam``/``_as_list``,
which the callbacks share.  ``SequentialModule`` and ``PythonModule``
wait for ROADMAP Queue 1 item 6."""
from .base_module import BaseModule, BatchEndParam, _as_list  # noqa: F401
from .executor_group import DataParallelExecutorGroup  # noqa: F401
from .module import Module  # noqa: F401
from .bucketing_module import BucketingModule  # noqa: F401
