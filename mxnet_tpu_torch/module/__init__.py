"""The Module API of the port (``mxnet_tpu/module/``): ``Module`` over
one device, ``BucketingModule``, ``SequentialModule``, ``PythonModule``
and ``PythonLossModule``, ``BaseModule`` (``fit``, ``score``,
``predict``), the executor group, and ``BatchEndParam``/``_as_list``,
which the callbacks share."""
from .base_module import BaseModule, BatchEndParam, _as_list  # noqa: F401
from .executor_group import DataParallelExecutorGroup  # noqa: F401
from .module import Module  # noqa: F401
from .bucketing_module import BucketingModule  # noqa: F401
from .sequential_module import SequentialModule  # noqa: F401
from .python_module import PythonLossModule, PythonModule  # noqa: F401
