"""Parallel runtime of the port (mirrors ``mxnet_tpu/parallel``).

The mesh and its shardings over ``DeviceMesh``/``DTensor`` (``mesh``),
the ring and Ulysses sequence parallelism and the single-device
attention dispatcher (``ring_attention``), pipeline parallelism over the
``pipe`` axis (``pipeline``: GPipe and 1F1B) and expert parallelism over
the ``expert`` axis (``moe``), the multi-process runtime over
``torch.distributed`` (``dist``: ranks, the mesh's process group,
``ppermute``, the barrier watchdog, generations) and the membership
coordinator (``coordinator``: leases, ``/cluster``, ``/fleet``)."""
from . import coordinator, dist, mesh, moe, pipeline  # noqa: F401
