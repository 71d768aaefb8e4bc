"""Parallel runtime of the port (mirrors ``mxnet_tpu/parallel``).

Ported: the mesh and its shardings over ``DeviceMesh``/``DTensor``
(``mesh``), the ring and Ulysses sequence parallelism and the
single-device attention dispatcher (``ring_attention``), the
multi-process runtime over ``torch.distributed`` (``dist``: ranks, the
mesh's process group, the barrier watchdog, generations) and the
membership coordinator (``coordinator``: leases, ``/cluster``,
``/fleet``).  Pipeline and MoE wait for ROADMAP Queue 1 item 10b."""
from . import coordinator, dist, mesh  # noqa: F401
