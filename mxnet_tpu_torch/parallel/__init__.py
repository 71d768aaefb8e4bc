"""Parallel runtime of the port (mirrors ``mxnet_tpu/parallel``).

Ported: the single-device attention dispatcher (``ring_attention``),
the multi-process runtime over ``torch.distributed`` (``dist``: ranks,
the barrier watchdog, generations) and the membership coordinator
(``coordinator``: leases, ``/cluster``, ``/fleet``).  The mesh toolkit,
the collective ``dist_sync``, the ring and Ulysses sequence parallelism,
pipeline and MoE wait for ROADMAP Queue 1 item 10b."""
from . import coordinator, dist  # noqa: F401
