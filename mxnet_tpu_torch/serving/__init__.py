"""Inference serving on PyTorch: continuous batching, int8 weights, a router.

The port of ``mxnet_tpu/serving``:

- :mod:`.scheduler` — slot-pool continuous batching over a
  ``KVDecoder``: one decode step per tick across all occupied slots,
  mid-flight slot reuse, bounded admission queue, deadlines; the
  ``serve_admit``, ``replica_kill`` and ``serve_slow`` fault sites.
- :mod:`.paged_kv` — paged KV cache: block-table indirection over a
  shared device page pool (``MXTPU_KV_BLOCK``) with prompt-prefix
  reuse (``MXTPU_PREFIX_CACHE``); the decode step's attention is the
  hand-written CUDA kernel of ``ops/paged_attention.py`` (or, by
  ``MXTPU_PAGED_KERNEL``, the gather or live-page-walk plain versions).
- :mod:`.server` — stdlib HTTP front-end (``POST /generate``,
  ``/healthz``, ``/metrics``, ``/metrics.json``, ``/spans.json``,
  ``/admin/drain|undrain``).
- :mod:`.router` — the fleet front: least-loaded balancing over N
  replicas (``MXTPU_SERVE_REPLICAS``), bounded idempotent retries,
  draining rolling upgrades, trace minting and the SLO plane
  (``GET /slo``, ``GET /fleet``).
- :mod:`.quantize` — per-channel symmetric int8 weights, dequantized
  where they are consumed, for ``KVDecoder(quantize="int8")`` and
  ``Predictor(quantize="int8")``.

``python -m mxnet_tpu_torch.serving`` runs a replica or a router.  The
paged step's attention schedule is searched by the autotuner at
``PagedSlots`` construction (``MXTPU_SCHEDULE_CACHE``), and the
scheduler feeds the perf plane and the flight ring.  Replicas
self-register with a coordinator (``register_replica``), and a router
given ``coordinator=`` folds them into its registry.
"""
from . import quantize  # noqa: F401
from .paged_kv import PagedSlots, PoolExhausted  # noqa: F401
from .quantize import QuantizedTensor, quantize_params  # noqa: F401
from .router import (  # noqa: F401
    NoReplicaAvailable, ReplicaDied, ReplicaRouter, ReplicaTimeout,
    RouterRetriesExhausted, register_replica, start_router,
)
from .scheduler import (  # noqa: F401
    AdmissionQueueFull, Request, SlotScheduler,
)
from .server import serve_decoder, start_server  # noqa: F401
