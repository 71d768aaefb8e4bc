"""Inference serving on PyTorch: continuous batching over a paged KV cache.

The port of ``mxnet_tpu/serving``'s replica path:

- :mod:`.scheduler` — slot-pool continuous batching over a
  ``KVDecoder``: one decode step per tick across all occupied slots,
  mid-flight slot reuse, bounded admission queue, deadlines.
- :mod:`.paged_kv` — paged KV cache: block-table indirection over a
  shared device page pool (``MXTPU_KV_BLOCK``) with prompt-prefix
  reuse (``MXTPU_PREFIX_CACHE``); the decode step's attention is the
  hand-written CUDA kernel of ``ops/paged_attention.py``.
- :mod:`.server` — stdlib HTTP front-end (``POST /generate``,
  ``/healthz``, ``/metrics``, ``/metrics.json``, ``/spans.json``,
  ``/admin/drain|undrain``).

Not ported yet: the router, int8 quantization, the autotuner.
"""
from .paged_kv import PagedSlots, PoolExhausted  # noqa: F401
from .scheduler import (  # noqa: F401
    AdmissionQueueFull, Request, SlotScheduler,
)
from .server import serve_decoder, start_server  # noqa: F401
