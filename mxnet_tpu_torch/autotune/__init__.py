"""Schedule autotuner of the port (mirrors ``mxnet_tpu/autotune``):
search over launch schedules per (kernel, shape signature, dtype,
device kind), winners persisted in the on-disk ``MXTPU_SCHEDULE_CACHE``
in the JAX package's layout.

Two halves with a hard purity line between them:

- :mod:`.cache` — the PURE lookup plane.  ``schedule_for`` is a dict
  read (no telemetry, no clock, no device); ``fingerprint`` is what
  ``executor._compiled_programs`` composes into the program-cache key
  so a new winner re-keys programs bound under the old one.
- :mod:`.search` — the measuring plane.  ``ensure`` runs the bounded
  search (``MXTPU_AUTOTUNE_TRIALS``) at bind/admit call sites only and
  owns the ``autotune_*`` telemetry families.

Consumers: the paged-attention CUDA kernel's split (``chunk_pages``;
gather against the pagewalk on the CPU) (``ops/paged_attention.py``,
tuned at ``PagedSlots`` construction) and the residual epilogue's
launch schedule (``{"threads", "blocks_per_sm"}``,
``ops/residual_epilogue.py:tune``).
"""
from .cache import (  # noqa: F401
    SCHEMA_VERSION, cache_spec, device_kind, fingerprint, load_file,
    prime, record, reset, schedule_for,
)
from .search import ScheduleRejected, ensure, measure, trials_budget  # noqa: F401
