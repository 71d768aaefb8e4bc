"""mxnet_tpu_torch: the PyTorch/CUDA port of mxnet_tpu.

A second package beside ``mxnet_tpu`` (the JAX reference, which it never
imports).  Plain tensor code is PyTorch; every kernel the JAX package
wrote in Pallas becomes a hand-written CUDA kernel for Hopper (sm_90a),
with a plain PyTorch version beside it for CPU tensors.

Ported so far: the paged decode-serving path — ``models.decode.
KVDecoder``, ``serving.PagedSlots``/``SlotScheduler``/``serve_decoder``
and the paged decode-attention kernel ``ops.paged_attention`` — and the
transformer-LM training step — ``models.transformer.transformer_lm``
over ``symbol``/``executor``/``ops``, ``trainer.FusedTrainer`` and the
flash-attention forward, dQ and dK/dV kernels ``ops.flash_attention``.

Entry points run on the card unless the caller passes ``device="cpu"``;
with no card and no explicit device they raise :class:`MXNetError`.
"""
from . import context, telemetry  # noqa: F401
from .base import MXNetError, __version__  # noqa: F401
from .context import cpu, gpu, resolve_device  # noqa: F401
