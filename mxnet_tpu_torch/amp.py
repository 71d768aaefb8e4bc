"""Automatic mixed precision of the port (``mxnet_tpu/amp.py``): the
policy, fp32 master weights and dynamic loss scaling for the
Module/Executor/KVStore path.

- ``MXTPU_AMP=bf16`` arms the ``amp_cast`` graph pass
  (``passes/amp_cast.py``): the tensor-core ops compute in bf16 through
  inserted ``Cast`` nodes, and softmax, the losses and whole-tensor
  reductions are cast back to fp32.  Unset, the pass returns the symbol
  object itself.
- fp32 **master weights**: a bf16/fp16 parameter whose optimizer opted
  in (``multi_precision``), or any under ``MXTPU_AMP``, carries an fp32
  master as the last optimizer-state slot; a low-precision weight that
  updates without one warns once (:func:`warn_no_master`).
- **dynamic loss scaling** (``MXTPU_LOSS_SCALE``, off by default; it
  rides the AMP policy): the scale is a 0-d fp32 tensor on the bind's
  device.  The executor multiplies each gradient by it after the
  backward (MXNet's loss ops discard the head gradient, so scaling the
  seed would not reach the graph); the bucketed kvstore update takes
  the merged gradient's finite flag, unscales and selects the old or
  the new weights and states by the flag (the skip-step), and
  :meth:`LossScaler.end_step` folds the step's flags into the scale
  with ``torch.where`` alone: halve (to at least 1) on an overflow,
  double (to at most 2^24) after ``MXTPU_LOSS_SCALE_WINDOW`` clean
  steps.  Scale, clean-step count and the two counters stay on the
  device; only :meth:`LossScaler.report` reads them, and counts each
  read in ``_sync_count``.  The eager ``Updater`` only unscales
  (:func:`maybe_unscale_grad`); it has no skip-step, as in the
  reference.
"""
from __future__ import annotations

import os
import threading
import warnings

import torch

from . import telemetry as _tm
from .base import MXNetError, numeric_dtype

__all__ = [
    "amp_enabled", "amp_dtype", "master_weights_wanted", "is_low_precision",
    "loss_scale_config", "scaling_active", "global_scaler", "reset_scaler",
    "LossScaler", "warn_no_master", "maybe_unscale_grad",
]

# --- telemetry families (the JAX package's "AMP" families) -----------------
_TM_SCALE = _tm.gauge(
    "amp_loss_scale",
    "current dynamic loss scale (mirrored from the device scalar at "
    "reporting boundaries — LossScaler.report(); never per step)")
_TM_OVERFLOW = _tm.counter(
    "amp_overflow_total",
    "optimizer steps on which a bucket saw a non-finite scaled gradient "
    "(device-accumulated; mirrored at reporting boundaries)")
_TM_CAST_NODES = _tm.counter(
    "amp_cast_nodes_total",
    "Cast nodes the amp_cast graph pass inserted into bound graphs "
    "(bind-time, host-side count)")
_TM_SKIPPED = _tm.counter(
    "amp_skipped_steps_total",
    "optimizer steps the loss-scale lattice skipped (weights/state held) "
    "— device-accumulated, mirrored at reporting boundaries")

_LOW_PRECISION = (torch.bfloat16, torch.float16)

_DEFAULT_INIT_SCALE = float(2 ** 15)
_DEFAULT_WINDOW = 2000
_MIN_SCALE = 1.0
_MAX_SCALE = float(2 ** 24)


def amp_enabled() -> bool:
    """``MXTPU_AMP`` gate: off by default, ``bf16`` enables."""
    return amp_dtype() is not None


def amp_dtype():
    """``torch.bfloat16`` when ``MXTPU_AMP`` asks for bf16, None when it
    is unset or off; an unknown value raises rather than quietly
    training in full precision."""
    raw = os.environ.get("MXTPU_AMP", "").strip().lower()
    if raw in ("", "0", "off", "false", "no", "none"):
        return None
    if raw in ("bf16", "bfloat16", "1", "on", "true", "yes"):
        return torch.bfloat16
    raise MXNetError(f"MXTPU_AMP={raw!r}: unknown AMP policy (supported: "
                     "'bf16', '0'/'off')")


def is_low_precision(dtype) -> bool:
    return numeric_dtype(dtype) in _LOW_PRECISION


def master_weights_wanted(optimizer, weight_dtype) -> bool:
    """Does a weight of ``weight_dtype`` updated by ``optimizer`` carry
    an fp32 master?  Yes for a low-precision weight when the optimizer
    asks (``multi_precision=True``) or ``MXTPU_AMP`` is on."""
    if not is_low_precision(weight_dtype):
        return False
    return bool(getattr(optimizer, "multi_precision", False)) \
        or amp_enabled()


_warned_no_master = set()


def warn_no_master(name):
    """Warn once per key when a low-precision weight updates without an
    fp32 master: bf16 keeps about 8 mantissa bits, and small updates
    round away."""
    key = str(name)
    if key in _warned_no_master:
        return
    _warned_no_master.add(key)
    warnings.warn(
        f"parameter {key!r} has a low-precision dtype but updates "
        "WITHOUT fp32 master weights — small updates will round away. "
        "Pass multi_precision=True to the optimizer (or set "
        "MXTPU_AMP=bf16) to keep fp32 masters.", stacklevel=3)


def count_cast_nodes(n: int):
    if n > 0 and _tm.enabled():
        _TM_CAST_NODES.inc(n)


# ---------------------------------------------------------------------------
# dynamic loss scaling
# ---------------------------------------------------------------------------
def loss_scale_config():
    """``(initial_scale, window)`` from ``MXTPU_LOSS_SCALE`` and
    ``MXTPU_LOSS_SCALE_WINDOW``, or None when loss scaling is off.

    ``MXTPU_LOSS_SCALE``: ``0``/``off`` (default) disables; ``dynamic``
    starts at 2^15; a number is the initial scale.  The schedule is
    always dynamic: halve on overflow, double after ``window``
    (default 2000) consecutive clean steps."""
    raw = os.environ.get("MXTPU_LOSS_SCALE", "").strip().lower()
    if raw in ("", "0", "off", "false", "no", "none"):
        return None
    if raw in ("1", "on", "true", "yes", "dynamic", "default"):
        init = _DEFAULT_INIT_SCALE
    else:
        try:
            init = float(raw)
        except ValueError:
            raise MXNetError(
                f"MXTPU_LOSS_SCALE={raw!r}: expected a number, "
                "'dynamic', or '0'/'off'") from None
        if not init > 0:
            raise MXNetError("MXTPU_LOSS_SCALE must be > 0")
    try:
        window = int(os.environ.get("MXTPU_LOSS_SCALE_WINDOW",
                                    str(_DEFAULT_WINDOW)))
    except ValueError:
        window = _DEFAULT_WINDOW
    return init, max(window, 1)


def scaling_active() -> bool:
    """Loss scaling rides the AMP policy: both knobs must be on."""
    return amp_enabled() and loss_scale_config() is not None


class LossScaler:
    """Dynamic loss scaler whose state is four 0-d tensors on one device
    (fp32 scale; int32 clean-step count, overflows and skips).

    The per-step path (:meth:`scale_raw`, :meth:`inv_scale_raw`,
    :meth:`end_step`) reads none of them back; :meth:`report` does, and
    counts the read in ``_sync_count``."""

    def __init__(self, init_scale=None, window=None):
        cfg = loss_scale_config()
        if init_scale is None:
            init_scale = cfg[0] if cfg else _DEFAULT_INIT_SCALE
        if window is None:
            window = cfg[1] if cfg else _DEFAULT_WINDOW
        self.window = int(window)
        self._lock = threading.Lock()
        self._sync_count = 0
        self._reported_overflows = 0
        self._reported_skipped = 0
        # made on the CPU; place() moves them to the device that uses them
        self._scale = torch.full((), float(init_scale), dtype=torch.float32)
        self._good = torch.zeros((), dtype=torch.int32)
        self._overflows = torch.zeros((), dtype=torch.int32)
        self._skipped = torch.zeros((), dtype=torch.int32)

    def place(self, device):
        """Move the state to ``device`` (the executor does it at bind, the
        two update routes before they use it; a no-op where the state
        already lies)."""
        with self._lock:
            self._scale, self._good, self._overflows, self._skipped = (
                t.to(device) for t in (self._scale, self._good,
                                       self._overflows, self._skipped))

    # ------------------------------------------------------------- hot path
    def scale_raw(self) -> torch.Tensor:
        """The scale, a 0-d fp32 tensor on the scaler's device."""
        return self._scale

    def inv_scale_raw(self) -> torch.Tensor:
        """``1 / scale`` in fp32, on the scaler's device."""
        return 1.0 / self._scale

    def end_step(self, flags):
        """Fold one optimizer step's finite flags (0-d bool tensors, one
        per bucket) into the scale lattice, on the device."""
        if not flags:
            return
        with self._lock:
            scale, good = self._scale, self._good
            fin = torch.stack([f.to(scale.device) for f in flags]).all()
            grown = torch.clamp(scale * 2.0, max=_MAX_SCALE)
            shrunk = torch.clamp(scale * 0.5, min=_MIN_SCALE)
            hit = good + 1 >= self.window
            self._scale = torch.where(fin, torch.where(hit, grown, scale),
                                      shrunk)
            self._good = torch.where(fin, torch.where(hit, 0, good + 1), 0)
            bad = (~fin).to(torch.int32)
            self._overflows = self._overflows + bad
            self._skipped = self._skipped + bad

    # ------------------------------------------------------ boundary reads
    def report(self) -> dict:
        """Read the device state (the one host read, counted in
        ``_sync_count``), mirror it into the ``amp_*`` telemetry
        families and return it."""
        with self._lock:
            self._sync_count += 1
            snap = {
                "scale": float(self._scale.item()),
                "good_steps": int(self._good.item()),
                "overflow_total": int(self._overflows.item()),
                "skipped_steps_total": int(self._skipped.item()),
                "window": self.window,
            }
            if _tm.enabled():
                _TM_SCALE.set(snap["scale"])
                d_over = snap["overflow_total"] - self._reported_overflows
                d_skip = snap["skipped_steps_total"] - self._reported_skipped
                if d_over > 0:
                    _TM_OVERFLOW.inc(d_over)
                if d_skip > 0:
                    _TM_SKIPPED.inc(d_skip)
            self._reported_overflows = snap["overflow_total"]
            self._reported_skipped = snap["skipped_steps_total"]
        return snap


_scaler = None
_scaler_lock = threading.Lock()


def global_scaler() -> LossScaler:
    """The process-wide scaler (made on first use from the env knobs)."""
    global _scaler
    with _scaler_lock:
        if _scaler is None:
            _scaler = LossScaler()
        return _scaler


def reset_scaler():
    """Drop the process scaler and the warn-once keys (the next use
    reads the env again)."""
    global _scaler
    with _scaler_lock:
        _scaler = None
    _warned_no_master.clear()


def maybe_unscale_grad(grad):
    """The eager ``Updater``'s unscale: ``grad * (1 / scale)`` (the
    reciprocal in fp32, cast to the gradient's dtype) as a new NDArray —
    of a row-sparse gradient, its value rows — the caller's gradient
    untouched; ``grad`` itself when loss scaling is off."""
    if not scaling_active():
        return grad
    from .ndarray import NDArray

    scaler = global_scaler()
    if getattr(grad, "stype", "default") == "row_sparse":
        from .sparse import RowSparseNDArray

        vals = grad.data.tensor
        scaler.place(vals.device)
        return RowSparseNDArray(grad.indices, vals * scaler.inv_scale_raw()
                                .to(vals.dtype), grad.shape)
    raw = grad.tensor if isinstance(grad, NDArray) else grad
    scaler.place(raw.device)  # a no-op after a bind on this device
    return NDArray(raw * scaler.inv_scale_raw().to(raw.dtype))
