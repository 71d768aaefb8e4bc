"""Evaluation metrics of the port (``mxnet_tpu/metric.py``; parity:
python/mxnet/metric.py): ``Accuracy``, ``TopKAccuracy``, ``F1``,
``MAE``/``MSE``/``RMSE``, ``CrossEntropy``, ``Perplexity``, ``Loss``,
``Torch``, ``CustomMetric`` (and the ``np`` wrapper),
``CompositeEvalMetric`` and ``create``.

Two accumulation paths, as in the reference:

- **fused** (default): a metric with a ``_fused_delta(label, pred) ->
  (sum, num)`` written in tensor ops keeps its running window as two
  0-d fp32 tensors on the prediction's device.  ``update()`` only
  launches a few kernels (a label on the host is uploaded without a
  sync); the values reach the host when a reader (``get()``,
  ``get_name_value()``, ``reset_local()``) needs them.
  ``MXTPU_FUSED_METRICS=0`` turns it off.
- **eager**: the reference's host-numpy path, one device-to-host copy
  per (label, pred) pair; ``F1``, ``Torch`` and custom metrics always
  take it, and so does any input that is neither an NDArray nor a
  tensor.

Both paths share the accumulators, so they may interleave.  The local
window / global total split (``reset_local``, ``get_global``) and the
sync-free ``update_stamp`` that ``callback.Speedometer`` reads are the
reference's.  Not ported: the mesh-sharded (multi-device) fused path
(ROADMAP Queue 1 item 10b) and the metric telemetry (item 11).
"""
from __future__ import annotations

import os

import numpy as _np
import torch

from .base import MXNetError, parse_bool
from .ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "MAE", "MSE", "RMSE", "CrossEntropy", "Perplexity", "Loss",
           "Torch", "CustomMetric", "np", "create", "fused_metrics_enabled"]


def fused_metrics_enabled() -> bool:
    """``MXTPU_FUSED_METRICS`` (default on)."""
    return parse_bool(os.environ.get("MXTPU_FUSED_METRICS", "1"))


def _tensor(x):
    """The tensor behind a metric input (an NDArray's or the tensor
    itself), without a host sync; None for host data (numpy, lists)."""
    if isinstance(x, NDArray):
        return x.tensor
    if isinstance(x, torch.Tensor):
        return x
    return None


def _host(x):
    """A metric input as a numpy array (the eager path's sync)."""
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        t = x.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    return _np.asarray(x)


def check_label_shapes(labels, preds):
    if len(labels) != len(preds):
        raise MXNetError(f"label/pred count mismatch: {len(labels)} vs "
                         f"{len(preds)}")


class EvalMetric:
    """Base metric with a local window and carried global totals.

    Subclasses touch only ``sum_metric``/``num_inst`` (the local
    window).  ``reset_local()`` folds the window into the carried totals
    and clears it, so interval reporters (Speedometer's auto_reset)
    print per-window values while ``get_global_name_value()`` still
    covers everything since ``reset()``."""

    # subclasses override with a method in tensor ops; None: eager only
    _fused_delta = None

    def __init__(self, name, num=None):
        self.name = name
        self.num = num
        # bumped on every fused update: with the host accumulators it
        # forms update_stamp(), the sync-free "anything new?" token
        self._version = 0
        self.reset()

    def reset(self):
        # the device window is dropped, not read: reset forgets it all
        self._dev_sum = None
        self._dev_num = None
        if self.num is None:
            self.num_inst = 0
            self.sum_metric = 0.0
            self._carried_num = 0
            self._carried_sum = 0.0
        else:
            self.num_inst = [0] * self.num
            self.sum_metric = [0.0] * self.num
            self._carried_num = [0] * self.num
            self._carried_sum = [0.0] * self.num

    def reset_local(self):
        """Fold the current window into the global totals and clear it."""
        self._drain()
        if self.num is None:
            self._carried_num += self.num_inst
            self._carried_sum += self.sum_metric
            self.num_inst = 0
            self.sum_metric = 0.0
        else:
            for i in range(self.num):
                self._carried_num[i] += self.num_inst[i]
                self._carried_sum[i] += self.sum_metric[i]
            self.num_inst = [0] * self.num
            self.sum_metric = [0.0] * self.num

    # ------------------------------------------------------ fused path
    def _fused_accumulate(self, label, pred) -> bool:
        """Fold one (label, pred) pair into the device window, with no
        host sync.  False (the caller runs its eager body) when fused
        metrics are off, the metric has no fused form or several
        accumulators, or the prediction is host data."""
        if (self.num is not None or self._fused_delta is None
                or not fused_metrics_enabled()):
            return False
        p = _tensor(pred)
        if p is None:
            return False
        if label is None:
            lab = None  # label-free metrics (Loss) ignore it
        else:
            lab = _tensor(label)
            if lab is None:
                return False
            if lab.device != p.device:
                lab = lab.to(p.device, non_blocking=True)
        with torch.no_grad():
            ds, dn = self._fused_delta(lab, p.detach())
            if self._dev_sum is None or self._dev_sum.device != p.device:
                self._drain()
                self._dev_sum = torch.zeros((), dtype=torch.float32,
                                            device=p.device)
                self._dev_num = torch.zeros((), dtype=torch.float32,
                                            device=p.device)
            self._dev_sum += ds
            self._dev_num += dn
        self._version += 1
        return True

    def _drain(self):
        """Fold the device window into the host accumulators: the one
        device-to-host sync of the fused path."""
        if self._dev_sum is None:
            return
        pair = torch.stack([self._dev_sum, self._dev_num]).cpu().tolist()
        self._dev_sum = None
        self._dev_num = None
        self.sum_metric += pair[0]
        n = pair[1]
        # eager counts are ints (len(label)); keep that type when exact
        self.num_inst += int(n) if float(n).is_integer() else n

    def update_stamp(self):
        """A sync-free token that changes whenever this metric received
        updates (Speedometer's "values needed" guard)."""

        def _t(v):
            return tuple(v) if isinstance(v, list) else v

        return (self._version, _t(self.num_inst), _t(self.sum_metric))

    def update(self, labels, preds):
        raise NotImplementedError

    def _value(self, s, n):
        """Accumulators -> the reported value (Perplexity overrides)."""
        return s / n if n else float("nan")

    def get(self):
        self._drain()
        if self.num is None:
            return (self.name, self._value(self.sum_metric, self.num_inst))
        names = [f"{self.name}_{i}" for i in range(self.num)]
        values = [self._value(s, n)
                  for s, n in zip(self.sum_metric, self.num_inst)]
        return (names, values)

    def get_global(self):
        self._drain()
        if self.num is None:
            return (self.name,
                    self._value(self._carried_sum + self.sum_metric,
                                self._carried_num + self.num_inst))
        names = [f"{self.name}_{i}" for i in range(self.num)]
        values = [self._value(cs + s, cn + n)
                  for cs, s, cn, n in zip(self._carried_sum, self.sum_metric,
                                          self._carried_num, self.num_inst)]
        return (names, values)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            return [(name, value)]
        return list(zip(name, value))

    def get_global_name_value(self):
        name, value = self.get_global()
        if not isinstance(name, list):
            return [(name, value)]
        return list(zip(name, value))


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite"):
        super().__init__(name)
        self.metrics = metrics or []

    def add(self, metric):
        self.metrics.append(metric)

    def reset(self):
        self._dev_sum = None
        self._dev_num = None
        for m in getattr(self, "metrics", []):
            m.reset()

    def reset_local(self):
        for m in self.metrics:
            m.reset_local()

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def update_stamp(self):
        return tuple(m.update_stamp() for m in self.metrics)

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.append(n)
            values.append(v)
        return (names, values)

    def get_global(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get_global()
            names.append(n)
            values.append(v)
        return (names, values)


class Accuracy(EvalMetric):
    """Argmax over axis 1 when the prediction has one more axis than the
    label; ``ignore_label`` entries leave both counts."""

    def __init__(self, ignore_label=None):
        super().__init__("accuracy")
        self.ignore_label = ignore_label

    def _fused_delta(self, label, pred):
        label = label.to(torch.int32)
        if pred.ndim > 1 and pred.shape != label.shape:
            pred = pred.argmax(dim=1)
        pred = pred.to(torch.int32).reshape(-1)
        label = label.reshape(-1)
        if self.ignore_label is not None:
            keep = label != self.ignore_label
            return (((pred == label) & keep).sum().float(),
                    keep.sum().float())
        return (pred == label).sum().float(), float(label.numel())

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            if self._fused_accumulate(label, pred):
                continue
            pred_np = _host(pred)
            label_np = _host(label).astype(_np.int32)
            if pred_np.ndim > 1 and pred_np.shape != label_np.shape:
                pred_np = pred_np.argmax(axis=1)
            pred_np = pred_np.astype(_np.int32).reshape(-1)
            label_np = label_np.reshape(-1)
            if self.ignore_label is not None:
                keep = label_np != self.ignore_label
                pred_np, label_np = pred_np[keep], label_np[keep]
            self.sum_metric += float((pred_np == label_np).sum())
            self.num_inst += len(label_np)


class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1):
        super().__init__(f"top_k_accuracy_{top_k}")
        self.top_k = top_k

    def _fused_delta(self, label, pred):
        label = label.to(torch.int64).reshape(-1)
        # argsort of -pred, as the reference ranks (stable: ties keep
        # the lower class first)
        top = torch.argsort(-pred, dim=1, stable=True)[:, :self.top_k]
        hits = (top == label[:, None]).any(dim=1).sum()
        return hits.float(), float(label.numel())

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            if self._fused_accumulate(label, pred):
                continue
            pred_np = _host(pred)
            label_np = _host(label).astype(_np.int32).reshape(-1)
            argsorted = _np.argsort(-pred_np, axis=1)[:, :self.top_k]
            self.sum_metric += float(
                (argsorted == label_np[:, None]).any(axis=1).sum())
            self.num_inst += len(label_np)


class F1(EvalMetric):
    """Binary F1, eager only: the per-batch F1 is not a (sum, num)
    fold."""

    def __init__(self):
        super().__init__("f1")

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            pred_np = _host(pred)
            label_np = _host(label).astype(_np.int32).reshape(-1)
            if pred_np.ndim > 1:
                pred_np = pred_np.argmax(axis=1)
            pred_np = pred_np.astype(_np.int32).reshape(-1)
            tp = float(((pred_np == 1) & (label_np == 1)).sum())
            fp = float(((pred_np == 1) & (label_np == 0)).sum())
            fn = float(((pred_np == 0) & (label_np == 1)).sum())
            precision = tp / (tp + fp) if tp + fp > 0 else 0.0
            recall = tp / (tp + fn) if tp + fn > 0 else 0.0
            f1 = (2 * precision * recall / (precision + recall)
                  if precision + recall > 0 else 0.0)
            self.sum_metric += f1
            self.num_inst += 1


class _Regression(EvalMetric):
    """MAE / MSE / RMSE: one value per (label, pred) pair, averaged over
    pairs; the label is reshaped to the prediction's shape."""

    def _err(self, diff):
        raise NotImplementedError

    def _fused_delta(self, label, pred):
        return self._err(label.reshape(pred.shape) - pred).float(), 1.0

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            if self._fused_accumulate(label, pred):
                continue
            p = _host(pred)
            lab = _host(label)
            self.sum_metric += float(self._err(lab.reshape(p.shape) - p))
            self.num_inst += 1


class MAE(_Regression):
    def __init__(self):
        super().__init__("mae")

    def _err(self, diff):
        return abs(diff).mean()


class MSE(_Regression):
    def __init__(self):
        super().__init__("mse")

    def _err(self, diff):
        return (diff ** 2).mean()


class RMSE(_Regression):
    def __init__(self):
        super().__init__("rmse")

    def _err(self, diff):
        return (diff ** 2).mean() ** 0.5


class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-8):
        super().__init__("cross-entropy")
        self.eps = eps

    def _fused_delta(self, label, pred):
        label = label.to(torch.int64).reshape(-1)
        prob = pred.gather(1, label[:, None])[:, 0]
        return ((-torch.log(prob + self.eps)).sum().float(),
                float(label.shape[0]))

    def update(self, labels, preds):
        for label, pred in zip(labels, preds):
            if self._fused_accumulate(label, pred):
                continue
            label_np = _host(label).astype(_np.int32).reshape(-1)
            pred_np = _host(pred)
            prob = pred_np[_np.arange(label_np.shape[0]), label_np]
            self.sum_metric += float((-_np.log(prob + self.eps)).sum())
            self.num_inst += label_np.shape[0]


class Perplexity(EvalMetric):
    """exp(mean NLL); ``ignore_label`` entries (padding) are left out."""

    def __init__(self, ignore_label=None, axis=-1):
        super().__init__("Perplexity")
        self.ignore_label = ignore_label
        self.axis = axis

    def _fused_delta(self, label, pred):
        label = label.to(torch.int64).reshape(-1)
        if self.axis not in (-1, pred.ndim - 1):
            pred = torch.movedim(pred, self.axis, -1)
        pred = pred.reshape(label.shape[0], -1)
        idx = label.clamp(0, pred.shape[1] - 1)
        prob = pred.gather(1, idx[:, None])[:, 0]
        nll = -torch.log(torch.clamp_min(prob, 1e-10))
        if self.ignore_label is not None:
            mask = label != self.ignore_label
            return (nll * mask).sum().float(), mask.sum().float()
        return nll.sum().float(), float(label.shape[0])

    def update(self, labels, preds):
        fused_all = True
        loss, num = 0.0, 0
        for label, pred in zip(labels, preds):
            if self._fused_accumulate(label, pred):
                continue
            fused_all = False
            label_np = _host(label).astype(_np.int32).reshape(-1)
            pred_np = _host(pred)
            if self.axis not in (-1, pred_np.ndim - 1):
                pred_np = _np.moveaxis(pred_np, self.axis, -1)
            pred_np = pred_np.reshape(label_np.shape[0], -1)
            prob = pred_np[_np.arange(label_np.shape[0]),
                           _np.clip(label_np, 0, pred_np.shape[1] - 1)]
            mask = _np.ones_like(prob, dtype=bool)
            if self.ignore_label is not None:
                mask = label_np != self.ignore_label
            loss += float(-_np.log(_np.maximum(prob[mask], 1e-10)).sum())
            num += int(mask.sum())
        if not fused_all:
            self.sum_metric += loss
            self.num_inst += num

    def _value(self, s, n):
        return float(_np.exp(s / n)) if n else float("nan")


class Loss(EvalMetric):
    """Mean of the raw loss outputs; labels are ignored."""

    def __init__(self, name="loss"):
        super().__init__(name)

    def _fused_delta(self, label, pred):
        return pred.sum().float(), float(pred.numel())

    def update(self, labels, preds):
        for pred in preds:
            if self._fused_accumulate(None, pred):
                continue
            pred_np = _host(pred)
            self.sum_metric += float(pred_np.sum())
            self.num_inst += pred_np.size


class Torch(EvalMetric):
    """Average of the predictions' means, once per update."""

    def __init__(self, name="torch"):
        super().__init__(name)

    def update(self, labels, preds):
        for pred in preds:
            self.sum_metric += float(_host(pred).mean())
        self.num_inst += 1


class CustomMetric(EvalMetric):
    """``feval(label_np, pred_np)`` -> a value or a ``(sum, num)`` pair,
    on host arrays."""

    def __init__(self, feval, name=None, allow_extra_outputs=False):
        super().__init__(name or getattr(feval, "__name__", "custom"))
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            res = self._feval(_host(label), _host(pred))
            if isinstance(res, tuple):
                s, n = res
                self.sum_metric += s
                self.num_inst += n
            else:
                self.sum_metric += res
                self.num_inst += 1


def np(numpy_feval=None, name=None, allow_extra_outputs=False):
    """Wrap a numpy function as a metric: ``np(f)``, ``@np`` or
    ``@np(name=...)``."""
    if callable(numpy_feval):
        return CustomMetric(numpy_feval, name, allow_extra_outputs)

    def deco(feval):
        return CustomMetric(feval, name, allow_extra_outputs)

    return deco


_METRICS = {
    "acc": Accuracy, "accuracy": Accuracy, "f1": F1, "mae": MAE,
    "mse": MSE, "rmse": RMSE, "ce": CrossEntropy,
    "cross-entropy": CrossEntropy, "torch": Torch, "loss": Loss,
    "perplexity": Perplexity,
}


def create(metric, **kwargs):
    """A metric from a name, a list of names, a callable or a metric."""
    if callable(metric) and not isinstance(metric, EvalMetric):
        return CustomMetric(metric, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        comp = CompositeEvalMetric()
        for m in metric:
            comp.add(create(m, **kwargs))
        return comp
    if isinstance(metric, str):
        if metric.startswith("top_k_accuracy"):
            parts = metric.split("_")
            return (TopKAccuracy(top_k=int(parts[-1]))
                    if parts[-1].isdigit() else TopKAccuracy())
        if metric.lower() in _METRICS:
            return _METRICS[metric.lower()](**kwargs)
    raise MXNetError(f"unknown metric {metric}")
