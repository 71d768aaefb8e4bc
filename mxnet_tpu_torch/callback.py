"""Training callbacks of the port (``mxnet_tpu/callback.py``; parity:
python/mxnet/callback.py): ``do_checkpoint``, ``log_train_metric``,
``Speedometer`` and ``ProgressBar``.

Batch-end callbacks receive a ``module.BatchEndParam`` (``epoch``,
``nbatch``, ``eval_metric``); epoch-end callbacks receive ``(epoch,
symbol, arg_params, aux_params)``.  ``Speedometer(auto_reset=True)``
reports per-interval metric values; with ``auto_reset=False`` it reads
the metric (the fused path's host sync) only when the metric's
``update_stamp`` says it received updates since the last report.
``module_checkpoint`` saves through a ``Module`` (with its optimizer
states when asked).  With the perf plane armed (``MXTPU_PERF_ATTR``)
the Speedometer's line carries ``telemetry.perf.speedometer_suffix()``
(`` mfu=0.42 top=dispatch``: pure reads of the host ledgers, no device
sync).  Each completed Speedometer window sets the gauge
``speedometer_samples_per_sec`` and adds its samples to
``speedometer_samples_total`` (telemetry on), and its lines carry the
``[rank/size@g<generation>]`` prefix of ``parallel.dist.log_prefix``
while a process group spans several processes.
"""
from __future__ import annotations

import logging
import time

from . import telemetry as _tm

__all__ = ["module_checkpoint", "do_checkpoint", "log_train_metric",
           "Speedometer", "ProgressBar"]

# the Speedometer through the registry: the windowed samples/sec its
# line reports, scrapeable from /metrics
_TM_SPEED = _tm.gauge(
    "speedometer_samples_per_sec",
    "throughput of the last completed Speedometer window")
_TM_SPEED_SAMPLES = _tm.counter(
    "speedometer_samples_total",
    "samples covered by completed Speedometer windows")


def _log_prefix() -> str:
    """``[rank/size@g<generation>] `` in multi-process runs, so the
    workers' interleaved Speedometer lines stay attributable."""
    from .parallel import dist as _dist

    return _dist.log_prefix()


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Epoch-end callback calling ``mod.save_checkpoint(prefix, epoch,
    save_optimizer_states)`` every ``period`` epochs."""
    every = max(1, int(period))

    def _save(epoch, sym=None, arg=None, aux=None):
        done = epoch + 1
        if done % every == 0:
            mod.save_checkpoint(prefix, done, save_optimizer_states)

    return _save


def do_checkpoint(prefix, period=1):
    """Epoch-end callback writing ``prefix-symbol.json`` and
    ``prefix-NNNN.params`` (:func:`mxnet_tpu_torch.model.save_checkpoint`)
    every ``period`` epochs."""
    from .model import save_checkpoint

    every = max(1, int(period))

    def _save(epoch, sym, arg, aux):
        done = epoch + 1
        if done % every == 0:
            save_checkpoint(prefix, done, sym, arg, aux)

    return _save


def log_train_metric(period, auto_reset=False):
    """Log the training metric every ``period`` batches; with
    ``auto_reset`` each line covers only the batches since the last."""

    def _log(param):
        if param.nbatch % period != 0 or param.eval_metric is None:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                         param.epoch, param.nbatch, name, value)
        if auto_reset:
            param.eval_metric.reset_local()

    return _log


class Speedometer:
    """Batch-end callback logging samples/sec (and the metric) every
    ``frequent`` batches; the speed counts the batches actually elapsed
    since the last report."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self._mark = None  # (wall time, nbatch) at the last report
        self._last_stamp = None  # metric state at the last value report

    def __call__(self, param):
        now = time.time()
        if self._mark is None or param.nbatch < self._mark[1]:
            # first call of an epoch (nbatch restarted): a new window
            self._mark = (now, param.nbatch)
            return
        if param.nbatch % self.frequent != 0:
            return
        t0, b0 = self._mark
        elapsed, nbatches = now - t0, param.nbatch - b0
        if elapsed <= 0 or nbatches <= 0:
            self._mark = (now, param.nbatch)
            return
        speed = nbatches * self.batch_size / elapsed
        _TM_SPEED.set(speed)
        _TM_SPEED_SAMPLES.inc(nbatches * self.batch_size)
        # perf plane armed: " mfu=0.42 top=dispatch" rides the line
        perf_sfx = _tm.perf.speedometer_suffix()
        prefix = _log_prefix()
        metric = param.eval_metric
        if metric is None:
            logging.info("%sIter[%d] Batch [%d]\tSpeed: %.2f samples/sec%s",
                         prefix, param.epoch, param.nbatch, speed, perf_sfx)
        else:
            # reading the metric is the fused path's host sync: without
            # auto_reset, pay it only when the metric moved
            stamp_fn = getattr(metric, "update_stamp", None)
            stamp = stamp_fn() if stamp_fn is not None else None
            if (self.auto_reset or stamp_fn is None
                    or stamp != self._last_stamp):
                parts = "".join("\tTrain-%s=%f" % nv
                                for nv in metric.get_name_value())
                logging.info("%sEpoch[%d] Batch [%d]\tSpeed: %.2f "
                             "samples/sec%s%s", prefix, param.epoch,
                             param.nbatch, speed, perf_sfx, parts)
                if self.auto_reset:
                    # the local window only: the epoch-end log still
                    # covers the whole epoch
                    metric.reset_local()
                # re-stamp after the read, which drained the window
                self._last_stamp = (stamp_fn() if stamp_fn is not None
                                    else None)
            else:
                logging.info("%sEpoch[%d] Batch [%d]\tSpeed: %.2f "
                             "samples/sec%s", prefix, param.epoch,
                             param.nbatch, speed, perf_sfx)
        self._mark = (now, param.nbatch)


class ProgressBar:
    """Console progress bar over a known total number of batches."""

    def __init__(self, total, length=80):
        self.total = total
        self.length = length

    def __call__(self, param):
        frac = min(max(param.nbatch / float(self.total), 0.0), 1.0)
        fill = int(self.length * frac + 0.5)
        bar = "=" * fill + "-" * (self.length - fill)
        logging.info("[%s] %d%%", bar, int(frac * 100 + 0.999))
