"""``BaseModule`` of the port (mirrors
``mxnet_tpu/module/base_module.py``; parity:
python/mxnet/module/base_module.py): ``forward_backward``, ``score``,
``iter_predict``, ``predict`` and ``fit``, with ``BatchEndParam`` and
``_as_list``, which the fused trainer's ``fit`` and the callbacks share.

``fit`` is the reference's loop — ``forward_backward``, ``update``,
``update_metric`` per batch — with fused metrics and the
:class:`~mxnet_tpu_torch.engine.AsyncWindow`: the loop makes no host
sync per batch and waits only when the window is full and at the epoch
boundary.  ``monitor=`` installs a ``monitor.Monitor`` and brackets
each batch with its ``tic``/``toc_print``: the monitor reads its
statistics to the host only on the batches of its windows.

Checkpoints (:mod:`mxnet_tpu_torch.checkpoint`): ``checkpoint=`` (a
``CheckpointManager`` or a directory; default ``MXTPU_CKPT_DIR`` with
``MXTPU_CKPT_EVERY``) snapshots the module's training state every N
steps through its checkpoint provider (``Module._checkpoint_arrays``),
behind the queued steps and without a host sync; SIGTERM leads to a
boundary checkpoint and ``checkpoint.Preempted``; a terminal checkpoint
follows the last epoch.  ``resume=True`` (or a path) restores the newest
complete checkpoint, then skips the batches its cursor already trained,
so the run continues step for step.  A module without a provider
(``BucketingModule``) warns and trains without checkpoints.

The health and perf planes (:mod:`mxnet_tpu_torch.telemetry`): each
batch is appended to the flight ring (``MXTPU_FLIGHT_RECORD``, default
on), and under ``MXTPU_PERF_ATTR`` its wall splits into ``data_wait`` /
``dispatch`` / ``window_stall`` and the epoch's drain into
``boundary_sync`` — host clock stamps only, no device sync; an uncaught
exception writes the flight record first when ``MXTPU_FLIGHT_RECORD``
names a path.

Membership (:mod:`mxnet_tpu_torch.parallel.coordinator`): with
``MXTPU_COORD_ADDR`` set the loop joins the coordinator (background
heartbeats carry the flight ring's step times), polls it once a batch
(a host-side flag check: fault site ``host_crash``), and when the
cluster's generation moves it writes a boundary checkpoint (when
checkpoints are armed) and raises
:class:`~mxnet_tpu_torch.parallel.dist.GenerationChanged`.
"""
from __future__ import annotations

import logging
import time
from collections import namedtuple

import torch

from .. import telemetry as _tm
from ..base import MXNetError
from ..ndarray import NDArray

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])

def _as_list(obj):
    if obj is None:
        return []
    return obj if isinstance(obj, list) else [obj]


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # ------------------------------------------------------ high level
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def _output_handles(self):
        """The last step's output tensors (what the async window records
        its event behind)."""
        return [o.tensor if isinstance(o, NDArray) else o
                for o in self.get_outputs()]

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0):
        """Run ``eval_data`` through the net (inference forward) into
        ``eval_metric``; returns its global ``(name, value)`` pairs."""
        from .. import engine, metric as metric_mod

        assert self.binded and self.params_initialized
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        if reset:
            eval_data.reset()
        eval_metric.reset()
        nbatch = 0
        window = engine.AsyncWindow()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            window.push(self._output_handles())
            if batch_end_callback is not None:
                params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                       eval_metric=eval_metric,
                                       locals=locals())
                for cb in _as_list(batch_end_callback):
                    cb(params)
        window.drain()
        if score_end_callback is not None:
            params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                   eval_metric=eval_metric, locals=locals())
            for cb in _as_list(score_end_callback):
                cb(params)
        return eval_metric.get_global_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad or 0
            outputs = [NDArray(out.tensor[:out.shape[0] - pad].clone())
                       for out in self.get_outputs()]
            yield outputs, nbatch, eval_batch

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """The outputs over ``eval_data`` (padding dropped), on the
        module's device, merged across batches unless asked not to."""
        output_list = [outs for outs, _, _ in self.iter_predict(
            eval_data, num_batch=num_batch, reset=reset)]
        if not output_list:
            return output_list
        if merge_batches:
            merged = [NDArray(torch.cat([o[i].tensor for o in output_list]))
                      for i in range(len(output_list[0]))]
            if len(merged) == 1 and not always_output_list:
                return merged[0]
            return merged
        return output_list

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, checkpoint=None, resume=None):
        """Bind, initialise and train for ``num_epoch`` epochs."""
        from .. import metric as metric_mod
        from ..initializer import Uniform

        assert num_epoch is not None, "please specify number of epochs"
        from .. import checkpoint as _ckpt

        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer or Uniform(0.01),
                         arg_params=arg_params, aux_params=aux_params,
                         allow_missing=allow_missing, force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        mgr = _ckpt.resolve_manager(checkpoint)
        if mgr is not None and not hasattr(self, "_checkpoint_arrays"):
            self.logger.warning("checkpointing requested but %s has no "
                                "checkpoint provider; disabled",
                                type(self).__name__)
            mgr = None
        resume_nbatch, resume_step = -1, 0
        if resume not in (None, False):
            if mgr is None and not checkpoint:
                raise MXNetError("fit(resume=...) needs MXTPU_CKPT_DIR (or "
                                 "a checkpoint= manager/directory)")
            if not hasattr(self, "_restore_checkpoint"):
                raise MXNetError(f"{type(self).__name__} has no checkpoint "
                                 "provider; resume is unsupported")
            path = _ckpt.resolve_resume(resume, mgr)
            if path is None:
                self.logger.warning("fit(resume=%r): no complete checkpoint "
                                    "found; starting fresh", resume)
            else:
                arrays, manifest = _ckpt.load(path)
                meta = self._restore_checkpoint(arrays, manifest)
                if meta.get("epoch") is not None:
                    begin_epoch = int(meta["epoch"])
                if meta.get("nbatch") is not None:
                    resume_nbatch = int(meta["nbatch"])
                resume_step = int(meta.get("step") or 0)
                if _ckpt._tm.enabled():
                    _ckpt._TM_RESUME.inc(status="ok")
                self.logger.info("resumed from %s (step %d, epoch %d, batch "
                                 "cursor %d)", path, resume_step, begin_epoch,
                                 resume_nbatch)
        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        if mgr is not None:
            mgr.install_preempt_handler()
        try:
            final_step = self._fit_epochs(
                train_data, eval_data, eval_metric, validation_metric,
                begin_epoch, num_epoch, epoch_end_callback,
                batch_end_callback, eval_end_callback,
                eval_batch_end_callback, monitor, mgr, resume_nbatch,
                resume_step)
            if mgr is not None:
                # terminal checkpoint: resuming a finished run is a no-op
                self._save_checkpoint_state(mgr, final_step, num_epoch, -1,
                                            background=False)
        except BaseException:
            # black box first, then crash: the ring, the registry and the
            # memory report (when MXTPU_FLIGHT_RECORD names a path)
            _tm.health.auto_dump("exception")
            raise
        finally:
            if mgr is not None:
                try:
                    mgr.wait()
                except Exception as exc:  # noqa: BLE001 — log, not mask
                    self.logger.warning("checkpoint writer failed: %r", exc)
                mgr.uninstall_preempt_handler()

    def _fit_epochs(self, train_data, eval_data, eval_metric,
                    validation_metric, begin_epoch, num_epoch,
                    epoch_end_callback, batch_end_callback,
                    eval_end_callback, eval_batch_end_callback,
                    monitor=None, mgr=None, resume_nbatch=-1, start_step=0):
        from .. import checkpoint as _ckpt
        from .. import engine
        from ..parallel import coordinator as _coordinator

        # membership: armed by MXTPU_COORD_ADDR; step_poll is a
        # host-side flag check
        coord = _coordinator.client_from_env()
        flight = _tm.health.flight_enabled()
        perf_on = _tm.perf.enabled()
        rec = flight or perf_on
        program = None
        if flight:
            try:
                program = getattr(self._exec_group.execs[0],
                                  "_program_label", None)
            except Exception:  # noqa: BLE001 — PythonModule and kin
                pass
        step_id = start_step
        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            window = engine.AsyncWindow()
            prev_tick = None  # per epoch: wall_s must not span eval/reset
            for nbatch, data_batch in enumerate(train_data):
                if epoch == begin_epoch and nbatch <= resume_nbatch:
                    # the checkpoint's cursor trained these already
                    continue
                if monitor is not None:
                    monitor.tic()
                step_id += 1
                t0 = time.perf_counter() if rec else 0.0
                self.forward_backward(data_batch)
                self.update()
                self.update_metric(eval_metric, data_batch.label)
                tp = time.perf_counter() if perf_on else 0.0
                window.push(self._output_handles())
                if rec:
                    # host clock stamps only: no device sync
                    now = time.perf_counter()
                    wall = now - (prev_tick if prev_tick is not None else t0)
                    if flight:
                        _tm.health.record_step(
                            loop="module", step=step_id, epoch=epoch,
                            nbatch=nbatch, depth=len(window),
                            dispatch_s=now - t0, wall_s=wall,
                            program=program)
                    if perf_on:
                        _tm.perf.record_step_buckets(
                            wall_s=wall,
                            data_wait=(max(t0 - prev_tick, 0.0)
                                       if prev_tick is not None else 0.0),
                            dispatch=tp - t0, window_stall=now - tp)
                    prev_tick = now
                if coord is not None and coord.step_poll():
                    # the generation moved (a host died or a rejoiner
                    # announced): checkpoint this boundary, then leave
                    # by name
                    w = None
                    if mgr is not None:
                        w = self._save_checkpoint_state(
                            mgr, step_id, epoch, nbatch, background=False)
                    coord.raise_generation_changed(getattr(w, "path", None))
                if mgr is not None:
                    if mgr.preempted:
                        w = self._save_checkpoint_state(
                            mgr, step_id, epoch, nbatch, background=False)
                        raise _ckpt.Preempted(
                            "SIGTERM: checkpoint saved to "
                            f"{getattr(w, 'path', mgr.directory)!r}; "
                            "restart with fit(resume=True)")
                    if mgr.due(step_id):
                        self._save_checkpoint_state(mgr, step_id, epoch,
                                                    nbatch)
                if monitor is not None:
                    monitor.toc_print()
                if batch_end_callback is not None:
                    params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                           eval_metric=eval_metric,
                                           locals=locals())
                    for cb in _as_list(batch_end_callback):
                        cb(params)
            # the epoch boundary: callbacks and the log need the card
            td0 = time.perf_counter() if perf_on else 0.0
            window.drain()
            if perf_on:
                _tm.perf.record_bucket("boundary_sync",
                                       time.perf_counter() - td0)
            for name, val in eval_metric.get_global_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - tic)
            arg_params_, aux_params_ = self.get_params()
            if epoch_end_callback is not None:
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, self.symbol, arg_params_, aux_params_)
            if eval_data is not None:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)
            train_data.reset()
        return step_id

    def _save_checkpoint_state(self, mgr, step, epoch, nbatch,
                               background=True):
        """One survival snapshot through the checkpoint provider
        (:meth:`_checkpoint_arrays`): the tensors are cloned behind the
        queued steps and the writer thread does the rest."""
        from .. import checkpoint as _ckpt

        arrays, extra = self._checkpoint_arrays()
        meta = {"module": type(self).__name__, "step": int(step),
                "epoch": int(epoch), "nbatch": int(nbatch),
                "signature": self._symbol.structural_signature()}
        meta.update(_ckpt.generator_meta(self._checkpoint_generator()))
        meta.update(extra)
        return mgr.save(step, arrays, meta=meta, background=background)

    # ------------------------------------------------- to be overridden
    @property
    def symbol(self):
        return self._symbol

    def get_params(self):
        raise NotImplementedError

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        raise NotImplementedError

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError

    def install_monitor(self, mon):
        raise NotImplementedError
