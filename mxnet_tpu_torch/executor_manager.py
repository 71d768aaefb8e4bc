"""The legacy data-parallel executor manager (mirrors
``mxnet_tpu/executor_manager.py``; parity: python/mxnet/
executor_manager.py ``_split_input_slice``, ``_check_arguments``,
``_load_data``/``_load_label`` and ``DataParallelExecutorManager``).

``FeedForward``'s engine room in the reference; here it keeps that API
over the port's executor group (:class:`~.module.executor_group.
DataParallelExecutorGroup`), which binds one executor on one device:
contexts that name one torch device (``cpu(0)``, ``cpu(1)``) bind one
executor at the whole batch, and contexts that name several cards in one
process raise, naming the launcher and ROADMAP Queue 1 item 10b, slice 5.
"""
from __future__ import annotations

import logging

from .base import MXNetError
from .module.executor_group import DataParallelExecutorGroup

__all__ = ["DataParallelExecutorManager"]


def _split_input_slice(batch_size, work_load_list):
    """The batch's slice of each device in proportion to its work load
    (parity: executor_manager.py:15)."""
    total = sum(work_load_list)
    slices = []
    start = 0
    for w in work_load_list:
        end = start + int(round(batch_size * w / total))
        slices.append(slice(start, min(end, batch_size)))
        start = end
    return slices


def _check_arguments(symbol):
    """Reject duplicated argument or aux-state names (parity:
    executor_manager.py:41)."""
    arg_names = symbol.list_arguments()
    if len(set(arg_names)) != len(arg_names):
        raise MXNetError(
            "Find duplicated argument name, please make the weight name "
            f"non-duplicated, arguments are {arg_names}")
    aux_names = symbol.list_auxiliary_states()
    if len(set(aux_names)) != len(aux_names):
        raise MXNetError(
            "Find duplicated auxiliary param name, please make the weight "
            f"name non-duplicated, auxiliary params are {aux_names}")


def _load_general(data, targets):
    """Copy each source array into its target: an NDArray, or a list of
    ``(slice, NDArray)`` pairs taking a slice of the batch each."""
    for d_src, d_targets in zip(data, targets):
        if hasattr(d_targets, "copyto"):
            d_src.copyto(d_targets)
        else:
            for sl, d_dst in d_targets:
                d_src[sl.start:sl.stop].copyto(d_dst)


def _load_data(batch, targets):
    _load_general(batch.data, targets)


def _load_label(batch, targets):
    _load_general(batch.label, targets)


class DataParallelExecutorManager:
    """Runs one executor group for a training loop: load a batch,
    forward, backward, update a metric (parity: executor_manager.py:279).
    ``sym_gen`` binds one group per bucket key, sharing the default
    bucket's parameters."""

    def __init__(self, symbol, ctx, train_data, arg_names=None,
                 param_names=None, aux_names=None, work_load_list=None,
                 logger=None, sym_gen=None):
        if logger is None:
            logger = logging
        if not isinstance(ctx, (list, tuple)):
            ctx = [ctx]
        num_device = len(ctx)
        logger.info("Start training with %s", str(ctx))
        if work_load_list is None:
            work_load_list = [1] * num_device
        if len(work_load_list) != num_device:
            raise MXNetError("Invalid settings for work load.")

        self.ctx = ctx
        self.symbol = symbol
        self.sym_gen = sym_gen
        self.data_names = [d[0] for d in train_data.provide_data]
        self.label_names = [l[0] for l in train_data.provide_label]
        self.arg_names = arg_names or symbol.list_arguments()
        if param_names is None:
            param_names = [n for n in self.arg_names
                           if n not in self.data_names + self.label_names]
        self.param_names = param_names
        self.aux_names = aux_names or symbol.list_auxiliary_states()
        _check_arguments(symbol)

        self.slices = _split_input_slice(train_data.batch_size,
                                         work_load_list)
        self.execgrp = DataParallelExecutorGroup(
            symbol, ctx, work_load_list, train_data.provide_data,
            train_data.provide_label, param_names, for_training=True,
            inputs_need_grad=False)
        self.execgrp_bucket = {}
        if sym_gen is not None and getattr(
                train_data, "default_bucket_key", None) is not None:
            self.execgrp_bucket[train_data.default_bucket_key] = self.execgrp
        self.curr_execgrp = self.execgrp
        self._curr_batch = None

    def install_monitor(self, monitor):
        self.execgrp.install_monitor(monitor)

    def set_params(self, arg_params, aux_params):
        self.execgrp.set_params(arg_params, aux_params)

    def copy_to(self, arg_params, aux_params):
        """Copy the current parameters into the given dicts (parity:
        executor_manager.py:340)."""
        self.execgrp.get_params(arg_params, aux_params)

    @property
    def param_arrays(self):
        return self.curr_execgrp.param_arrays

    @property
    def grad_arrays(self):
        return self.curr_execgrp.grad_arrays

    @property
    def aux_arrays(self):
        ex = self.curr_execgrp.execs[0]
        return [[ex.aux_dict[name]] for name in self.aux_names]

    def load_data_batch(self, data_batch):
        """Switch to the batch's bucket (binding it on first use) and
        stage the batch (parity: executor_manager.py:365)."""
        key = getattr(data_batch, "bucket_key", None)
        if self.sym_gen is not None and key is not None:
            if key not in self.execgrp_bucket:
                self.execgrp_bucket[key] = DataParallelExecutorGroup(
                    self.sym_gen(key), self.ctx, None,
                    data_batch.provide_data, data_batch.provide_label,
                    self.param_names, for_training=True,
                    inputs_need_grad=False, shared_group=self.execgrp)
            self.curr_execgrp = self.execgrp_bucket[key]
        self._curr_batch = data_batch

    def forward(self, is_train=False):
        self.curr_execgrp.forward(self._curr_batch, is_train=is_train)

    def backward(self):
        self.curr_execgrp.backward()

    def update_metric(self, metric, labels):
        self.curr_execgrp.update_metric(metric, labels)
