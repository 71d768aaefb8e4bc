"""The executor group of the port (mirrors
``mxnet_tpu/module/executor_group.py:50-310``), over **one** device.

One executor bound with the group's gradient requests by role: data
inputs ``write`` when the module wants input gradients, labels and fixed
parameters ``null``, the other parameters the module's ``grad_req``
(``null`` for a module not bound for training).  Batches are copied into
the bound input buffers (host batches through pinned memory, without a
host sync); outputs stay on the device.  The bound tensors are wrapped
once in NDArrays, which the kvstore and the updater write in place.

Several contexts that resolve to one torch device (``cpu(0)`` ..
``cpu(7)`` are all the host) bind one executor at the whole batch: the
reference runs such a group as one SPMD program over the whole batch
(``mxnet_tpu/module/executor_group.py:1-20, 66-98``), so BatchNorm's
moments, the outputs and the gradients are the whole batch's, which one
executor gives.  Data parallelism across cards runs one process a card
(``python -m mxnet_tpu_torch.launch -n <cards> -s 0`` with the collective
``dist_sync`` store, which sums the gradients).  Several distinct cards
inside one process are refused: one executor a card would take
BatchNorm's moments per slice, not over the batch as the reference does
(ROADMAP Queue 1 item 10b, slice 5).
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..convert import _to_tensor
from ..executor import simple_bind
from ..ndarray import NDArray

__all__ = ["DataParallelExecutorGroup"]


class DataParallelExecutorGroup:
    def __init__(self, symbol, contexts, workload, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 shared_group=None, logger=None, fixed_param_names=None,
                 grad_req="write"):
        devices = []
        for c in contexts:
            if c not in devices:
                devices.append(c)
        if len(devices) != 1:
            raise MXNetError(
                f"a Module over {len(devices)} distinct devices in one "
                "process is not ported (ROADMAP Queue 1 item 10b, slice 5: "
                "BatchNorm's moments over the whole batch across cards); "
                "run one process a card with python -m "
                f"mxnet_tpu_torch.launch -n {len(devices)} -s 0 and "
                "kvstore='dist_sync'")
        self.symbol = symbol
        self.contexts = contexts
        self.workload = workload or [1] * len(contexts)
        self.param_names = param_names
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.fixed_param_names = set(fixed_param_names or [])
        self.data_names = [d[0] for d in data_shapes]
        self.label_names = [d[0] for d in label_shapes] if label_shapes \
            else []
        self.data_shapes = data_shapes
        self.label_shapes = label_shapes
        self.batch_size = data_shapes[0][1][0]
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        req = {}
        for name in self.arg_names:
            if name in self.data_names:
                req[name] = "write" if inputs_need_grad else "null"
            elif name in self.label_names or name in self.fixed_param_names:
                req[name] = "null"
            else:
                req[name] = grad_req if for_training else "null"
        input_shapes = dict([(n, s) for n, s in data_shapes]
                            + [(n, s) for n, s in (label_shapes or [])])
        ex = simple_bind(symbol, devices[0], grad_req=req, **input_shapes)
        # whether every parameter and aux state is the donor's own tensor
        # (then a bucketing module need not copy parameters in)
        self.shares_param_storage = False
        if shared_group is not None:
            # the donor's parameter storage, shared live (bucketing)
            donor = shared_group.execs[0]
            shared = set()
            for store, theirs in ((ex.arg_dict, donor.arg_dict),
                                  (ex.aux_dict, donor.aux_dict)):
                for name, t in theirs.items():
                    if (name in store and name in param_names + self.aux_names
                            and store[name].shape == t.shape):
                        store[name] = t
                        shared.add(name)
            mine = {n for n in param_names if n in ex.arg_dict}
            self.shares_param_storage = (mine | set(ex.aux_dict)) <= shared
        self.execs = [ex]
        self.device = devices[0]
        self._arg_nd = {k: NDArray(v) for k, v in ex.arg_dict.items()}
        # a row-sparse gradient holder is an NDArray already
        self._grad_nd = {k: v if isinstance(v, NDArray) else NDArray(v)
                         for k, v in ex.grad_dict.items()}

    # ----------------------------------------------------------- params
    @property
    def param_arrays(self):
        """Per parameter, the list of its bound arrays (one device)."""
        return [[self._arg_nd[n]] for n in self.param_names
                if n in self._arg_nd]

    @property
    def grad_arrays(self):
        """Per parameter, the list of its gradient arrays (None where
        the parameter has no gradient)."""
        return [[self._grad_nd.get(n)] for n in self.param_names
                if n in self._arg_nd]

    def set_params(self, arg_params, aux_params):
        ex = self.execs[0]
        for store, given in ((ex.arg_dict, arg_params),
                             (ex.aux_dict, aux_params or {})):
            for name, v in given.items():
                dst = store.get(name)
                if dst is None:
                    continue
                if isinstance(v, NDArray):
                    # device to device, no host round trip
                    v = v.tensor
                dst.copy_(_to_tensor(v, dst.dtype, dst.device))

    def get_params(self, arg_params, aux_params):
        """Copies of the bound parameters and aux states, as NDArrays in
        the bound memory format."""
        ex = self.execs[0]
        for name in self.param_names:
            if name in ex.arg_dict:
                arg_params[name] = NDArray(ex.arg_dict[name].clone())
        for name, t in ex.aux_dict.items():
            aux_params[name] = NDArray(t.clone())

    # ---------------------------------------------------------- running
    def forward(self, data_batch, is_train=None):
        if is_train is None:
            is_train = self.for_training
        ex = self.execs[0]
        self._load(ex, self.data_names, data_batch.data)
        if self.label_names and data_batch.label:
            self._load(ex, self.label_names, data_batch.label)
        ex.forward(is_train=is_train)

    @staticmethod
    def _load(ex, names, arrays):
        for name, arr in zip(names, arrays):
            dst = ex.arg_dict[name]
            src = arr.tensor if isinstance(arr, NDArray) else (
                arr if isinstance(arr, torch.Tensor)
                else torch.as_tensor(arr))
            if dst.is_cuda and not src.is_cuda and not src.is_pinned():
                src = src.pin_memory()
            dst.copy_(src, non_blocking=True)

    def backward(self, out_grads=None):
        self.execs[0].backward(out_grads)

    def get_outputs(self, merge_multi_context=True):
        return [NDArray(o) for o in self.execs[0].outputs]

    def get_output_handles(self):
        """The outputs' tensors: what the async window records behind."""
        return list(self.execs[0].outputs)

    def get_input_grads(self, merge_multi_context=True):
        return [self._grad_nd[n] for n in self.data_names
                if n in self._grad_nd]

    def get_update_data(self):
        """``(keys, per-key gradient lists, per-key weights)`` for the
        batched kvstore step; keys are the parameter indices."""
        idxs, grads, weights = [], [], []
        for idx, name in enumerate(self.param_names):
            g = self._grad_nd.get(name)
            if g is None:
                continue
            idxs.append(idx)
            grads.append([g])
            weights.append(self._arg_nd[name])
        return idxs, grads, weights

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.get_outputs())

    def install_monitor(self, mon):
        for ex in self.execs:
            mon.install(ex)
