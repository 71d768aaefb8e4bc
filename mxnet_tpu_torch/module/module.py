"""``Module`` of the port (mirrors ``mxnet_tpu/module/module.py:28-404``;
parity: python/mxnet/module/module.py).

The training API over one symbol on one device: ``bind`` (the executor
group), ``init_params``, ``init_optimizer``, ``forward``/``backward``/
``update``, outputs and metrics, checkpoints with optimizer states.
The default context is the card; ``context=mx.cpu()`` runs on the host,
and without a card and a CPU context the constructor raises.

``update`` keeps the reference's routes (``model._create_kvstore``):
one device with a store named by a string trains through the module's
own eager ``Updater`` (one ``sgd_mom_update`` per parameter), while a
``KVStore`` instance (``init_optimizer(kvstore=mx.kv.create("local"))``)
takes one batched ``push``/``pull`` per step, which the store routes to
its bucketed engine.  A parameter-server store (``kvstore="dist_sync"``,
``"dist_device_sync"`` or ``"dist_async"`` under the launcher) keeps
MXNet's per-key loop, ``push``/``pull`` with ``priority=-index``, so
each key's RPC overlaps the others; the optimizer and its states live
on the servers, the effective batch of a sync store is the batch times
the workers (``rescale_grad``), every worker starts from worker 0's
initial weights (pulled back after ``init``), and BatchNorm's moving
statistics stay each worker's own.  The pulled weights land at the next
``forward`` (or parameter read), one wait per key.  The collective
``dist_sync`` (no servers, ``python -m mxnet_tpu_torch.launch -n W -s
0``) keeps that contract with batched pushes and pulls, as for a local
store: each worker binds its own context and trains on its own batch,
and the store sums the gradients over the world (``kvstore_fused``).
The module's parameter copies (``get_params``) live on its device in the
bound memory format.

``init_params`` honours a variable's own ``__init__`` attr (an
initializer's ``dumps()``, as ``sym.Variable(init=...)`` writes it)
before the module's initializer.  A ``grad_stype="row_sparse"`` Embedding
weight binds a row-sparse gradient (``executor.simple_bind``) and its
kvstore key is initialised row-sparse.

The survival checkpoint provider (``fit(checkpoint=, resume=)``):
:meth:`Module._checkpoint_arrays` names the bound parameters and aux
states, every optimizer slot of the active updater (the module's own on
the eager route, the store's on the bucketed one) and the loss scaler's
state (``amp/scale`` and its counters), in the JAX package's names;
:meth:`Module._restore_checkpoint` puts them back, with the store's
weight copies, the update counts and this package's generator state.
Several contexts in one process that name one torch device (``cpu(0)``
to ``cpu(7)``) bind one executor at the whole batch, as the reference's
SPMD program over them computes; contexts that name several cards in one
process are refused (``module/executor_group.py``): launch one process a
card.
``BucketingModule``, ``SequentialModule`` and ``PythonModule`` are in
their own files.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from .. import optimizer as opt
from ..base import MXNetError
from ..context import resolve_device
from ..convert import _to_tensor
from ..model import _create_kvstore, load_checkpoint, save_checkpoint
from ..ndarray import NDArray
from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup

__all__ = ["Module"]


def _devices(context):
    """``context`` (one or a list of devices; None: the card) as a list
    of resolved ``torch.device``s."""
    if context is None:
        context = [None]
    elif not isinstance(context, (list, tuple)):
        context = [context]
    return [resolve_device(c) for c in context]


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None):
        super().__init__(logger=logger)
        self._context = _devices(context)
        self._work_load_list = work_load_list or [1] * len(self._context)
        self._symbol = symbol
        self._data_names = list(data_names or [])
        self._label_names = list(label_names or [])
        input_names = self._data_names + self._label_names
        self._param_names = [n for n in symbol.list_arguments()
                             if n not in input_names]
        self._aux_names = symbol.list_auxiliary_states()
        self._fixed_param_names = list(fixed_param_names or [])
        self._exec_group = None
        self._arg_params = None
        self._aux_params = None
        self._params_dirty = False
        self._optimizer = None
        self._kvstore = None
        self._update_on_kvstore = None
        self._updater = None
        self._preload_opt_states = None

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A module from ``save_checkpoint``'s files; the optimizer
        states load at ``init_optimizer`` when asked for."""
        context = kwargs.get("context")
        device = _devices(context)[0]
        sym, args, auxs = load_checkpoint(prefix, epoch, ctx=device)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = f"{prefix}-{epoch:04d}.states"
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        self._sync_params_from_devices()
        save_checkpoint(prefix, epoch, self.symbol, self._arg_params,
                        self._aux_params)
        if save_optimizer_states:
            self.save_optimizer_states(f"{prefix}-{epoch:04d}.states")

    # ---------------------------------------------------------- binding
    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._symbol.list_outputs()

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        shapes = {d[0]: d[1] for d in list(self._data_shapes)
                  + list(self._label_shapes or [])}
        _, out_shapes, _ = self._symbol.infer_shape(**shapes)
        return list(zip(self.output_names, out_shapes))

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if force_rebind:
            if self.binded and self.params_initialized:
                self._sync_params_from_devices()
            self._exec_group = None
            self.binded = False
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        self._data_shapes = [tuple(x) for x in data_shapes]
        self._label_shapes = ([tuple(x) for x in label_shapes]
                              if label_shapes else None)
        shared_group = (shared_module._exec_group
                        if shared_module is not None else None)
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._work_load_list,
            self._data_shapes, self._label_shapes or [], self._param_names,
            for_training, inputs_need_grad, shared_group=shared_group,
            logger=self.logger, fixed_param_names=self._fixed_param_names,
            grad_req=grad_req)
        if shared_module is not None and shared_module.params_initialized:
            self.set_params(*shared_module.get_params())
        elif self.params_initialized and self._arg_params is not None:
            # a re-bind (or Module.load, then bind): the new executor
            # gets the parameters this module holds
            self._exec_group.set_params(self._arg_params,
                                        self._aux_params or {})
            self._adopt_bound_params()

    # ----------------------------------------------------------- params
    def get_params(self):
        assert self.binded and self.params_initialized
        self._sync_params_from_devices()
        return self._arg_params, self._aux_params

    def _resolve_pulls(self):
        """Land a parameter-server store's pending pulls in the bound
        arrays (the lazy half of ``update``)."""
        if self._ps_store():
            self._kvstore.wait_pulls()

    def _ps_store(self) -> bool:
        """A dist store that talks to parameter servers."""
        kv = self._kvstore
        return (kv is not None and "dist" in kv.type
                and not kv.collective)

    def _sync_params_from_devices(self):
        self._resolve_pulls()
        if self._params_dirty and self._exec_group is not None:
            self._arg_params = self._arg_params or {}
            self._aux_params = self._aux_params or {}
            self._exec_group.get_params(self._arg_params, self._aux_params)
            self._params_dirty = False

    def _adopt_bound_params(self):
        """The module's copies become copies of the bound arrays (their
        device, dtype and memory format)."""
        self._arg_params, self._aux_params = {}, {}
        self._exec_group.get_params(self._arg_params, self._aux_params)

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        """Fill the parameters: given values (``arg_params``/
        ``aux_params``: NDArrays, tensors or numpy), else ``initializer``
        (default ``Uniform(0.01)``), or a variable's own ``__init__``
        attr before it.  A parameter missing from a non-empty
        ``arg_params`` raises unless ``allow_missing``."""
        from .. import initializer as init_mod

        if self.params_initialized and not force_init:
            if arg_params or aux_params:
                self._set_params_direct(arg_params, aux_params)
            return
        assert self.binded, "call bind before init_params"
        initializer = (initializer if initializer is not None
                       else init_mod.Uniform(0.01))
        ex = self._exec_group.execs[0]
        # a variable's own __init__ attr overrides the module's
        # initializer (parity: the InitDesc/__init__ attr protocol)
        var_inits = init_mod.variable_initializers(self._symbol)
        for kind, names, bound, given in (
                ("param", self._param_names, ex.arg_dict, arg_params),
                ("aux", self._aux_names, ex.aux_dict, aux_params)):
            for name in names:
                dst = bound.get(name)
                if dst is None:
                    continue
                if given is not None and name in given:
                    dst.copy_(_to_tensor(given[name], dst.dtype, dst.device))
                    continue
                if (kind == "param" and given and not allow_missing):
                    raise MXNetError(f"param {name} missing")
                # filled in logical order, so the draws do not depend on
                # the bound memory format
                arr = torch.zeros(dst.shape, dtype=dst.dtype,
                                  device=dst.device)
                var_inits.get(name, initializer)(name, arr)
                dst.copy_(arr)
        self._adopt_bound_params()
        self.params_initialized = True
        self._params_dirty = False

    def _set_params_direct(self, arg_params, aux_params):
        for mine, given in ((self._arg_params, arg_params),
                            (self._aux_params, aux_params)):
            for k, v in (given or {}).items():
                if k in mine:
                    dst = mine[k].tensor
                    dst.copy_(_to_tensor(v, dst.dtype, dst.device))
        self._exec_group.set_params(self._arg_params, self._aux_params)

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True):
        if not self.params_initialized:
            self._exec_group.set_params(arg_params or {}, aux_params or {})
            self._adopt_bound_params()
            self.params_initialized = True
            return
        self._set_params_direct(arg_params, aux_params)

    # -------------------------------------------------------- optimizer
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """Make the optimizer (``rescale_grad`` 1/batch unless given) and
        decide the store as the reference does."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized")
            return
        kvstore_inst, update_on_kvstore = _create_kvstore(
            kvstore, len(self._context), self._arg_params)
        batch_size = self._exec_group.batch_size
        if (kvstore_inst and "dist" in kvstore_inst.type
                and "_sync" in kvstore_inst.type):
            # sync (servers or collectives): every worker pushes its own
            # batch's gradient and the store sums them, so the effective
            # batch is B * workers
            batch_size *= kvstore_inst.num_workers
        rescale_grad = 1.0 / batch_size
        if isinstance(optimizer, str):
            idx2name = dict(enumerate(self._param_names))
            optimizer_params = dict(optimizer_params)
            optimizer_params.setdefault("rescale_grad", rescale_grad)
            optimizer = opt.create(optimizer, sym=self.symbol,
                                   param_idx2name=idx2name,
                                   **optimizer_params)
        self._optimizer = optimizer
        self._kvstore = kvstore_inst
        self._update_on_kvstore = update_on_kvstore
        self._updater = None
        if kvstore_inst:
            ex = self._exec_group.execs[0]
            # the workers' random inits differ: only worker 0's defines
            # the model, and every worker pulls it back after init
            pull_back = update_on_kvstore and kvstore_inst.num_workers > 1
            for idx, name in enumerate(self._param_names):
                if name in ex.arg_dict:
                    # the bound array: the same values as the module's
                    # copy, in the layout the updates run in
                    init_val = ex.arg_dict[name]
                    if getattr(ex.grad_dict.get(name), "stype",
                               "default") == "row_sparse":
                        # its gradient arrives row-sparse, so the key is
                        # row-sparse (the store checks each push)
                        from .. import sparse as _sparse

                        init_val = _sparse.full_row_sparse(init_val)
                    kvstore_inst.init(idx, init_val)
                    if pull_back:
                        kvstore_inst.pull(idx, ex.arg_dict[name],
                                          priority=-idx)
            if pull_back:
                self._resolve_pulls()
                self._adopt_bound_params()
            if update_on_kvstore:
                kvstore_inst.set_optimizer(self._optimizer)
        if not update_on_kvstore:
            self._updater = opt.get_updater(optimizer)
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def borrow_optimizer(self, shared_module):
        """Share another module's optimizer, store and updater."""
        assert shared_module.optimizer_initialized
        self._optimizer = shared_module._optimizer
        self._kvstore = shared_module._kvstore
        self._update_on_kvstore = shared_module._update_on_kvstore
        self._updater = shared_module._updater
        self.optimizer_initialized = True

    # ------------------------------------------------------ computation
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        self._resolve_pulls()
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec_group.backward(out_grads)

    def update(self):
        """One optimizer step over the gradients of the last backward:
        a batched push (and pull) through the store when there is one,
        per key with ``priority=-index`` on a parameter-server store,
        else the module's updater per parameter."""
        assert (self.binded and self.params_initialized
                and self.optimizer_initialized)
        self._params_dirty = True
        group = self._exec_group
        with torch.profiler.record_function("Module.update"):
            if self._ps_store():
                kv = self._kvstore
                idxs, grads, weights = group.get_update_data()
                for idx, g, w in zip(idxs, grads, weights):
                    kv.push(idx, g, priority=-idx)
                    kv.pull(idx, w if self._update_on_kvstore else g[0],
                            priority=-idx)
                if not self._update_on_kvstore:
                    # aggregation only: the summed gradients come back,
                    # then the module's updater runs per key
                    kv.wait_pulls()
                    for idx, g, w in zip(idxs, grads, weights):
                        self._updater(idx, g[0], w)
                return
            if self._kvstore is not None:
                idxs, grads, weights = group.get_update_data()
                self._kvstore.push(idxs, grads)
                if self._update_on_kvstore:
                    self._kvstore.pull(idxs, weights)
                else:
                    # aggregation only: the merged gradients come back,
                    # then the module's updater runs per key
                    self._kvstore.pull(idxs, [g[0] for g in grads])
                    for idx, g, w in zip(idxs, grads, weights):
                        self._updater(idx, g[0], w)
                return
            for idx, g, w in zip(*group.get_update_data()):
                self._updater(idx, g[0], w)

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._exec_group.get_outputs(merge_multi_context)

    def _output_handles(self):
        return self._exec_group.get_output_handles()

    def get_input_grads(self, merge_multi_context=True):
        assert (self.binded and self.params_initialized
                and self.inputs_need_grad)
        return self._exec_group.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._exec_group.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        assert self.binded
        self._exec_group.install_monitor(mon)

    # --------------------------------------------------- survival layer
    def _active_updater(self):
        if self._update_on_kvstore and self._kvstore is not None:
            return getattr(self._kvstore, "_updater", None)
        return self._updater

    def _checkpoint_arrays(self):
        """``(arrays, extra meta)`` of this module's training state: the
        bound parameters and aux states, the optimizer slots (``opt/<key>
        /<slot>``), and under loss scaling the scaler's state.  Tensors
        are snapshotted by the checkpoint layer, behind the queued
        steps."""
        assert self.binded and self.params_initialized
        from .. import amp as _amp
        from ..kvstore_fused import _state_slots

        self._resolve_pulls()
        ex = self._exec_group.execs[0]
        arrs = {}
        for name in self._param_names:
            if name in ex.arg_dict:
                arrs["param/" + name] = ex.arg_dict[name]
        for name in self._aux_names:
            if name in ex.aux_dict:
                arrs["aux/" + name] = ex.aux_dict[name]
        upd = self._active_updater()
        if upd is not None:
            if hasattr(upd, "sync_sharded"):
                upd.sync_sharded()
            for key, st in upd.states.items():
                for j, leaf in enumerate(_state_slots(st)):
                    if leaf is not None:
                        arrs[f"opt/{key}/{j}"] = (
                            leaf.tensor if hasattr(leaf, "tensor") else leaf)
        extra = {}
        if self._optimizer is not None:
            extra["opt_counts"] = {
                str(k): int(v) for k, v in getattr(
                    self._optimizer, "_index_update_count", {}).items()}
            extra["num_update"] = int(getattr(self._optimizer,
                                              "num_update", 0))
        if _amp.scaling_active():
            sc = _amp.global_scaler()
            arrs["amp/scale"] = sc._scale
            arrs["amp/good"] = sc._good
            arrs["amp/overflows"] = sc._overflows
            arrs["amp/skipped"] = sc._skipped
        if self._ps_store():
            extra["dist_note"] = ("dist store: optimizer state lives "
                                  "server-side; weights only")
        return arrs, extra

    def _checkpoint_generator(self):
        from .. import random as _random

        return _random.generator(self._exec_group.device)

    @staticmethod
    def _ckpt_key(raw):
        """Integer kvstore keys come back from JSON as strings."""
        if isinstance(raw, str) and raw.lstrip("-").isdigit():
            return int(raw)
        return raw

    def _restore_checkpoint(self, arrays, manifest):
        """Restore a survival checkpoint (of either package) into this
        bound, initialised module: parameters and aux states, the store's
        weight copies, the optimizer slots, the update counts, the loss
        scaler and the generator.  Returns the manifest's meta."""
        from .. import amp as _amp
        from .. import checkpoint as _ckpt
        from ..kvstore_fused import _state_slots

        assert self.binded and self.params_initialized
        meta = manifest.get("meta", {})
        saved_sig = meta.get("signature")
        sig = self._symbol.structural_signature()
        if saved_sig is not None and saved_sig != sig:
            raise _ckpt.CheckpointError(
                "checkpoint was saved from a different graph (signature "
                f"{saved_sig[:16]}... vs bound {sig[:16]}...); refusing to "
                "load mismatched weights")
        for what, names, prefix in (("params", self._param_names, "param/"),
                                    ("aux states", self._aux_names, "aux/")):
            missing = [n for n in names if prefix + n not in arrays]
            if missing:
                raise _ckpt.CheckpointError(
                    f"checkpoint lacks {what} {missing[:5]}...")
        self.set_params({n: arrays["param/" + n] for n in self._param_names},
                        {n: arrays["aux/" + n] for n in self._aux_names},
                        force_init=True)
        kv = self._kvstore
        ex = self._exec_group.execs[0]
        if kv is not None:
            # the store's weight copies feed the next update
            for idx, name in enumerate(self._param_names):
                if idx in kv._store:
                    dst = kv._store[idx].tensor
                    dst.copy_(_to_tensor(arrays["param/" + name], dst.dtype,
                                         dst.device))
        upd = self._active_updater()
        if upd is not None:
            def weight_for(key):
                if kv is not None and key in kv._store:
                    return kv._store[key]
                if isinstance(key, int) and key < len(self._param_names):
                    key = self._param_names[key]
                t = ex.arg_dict.get(key)
                return None if t is None else NDArray(t)

            per_key = {}
            for name, host in arrays.items():
                if name.startswith("opt/"):
                    _, key, j = name.split("/", 2)
                    per_key.setdefault(self._ckpt_key(key), []).append(
                        (int(j), host))
            for key, slot_hosts in per_key.items():
                w = weight_for(key)
                if w is None:
                    continue
                leaves = _state_slots(upd.ensure_state(key, w))
                for j, host in slot_hosts:
                    if j < len(leaves) and leaves[j] is not None:
                        dst = leaves[j].tensor
                        dst.copy_(_to_tensor(host, dst.dtype, dst.device)
                                  .reshape(dst.shape))
        if self._optimizer is not None:
            counts = meta.get("opt_counts") or {}
            self._optimizer._index_update_count = {
                self._ckpt_key(k): int(v) for k, v in counts.items()}
            if meta.get("num_update") is not None:
                self._optimizer.num_update = int(meta["num_update"])
        if "amp/scale" in arrays and _amp.scaling_active():
            sc = _amp.global_scaler()
            dev = sc._scale.device
            sc._scale, sc._good, sc._overflows, sc._skipped = (
                torch.from_numpy(np.asarray(arrays[k])).to(dev)
                for k in ("amp/scale", "amp/good", "amp/overflows",
                          "amp/skipped"))
        _ckpt.restore_generator(self._checkpoint_generator(), meta)
        self._params_dirty = False
        return meta

    def save_optimizer_states(self, fname):
        assert self.optimizer_initialized
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname)
        else:
            with open(fname, "wb") as f:
                f.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        assert self.optimizer_initialized
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
        else:
            with open(fname, "rb") as f:
                self._updater.set_states(f.read())
