"""``SequentialModule`` of the port (mirrors
``mxnet_tpu/module/sequential_module.py``; parity:
python/mxnet/module/sequential_module.py): modules chained so each
later one takes the previous one's outputs as its data.

``add(module, take_labels=True)`` gives a module the labels (its metric
is the chain's); ``auto_wiring`` is accepted as in the reference.  At
bind every module but the first wants input gradients when training, so
``backward`` hands each module's input gradients to the one before it
as its head gradients (``inputs_need_grad`` chaining).  Outputs and
gradients stay on the modules' device: the chain adds no host sync.
"""
from __future__ import annotations

import logging

from ..io import DataBatch
from .base_module import BaseModule


class SequentialModule(BaseModule):
    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._modules = []
        self._metas = []
        self._label_shapes = None
        self._data_shapes = None
        self._meta_keys = {self.META_TAKE_LABELS, self.META_AUTO_WIRING}

    def add(self, module, **kwargs):
        self._modules.append(module)
        for key in kwargs:
            assert key in self._meta_keys, f"unknown meta {key}"
        self._metas.append(kwargs)
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self

    @property
    def data_names(self):
        if self._modules:
            return self._modules[0].data_names
        return []

    @property
    def output_names(self):
        if self._modules:
            return self._modules[-1].output_names
        return []

    def get_params(self):
        assert self.binded and self.params_initialized
        arg_params, aux_params = {}, {}
        for module in self._modules:
            arg, aux = module.get_params()
            arg_params.update(arg)
            aux_params.update(aux)
        return (arg_params, aux_params)

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded
        for module in self._modules:
            module.init_params(initializer=initializer, arg_params=arg_params,
                               aux_params=aux_params, allow_missing=True,
                               force_init=force_init)
        self.params_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            return
        assert shared_module is None
        assert len(self._modules) > 0
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes

        my_data_shapes = data_shapes
        anybody_ever_needs_label = False
        for i_layer, (meta, module) in enumerate(zip(self._metas, self._modules)):
            meta_take_labels = meta.get(self.META_TAKE_LABELS, False)
            my_label_shapes = label_shapes if meta_take_labels else None
            if meta_take_labels:
                anybody_ever_needs_label = True
            my_inputs_need_grad = for_training and (inputs_need_grad or i_layer > 0)
            module.bind(data_shapes=my_data_shapes, label_shapes=my_label_shapes,
                        for_training=for_training,
                        inputs_need_grad=my_inputs_need_grad,
                        force_rebind=force_rebind, grad_req=grad_req)
            if i_layer < len(self._modules) - 1:
                my_data_shapes = [
                    (name, shape)
                    for name, shape in zip(
                        self._modules[i_layer + 1].data_names,
                        [s for _, s in module.output_shapes],
                    )
                ]
        if not anybody_ever_needs_label:
            self._label_shapes = None

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),), force_init=False):
        assert self.binded and self.params_initialized
        for module in self._modules:
            module.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                                  optimizer_params=optimizer_params,
                                  force_init=force_init)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        batch = DataBatch(data=data_batch.data, label=data_batch.label,
                          pad=data_batch.pad)
        for i, module in enumerate(self._modules):
            module.forward(batch, is_train=is_train)
            if i < len(self._modules) - 1:
                batch = DataBatch(data=module.get_outputs(),
                                  label=data_batch.label, pad=data_batch.pad)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        for i in range(len(self._modules) - 1, -1, -1):
            module = self._modules[i]
            module.backward(out_grads=out_grads)
            if i == 0:
                break
            out_grads = module.get_input_grads()

    def update(self):
        for module in self._modules:
            module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._modules[-1].get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.inputs_need_grad
        return self._modules[0].get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        for meta, module in zip(self._metas, self._modules):
            if meta.get(self.META_TAKE_LABELS, False):
                module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        for module in self._modules:
            module.install_monitor(mon)
