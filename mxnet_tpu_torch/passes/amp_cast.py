"""AMP bf16 cast-insertion pass (``MXTPU_AMP=bf16``; a copy of
``mxnet_tpu/passes/amp_cast.py`` over the port's Symbol).

Policy:

- **allow list** (compute bf16): Convolution / Deconvolution /
  FullyConnected / dot / batch_dot / FlashAttention, the tensor-core
  ops.  Every float input (data, weights, bias) is cast, so the op never
  promotes back to fp32 through a mixed operand.
- **deny list** (cast back to fp32): the softmax family, the loss
  output ops and whole-tensor reductions.  Only op-produced inputs are
  cast: variables feeding a loss are labels whose dtype passes through.
- everything else passes through in whatever dtype arrives.  BatchNorm
  keeps fp32 moments, and its fp32 gamma and beta promote its output to
  fp32, so under the policy the tensors between convolutions are fp32
  and each convolution's input is a ``Cast``.

Casts are shared per (producer, output, dtype).  With ``MXTPU_AMP``
unset the pass returns the input symbol object itself.  Gradients:
autograd through a ``Cast`` casts back, so an fp32 parameter gets an
fp32 gradient.
"""
from __future__ import annotations

from .. import amp as _amp
from ..symbol import Symbol, _Node
from . import register_pass

# tensor-core ops whose float inputs are cast to the AMP compute dtype
AMP_ALLOW = frozenset({
    "Convolution", "Deconvolution", "FullyConnected",
    "dot", "batch_dot", "FlashAttention",
})

# ops whose op-produced inputs are cast back to fp32: softmax family,
# loss outputs, whole-tensor reductions (sum/mean/... and their
# aliases).  Norm layers are deliberately absent — their statistics are
# fp32 by construction (ops/nn.py).
AMP_DENY = frozenset({
    "softmax", "log_softmax", "SoftmaxActivation",
    "SoftmaxOutput", "Softmax", "softmax_cross_entropy",
    "LinearRegressionOutput", "LogisticRegressionOutput",
    "MAERegressionOutput", "SVMOutput", "MakeLoss",
    "sum", "sum_axis", "mean", "prod", "nansum", "nanprod",
    "max", "max_axis", "min", "min_axis", "norm",
})


@register_pass("amp_cast", training_safe=True)
def amp_cast(symbol: Symbol) -> Symbol:
    """Insert the policy's Cast nodes (no-op unless MXTPU_AMP=bf16)."""
    if _amp.amp_dtype() is None:
        return symbol
    compute = "bfloat16"

    memo: dict = {}
    casts: dict = {}  # (id(node), oidx, dtype) -> cast entry
    inserted = 0

    def cast_entry(entry, dt):
        nonlocal inserted
        src, oidx = entry
        if not src.is_variable:
            if src.op == "Cast" and str(src.attrs.get("dtype")) == dt:
                return entry
            if dt == compute and src.op in AMP_ALLOW:
                return entry  # an allow op already produces bf16
        key = (id(src), oidx, dt)
        got = casts.get(key)
        if got is None:
            node = _Node("Cast", f"{src.name}_amp_{dt}",
                         attrs={"dtype": dt}, inputs=[entry])
            got = (node, 0)
            casts[key] = got
            inserted += 1
        return got

    for node in symbol.nodes:
        if node.is_variable:
            memo[id(node)] = ((node, 0),)
            continue
        new_inputs = [memo[id(src)][oidx] for src, oidx in node.inputs]
        if node.op in AMP_ALLOW:
            new_inputs = [cast_entry(e, compute) for e in new_inputs]
        elif node.op in AMP_DENY:
            # only op-produced inputs: variables here are labels /
            # targets whose dtype must pass through untouched
            new_inputs = [e if e[0].is_variable else cast_entry(e, "float32")
                          for e in new_inputs]
        if all(e[0] is src and e[1] == oidx
               for e, (src, oidx) in zip(new_inputs, node.inputs)):
            memo[id(node)] = tuple(
                (node, k) for k in range(node.num_outputs()))
        else:
            clone = _Node(node.op, node.name, attrs=node.attrs,
                          inputs=new_inputs, extra_attrs=node.extra_attrs)
            memo[id(node)] = tuple(
                (clone, k) for k in range(clone.num_outputs()))
    if not inserted:
        return symbol
    _amp.count_cast_nodes(inserted)
    return Symbol([memo[id(n)][i] for n, i in symbol._outputs])
