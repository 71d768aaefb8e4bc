"""Symbolic graph layer of the port (mirrors ``mxnet_tpu/symbol.py``).

A Symbol is a list of output entries of a small DAG whose nodes name ops
of :mod:`mxnet_tpu_torch.ops.registry`.  ``sym.<Op>`` constructors are
generated from the registry; an op's missing learned inputs become
variables named ``<node>_<arg>`` (``layer0_q_weight``), as in the JAX
package, and ``list_arguments`` walks the graph in the same stable DFS
order, so both packages bind the same names in the same order.

Shape inference walks the graph on meta tensors (the JAX package uses
``jax.eval_shape``).  ``tojson``/``load_json`` (and their file forms
``save``/``load``) write and read the JAX package's own JSON, so a
symbol built there reaches the port as ``load_json(jax_symbol.tojson())``
(attrs then arrive as strings or JSON values, which the ops read with
``parse_attr``).  ``simple_bind`` and ``bind`` bind an
:class:`~.executor.Executor` (forward and backward).  The arithmetic
operators (``+ - * / **``, unary ``-`` and the reflected forms) make the
reference's nodes; ``get_internals`` lists every node's outputs (the
executor's monitor taps them).

:meth:`Symbol.structural_signature` is the reference's digest for the
same graph: it hashes ``repr()`` of every attr, so attrs keep the
values the reference would hold (tuples, numpy dtype names, Python
numbers), and a checkpoint written by one package names a graph the
other recognises.  ``load_json`` also reads the reference's nnvm format
(``param``/``attr`` dicts, ``node_row_ptr``) through
:func:`mxnet_tpu_torch.interop.load_symbol_json`.
"""
from __future__ import annotations

import hashlib
import json
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import ops
from .base import MXNetError, current_name_manager, scoped_attrs

__all__ = ["Symbol", "Variable", "Group", "load", "load_json", "zeros",
           "ones", "arange"]


class _Node:
    __slots__ = ("op", "name", "attrs", "inputs", "extra_attrs", "is_aux")

    def __init__(self, op, name, attrs=None, inputs=None, extra_attrs=None,
                 is_aux=False):
        self.op = op  # None for variables
        self.name = name
        self.attrs = dict(attrs or {})
        self.inputs: List[Tuple[_Node, int]] = list(inputs or [])
        self.extra_attrs = dict(extra_attrs or {})
        self.is_aux = is_aux

    @property
    def is_variable(self):
        return self.op is None

    def num_outputs(self):
        return 1 if self.op is None else \
            ops.get(self.op).count_outputs(self.attrs)


def _topo_order(out_nodes: Sequence[_Node]) -> List[_Node]:
    """Stable DFS topological order (the JAX package's, so
    ``list_arguments`` agrees with it)."""
    seen = set()
    order: List[_Node] = []

    def visit(node):
        if id(node) in seen:
            return
        seen.add(id(node))
        for inp, _ in node.inputs:
            visit(inp)
        order.append(node)

    for n in out_nodes:
        visit(n)
    return order


class Symbol:
    """A list of output entries of a graph node."""

    __slots__ = ("_outputs",)

    def __init__(self, outputs: Sequence[Tuple[_Node, int]]):
        self._outputs = list(outputs)

    @property
    def nodes(self) -> List[_Node]:
        return _topo_order([n for n, _ in self._outputs])

    def list_arguments(self) -> List[str]:
        return [n.name for n in self.nodes if n.is_variable and not n.is_aux]

    def list_auxiliary_states(self) -> List[str]:
        return [n.name for n in self.nodes if n.is_variable and n.is_aux]

    def list_outputs(self) -> List[str]:
        names = []
        for node, idx in self._outputs:
            if node.is_variable:
                names.append(node.name)
                continue
            od = ops.get(node.op)
            if od.num_outputs_fn is not None:
                names.append(f"{node.name}_{od.output_names[idx]}"
                             if idx < len(od.output_names)
                             else f"{node.name}_output{idx}")
            elif od.num_outputs == -1:  # attr-dependent (SliceChannel)
                names.append(f"{node.name}_output{idx}")
            elif od.num_outputs == 1:
                names.append(f"{node.name}_output")
            else:
                names.append(f"{node.name}_{od.output_names[idx]}")
        return names

    def get_internals(self) -> "Symbol":
        """Every node's outputs, variables included, in topological
        order (parity: Symbol.get_internals)."""
        outs = []
        for node in self.nodes:
            if node.is_variable:
                outs.append((node, 0))
            else:
                for i in range(node.num_outputs()):
                    outs.append((node, i))
        return Symbol(outs)

    def get_children(self) -> Optional["Symbol"]:
        """The inputs of the first output's node, or None for a
        variable."""
        node, _ = self._outputs[0]
        if not node.inputs:
            return None
        return Symbol(list(node.inputs))

    def structural_signature(self) -> str:
        """The reference's structure hash (its program cache key and a
        survival checkpoint's graph identity): op topology, op attrs,
        variable names, aux flags and extra attrs (``__shape__``,
        ``__dtype__``), and the output entries.  Op-node names are left
        out, so alpha-renamed graphs hash equal; variable names stay in,
        since they are the bind interface."""
        nodes = self.nodes
        index = {id(n): i for i, n in enumerate(nodes)}
        parts = []
        for n in nodes:
            parts.append((
                n.op or "null",
                n.name if n.is_variable else "",
                n.is_aux,
                tuple(sorted((k, repr(v)) for k, v in n.attrs.items())),
                tuple(sorted((k, repr(v))
                             for k, v in n.extra_attrs.items())),
                tuple((index[id(src)], oidx) for src, oidx in n.inputs),
            ))
        heads = tuple((index[id(n)], i) for n, i in self._outputs)
        return hashlib.sha256(repr((parts, heads)).encode()).hexdigest()

    # ------------------------------------------------------------ attrs
    def attr(self, key):
        """The first output node's annotation ``key`` (None if unset)."""
        node, _ = self._outputs[0]
        return node.extra_attrs.get(key)

    def list_attr(self):
        """The first output node's annotations."""
        node, _ = self._outputs[0]
        return dict(node.extra_attrs)

    def _set_attr(self, **kwargs):
        node, _ = self._outputs[0]
        node.extra_attrs.update({k: str(v) for k, v in kwargs.items()})

    def __copy__(self):
        return Symbol(list(self._outputs))

    def __deepcopy__(self, memo):
        return load_json(self.tojson())

    @property
    def name(self):
        if len(self._outputs) == 1:
            return self._outputs[0][0].name
        return None

    def __getitem__(self, index):
        if isinstance(index, str):
            names = self.list_outputs()
            if index not in names:
                raise MXNetError(f"no output named {index}; outputs: {names}")
            index = names.index(index)
        if isinstance(index, int):
            return Symbol([self._outputs[index]])
        raise TypeError(index)

    def __len__(self):
        return len(self._outputs)

    def __iter__(self):
        for i in range(len(self._outputs)):
            yield self[i]

    def __repr__(self):
        return f"<Symbol {self.name or 'grouped'}>"

    def attr_dict(self):
        return {node.name: dict(node.extra_attrs) for node in self.nodes
                if node.extra_attrs}

    # -------------------------------------------------------- operators
    def _binop(self, other, op, scalar_op, reverse=False):
        if isinstance(other, Symbol):
            a, b = (other, self) if reverse else (self, other)
            return _create(op, [a, b], {})
        if np.isscalar(other):
            return _create(scalar_op, [self], {"scalar": float(other)})
        raise TypeError(type(other))

    def __add__(self, o):
        return self._binop(o, "elemwise_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop(o, "elemwise_sub", "_minus_scalar")

    def __rsub__(self, o):
        return self._binop(o, "elemwise_sub", "_rminus_scalar", reverse=True)

    def __mul__(self, o):
        return self._binop(o, "elemwise_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop(o, "elemwise_div", "_div_scalar")

    def __rtruediv__(self, o):
        return self._binop(o, "elemwise_div", "_rdiv_scalar", reverse=True)

    def __pow__(self, o):
        return self._binop(o, "_power", "_power_scalar")

    def __neg__(self):
        return _create("negative", [self], {})

    # -------------------------------------------------- shape inference
    def infer_shape(self, *args, **kwargs):
        """``(arg_shapes, out_shapes, aux_shapes)`` from the shapes of some
        arguments, or ``(None, None, None)`` when the graph cannot be
        completed from them."""
        try:
            return self._infer_and_collect(args, kwargs, partial=False)
        except _InferIncomplete:
            return None, None, None

    def infer_shape_partial(self, *args, **kwargs):
        """Like :meth:`infer_shape`, but whatever can be inferred is
        returned and the rest is None."""
        return self._infer_and_collect(args, kwargs, partial=True)

    def _infer_and_collect(self, args, kwargs, partial):
        known = dict(kwargs)
        for name, shape in zip(self.list_arguments(), args):
            if shape is not None:
                known[name] = shape
        shapes = self._infer(known, partial=partial)

        def out_shape(node, idx):
            if node.is_variable:
                return shapes.get((node.name, "var"))
            return shapes.get((id(node), idx))

        arg_shapes = [shapes.get((a, "var")) for a in self.list_arguments()]
        aux_shapes = [shapes.get((a, "var"))
                      for a in self.list_auxiliary_states()]
        out_shapes = [out_shape(n, i) for n, i in self._outputs]
        return arg_shapes, out_shapes, aux_shapes

    def infer_type(self, *args, **kwargs):
        """``(arg_types, out_types, aux_types)`` as numpy scalar types,
        as the reference gives them: the given types for arguments,
        float32 for everything else."""
        known = dict(kwargs)
        for name, ty in zip(self.list_arguments(), args):
            if ty is not None:
                known[name] = ty
        arg_types = [np.dtype(known.get(a, np.float32)).type
                     for a in self.list_arguments()]
        aux_types = [np.float32 for _ in self.list_auxiliary_states()]
        out_types = [np.float32 for _ in self._outputs]
        return arg_types, out_types, aux_types

    def _infer(self, known_shapes: Dict[str, tuple], partial=False):
        """Walk the graph on meta tensors; ``{key: shape}`` with keys
        ``(arg_name, "var")`` for variables and ``(id(node), out_idx)``.
        With ``partial`` a node that cannot be inferred is skipped (and
        so are its consumers) instead of ending the walk."""
        shapes: Dict = {}
        vals: Dict = {}  # id(node) -> tuple of meta tensors

        def meta(shape):
            return torch.empty(tuple(shape), dtype=torch.float32,
                               device="meta")

        for node in self.nodes:
            if node.is_variable:
                if node.name in known_shapes:
                    shape = tuple(known_shapes[node.name])
                elif "__shape__" in node.extra_attrs:
                    shape = tuple(json.loads(node.extra_attrs["__shape__"]))
                else:
                    continue
                vals[id(node)] = (meta(shape),)
                shapes[(node.name, "var")] = shape
                continue
            try:
                self._infer_node(node, vals, shapes, meta)
            except _InferIncomplete:
                if not partial:
                    raise
        return shapes

    @staticmethod
    def _infer_node(node, vals, shapes, meta):
        od = ops.get(node.op)
        ins = []
        for inp, oidx in node.inputs:
            got = vals.get(id(inp))
            if got is None and not inp.is_variable:
                raise _InferIncomplete(node.name)
            ins.append(None if got is None else got[oidx])
        if any(x is None for x in ins):
            if od.infer_params is None:
                raise _InferIncomplete(node.name)
            attrs = od.with_defaults(node.attrs)
            names = od.resolve_arg_names(attrs) + list(od.aux_names)
            if len(names) < len(node.inputs):
                # the JSON gives an input that the defaults drop (the
                # JAX package's Deconvolution makes a bias): read the
                # attrs as given
                attrs = node.attrs
                names = list(od.arg_names) + list(od.aux_names)
            try:
                param_shapes = od.infer_params(
                    attrs, *[None if x is None else tuple(x.shape)
                             for x in ins])
            except (TypeError, IndexError, KeyError):
                raise _InferIncomplete(node.name) from None
            for j, (inp, _) in enumerate(node.inputs):
                if ins[j] is None:
                    pname = names[j] if j < len(names) else None
                    if pname not in param_shapes:
                        raise _InferIncomplete(f"{node.name}:{pname}")
                    shape = tuple(param_shapes[pname])
                    ins[j] = meta(shape)
                    vals[id(inp)] = (ins[j],)
                    shapes[(inp.name, "var")] = shape
        ctx = ops.OpCtx(is_train=True, device=torch.device("meta"))
        with torch.no_grad():
            res = od.fn(ctx, *ins, **node.attrs)
        if od.aux_names:
            res = res[0]
        res = res if isinstance(res, tuple) else (res,)
        vals[id(node)] = res
        for i, r in enumerate(res):
            shapes[(id(node), i)] = tuple(r.shape)


    # -------------------------------------------------------- save/load
    def tojson(self) -> str:
        """The JAX package's JSON (``Symbol.tojson`` there): nodes in
        topological order, non-string attrs JSON-encoded."""
        nodes = self.nodes
        index = {id(n): i for i, n in enumerate(nodes)}
        jnodes = []
        for n in nodes:
            jnodes.append({
                "op": n.op or "null",
                "name": n.name,
                "attrs": {k: json.dumps(v) if not isinstance(v, str) else v
                          for k, v in n.attrs.items()},
                "extra_attrs": n.extra_attrs,
                "is_aux": n.is_aux,
                "inputs": [[index[id(src)], oidx, 0]
                           for src, oidx in n.inputs],
            })
        heads = [[index[id(n)], i, 0] for n, i in self._outputs]
        arg_nodes = [i for i, n in enumerate(nodes) if n.is_variable]
        return json.dumps(
            {"nodes": jnodes, "arg_nodes": arg_nodes, "heads": heads,
             "attrs": {"mxnet_tpu_version": 1}}, indent=2)

    def save(self, fname: str):
        """Write :meth:`tojson` to ``fname``, a path or a URI of any
        registered filesystem (a remote one in one upload on close)."""
        from .filesystem import is_remote, open_uri

        if is_remote(fname):
            with open_uri(fname, "wb") as f:
                f.write(self.tojson().encode())
            return
        with open(fname, "w") as f:
            f.write(self.tojson())

    def simple_bind(self, ctx=None, grad_req="write", type_dict=None,
                    group2ctx=None, shared_exec=None, **kwargs):
        """Infer shapes from ``kwargs``, allocate and bind an
        :class:`~.executor.Executor` on ``ctx`` (default: the card)."""
        from .executor import simple_bind as _simple_bind

        return _simple_bind(self, ctx, grad_req=grad_req,
                            type_dict=type_dict, group2ctx=group2ctx,
                            shared_exec=shared_exec, **kwargs)

    def bind(self, ctx, args, args_grad=None, grad_req="write",
             aux_states=None, group2ctx=None, shared_exec=None):
        """Bind to given arrays (:func:`~.executor.bind`)."""
        from .executor import bind as _bind

        return _bind(self, ctx, args, args_grad=args_grad, grad_req=grad_req,
                     aux_states=aux_states, group2ctx=group2ctx,
                     shared_exec=shared_exec)

    def eval(self, ctx=None, **kwargs):
        """Bind for inference on the shapes of ``kwargs``, set them and
        run one forward; returns the outputs as NDArrays."""
        from .ndarray import NDArray

        vals = {k: v.tensor if isinstance(v, NDArray) else v
                for k, v in kwargs.items()}
        ex = self.simple_bind(ctx, grad_req="null",
                              **{k: tuple(v.shape) for k, v in vals.items()})
        return [NDArray(o) for o in ex.forward(is_train=False, **vals)]


class _InferIncomplete(Exception):
    pass


def load(fname: str) -> Symbol:
    """The Symbol in the JSON file ``fname`` (the file form of
    :func:`load_json`), a path or a URI of any registered filesystem."""
    from .filesystem import is_remote, open_uri

    if is_remote(fname):
        with open_uri(fname, "rb") as f:
            return load_json(f.read().decode())
    with open(fname) as f:
        return load_json(f.read())


def load_json(json_str: str) -> Symbol:
    """A Symbol from the JSON that :meth:`Symbol.tojson` (of either
    package) writes, or from the reference's nnvm format (node ``param``
    dicts, ``backward_source_id``, ``node_row_ptr``), which goes through
    :func:`mxnet_tpu_torch.interop.load_symbol_json` as in the JAX
    package."""
    data = json.loads(json_str)
    if data.get("nodes") and ("node_row_ptr" in data or any(
            "param" in n or "backward_source_id" in n
            for n in data["nodes"])):
        from .interop import load_symbol_json

        return load_symbol_json(json_str)
    nodes: List[_Node] = []
    for jn in data["nodes"]:
        if jn["op"] == "null":
            node = _Node(None, jn["name"],
                         extra_attrs=jn.get("extra_attrs", {}),
                         is_aux=jn.get("is_aux", False))
        else:
            ops.get(jn["op"])  # an op the port lacks fails here, by name
            attrs = {k: ops.decode_attr(v)
                     for k, v in jn.get("attrs", {}).items()}
            node = _Node(jn["op"], jn["name"], attrs=attrs,
                         extra_attrs=jn.get("extra_attrs", {}))
            node.inputs = [(nodes[i], oidx) for i, oidx, _ in jn["inputs"]]
        nodes.append(node)
    return Symbol([(nodes[i], oidx) for i, oidx, _ in data["heads"]])


# ---------------------------------------------------------- composition
def _dtype_name(dtype) -> str:
    """A dtype as the reference's ``__dtype__`` attr names it (numpy's
    name; ``bfloat16``, which numpy lacks, by its name)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    if str(dtype) == "bfloat16":
        return "bfloat16"
    return np.dtype(dtype).name


def Variable(name, attr=None, shape=None, lr_mult=None,
             wd_mult=None, dtype=None, init=None, stype=None,
             grad_stype=None, **kwargs) -> Symbol:
    """A named input or parameter.  ``shape`` is stored as the
    ``__shape__`` attr, the multipliers as ``__lr_mult__`` /
    ``__wd_mult__`` (read by the trainer), ``dtype`` as ``__dtype__``,
    ``init`` (an initializer or its ``dumps()``) as ``__init__`` (read
    by ``Module.init_params``).  ``grad_stype="row_sparse"`` marks an
    Embedding weight whose gradient the executor emits as the touched
    rows only (:mod:`mxnet_tpu_torch.sparse`); ``stype`` is recorded as
    the reference records it.  The attrs of the current ``AttrScope``
    are merged under ``attr``."""
    extra = scoped_attrs(attr)
    if shape is not None:
        extra["__shape__"] = json.dumps(list(shape))
    if lr_mult is not None:
        extra["__lr_mult__"] = str(lr_mult)
    if wd_mult is not None:
        extra["__wd_mult__"] = str(wd_mult)
    if dtype is not None:
        extra["__dtype__"] = _dtype_name(dtype)
    if init is not None:
        extra["__init__"] = init if isinstance(init, str) else init.dumps()
    for key, val in (("__storage_type__", stype),
                     ("__grad_stype__", grad_stype)):
        if val is not None:
            if val not in ("default", "row_sparse"):
                raise MXNetError(
                    f"Variable {name!r}: unknown storage type {val!r} "
                    "(expected 'default' or 'row_sparse')")
            extra[key] = val
    return Symbol([(_Node(None, name, extra_attrs=extra), 0)])


def Group(symbols) -> Symbol:
    outs = []
    for s in symbols:
        outs.extend(s._outputs)
    return Symbol(outs)


def _create_named(od, sym_inputs, attrs, name, extra_attr=None) -> Symbol:
    inputs = []
    for s in sym_inputs:
        if not isinstance(s, Symbol):
            raise TypeError(f"{od.name}: expected Symbol input, got "
                            f"{type(s)}")
        if len(s._outputs) != 1:
            raise MXNetError(f"{od.name}: cannot use a grouped symbol as "
                             "input")
        inputs.append(s._outputs[0])
    node = _Node(od.name, name, attrs=attrs, inputs=inputs,
                 extra_attrs=scoped_attrs(extra_attr))
    return Symbol([(node, i) for i in range(node.num_outputs())])


def _create(opname, sym_inputs, attrs, name=None) -> Symbol:
    od = ops.get(opname)
    return _create_named(od, sym_inputs, attrs,
                         current_name_manager().get(name, od.name))


def _make_symbol_fn(opname: str):
    od = ops.get(opname)

    def creator(*args, **kwargs):
        name = kwargs.pop("name", None)
        attr = kwargs.pop("attr", None)
        sym_kwargs = {k: v for k, v in kwargs.items()
                      if isinstance(v, Symbol)}
        attrs = {k: v for k, v in kwargs.items()
                 if not isinstance(v, Symbol)}
        name = current_name_manager().get(name, od.name)
        if od.varargs:
            inputs = [a for a in args if isinstance(a, Symbol)]
            attrs.setdefault("num_args", len(inputs))
            return _create_named(od, inputs, attrs, name, attr)
        inputs = []
        pos = list(args)
        for an in od.resolve_arg_names(attrs):
            if an in sym_kwargs:
                inputs.append(sym_kwargs.pop(an))
            elif pos:
                inputs.append(pos.pop(0))
            else:
                # a missing input becomes a variable: parameters
                # (layer0_q_weight) and data/label inputs alike
                inputs.append(Variable(f"{name}_{an}"))
        if sym_kwargs:
            raise MXNetError(f"{opname}: unexpected symbol kwargs "
                             f"{list(sym_kwargs)}")
        for aux in od.aux_names:
            v = Variable(f"{name}_{aux}")
            v._outputs[0][0].is_aux = True
            inputs.append(v)
        return _create_named(od, inputs, attrs, name, attr)

    creator.__name__ = opname
    creator.__doc__ = od.doc
    return creator


def zeros(shape, dtype=np.float32, **kwargs) -> Symbol:
    """A ``_zeros`` node (the reference's ``sym.zeros``)."""
    return _create("_zeros", [], {"shape": tuple(shape),
                                  "dtype": _dtype_name(dtype)}, **kwargs)


def ones(shape, dtype=np.float32, **kwargs) -> Symbol:
    """A ``_ones`` node (the reference's ``sym.ones``)."""
    return _create("_ones", [], {"shape": tuple(shape),
                                 "dtype": _dtype_name(dtype)}, **kwargs)


def arange(start, stop=None, step=1.0, repeat=1, dtype=np.float32,
           **kwargs) -> Symbol:
    """An ``_arange`` node (the reference's ``sym.arange``)."""
    return _create("_arange", [], {"start": start, "stop": stop,
                                   "step": step, "repeat": repeat,
                                   "dtype": _dtype_name(dtype)}, **kwargs)


def _init_symbol_functions():
    mod = sys.modules[__name__]
    for opname in ops.list_ops():
        if not hasattr(mod, opname):
            setattr(mod, opname, _make_symbol_fn(opname))


_init_symbol_functions()
