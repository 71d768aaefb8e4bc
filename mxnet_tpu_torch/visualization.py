"""Network visualization of the port (mirrors
``mxnet_tpu/visualization.py``; parity: python/mxnet/visualization.py):
``plot_network`` gives the JAX package's DOT source — a
``graphviz.Source`` where the ``graphviz`` package imports, else an
object with ``.source`` — and ``print_summary`` prints its layer table
(output shapes, parameter counts, previous layers) and returns the
parameter total."""
from __future__ import annotations

from .base import MXNetError
from .symbol import Symbol


def _node_label(node):
    op = node.op or "null"
    if op == "null":
        return node.name
    attrs = node.attrs or {}
    extras = []
    for k in ("num_hidden", "kernel", "stride", "num_filter", "pool_type",
              "act_type"):
        if k in attrs:
            extras.append(f"{k}={attrs[k]}")
    label = f"{node.name}\\n{op}"
    if extras:
        label += "\\n" + ", ".join(extras)
    return label


_OP_COLOR = {
    "Convolution": "#fb8072", "Deconvolution": "#fb8072",
    "FullyConnected": "#fb8072",
    "BatchNorm": "#bebada", "Activation": "#ffffb3", "LeakyReLU": "#ffffb3",
    "Pooling": "#80b1d3", "Concat": "#fdb462", "Flatten": "#fdb462",
    "Reshape": "#fdb462", "SoftmaxOutput": "#b3de69",
}


def plot_network(symbol, title="plot", shape=None, node_attrs=None,
                 hide_weights=True):
    """The DOT graph of ``symbol`` (bottom to top, weights hidden unless
    ``hide_weights=False``, edges labelled with the shapes inferred from
    ``shape``): a ``graphviz.Source`` when the graphviz package imports,
    else an object exposing the DOT text as ``.source``."""
    if not isinstance(symbol, Symbol):
        raise MXNetError("plot_network requires a Symbol")
    node_attrs = node_attrs or {}

    shapes = {}
    if shape is not None:
        arg_shapes, out_shapes, _ = symbol.infer_shape(**shape)
        internals = symbol.get_internals()
        names = internals.list_outputs()
        try:
            _, int_shapes, _ = internals.infer_shape(**shape)
            shapes = dict(zip(names, int_shapes))
        except MXNetError:
            pass

    nodes = symbol.nodes
    weights = set()
    if hide_weights:
        for node in nodes:
            if node.op:
                for inp, _idx in node.inputs:
                    if inp.op is None and inp.name.endswith(
                            ("_weight", "_bias", "_gamma", "_beta",
                             "_moving_mean", "_moving_var")):
                        weights.add(inp.name)

    lines = [f'digraph "{title}" {{', "  rankdir=BT;"]
    id2name = {}
    for node in nodes:
        if node.name in weights:
            continue
        id2name[id(node)] = node.name
        color = _OP_COLOR.get(node.op or "", "#8dd3c7")
        style = {"shape": "box", "fillcolor": color, "style": "filled",
                 **node_attrs}
        attr_txt = ", ".join(f'{k}="{v}"' for k, v in style.items())
        lines.append(f'  "{node.name}" [label="{_node_label(node)}", '
                     f'{attr_txt}];')
    for node in nodes:
        if node.name in weights or not node.op:
            continue
        for inp, _idx in node.inputs:
            if inp.name in weights or id(inp) not in id2name:
                continue
            label = ""
            out_name = inp.name if inp.op is None else inp.name + "_output"
            if shapes.get(out_name):
                label = f' [label="{"x".join(map(str, shapes[out_name]))}"]'
            lines.append(f'  "{inp.name}" -> "{node.name}"{label};')
    lines.append("}")
    dot_src = "\n".join(lines)

    try:
        import graphviz  # type: ignore

        g = graphviz.Source(dot_src)
        return g
    except ImportError:
        class _Dot:
            source = dot_src

            def render(self, *a, **k):
                raise MXNetError("graphviz not installed")

            def __repr__(self):
                return self.source

        return _Dot()


def print_summary(symbol, shape=None, line_length=120, positions=(.44, .64,
                                                                  .74, 1.)):
    """Print the layer table (output shapes, parameter counts and the
    previous layers) of ``symbol`` at the input shapes ``shape``;
    returns the parameter total."""
    if not isinstance(symbol, Symbol):
        raise MXNetError("print_summary requires a Symbol")
    shapes = {}
    if shape is not None:
        internals = symbol.get_internals()
        names = internals.list_outputs()
        _, int_shapes, _ = internals.infer_shape(**shape)
        shapes = dict(zip(names, int_shapes))
        arg_names = symbol.list_arguments()
        arg_shape_list, _, _ = symbol.infer_shape(**shape)
        arg_shapes = dict(zip(arg_names, arg_shape_list))
    else:
        arg_shapes = {}

    positions = [int(line_length * p) for p in positions]
    fields = ["Layer (type)", "Output Shape", "Param #", "Previous Layer"]

    def print_row(cols):
        line = ""
        for txt, pos in zip(cols, positions):
            line = (line + str(txt))[:pos].ljust(pos)
        print(line)

    print("_" * line_length)
    print_row(fields)
    print("=" * line_length)

    total = 0
    for node in symbol.nodes:
        if node.op is None:
            continue
        out_name = node.name + "_output"
        out_shape = shapes.get(out_name, "")
        params = 0
        prevs = []
        for inp, _idx in node.inputs:
            if inp.op is None:
                if inp.name in arg_shapes and (
                        inp.name.endswith(("_weight", "_bias", "_gamma",
                                           "_beta", "_moving_mean",
                                           "_moving_var"))):
                    s = arg_shapes[inp.name]
                    n = 1
                    for d in s:
                        n *= d
                    params += n
                else:
                    prevs.append(inp.name)
            else:
                prevs.append(inp.name)
        total += params
        print_row([f"{node.name} ({node.op})", out_shape, params,
                   ",".join(prevs)])
    print("=" * line_length)
    print(f"Total params: {total}")
    print("_" * line_length)
    return total
