"""Identity / no-op elimination + dead-node pruning (a copy of
``mxnet_tpu/passes/dce.py`` over the port's Symbol).

The structural rewrites nnvm gets from its identity-elimination passes:

- ``_copy`` / ``identity`` nodes forward their input (inside a graph the
  copy is meaningless — NDArray copy semantics live at the eager layer),
- a ``transpose`` whose permutation is the identity is dropped,
- a ``transpose``-of-``transpose`` whose composed permutation is the
  identity cancels to the original entry (both-axes-None — double full
  reverse — cancels for any rank),
- ``Reshape(Reshape(x, s1), s2)`` collapses to ``Reshape(x, s2)`` when
  the outer target has no ``0`` dim codes (a ``0`` copies a dim from
  the *inner* reshape's output, so collapsing would change its
  meaning; ``-1`` is total-size-derived and the total is preserved).

Everything the rewritten heads can no longer reach — including nodes
orphaned by CSE earlier in the pipeline — is
pruned by reconstruction.
"""
from __future__ import annotations

from ..base import parse_attr
from ..symbol import _Node
from . import register_pass
from .common import clone_rewrite


def _transpose_axes(node):
    """Normalized axes tuple of a transpose node, or None for the
    default full reverse."""
    axes = parse_attr(node.attrs.get("axes", None))
    if axes in (None, ()):
        return None
    return tuple(int(a) for a in axes)


def _reshape_target(node):
    shape = parse_attr(node.attrs.get("shape",
                                      node.attrs.get("target_shape", None)))
    if shape is None:
        return None
    return tuple(int(s) for s in shape)


@register_pass("dce", training_safe=True)
def dce(symbol):
    """Drop no-op nodes and prune everything no output depends on.
    Training-safe: every elimination forwards the exact producing
    entry, so cotangents flow through untouched."""

    def rewrite(node, new_inputs):
        # canonical registered names; the alias spellings also appear in
        # graphs loaded from external nnvm JSON (interop path)
        op = node.op
        if op in ("_copy", "identity"):
            return [new_inputs[0]]
        if op == "transpose":
            axes = _transpose_axes(node)
            if axes is not None and axes == tuple(range(len(axes))):
                return [new_inputs[0]]
            src, oidx = new_inputs[0]
            if not src.is_variable and src.op == "transpose" and oidx == 0:
                inner = _transpose_axes(src)
                if axes is None and inner is None:
                    return [src.inputs[0]]  # reverse twice = identity
                if (axes is not None and inner is not None
                        and len(axes) == len(inner)
                        and all(inner[a] == i for i, a in enumerate(axes))):
                    return [src.inputs[0]]
        if op in ("Reshape", "reshape"):
            src, oidx = new_inputs[0]
            if (not src.is_variable and src.op in ("Reshape", "reshape")
                    and oidx == 0):
                target = _reshape_target(node)
                if target is not None and 0 not in target:
                    collapsed = _Node("Reshape", node.name, attrs=node.attrs,
                                      inputs=[src.inputs[0]],
                                      extra_attrs=node.extra_attrs)
                    return [(collapsed, 0)]
        return None

    return clone_rewrite(symbol, rewrite)
