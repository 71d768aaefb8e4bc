"""Graph-rewrite pass pipeline over the port's ``Symbol`` graphs (the
port of ``mxnet_tpu/passes``).

Semantics-preserving rewrites applied at bind time, before the graph
interpreter runs the graph.  Pipeline (registration order = run order):

- ``constant_fold``  evaluate constant subgraphs once, bake literals
- ``cse``            merge structurally identical nodes
- ``dce``            drop identity/no-op nodes, prune dead ones
- ``residual_epilogue`` fuse relu(add)/relu(BN(add)) residual tails
                     into the fused epilogue ops (the CUDA kernel of
                     ``ops/residual_epilogue.py`` at inference)
- ``amp_cast``       the ``MXTPU_AMP=bf16`` precision policy as Cast
                     insertion (the same symbol object when AMP is off)
- ``prefuse``        collapse elementwise chains into one fused node
- ``convbn_fold``    inference-only Conv+BN weight folding (needs the
                     parameter values; the Predictor's path only)

Selection: ``MXTPU_GRAPH_PASSES`` — default/empty/``on`` runs the whole
pipeline, ``0``/``off`` disables everything, a comma list (``cse,dce``)
runs exactly the named passes in pipeline order.  The JAX package's
program cache keyed on the post-pass signature has no counterpart yet.
"""
from __future__ import annotations

import os
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable

from .. import telemetry as _tm
from ..base import MXNetError

# --- telemetry families (the JAX package's "Graph passes" families) -------
_TM_PASS_SEC = _tm.histogram(
    "graph_pass_seconds",
    "wall time of one graph-rewrite pass application at bind",
    labels=("pass",))
_TM_PASS_REMOVED = _tm.counter(
    "graph_pass_nodes_removed_total",
    "op nodes removed from bound graphs, per rewrite pass",
    labels=("pass",))
_TM_CONVBN = _tm.counter(
    "graph_pass_convbn_folded_total",
    "Conv+BatchNorm pairs folded into conv weights on inference binds")


@dataclass
class PassDef:
    """One registered graph pass.  ``training_safe`` True: the rewrite
    preserves forward outputs and gradients and may run on training
    binds; False restricts it to inference-only call sites."""

    name: str
    fn: Callable
    training_safe: bool
    needs_params: bool = False
    doc: str = ""


PASSES: "OrderedDict[str, PassDef]" = OrderedDict()


def register_pass(name, *, training_safe, needs_params=False):
    """Register a pass; registration order defines pipeline order."""

    def deco(fn):
        PASSES[name] = PassDef(name=name, fn=fn,
                               training_safe=bool(training_safe),
                               needs_params=needs_params,
                               doc=fn.__doc__ or "")
        return fn

    return deco


def enabled_passes():
    """Pass names selected by MXTPU_GRAPH_PASSES, in pipeline order."""
    raw = os.environ.get("MXTPU_GRAPH_PASSES", "").strip().lower()
    if raw in ("0", "off", "false", "no", "none", "disable", "disabled"):
        return []
    if raw in ("", "1", "on", "true", "yes", "default", "all"):
        return list(PASSES)
    names = {p.strip() for p in raw.split(",") if p.strip()}
    unknown = sorted(names - set(PASSES))
    if unknown:
        raise MXNetError(
            f"MXTPU_GRAPH_PASSES names unknown passes {unknown}; "
            f"registered: {list(PASSES)}")
    return [n for n in PASSES if n in names]


def convbn_fold_enabled() -> bool:
    return "convbn_fold" in enabled_passes()


def apply_graph_passes(symbol):
    """Run every enabled training-safe graph pass over ``symbol`` (the
    executor's bind-time hook; ``convbn_fold`` has its own entry point,
    :func:`apply_convbn_fold`).  Returns the input symbol unchanged when
    the pipeline is disabled."""
    names = enabled_passes()
    if not names:
        return symbol
    for name in names:
        p = PASSES[name]
        if p.needs_params or not p.training_safe:
            continue
        before = op_node_count(symbol)
        t0 = time.perf_counter()
        symbol = p.fn(symbol)
        _TM_PASS_SEC.observe(time.perf_counter() - t0, **{"pass": name})
        removed = before - op_node_count(symbol)
        if removed > 0:
            _TM_PASS_REMOVED.inc(removed, **{"pass": name})
    return symbol


def apply_convbn_fold(symbol, arg_params, aux_params):
    """Telemetry-counted Conv+BN fold (the Predictor's entry point).
    Honours MXTPU_GRAPH_PASSES; returns ``(symbol, arg_params,
    aux_params, n_folded)``."""
    if not convbn_fold_enabled():
        return symbol, dict(arg_params or {}), dict(aux_params or {}), 0
    t0 = time.perf_counter()
    symbol, arg_params, aux_params, n = fold_conv_bn(
        symbol, arg_params, aux_params)
    _TM_PASS_SEC.observe(time.perf_counter() - t0, **{"pass": "convbn_fold"})
    if n > 0:
        _TM_CONVBN.inc(n)
        _TM_PASS_REMOVED.inc(n, **{"pass": "convbn_fold"})
    return symbol, arg_params, aux_params, n


def pipeline_report(symbol):
    """Per-pass node counts for the enabled graph passes:
    ``[{'pass', 'nodes_before', 'nodes_after'}, ...]``."""
    rows = []
    for name in enabled_passes():
        p = PASSES[name]
        if p.needs_params or not p.training_safe:
            continue
        before = op_node_count(symbol)
        symbol = p.fn(symbol)
        rows.append({"pass": name, "nodes_before": before,
                     "nodes_after": op_node_count(symbol)})
    return rows


# pass modules register themselves in PIPELINE ORDER
from . import constant_fold  # noqa: E402,F401
from . import cse  # noqa: E402,F401
from . import dce  # noqa: E402,F401
# residual_epilogue after dce (identity nodes between add/BN/relu are
# gone by then); amp_cast after it (the fused epilogue ops are
# pass-through for the precision policy) and before prefuse (inserted
# Casts join elementwise chains)
from . import residual_epilogue  # noqa: E402,F401
from . import amp_cast  # noqa: E402,F401
from . import prefuse  # noqa: E402,F401
from . import convbn  # noqa: E402,F401
from .common import op_node_count  # noqa: E402
from .convbn import fold_conv_bn  # noqa: E402
